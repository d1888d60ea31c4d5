"""Batched beam search (port of the JAX package's ``decoding/beam.py``).

``beam_search`` encodes once and runs the whole (B, K) recurrence in the
``lstm_beam`` kernel (``attlstm_beam`` under attention fusion;
``models/captioner.py::CaptionModel.fused_beam``): the ladder engine's
path.  ``beam_search_from_state`` is the reference's per-step beam, one
``decoding/core.py::decode_step`` per token with early exit: the offline
twin the continuous slot loop is held token-exact against (it runs the
same step over the same rows, only the batch axis is the slot axis).
``finalize_beams`` is the shared epilogue: length normalization (divide
the raw log-prob by the token count) and best-first order.
``make_beam_search_fn`` binds the eval's settings to ``beam_search``
(the reference's jitted closure, here a plain function: the kernel is
the whole recurrence), and ``beam_backend`` names what a model's beam
search runs, for the eval's log line.

The kernels cover single-layer decoders, as the reference's do: a model
with ``num_layers > 1`` takes the per-step beam (:func:`per_step_beam`,
from ``CaptionModel.fused_beam``), chosen from the configuration
(``CaptionModel.decodes_fused``, logged once), as the reference's shape
gate sends it.  A single-layer model never falls back: a shape its
kernel does not take raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from cst_captioning_torch.constants import PAD_ID
from cst_captioning_torch.decoding.core import (
    DecodeState,
    all_done,
    decode_step,
    init_core,
)


class BeamResult(NamedTuple):
    tokens: torch.Tensor      # (B, L) int32 — best hypothesis per video
    score: torch.Tensor       # (B,) float32 — its (normalized) log-prob
    all_tokens: torch.Tensor  # (B, K, L) int32 — full beam, best-first
    all_scores: torch.Tensor  # (B, K) float32


def finalize_beams(seqs: torch.Tensor, scores: torch.Tensor,
                   length_normalize: bool = True) -> BeamResult:
    """Length-normalize and order best-first (stable, as the
    reference's ``jnp.argsort``)."""
    if length_normalize:
        lengths = torch.clamp((seqs != PAD_ID).sum(-1), min=1)
        final = scores / lengths.float()
    else:
        final = scores
    order = torch.argsort(-final, dim=-1, stable=True)
    all_tokens = torch.gather(
        seqs, 1, order[:, :, None].expand(-1, -1, seqs.shape[-1]))
    all_scores = torch.gather(final, 1, order)
    return BeamResult(tokens=all_tokens[:, 0], score=all_scores[:, 0],
                      all_tokens=all_tokens, all_scores=all_scores)


def beam_search(model, feats, feat_masks, category=None, *,
                beam_size: int = 5, max_len: int = 30,
                length_normalize: bool = True) -> BeamResult:
    """Beam search for a batch of videos through the fused kernel; a
    stacked model's ``fused_beam`` runs :func:`beam_search_from_state`'s
    per-step recurrence instead (``category``: (B,) ids under
    ``use_category``)."""
    seqs, scores = model.fused_beam(feats, feat_masks, category,
                                    beam_size=beam_size, max_len=max_len)
    return finalize_beams(seqs, scores, length_normalize)


def make_beam_search_fn(model, beam_size: int, max_len: int,
                        length_normalize: bool = True) -> Callable:
    """``(feats, feat_masks, category=None) -> BeamResult`` over
    :func:`beam_search` (reference ``make_beam_search_fn``, without
    jit); ``category`` reaches the encode."""

    def fn(feats, feat_masks, category=None):
        return beam_search(model, feats, feat_masks, category,
                           beam_size=beam_size, max_len=max_len,
                           length_normalize=length_normalize)

    return fn


def beam_backend(model) -> str:
    """What :func:`beam_search` runs for ``model``: the fused CUDA kernel
    (``lstm_beam``, or ``attlstm_beam`` under attention fusion), or for
    a stacked model the per-step beam on the ``row_gemm`` products, on
    the card; their plain PyTorch versions on CPU tensors."""
    on_card = model.device.type == "cuda"
    if model.num_layers > 1:
        where = ("the row_gemm CUDA kernel" if on_card
                 else "plain PyTorch products on the CPU")
        return (f"per-step beam (num_layers={model.num_layers}; "
                f"decode_step on {where})")
    name = "attlstm_beam" if model.fusion == "attention" else "lstm_beam"
    if on_card:
        return f"{name} CUDA kernel"
    return f"{name}_ref, the plain PyTorch version on the CPU"


@torch.no_grad()
def beam_search_from_state(model, state: DecodeState, cache, *,
                           beam_size: int = 5, max_len: int = 30,
                           length_normalize: bool = True,
                           early_exit: bool = True) -> BeamResult:
    """Per-step beam search from a pre-encoded ``(state, cache)`` pair
    (``CaptionModel.init_decode``; reference ``beam_search_from_state``).
    Every per-video tensor is expanded to the flat (B*K) beam axis, then
    ``decode_step`` runs until every beam of every row has finished or
    ``max_len`` steps: a step in which all beams are finished only
    re-ranks equal-score PAD-frozen beams (the selection keeps their
    order) and the epilogue's sort is stable, so the early exit cannot
    change any output."""
    seqs, scores = per_step_beam(model, state, cache, beam_size=beam_size,
                                 max_len=max_len, early_exit=early_exit)
    return finalize_beams(seqs, scores, length_normalize)


@torch.no_grad()
def per_step_beam(model, state: DecodeState, cache, *, beam_size: int,
                  max_len: int, early_exit: bool = True):
    """The per-step beam's raw ``(seqs (B, K, L), scores (B, K))``, as
    the fused kernel returns them (:func:`beam_search_from_state`'s
    recurrence, before its epilogue)."""
    from cst_captioning_torch.models.captioner import _repeat_cache

    K = beam_size
    B = state.h.shape[1]
    state = DecodeState(h=state.h.repeat_interleave(K, dim=1),
                        c=state.c.repeat_interleave(K, dim=1))
    cache = _repeat_cache(cache, K)

    def step_logits(st, tokens):
        return model.decode_logits(st, cache, tokens)

    st = init_core(state, B, K, max_len, mode="beam")
    for _ in range(max_len):
        if early_exit and all_done(st):
            break
        st = decode_step(step_logits, st, mode="beam")
    return st.seqs, st.scores
