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
"""

from __future__ import annotations

from typing import NamedTuple

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


def beam_search(model, feats, feat_masks, *, beam_size: int = 5,
                max_len: int = 30, length_normalize: bool = True) -> BeamResult:
    """Beam search for a batch of videos through the fused kernel."""
    seqs, scores = model.fused_beam(feats, feat_masks, beam_size=beam_size,
                                    max_len=max_len)
    return finalize_beams(seqs, scores, length_normalize)


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
    return finalize_beams(st.seqs, st.scores, length_normalize)
