"""Batched beam search (port of the JAX package's ``decoding/beam.py``,
the fused path).

``beam_search`` encodes once and runs the whole (B, K) recurrence in the
``lstm_beam`` kernel (``models/captioner.py::CaptionModel.fused_beam``);
``finalize_beams`` is the shared epilogue: length normalization (divide
the raw log-prob by the token count) and best-first order.  The
reference's per-step scan path is not ported: every configuration this
slice accepts takes the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cst_captioning_torch.constants import PAD_ID


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
