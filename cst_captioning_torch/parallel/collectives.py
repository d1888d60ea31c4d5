"""Collectives over a mesh axis, run by the one controller (the
counterparts of ``jax.lax.psum`` / ``pmax`` / ``all_gather`` inside the
reference's ``shard_map`` bodies).

Each shard's tensor lives on its own device.  :func:`psum` copies every
shard to the destination and adds them in shard order 0, 1, ..., M-1;
:func:`all_gather` concatenates them in that order.  The order is fixed,
so the same mesh gives the same bits on every run (docs/PARITY.md r12).
Across cards the copies are peer copies; where one device stands at
several positions they are copies within it.  Every function here is
differentiable: autograd carries a gradient back through the copies to
each shard's own device.

Vocab parallelism (the ``model`` axis):

* :func:`embedding_rows`: the next-token embedding under a row-sharded
  table, a masked local lookup on each shard plus one :func:`psum` (the
  reference's ``_emb_psum``; exact, since the shards that do not own a
  row add zeros);
* :class:`VocabShardedLogits`: (..., V) logits held as M (..., V/M)
  column tiles, one on each shard's device;
* :func:`token_logprobs`: ``log_softmax(logits)[target]`` of either a
  plain tensor or sharded logits.  The sharded form is the autograd
  Function :class:`VocabParallelLogSoftmax`: the global max is the max
  of the shards' maxima (exact), the normalizer folds the shards'
  partial sums of ``exp(l - max)`` in shard order, and each shard's
  gradient ``g * (onehot - softmax)`` lands on its own logits.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cst_captioning_torch.constants import BOS_ID, PAD_ID, UNK_ID

NEG_INF = -1e30


def psum(xs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Sum of the shards ``xs`` on ``device``, added in shard order."""
    out = xs[0].to(device)
    for x in xs[1:]:
        out = out + x.to(device)
    return out


def pmax(xs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Elementwise max of the shards on ``device`` (exact in any order)."""
    out = xs[0].to(device)
    for x in xs[1:]:
        out = torch.maximum(out, x.to(device))
    return out


def all_gather(xs: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """The shards concatenated along ``dim`` on ``device``, shard order."""
    return torch.cat([x.to(device) for x in xs], dim=dim)


def embedding_rows(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                   cdt: torch.dtype,
                   scales: Optional[Sequence[torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Rows ``ids`` (any shape, on the result's device) of a table held
    as row shards ``tables[j]`` (V/M, E), in ``cdt``: each shard looks up
    the ids it owns and zeros the rest, and the shards sum in order.
    ``scales``: the int8w row scales' shards (``dequant_rows`` then
    runs on each shard's rows)."""
    from cst_captioning_torch.ops.quant import dequant_rows

    dev = ids.device
    parts = []
    col0 = 0
    for j, tab in enumerate(tables):
        vloc = tab.shape[0]
        local = ids.to(tab.device) - col0
        valid = (local >= 0) & (local < vloc)
        idx = local.clamp(0, vloc - 1)
        if scales is None:
            rows = tab.to(cdt)[idx]
        else:
            rows = dequant_rows(tab, scales[j], idx, cdt)
        parts.append(torch.where(valid[..., None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device)))
        col0 += vloc
    return psum(parts, dev)


class VocabShardedLogits:
    """Logits (..., V) held as column tiles ``shards[j]`` (..., V/M) on
    the shards' devices (shard j owns columns [j·V/M, (j+1)·V/M));
    ``lead`` is where a merge or a gather lands."""

    def __init__(self, shards: Sequence[torch.Tensor], lead):
        self.shards = list(shards)
        self.lead = torch.device(lead)
        self.vloc = int(self.shards[0].shape[-1])
        self.V = self.vloc * len(self.shards)

    @property
    def shape(self):
        return tuple(self.shards[0].shape[:-1]) + (self.V,)

    def col0(self, j: int) -> int:
        return j * self.vloc

    def _map(self, fn) -> "VocabShardedLogits":
        return VocabShardedLogits([fn(x) for x in self.shards], self.lead)

    def __truediv__(self, other) -> "VocabShardedLogits":
        if isinstance(other, torch.Tensor):
            return self._map(lambda x: x / other.to(x.device))
        return self._map(lambda x: x / other)

    def gather(self, device=None) -> torch.Tensor:
        """The full (..., V) logits on ``device`` (default ``lead``)."""
        return all_gather(self.shards, -1,
                          self.lead if device is None else device)

    def mask_decode(self, suppress_unk: bool = False) -> "VocabShardedLogits":
        """A copy with the decode policy's PAD / BOS (and UNK) columns at
        -1e30 on the shards that own them
        (``CaptionModel.mask_decode_logits``)."""
        cols = [PAD_ID, BOS_ID] + ([UNK_ID] if suppress_unk else [])
        out = []
        for j, x in enumerate(self.shards):
            mine = [c - self.col0(j) for c in cols
                    if 0 <= c - self.col0(j) < self.vloc]
            if mine:
                x = x.clone()
                x[..., mine] = NEG_INF
            out.append(x)
        return VocabShardedLogits(out, self.lead)

    def log_softmax_stats(self):
        """(global max (..., 1), sum of exp(l - max) (..., 1)) on
        ``lead``: the max exact, the sum folded in shard order."""
        m = pmax([x.max(dim=-1, keepdim=True).values for x in self.shards],
                 self.lead)
        s = psum([torch.exp(x - m.to(x.device)).sum(dim=-1, keepdim=True)
                  for x in self.shards], self.lead)
        return m, s


class VocabParallelLogSoftmax(torch.autograd.Function):
    """``log_softmax(logits)[target]`` over vocab-sharded logits; see the
    module doc.  ``forward(targets, lead, *shards)``: ``targets`` (...)
    int64 on ``lead``; returns (...) float32 on ``lead``."""

    @staticmethod
    def forward(ctx, targets, lead, *shards):
        sl = VocabShardedLogits([s.float() for s in shards], lead)
        m, s = sl.log_softmax_stats()
        lse = m + torch.log(s)                                  # (..., 1)
        picks = []
        for j, x in enumerate(sl.shards):
            local = targets.to(x.device) - sl.col0(j)
            valid = (local >= 0) & (local < sl.vloc)
            got = torch.gather(x, -1, local.clamp(0, sl.vloc - 1)[..., None])
            picks.append(torch.where(valid[..., None], got, 0.0))
        out = psum(picks, lead) - lse
        ctx.save_for_backward(targets, lse, *shards)
        ctx.vloc = sl.vloc
        return out[..., 0]

    @staticmethod
    def backward(ctx, g):
        targets, lse, *shards = ctx.saved_tensors
        grads = []
        for j, x in enumerate(shards):
            dev = x.device
            p = torch.exp(x.float() - lse.to(dev))
            gj = g.to(dev)[..., None]
            grad = -gj * p
            local = targets.to(dev) - j * ctx.vloc
            valid = ((local >= 0) & (local < ctx.vloc))[..., None]
            onehot = torch.zeros_like(grad).scatter_(
                -1, local.clamp(0, ctx.vloc - 1)[..., None], 1.0)
            grad = grad + torch.where(valid, onehot, 0.0) * gj
            grads.append(grad.to(x.dtype))
        return (None, None) + tuple(grads)


def token_logprobs(logits, targets: torch.Tensor) -> torch.Tensor:
    """``log_softmax(logits)[..., target]`` in float32 for a plain
    (..., V) tensor or :class:`VocabShardedLogits`."""
    if isinstance(logits, VocabShardedLogits):
        return VocabParallelLogSoftmax.apply(targets.long(), logits.lead,
                                             *logits.shards)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, targets.long()[..., None])[..., 0]
