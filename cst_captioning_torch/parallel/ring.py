"""Sequence / frame parallelism (port of the JAX package's
``parallel/ring.py``), plain PyTorch as the reference's is plain XLA.

* :func:`ring_attention`: exact blockwise-softmax attention with Q/K/V
  (B, S, H) split along S over a mesh axis.  Each query shard visits the
  key/value shards in ring order (its own first, then the next one
  round), folding flash-style running (max, sum, weighted sum)
  accumulators in float32; the reference rotates K/V with ``ppermute``,
  the one controller reads each shard where it lies.
* :func:`sharded_context_attention`: the captioner's single-query
  Bahdanau attention with the FRAME axis split over ``axis``: each shard
  scores its frames and the softmax is assembled from the shards'
  (max, sum of exp, weighted sum of values), folded in shard order.
  ``CaptionModel._context`` takes it under ``model.shard_frames``
  ahead of the ``fused_context_attention`` kernel.

Both take whole tensors and a :class:`~cst_captioning_torch.parallel.
mesh.Mesh`, split them over the axis's devices (a shard's rows go to
its own device), and return the result on the query's device; both are
differentiable.
"""

from __future__ import annotations

from typing import Optional

import torch

from cst_captioning_torch.ops.rnn import dot_f32
from cst_captioning_torch.parallel.collectives import pmax, psum

NEG_INF = -1e30


def _axis_devices(mesh, axis: str):
    return mesh.model_row(0) if axis == "model" else [
        mesh.devices[(i,) + (0,) * (mesh.devices.ndim - 1)]
        for i in range(mesh.shape[axis])]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "model",
                   kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention with Q/K/V (B, S, H) split along S over ``axis``;
    ``kv_mask`` (B, S) marks valid keys.  Scale 1/sqrt(H).  Returns (B,
    S, H) in ``q``'s dtype on ``q``'s device."""
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.float32,
                             device=k.device)
    devs = _axis_devices(mesh, axis)
    p = len(devs)
    if q.shape[1] % p or k.shape[1] % p:
        raise ValueError(f"sequence {q.shape[1]} / {k.shape[1]} does not "
                         f"split over the {p}-way {axis!r} axis")
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qs = [x.to(d) for x, d in zip(q.chunk(p, 1), devs)]
    ks = [x.to(d) for x, d in zip(k.chunk(p, 1), devs)]
    vs = [x.to(d) for x, d in zip(v.chunk(p, 1), devs)]
    ms = [x.to(d) for x, d in zip(kv_mask.chunk(p, 1), devs)]
    outs = []
    for i, (qi, dev) in enumerate(zip(qs, devs)):
        qf = qi.float() * scale
        B, Sq, _ = qi.shape
        m = torch.full((B, Sq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Sq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, Sq, v.shape[-1]), dtype=torch.float32,
                        device=dev)
        for step in range(p):
            j = (i - step) % p          # the block that reaches i at `step`
            kj, vj, mj = (x.to(dev) for x in (ks[j], vs[j], ms[j]))
            s = torch.einsum("bqh,bkh->bqk", qf, kj.float())
            valid = mj[:, None, :] > 0
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            alpha = torch.exp(m - m_new)
            pexp = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + pexp.sum(-1)
            o = o * alpha[..., None] + torch.einsum("bqk,bkh->bqh", pexp,
                                                    vj.float())
            m = m_new
        outs.append((o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat([x.to(q.device) for x in outs], dim=1)


def sharded_context_attention(query: torch.Tensor, att_vals: torch.Tensor,
                              att_proj: torch.Tensor, att_mask: torch.Tensor,
                              att_v: torch.Tensor, mesh, axis: str = "model",
                              batch_axis: Optional[str] = None
                              ) -> torch.Tensor:
    """Frame-sharded Bahdanau context (reference
    ``sharded_context_attention``): ``query`` (B, A) in the values'
    dtype; ``att_vals`` (B, F, E), ``att_proj`` (B, F, A), ``att_mask``
    (B, F) split along F over ``axis``; ``att_v`` (A, 1).  The score
    ``tanh(proj + q) @ att_v`` is rounded like the reference's matmul in
    the compute dtype; the max is detached (it cancels in value and
    gradient).  ``batch_axis`` also splits B over that axis (each block
    of rows folds over its own frame shards).  Returns (B, E) in the
    values' dtype on ``query``'s device."""
    p = mesh.shape[axis]
    if att_vals.shape[1] % p:
        raise ValueError(f"{att_vals.shape[1]} frames do not split over the "
                         f"{p}-way {axis!r} axis")
    nb = 1
    if batch_axis is not None and mesh.shape.get(batch_axis, 1) > 1:
        nb = mesh.shape[batch_axis]
        if query.shape[0] % nb:
            nb = 1
    cdt = att_vals.dtype
    outs = []
    for i, (qb, vb, pb, mb) in enumerate(zip(
            query.chunk(nb, 0), att_vals.chunk(nb, 0), att_proj.chunk(nb, 0),
            att_mask.chunk(nb, 0))):
        # Row block i lives on data row i's frame shards.
        devs = (mesh.model_row(i) if axis == "model" and nb > 1
                else _axis_devices(mesh, axis))
        scores, vals, masks = [], [], []
        for d, v_, p_, m_ in zip(devs, vb.chunk(p, 1), pb.chunk(p, 1),
                                 mb.chunk(p, 1)):
            q = qb.to(d)
            th = torch.tanh(p_.to(d) + q[:, None, :])
            s = dot_f32(th, att_v.to(d), cdt)[..., 0].to(cdt).float()
            mk = m_.to(d)
            scores.append(torch.where(mk > 0, s, NEG_INF))
            vals.append(v_.to(d))
            masks.append(mk)
        m = pmax([s.detach().max(dim=-1).values for s in scores],
                 query.device)
        es = [torch.where(mk > 0, torch.exp(s - m.to(s.device)[:, None]), 0.0)
              for s, mk in zip(scores, masks)]
        l = psum([e.sum(-1) for e in es], query.device)
        ctx = psum([torch.einsum("bf,bfe->be", e, v.float())
                    for e, v in zip(es, vals)], query.device)
        outs.append((ctx / torch.clamp(l, min=1e-30)[:, None]).to(cdt))
    return torch.cat(outs, dim=0)
