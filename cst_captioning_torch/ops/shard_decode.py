"""Tensor-parallel fused decode with the cross-shard top-K merge (port
of the JAX package's ``ops/shard_decode.py``).

The vocab splits over the ``model`` axis of a mesh row (the
``parallel/partition.py`` layout): shard j owns ``w_out`` columns, bias
entries and ``emb`` rows [j·V/M, (j+1)·V/M) and keeps them on its own
device.  Each decode step

* looks up the fed tokens' embeddings by a masked local lookup on every
  shard plus one fixed-order sum (``parallel/collectives.py::
  embedding_rows``, the reference's ``_emb_psum``);
* runs the recurrence once, on the lead device, with every product
  through the row-invariant ``row_gemm`` kernel (``ops/rowgemm.py``);
  the attention step is the plain math the reference's port runs;
* runs each shard's (H, V/M) vocab product through ``row_gemm`` on the
  shard's device.  ``row_gemm`` sums each output in a fixed k order
  whatever the rows or columns, so every logit column is bitwise the
  single-device column (docs/PARITY.md r12);
* beam: each shard takes its K best ``(logit, global id)`` pairs by
  (value desc, id asc), one gather builds the (rows, M·K) candidate
  table, and a re-top-K of the union is exactly the global per-row top-K
  (any global top-K element is in its shard's top-K); sampler: each shard
  takes its Gumbel-max (or argmax) winner and the winners merge by (z
  desc, id asc).  The hash-Gumbel counters key on the GLOBAL vocab
  position and the reference's stream geometry, so multinomial tokens
  are the single-device kernel's bit for bit;
* folds the log-softmax normalizer from the shards' (max, sum of exp):
  the sampler's in float32, a per-row constant shift of at most an ulp
  (r15) that moves no token; the beam's sums of the float32 exps in
  float64, as ``decoding/core.py::beam_log_softmax`` does, so the folded
  normalizer rounds to the bits of the same decoder over one shard and
  near-ties across beams resolve as there (the reference folds in
  float32).

The whole-recurrence kernels (``ops/beam.py``, ``ops/sampler.py``) stay
the single-device path: no kernel can hold a collective in the middle of
its recurrence, so here the recurrence runs step by step, as in the
reference.  Finished rows, PAD feeds and the decode mask follow the
plain versions ``_beam_ref`` / ``_sample_ref`` (a masked column takes no
Gumbel draw, as there).

``emb`` / ``w_out`` / ``b_out`` (and the int8w ``emb_scale`` /
``wout_scale`` of ``quant``) are whole tensors, split here over the
axis's devices, or lists of shards already placed (the sharded model's
``VocabShards``).  int8w: each shard streams its int8 code tile with its
scale slice, dequantized as ``quant_matmul`` (scale after the float32
sum, float32 bias, no rounding to the compute dtype).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID, UNK_ID
from cst_captioning_torch.ops.attlstm import attention_step
from cst_captioning_torch.ops.decode_common import (
    MASK32,
    MASKED_LOGIT,
    NEG_INF,
    candidate_totals,
    gumbel_from_counter,
    mul32,
    row_topk,
    seed_words,
    select_beams,
    unpack_quant,
)
from cst_captioning_torch.ops.rnn import gate_update
from cst_captioning_torch.ops.rowgemm import row_dot
from cst_captioning_torch.ops.sampler import _inv_temp, stream_geometry
from cst_captioning_torch.parallel.collectives import (
    embedding_rows,
    pmax,
    psum,
)


def shard_decode_ok(V: int, model_shards: int, K: int = 1) -> bool:
    """The vocab splits evenly over the model axis and each shard's tile
    can give K candidates (the union argument needs a per-shard top-K)."""
    return (model_shards > 1 and V % model_shards == 0
            and V // model_shards >= max(K, 1))


def _axis_devices(mesh, axis: str) -> List[torch.device]:
    if axis != "model":
        raise ValueError(f"the vocab shards over 'model', not {axis!r}")
    return mesh.model_row(0)


def _shards(x, devs, dim: int) -> Optional[List[torch.Tensor]]:
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return list(x)
    return [c.to(d).contiguous() for c, d in zip(x.chunk(len(devs), dim),
                                                  devs)]


def _vocab_tiles(emb, w_out, b_out, quant, devs, cdt, suppress_unk):
    """Per-shard (emb, emb_scale, w_out, w_scale, masked bias) lists:
    float weights in ``cdt``, int8 codes as they are; the decode mask's
    PAD / BOS (and UNK) columns at -1e30 on the shards owning them."""
    embs = _shards(emb, devs, 0)
    wos = _shards(w_out, devs, 1)
    bs = _shards(b_out, devs, 0)
    emb_s = ws = None
    if quant is not None:
        emb_s = [x.float() for x in _shards(quant[0], devs, 0)]
        ws = [x.float() for x in _shards(quant[1], devs, 0)]
    masked = [PAD_ID, BOS_ID] + ([UNK_ID] if suppress_unk else [])
    biases, col0 = [], 0
    for b in bs:
        b = b.float().clone()
        for c in masked:
            if col0 <= c < col0 + b.shape[0]:
                b[c - col0] = NEG_INF
        biases.append(b)
        col0 += b.shape[0]
    if quant is None:
        wos = [w.to(cdt).contiguous() for w in wos]
    return embs, emb_s, wos, ws, biases


def _local_logits(h, wos, ws, biases, cdt, quant: bool):
    """Each shard's (rows, V/M) logit tile on its device: float rounds
    the product and the bias to ``cdt`` (``CaptionModel._logits``),
    int8w scales the float32 sum and adds the float32 bias."""
    out = []
    for j, (w, b) in enumerate(zip(wos, biases)):
        hj = h.to(w.device)
        if quant:
            out.append(row_dot(hj, w, cdt, ws[j]) + b)
        else:
            out.append((row_dot(hj, w, cdt).to(cdt) + b.to(cdt)).float())
    return out


def _gates(gx, emb_tok, h, w_x, wh, w_ctx, ctx, cdt, ls):
    """The kernels' gate sum ``gxs + emb [+ ctx] + h`` (reference
    ``_gates``), every product through ``row_dot``."""
    gates = gx + row_dot(emb_tok, w_x, cdt, ls)
    if ctx is not None:
        gates = gates + row_dot(ctx, w_ctx, cdt, ls)
    return gates + row_dot(h, wh, cdt, ls)


def _ctx(h, att, cdt, att_s):
    if att is None:
        return None
    _, att_wh, vvec, proj, maskf, vals_f = att
    return attention_step(h, att_wh, vvec, proj, maskf, vals_f, cdt,
                          att_s)[0]


def _att_rows(att, repeat: int):
    """The attention operands as the step reads them (rows repeated
    ``repeat`` times for the beam), float32 mask / values / score
    vector."""
    if att is None:
        return None
    w_ctx, att_wh, att_v, proj, mask, vals = att
    r = (lambda x: x.repeat_interleave(repeat, dim=0)) if repeat > 1 else (
        lambda x: x)  # noqa: E731
    return (w_ctx, att_wh, att_v.float()[:, 0], r(proj), r(mask.float()),
            r(vals).float())


# ------------------------------------------------------------------ beam

def _sharded_beam_impl(gx_static, w_x, wh, att, emb, w_out, b_out, mesh,
                       axis, beam_size, max_len, suppress_unk, quant=None,
                       compute_dtype=None):
    K, T = beam_size, max_len
    B = gx_static.shape[0]
    H = wh.shape[0]
    R = B * K
    dev = gx_static.device
    devs = _axis_devices(mesh, axis)
    cdt, quant = unpack_quant(quant, compute_dtype, wh)
    embs, emb_s, wos, ws, biases = _vocab_tiles(
        emb, w_out, b_out, quant, devs, cdt, suppress_unk)
    V = sum(e.shape[0] for e in embs)
    ls = att_s = None
    if quant is not None:
        ls = quant[2].float()
        att_s = None if quant[3] is None else quant[3].float()
    att_r = _att_rows(att, K)
    gx_r = gx_static.float().repeat_interleave(K, dim=0)
    gcols, col0 = [], 0
    for w in wos:
        n = w.shape[1]
        gcols.append(torch.arange(col0, col0 + n, device=w.device)[None, :]
                     .expand(R, n))
        col0 += n

    h = torch.zeros((R, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    fin = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    beam = (torch.arange(R, device=dev) % K)[:, None]
    score = torch.where(beam == 0, 0.0, NEG_INF).to(torch.float32)
    seqs = torch.full((B, K, T), PAD_ID, dtype=torch.long, device=dev)
    tok = torch.full((R,), BOS_ID, dtype=torch.long, device=dev)
    bix = torch.arange(B, device=dev)[:, None]
    for t in range(T):
        emb_tok = embedding_rows(embs, tok, cdt, emb_s)
        ctx = _ctx(h, att_r, cdt, att_s)
        gates = _gates(gx_r, emb_tok, h, w_x, wh,
                       None if att is None else att[0], ctx, cdt, ls)
        h_new, c_new = gate_update(gates, c)
        logits = _local_logits(h_new, wos, ws, biases, cdt,
                               quant is not None)
        m = pmax([x.max(dim=-1, keepdim=True).values for x in logits], dev)
        lse = torch.log(psum([
            torch.exp(x - m.to(x.device)).sum(dim=-1, keepdim=True,
                                              dtype=torch.float64)
            for x in logits], dev)).float()
        cand = [row_topk(x, g, K) for x, g in zip(logits, gcols)]
        top_v = torch.cat([v.to(dev) for v, _ in cand], dim=-1)
        top_i = torch.cat([i.to(dev) for _, i in cand], dim=-1)
        top_v, top_i = row_topk(top_v, top_i, K)
        totals, keys = candidate_totals(top_v, top_i, m, None, score, fin,
                                        K, V, lse=lse)
        sc, parent, tok_sel = select_beams(
            totals.reshape(B, K * K), keys.reshape(B, K * K), K, V)
        seqs = seqs[bix, parent]
        seqs[:, :, t] = tok_sel
        ended = (tok_sel == EOS_ID) | (tok_sel == PAD_ID)
        fin = torch.maximum(fin.reshape(B, K)[bix, parent],
                            ended.float()).reshape(R, 1)
        flat_parent = (bix * K + parent).reshape(-1)
        h = h_new[flat_parent]
        c = c_new[flat_parent]
        tok = torch.where(tok_sel == PAD_ID, EOS_ID, tok_sel).reshape(-1)
        score = sc.reshape(R, 1)
    return seqs.to(torch.int32), score.reshape(B, K)


def sharded_lstm_beam(gx_static, w_x, wh, emb, w_out, b_out, *, mesh,
                      axis: str = "model", beam_size: int, max_len: int,
                      suppress_unk: bool = False, quant=None,
                      compute_dtype=None):
    """Meanpool sharded beam search (reference ``sharded_lstm_beam``):
    ``(seqs (B, K, L) int32, scores (B, K))`` for
    ``decoding.beam.finalize_beams``."""
    return _sharded_beam_impl(gx_static, w_x, wh, None, emb, w_out, b_out,
                              mesh, axis, beam_size, max_len, suppress_unk,
                              quant, compute_dtype)


def sharded_attlstm_beam(gx_static, w_x, wh, w_ctx, att_wh, att_v, att_proj,
                         att_mask, att_vals, emb, w_out, b_out, *, mesh,
                         axis: str = "model", beam_size: int, max_len: int,
                         suppress_unk: bool = False, quant=None,
                         compute_dtype=None):
    """Attention-fusion sharded beam search (reference
    ``sharded_attlstm_beam``)."""
    return _sharded_beam_impl(
        gx_static, w_x, wh, (w_ctx, att_wh, att_v, att_proj, att_mask,
                             att_vals),
        emb, w_out, b_out, mesh, axis, beam_size, max_len, suppress_unk,
        quant, compute_dtype)


# --------------------------------------------------------------- sampler

def _sharded_sample_impl(gx_static, w_x, wh, att, emb, w_out, b_out, seed,
                         mesh, axis, max_len, greedy, temperature,
                         suppress_unk, quant=None, compute_dtype=None):
    T = max_len
    B = gx_static.shape[0]
    H = wh.shape[0]
    E = w_x.shape[0]
    dev = gx_static.device
    devs = _axis_devices(mesh, axis)
    cdt, quant = unpack_quant(quant, compute_dtype, wh)
    embs, emb_s, wos, ws, biases = _vocab_tiles(
        emb, w_out, b_out, quant, devs, cdt, suppress_unk)
    V = sum(e.shape[0] for e in embs)
    F, A = (0, 0) if att is None else tuple(att[3].shape[1:])
    _, V_pad = stream_geometry(B, E, H, cdt, V, F, A)
    ls = att_s = None
    if quant is not None:
        ls = quant[2].float()
        att_s = None if quant[3] is None else quant[3].float()
    att_r = _att_rows(att, 1)
    gx = gx_static.float()
    bt, _ = stream_geometry(B, E, H, cdt, V, F, A)
    rows = torch.arange(B, dtype=torch.long, device=dev)
    sw = seed_words(seed, rows, bt)[:, None]
    inv_temp = _inv_temp(greedy, temperature)
    gcols, col0 = [], 0
    for w in wos:
        n = w.shape[1]
        gcols.append(torch.arange(col0, col0 + n, dtype=torch.long,
                                  device=w.device)[None, :])
        col0 += n

    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    fin = torch.zeros((B,), dtype=torch.bool, device=dev)
    tok = torch.full((B,), BOS_ID, dtype=torch.long, device=dev)
    toks, lps, msks = [], [], []
    for t in range(T):
        emb_tok = embedding_rows(embs, tok, cdt, emb_s)
        ctx = _ctx(h, att_r, cdt, att_s)
        gates = _gates(gx, emb_tok, h, w_x, wh,
                       None if att is None else att[0], ctx, cdt, ls)
        h, c = gate_update(gates, c)
        logits = _local_logits(h, wos, ws, biases, cdt, quant is not None)
        zs, ids, scs, scaled_all = [], [], [], []
        for x, g in zip(logits, gcols):
            d = x.device
            scaled = x * inv_temp.to(d)
            if greedy:
                z = scaled
            else:
                counter = (mul32(rows.to(d) * T + t, V_pad)[:, None]
                           + g) & MASK32
                z = scaled + torch.where(
                    x > MASKED_LOGIT,
                    gumbel_from_counter(counter, sw.to(d)), 0.0)
            arg = torch.argmax(z, dim=-1)
            zs.append(z.gather(-1, arg[:, None]).to(dev))
            scs.append(scaled.gather(-1, arg[:, None]).to(dev))
            ids.append((arg + g[0, 0]).to(dev)[:, None])
            scaled_all.append(scaled)
        zs, ids, scs = (torch.cat(x, dim=-1) for x in (zs, ids, scs))
        # (z desc, id asc): per-shard ids ascend with the shard order,
        # so the first maximum in shard order is the lowest id.
        best = torch.argmax(zs, dim=-1, keepdim=True)
        nxt = ids.gather(-1, best)[:, 0]
        chosen = scs.gather(-1, best)[:, 0]
        m = pmax([s.max(dim=-1, keepdim=True).values for s in scaled_all],
                 dev)
        ssum = psum([torch.exp(s - m.to(s.device)).sum(dim=-1, keepdim=True)
                     for s in scaled_all], dev)
        tok_lp = chosen - (m + torch.log(ssum))[:, 0]
        valid = ~fin
        out_tok = torch.where(valid, nxt, PAD_ID)
        toks.append(out_tok)
        lps.append(torch.where(valid, tok_lp, 0.0))
        msks.append(valid.float())
        fin = fin | (nxt == EOS_ID) | (nxt == PAD_ID)
        tok = torch.where(out_tok == PAD_ID, EOS_ID, out_tok)
    return (torch.stack(toks, 1).to(torch.int32), torch.stack(lps, 1),
            torch.stack(msks, 1))


def sharded_lstm_sample(gx_static, w_x, wh, emb, w_out, b_out, seed, *, mesh,
                        axis: str = "model", max_len: int, greedy: bool,
                        temperature: float = 1.0, suppress_unk: bool = False,
                        quant=None, compute_dtype=None):
    """Meanpool sharded sample (reference ``sharded_lstm_sample``):
    ``(tokens (B, L) int32, logprobs (B, L), mask (B, L))``."""
    return _sharded_sample_impl(gx_static, w_x, wh, None, emb, w_out, b_out,
                                seed, mesh, axis, max_len, greedy,
                                temperature, suppress_unk, quant,
                                compute_dtype)


def sharded_attlstm_sample(gx_static, w_x, wh, w_ctx, att_wh, att_v,
                           att_proj, att_mask, att_vals, emb, w_out, b_out,
                           seed, *, mesh, axis: str = "model", max_len: int,
                           greedy: bool, temperature: float = 1.0,
                           suppress_unk: bool = False, quant=None,
                           compute_dtype=None):
    """Attention-fusion sharded sample (reference
    ``sharded_attlstm_sample``)."""
    return _sharded_sample_impl(
        gx_static, w_x, wh, (w_ctx, att_wh, att_v, att_proj, att_mask,
                             att_vals),
        emb, w_out, b_out, seed, mesh, axis, max_len, greedy, temperature,
        suppress_unk, quant, compute_dtype)
