"""Helpers shared by the fused decode kernels' wrappers and their plain
versions (``ops/beam.py``, ``ops/sampler.py``).

Ports of the JAX package's shared decode pieces:

* ``pallas_sampler.py``: the murmur3 hash stream (``_fmix32``,
  ``_gumbel_from_counter``), the decode-policy bias (``_decode_bias``,
  ``_masked_vocab`` and its int8 twin ``_masked_vocab_q``) and the sampler's TPU tile picker (``_pick_tiles``,
  ``_resident_bytes``, 14 MiB budget).  The picker fixes the stream
  geometry — the batch tile ``bt`` that mixes the seed word and the
  padded vocab width ``V_pad`` in the counter — so the port reproduces
  the reference's multinomial stream exactly.  The CUDA kernels take
  that geometry as stream parameters, apart from their own tiling.
* ``pallas_beam.py``: the beam tile picker (its ``Vt`` fixes the
  log-sum-exp chunk order of the plain version) and the top-K pieces
  ``_row_topk``, ``_merge_topk``, ``_select_beams`` and
  ``_candidate_totals`` with the reference's tie order (value desc, id
  asc).

uint32 arithmetic is done in int64 with explicit ``& 0xFFFFFFFF``; a
product of two 32-bit words is split into 16-bit halves so no int64
product overflows.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from cst_captioning_torch.constants import BOS_ID, PAD_ID, UNK_ID
from cst_captioning_torch.ops.quant import dequant_rows

NEG_INF = -1e30
# Sentinel strictly below any real candidate (running top-K slots start
# here so the first tile evicts them all).
F32_MIN = -3.0e38
MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
GOLDEN = 0x9E3779B9
# The CUDA kernels' vocab tile width (csrc/decode_common.cuh L_TV) and
# their compute-dtype codes.
KERNEL_TILE_V = 128
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------- hash RNG

def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``b``, without overflowing int64."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & MASK32


def fmix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    z = z ^ (z >> 16)
    z = mul32(z, _M1)
    z = z ^ (z >> 13)
    z = mul32(z, _M2)
    z = z ^ (z >> 16)
    return z


def gumbel_from_counter(counter: torch.Tensor, seed_word: torch.Tensor) -> torch.Tensor:
    """counter (uint32 in int64, unique per sampled position) + mixed
    seed word -> standard Gumbel noise, float32."""
    bits = fmix32(fmix32((counter + seed_word) & MASK32))
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    u = u + 2.0 ** -25
    return -torch.log(-torch.log(u))


def seed_words(seed, rows: torch.Tensor, bt: int) -> torch.Tensor:
    """Per-row seed word: ``fmix32(fmix32(s0 + GOLDEN * tile_base) +
    s1)`` where ``tile_base`` is the first row of the row's ``bt``-tile
    (rows within a tile share the word; the counter separates them)."""
    s0, s1 = split_seed(seed)
    base = (rows // bt) * bt
    w = fmix32((s0 + mul32(base, GOLDEN)) & MASK32)
    return fmix32((w + s1) & MASK32)


def split_seed(seed) -> Tuple[int, int]:
    """Seed (int, or 1-2 ints / a tensor of them) -> two uint32 words; a
    scalar pads word 1 with zero, like the reference."""
    if isinstance(seed, torch.Tensor):
        vals = [int(v) for v in seed.reshape(-1).tolist()]
    elif isinstance(seed, (list, tuple)):
        vals = [int(v) for v in seed]
    else:
        vals = [int(seed)]
    vals = (vals + [0, 0])[:2]
    return vals[0] & MASK32, vals[1] & MASK32


# ------------------------------------------------------------ tile pickers

def _sampler_resident_bytes(bt: int, F: int, A: int, E: int, H: int,
                            Vt: int, itemsize: int) -> int:
    att = bt * F * (A + E) * itemsize
    weights = (H + 2 * E) * 4 * H * itemsize + H * A * itemsize
    wout = 2 * H * Vt * itemsize
    gx = bt * 4 * H * 4
    emb = bt * E * itemsize
    state = 2 * bt * H * 4
    return att + weights + wout + gx + emb + state


_SAMPLER_BUDGET = int(
    float(os.environ.get("CST_SAMPLER_VMEM_MB", "14")) * 1024 * 1024
)
_BEAM_BUDGET = int(
    float(os.environ.get("CST_BEAM_VMEM_MB", "14")) * 1024 * 1024
)


def sampler_pick_tiles(B: int, F: int, A: int, E: int, H: int,
                       itemsize: int) -> Tuple[int, int]:
    """The reference sampler's (bt, Vt): the stream geometry."""
    for Vt in (512, 256, 128):
        for bt in (64, 40, 32, 24, 16, 8):
            if B % bt:
                continue
            if _sampler_resident_bytes(bt, F, A, E, H, Vt,
                                       itemsize) <= _SAMPLER_BUDGET:
                return bt, Vt
    return 8, 128


def _beam_resident_bytes(btv: int, K: int, F: int, A: int, E: int, H: int,
                         Vt: int, L: int, itemsize: int) -> int:
    rt = btv * K
    att = rt * F * (A + E) * itemsize
    weights = (H + 2 * E) * 4 * H * itemsize + H * A * itemsize
    wout = 2 * H * Vt * itemsize
    gx = rt * 4 * H * 4
    emb = rt * E * itemsize
    state = 2 * rt * H * 4
    seqs = rt * L * 4
    return att + weights + wout + gx + emb + state + seqs


def beam_pick_tiles(B: int, K: int, F: int, A: int, E: int, H: int,
                    L: int, itemsize: int) -> Tuple[int, int]:
    """The reference beam kernel's (btv, Vt); ``Vt`` fixes the chunk
    order of the plain version's online log-sum-exp."""
    for Vt in (512, 256, 128):
        for btv in (16, 8, 4, 2, 1):
            if B % btv:
                continue
            if _beam_resident_bytes(btv, K, F, A, E, H, Vt, L,
                                    itemsize) <= _BEAM_BUDGET:
                return btv, Vt
    return 1, 128


# ------------------------------------------------------ operand checks

def unpack_quant(quant, compute_dtype, wh):
    """(compute dtype, (emb_scale, wout_scale, lstm_scale, att_scale) or
    None) of a fused decode call: without ``quant`` the weights carry the
    compute dtype; with it they are int8 codes and ``compute_dtype``
    names it (a meanpool call's 3-tuple gains ``att_scale`` None)."""
    if quant is None:
        return wh.dtype, None
    if compute_dtype is None:
        raise ValueError("int8w decode needs compute_dtype: the int8 codes "
                         "do not carry it")
    quant = tuple(quant) + (None,) * (4 - len(quant))
    return compute_dtype, quant


def check_operands(name: str, gx_static, w_x, wh, emb, w_out, b_out,
                   cdt=None):
    """Validate a fused decode call's operands for the CUDA kernel:
    returns (B, V, E, H, compute dtype) or raises on what the kernel
    does not take.  ``cdt`` given: an int8w call, the weights int8
    codes; else the weights' dtype is the compute dtype."""
    B = gx_static.shape[0]
    V, E = emb.shape
    H = wh.shape[0]
    wdt = torch.int8 if cdt is not None else wh.dtype
    cdt = wh.dtype if cdt is None else cdt
    if cdt not in KERNEL_DTYPES:
        raise TypeError(f"{name}: compute dtype {cdt} not supported")
    for arg, x, shape in (("w_x", w_x, (E, 4 * H)), ("wh", wh, (H, 4 * H)),
                          ("emb", emb, (V, E)), ("w_out", w_out, (H, V))):
        if x.dtype != wdt or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {arg} is {x.dtype}{tuple(x.shape)}, "
                             f"expected {wdt}{shape}")
    for arg, x in (("w_x", w_x), ("wh", wh), ("emb", emb), ("w_out", w_out),
                   ("b_out", b_out)):
        if x.device != gx_static.device:
            raise ValueError(f"{name}: {arg} on {x.device}, "
                             f"gx_static on {gx_static.device}")
    if tuple(gx_static.shape) != (B, 4 * H) or tuple(b_out.shape) != (V,):
        raise ValueError(f"{name}: gx_static / b_out shape mismatch")
    return B, V, E, H, cdt


# ------------------------------------------ bf16 tensor-core decoders

class TensorCoreShapeError(ValueError):
    """A shape the bf16 decoders' tensor-core chain does not take
    (``csrc/decode_tc.cuh``): E and H, and A under attention, must be
    multiples of 32.  The wrappers raise it instead of taking another
    path."""


def check_tc_widths(name: str, E: int, H: int, A=None) -> None:
    """Raise :class:`TensorCoreShapeError` unless E, H and (attention)
    A are positive multiples of 32 (the tile GEMMs split k on 32-deep
    chunks and read rows in 16-byte chunks)."""
    widths = (E, H) if A is None else (E, H, A)
    if min(widths) < 32 or any(w % 32 for w in widths):
        named = f"E={E}, H={H}" + ("" if A is None else f", A={A}")
        which = "E and H" if A is None else "E, H and A"
        raise TensorCoreShapeError(
            f"{name}: {named}: the bf16 tensor-core decoder takes {which} "
            "in multiples of 32")


def stage_tc_weights(w_x, w_ctx, wh, att_wh, emb, w_out_p, emb_scale=None):
    """The bf16 decoders' weights as the tensor-core chain reads them,
    staged once per call: ``(emb, wcat_t, att_wh_t, w_out_t)``.
    ``wcat_t`` is ``[W_x ; W_ctx ; W_h]^T`` (4H, 2E + H), or ``[W_x ;
    W_h]^T`` (4H, E + H) for meanpool (``w_ctx`` and ``att_wh`` None,
    ``att_wh_t`` then None); ``att_wh_t`` (A, H) and ``w_out_t`` (Vp, H)
    the tile GEMM's B^T of ``att_wh`` and the padded ``w_out_p``, all
    bf16: the operands the plain version rounds to bf16, or int8 codes
    widened to bf16 (exact, |code| <= 127).  ``emb`` is the (V, E) table
    of rows the plain version gathers: the bf16 table itself, or with
    ``emb_scale`` (int8w) every row as ``T(code * row scale)``
    (``quant.dequant_rows``)."""
    bf = torch.bfloat16
    t = lambda w: w.to(bf).t().contiguous()  # noqa: E731
    if emb_scale is None:
        table = emb.to(bf).contiguous()
    else:
        ids = torch.arange(emb.shape[0], device=emb.device)
        table = dequant_rows(emb, emb_scale, ids, bf).contiguous()
    gate_w = [w for w in (w_x, w_ctx, wh) if w is not None]
    return (table, t(torch.cat(gate_w)),
            None if att_wh is None else t(att_wh), t(w_out_p))


# ------------------------------------------------------- vocab masking

def decode_bias(b_out: torch.Tensor, V: int, V_pad: int,
                suppress_unk: bool) -> torch.Tensor:
    """Decode-policy bias (PAD/BOS, optional UNK -> -1e30) padded to
    ``V_pad`` with -1e30: masked and padded columns never win and add 0
    to the log-sum-exp."""
    bias = torch.full((V_pad,), NEG_INF, dtype=torch.float32,
                      device=b_out.device)
    bias[:V] = b_out.float()
    bias[PAD_ID] = NEG_INF
    bias[BOS_ID] = NEG_INF
    if suppress_unk:
        bias[UNK_ID] = NEG_INF
    return bias


def masked_vocab(b_out: torch.Tensor, w_out: torch.Tensor, V: int,
                 V_pad: int, suppress_unk: bool, cdt: torch.dtype):
    """(bias (V_pad,) f32, w_out padded to (H, V_pad) in ``cdt``)."""
    bias = decode_bias(b_out, V, V_pad, suppress_unk)
    if V_pad == V:
        return bias, w_out.to(cdt).contiguous()
    w_out_p = torch.zeros((w_out.shape[0], V_pad), dtype=cdt,
                          device=w_out.device)
    w_out_p[:, :V] = w_out.to(cdt)
    return bias, w_out_p


def masked_vocab_q(b_out: torch.Tensor, w_out_q: torch.Tensor,
                   w_scale: torch.Tensor, V: int, V_pad: int,
                   suppress_unk: bool):
    """Int8 twin of :func:`masked_vocab` (reference ``_masked_vocab_q``):
    (bias (V_pad,) f32, codes padded to (H, V_pad) with zeros, scales
    (V_pad,) f32 padded with ones).  A padded column's logit is 0 * 1 +
    (-1e30): inert in the max and the log-sum-exp, as in the float
    padding."""
    bias = decode_bias(b_out, V, V_pad, suppress_unk)
    ws = w_scale.float()
    if V_pad == V:
        return bias, w_out_q.contiguous(), ws.contiguous()
    w_out_p = torch.zeros((w_out_q.shape[0], V_pad), dtype=torch.int8,
                          device=w_out_q.device)
    w_out_p[:, :V] = w_out_q
    ws_p = torch.ones((V_pad,), dtype=torch.float32, device=w_out_q.device)
    ws_p[:V] = ws
    return bias, w_out_p, ws_p


def check_quant_scales(name: str, quant, V: int, H: int, A: int, device):
    """Validate an int8w call's float32 scales (``unpack_quant``'s
    tuple; ``A`` 0 for meanpool): returns them contiguous."""
    want = (("emb_scale", V), ("wout_scale", V), ("lstm_scale", 4 * H),
            ("att_scale", A))
    out = []
    for (arg, n), x in zip(want, quant):
        if n == 0:
            out.append(None)
            continue
        if (x is None or x.dtype != torch.float32 or tuple(x.shape) != (n,)
                or x.device != device):
            got = None if x is None else f"{x.dtype}{tuple(x.shape)}"
            raise ValueError(f"{name}: {arg} is {got}, expected "
                             f"float32({n},) on {device}")
        out.append(x.contiguous())
    return out


# ------------------------------------------------------------ beam top-K

def row_topk(values: torch.Tensor, ids: torch.Tensor, k: int):
    """Per-row top-``k`` by (value desc, id asc) — ``jax.lax.top_k``'s
    order over values keyed by ascending ids.  Stable sorts: first by
    id, then by value descending, so equal values keep id order."""
    by_id = torch.argsort(ids, dim=-1, stable=True)
    v = torch.gather(values, -1, by_id)
    i = torch.gather(ids, -1, by_id)
    order = torch.sort(v, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(v, -1, order), torch.gather(i, -1, order)


def merge_topk(run_v, run_i, tile_v, tile_i, k: int):
    """Merge a tile's top-k into the running top-k (both (R, k))."""
    return row_topk(torch.cat([run_v, tile_v], -1),
                    torch.cat([run_i, tile_i], -1), k)


def select_beams(totals: torch.Tensor, keys: torch.Tensor, K: int, V: int):
    """Per-video next beams from the K·K candidate union (flat keys
    ``k*V + v``) -> (scores, parent, tok), each (nv, K)."""
    sc, key = row_topk(totals, keys, K)
    parent = torch.div(key, V, rounding_mode="floor")
    tok = key - parent * V
    return sc, parent, tok


def candidate_totals(top_v, top_i, m, ssum, score, fin, K: int, V: int):
    """Per-row top-K logits -> (totals, flat keys).  ``logp = (logit -
    max) - log(ssum)``, ``total = score + logp``; a finished row
    collapses to ``[(PAD, score + 0.0), (1..K-1, score + NEG_INF)]``."""
    logp = (top_v - m) - torch.log(ssum)
    totals = score + logp
    R = top_v.shape[0]
    dev = top_v.device
    beam = (torch.arange(R, device=dev) % K)[:, None]
    keys = beam * V + top_i
    j = torch.arange(top_i.shape[1], device=dev)[None, :]
    fin_tot = torch.where(j == 0, score + 0.0, score + NEG_INF)
    fin_keys = beam * V + torch.where(j == 0, torch.full_like(j, PAD_ID), j)
    is_fin = fin > 0.0
    return (torch.where(is_fin, fin_tot, totals),
            torch.where(is_fin, fin_keys, keys))
