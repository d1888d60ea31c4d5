"""The cluster design of the context attention kernels
(``csrc/context_attention.cu``, ``csrc/context_attention_bwd.cu`` on
``csrc/context_common.cuh``), as far as the CPU can hold it:

* the summation orders the kernels take, run here in numpy float32 one
  operation at a time (``kernel_forward`` / ``kernel_backward``), against
  the JAX package's Pallas kernels in interpret mode
  (``ops/pallas_attention.py::_fused_fwd_call`` and ``_fused_vjp_bwd``,
  through the VJP of ``jnp.repeat`` where rep > 1), at the tolerances
  ``chip_smoke.py`` holds the kernels to on the card (phase 2e's
  ``CTX_*``, phase 2g's ``CTXB_*``).  The orders: the score a warp's
  butterfly over lanes, each lane's 16-byte chunks of A in order (bf16)
  or every 32nd element (float32); the softmax ``softmax_warp``'s; the mix
  frame order; da like the bf16 score over E; d_q eight frame groups
  (f mod 8) added in order; d_v per column one sum per row of a block of four (over the
  blocks and a frame group's frames), then rows, frame groups and videos
  in order; d_proj and d_vals folded over rows in order;
* the CUDA path's shape gate raises ``ContextShapeError`` before the
  library loads (A or E not a multiple of 8, or a share of shared memory
  too large at 8 CTAs a cluster), and lets the widths it takes through
  to the load;
* the two sources and every header they include use no float atomics;
* the bf16 tanh lookup's selection (``attention_tc.cuh::tanh_code``) on
  every bf16 code, with numpy's float32 tanh standing in for ``tanhf``.

Inputs are drawn with numpy from a seed; F = 13 with masked tails and
video 0 all masked; A = 264 (33 chunks of 8, so lane 0 takes two) and
E = 24.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from cst_captioning_tpu.ops import pallas_attention as jpa
from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops import attention as tat

F, A, E = 13, 264, 24
G = 8   # the backward's frame groups (context_attention_bwd.cu::BWD_GROUPS)
NEG_INF = np.float32(-1e30)
f32 = np.float32


def _inputs(B, rep, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B * rep, A) * 0.5).astype(f32)
    proj = (rng.randn(B, F, A) * 0.5).astype(f32)
    vals = (rng.randn(B, F, E) * 0.5).astype(f32)
    v = (rng.randn(A, 1) * 0.06).astype(f32)
    n = rng.randint(1, F + 1, size=B)
    mask = (np.arange(F)[None, :] < n[:, None]).astype(f32)
    mask[0] = 0.0
    dctx = rng.randn(B * rep, E).astype(f32)
    return q, proj, mask, vals, v, dctx


def _round(x, dtype):
    """x rounded to ``dtype`` (float32 or bfloat16), as float32."""
    if dtype == "float32":
        return np.asarray(x, f32)
    return torch.from_numpy(np.asarray(x, f32)).bfloat16().float().numpy()


def _butterfly(p):
    """A warp's ``warp_sum`` over the last axis (32 lanes)."""
    idx = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        p = (p + p[..., idx ^ off]).astype(f32)
    return p[..., 0]


def _lane_sums(terms, chunk):
    """Each lane's sequential sum over the last axis: lane l takes the
    elements of chunks l, l + 32, ... (``chunk`` elements each) in order;
    then the butterfly."""
    n = terms.shape[-1]
    part = np.zeros(terms.shape[:-1] + (32,), f32)
    for c0 in range(0, n // chunk, 32):
        for lane in range(32):
            c = c0 + lane
            if c >= n // chunk:
                break
            for j in range(chunk):
                part[..., lane] = part[..., lane] + terms[..., c * chunk + j]
    return _butterfly(part)


def _softmax_warp(s):
    m = s.max(-1, keepdims=True)
    e = np.exp((s - m).astype(f32)).astype(f32)
    part = np.zeros(s.shape[:-1] + (32,), f32)
    for f in range(s.shape[-1]):
        part[..., f % 32] = part[..., f % 32] + e[..., f]
    return (e / _butterfly(part)[..., None]).astype(f32)


def _tanh_arg(proj, q, dtype):
    """tanh(T(proj + q)) in float32 for every (row, frame, column)."""
    return np.tanh(_round((proj + q[:, None, :]).astype(f32), dtype)).astype(f32)


def kernel_forward(q, proj, mask, vals, v, rep, dtype):
    """The forward kernel's arithmetic in its order: (ctx, attn)."""
    q, proj, vals, v = (_round(x, dtype) for x in (q, proj, vals, v))
    rows = np.arange(q.shape[0]) // rep
    th = _tanh_arg(proj[rows], q, dtype)
    s = _lane_sums((th * v[:, 0]).astype(f32),
                   8 if dtype == "bfloat16" else 1)
    s = np.where(mask[rows] > 0, s, NEG_INF).astype(f32)
    a = _softmax_warp(s)
    ctx = np.zeros((q.shape[0], vals.shape[-1]), f32)
    for f in range(F):
        ctx = (ctx + a[:, f, None] * vals[rows, f]).astype(f32)
    return _round(ctx, dtype), a


def kernel_backward(q, proj, vals, v, attn, dctx, rep, dtype):
    """The backward kernels' arithmetic in their order: (d_q, d_proj,
    d_vals, d_v)."""
    q, proj, vals, v, dctx = (_round(x, dtype)
                              for x in (q, proj, vals, v, dctx))
    R, B = q.shape[0], proj.shape[0]
    rows = np.arange(R) // rep
    da = _lane_sums((dctx[:, None, :] * vals[rows]).astype(f32), 8)
    part = np.zeros((R, 32), f32)
    for f in range(F):
        part[:, f % 32] = part[:, f % 32] + attn[:, f] * da[:, f]
    ds = (attn * (da - _butterfly(part)[:, None])).astype(f32)
    th = _tanh_arg(proj[rows], q, dtype)
    dpre = ((ds[:, :, None] * v[:, 0]).astype(f32)
            * (f32(1) - th * th).astype(f32)).astype(f32)
    groups = np.zeros((G, R, A), f32)
    for f in range(F):
        groups[f % G] = groups[f % G] + dpre[:, f]
    d_q = groups[0]
    for g in range(1, G):
        d_q = (d_q + groups[g]).astype(f32)
    d_proj = np.zeros((B, F, A), f32)
    d_vals = np.zeros((B, F, E), f32)
    for r in range(R):
        d_proj[rows[r]] = _round(d_proj[rows[r]] + _round(dpre[r], dtype),
                                 dtype)
        d_vals[rows[r]] = _round(
            d_vals[rows[r]] + _round(attn[r, :, None] * dctx[r], dtype),
            dtype)
    tds = (th * ds[:, :, None]).astype(f32)
    dvp = np.zeros((B, G, 4, A), f32)   # video, frame group, row of a block
    for b in range(B):
        for rb in range(0, rep, 4):
            for f in range(F):
                for rr in range(min(4, rep - rb)):
                    dvp[b, f % G, rr] = dvp[b, f % G, rr] + tds[b * rep + rb + rr, f]
    d_v = np.zeros(A, f32)
    for b in range(B):
        s = None
        for g in range(G):
            t = dvp[b, g, 0]
            for rr in range(1, 4):
                t = (t + dvp[b, g, rr]).astype(f32)
            s = t if s is None else (s + t).astype(f32)
        d_v = (d_v + s).astype(f32)
    return (_round(d_q, dtype), d_proj, d_vals,
            _round(d_v, dtype).reshape(A, 1))


def _jax_forward(q, proj, mask, vals, v, rep, dtype):
    g = lambda x: np.repeat(x, rep, axis=0)  # noqa: E731
    j = [jnp.asarray(x, getattr(jnp, dtype))
         for x in (q, g(proj), g(vals), v)]
    ctx, attn = jpa._fused_fwd_call(j[0], j[1], jnp.asarray(g(mask)), j[2],
                                    j[3], jpa._pick_bt(q.shape[0]))
    return np.asarray(ctx.astype(jnp.float32)), np.asarray(attn)


def _jax_backward(q, proj, mask, vals, v, dctx, rep, dtype):
    """The reference's training layout (``_repeat_cache``, then the
    kernel's VJP): attn and the cotangents of q, att_proj, att_vals,
    att_v."""
    j = [jnp.asarray(x, getattr(jnp, dtype)) for x in (q, proj, vals, v,
                                                        dctx)]
    m = jnp.repeat(jnp.asarray(mask), rep, axis=0)

    def fwd(q, p, vals, v):
        return jpa._fused(q, jnp.repeat(p, rep, axis=0), m,
                          jnp.repeat(vals, rep, axis=0), v)

    _, vjp = jax.vjp(fwd, *j[:4])
    _, res = jpa._fused_vjp_fwd(j[0], jnp.repeat(j[1], rep, axis=0), m,
                                jnp.repeat(j[2], rep, axis=0), j[3])
    return np.asarray(res[-1]), [np.asarray(x.astype(jnp.float32))
                                 for x in vjp(j[4])]


def _ulps(got, want, atol_rel):
    t = lambda x: torch.from_numpy(np.asarray(x, np.float64))  # noqa: E731
    return cs.bf16_ulps(torch, t(got), t(want), atol_rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,rep", [(8, 1), (4, 2)])
def test_forward_order_matches_pallas_kernel(dtype, B, rep):
    q, proj, mask, vals, v, _ = _inputs(B, rep, seed=10 * B + rep)
    kc, ka = kernel_forward(q, proj, mask, vals, v, rep, dtype)
    jc, ja = _jax_forward(q, proj, mask, vals, v, rep, dtype)
    assert np.isfinite(kc).all()
    np.testing.assert_allclose(ka[0], np.full(F, 1.0 / F, f32), rtol=1e-6)
    if dtype == "float32":
        assert np.abs(kc - jc).max() <= cs.CTX_F32_RTOL * np.abs(jc).max()
        assert np.abs(ka - ja).max() <= cs.CTX_F32_RTOL * np.abs(ja).max()
    else:
        assert _ulps(kc, jc, cs.CTX_BF16_ATOL_REL) <= cs.CTX_BF16_ULPS
        assert np.abs(ka - ja).max() <= cs.CTX_BF16_ATTN_ATOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,rep", [(8, 1), (2, 8)])
def test_backward_order_matches_pallas_vjp(dtype, B, rep):
    q, proj, mask, vals, v, dctx = _inputs(B, rep, seed=20 * B + rep)
    attn, want = _jax_backward(q, proj, mask, vals, v, dctx, rep, dtype)
    got = kernel_backward(q, proj, vals, v, attn, dctx, rep, dtype)
    for name, g, w in zip(("d_q", "d_proj", "d_vals", "d_v"), got, want):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        if dtype == "float32":
            assert np.abs(g - w).max() <= cs.CTXB_F32_RTOL * np.abs(w).max(), name
        else:
            assert _ulps(g, w, cs.CTXB_BF16_ATOL_REL) <= cs.CTXB_BF16_ULPS, name
    # The all-masked video's rows get the kernel's non-zero d_q.
    assert np.abs(got[0][:rep]).max() > 0


def test_kernel_orders_are_the_plain_versions_within_the_card_tiers():
    """The emulated kernels against the port's plain versions, which the
    card check compares them with (float32)."""
    B, rep = 3, 4
    q, proj, mask, vals, v, dctx = _inputs(B, rep, seed=3)
    t = [torch.from_numpy(x) for x in (q, proj, mask, vals, v, dctx)]
    rc, ra = tat.fused_context_attention_ref(*t[:5], rep=rep)
    kc, ka = kernel_forward(q, proj, mask, vals, v, rep, "float32")
    assert np.abs(kc - rc.numpy()).max() <= cs.CTX_F32_RTOL * float(rc.abs().max())
    rb = tat.fused_context_attention_bwd_ref(t[0], t[1], t[3], t[4],
                                             torch.from_numpy(ka), t[5],
                                             rep=rep)
    kb = kernel_backward(q, proj, vals, v, ka, dctx, rep, "float32")
    for g, w in zip(kb, rb):
        w = w.numpy()
        assert np.abs(g - w).max() <= cs.CTXB_F32_RTOL * np.abs(w).max()


# ------------------------------------------------------------ the gate

@pytest.fixture
def no_library(monkeypatch):
    """``_build.load`` raises ``LookupError``: a call that reaches the
    library load shows it."""
    def refuse(name):
        raise LookupError(f"the kernel library {name} was loaded")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tat, "_lib", None)
    monkeypatch.setattr(tat, "_bwd_lib", None)


def _launch(which, B, rep, Fx, Ax, Ex, dtype):
    """A call of the CUDA path's launcher (``_launch_fwd`` /
    ``_launch_bwd``) on tensors of the given shape."""
    z = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    q, proj, vals, v = z(B * rep, Ax), z(B, Fx, Ax), z(B, Fx, Ex), z(Ax, 1)
    if which == "forward":
        return tat._launch_fwd(q, proj, torch.ones(B, Fx), vals, v, rep,
                               True)
    return tat._launch_bwd(q, proj, vals, v,
                           torch.zeros(B * rep, Fx), z(B * rep, Ex), rep)


@pytest.mark.parametrize("which", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("Ax,Ex", [(20, 16), (16, 12), (4, 8)])
def test_width_gate_raises_before_the_library_loads(which, dtype, Ax, Ex,
                                                    no_library):
    with pytest.raises(tat.ContextShapeError, match="multiples of 8"):
        _launch(which, 2, 3, 5, Ax, Ex, dtype)


@pytest.mark.parametrize("which", ["forward", "backward"])
def test_shared_memory_gate_raises_before_the_library_loads(which,
                                                            no_library):
    """A video's rows that fill a CTA's shared memory even at 8 CTAs a
    cluster (the query rows alone are 400 x 512 x 4 bytes)."""
    with pytest.raises(tat.ContextShapeError, match="shared memory"):
        _launch(which, 1, 400, 8, 512, 512, torch.float32)


@pytest.mark.parametrize("which", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_gate_passes_the_widths_it_takes(which, dtype, no_library):
    """The main path's shape passes the gate and reaches the load."""
    with pytest.raises(LookupError, match="was loaded"):
        _launch(which, 2, 5, 56, 512, 512, dtype)


def test_frame_bounds_are_the_narrowest_shape_that_fits():
    """``_FWD_MAX_F`` / ``_BWD_MAX_F``: the largest F any shape fits in
    any kernel dtype, and the F-only refusal both paths keep.  Only bf16
    holds the tanh table (``table_bytes``): f16 is bf16's plan less it."""
    dts = (torch.float32, torch.bfloat16, torch.float16)
    assert [tat._table(dt) for dt in dts] == [0, tat._TABLE_BYTES, 0]
    for smem, top in ((tat._fwd_smem, tat._FWD_MAX_F),
                      (tat._bwd_smem, tat._BWD_MAX_F)):
        assert min(smem(1, top, 8, 8, 8, dt) for dt in dts) <= tat._SMEM
        for dt in dts:
            assert smem(1, top + 1, 8, 8, 8, dt) > tat._SMEM
            assert smem(20, 56, 512, 512, 2, dt) <= tat._SMEM
        assert (smem(20, 56, 512, 512, 2, torch.bfloat16)
                - smem(20, 56, 512, 512, 2, torch.float16)
                == tat._TABLE_BYTES)


# ------------------------------------------------------------ atomics

CSRC_OF_CONTEXT = ("context_attention.cu", "context_attention_bwd.cu",
                   "context_common.cuh", "attention_tc.cuh",
                   "attention_common.cuh", "tc_common.cuh",
                   "decode_common.cuh")
FLOAT_ATOMIC = re.compile(r"\batomic(Add|Sub|Exch|Max|Min)\w*\s*\(|"
                          r"\b(atom|red)\.(global|shared|add|gpu)")


# ------------------------------------------------------------ tanh lookup

TB_ELO = 127 - 16            # attention_tc.cuh: biased exponent of 2^-16
TB_SPAN = (132 - TB_ELO + 1) * 128  # entries per sign


def test_tanh_lookup_selects_tanh_on_every_bf16_code():
    """``tanh_code`` run in numpy: the table of tanh on |x| in [2^-16,
    64), both signs, indexed by the code's offset d from 2^-16's; x where
    d lies past inf's offset (|x| < 2^-16, d wrapped; NaN), else the
    entry, clamped to the sign's last (tanh of 63.75, which is 1).  Held
    bitwise to tanh of every bf16 value, NaN for the NaN codes: the
    selection is right for any tanh that is odd, returns x below 2^-16 and
    1 from 64, as ``tanhf`` does (chip_smoke.py checks the card's)."""
    i = np.arange(2 * TB_SPAN, dtype=np.uint32)
    sign = (i >= TB_SPAN).astype(np.uint32)
    k = i - sign * np.uint32(TB_SPAN)
    tab = np.tanh(((sign << np.uint32(31))
                   | ((k + np.uint32(TB_ELO << 7)) << np.uint32(16)))
                  .view(np.float32))
    c = np.arange(1 << 16, dtype=np.uint32)
    d = (c & np.uint32(0x7fff)) - np.uint32(TB_ELO << 7)
    t = tab[(c >> np.uint32(15)) * np.uint32(TB_SPAN)
            + np.minimum(d, np.uint32(TB_SPAN - 1))]
    x = (c << np.uint32(16)).view(np.float32)
    got = np.where(d > np.uint32(0x7f80 - (TB_ELO << 7)), x, t)
    nan = np.isnan(x)
    assert int(nan.sum()) == 254 and np.isnan(got[nan]).all()
    want = np.tanh(x[~nan])
    assert np.array_equal(got[~nan].view(np.uint32), want.view(np.uint32))
    assert tab[TB_SPAN - 1] == 1.0 and tab[2 * TB_SPAN - 1] == -1.0


@pytest.mark.parametrize("name", CSRC_OF_CONTEXT)
def test_context_sources_use_no_float_atomics(name):
    """The kernels' sums are taken in fixed orders (results repeat run to
    run): no atomic adds in the sources or the headers they include, and
    every local include is in the list."""
    with open(os.path.join(_build.CSRC, name)) as fh:
        src = fh.read()
    assert not FLOAT_ATOMIC.search(src), name
    incs = set(re.findall(r'#\s*include\s+"([^"]+)"', src))
    assert incs <= set(CSRC_OF_CONTEXT), name
