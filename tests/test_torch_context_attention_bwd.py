"""The backward of ``fused_context_attention``: its plain version against
the JAX package's custom VJP (``ops/pallas_attention.py::_fused_vjp_bwd``,
the Pallas ``_bwd_kernel`` in interpret mode on the CPU), the ``rep``
layout against the VJP of ``jnp.repeat`` followed by ``_fused``, finite
differences through the autograd Function, and the wrapper's refusals.

Inputs are drawn with numpy from a seed and handed to both sides.  F = 13
is not a multiple of 8, frame tails are masked per row and row 0 has every
frame masked: the kernel does not re-apply the mask in the backward, so
that row's uniform weights give it a non-zero gradient, and the port
follows the kernel.  Row counts are multiples of 8 (the JAX side sends
other counts to the dense fallback, whose gradient differs).
Tolerances: float32 cotangents within 1e-5 x their max |value| (a change
of summation order is all that differs); bfloat16 within 2 bf16 ulps of
the larger value past an allowance of 1e-6 x max |value| (near zero the
float32 sums cancel and ulps mean nothing); float16 within 2 f16 ulps
past the same allowance (bf16's count of an 8 times finer ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops import pallas_attention as jpa
from cst_captioning_torch.ops import attention as tat

F, A, E = 13, 24, 20
NAMES = ("d_q", "d_proj", "d_vals", "d_v")


def _inputs(B, seed=0, all_masked_row=True):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, A) * 0.5).astype(np.float32)
    proj = (rng.randn(B, F, A) * 0.5).astype(np.float32)
    vals = (rng.randn(B, F, E) * 0.5).astype(np.float32)
    v = (rng.randn(A, 1) * 0.3).astype(np.float32)
    n = rng.randint(1, F + 1, size=B)
    mask = (np.arange(F)[None, :] < n[:, None]).astype(np.float32)
    if all_masked_row:
        mask[0] = 0.0
    dctx = rng.randn(B, E).astype(np.float32)
    return q, proj, mask, vals, v, dctx


def _jax_vjp(args, dtype):
    """(attn, (d_q, d_proj, d_vals, d_v)) of the reference's custom VJP."""
    q, proj, mask, vals, v, dctx = args
    j = [jnp.asarray(x, dtype) for x in (q, proj, vals, v, dctx)]
    _, res = jpa._fused_vjp_fwd(j[0], j[1], jnp.asarray(mask), j[2], j[3])
    dq, dp, dmask, dvals, dv = jpa._fused_vjp_bwd(res, j[4])
    assert not np.asarray(dmask).any()
    return np.asarray(res[-1]), [np.asarray(x.astype(jnp.float32))
                                 for x in (dq, dp, dvals, dv)]


def _torch_bwd(args, attn, dtype, rep=1):
    q, proj, mask, vals, v, dctx = args
    t = [torch.from_numpy(x).to(dtype) for x in (q, proj, vals, v, dctx)]
    out = tat.fused_context_attention_bwd(t[0], t[1], t[2], t[3],
                                          torch.from_numpy(attn.copy()), t[4],
                                          rep=rep)
    assert all(x.dtype == dtype for x in out)
    return [x.float().numpy() for x in out]


def _bf16_ulps(got, want, atol_rel=1e-6):
    got, want = got.astype(np.float64), want.astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    gap = np.maximum(np.abs(got - want) - atol_rel * np.abs(want).max(), 0.0)
    return float((gap / ulp).max())


def _f16_ulps(got, want, atol_rel=1e-6):
    got, want = got.astype(np.float64), want.astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -14))) - 10)
    gap = np.maximum(np.abs(got - want) - atol_rel * np.abs(want).max(), 0.0)
    return float((gap / ulp).max())


ULPS = {"bfloat16": _bf16_ulps, "float16": _f16_ulps}


def _close_rel(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("B", [8, 16, 24])
def test_f32_matches_pallas_vjp(B):
    args = _inputs(B, seed=B)
    attn, want = _jax_vjp(args, jnp.float32)
    got = _torch_bwd(args, attn, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _close_rel(g, w)
    # The all-masked row's gradient is the kernel's, not zero.
    assert np.abs(got[0][0]).max() > 0 and np.abs(got[1][0]).max() > 0


@pytest.mark.parametrize("B", [8, 16, 24])
def test_bf16_within_two_ulps_of_pallas_vjp(B):
    args = _inputs(B, seed=100 + B)
    attn, want = _jax_vjp(args, jnp.bfloat16)
    got = _torch_bwd(args, attn, torch.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        assert _bf16_ulps(g, w) <= 2.0, name


@pytest.mark.parametrize("B", [8, 16, 24])
def test_f16_within_two_ulps_of_pallas_vjp(B):
    """float16 compute (the kernel's dtype code 2) against the custom VJP
    at float16 in interpret mode; the all-masked row's gradient is the
    kernel's, not zero, as at float32."""
    args = _inputs(B, seed=300 + B)
    attn, want = _jax_vjp(args, jnp.float16)
    got = _torch_bwd(args, attn, torch.float16)
    for name, g, w in zip(NAMES, got, want):
        assert np.isfinite(g).all(), name
        assert _f16_ulps(g, w) <= 2.0, name
    assert np.abs(got[0][0]).max() > 0 and np.abs(got[1][0]).max() > 0


def _jax_repeat_vjp(args, rep, dtype):
    """The reference's training layout: the per-video cache repeated to
    the caption rows (``_repeat_cache``), then the kernel's VJP.  Returns
    (attn, cotangents of q, att_proj, att_vals, att_v)."""
    q, proj, mask, vals, v, dctx = args
    j = [jnp.asarray(x, dtype) for x in (q, proj, vals, v, dctx)]
    m = jnp.repeat(jnp.asarray(mask), rep, axis=0)

    def f(q, p, vals, v):
        return jpa._fused(q, jnp.repeat(p, rep, axis=0), m,
                          jnp.repeat(vals, rep, axis=0), v)

    _, vjp = jax.vjp(f, *j[:4])
    _, res = jpa._fused_vjp_fwd(j[0], jnp.repeat(j[1], rep, axis=0), m,
                                jnp.repeat(j[2], rep, axis=0), j[3])
    return np.asarray(res[-1]), [np.asarray(x.astype(jnp.float32))
                                 for x in vjp(j[4])]


def _rep_args(B, rep, seed):
    """B videos' tensors with B * rep query rows and cotangents."""
    q, proj, mask, vals, v, _ = _inputs(B, seed=seed)
    rng = np.random.RandomState(seed + 7)
    qk = (rng.randn(B * rep, A) * 0.5).astype(np.float32)
    dctx = rng.randn(B * rep, E).astype(np.float32)
    return qk, proj, mask, vals, v, dctx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("B,rep", [(4, 2), (2, 4), (3, 8)])
def test_rep_matches_repeat_vjp(dtype, B, rep):
    """rep = K sums each video's K rows as XLA sums the rounded rows in
    the VJP of ``jnp.repeat``: bf16 and f16 within 2 ulps of their type,
    f32 within 1e-5."""
    args = _rep_args(B, rep, seed=10 * B + rep)
    attn, want = _jax_repeat_vjp(args, rep, getattr(jnp, dtype))
    got = _torch_bwd(args, attn, getattr(torch, dtype), rep=rep)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        if dtype == "float32":
            _close_rel(g, w)
        else:
            assert ULPS[dtype](g, w) <= 2.0, name


def test_rep_sum_rounds_each_add_in_bf16():
    """Pins how XLA sums a video's rows in the VJP of ``jnp.repeat`` on
    bf16 rows: one bf16-rounded add per row in row order (what the kernel
    and ``_rep_sum`` do), not a float32 sum rounded once."""
    rng = np.random.RandomState(0)
    B, rep = 8, 20
    rows = jnp.asarray(rng.randn(B * rep, F, A), jnp.bfloat16)
    _, vjp = jax.vjp(lambda x: jnp.repeat(x, rep, axis=0),
                     jnp.zeros((B, F, A), jnp.bfloat16))
    want = np.asarray(vjp(rows)[0].astype(jnp.float32))
    t = torch.from_numpy(np.array(rows.astype(jnp.float32))).bfloat16()
    seq = tat._rep_sum(t, rep).float().numpy()
    once = t.float().reshape(B, rep, F, A).sum(1).bfloat16().float().numpy()
    np.testing.assert_array_equal(seq, want)
    assert (once != want).mean() > 0.1


def test_rep_sum_rounds_each_add_in_f16():
    """The same pin at float16: XLA adds a video's f16 rows with one
    f16-rounded add per row, as ``_rep_sum`` and the kernel's f16 folds
    (``Fold<__half>``, the half2 d_vals fold) do."""
    rng = np.random.RandomState(1)
    B, rep = 8, 20
    rows = jnp.asarray(rng.randn(B * rep, F, A), jnp.float16)
    _, vjp = jax.vjp(lambda x: jnp.repeat(x, rep, axis=0),
                     jnp.zeros((B, F, A), jnp.float16))
    want = np.asarray(vjp(rows)[0].astype(jnp.float32))
    t = torch.from_numpy(np.array(rows.astype(jnp.float32))).half()
    seq = tat._rep_sum(t, rep).float().numpy()
    once = t.float().reshape(B, rep, F, A).sum(1).half().float().numpy()
    np.testing.assert_array_equal(seq, want)
    assert (once != want).mean() > 0.1


@pytest.mark.parametrize("rep", [1, 2])
def test_function_gradcheck_f64(rep):
    """Finite differences through ``ContextAttention`` (plain forward and
    backward in float64) on a partially masked batch: with no row fully
    masked the kernel's unmasked ``ds`` is the true gradient."""
    B = 3
    q, proj, mask, vals, v, _ = _rep_args(B, rep, seed=5)
    mask[:, 0] = 1.0
    t = [torch.from_numpy(x).double().requires_grad_()
         for x in (q, proj, vals, v)]
    m = torch.from_numpy(mask)

    def f(q, proj, vals, v):
        return tat.ContextAttention.apply(q, proj, m, vals, v, rep)

    assert torch.autograd.gradcheck(f, t, eps=1e-6, atol=1e-7, rtol=1e-5)


def test_autograd_goes_through_the_function():
    """Under autograd the public wrapper takes the Function: its
    gradients are the plain backward's, the all-masked row included (a
    dense autograd of the forward would give that row zero)."""
    args = _inputs(8, seed=3)
    q, proj, mask, vals, v, dctx = (torch.from_numpy(x) for x in args)
    leaves = [x.clone().requires_grad_() for x in (q, proj, vals, v)]
    ctx = tat.fused_context_attention(leaves[0], leaves[1], mask, leaves[2],
                                      leaves[3])
    (ctx * dctx).sum().backward()
    _, attn = tat.fused_context_attention_ref(q, proj, mask, vals, v)
    want = tat.fused_context_attention_bwd_ref(q, proj, vals, v, attn, dctx)
    for leaf, w in zip(leaves, (want[0], want[1], want[2], want[3])):
        assert torch.equal(leaf.grad, w)
    assert leaves[0].grad[0].abs().max() > 0
    assert tat.fused_context_attention.launches == 0
    assert tat.fused_context_attention_bwd.launches == 0
    with torch.no_grad():
        plain = tat.fused_context_attention(leaves[0], leaves[1], mask,
                                            leaves[2], leaves[3])
    assert plain.grad_fn is None and torch.equal(plain, ctx.detach())


def test_wrapper_refusals():
    q, proj, mask, vals, v, dctx = (torch.from_numpy(x) for x in _inputs(8))
    _, attn = tat.fused_context_attention_ref(q, proj, mask, vals, v)
    bwd = tat.fused_context_attention_bwd
    with pytest.raises(ValueError, match="rep"):
        bwd(q, proj, vals, v, attn, dctx, rep=0)
    with pytest.raises(ValueError, match="query rows"):
        bwd(q, proj, vals, v, attn, dctx, rep=3)
    with pytest.raises(ValueError, match="attn is"):
        bwd(q, proj, vals, v, attn.bfloat16(), dctx)
    with pytest.raises(ValueError, match="attn is"):
        bwd(q, proj, vals, v, attn[:, :-1], dctx)
    with pytest.raises(ValueError, match="dctx is"):
        bwd(q, proj, vals, v, attn, dctx[:, :-1])
    with pytest.raises(ValueError, match="dctx is"):
        bwd(q, proj, vals, v, attn, dctx.bfloat16())
    with pytest.raises(ValueError, match="att_v is"):
        bwd(q, proj, vals, v[:-1], attn, dctx)
    # float16: the plain version and the kernel's check both take it
    # (the kernel's dtype code 2).
    d16 = bwd(q.half(), proj.half(), vals.half(), v.half(), attn,
              dctx.half())
    assert {x.dtype for x in d16} == {torch.float16}
    assert tat._check_bwd(q.half(), proj.half(), vals.half(), v.half(), attn,
                          dctx.half(), 1) == (8, 8, F, A, E)
    with pytest.raises(ValueError, match="unsupported dtype"):
        bwd(q.int(), proj.int(), vals.int(), v.int(), attn, dctx.int())
    with pytest.raises(ValueError, match="shared memory"):
        Fb = tat._BWD_MAX_F + 1
        bwd(q, torch.zeros(8, Fb, A), torch.zeros(8, Fb, E), v,
            torch.zeros(8, Fb), dctx)
    with pytest.raises(ValueError, match="unsupported device"):
        bwd(q.to("meta"), proj, vals, v, attn, dctx)
