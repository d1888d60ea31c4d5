"""The ``fused_context_attention`` kernel's plain version against the JAX
package's Pallas kernel (``ops/pallas_attention.py``, interpret mode on
the CPU), against the dense fallback, the ``rep`` layout, and the
wrapper's refusals.

Inputs are drawn with numpy from a seed and handed to both sides.  The
frame axis F = 13 is not a multiple of 8, frame tails are masked per
row, and row 0 has every frame masked (uniform weights, not NaN).
Tolerances: float32 ctx and weights within rtol 1e-6 (plus an absolute
1e-6 x max |value| for entries near zero, where a change of summation
order is all that differs); bfloat16 ctx within one bf16 ulp of the
larger value (the f32 mix is rounded once; an f32 difference in the
last bit can flip that rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops import pallas_attention as jpa
from cst_captioning_torch.ops import attention as tat
from cst_captioning_torch.ops.attlstm import dense_context_attention

F, A, E = 13, 24, 20


def _inputs(B, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, A) * 0.5).astype(np.float32)
    proj = (rng.randn(B, F, A) * 0.5).astype(np.float32)
    vals = (rng.randn(B, F, E) * 0.5).astype(np.float32)
    v = (rng.randn(A, 1) * 0.3).astype(np.float32)
    n = rng.randint(1, F + 1, size=B)
    mask = (np.arange(F)[None, :] < n[:, None]).astype(np.float32)
    mask[0] = 0.0
    return q, proj, mask, vals, v


def _jax(args, dtype):
    q, proj, mask, vals, v = args
    cast = [jnp.asarray(x, dtype) for x in (q, proj, vals, v)]
    bt = jpa._pick_bt(q.shape[0])
    ctx, attn = jpa._fused_fwd_call(cast[0], cast[1], jnp.asarray(mask),
                                    cast[2], cast[3], bt)
    public = jpa.fused_context_attention(cast[0], cast[1], jnp.asarray(mask),
                                         cast[2], cast[3], use_pallas=True)
    np.testing.assert_array_equal(np.asarray(public, np.float32),
                                  np.asarray(ctx, np.float32))
    return np.asarray(ctx.astype(jnp.float32)), np.asarray(attn)


def _torch(args, dtype, rep=1):
    q, proj, mask, vals, v = args
    t = [torch.from_numpy(x).to(dtype) for x in (q, proj, vals, v)]
    ctx, attn = tat.fused_context_attention(
        t[0], t[1], torch.from_numpy(mask), t[2], t[3], rep=rep,
        return_attn=True)
    assert ctx.dtype == dtype and attn.dtype == torch.float32
    return ctx.float().numpy(), attn.numpy()


def _close_f32(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def _bf16_ulps(got, want):
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    return float((np.abs(got.astype(np.float64) - want) / ulp).max())


@pytest.mark.parametrize("B", [8, 16, 24])
def test_f32_matches_pallas_kernel(B):
    args = _inputs(B, seed=B)
    jc, ja = _jax(args, jnp.float32)
    tc, ta = _torch(args, torch.float32)
    _close_f32(tc, jc)
    _close_f32(ta, ja)
    np.testing.assert_allclose(ta[0], np.full((F,), 1.0 / F), rtol=1e-6)
    assert np.isfinite(tc).all()


@pytest.mark.parametrize("B", [8, 16, 24])
def test_bf16_within_one_ulp_of_pallas_kernel(B):
    args = _inputs(B, seed=100 + B)
    jc, ja = _jax(args, jnp.bfloat16)
    tc, ta = _torch(args, torch.bfloat16)
    assert _bf16_ulps(tc, jc) <= 1.0
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-6)


def test_f32_matches_dense_fallback():
    """In float32 the kernel's numerics (f32 weights into the mix) and
    the dense fallback's (weights rounded to the values' dtype first)
    coincide."""
    q, proj, mask, vals, v = _inputs(10, seed=3)
    t = [torch.from_numpy(x) for x in (q, proj, mask, vals, v)]
    want = dense_context_attention(*t)
    got = tat.fused_context_attention(*t)
    _close_f32(got.numpy(), want.numpy())
    want_jax = jpa.dense_context_attention(*(jnp.asarray(x) for x in
                                             (q, proj, mask, vals, v)))
    _close_f32(got.numpy(), np.asarray(want_jax))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [2, 5])
def test_rep_equals_gathered_layout(dtype, rep):
    """rep = K reads video r // K: bitwise the gathered (K-fold
    repeated) layout at rep = 1."""
    B = 6
    q, proj, mask, vals, v = _inputs(B, seed=rep)
    rng = np.random.RandomState(rep + 50)
    qk = (rng.randn(B * rep, A) * 0.5).astype(np.float32)
    t = [torch.from_numpy(x).to(dtype) for x in (qk, proj, vals, v)]
    m = torch.from_numpy(mask)
    c1, a1 = tat.fused_context_attention(t[0], t[1], m, t[2], t[3], rep=rep,
                                         return_attn=True)
    g = lambda x: x.repeat_interleave(rep, dim=0)  # noqa: E731
    c2, a2 = tat.fused_context_attention(t[0], g(t[1]), g(m), g(t[2]), t[3],
                                         return_attn=True)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert c1.shape == (B * rep, E)


def test_ref_is_the_wrapper_on_cpu():
    args = [torch.from_numpy(x) for x in _inputs(8, seed=9)]
    a = tat.fused_context_attention(*args, return_attn=True)
    b = tat.fused_context_attention_ref(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert tat.fused_context_attention.launches == 0


def test_wrapper_refusals():
    q, proj, mask, vals, v = (torch.from_numpy(x) for x in _inputs(8))
    with pytest.raises(ValueError, match="rep"):
        tat.fused_context_attention(q, proj, mask, vals, v, rep=0)
    with pytest.raises(ValueError, match="query rows"):
        tat.fused_context_attention(q, proj, mask, vals, v, rep=3)
    with pytest.raises(ValueError, match="q is"):
        tat.fused_context_attention(q.double(), proj, mask, vals, v)
    with pytest.raises(ValueError, match="att_proj is"):
        tat.fused_context_attention(q, proj[:, :, :-1], mask, vals, v)
    with pytest.raises(ValueError, match="att_v is"):
        tat.fused_context_attention(q, proj, mask, vals, v[:-1])
    with pytest.raises(ValueError, match="att_mask is"):
        tat.fused_context_attention(q, proj, mask[:, :-1], vals, v)
    with pytest.raises(ValueError, match="unsupported dtype"):
        tat.fused_context_attention(q.half(), proj.half(), mask, vals.half(),
                                    v.half())
    with pytest.raises(ValueError, match="must be"):
        tat.fused_context_attention(q[None], proj, mask, vals, v)
    with pytest.raises(ValueError, match="unsupported device"):
        tat.fused_context_attention(q.to("meta"), proj, mask, vals, v)
