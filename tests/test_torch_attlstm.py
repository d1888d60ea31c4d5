"""Port parity: ``cst_captioning_torch.ops.attlstm`` (plain versions of
the ``attlstm_recurrence`` forward and backward kernels, and the autograd
Function) against the JAX package's ``ops/pallas_attlstm.py``.

The same numpy inputs go through the TPU kernels in interpret mode
(``_fwd_call`` with residuals, and ``attlstm_recurrence`` under
``jax.grad``, whose custom VJP runs ``_bwd_call``) and through the port.
Every input has a video with a masked frame tail and one with all its
frames masked.  Tolerances:

* float32 forward (``h_seq``, ``c_seq``, ``a_seq``): rtol 1e-5 / atol
  1e-6 (the same products summed in another order);
* bfloat16 ``h_seq``: within 2 bf16 ulps (the f32 carry differs in its
  last bits, then rounds);
* float32 cotangents, all eight, through the autograd Function vs
  ``jax.grad`` through the custom VJP: rtol 1e-5 / atol 1e-6;
* bfloat16 backward on the same residuals: the float32 ``dgx`` rtol
  1e-4 / atol 1e-5; the cotangents returned in bf16 within 2 bf16 ulps
  of the reference plus an absolute 1e-4 (an f32 value near a rounding
  boundary may round either way, and ``dgates`` is rounded to bf16
  before three products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops import pallas_attention as jpa
from cst_captioning_tpu.ops import pallas_attlstm as jal
from cst_captioning_torch.ops import attlstm as tal

F32 = dict(rtol=1e-5, atol=1e-6)
NAMES = ["gx", "wh", "w_ctx", "att_wh", "att_v", "att_proj", "att_mask",
         "att_vals"]

SHAPES = [
    # R, T, H, A, E, F
    (8, 5, 16, 24, 20, 6),
    (16, 4, 24, 16, 32, 9),
    (8, 1, 8, 8, 8, 3),      # one step
]


def make_problem(R, T, H, A, E, F, seed=0):
    """Inputs at the scales of the model (recurrent weights ~ init
    scale, attention tensors ~ unit scale); row 1 has every frame
    masked, row 2 a masked tail."""
    rng = np.random.RandomState(seed)
    f = lambda *s, sc: (rng.randn(*s) * sc).astype(np.float32)  # noqa: E731
    mask = (rng.rand(R, F) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[1] = 0.0
    mask[2, F // 2:] = 0.0
    args = [f(R, T, 4 * H, sc=0.5), f(H, 4 * H, sc=0.3), f(E, 4 * H, sc=0.3),
            f(H, A, sc=0.3), f(A, 1, sc=0.3), f(R, F, A, sc=0.5), mask,
            f(R, F, E, sc=0.5)]
    return args, f(R, T, H, sc=1.0)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_within_bf16_ulps(got, want, n, atol=0.0, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    worst = float(np.max((np.abs(got - want) - atol) / ulp))
    assert worst <= n, f"{what}: {worst} bf16 ulps apart (limit {n})"


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def cast(args, bf16):
    """(jax args, torch args): gx and the mask stay float32, the rest in
    the compute dtype."""
    j, t = [], []
    for i, a in enumerate(args):
        low = bf16 and i not in (0, 6)
        j.append(jnp.asarray(a, jnp.float32).astype(
            jnp.bfloat16 if low else jnp.float32))
        t.append(torch.from_numpy(a).to(torch.bfloat16 if low
                                        else torch.float32))
    return j, t


def jax_forward(jargs):
    R = jargs[0].shape[0]
    h, a, c = jal._fwd_call(*jargs, bt=R, tc=1, with_residuals=True)
    return h, c, a


@pytest.mark.parametrize("R,T,H,A,E,F", SHAPES)
def test_forward_f32_matches_pallas_kernel(R, T, H, A, E, F):
    args, _ = make_problem(R, T, H, A, E, F)
    jargs, targs = cast(args, False)
    want = jax_forward(jargs)
    got = tal.attlstm_recurrence_fwd(*targs, with_residuals=True)
    for name, g, w in zip(("h_seq", "c_seq", "a_seq"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **F32)
    np.testing.assert_allclose(got[0].numpy(),
                               np.asarray(jal.attlstm_scan(*jargs)), **F32)


def test_all_masked_row_gets_uniform_weights():
    args, _ = make_problem(8, 3, 16, 24, 20, 6, seed=1)
    _, _, a = tal.attlstm_recurrence_ref(
        *cast(args, False)[1], with_residuals=True)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a[1], torch.full_like(a[1], 1.0 / 6))
    assert torch.all(a[2, :, 3:] == 0.0)


def test_masked_frames_cannot_leak():
    args, _ = make_problem(8, 4, 16, 24, 20, 6, seed=2)
    ref = tal.attlstm_recurrence_ref(*cast(args, False)[1])
    mask, vals = args[6], args[7].copy()
    live = mask.sum(-1) > 0
    vals[live] = np.where(mask[live][..., None] > 0, vals[live], 1e3)
    args[7] = vals
    got = tal.attlstm_recurrence_ref(*cast(args, False)[1])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("R,T,H,A,E,F", SHAPES[:2])
def test_forward_bf16_within_two_ulps(R, T, H, A, E, F):
    args, _ = make_problem(R, T, H, A, E, F, seed=3)
    jargs, targs = cast(args, True)
    jh, jc, ja = jax_forward(jargs)
    th, tc, ta = tal.attlstm_recurrence_fwd(*targs, with_residuals=True)
    assert th.dtype == torch.bfloat16 and jh.dtype == jnp.bfloat16
    assert_within_bf16_ulps(as_np(th), as_np(jh), 2, what="h_seq")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=2e-2,
                               atol=2e-2)


def _jax_grads(jargs, dh):
    def f(*a):
        h = jal.attlstm_recurrence(*a)
        return jnp.sum(h.astype(jnp.float32) * dh)

    return jax.grad(f, argnums=tuple(range(8)))(*jargs)


@pytest.mark.parametrize("R,T,H,A,E,F", SHAPES)
def test_grads_f32_match_custom_vjp(R, T, H, A, E, F):
    args, dh = make_problem(R, T, H, A, E, F, seed=4)
    jargs, targs = cast(args, False)
    want = _jax_grads(jargs, jnp.asarray(dh))
    targs = [x.requires_grad_() for x in targs]
    h = tal.attlstm_recurrence(*targs)
    (h * torch.from_numpy(dh)).sum().backward()
    for name, x, w in zip(NAMES, targs, want):
        assert x.grad is not None and x.grad.dtype == x.dtype, name
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   err_msg=name, **F32)


def test_bf16_backward_on_same_residuals():
    """The reference backward kernel (``_bwd_call`` in interpret mode +
    ``_vjp_bwd``'s contractions) and the port's plain backward, fed the
    same bf16 operands and the reference forward's residuals."""
    R, T, H, A, E, F = 8, 4, 16, 24, 20, 6
    args, dh = make_problem(R, T, H, A, E, F, seed=5)
    jargs, targs = cast(args, True)
    jh, jc, ja = jax_forward(jargs)
    res = (*jargs, jh, jc, ja)
    want = jal._vjp_bwd(res, jnp.asarray(dh).astype(jnp.bfloat16))
    got = tal.attlstm_recurrence_bwd_ref(
        *targs[:6], targs[7], torch.from_numpy(as_np(jh)).to(torch.bfloat16),
        torch.from_numpy(np.array(jc)), torch.from_numpy(np.array(ja)),
        torch.from_numpy(dh).to(torch.bfloat16))
    wants = [w for i, w in enumerate(want) if i != 6]
    names = [n for n in NAMES if n != "att_mask"]
    assert got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(wants[0]),
                               rtol=1e-4, atol=1e-5)
    for name, g, w in zip(names[1:], got[1:], wants[1:]):
        assert g.dtype == torch.bfloat16, name
        assert_within_bf16_ulps(as_np(g), as_np(w), 2, atol=1e-4, what=name)


@pytest.mark.parametrize("grad_mode", [False, True])
def test_residuals_only_under_autograd(monkeypatch, grad_mode):
    """The primal path writes no residuals (reference
    ``attlstm_recurrence``'s no-residual forward); under autograd the
    Function asks for them."""
    seen = []
    real = tal.attlstm_recurrence_ref

    def spy(*a, with_residuals=False):
        seen.append(with_residuals)
        return real(*a, with_residuals=with_residuals)

    monkeypatch.setattr(tal, "attlstm_recurrence_ref", spy)
    args, _ = make_problem(8, 2, 8, 8, 8, 3, seed=6)
    targs = cast(args, False)[1]
    targs[0].requires_grad_(grad_mode)
    with torch.set_grad_enabled(True):
        h = tal.attlstm_recurrence(*targs)
    assert seen == [grad_mode]
    assert h.requires_grad == grad_mode
    with torch.no_grad():
        tal.attlstm_recurrence(*targs)
    assert seen[-1] is False


def test_cpu_tensors_launch_nothing():
    before = (tal.attlstm_recurrence.launches,
              tal.attlstm_recurrence_bwd.launches)
    args, dh = make_problem(8, 2, 8, 8, 8, 3, seed=7)
    targs = [x.requires_grad_() for x in cast(args, False)[1]]
    (tal.attlstm_recurrence(*targs) * torch.from_numpy(dh)).sum().backward()
    assert (tal.attlstm_recurrence.launches,
            tal.attlstm_recurrence_bwd.launches) == before
    assert tal._lib is None


@pytest.mark.parametrize("bf16", [False, True])
def test_dense_context_matches_reference(bf16):
    """The per-step context of ``CaptionModel._context``: f32 rtol 1e-5;
    bf16 within 2 bf16 ulps."""
    rng = np.random.RandomState(8)
    B, F, A, E = 5, 7, 12, 10
    q = rng.randn(B, A).astype(np.float32)
    proj = rng.randn(B, F, A).astype(np.float32)
    mask = (rng.rand(B, F) > 0.4).astype(np.float32)
    mask[0] = 0.0
    vals = rng.randn(B, F, E).astype(np.float32)
    v = rng.randn(A, 1).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    want = jpa.dense_context_attention(
        *(jnp.asarray(x).astype(jdt) for x in (q, proj)), jnp.asarray(mask),
        *(jnp.asarray(x).astype(jdt) for x in (vals, v)))
    got = tal.dense_context_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, proj)),
        torch.from_numpy(mask),
        *(torch.from_numpy(x).to(tdt) for x in (vals, v)))
    assert got.dtype == tdt
    if bf16:
        assert_within_bf16_ulps(as_np(got), as_np(want), 2, what="ctx")
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_score_keeps_tanh_in_f32_as_xla_does():
    """The reference's score ``sum(tanh(proj + q).astype(f32) * v)``
    with bf16 operands, jitted as it runs: XLA rounds the tanh argument
    to bf16 but keeps the tanh in float32 for the float32 convert that
    follows.  The port's step matches that to float32 rounding, while
    rounding the tanh output to bf16 as well (what the source's types
    say) lands far off."""
    rng = np.random.RandomState(9)
    p = rng.randn(8, 6, 24).astype(np.float32)
    q = rng.randn(8, 24).astype(np.float32)
    v = rng.randn(24).astype(np.float32)
    score = jax.jit(lambda p, q, v: jnp.sum(
        jnp.tanh(p + q[:, None, :]).astype(jnp.float32) * v, axis=-1))
    want = np.asarray(score(jnp.asarray(p).astype(jnp.bfloat16),
                            jnp.asarray(q).astype(jnp.bfloat16),
                            jnp.asarray(v)))
    tp, tq = (torch.from_numpy(x).to(torch.bfloat16) for x in (p, q))
    arg = tp + tq[:, None, :]
    tv = torch.from_numpy(v)
    port = (torch.tanh(arg.float()) * tv).sum(-1).numpy()
    twice = (torch.tanh(arg).float() * tv).sum(-1).numpy()
    np.testing.assert_allclose(port, want, rtol=1e-5, atol=1e-5)
    assert np.abs(twice - want).max() > 1e-3
