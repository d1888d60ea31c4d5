"""Port parity: ``cst_captioning_torch.ops.lstm`` (plain version of the
``lstm_recurrence`` kernel, the analytic backward and the autograd
Function) against the JAX package's ``ops/pallas_lstm.py``.

The same numpy inputs go through the TPU kernel in interpret mode
(``lstm_recurrence_pallas(interpret=True)``, and ``lstm_recurrence``
with ``use_pallas=True`` at R >= 8 rows so its kernel path engages) and
through the port.  Tolerances:

* float32 forward: rtol 1e-5 / atol 1e-6 (one f32 product per step,
  summed in another order);
* bfloat16 ``h_seq``: within 2 bf16 ulps (the f32 carry differs in its
  last bits, then rounds);
* gradients at float32: rtol 1e-4 / atol 1e-5 (a reverse recurrence in
  f32, its products summed in another order);
* bfloat16 backward on the same residuals: ``dgx`` rtol 1e-4 /
  atol 1e-5, ``dwh`` rounded to bf16 on both sides and within one bf16
  ulp (an f32 value within 1e-6 of a rounding boundary may round either
  way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cst_captioning_tpu.ops import pallas_lstm as jpl
from cst_captioning_torch.ops import lstm as tl

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)

SHAPES = [
    # R, T, H
    (8, 6, 16),
    (13, 7, 24),   # odd rows and steps, H not a multiple of 32
    (9, 1, 8),     # one step
]


def make_problem(R, T, H, seed=0, rec=0.3, scale=1.0):
    rng = np.random.RandomState(seed)
    gx = (rng.randn(R, T, 4 * H) * scale).astype(np.float32)
    wh = (rng.randn(H, 4 * H) * rec).astype(np.float32)
    dh = rng.randn(R, T, H).astype(np.float32)
    return gx, wh, dh


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_within_bf16_ulps(got, want, n):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    worst = float(np.max(np.abs(got - want) / ulp))
    assert worst <= n, f"{worst} bf16 ulps apart (limit {n})"


def jnp_bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def t_bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("R,T,H", SHAPES)
def test_forward_f32_matches_pallas_kernel(R, T, H):
    gx, wh, _ = make_problem(R, T, H)
    jh, jc = jpl.lstm_recurrence_pallas(jnp.asarray(gx), jnp.asarray(wh),
                                        with_cell=True, interpret=True)
    th, tc = tl.lstm_recurrence_fwd(torch.from_numpy(gx),
                                    torch.from_numpy(wh), with_cell=True)
    assert th.dtype == torch.float32 and tc.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **F32)


@pytest.mark.parametrize("R,T,H", SHAPES)
def test_forward_bf16_within_two_ulps(R, T, H):
    gx, wh, _ = make_problem(R, T, H, seed=1)
    jh, jc = jpl.lstm_recurrence_pallas(jnp.asarray(gx), jnp_bf16(wh),
                                        with_cell=True, interpret=True)
    th, tc = tl.lstm_recurrence_fwd(torch.from_numpy(gx), t_bf16(wh),
                                    with_cell=True)
    assert th.dtype == torch.bfloat16 and jh.dtype == jnp.bfloat16
    assert tc.dtype == torch.float32
    assert_within_bf16_ulps(as_np(th), as_np(jh), 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-2,
                               atol=2e-2)


def test_saturated_gates_exact_f32():
    gx, wh, _ = make_problem(8, 4, 16, seed=3, scale=16.0)
    jh = jpl.lstm_recurrence_pallas(jnp.asarray(gx), jnp.asarray(wh),
                                    interpret=True)
    th = tl.lstm_recurrence_ref(torch.from_numpy(gx), torch.from_numpy(wh))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


def _jax_grads(gx, wh, dh):
    def f(g, w):
        h = jpl.lstm_recurrence(g, w, True)
        return jnp.sum(h.astype(jnp.float32) * dh)

    return jax.grad(f, argnums=(0, 1))(gx, wh)


@pytest.mark.parametrize("R,T,H", SHAPES)
def test_grads_f32_match_custom_vjp(R, T, H):
    gx, wh, dh = make_problem(R, T, H, seed=4)
    jgx, jwh = _jax_grads(jnp.asarray(gx), jnp.asarray(wh), jnp.asarray(dh))
    tgx = torch.from_numpy(gx).requires_grad_()
    twh = torch.from_numpy(wh).requires_grad_()
    h = tl.lstm_recurrence(tgx, twh)
    (h * torch.from_numpy(dh)).sum().backward()
    np.testing.assert_allclose(tgx.grad.numpy(), np.asarray(jgx), **GRAD)
    np.testing.assert_allclose(twh.grad.numpy(), np.asarray(jwh), **GRAD)


def test_bf16_backward_on_same_residuals():
    R, T, H = 12, 5, 16
    gx, wh, dh = make_problem(R, T, H, seed=5)
    jh, jc = jpl.lstm_recurrence_pallas(jnp.asarray(gx), jnp_bf16(wh),
                                        with_cell=True, interpret=True)
    jgx, jwh = jpl.lstm_recurrence_bwd_scan(jnp.asarray(gx), jnp_bf16(wh),
                                            jh, jc, jnp.asarray(dh))
    tgx, twh = tl.lstm_recurrence_bwd(
        torch.from_numpy(gx), t_bf16(wh),
        torch.from_numpy(as_np(jh)).to(torch.bfloat16),
        torch.from_numpy(np.array(jc)), torch.from_numpy(dh))
    assert twh.dtype == torch.bfloat16 and jwh.dtype == jnp.bfloat16
    assert tgx.dtype == torch.float32
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), **GRAD)
    assert_within_bf16_ulps(as_np(twh), as_np(jwh), 1)


def test_bf16_grads_end_to_end():
    """Through the Function in bf16: dwh comes back in bf16 and close
    to the reference's (rtol 2e-2: the two forwards already differ by up
    to 2 bf16 ulps in h_seq, and the backward reads h_seq)."""
    R, T, H = 10, 4, 16
    gx, wh, dh = make_problem(R, T, H, seed=6)
    jgx, jwh = _jax_grads(jnp.asarray(gx), jnp_bf16(wh), jnp.asarray(dh))
    tgx = torch.from_numpy(gx).requires_grad_()
    twh = t_bf16(wh).requires_grad_()
    h = tl.lstm_recurrence(tgx, twh)
    assert h.dtype == torch.bfloat16
    (h.float() * torch.from_numpy(dh)).sum().backward()
    assert twh.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(twh.grad), as_np(jwh), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(tgx.grad.numpy(), np.asarray(jgx), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("grad_mode", [False, True])
def test_cell_output_only_under_autograd(monkeypatch, grad_mode):
    """The primal path writes no cell (reference ``lstm_recurrence``'s
    no-residual forward); under autograd the Function asks for it."""
    seen = []
    real = tl.lstm_recurrence_ref

    def spy(gx, wh, with_cell=False):
        seen.append(with_cell)
        return real(gx, wh, with_cell)

    monkeypatch.setattr(tl, "lstm_recurrence_ref", spy)
    gx, wh, _ = make_problem(8, 3, 8, seed=7)
    tgx = torch.from_numpy(gx).requires_grad_(grad_mode)
    with torch.set_grad_enabled(True):
        h = tl.lstm_recurrence(tgx, torch.from_numpy(wh))
    assert seen == [grad_mode]
    assert h.requires_grad == grad_mode
    with torch.no_grad():
        tl.lstm_recurrence(tgx, torch.from_numpy(wh))
    assert seen[-1] is False


def test_cpu_tensors_launch_nothing():
    before = tl.lstm_recurrence.launches
    gx, wh, _ = make_problem(8, 2, 8, seed=8)
    tl.lstm_recurrence(torch.from_numpy(gx), torch.from_numpy(wh))
    assert tl.lstm_recurrence.launches == before
    assert tl._lib is None


@pytest.mark.parametrize("H,ok", [(32, True), (64, True), (96, True),
                                  (512, True), (48, False), (544, False),
                                  (0, False)])
def test_bf16_kernel_width_rule(H, ok):
    """The bfloat16 kernel's clusters hold H / 32 CTAs of 32 hidden units,
    at most 16: other widths raise before any library is built."""
    if ok:
        tl.check_bf16_width(H, "lstm_recurrence")
        return
    with pytest.raises(ValueError, match="multiple of 32"):
        tl.check_bf16_width(H, "lstm_recurrence")
    gx = torch.zeros((2, 3, 4 * H))
    wh = torch.zeros((H, 4 * H), dtype=torch.bfloat16)
    h_seq = torch.empty((2, 3, H), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 32"):
        tl._run("lstm_recurrence", torch.bfloat16, False, gx, wh, None,
                h_seq, None)
    assert tl._lib is None
