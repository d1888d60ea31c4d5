"""LSTM cell math as plain tensor functions (port of the JAX package's
``ops/rnn.py``).

Gate order is i|f|g|o along the last axis of the fused
``((input + hidden), 4*hidden)`` kernel, the same as
``torch.nn.LSTMCell``.  Products take compute-dtype operands into a
float32 accumulator and the cell state stays float32, as in the
reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class LSTMWeights(NamedTuple):
    """One layer's weights. ``w``: ((input_dim + hidden), 4*hidden), gates
    ordered i|f|g|o along the last axis; ``b``: (4*hidden,)."""

    w: torch.Tensor
    b: torch.Tensor


def lstm_kernel_init(shape, generator: torch.Generator,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform ±1/sqrt(hidden) over the fused ((in+hidden), 4*hidden)
    kernel — the reference's ``lstm_kernel_init`` distribution."""
    hidden = shape[-1] // 4
    scale = 1.0 / float(hidden) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2 * scale) - scale).to(dtype=dtype, device=device)


def lstm_bias_init(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    """Zero bias with the forget slice at 1.0 (reference
    ``lstm_bias_init``)."""
    hidden = shape[-1] // 4
    b = torch.zeros(shape, dtype=dtype, device=device)
    b[hidden: 2 * hidden] = 1.0
    return b


def dot_f32(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``cdt`` and the products
    accumulated in float32 — ``jax.lax.dot_general(...,
    preferred_element_type=float32)``.  bf16 products are exact in f32,
    so upcasting the rounded operands is the same contraction."""
    return torch.matmul(a.to(cdt).float(), b.to(cdt).float())


def gate_update(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, 4H) float32 pre-activations + (R, H) float32 cell -> (h, c)
    (reference ``pallas_lstm.py::_gate_update``)."""
    H = c.shape[-1]
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H: 2 * H])
    g = torch.tanh(gates[:, 2 * H: 3 * H])
    o = torch.sigmoid(gates[:, 3 * H:])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(
    weights: LSTMWeights,
    x: torch.Tensor,
    h: torch.Tensor,
    c: torch.Tensor,
    *,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step ``(h', c') = cell(x, (h, c))`` as one fused
    ``[x, h] @ w`` product (f32 accumulation) and float32 cell state."""
    cdt = compute_dtype or weights.w.dtype
    gates = dot_f32(torch.cat([x.to(cdt), h.to(cdt)], dim=-1), weights.w, cdt)
    gates = gates + weights.b.float()
    h_new, c_new = gate_update(gates, c.float())
    return h_new.to(cdt), c_new
