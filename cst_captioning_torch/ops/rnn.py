"""LSTM cell math as plain tensor functions (port of the JAX package's
``ops/rnn.py``).

Gate order is i|f|g|o along the last axis of the fused
``((input + hidden), 4*hidden)`` kernel, the same as
``torch.nn.LSTMCell``.  Products take compute-dtype operands into a
float32 accumulator and the cell state stays float32, as in the
reference.  The per-step decoder step (the reference's ``lstm_step``)
is ``CaptionModel._step``, on the row-invariant ``ops/rowgemm.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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


def dot_f32(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``cdt`` and the products
    accumulated in float32 — ``jax.lax.dot_general(...,
    preferred_element_type=float32)``.  bf16 products are exact in f32,
    so upcasting the rounded operands is the same contraction.  With
    ``scale`` (``b`` int8 codes), the per-column float32 scale multiplies
    the float32 result: the reference's ``ops/quant.py::quant_matmul``."""
    out = torch.matmul(a.to(cdt).float(), b.to(cdt).float())
    return out if scale is None else out * scale.float()


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

