"""Weight-only int8 quantization for the low-precision serving path (the
port's own copy of the JAX package's ``ops/quant.py``).

``serving.dtype = int8w`` stores the large weight matrices (the vocab
projection ``logit_w``, the embedding rows ``word_embed``, the LSTM
kernel ``lstm0_w`` and the attention projections ``att_wf`` / ``att_wh``)
as int8 codes with one float32 scale per channel, computed once at
engine boot from the float weights.  Activations run in the compute
dtype and every product accumulates in float32; the scale multiplies the
float32 accumulator, and the result is never rounded back down, so the
decode logits exit float32 as the float path's do.

Symmetric per-channel scheme: ``scale_c = max|w_c| / 127`` (1.0 for an
all-zero channel), ``q = clip(round(w / scale), -127, 127)`` with round
half to even.  int8 magnitudes are exact in bfloat16, so casting the
codes to the compute dtype is lossless.  ``calibration="percentile"``
takes the 99.9th percentile of ``|w|`` per channel instead of the max,
by the same linear interpolation in float32 as ``jnp.percentile``
(written out here: a one-ulp difference in a scale changes codes, and
:func:`scale_hashes` equal to the JAX package's is the proof).

Everything works on a flat ``{name: tensor}`` tree (a state dict) or on
the JAX package's ``{"params": {...}}`` layout of numpy arrays.
"""

from __future__ import annotations

import hashlib
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cst_captioning_torch.ops.rnn import dot_f32

# Leaf-name pattern -> quantized channel axis: rows of the embedding,
# output columns everywhere else.  Biases, ``att_v``, ``att_b`` and the
# feature projections stay float32.
_QUANT_AXIS_RULES: Tuple[Tuple[str, int], ...] = (
    (r"word_embed$", 0),
    (r"logit_w$", 1),
    (r"lstm\d+_w$", 1),
    (r"att_w[fh]$", 1),
)

SCALE_SUFFIX = "_scale"
CALIBRATIONS = ("absmax", "percentile")
PERCENTILE_Q = 99.9


def quant_axis(name: str) -> Optional[int]:
    """Channel axis for a quantizable parameter name, else None."""
    for pat, axis in _QUANT_AXIS_RULES:
        if re.search(pat, name):
            return axis
    return None


def _as_f32(w) -> torch.Tensor:
    if isinstance(w, torch.Tensor):
        return w.detach().float()
    return torch.from_numpy(np.array(w, np.float32))


def _percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q, axis=-1)`` with linear interpolation, in
    float32 operation for operation as XLA runs it: the position ``p =
    f32(q) * (f32(n - 1) * f32(1 / 100))`` (XLA turns ``(q / 100) * (n -
    1)`` into a product with the reciprocal and folds the constants
    first), the neighbours of ``p`` in
    sorted order weighted ``1 - (p - floor p)`` and ``p - floor p``, the
    weighted sum contracted as XLA's CPU backend does, ``fma(lo, 1 - w,
    f32(hi * w))`` (the exact product and one rounding: float64 holds the
    48-bit product of two float32 values exactly)."""
    n = a.shape[-1]
    s = torch.sort(a, dim=-1).values
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    p = f32(q) * (f32(float(n - 1)) * (f32(1.0) / f32(100.0)))
    lo, hi = torch.floor(p), torch.ceil(p)
    hw = p - lo
    lw = f32(1.0) - hw
    lo_i = int(min(max(float(lo), 0.0), n - 1))
    hi_i = int(min(max(float(hi), 0.0), n - 1))
    tail = (s[..., hi_i] * hw).double()
    return (s[..., lo_i].double() * lw.double() + tail).float()


def quantize_per_channel(w, axis: int, calibration: str = "absmax"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8 quantization of ``w`` along ``axis``.
    Returns ``(q int8, scale float32 (w.shape[axis],))``; an all-zero
    channel gets scale 1.0."""
    if calibration not in CALIBRATIONS:
        raise ValueError(f"unknown quant calibration {calibration!r} — "
                         f"expected one of {CALIBRATIONS}")
    w = _as_f32(w)
    moved = w.movedim(axis, 0).reshape(w.shape[axis], -1)
    if calibration == "percentile":
        amax = _percentile(moved.abs(), PERCENTILE_Q)
    else:
        amax = moved.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / _bshape(scale, w.dim(), axis)),
                    -127.0, 127.0).to(torch.int8)
    return q, scale.float()


def _bshape(scale: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = -1
    return scale.reshape(shape)


def dequantize(q: torch.Tensor, scale: torch.Tensor, axis: int) -> torch.Tensor:
    """float32 reconstruction (tests and references only: the serving
    products scale after the float32 accumulation instead)."""
    return q.float() * _bshape(scale.float(), q.dim(), axis)


def quant_matmul(x: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q)`` the serving way (plain version): the codes
    cast to ``x.dtype`` (lossless), float32 accumulation, the
    per-column ``scale`` (N,) applied after it in float32.  ``q`` (K, N)
    int8, ``x`` (..., K)."""
    return dot_f32(x, q, x.dtype, scale)


def dequant_rows(q: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Embedding lookup from per-row-quantized storage: gather the int8
    rows, reconstruct them in float32 and round once to the compute
    dtype."""
    return (q[ids].float() * scale[ids][..., None].float()).to(compute_dtype)


# ------------------------------------------------------------- tree ops

def _param_dict(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params else params


def quantize_params(params: Mapping[str, Any], calibration: str = "absmax"):
    """Quantize every quantizable leaf of a float tree: each matched
    leaf becomes int8 codes and gains its ``<name>_scale`` sibling.
    Returns a new tree of the same layout, with torch tensors for the
    quantized leaves and their scales."""
    p = dict(_param_dict(params))
    for name in sorted(p):
        axis = quant_axis(name)
        if axis is None:
            continue
        q, scale = quantize_per_channel(p[name], axis, calibration)
        p[name] = q
        p[name + SCALE_SUFFIX] = scale
    if "params" in params:
        out = dict(params)
        out["params"] = p
        return out
    return p


def _dtype_name(leaf) -> str:
    dt = getattr(leaf, "dtype", None)
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(np.dtype(dt)) if dt is not None else ""


def is_quantized(params: Mapping[str, Any]) -> bool:
    """True when the tree already carries int8 weight leaves (decided by
    its first quantizable leaf, as the reference does): boot-time
    quantization is never applied twice."""
    for name, leaf in _param_dict(params).items():
        if quant_axis(name) is not None:
            return _dtype_name(leaf) == "int8"
    return False


def scale_hashes(params: Mapping[str, Any]) -> Dict[str, str]:
    """sha256 (16 hex chars) of every scale vector's float32 bytes."""
    p = _param_dict(params)
    out: Dict[str, str] = {}
    for name in sorted(p):
        if not name.endswith(SCALE_SUFFIX):
            continue
        host = _as_f32(p[name]).cpu().numpy()
        out[name] = hashlib.sha256(host.tobytes()).hexdigest()[:16]
    return out


def quantized_leaf_bytes(shape, axis: int) -> Tuple[int, int]:
    """Closed-form (int8 weight bytes, float32 scale bytes) of one
    quantized leaf: 0.25x the float32 leaf, plus ``shape[axis]`` scales."""
    n = 1
    for d in shape:
        n *= int(d)
    return n, int(shape[axis]) * 4
