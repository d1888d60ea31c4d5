"""Row-invariant matrix product for the decode path: the CUDA kernel
wrapper and its plain version.

``row_dot(x, w, cdt)`` is ``ops/rnn.py::dot_f32`` (both operands
rounded to ``cdt``, float32 accumulation) with one more promise: a row's
result does not depend on how many rows the call holds.  The continuous
slot loop decodes S*K rows per step and its offline twin B*K; cuBLAS may
pick another kernel or split K for another row count and change a row's
bits, which over 30 fed-back steps can change a caption.  The kernel
(``csrc/row_gemm.cu``) fixes every output's order over k whatever the
row count: at float32 compute one thread sums it in ascending k; at
bfloat16 or float16 compute the tensor cores sum ascending 32-deep
chunks of k, each added once to a float32 accumulator.  So the served
caption is bit for bit the offline one.  No TPU kernel is replaced: the reference
leaves these products to XLA.

int8w serving (``serving.dtype = int8w``, ``ops/quant.py``): ``w`` holds
int8 codes and ``scale`` their (N,) float32 column scales; the product is
the reference's ``quant_matmul``, ``(T(x) @ T(codes)) * scale`` with the
scale applied once to the float32 sum.  The kernel reads the codes as
int8 (no float copy of the weights per call) and counts the launch in
``row_dot.launches`` and ``row_dot.quant_launches``.

CPU tensors take :func:`row_dot_ref` (``dot_f32``);
CUDA tensors launch the kernel (``row_dot.launches`` counts the
launches) or raise.  No autograd: the decode path runs without it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.decode_common import KERNEL_DTYPES
from cst_captioning_torch.ops.rnn import dot_f32


def row_dot_ref(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version (any device): ``dot_f32``."""
    return dot_f32(x, w, cdt, scale)


def row_dot(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype,
            scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` (..., K) float32 or ``cdt`` (float32, bfloat16 or float16;
    float32 compute also takes bfloat16 ``x``); ``w`` (K, N) in any float
    dtype, or int8 codes with their (N,) float32 column ``scale`` at
    float32 or bfloat16 compute.  Returns the float32 ``T(x) @ T(w)``
    (``* scale``) (..., N)."""
    if (w.dtype == torch.int8) != (scale is not None):
        raise ValueError("row_dot: int8 weights need their scale, and only "
                         "they take one")
    if x.device.type == "cpu":
        return row_dot_ref(x, w, cdt, scale)
    if x.device.type != "cuda":
        raise ValueError(f"row_dot: unsupported device {x.device}")
    # x is float32 or cdt (csrc/row_gemm.cu); float32 compute also takes
    # bfloat16 x.  int8 weights have no float16 instantiation.
    x_ok = x.dtype in (torch.float32, cdt) or (
        cdt == torch.float32 and x.dtype == torch.bfloat16)
    if (cdt not in KERNEL_DTYPES or not x_ok
            or (scale is not None and cdt == torch.float16)):
        raise ValueError(f"row_dot: unsupported dtypes {x.dtype} -> {cdt}"
                         + ("" if scale is None else " (int8 weights)"))
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"row_dot: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"row_dot: w on {w.device}, x on {x.device}")
    if scale is not None and (scale.shape != (w.shape[1],)
                              or scale.dtype != torch.float32
                              or scale.device != x.device):
        raise ValueError(f"row_dot: scale {scale.dtype}{tuple(scale.shape)} "
                         f"on {scale.device} for w {tuple(w.shape)}")
    K, N = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if x2.stride(-1) != 1 or x2.stride(0) < K:
        x2 = x2.contiguous()
    R = x2.shape[0]
    out = torch.empty((R, N), dtype=torch.float32, device=x.device)
    if R:
        quant = scale is not None
        w_c = (w if quant else w.to(cdt)).contiguous()
        sc = scale.contiguous() if quant else None
        lib = _bound()
        err = lib.cst_row_gemm(
            KERNEL_DTYPES[cdt], KERNEL_DTYPES[x.dtype], int(quant),
            x2.data_ptr(), x2.stride(0), w_c.data_ptr(),
            sc.data_ptr() if quant else None, out.data_ptr(), R, K, N,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, err, "row_dot")
        _build.count_launch(row_dot)
        _build.count_launch(row_dot, "quant_launches", int(quant))
    return out.reshape(*lead, N)


row_dot.launches = 0
row_dot.quant_launches = 0
_lib: Optional[ctypes.CDLL] = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("row_gemm")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cst_row_gemm.argtypes = [I, I, I, P, ctypes.c_longlong, P, P, P,
                                     I, I, I, P]
        lib.cst_row_gemm.restype = I
        _lib = lib
    return _lib
