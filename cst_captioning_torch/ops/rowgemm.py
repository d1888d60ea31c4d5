"""Row-invariant matrix product for the decode path: the CUDA kernel
wrapper and its plain version.

``row_dot(x, w, cdt)`` is ``ops/rnn.py::dot_f32`` (both operands
rounded to ``cdt``, float32 accumulation) with one more promise: a row's
result does not depend on how many rows the call holds.  The continuous
slot loop decodes S*K rows per step and its offline twin B*K; cuBLAS may
pick another kernel or split K for another row count and change a row's
bits, which over 30 fed-back steps can change a caption.  The kernel
(``csrc/row_gemm.cu``) sums every output over k in ascending order in
one thread whatever the row count, so the served caption is bit for bit
the offline one.  No TPU kernel is replaced: the reference leaves these
products to XLA.

CPU tensors take :func:`row_dot_ref` (``dot_f32``); CUDA tensors launch
the kernel (``row_dot.launches`` counts the launches) or raise.  No
autograd: the decode path runs without it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.decode_common import KERNEL_DTYPES
from cst_captioning_torch.ops.rnn import dot_f32


def row_dot_ref(x: torch.Tensor, w: torch.Tensor,
                cdt: torch.dtype) -> torch.Tensor:
    """Plain version (any device): ``dot_f32``."""
    return dot_f32(x, w, cdt)


def row_dot(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``x`` (..., K) float32 or ``cdt``; ``w`` (K, N).  Returns the
    float32 ``T(x) @ T(w)`` (..., N)."""
    if x.device.type == "cpu":
        return row_dot_ref(x, w, cdt)
    if x.device.type != "cuda":
        raise ValueError(f"row_dot: unsupported device {x.device}")
    if cdt not in KERNEL_DTYPES or x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"row_dot: unsupported dtypes {x.dtype} -> {cdt}")
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"row_dot: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"row_dot: w on {w.device}, x on {x.device}")
    K, N = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if x2.stride(-1) != 1 or x2.stride(0) < K:
        x2 = x2.contiguous()
    R = x2.shape[0]
    out = torch.empty((R, N), dtype=torch.float32, device=x.device)
    if R:
        w_c = w.to(cdt).contiguous()
        lib = _bound()
        err = lib.cst_row_gemm(
            KERNEL_DTYPES[cdt], KERNEL_DTYPES[x.dtype], x2.data_ptr(),
            x2.stride(0), w_c.data_ptr(), out.data_ptr(), R, K, N,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(lib, err, "row_dot")
        row_dot.launches += 1
    return out.reshape(*lead, N)


row_dot.launches = 0
_lib: Optional[ctypes.CDLL] = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("row_gemm")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cst_row_gemm.argtypes = [I, I, P, ctypes.c_longlong, P, P, I, I,
                                     I, P]
        lib.cst_row_gemm.restype = I
        _lib = lib
    return _lib
