"""One Bahdanau attention step: the CUDA kernel wrapper and its plain
PyTorch version.

Port of the JAX package's ``ops/pallas_attention.py::
fused_context_attention`` (forward: TPU kernel ``_fwd_kernel`` via
``_fused_fwd_call``), the per-step context of ``CaptionModel._context``
that the continuous slot loop runs once per decode step under attention
fusion.  The kernel is ``csrc/context_attention.cu`` on
``csrc/attention_common.cuh``; its header says what bounds it on the
H100 and how its design differs from the TPU kernel.  The backward
(``_fused_vjp_bwd``) belongs to scheduled sampling, which is not ported
yet.

Numerics (kernel and plain version alike, ``_fwd_kernel``'s): the tanh
argument ``T(att_proj + q)`` in the values' dtype T with the tanh kept
in float32 (as XLA runs the reference; ``ops/attlstm.py`` says why),
the score ``sum_a th * v`` in float32, masked frames at -1e30, a
max-subtracted float32 softmax over frames (an all-masked row gets
uniform weights), and the context as a float32 mix of the float32
weights, rounded once to T.  The reference's dense fallback
(``dense_context_attention``, kept in ``ops/attlstm.py`` for the tests)
rounds the weights to T before the mix instead; the two agree in
float32.

``rep`` serves ``rep`` consecutive query rows from one stored copy of a
video's tensors: row ``r`` reads video ``r // rep`` (the reference slot
loop's deduplicated cache read ``cache[row // K]``, without
materialising the gather).  ``rep = 1`` is the reference's signature.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.attlstm import context_from_query
from cst_captioning_torch.ops.decode_common import KERNEL_DTYPES


def _check(q, att_proj, att_mask, att_vals, att_v, rep: int):
    if rep < 1:
        raise ValueError(f"fused_context_attention: rep={rep} < 1")
    if (q.dim() != 2 or att_proj.dim() != 3 or att_vals.dim() != 3
            or att_mask.dim() != 2):
        raise ValueError("fused_context_attention: q must be (R, A), "
                         "att_proj (B, F, A), att_vals (B, F, E), att_mask "
                         "(B, F)")
    R, A = q.shape
    B, F, E = att_vals.shape
    cdt = att_vals.dtype
    if cdt not in KERNEL_DTYPES:
        raise ValueError(f"fused_context_attention: unsupported dtype {cdt}")
    if B * rep != R:
        raise ValueError(f"fused_context_attention: {R} query rows for {B} "
                         f"videos at rep={rep}")
    for arg, x, shape in (("q", q, (R, A)), ("att_proj", att_proj, (B, F, A)),
                          ("att_v", att_v, (A, 1))):
        if x.dtype != cdt or tuple(x.shape) != shape:
            raise ValueError(f"fused_context_attention: {arg} is "
                             f"{x.dtype}{tuple(x.shape)}, expected "
                             f"{cdt}{shape}")
    if tuple(att_mask.shape) != (B, F):
        raise ValueError(f"fused_context_attention: att_mask is "
                         f"{tuple(att_mask.shape)}, expected {(B, F)}")
    for arg, x in (("att_proj", att_proj), ("att_mask", att_mask),
                   ("att_vals", att_vals), ("att_v", att_v)):
        if x.device != q.device:
            raise ValueError(f"fused_context_attention: {arg} on {x.device}, "
                             f"q on {q.device}")
    if 2 * A + F > 12_000:
        raise ValueError(f"fused_context_attention: F={F}, A={A} exceed the "
                         "kernel's shared memory")
    return R, B, F, A, E


def fused_context_attention_ref(q, att_proj, att_mask, att_vals, att_v,
                                rep: int = 1):
    """Plain version of the kernel (any device): the decode kernels'
    plain attention step (``ops/attlstm.py::context_from_query``) with
    the context rounded to the values' dtype.  Returns ``(ctx (R, E) in
    att_vals.dtype, attn (R, F) float32)``."""
    _check(q, att_proj, att_mask, att_vals, att_v, rep)
    cdt = att_vals.dtype
    if rep > 1:
        att_proj, att_mask, att_vals = (
            x.repeat_interleave(rep, dim=0)
            for x in (att_proj, att_mask, att_vals))
    ctx, a = context_from_query(q, att_proj, att_mask.float(),
                                att_vals.float(), att_v.float()[:, 0])
    return ctx.to(cdt), a


def fused_context_attention(q, att_proj, att_mask, att_vals, att_v,
                            rep: int = 1, return_attn: bool = False):
    """One decode step of Bahdanau context attention: ``q`` (R, A) in
    the values' dtype, ``att_proj`` (B, F, A), ``att_mask`` (B, F),
    ``att_vals`` (B, F, E), ``att_v`` (A, 1), ``R = B * rep``.  Returns
    the context (R, E) in ``att_vals.dtype``, and with ``return_attn``
    the float32 softmax weights (R, F) too.  CPU tensors take
    :func:`fused_context_attention_ref`; CUDA tensors launch the kernel
    (``fused_context_attention.launches`` counts the launches) or
    raise."""
    if q.device.type == "cpu":
        ctx, a = fused_context_attention_ref(q, att_proj, att_mask, att_vals,
                                             att_v, rep)
        return (ctx, a) if return_attn else ctx
    if q.device.type != "cuda":
        raise ValueError(f"fused_context_attention: unsupported device "
                         f"{q.device}")
    R, B, F, A, E = _check(q, att_proj, att_mask, att_vals, att_v, rep)
    cdt = att_vals.dtype
    ctx = torch.empty((R, E), dtype=cdt, device=q.device)
    attn = (torch.empty((R, F), dtype=torch.float32, device=q.device)
            if return_attn else None)
    if R:
        ins = [x.contiguous() for x in (q, att_v, att_proj)]
        mask = att_mask.float().contiguous()
        vals = att_vals.contiguous()
        lib = _bound()
        err = lib.cst_context_attention(
            KERNEL_DTYPES[cdt], *(x.data_ptr() for x in ins),
            mask.data_ptr(), vals.data_ptr(), rep, R, F, A, E,
            ctx.data_ptr(), None if attn is None else attn.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, err, "fused_context_attention")
        fused_context_attention.launches += 1
    return (ctx, attn) if return_attn else ctx


fused_context_attention.launches = 0
_lib: Optional[ctypes.CDLL] = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("context_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cst_context_attention.argtypes = [I] + [P] * 5 + [I] * 5 + [P] * 3
        lib.cst_context_attention.restype = I
        _lib = lib
    return _lib
