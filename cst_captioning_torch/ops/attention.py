"""One Bahdanau attention step and its backward: the CUDA kernel
wrappers, their plain PyTorch versions and the autograd Function.

Port of the JAX package's ``ops/pallas_attention.py::
fused_context_attention``: the forward (TPU kernel ``_fwd_kernel`` via
``_fused_fwd_call``) and its custom VJP (``_fused_vjp_bwd``, TPU kernel
``_bwd_kernel`` via ``_fused_bwd_call``), the per-step context of
``CaptionModel._context``.  The continuous slot loop runs the forward
once per decode step under attention fusion; scheduled-sampling
training runs forward and backward once per teacher-forced step.  The
kernels are ``csrc/context_attention.cu`` and
``csrc/context_attention_bwd.cu`` on ``csrc/attention_common.cuh``;
``csrc/context_common.cuh`` (one video per thread-block cluster, its
tensors staged once in shared memory; the forward at rep = 1 over at
least as many videos as SMs reads them in place); their headers say what
bounds them on the H100 and how their design differs from the TPU
kernels.
The CUDA path takes A and E in multiples of 8 and a video's share of
shared memory at 8 CTAs a cluster (:func:`check_context_shape`, which
raises :class:`ContextShapeError` before the library loads); the plain
versions take any width.

Numerics (kernel and plain version alike, ``_fwd_kernel``'s): the tanh
argument ``T(att_proj + q)`` in the values' dtype T with the tanh kept
in float32, rounded to T under float16 (as XLA runs the reference;
``ops/attlstm.py::tanh_of`` says why),
the score ``sum_a th * v`` in float32, masked frames at -1e30, a
max-subtracted float32 softmax over frames (an all-masked row gets
uniform weights), and the context as a float32 mix of the float32
weights, rounded once to T.  The reference's dense fallback
(``dense_context_attention``, kept in ``ops/attlstm.py`` for the tests)
rounds the weights to T before the mix instead; the two agree in
float32.

The backward follows ``_bwd_kernel``: from the saved float32 weights
``a``, ``da = dctx . vals``, ``ds = a * (da - sum(a * da))`` not masked
(an all-masked row's uniform weights give it a non-zero gradient, where
the dense math's would be zero), the tanh recomputed as in the forward,
``dpre = ds * v * (1 - th^2)``; ``d_q = T(sum_f dpre)``, ``d_proj =
T(dpre)`` and ``d_vals = T(a * dctx)`` per row, ``d_v`` summed in
float32 and rounded to ``att_v``'s dtype.  The mask gets no gradient.

``rep`` serves ``rep`` consecutive query rows from one stored copy of a
video's tensors: row ``r`` reads video ``r // rep`` (the reference slot
loop's deduplicated cache read ``cache[row // K]``, or its training
step's ``_repeat_cache``, without materialising the gather).  ``rep =
1`` is the reference's signature.  In the backward a video's ``d_proj``
and ``d_vals`` sum its rows in row order, each add rounded to T: what
XLA makes of the VJP of ``jnp.repeat`` on the rounded rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.attlstm import context_from_query, tanh_of
from cst_captioning_torch.ops.decode_common import KERNEL_DTYPES


# ------------------------------------------------- the CUDA path's gate

# The kernels' shared memory (csrc/context_attention.cu::fwd_plan and
# csrc/context_attention_bwd.cu::bwd_plan, mirrored): a CTA of a video's
# cluster of S CTAs holds its share of the video's tensors.  The kernels
# pick the smallest S that fills the card and raise it until the share
# fits; a shape that does not fit at S = 8 is refused.
_SMEM = 232_448           # a block's shared memory on the H100
_MAX_CLUSTER = 8
_TABLE_BYTES = 2 * 22 * 128 * 4   # attention_tc.cuh::TB_BYTES
_BWD_GROUPS = 8           # context_attention_bwd.cu::BWD_GROUPS
_BWD_COLS = 128           # ... ::BWD_COLS


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def _table(dtype: torch.dtype) -> int:
    """The tanh table's bytes (``table_bytes<T>``): bf16 only, f16 and
    float32 evaluate ``tanhf``."""
    return _TABLE_BYTES if dtype == torch.bfloat16 else 0


def _fwd_smem(rep: int, F: int, A: int, E: int, S: int,
              dtype: torch.dtype) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    nf, nc = -(-F // S), -(-(E // 8) // S)
    return (_table(dtype) + _a16(rep * A * itemsize)
            + _a16(A * itemsize) + _a16(nf * A * itemsize)
            + _a16(F * 8 * nc * itemsize) + _a16(F * 4) + rep * F * 4)


def _bwd_smem(rep: int, F: int, A: int, E: int, S: int,
              dtype: torch.dtype) -> int:
    itemsize = torch.empty((), dtype=dtype).element_size()
    nf, ac = -(-F // S), 8 * -(-(A // 8) // S)
    rep4 = -(-rep // 4) * 4
    carry = _a16(F * _BWD_COLS * 4) + _BWD_GROUPS * 4 * _BWD_COLS * 4
    return (_table(dtype)
            + _a16(max(_a16(nf * E * itemsize), carry))
            + _a16(F * ac * itemsize) + _a16(rep * ac * itemsize)
            + _a16(rep * E * itemsize) + 2 * _a16(rep * F * 4)
            + rep4 * F * 4)


def _max_frames(smem) -> int:
    """The largest F that fits at the narrowest shape (rep = 1, A = E =
    8, 8 CTAs a cluster), in any kernel dtype: no larger F fits any
    shape."""
    def fits(F):
        return any(smem(1, F, 8, 8, _MAX_CLUSTER, dt) <= _SMEM
                   for dt in KERNEL_DTYPES)
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


class ContextShapeError(ValueError):
    """A shape the CUDA context kernels do not take: A or E not a
    multiple of 8 (16-byte rows of bf16), or a video's share of shared
    memory too large at 8 CTAs a cluster.  The wrappers raise it instead
    of taking another path."""


def check_context_shape(name: str, rep: int, F: int, A: int, E: int,
                        dtype: torch.dtype, backward: bool = False) -> None:
    """Raise :class:`ContextShapeError` unless the CUDA kernel (the
    backward's with ``backward``) takes this shape."""
    if min(A, E) < 8 or A % 8 or E % 8:
        raise ContextShapeError(
            f"{name}: A={A}, E={E}: the CUDA kernel takes A and E in "
            "multiples of 8")
    smem = (_bwd_smem if backward else _fwd_smem)(
        rep, F, A, E, _MAX_CLUSTER, dtype)
    if smem > _SMEM:
        raise ContextShapeError(
            f"{name}: rep={rep}, F={F}, A={A}, E={E} exceed the kernel's "
            f"shared memory ({smem} bytes a CTA at {_MAX_CLUSTER} CTAs a "
            "cluster)")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte aligned address (the kernels' rows
    are read in 16-byte chunks)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


_FWD_MAX_F = _max_frames(_fwd_smem)
_BWD_MAX_F = _max_frames(_bwd_smem)


def _check(q, att_proj, att_mask, att_vals, att_v, rep: int,
           plain: bool = False):
    """Shapes, dtypes and devices of a call (``att_mask`` None: not an
    operand); the kernels take float32, bfloat16 and float16, the plain
    versions float64 too.  Returns (R, B, F, A, E) or raises on what the
    kernels do not take."""
    if rep < 1:
        raise ValueError(f"fused_context_attention: rep={rep} < 1")
    if (q.dim() != 2 or att_proj.dim() != 3 or att_vals.dim() != 3
            or (att_mask is not None and att_mask.dim() != 2)):
        raise ValueError("fused_context_attention: q must be (R, A), "
                         "att_proj (B, F, A), att_vals (B, F, E), att_mask "
                         "(B, F)")
    R, A = q.shape
    B, F, E = att_vals.shape
    cdt = att_vals.dtype
    if cdt not in KERNEL_DTYPES and not (plain and cdt == torch.float64):
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
    if att_mask is not None and tuple(att_mask.shape) != (B, F):
        raise ValueError(f"fused_context_attention: att_mask is "
                         f"{tuple(att_mask.shape)}, expected {(B, F)}")
    for arg, x in (("att_proj", att_proj), ("att_mask", att_mask),
                   ("att_vals", att_vals), ("att_v", att_v)):
        if x is not None and x.device != q.device:
            raise ValueError(f"fused_context_attention: {arg} on {x.device}, "
                             f"q on {q.device}")
    if F > _FWD_MAX_F:
        raise ValueError(f"fused_context_attention: F={F} exceeds the "
                         "kernel's shared memory")
    return R, B, F, A, E


def fused_context_attention_ref(q, att_proj, att_mask, att_vals, att_v,
                                rep: int = 1):
    """Plain version of the kernel (any device): the decode kernels'
    plain attention step (``ops/attlstm.py::context_from_query``) with
    the context rounded to the values' dtype.  Returns ``(ctx (R, E) in
    att_vals.dtype, attn (R, F) float32)``."""
    _check(q, att_proj, att_mask, att_vals, att_v, rep, plain=True)
    cdt = att_vals.dtype
    if rep > 1:
        att_proj, att_mask, att_vals = (
            x.repeat_interleave(rep, dim=0)
            for x in (att_proj, att_mask, att_vals))
    wf = torch.promote_types(cdt, torch.float32)
    ctx, a = context_from_query(q, att_proj, att_mask.to(wf),
                                att_vals.to(wf), att_v.to(wf)[:, 0])
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
    raise.  When autograd records the call (and ``return_attn`` is
    off) it goes through :class:`ContextAttention`, whose backward is
    :func:`fused_context_attention_bwd`."""
    if (not return_attn and torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, att_proj, att_vals, att_v))):
        return ContextAttention.apply(q, att_proj, att_mask, att_vals, att_v,
                                      rep)
    if q.device.type == "cpu":
        ctx, a = fused_context_attention_ref(q, att_proj, att_mask, att_vals,
                                             att_v, rep)
        return (ctx, a) if return_attn else ctx
    if q.device.type != "cuda":
        raise ValueError(f"fused_context_attention: unsupported device "
                         f"{q.device}")
    ctx, attn = _launch_fwd(q, att_proj, att_mask, att_vals, att_v, rep,
                            return_attn)
    return (ctx, attn) if return_attn else ctx


def _launch_fwd(q, att_proj, att_mask, att_vals, att_v, rep, return_attn):
    """The forward kernel on CUDA tensors: ``(ctx, attn or None)``."""
    R, B, F, A, E = _check(q, att_proj, att_mask, att_vals, att_v, rep)
    cdt = att_vals.dtype
    check_context_shape("fused_context_attention", rep, F, A, E, cdt)
    ctx = torch.empty((R, E), dtype=cdt, device=q.device)
    attn = (torch.empty((R, F), dtype=torch.float32, device=q.device)
            if return_attn else None)
    if R:
        ins = [_aligned(x) for x in (q, att_v, att_proj)]
        mask = att_mask.float().contiguous()
        vals = _aligned(att_vals)
        lib = _bound()
        err = lib.cst_context_attention(
            KERNEL_DTYPES[cdt], *(x.data_ptr() for x in ins),
            mask.data_ptr(), vals.data_ptr(), rep, R, F, A, E,
            ctx.data_ptr(), None if attn is None else attn.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, err, "fused_context_attention")
        _build.count_launch(fused_context_attention)
    return ctx, attn


# -------------------------------------------------------------- backward

def _check_bwd(q, att_proj, att_vals, att_v, attn, dctx, rep: int,
               plain: bool = False):
    R, B, F, A, E = _check(q, att_proj, None, att_vals, att_v, rep, plain)
    wdt = torch.promote_types(att_vals.dtype, torch.float32)
    for arg, x, shape, dt in (("attn", attn, (R, F), wdt),
                              ("dctx", dctx, (R, E), att_vals.dtype)):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"fused_context_attention_bwd: {arg} is "
                             f"{x.dtype}{tuple(x.shape)}, expected {dt}{shape}")
        if x.device != q.device:
            raise ValueError(f"fused_context_attention_bwd: {arg} on "
                             f"{x.device}, q on {q.device}")
    if F > _BWD_MAX_F:
        raise ValueError(f"fused_context_attention_bwd: F={F} exceeds the "
                         "kernel's shared memory")
    return R, B, F, A, E


def _rep_sum(x: torch.Tensor, rep: int) -> torch.Tensor:
    """Sum each video's ``rep`` consecutive rows of ``x`` in row order,
    each add in ``x``'s dtype (XLA's reduce for the VJP of
    ``jnp.repeat``)."""
    if rep == 1:
        return x
    x = x.reshape(x.shape[0] // rep, rep, *x.shape[1:])
    acc = x[:, 0]
    for r in range(1, rep):
        acc = acc + x[:, r]
    return acc


def fused_context_attention_bwd_ref(q, att_proj, att_vals, att_v, attn, dctx,
                                    rep: int = 1):
    """Plain version of the backward kernel (any device): ``_bwd_kernel``
    on the forward's operands, its float32 weights ``attn`` (R, F) and
    the context cotangent ``dctx`` (R, E) in the values' dtype.  Returns
    ``(d_q (R, A), d_proj (B, F, A), d_vals (B, F, E), d_v (A, 1))``,
    each in its primal's dtype."""
    _check_bwd(q, att_proj, att_vals, att_v, attn, dctx, rep, plain=True)
    cdt = att_vals.dtype
    if rep > 1:
        att_proj, att_vals = (x.repeat_interleave(rep, dim=0)
                              for x in (att_proj, att_vals))
    wf = attn.dtype
    dc = dctx.to(wf)
    da = (dc[:, None, :] * att_vals.to(wf)).sum(-1)
    d_vals = (attn[:, :, None] * dc[:, None, :]).to(cdt)
    ds = attn * (da - (attn * da).sum(-1, keepdim=True))
    th = tanh_of(att_proj + q[:, None, :], wf)
    d_v = (th * ds[:, :, None]).sum((0, 1))
    dpre = ds[:, :, None] * att_v.to(wf)[:, 0] * (1.0 - th * th)
    return (dpre.sum(1).to(cdt), _rep_sum(dpre.to(cdt), rep),
            _rep_sum(d_vals, rep), d_v.to(att_v.dtype).reshape(att_v.shape))


def fused_context_attention_bwd(q, att_proj, att_vals, att_v, attn, dctx,
                                rep: int = 1):
    """The backward (arguments and results as
    :func:`fused_context_attention_bwd_ref`): CPU tensors take the plain
    version; CUDA tensors launch the kernel
    (``fused_context_attention_bwd.launches`` counts the launches) or
    raise."""
    if q.device.type == "cpu":
        return fused_context_attention_bwd_ref(q, att_proj, att_vals, att_v,
                                               attn, dctx, rep)
    if q.device.type != "cuda":
        raise ValueError(f"fused_context_attention_bwd: unsupported device "
                         f"{q.device}")
    return _launch_bwd(q, att_proj, att_vals, att_v, attn, dctx, rep)


def _launch_bwd(q, att_proj, att_vals, att_v, attn, dctx, rep):
    """The backward kernels on CUDA tensors."""
    R, B, F, A, E = _check_bwd(q, att_proj, att_vals, att_v, attn, dctx, rep)
    cdt = att_vals.dtype
    check_context_shape("fused_context_attention_bwd", rep, F, A, E, cdt,
                        backward=True)
    dev = q.device
    d_q = torch.empty((R, A), dtype=cdt, device=dev)
    d_proj = torch.empty((B, F, A), dtype=cdt, device=dev)
    d_vals = torch.empty((B, F, E), dtype=cdt, device=dev)
    d_v = torch.empty((A, 1), dtype=cdt, device=dev)
    if R:
        dv_part = torch.empty((B, A), dtype=torch.float32, device=dev)
        ins = [x.contiguous() if x is attn else _aligned(x)
               for x in (q, att_v, att_proj, att_vals, attn, dctx)]
        lib = _bound_bwd()
        err = lib.cst_context_attention_bwd(
            KERNEL_DTYPES[cdt], *(x.data_ptr() for x in ins), rep, R, F, A,
            E, dv_part.data_ptr(), d_q.data_ptr(), d_proj.data_ptr(),
            d_vals.data_ptr(), d_v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, "fused_context_attention_bwd")
        _build.count_launch(fused_context_attention_bwd)
    else:
        d_v.zero_()
    return d_q, d_proj, d_vals, d_v


class ContextAttention(torch.autograd.Function):
    """The reference's custom VJP: the forward kernel with the softmax
    weights saved, the backward kernel; ``att_mask`` and ``rep`` get no
    gradient."""

    @staticmethod
    def forward(ctx, q, att_proj, att_mask, att_vals, att_v, rep):
        out, attn = fused_context_attention(q, att_proj, att_mask, att_vals,
                                            att_v, rep=rep, return_attn=True)
        ctx.rep = rep
        ctx.save_for_backward(q, att_proj, att_vals, att_v, attn)
        return out

    @staticmethod
    def backward(ctx, dctx):
        q, att_proj, att_vals, att_v, attn = ctx.saved_tensors
        d_q, d_proj, d_vals, d_v = fused_context_attention_bwd(
            q, att_proj, att_vals, att_v, attn, dctx, rep=ctx.rep)
        return d_q, d_proj, None, d_vals, d_v, None


fused_context_attention.launches = 0
fused_context_attention_bwd.launches = 0
_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("context_attention")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cst_context_attention.argtypes = ([I] + [P] * 5 + [I] * 5
                                              + [P] * 3)
        lib.cst_context_attention.restype = I
        _lib = lib
    return _lib


def _bound_bwd() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("context_attention_bwd")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cst_context_attention_bwd.argtypes = ([I] + [P] * 6 + [I] * 5
                                                  + [P] * 6)
        lib.cst_context_attention_bwd.restype = I
        _bwd_lib = lib
    return _bwd_lib
