"""Teacher-forced attention + LSTM recurrence: CUDA kernel wrappers, the
plain PyTorch versions of its forward and backward, and the autograd
Function; plus the Bahdanau attention step the attention decoders share.

Port of the JAX package's ``ops/pallas_attlstm.py``: the forward
``attlstm_recurrence`` (TPU kernel ``_make_fwd_kernel`` via
``_fwd_call``) and its custom VJP (``_vjp_fwd`` / ``_vjp_bwd``, TPU
kernel ``_bwd_kernel`` via ``_bwd_call``).  The kernels are
``csrc/attlstm_recurrence.cu`` (forward and backward entry points, per
compute dtype) on top of ``csrc/attention_common.cuh`` and
``csrc/tc_common.cuh``; its header says what bounds them on the H100
and how the design differs from the TPU kernels.

Numerics (kernels and plain versions alike, the reference kernels'):
per step ``q = T(h) @ att_wh`` (float32 accumulation), the tanh
argument ``T(att_proj + T(q))`` rounded to the compute dtype T, ``th =
tanh(.)`` (rounded to T again under float16, below) and the score ``s =
sum_a th * v`` in float32, masked frames
at -1e30, a max-subtracted softmax over frames and ``ctx = sum_f a *
f32(att_vals)`` in float32; then ``gates = (gx_t + T(ctx) @ W_ctx) +
T(h) @ W_h`` and the i|f|g|o update with float32 h and c.  A row whose
frames are all masked gets uniform weights, as ``jax.nn.softmax`` does.

The tanh output is not rounded to T under bfloat16 although the
reference's source types it so (``jnp.tanh`` of a compute-dtype array,
then ``.astype(float32)``): XLA keeps a bfloat16 tanh in float32 when a
float32 convert follows.  Under float16 XLA rounds the tanh's result to
float16 before that convert, so at float16 ``th = T(tanh(T(att_proj +
T(q))))`` (:func:`tanh_of`; ``tests/test_torch_attlstm.py`` pins both
facts).  The port follows what the reference computes.

int8w serving adds :func:`attlstm_recurrence_quant` (the reference's
``attlstm_recurrence_quant``, TPU kernel ``_make_fwd_kernel(quant=True)``
via ``_fwd_call``): ``wh``, ``w_ctx`` and ``att_wh`` are int8 codes, the
first two sharing the (4H,) LSTM column scale; ``q = T((T(h) @ codes) *
att_scale)``, ``gates = gx_t + (T(ctx) @ W_ctx) * ls + (T(h) @ W_h) *
ls``, each scale applied once to its float32 sum.  Forward only, with no
residuals and no backward, as in the reference: quantized weights serve,
they never train.  Its plain version is the twin ``attlstm_scan_quant``.

The backward mirrors ``_bwd_kernel`` step for step over reversed time:
gates recomputed from the stored compute-dtype ``h_seq`` and the saved
softmax weights, ``dgates`` rounded to T before the products with
``W_ctx`` and ``W_h``, ``dh = dh_gates + T(dq) @ att_wh^T``, zero
previous state at t = 0; ``dproj``, ``dvals`` and ``dv`` accumulated in
float32 across time.  The three weight cotangents are plain
contractions outside, as the reference leaves them to XLA (``_vjp_bwd``).

``rep``: the attention tensors ``att_proj`` (B, F, A), ``att_mask`` (B,
F) and ``att_vals`` (B, F, E) are per video, and caption row ``r`` of
the ``R = B * rep`` rows reads video ``r // rep``; ``rep = 1`` is the
reference's signature, which its model meets by repeating the cache to
the rows (``_repeat_cache``).  The forward is bitwise the same as rep =
1 on the repeated tensors.  In the backward a video's ``dproj`` and
``dvals`` are each row's float32 sum over reversed time, then the rows
added in row order in float32 (:func:`_fold_rows`), rounded once to the
primal's dtype: bitwise the rep = 1 rows folded so.  The reference
instead rounds each row's cotangent to T and adds a video's rows with one
rounded add each (the VJP of ``jnp.repeat``); the two agree in float32
up to order, and in bf16 the port's single rounding sits within an ulp
of the exact sum (``tests/test_torch_attlstm_rep.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.decode_common import KERNEL_DTYPES
from cst_captioning_torch.ops.rnn import dot_f32, gate_update

NEG_INF = -1e30
# Frames per block of the backward's fold (csrc/attlstm_recurrence.cu
# FD_FRAMES): d_v's partial sums come in ceil(F / 32) rows per video.
_FOLD_FRAMES = 32


# ------------------------------------------------------- attention step

def attention_step(h, att_wh, vvec, att_proj, maskf, vals_f, cdt,
                   att_scale=None):
    """The fused kernels' Bahdanau step (plain): query ``h`` (R, H)
    float32, ``att_proj`` (R, F, A) in ``cdt``, ``maskf`` (R, F) and
    ``vals_f`` (R, F, E) float32, ``vvec`` (A,) float32; ``att_wh`` in
    ``cdt``, or int8 codes with their (A,) ``att_scale`` applied to the
    float32 product before the rounding to ``cdt``.  Returns ``(ctx (R,
    E) f32, a (R, F) f32)``."""
    q = dot_f32(h, att_wh, cdt, att_scale)
    return context_from_query(q.to(cdt), att_proj, maskf, vals_f, vvec)


def tanh_of(arg, wf):
    """The attention's ``th`` from its compute-dtype argument ``arg`` (the
    rounded ``att_proj + q``), in the working dtype ``wf``: ``tanh`` in
    ``wf``, then rounded to float16 when ``arg`` is float16 (XLA rounds a
    float16 tanh's result before the float32 convert that follows, where
    it keeps a bfloat16 tanh in float32)."""
    th = torch.tanh(arg.to(wf))
    return th.half().to(wf) if arg.dtype == torch.float16 else th


def context_from_query(q, att_proj, maskf, vals_f, vvec):
    """The score, softmax and context of the attention step from a query
    ``q`` (R, A) already in ``att_proj``'s dtype (arguments otherwise as
    :func:`attention_step`).  Returns ``(ctx (R, E) f32, a (R, F)
    f32)`` (float64 where ``vals_f`` is)."""
    th = tanh_of(att_proj + q[:, None, :], vals_f.dtype)
    s = (th * vvec).sum(-1)
    s = torch.where(maskf > 0, s, NEG_INF)
    m = s.max(-1, keepdim=True).values
    e = torch.exp(s - m)
    a = e / e.sum(-1, keepdim=True)
    ctx = (a[:, :, None] * vals_f).sum(1)
    return ctx, a


def dense_context_attention(q, att_proj, att_mask, att_vals, att_v):
    """The per-step (unfused) context of ``CaptionModel._context``
    (reference ``ops/pallas_attention.py::dense_context_attention``):
    score and mix accumulate float32, the weights round to the values'
    dtype before the mix, the context returns in that dtype."""
    cdt = att_vals.dtype
    th = torch.tanh(att_proj + q[:, None, :])
    s = dot_f32(th, att_v, cdt)[..., 0]
    s = torch.where(att_mask > 0, s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bf,bfe->be", a.to(cdt).float(), att_vals.float())
    return ctx.to(cdt)


def check_att_operands(name: str, cdt, B: int, E: int, H: int, w_ctx,
                       att_wh, att_v, att_proj, att_mask, att_vals,
                       device, wdt=None) -> Tuple[int, int]:
    """Validate the attention operands of a kernel call (``att_mask``
    None: not an operand; ``wdt``: the dtype of ``w_ctx`` and ``att_wh``,
    int8 under int8w, else ``cdt``); returns (F, A) or raises on what the
    kernels do not take."""
    wdt = cdt if wdt is None else wdt
    if att_proj.dim() != 3 or att_vals.dim() != 3 or att_wh.dim() != 2:
        raise ValueError(f"{name}: att_proj / att_vals must be (B, F, *), "
                         f"att_wh (H, A)")
    F, A = att_proj.shape[1], att_proj.shape[2]
    for arg, x, shape, dt in (("w_ctx", w_ctx, (E, 4 * H), wdt),
                              ("att_wh", att_wh, (H, A), wdt),
                              ("att_v", att_v, (A, 1), cdt),
                              ("att_proj", att_proj, (B, F, A), cdt),
                              ("att_vals", att_vals, (B, F, E), cdt)):
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"{name}: {arg} is {x.dtype}{tuple(x.shape)}, "
                             f"expected {dt}{shape}")
    if att_mask is not None and tuple(att_mask.shape) != (B, F):
        raise ValueError(f"{name}: att_mask is {tuple(att_mask.shape)}, "
                         f"expected {(B, F)}")
    for arg, x in (("w_ctx", w_ctx), ("att_wh", att_wh), ("att_v", att_v),
                   ("att_proj", att_proj), ("att_mask", att_mask),
                   ("att_vals", att_vals)):
        if x is not None and x.device != device:
            raise ValueError(f"{name}: {arg} on {x.device}, expected {device}")
    if F < 1 or A < 1 or 2 * A + F > 12_000 or E > 12_000:
        raise ValueError(f"{name}: F={F}, A={A}, E={E} not supported")
    return F, A


# --------------------------------------------------------------- layout

def _check_rep(name: str, R: int, att_proj, rep: int) -> int:
    """The video count B of ``R`` caption rows at ``rep`` rows a video:
    ``att_proj`` holds B videos and ``B * rep`` must be ``R``."""
    B = att_proj.shape[0] if att_proj.dim() == 3 else -1
    if rep < 1 or B * rep != R:
        raise ValueError(f"{name}: {R} rows for {B} videos at rep={rep} "
                         f"(R must be B * rep)")
    return B


def _rows(rep: int, *xs):
    """Per-video tensors repeated to their caption rows (video b ->
    rows b*rep .. b*rep+rep-1), as the reference's ``_repeat_cache``."""
    return xs if rep == 1 else tuple(x.repeat_interleave(rep, dim=0)
                                     for x in xs)


def _fold_rows(x, rep: int):
    """Per-row float sums (R, ...) -> per video: the first row, then
    each further row added in row order (one add each), as the backward
    kernel folds them."""
    if rep == 1:
        return x
    x = x.reshape(x.shape[0] // rep, rep, *x.shape[1:])
    out = x[:, 0].clone()
    for j in range(1, rep):
        out = out + x[:, j]
    return out


def _dot(a, b, cdt):
    """The plain recurrence's products: :func:`dot_f32` (operands rounded
    to ``cdt``, float32 accumulation), accumulated in float64 for float64
    operands (the autograd Function's gradcheck)."""
    if cdt == torch.float64:
        return torch.matmul(a.to(cdt), b.to(cdt))
    return dot_f32(a, b, cdt)


def _work_dtype(cdt):
    return torch.promote_types(cdt, torch.float32)


# --------------------------------------------------------------- forward

def attlstm_recurrence_ref(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                           att_vals, rep: int = 1,
                           with_residuals: bool = False):
    """Plain version of the forward kernel (any device).  Shapes: gx
    (R, T, 4H) float32; wh (H, 4H), w_ctx (E, 4H), att_wh (H, A), att_v
    (A, 1), att_proj (B, F, A), att_vals (B, F, E) in the compute dtype;
    att_mask (B, F); R = B * rep caption rows, row r reading video r //
    rep (rep = 1: the reference's per-row signature).  Returns ``h_seq``
    (R, T, H) in ``wh.dtype``, plus the float32 residuals ``(c_seq (R,
    T, H), a_seq (R, T, F))`` with ``with_residuals``.  float64 operands
    compute in float64."""
    R, T, _ = gx.shape
    _check_rep("attlstm_recurrence", R, att_proj, rep)
    att_proj, att_mask, att_vals = _rows(rep, att_proj, att_mask, att_vals)
    H = wh.shape[0]
    F = att_proj.shape[1]
    cdt = wh.dtype
    wf = _work_dtype(cdt)
    dev = gx.device
    fk = dict(dtype=wf, device=dev)
    maskf = att_mask.to(wf)
    vvec = att_v.to(wf)[:, 0]
    vals_f = att_vals.to(wf)
    h = torch.zeros((R, H), **fk)
    c = torch.zeros_like(h)
    h_seq = torch.empty((R, T, H), dtype=cdt, device=dev)
    if with_residuals:
        c_seq = torch.empty((R, T, H), **fk)
        a_seq = torch.empty((R, T, F), **fk)
    for t in range(T):
        q = _dot(h, att_wh, cdt)
        ctx, a = context_from_query(q.to(cdt), att_proj, maskf, vals_f, vvec)
        gates = gx[:, t].to(wf) + _dot(ctx, w_ctx, cdt)
        gates = gates + _dot(h, wh, cdt)
        h, c = gate_update(gates, c)
        h_seq[:, t] = h.to(cdt)
        if with_residuals:
            c_seq[:, t] = c
            a_seq[:, t] = a
    return (h_seq, c_seq, a_seq) if with_residuals else h_seq


def attlstm_recurrence_fwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                           att_vals, rep: int = 1,
                           with_residuals: bool = False):
    """The forward: CPU tensors take :func:`attlstm_recurrence_ref`,
    CUDA tensors launch the kernel (``attlstm_recurrence.launches``
    counts the launches)."""
    if gx.device.type == "cpu":
        return attlstm_recurrence_ref(gx, wh, w_ctx, att_wh, att_v, att_proj,
                                      att_mask, att_vals, rep,
                                      with_residuals=with_residuals)
    if gx.device.type != "cuda":
        raise ValueError(f"attlstm_recurrence: unsupported device {gx.device}")
    return _launch_fwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                       att_vals, rep, with_residuals)


def _check_recurrence(name, gx, wh, w_ctx, att_wh, att_v, att_proj,
                      att_mask, att_vals, rep):
    if gx.dim() != 3 or wh.dim() != 2:
        raise ValueError(f"{name}: gx must be (R, T, 4H), wh (H, 4H)")
    R, T, G = gx.shape
    H = wh.shape[0]
    if G != 4 * H or wh.shape[1] != G:
        raise ValueError(f"{name}: gx {tuple(gx.shape)} does not match wh "
                         f"{tuple(wh.shape)}")
    if gx.dtype != torch.float32:
        raise ValueError(f"{name}: gx must be float32, got {gx.dtype}")
    if wh.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: unsupported dtype {wh.dtype}")
    if wh.device != gx.device:
        raise ValueError(f"{name}: gx and wh on different devices")
    E = w_ctx.shape[0]
    B = _check_rep(name, R, att_proj, rep)
    F, A = check_att_operands(name, wh.dtype, B, E, H, w_ctx, att_wh, att_v,
                              att_proj, att_mask, att_vals, gx.device)
    _check_kernel_widths(name, wh.dtype, H, E, A)
    return R, T, H, E, F, A


def _check_kernel_widths(name, cdt, H, E, A):
    """The kernels read A and E in 16-byte chunks; the 16-bit tile GEMMs
    also want H and E in multiples of 32."""
    if A % 8 or E % 8 or (cdt != torch.float32 and (H % 32 or E % 32)):
        raise ValueError(f"{name}: H={H}, E={E}, A={A} not supported by the "
                         f"{cdt} kernels (A, E multiples of 8; bf16 and "
                         "f16: H, E multiples of 32)")


def tanh_table_check(device) -> torch.Tensor:
    """The bf16 kernels' tanh table against ``tanhf`` on the card: (2,
    65536) float32, row 0 the lookups and row 1 ``tanhf`` of every bf16
    value (bits ``i << 16``); the two must agree bit for bit, and be NaN
    on the NaN inputs."""
    out = torch.empty((2, 65536), dtype=torch.float32, device=device)
    lib = _bound()
    _build.check(lib, lib.cst_attlstm_tanh_check(out.data_ptr(),
                                                 _stream(out.device)),
                 "attlstm tanh table")
    return out


def tanh_f16_check(device) -> torch.Tensor:
    """The f16 kernels' tanh on the card (``attention_tc.cuh::
    tanh_direct``: ``tanhf`` of the f16 argument, rounded to f16) of every
    f16 code ``i``: (65536,) float32, to hold bitwise against
    :func:`tanh_of` (NaN on the NaN codes)."""
    out = torch.empty((65536,), dtype=torch.float32, device=device)
    lib = _bound()
    _build.check(lib, lib.cst_attlstm_tanh_f16(out.data_ptr(),
                                               _stream(out.device)),
                 "attlstm f16 tanh")
    return out


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(x):
    return None if x is None else x.data_ptr()


# The 16-bit entries of csrc/attlstm_recurrence.cu by compute dtype.
_TC_FWD = {torch.bfloat16: "cst_attlstm_fwd_bf16",
           torch.float16: "cst_attlstm_fwd_f16"}
_TC_BWD = {torch.bfloat16: "cst_attlstm_bwd_bf16",
           torch.float16: "cst_attlstm_bwd_f16"}


def _launch_fwd_tc(lib, gx, wcat_t, att_wh_t, lstm_s, att_s, att_v,
                   att_proj, att_mask, att_vals, h_seq, c_seq, a_seq,
                   rep, name):
    """The tensor-core forward at ``h_seq``'s dtype (``cst_attlstm_fwd_
    bf16`` / ``_f16``): ``wcat_t`` is ``[W_ctx ; W_h]^T`` (4H, E + H) and
    ``att_wh_t`` ``att_wh^T`` (A, H) in that dtype, the int8w scales
    (bf16 only) or None."""
    R, T, H = h_seq.shape
    A, E = att_wh_t.shape[0], att_vals.shape[-1]
    F = att_proj.shape[1]
    dev = gx.device
    cdt = h_seq.dtype
    c = torch.empty((R, H), dtype=torch.float32, device=dev)
    q = torch.empty((R, A), dtype=cdt, device=dev)
    ctx = torch.empty((R, E), dtype=cdt, device=dev)
    ins = [x.contiguous() for x in (gx, wcat_t, att_wh_t)]
    ops = [None if x is None else x.contiguous()
           for x in (lstm_s, att_s, att_v, att_proj)]
    mask = att_mask.float().contiguous()
    err = getattr(lib, _TC_FWD[cdt])(
        *(_ptr(x) for x in ins + ops), mask.data_ptr(),
        att_vals.contiguous().data_ptr(), c.data_ptr(), q.data_ptr(),
        ctx.data_ptr(), h_seq.data_ptr(), _ptr(c_seq), _ptr(a_seq),
        R, T, H, E, A, F, rep, _stream(dev))
    _build.check(lib, err, name)


def _launch_fwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask, att_vals,
                rep: int, with_residuals: bool):
    R, T, H, E, F, A = _check_recurrence(
        "attlstm_recurrence", gx, wh, w_ctx, att_wh, att_v, att_proj,
        att_mask, att_vals, rep)
    dev = gx.device
    f32 = dict(dtype=torch.float32, device=dev)
    h_seq = torch.empty((R, T, H), dtype=wh.dtype, device=dev)
    c_seq = torch.empty((R, T, H), **f32) if with_residuals else None
    a_seq = torch.empty((R, T, F), **f32) if with_residuals else None
    if R and T:
        lib = _bound()
        if wh.dtype == torch.float32:
            _launch_fwd_f32(lib, 0, gx, wh, w_ctx, att_wh, att_v, att_proj,
                            att_mask, att_vals, None, None, h_seq, c_seq,
                            a_seq, rep, "attlstm_recurrence")
        else:
            _launch_fwd_tc(lib, gx, torch.cat([w_ctx, wh]).t(), att_wh.t(),
                           None, None, att_v, att_proj, att_mask, att_vals,
                           h_seq, c_seq, a_seq, rep, "attlstm_recurrence")
        _build.count_launch(attlstm_recurrence)
    return (h_seq, c_seq, a_seq) if with_residuals else h_seq


def _launch_fwd_f32(lib, wq, gx, wh, w_ctx, att_wh, att_v, att_proj,
                    att_mask, att_vals, lstm_s, att_s, h_seq, c_seq, a_seq,
                    rep, name):
    """The float32-compute forward (``cst_attlstm_fwd_f32``, SIMT);
    ``wq``: the weights are int8 codes with their scales."""
    R, T, H = h_seq.shape
    E, A, F = w_ctx.shape[0], att_wh.shape[1], att_proj.shape[1]
    f32 = dict(dtype=torch.float32, device=gx.device)
    h_a = torch.zeros((R, H), **f32)
    h_b = torch.empty((R, H), **f32)
    c = torch.zeros((R, H), **f32)
    q = torch.empty((R, A), **f32)
    ctx = torch.empty((R, E), **f32)
    ins = [x.contiguous() for x in (gx, wh, w_ctx, att_wh, att_v, att_proj)]
    mask = att_mask.float().contiguous()
    err = lib.cst_attlstm_fwd_f32(
        wq, *(x.data_ptr() for x in ins), mask.data_ptr(),
        att_vals.contiguous().data_ptr(), h_a.data_ptr(), h_b.data_ptr(),
        c.data_ptr(), q.data_ptr(), ctx.data_ptr(), h_seq.data_ptr(),
        _ptr(c_seq), _ptr(a_seq), _ptr(lstm_s), _ptr(att_s),
        R, T, H, E, A, F, rep, _stream(gx.device))
    _build.check(lib, err, name)


# ------------------------------------------------------------ int8w forward

def attlstm_recurrence_quant_ref(gx, wh_q, w_ctx_q, lstm_scale, att_wh_q,
                                 att_scale, att_v, att_proj, att_mask,
                                 att_vals, compute_dtype, rep: int = 1):
    """Plain version of the int8w forward (any device), step for step
    the reference twin ``attlstm_scan_quant``: ``wh_q`` (H, 4H) and
    ``w_ctx_q`` (E, 4H) int8 sharing ``lstm_scale`` (4H,), ``att_wh_q``
    (H, A) int8 with ``att_scale`` (A,); ``att_v``, ``att_proj`` and
    ``att_vals`` in ``compute_dtype``, per video as
    :func:`attlstm_recurrence_ref`.  Returns ``h_seq`` (R, T, H) in
    ``compute_dtype``."""
    R, T, _ = gx.shape
    _check_rep("attlstm_recurrence_quant", R, att_proj, rep)
    att_proj, att_mask, att_vals = _rows(rep, att_proj, att_mask, att_vals)
    H = wh_q.shape[0]
    cdt = compute_dtype
    f32 = dict(dtype=torch.float32, device=gx.device)
    maskf = att_mask.float()
    vvec = att_v.float()[:, 0]
    vals_f = att_vals.float()
    ls = lstm_scale
    h = torch.zeros((R, H), **f32)
    c = torch.zeros_like(h)
    h_seq = torch.empty((R, T, H), dtype=cdt, device=gx.device)
    for t in range(T):
        ctx, _ = attention_step(h, att_wh_q, vvec, att_proj, maskf, vals_f,
                                cdt, att_scale)
        gates = (gx[:, t].float() + dot_f32(ctx, w_ctx_q, cdt, ls)
                 + dot_f32(h, wh_q, cdt, ls))
        h, c = gate_update(gates, c)
        h_seq[:, t] = h.to(cdt)
    return h_seq


def attlstm_recurrence_quant(gx, wh_q, w_ctx_q, lstm_scale, att_wh_q,
                             att_scale, att_v, att_proj, att_mask, att_vals,
                             compute_dtype, rep: int = 1):
    """Fused int8w attention + LSTM forward (serving only: no autograd),
    arguments as :func:`attlstm_recurrence_quant_ref`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel's int8w
    instantiation (``attlstm_recurrence_quant.launches`` counts the
    launches) or raise.  With bf16 compute the codes are widened to
    bf16 once per call for the tensor-core path (exact), the scales
    applied to the float32 sums."""
    args = (gx, wh_q, w_ctx_q, lstm_scale, att_wh_q, att_scale, att_v,
            att_proj, att_mask, att_vals, compute_dtype)
    if gx.device.type == "cpu":
        return attlstm_recurrence_quant_ref(*args, rep=rep)
    if gx.device.type != "cuda":
        raise ValueError(f"attlstm_recurrence_quant: unsupported device "
                         f"{gx.device}")
    name = "attlstm_recurrence_quant"
    cdt = compute_dtype
    if cdt not in KERNEL_DTYPES or cdt == torch.float16:
        raise ValueError(f"{name}: unsupported compute dtype {cdt}")
    if gx.dim() != 3 or gx.dtype != torch.float32 or wh_q.dim() != 2:
        raise ValueError(f"{name}: gx must be float32 (R, T, 4H), wh (H, 4H)")
    R, T, G = gx.shape
    H = wh_q.shape[0]
    E = w_ctx_q.shape[0]
    if (G != 4 * H or tuple(wh_q.shape) != (H, G) or wh_q.dtype != torch.int8
            or wh_q.device != gx.device):
        raise ValueError(f"{name}: wh is {wh_q.dtype}{tuple(wh_q.shape)} on "
                         f"{wh_q.device}, gx {tuple(gx.shape)}")
    B = _check_rep(name, R, att_proj, rep)
    F, A = check_att_operands(name, cdt, B, E, H, w_ctx_q, att_wh_q, att_v,
                              att_proj, att_mask, att_vals, gx.device,
                              wdt=torch.int8)
    _check_kernel_widths(name, cdt, H, E, A)
    scales = []
    for arg, x, n in (("lstm_scale", lstm_scale, G),
                      ("att_scale", att_scale, A)):
        if (x.dtype != torch.float32 or tuple(x.shape) != (n,)
                or x.device != gx.device):
            raise ValueError(f"{name}: {arg} is {x.dtype}{tuple(x.shape)}")
        scales.append(x.contiguous())
    h_seq = torch.empty((R, T, H), dtype=cdt, device=gx.device)
    if R and T:
        lib = _bound()
        if cdt == torch.float32:
            _launch_fwd_f32(lib, 1, gx, wh_q, w_ctx_q, att_wh_q, att_v,
                            att_proj, att_mask, att_vals, *scales, h_seq,
                            None, None, rep, name)
        else:
            wide = torch.bfloat16
            _launch_fwd_tc(lib, gx, torch.cat([w_ctx_q, wh_q]).to(wide).t(),
                           att_wh_q.to(wide).t(), *scales, att_v, att_proj,
                           att_mask, att_vals, h_seq, None, None, rep, name)
        _build.count_launch(attlstm_recurrence_quant)
    return h_seq


# -------------------------------------------------------------- backward

def _bwd_core_ref(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals, h_seq,
                  c_seq, a_seq, dh, rep: int = 1):
    """The reversed-time loop of ``_bwd_kernel`` (plain), per caption row,
    then each video's rows of ``dproj`` / ``dvals`` folded in row order
    (:func:`_fold_rows`).  Returns the float32 (float64 for float64
    operands) ``(dgx (R, T, 4H), dq_seq (R, T, A), dproj (B, F, A), dvals
    (B, F, E), dv (A,))``."""
    R, T, G = gx.shape
    _check_rep("attlstm_recurrence_bwd", R, att_proj, rep)
    att_proj, att_vals = _rows(rep, att_proj, att_vals)
    H = wh.shape[0]
    F, A = att_proj.shape[1], att_proj.shape[2]
    E = att_vals.shape[-1]
    cdt = wh.dtype
    wf = _work_dtype(cdt)
    fk = dict(dtype=wf, device=gx.device)
    vvec = att_v.to(wf)[:, 0]
    vals_f = att_vals.to(wf)
    h_prev = torch.cat([torch.zeros((R, 1, H), **fk),
                        h_seq[:, :-1].to(wf)], dim=1)
    c_prev = torch.cat([torch.zeros((R, 1, H), **fk), c_seq[:, :-1]], dim=1)
    dgx = torch.empty((R, T, G), **fk)
    dq_seq = torch.empty((R, T, A), **fk)
    dproj = torch.zeros((R, F, A), **fk)
    dvals = torch.zeros((R, F, E), **fk)
    dv = torch.zeros((A,), **fk)
    dh_next = torch.zeros((R, H), **fk)
    dc_next = torch.zeros((R, H), **fk)
    for t in reversed(range(T)):
        hp, cp, a = h_prev[:, t], c_prev[:, t], a_seq[:, t]
        ctx = (a[:, :, None] * vals_f).sum(1)
        q = _dot(hp, att_wh, cdt)
        gates = gx[:, t].to(wf) + _dot(ctx, w_ctx, cdt)
        gates = gates + _dot(hp, wh, cdt)
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H: 2 * H])
        g = torch.tanh(gates[:, 2 * H: 3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        tch = torch.tanh(c_seq[:, t])
        dh_t = dh[:, t].to(wf) + dh_next
        do = dh_t * tch * o * (1.0 - o)
        dc = dc_next + dh_t * o * (1.0 - tch * tch)
        di = dc * g * i * (1.0 - i)
        df = dc * cp * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        dgates = torch.cat([di, df, dg, do], dim=-1)
        dgx[:, t] = dgates
        dctx = _dot(dgates, w_ctx.T, cdt)
        dh_gates = _dot(dgates, wh.T, cdt)
        da = (dctx[:, None, :] * vals_f).sum(-1)
        dvals += a[:, :, None] * dctx[:, None, :]
        ds = a * (da - (a * da).sum(-1, keepdim=True))
        th = tanh_of(att_proj + q.to(cdt)[:, None, :], wf)
        dv += (th * ds[:, :, None]).sum((0, 1))
        dpre = ds[:, :, None] * vvec * (1.0 - th * th)
        dproj += dpre
        dq = dpre.sum(1)
        dq_seq[:, t] = dq
        dh_next = dh_gates + _dot(dq, att_wh.T, cdt)
        dc_next = dc * f
    return dgx, dq_seq, _fold_rows(dproj, rep), _fold_rows(dvals, rep), dv


def _finish_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals, h_seq,
                a_seq, core, rep: int = 1):
    """``_vjp_bwd``'s epilogue: the three weight cotangents as plain
    contractions over the per-step gate and query cotangents, every
    cotangent in its primal's dtype (``dproj`` and ``dvals``, summed per
    video in float32, rounded once)."""
    dgx, dq_seq, dproj, dvals, dv = core
    R, T, H = h_seq.shape
    G, A, E = dgx.shape[-1], dq_seq.shape[-1], att_vals.shape[-1]
    F = a_seq.shape[-1]
    wf = dgx.dtype
    h_prev = torch.cat([torch.zeros((R, 1, H), dtype=wf, device=gx.device),
                        h_seq[:, :-1].to(wf)], dim=1).reshape(R * T, H)
    ctx_seq = torch.bmm(a_seq.reshape(R // rep, rep * T, F),
                        att_vals.to(wf)).reshape(R * T, E)
    dg2 = dgx.reshape(R * T, G)
    return (
        dgx.to(gx.dtype),
        (h_prev.T @ dg2).to(wh.dtype),
        (ctx_seq.T @ dg2).to(w_ctx.dtype),
        (h_prev.T @ dq_seq.reshape(R * T, A)).to(att_wh.dtype),
        dv.reshape(att_v.shape).to(att_v.dtype),
        dproj.to(att_proj.dtype),
        dvals.to(att_vals.dtype),
    )


def attlstm_recurrence_bwd_ref(gx, wh, w_ctx, att_wh, att_v, att_proj,
                               att_vals, h_seq, c_seq, a_seq, dh,
                               rep: int = 1):
    """Plain backward (any device): ``(dgx, dwh, dw_ctx, datt_wh, dv,
    dproj, dvals)`` from the forward's residuals and the cotangent of
    ``h_seq``; ``dproj`` and ``dvals`` per video."""
    core = _bwd_core_ref(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals,
                         h_seq, c_seq, a_seq, dh, rep)
    return _finish_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals,
                       h_seq, a_seq, core, rep)


def attlstm_recurrence_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals,
                           h_seq, c_seq, a_seq, dh, rep: int = 1):
    """The backward: CPU tensors take :func:`attlstm_recurrence_bwd_ref`,
    CUDA tensors launch the backward kernel for the reversed-time loop
    (``attlstm_recurrence_bwd.launches`` counts the launches) and reduce
    the weight cotangents outside it."""
    core = attlstm_recurrence_bwd_core(gx, wh, w_ctx, att_wh, att_v, att_proj,
                                       att_vals, h_seq, c_seq, a_seq, dh, rep)
    return _finish_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals,
                       h_seq, a_seq, core, rep)


def attlstm_recurrence_bwd_core(gx, wh, w_ctx, att_wh, att_v, att_proj,
                                att_vals, h_seq, c_seq, a_seq, dh,
                                rep: int = 1):
    """The reversed-time loop before ``_finish_bwd`` rounds its outputs:
    ``(dgx, dq_seq, dproj, dvals, dv)`` as :func:`_bwd_core_ref` returns
    them.  CPU tensors take :func:`_bwd_core_ref`, CUDA tensors launch
    the backward kernel (``attlstm_recurrence_bwd.launches`` counts the
    launches)."""
    if gx.device.type == "cpu":
        return _bwd_core_ref(gx, wh, w_ctx, att_wh, att_v, att_proj,
                             att_vals, h_seq, c_seq, a_seq, dh, rep)
    if gx.device.type != "cuda":
        raise ValueError(f"attlstm_recurrence: unsupported device {gx.device}")
    R, T, H, E, F, A = _check_recurrence(
        "attlstm_recurrence_bwd", gx, wh, w_ctx, att_wh, att_v, att_proj,
        None, att_vals, rep)
    for arg, x, shape, dt in (("h_seq", h_seq, (R, T, H), wh.dtype),
                              ("c_seq", c_seq, (R, T, H), torch.float32),
                              ("a_seq", a_seq, (R, T, F), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dt or x.device != gx.device:
            raise ValueError(f"attlstm_recurrence_bwd: {arg} is "
                             f"{x.dtype}{tuple(x.shape)}, expected {dt}{shape}")
    if tuple(dh.shape) != (R, T, H):
        raise ValueError(f"attlstm_recurrence_bwd: dh is {tuple(dh.shape)}")
    B = R // rep
    dev = gx.device
    f32 = dict(dtype=torch.float32, device=dev)
    lo = dict(dtype=wh.dtype, device=dev)
    dgx = torch.empty((R, T, 4 * H), **f32)
    dq_seq = torch.empty((R, T, A), **f32)
    dproj = torch.zeros((B, F, A), **f32)
    dvals = torch.zeros((B, F, E), **f32)
    dv = torch.zeros((A,), **f32)
    if R and T:
        dv_part = torch.empty((B * -(-F // _FOLD_FRAMES), A), **f32)
        dctx_seq = torch.empty((R, T, E), **f32)
        ds_seq = torch.empty((R, T, F), **f32)
        dh_c = torch.zeros((R, H), **f32)
        dc_c = torch.zeros((R, H), **f32)
        ops = [x.contiguous() for x in (att_v, att_proj, att_vals, h_seq,
                                        c_seq, a_seq)]
        outs = [dgx, dq_seq, dproj, dvals, dv_part, dv]
        dh32 = dh.float().contiguous()
        lib = _bound()
        if wh.dtype == torch.float32:
            q_all = torch.empty((R, T, A), **f32)
            ctx = torch.empty((R, E), **f32)
            ws = [x.contiguous() for x in (gx, wh, w_ctx, att_wh)]
            err = lib.cst_attlstm_bwd_f32(
                *(x.data_ptr() for x in ws + ops + [dh32] + outs
                  + [q_all, ctx, dctx_seq, ds_seq, dh_c, dc_c]),
                R, T, H, E, A, F, rep, _stream(dev))
        else:
            wcat = torch.cat([w_ctx, wh]).contiguous()
            ws = [gx.contiguous(), wcat, wcat.t().contiguous(),
                  att_wh.contiguous(), att_wh.t().contiguous()]
            scratch = [torch.empty((R, T, A), **lo), torch.empty((R, T, E), **lo),
                       dctx_seq, ds_seq, torch.empty((R, 4 * H), **lo),
                       torch.empty((R, A), **lo), dh_c, dc_c]
            err = getattr(lib, _TC_BWD[wh.dtype])(
                *(x.data_ptr() for x in ws + ops + [dh32] + outs + scratch),
                R, T, H, E, A, F, rep, _stream(dev))
        _build.check(lib, err, "attlstm_recurrence_bwd")
        _build.count_launch(attlstm_recurrence_bwd)
    return dgx, dq_seq, dproj, dvals, dv


# ------------------------------------------------------------- autograd

class AttLSTMRecurrence(torch.autograd.Function):
    """The reference's custom VJP: the forward writes the float32 cell
    and softmax residuals, the backward is
    :func:`attlstm_recurrence_bwd`; the mask gets a zero cotangent and
    ``rep`` none."""

    @staticmethod
    def forward(ctx, gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                att_vals, rep=1):
        h_seq, c_seq, a_seq = attlstm_recurrence_fwd(
            gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask, att_vals, rep,
            with_residuals=True)
        ctx.save_for_backward(gx, wh, w_ctx, att_wh, att_v, att_proj,
                              att_mask, att_vals, h_seq, c_seq, a_seq)
        ctx.rep = rep
        return h_seq

    @staticmethod
    def backward(ctx, dh):
        (gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask, att_vals, h_seq,
         c_seq, a_seq) = ctx.saved_tensors
        dgx, dwh, dw_ctx, datt_wh, dv, dproj, dvals = attlstm_recurrence_bwd(
            gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals, h_seq, c_seq,
            a_seq, dh, ctx.rep)
        dmask = (torch.zeros_like(att_mask) if ctx.needs_input_grad[6]
                 else None)
        return dgx, dwh, dw_ctx, datt_wh, dv, dproj, dmask, dvals, None


def attlstm_recurrence(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                       att_vals, rep: int = 1) -> torch.Tensor:
    """Attention + LSTM recurrence over pre-computed input gates, from
    zero state (shapes as :func:`attlstm_recurrence_ref`; the attention
    tensors per video, ``rep`` caption rows each).  Returns ``h_seq``
    (R, T, H) in ``wh.dtype``.  When autograd records the call goes
    through :class:`AttLSTMRecurrence`; otherwise the forward writes no
    residuals, as the reference's primal path does."""
    args = (gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask, att_vals)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return AttLSTMRecurrence.apply(*args, rep)
    return attlstm_recurrence_fwd(*args, rep, with_residuals=False)


attlstm_recurrence.launches = 0
attlstm_recurrence_bwd.launches = 0
attlstm_recurrence_quant.launches = 0
_lib: Optional[ctypes.CDLL] = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("attlstm_recurrence")
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn, head, n_ptr in (("cst_attlstm_fwd_f32", [I], 18),
                                ("cst_attlstm_fwd_bf16", [], 15),
                                ("cst_attlstm_fwd_f16", [], 15),
                                ("cst_attlstm_bwd_f32", [], 23),
                                ("cst_attlstm_bwd_bf16", [], 26),
                                ("cst_attlstm_bwd_f16", [], 26)):
            f = getattr(lib, fn)
            f.argtypes = head + [P] * n_ptr + [I] * 7 + [P]
            f.restype = I
        for fn in ("cst_attlstm_tanh_check", "cst_attlstm_tanh_f16"):
            getattr(lib, fn).argtypes = [P, P]
            getattr(lib, fn).restype = I
        _lib = lib
    return _lib
