"""Teacher-forced attention + LSTM recurrence: CUDA kernel wrappers, the
plain PyTorch versions of its forward and backward, and the autograd
Function; plus the Bahdanau attention step the attention decoders share.

Port of the JAX package's ``ops/pallas_attlstm.py``: the forward
``attlstm_recurrence`` (TPU kernel ``_make_fwd_kernel`` via
``_fwd_call``) and its custom VJP (``_vjp_fwd`` / ``_vjp_bwd``, TPU
kernel ``_bwd_kernel`` via ``_bwd_call``).  The kernels are
``csrc/attlstm_recurrence.cu`` (forward and backward entry points) on
top of ``csrc/attention_common.cuh``; their headers say what bounds
them on the H100 and how the design differs from the TPU kernels.

Numerics (kernels and plain versions alike, the reference kernels'):
per step ``q = T(h) @ att_wh`` (float32 accumulation), the tanh
argument ``T(att_proj + T(q))`` rounded to the compute dtype T, ``th =
tanh(.)`` and the score ``s = sum_a th * v`` in float32, masked frames
at -1e30, a max-subtracted softmax over frames and ``ctx = sum_f a *
f32(att_vals)`` in float32; then ``gates = (gx_t + T(ctx) @ W_ctx) +
T(h) @ W_h`` and the i|f|g|o update with float32 h and c.  A row whose
frames are all masked gets uniform weights, as ``jax.nn.softmax`` does.

The tanh output is not rounded to T although the reference's source
types it so (``jnp.tanh`` of a compute-dtype array, then
``.astype(float32)``): XLA keeps it in float32 when a float32 convert
follows (``tests/test_torch_attlstm.py`` pins both facts), and the
port follows what the reference computes.

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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.decode_common import KERNEL_DTYPES
from cst_captioning_torch.ops.rnn import dot_f32, gate_update

NEG_INF = -1e30


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


def context_from_query(q, att_proj, maskf, vals_f, vvec):
    """The score, softmax and context of the attention step from a query
    ``q`` (R, A) already in ``att_proj``'s dtype (arguments otherwise as
    :func:`attention_step`).  Returns ``(ctx (R, E) f32, a (R, F)
    f32)`` (float64 where ``vals_f`` is)."""
    th = torch.tanh((att_proj + q[:, None, :]).to(vals_f.dtype))
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


# --------------------------------------------------------------- forward

def attlstm_recurrence_ref(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                           att_vals, with_residuals: bool = False):
    """Plain version of the forward kernel (any device).  Shapes: gx
    (R, T, 4H) float32; wh (H, 4H), w_ctx (E, 4H), att_wh (H, A), att_v
    (A, 1), att_proj (R, F, A), att_vals (R, F, E) in the compute dtype;
    att_mask (R, F).  Returns ``h_seq`` (R, T, H) in ``wh.dtype``, plus
    the float32 residuals ``(c_seq (R, T, H), a_seq (R, T, F))`` with
    ``with_residuals``."""
    R, T, _ = gx.shape
    H = wh.shape[0]
    F = att_proj.shape[1]
    cdt = wh.dtype
    dev = gx.device
    f32 = dict(dtype=torch.float32, device=dev)
    maskf = att_mask.float()
    vvec = att_v.float()[:, 0]
    vals_f = att_vals.float()
    h = torch.zeros((R, H), **f32)
    c = torch.zeros_like(h)
    h_seq = torch.empty((R, T, H), dtype=cdt, device=dev)
    if with_residuals:
        c_seq = torch.empty((R, T, H), **f32)
        a_seq = torch.empty((R, T, F), **f32)
    for t in range(T):
        ctx, a = attention_step(h, att_wh, vvec, att_proj, maskf, vals_f, cdt)
        gates = gx[:, t].float() + dot_f32(ctx, w_ctx, cdt)
        gates = gates + dot_f32(h, wh, cdt)
        h, c = gate_update(gates, c)
        h_seq[:, t] = h.to(cdt)
        if with_residuals:
            c_seq[:, t] = c
            a_seq[:, t] = a
    return (h_seq, c_seq, a_seq) if with_residuals else h_seq


def attlstm_recurrence_fwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                           att_vals, with_residuals: bool = False):
    """The forward: CPU tensors take :func:`attlstm_recurrence_ref`,
    CUDA tensors launch the kernel (``attlstm_recurrence.launches``
    counts the launches)."""
    if gx.device.type == "cpu":
        return attlstm_recurrence_ref(gx, wh, w_ctx, att_wh, att_v, att_proj,
                                      att_mask, att_vals,
                                      with_residuals=with_residuals)
    if gx.device.type != "cuda":
        raise ValueError(f"attlstm_recurrence: unsupported device {gx.device}")
    return _launch_fwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                       att_vals, with_residuals)


def _check_recurrence(name, gx, wh, w_ctx, att_wh, att_v, att_proj,
                      att_mask, att_vals):
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
    F, A = check_att_operands(name, wh.dtype, R, E, H, w_ctx, att_wh, att_v,
                              att_proj, att_mask, att_vals, gx.device)
    return R, T, H, E, F, A


def _launch_fwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask, att_vals,
                with_residuals: bool):
    R, T, H, E, F, A = _check_recurrence(
        "attlstm_recurrence", gx, wh, w_ctx, att_wh, att_v, att_proj,
        att_mask, att_vals)
    dev = gx.device
    f32 = dict(dtype=torch.float32, device=dev)
    h_seq = torch.empty((R, T, H), dtype=wh.dtype, device=dev)
    c_seq = torch.empty((R, T, H), **f32) if with_residuals else None
    a_seq = torch.empty((R, T, F), **f32) if with_residuals else None
    if R and T:
        h_a = torch.zeros((R, H), **f32)
        h_b = torch.empty((R, H), **f32)
        c = torch.zeros((R, H), **f32)
        q = torch.empty((R, A), **f32)
        ctx = torch.empty((R, E), **f32)
        ins = [x.contiguous() for x in (gx, wh, w_ctx, att_wh, att_v,
                                        att_proj)]
        mask = att_mask.float().contiguous()
        vals = att_vals.contiguous()
        lib = _bound()
        err = lib.cst_attlstm_recurrence_fwd(
            KERNEL_DTYPES[wh.dtype], 0, *(x.data_ptr() for x in ins),
            mask.data_ptr(), vals.data_ptr(), h_a.data_ptr(), h_b.data_ptr(),
            c.data_ptr(), q.data_ptr(), ctx.data_ptr(), h_seq.data_ptr(),
            c_seq.data_ptr() if with_residuals else None,
            a_seq.data_ptr() if with_residuals else None, None, None,
            R, T, H, E, A, F, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "attlstm_recurrence")
        attlstm_recurrence.launches += 1
    return (h_seq, c_seq, a_seq) if with_residuals else h_seq


# ------------------------------------------------------------ int8w forward

def attlstm_recurrence_quant_ref(gx, wh_q, w_ctx_q, lstm_scale, att_wh_q,
                                 att_scale, att_v, att_proj, att_mask,
                                 att_vals, compute_dtype):
    """Plain version of the int8w forward (any device), step for step
    the reference twin ``attlstm_scan_quant``: ``wh_q`` (H, 4H) and
    ``w_ctx_q`` (E, 4H) int8 sharing ``lstm_scale`` (4H,), ``att_wh_q``
    (H, A) int8 with ``att_scale`` (A,); ``att_v``, ``att_proj`` and
    ``att_vals`` in ``compute_dtype``.  Returns ``h_seq`` (R, T, H) in
    ``compute_dtype``."""
    R, T, _ = gx.shape
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
                             compute_dtype):
    """Fused int8w attention + LSTM forward (serving only: no autograd),
    arguments as :func:`attlstm_recurrence_quant_ref`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel's int8w
    instantiation (``attlstm_recurrence_quant.launches`` counts the
    launches) or raise."""
    args = (gx, wh_q, w_ctx_q, lstm_scale, att_wh_q, att_scale, att_v,
            att_proj, att_mask, att_vals, compute_dtype)
    if gx.device.type == "cpu":
        return attlstm_recurrence_quant_ref(*args)
    if gx.device.type != "cuda":
        raise ValueError(f"attlstm_recurrence_quant: unsupported device "
                         f"{gx.device}")
    name = "attlstm_recurrence_quant"
    cdt = compute_dtype
    if cdt not in KERNEL_DTYPES:
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
    F, A = check_att_operands(name, cdt, R, E, H, w_ctx_q, att_wh_q, att_v,
                              att_proj, att_mask, att_vals, gx.device,
                              wdt=torch.int8)
    scales = []
    for arg, x, n in (("lstm_scale", lstm_scale, G),
                      ("att_scale", att_scale, A)):
        if (x.dtype != torch.float32 or tuple(x.shape) != (n,)
                or x.device != gx.device):
            raise ValueError(f"{name}: {arg} is {x.dtype}{tuple(x.shape)}")
        scales.append(x.contiguous())
    dev = gx.device
    f32 = dict(dtype=torch.float32, device=dev)
    h_seq = torch.empty((R, T, H), dtype=cdt, device=dev)
    if R and T:
        h_a = torch.zeros((R, H), **f32)
        h_b = torch.empty((R, H), **f32)
        c = torch.zeros((R, H), **f32)
        q = torch.empty((R, A), **f32)
        ctx = torch.empty((R, E), **f32)
        ins = [x.contiguous() for x in (gx, wh_q, w_ctx_q, att_wh_q, att_v,
                                        att_proj)]
        mask = att_mask.float().contiguous()
        vals = att_vals.contiguous()
        lib = _bound()
        err = lib.cst_attlstm_recurrence_fwd(
            KERNEL_DTYPES[cdt], 1, *(x.data_ptr() for x in ins),
            mask.data_ptr(), vals.data_ptr(), h_a.data_ptr(), h_b.data_ptr(),
            c.data_ptr(), q.data_ptr(), ctx.data_ptr(), h_seq.data_ptr(),
            None, None, scales[0].data_ptr(), scales[1].data_ptr(),
            R, T, H, E, A, F, torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, name)
        attlstm_recurrence_quant.launches += 1
    return h_seq


# -------------------------------------------------------------- backward

def _bwd_core_ref(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals, h_seq,
                  c_seq, a_seq, dh):
    """The reversed-time loop of ``_bwd_kernel`` (plain).  Returns the
    float32 ``(dgx (R, T, 4H), dq_seq (R, T, A), dproj (R, F, A),
    dvals (R, F, E), dv (A,))``."""
    R, T, G = gx.shape
    H = wh.shape[0]
    F, A = att_proj.shape[1], att_proj.shape[2]
    E = att_vals.shape[-1]
    cdt = wh.dtype
    f32 = dict(dtype=torch.float32, device=gx.device)
    vvec = att_v.float()[:, 0]
    vals_f = att_vals.float()
    h_prev = torch.cat([torch.zeros((R, 1, H), **f32),
                        h_seq[:, :-1].float()], dim=1)
    c_prev = torch.cat([torch.zeros((R, 1, H), **f32), c_seq[:, :-1]], dim=1)
    dgx = torch.empty((R, T, G), **f32)
    dq_seq = torch.empty((R, T, A), **f32)
    dproj = torch.zeros((R, F, A), **f32)
    dvals = torch.zeros((R, F, E), **f32)
    dv = torch.zeros((A,), **f32)
    dh_next = torch.zeros((R, H), **f32)
    dc_next = torch.zeros((R, H), **f32)
    for t in reversed(range(T)):
        hp, cp, a = h_prev[:, t], c_prev[:, t], a_seq[:, t]
        ctx = (a[:, :, None] * vals_f).sum(1)
        q = dot_f32(hp, att_wh, cdt)
        gates = gx[:, t].float() + dot_f32(ctx, w_ctx, cdt)
        gates = gates + dot_f32(hp, wh, cdt)
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H: 2 * H])
        g = torch.tanh(gates[:, 2 * H: 3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        tch = torch.tanh(c_seq[:, t])
        dh_t = dh[:, t].float() + dh_next
        do = dh_t * tch * o * (1.0 - o)
        dc = dc_next + dh_t * o * (1.0 - tch * tch)
        di = dc * g * i * (1.0 - i)
        df = dc * cp * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        dgates = torch.cat([di, df, dg, do], dim=-1)
        dgx[:, t] = dgates
        dctx = dot_f32(dgates, w_ctx.T, cdt)
        dh_gates = dot_f32(dgates, wh.T, cdt)
        da = (dctx[:, None, :] * vals_f).sum(-1)
        dvals += a[:, :, None] * dctx[:, None, :]
        ds = a * (da - (a * da).sum(-1, keepdim=True))
        th = torch.tanh((att_proj + q.to(cdt)[:, None, :]).float())
        dv += (th * ds[:, :, None]).sum((0, 1))
        dpre = ds[:, :, None] * vvec * (1.0 - th * th)
        dproj += dpre
        dq = dpre.sum(1)
        dq_seq[:, t] = dq
        dh_next = dh_gates + dot_f32(dq, att_wh.T, cdt)
        dc_next = dc * f
    return dgx, dq_seq, dproj, dvals, dv


def _finish_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals, h_seq,
                a_seq, core):
    """``_vjp_bwd``'s epilogue: the three weight cotangents as plain
    contractions over the per-step gate and query cotangents, every
    cotangent in its primal's dtype."""
    dgx, dq_seq, dproj, dvals, dv = core
    R, T, H = h_seq.shape
    G, A, E = dgx.shape[-1], dq_seq.shape[-1], att_vals.shape[-1]
    h_prev = torch.cat([torch.zeros((R, 1, H), dtype=torch.float32,
                                    device=gx.device),
                        h_seq[:, :-1].float()], dim=1).reshape(R * T, H)
    ctx_seq = torch.bmm(a_seq, att_vals.float()).reshape(R * T, E)
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
                               att_vals, h_seq, c_seq, a_seq, dh):
    """Plain backward (any device): ``(dgx, dwh, dw_ctx, datt_wh, dv,
    dproj, dvals)`` from the forward's residuals and the cotangent of
    ``h_seq``."""
    core = _bwd_core_ref(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals,
                         h_seq, c_seq, a_seq, dh)
    return _finish_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals,
                       h_seq, a_seq, core)


def attlstm_recurrence_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals,
                           h_seq, c_seq, a_seq, dh):
    """The backward: CPU tensors take :func:`attlstm_recurrence_bwd_ref`,
    CUDA tensors launch the backward kernel for the reversed-time loop
    (``attlstm_recurrence_bwd.launches`` counts the launches) and reduce
    the weight cotangents outside it."""
    if gx.device.type == "cpu":
        return attlstm_recurrence_bwd_ref(gx, wh, w_ctx, att_wh, att_v,
                                          att_proj, att_vals, h_seq, c_seq,
                                          a_seq, dh)
    if gx.device.type != "cuda":
        raise ValueError(f"attlstm_recurrence: unsupported device {gx.device}")
    core = _launch_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals,
                       h_seq, c_seq, a_seq, dh)
    return _finish_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals,
                       h_seq, a_seq, core)


def _launch_bwd(gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals, h_seq,
                c_seq, a_seq, dh):
    R, T, H, E, F, A = _check_recurrence(
        "attlstm_recurrence_bwd", gx, wh, w_ctx, att_wh, att_v, att_proj,
        None, att_vals)
    for arg, x, shape, dt in (("h_seq", h_seq, (R, T, H), wh.dtype),
                              ("c_seq", c_seq, (R, T, H), torch.float32),
                              ("a_seq", a_seq, (R, T, F), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dt or x.device != gx.device:
            raise ValueError(f"attlstm_recurrence_bwd: {arg} is "
                             f"{x.dtype}{tuple(x.shape)}, expected {dt}{shape}")
    if tuple(dh.shape) != (R, T, H):
        raise ValueError(f"attlstm_recurrence_bwd: dh is {tuple(dh.shape)}")
    dev = gx.device
    f32 = dict(dtype=torch.float32, device=dev)
    dgx = torch.empty((R, T, 4 * H), **f32)
    dq_seq = torch.empty((R, T, A), **f32)
    dproj = torch.zeros((R, F, A), **f32)
    dvals = torch.zeros((R, F, E), **f32)
    dv = torch.empty((A,), **f32)
    if R and T:
        dv_part = torch.zeros((R, A), **f32)
        dh_c = torch.zeros((R, H), **f32)
        dc_c = torch.zeros((R, H), **f32)
        q = torch.empty((R, A), **f32)
        ctx = torch.empty((R, E), **f32)
        dctx = torch.empty((R, E), **f32)
        ins = [x.contiguous() for x in (gx, wh, w_ctx, att_wh, att_v,
                                        att_proj, att_vals, h_seq, c_seq,
                                        a_seq)]
        dh32 = dh.float().contiguous()
        lib = _bound()
        err = lib.cst_attlstm_recurrence_bwd(
            KERNEL_DTYPES[wh.dtype], *(x.data_ptr() for x in ins),
            dh32.data_ptr(), dgx.data_ptr(), dq_seq.data_ptr(),
            dproj.data_ptr(), dvals.data_ptr(), dv_part.data_ptr(),
            dv.data_ptr(), dh_c.data_ptr(), dc_c.data_ptr(), q.data_ptr(),
            ctx.data_ptr(), dctx.data_ptr(), R, T, H, E, A, F,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, err, "attlstm_recurrence_bwd")
        attlstm_recurrence_bwd.launches += 1
    else:
        dv.zero_()
    return dgx, dq_seq, dproj, dvals, dv


# ------------------------------------------------------------- autograd

class AttLSTMRecurrence(torch.autograd.Function):
    """The reference's custom VJP: the forward writes the float32 cell
    and softmax residuals, the backward is
    :func:`attlstm_recurrence_bwd`; the mask gets a zero cotangent."""

    @staticmethod
    def forward(ctx, gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                att_vals):
        h_seq, c_seq, a_seq = attlstm_recurrence_fwd(
            gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask, att_vals,
            with_residuals=True)
        ctx.save_for_backward(gx, wh, w_ctx, att_wh, att_v, att_proj,
                              att_mask, att_vals, h_seq, c_seq, a_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dh):
        (gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask, att_vals, h_seq,
         c_seq, a_seq) = ctx.saved_tensors
        dgx, dwh, dw_ctx, datt_wh, dv, dproj, dvals = attlstm_recurrence_bwd(
            gx, wh, w_ctx, att_wh, att_v, att_proj, att_vals, h_seq, c_seq,
            a_seq, dh)
        dmask = (torch.zeros_like(att_mask) if ctx.needs_input_grad[6]
                 else None)
        return dgx, dwh, dw_ctx, datt_wh, dv, dproj, dmask, dvals


def attlstm_recurrence(gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask,
                       att_vals) -> torch.Tensor:
    """Attention + LSTM recurrence over pre-computed input gates, from
    zero state (shapes as :func:`attlstm_recurrence_ref`).  Returns
    ``h_seq`` (R, T, H) in ``wh.dtype``.  When autograd records the call
    goes through :class:`AttLSTMRecurrence`; otherwise the forward
    writes no residuals, as the reference's primal path does."""
    args = (gx, wh, w_ctx, att_wh, att_v, att_proj, att_mask, att_vals)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return AttLSTMRecurrence.apply(*args)
    return attlstm_recurrence_fwd(*args, with_residuals=False)


attlstm_recurrence.launches = 0
attlstm_recurrence_bwd.launches = 0
attlstm_recurrence_quant.launches = 0
_lib: Optional[ctypes.CDLL] = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("attlstm_recurrence")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cst_attlstm_recurrence_fwd.argtypes = ([I, I] + [P] * 18
                                                   + [I] * 6 + [P])
        lib.cst_attlstm_recurrence_fwd.restype = I
        lib.cst_attlstm_recurrence_bwd.argtypes = [I] + [P] * 22 + [I] * 6 + [P]
        lib.cst_attlstm_recurrence_bwd.restype = I
        _lib = lib
    return _lib
