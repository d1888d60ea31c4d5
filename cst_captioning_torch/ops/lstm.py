"""Teacher-forced LSTM recurrence: CUDA kernel wrapper, its plain
PyTorch version and the analytic backward.

Port of the JAX package's ``ops/pallas_lstm.py``: the forward of
``lstm_recurrence`` (TPU kernel ``lstm_recurrence_pallas``, kernel
``_make_kernel``) and its custom VJP.  The kernel is
``csrc/lstm_recurrence.cu``; its header says what bounds it on the H100
and how its design differs from the TPU kernel.  The wrapper picks the
kernel's path by compute dtype: bfloat16 runs one persistent launch
(thread-block clusters of ``H / 32`` CTAs, so ``H`` must be a multiple of
32 and at most 512, else it raises); float32 runs the per-step kernel,
one launch per step, on any ``H``.  Both sum each product in the plain
version's order, one ascending-k float32 FMA chain per output.

Numerics follow the TPU kernel (not its scan twin, which rounds
``h @ W_h`` to the compute dtype in bf16): per step ``gates = gx_t +
T(h) @ W_h`` with compute-dtype operands, float32 accumulation and one
float32 add, the i|f|g|o update with float32 h and c, ``h_seq`` emitted
in ``wh.dtype``.  The recurrence starts from zero state.

int8w serving adds :func:`lstm_recurrence_quant` (the reference's
``lstm_recurrence_quant``, TPU kernel ``_make_kernel(quant=True)`` via
``lstm_recurrence_pallas``): ``W_h`` int8 codes with a (4H,) float32
column scale applied once to the float32 product, ``gates = gx_t + (T(h)
@ codes) * scale``.  Forward only, no cell output, ``h_seq`` in the
compute dtype; its plain version is the twin
``lstm_recurrence_scan_quant``.

The backward is plain PyTorch on every device, as the reference's is
XLA (``lstm_recurrence_bwd_scan``), not a kernel: a reverse loop over
the saved ``(h_seq, c_seq)`` residuals that recomputes the gates with
one product per step, and ``dW_h`` as one contraction.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.decode_common import KERNEL_DTYPES
from cst_captioning_torch.ops.rnn import gate_update


def lstm_recurrence_ref(gx: torch.Tensor, wh: torch.Tensor,
                        with_cell: bool = False):
    """Plain version of the kernel (any device): ``gx`` (R, T, 4H)
    float32, ``wh`` (H, 4H) in the compute dtype.  Returns ``h_seq``
    (R, T, H) in ``wh.dtype``, plus the float32 ``c_seq`` with
    ``with_cell``."""
    R, T, _ = gx.shape
    H = wh.shape[0]
    cdt = wh.dtype
    whf = wh.float()
    h = torch.zeros((R, H), dtype=torch.float32, device=gx.device)
    c = torch.zeros_like(h)
    h_seq = torch.empty((R, T, H), dtype=cdt, device=gx.device)
    c_seq = (torch.empty((R, T, H), dtype=torch.float32, device=gx.device)
             if with_cell else None)
    for t in range(T):
        gates = gx[:, t].float() + h.to(cdt).float() @ whf
        h, c = gate_update(gates, c)
        h_seq[:, t] = h.to(cdt)
        if with_cell:
            c_seq[:, t] = c
    return (h_seq, c_seq) if with_cell else h_seq


def lstm_recurrence_bwd(gx, wh, h_seq, c_seq, dh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Analytic reverse pass over the saved residuals (reference
    ``lstm_recurrence_bwd_scan``, step for step): gates recomputed from
    the stored compute-dtype ``h_seq`` in float32, ``dW_h = sum_t
    h_{t-1}^T dgates_t`` in float32 and then rounded to ``wh.dtype``.
    Returns ``(dgx, dwh)``."""
    R, T, G = gx.shape
    H = wh.shape[0]
    f32 = dict(dtype=torch.float32, device=gx.device)
    whf = wh.float()
    h_prev = torch.cat([torch.zeros((R, 1, H), **f32),
                        h_seq[:, :-1].float()], dim=1)
    c_prev = torch.cat([torch.zeros((R, 1, H), **f32), c_seq[:, :-1]], dim=1)
    dgates = torch.empty((R, T, G), **f32)
    dh_next = torch.zeros((R, H), **f32)
    dc_next = torch.zeros((R, H), **f32)
    for t in reversed(range(T)):
        gates = gx[:, t].float() + h_prev[:, t] @ whf
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H: 2 * H])
        g = torch.tanh(gates[:, 2 * H: 3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        tc = torch.tanh(c_seq[:, t])
        dh_t = dh[:, t].float() + dh_next
        do = dh_t * tc * o * (1 - o)
        dc = dc_next + dh_t * o * (1 - tc * tc)
        di = dc * g * i * (1 - i)
        df = dc * c_prev[:, t] * f * (1 - f)
        dg = dc * i * (1 - g * g)
        dgt = torch.cat([di, df, dg, do], dim=-1)
        dgates[:, t] = dgt
        dh_next = dgt @ whf.T
        dc_next = dc * f
    dwh = h_prev.reshape(R * T, H).T @ dgates.reshape(R * T, G)
    return dgates.to(gx.dtype), dwh.to(wh.dtype)


def lstm_recurrence_fwd(gx: torch.Tensor, wh: torch.Tensor,
                        with_cell: bool = False):
    """The recurrence forward: CPU tensors take
    :func:`lstm_recurrence_ref`, CUDA tensors launch the kernel
    (``lstm_recurrence.launches`` counts the launches)."""
    if gx.device.type == "cpu":
        return lstm_recurrence_ref(gx, wh, with_cell)
    if gx.device.type != "cuda":
        raise ValueError(f"lstm_recurrence: unsupported device {gx.device}")
    return _launch(gx, wh, with_cell)


# The bfloat16 kernel: each CTA of a cluster owns CLUSTER_UNITS hidden
# units with their four gates, and a cluster holds at most 16 CTAs.
CLUSTER_UNITS = 32
CLUSTER_MAX_H = 16 * CLUSTER_UNITS


def check_bf16_width(H: int, what: str) -> None:
    """Raise unless the bfloat16 kernel takes hidden width ``H``."""
    if H % CLUSTER_UNITS or not 0 < H <= CLUSTER_MAX_H:
        raise ValueError(f"{what}: the bfloat16 kernel needs H a multiple "
                         f"of {CLUSTER_UNITS} and at most {CLUSTER_MAX_H}, "
                         f"got H={H}")


def bf16_launch_plan(R: int, H: int) -> Tuple[int, ...]:
    """The bfloat16 kernel's launch on the current card for ``R`` rows of
    width ``H``: (clusters, CTAs per cluster, rows per cluster)."""
    check_bf16_width(H, "lstm_recurrence")
    lib = _bound()
    out = (ctypes.c_int * 3)()
    _build.check(lib, lib.cst_lstm_recurrence_plan(R, H, out),
                 "lstm_recurrence launch plan")
    return tuple(out)


def _run(what: str, cdt: torch.dtype, quant: bool, gx, w, w_scale, h_seq,
         c_seq) -> None:
    """One kernel call on the card: the scratch its path needs, then the
    launch (``cdt`` picks the path, see the module docstring)."""
    R, T, _ = gx.shape
    H = w.shape[0]
    dev = gx.device
    f32 = dict(dtype=torch.float32, device=dev)
    if cdt == torch.bfloat16:
        check_bf16_width(H, what)
        h_a = h_b = None
        c = torch.empty((R, H), **f32)
    else:
        h_a, h_b = torch.zeros((R, H), **f32), torch.empty((R, H), **f32)
        c = torch.zeros((R, H), **f32)
    gx_c = gx.contiguous()
    if gx_c.data_ptr() % 16:
        gx_c = gx_c.clone()
    w_c = w.contiguous()
    ws_c = w_scale.contiguous() if quant else None
    lib = _bound()
    err = lib.cst_lstm_recurrence(
        KERNEL_DTYPES[cdt], int(quant), gx_c.data_ptr(), w_c.data_ptr(),
        ws_c.data_ptr() if quant else None,
        None if h_a is None else h_a.data_ptr(),
        None if h_b is None else h_b.data_ptr(), c.data_ptr(),
        h_seq.data_ptr(), None if c_seq is None else c_seq.data_ptr(),
        R, T, H, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, what)


def _launch(gx, wh, with_cell: bool):
    if gx.dim() != 3 or wh.dim() != 2:
        raise ValueError("lstm_recurrence: gx must be (R, T, 4H), wh (H, 4H)")
    R, T, G = gx.shape
    H = wh.shape[0]
    if G != 4 * H or wh.shape[1] != G:
        raise ValueError(f"lstm_recurrence: gx {tuple(gx.shape)} does not "
                         f"match wh {tuple(wh.shape)}")
    if gx.dtype != torch.float32:
        raise ValueError(f"lstm_recurrence: gx must be float32, got {gx.dtype}")
    if wh.dtype not in KERNEL_DTYPES:
        raise ValueError(f"lstm_recurrence: unsupported dtype {wh.dtype}")
    if wh.device != gx.device:
        raise ValueError("lstm_recurrence: gx and wh on different devices")
    dev = gx.device
    h_seq = torch.empty((R, T, H), dtype=wh.dtype, device=dev)
    c_seq = (torch.empty((R, T, H), dtype=torch.float32, device=dev)
             if with_cell else None)
    if R == 0 or T == 0:
        return (h_seq, c_seq) if with_cell else h_seq
    _run("lstm_recurrence", wh.dtype, False, gx, wh, None, h_seq, c_seq)
    lstm_recurrence.launches += 1
    return (h_seq, c_seq) if with_cell else h_seq


def lstm_recurrence_quant_ref(gx: torch.Tensor, wh_q: torch.Tensor,
                              wh_scale: torch.Tensor,
                              compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the int8w recurrence (any device), step for step
    the reference twin ``lstm_recurrence_scan_quant``: the float32 (h, c)
    carry, ``gates = gx_t + (T(h) @ T(codes)) * scale``, only the emitted
    ``h_seq`` rounded to ``compute_dtype``."""
    R, T, _ = gx.shape
    H = wh_q.shape[0]
    cdt = compute_dtype
    whf = wh_q.to(cdt).float()
    ws = wh_scale.float()
    h = torch.zeros((R, H), dtype=torch.float32, device=gx.device)
    c = torch.zeros_like(h)
    h_seq = torch.empty((R, T, H), dtype=cdt, device=gx.device)
    for t in range(T):
        gates = gx[:, t].float() + (h.to(cdt).float() @ whf) * ws
        h, c = gate_update(gates, c)
        h_seq[:, t] = h.to(cdt)
    return h_seq


def lstm_recurrence_quant(gx: torch.Tensor, wh_q: torch.Tensor,
                          wh_scale: torch.Tensor,
                          compute_dtype: torch.dtype) -> torch.Tensor:
    """Forward-only int8w recurrence from zero state: ``gx`` (R, T, 4H)
    float32, ``wh_q`` (H, 4H) int8 codes, ``wh_scale`` (4H,) float32.
    Returns ``h_seq`` (R, T, H) in ``compute_dtype``, with no cell output
    and no autograd (quantized weights serve, they never train).  CPU
    tensors take :func:`lstm_recurrence_quant_ref`; CUDA tensors launch
    the kernel's int8w instantiation (``lstm_recurrence_quant.launches``
    counts the launches) or raise."""
    if gx.device.type == "cpu":
        return lstm_recurrence_quant_ref(gx, wh_q, wh_scale, compute_dtype)
    if gx.device.type != "cuda":
        raise ValueError(f"lstm_recurrence_quant: unsupported device "
                         f"{gx.device}")
    if gx.dim() != 3 or gx.dtype != torch.float32:
        raise ValueError("lstm_recurrence_quant: gx must be float32 (R, T, 4H)")
    R, T, G = gx.shape
    H = wh_q.shape[0]
    if (tuple(wh_q.shape) != (H, G) or G != 4 * H or wh_q.dtype != torch.int8
            or tuple(wh_scale.shape) != (G,)
            or wh_scale.dtype != torch.float32):
        raise ValueError(
            f"lstm_recurrence_quant: wh {wh_q.dtype}{tuple(wh_q.shape)} and "
            f"scale {wh_scale.dtype}{tuple(wh_scale.shape)} do not match gx "
            f"{tuple(gx.shape)}")
    if compute_dtype not in KERNEL_DTYPES:
        raise ValueError(f"lstm_recurrence_quant: unsupported compute dtype "
                         f"{compute_dtype}")
    if wh_q.device != gx.device or wh_scale.device != gx.device:
        raise ValueError("lstm_recurrence_quant: operands on different devices")
    dev = gx.device
    h_seq = torch.empty((R, T, H), dtype=compute_dtype, device=dev)
    if R == 0 or T == 0:
        return h_seq
    _run("lstm_recurrence_quant", compute_dtype, True, gx, wh_q, wh_scale,
         h_seq, None)
    lstm_recurrence_quant.launches += 1
    return h_seq


class LSTMRecurrence(torch.autograd.Function):
    """The reference's custom VJP: the forward writes the float32 cell
    residual, the backward is :func:`lstm_recurrence_bwd`."""

    @staticmethod
    def forward(ctx, gx, wh):
        h_seq, c_seq = lstm_recurrence_fwd(gx, wh, with_cell=True)
        ctx.save_for_backward(gx, wh, h_seq, c_seq)
        return h_seq

    @staticmethod
    def backward(ctx, dh):
        gx, wh, h_seq, c_seq = ctx.saved_tensors
        return lstm_recurrence_bwd(gx, wh, h_seq, c_seq, dh)


def lstm_recurrence(gx: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """Recurrent LSTM over pre-computed input gates, from zero state.

    ``gx`` (R, T, 4H) float32 = x @ W_x + b; ``wh`` (H, 4H) in the
    compute dtype.  Returns ``h_seq`` (R, T, H) in ``wh.dtype``.  When
    autograd records (grad mode on and an input requires grad) the call
    goes through :class:`LSTMRecurrence`; otherwise the forward writes no
    cell output, as the reference's primal path does."""
    if torch.is_grad_enabled() and (gx.requires_grad or wh.requires_grad):
        return LSTMRecurrence.apply(gx, wh)
    return lstm_recurrence_fwd(gx, wh, with_cell=False)


lstm_recurrence.launches = 0
lstm_recurrence_quant.launches = 0
_lib: Optional[ctypes.CDLL] = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lstm_recurrence")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cst_lstm_recurrence.argtypes = [I, I] + [P] * 8 + [I] * 3 + [P]
        lib.cst_lstm_recurrence.restype = I
        lib.cst_lstm_recurrence_plan.argtypes = [I, I, ctypes.POINTER(I)]
        lib.cst_lstm_recurrence_plan.restype = I
        _lib = lib
    return _lib
