"""Fused sampling decode (greedy argmax or hash-Gumbel multinomial),
meanpool and attention fusion: CUDA kernel wrappers and their plain
PyTorch versions.

Port of the JAX package's ``ops/pallas_sampler.py::lstm_sample`` and
``attlstm_sample`` (TPU kernel ``_make_sample_kernel`` via
``_sample_impl``).  Both kernels are in ``csrc/lstm_sample.cu`` (at
bf16 compute both fusions run the tensor-core chain of
``csrc/decode_tc.cuh`` on weights this wrapper stages once a call: three
launches a step under meanpool, five under attention); its header says
what bounds them on the H100.  :func:`lstm_sample_ref` /
:func:`attlstm_sample_ref` are the plain versions, step for step the
reference twin ``attlstm_sample_scan``: global argmax (first index on a
tie), global log-sum-exp of ``logits * inv_temp``, and the same
murmur3 counter stream, so with the same two seed words it draws the
same tokens as the JAX package.

The stream geometry — the batch tile ``bt`` that mixes the seed word
and the padded vocab width in the counter — is the reference TPU tile
picker's (``decode_common.sampler_pick_tiles``); the CUDA kernel takes
it as parameters, apart from its own 128-column tiling.

Finished rows emit PAD with log-prob 0 and mask 0; EOS (and PAD) feed
back as EOS; the step that samples EOS keeps mask 1.  In greedy mode
``inv_temp`` is 1 whatever ``temperature`` says, as in the reference.

int8w (``quant=(emb_scale, wout_scale, lstm_scale[, att_scale])`` with
``compute_dtype``, the reference's ``quant=`` mode of the same kernels):
the weight operands are int8 codes.  Embedding rows are ``T(code * row
scale)``; each gate operand's float32 product is scaled by the shared
LSTM scale before the sum ``gxs + emb [+ ctx] + h``; the query is
``T((T(h) @ codes) * att_scale)``; the vocab logit is ``(T(h) @ codes)
* column scale + bias`` in float32, not rounded to T.  The stream
geometry is picked on the compute dtype, so the hash-Gumbel counters
are the float kernel's.  The CUDA wrappers count these launches in
``lstm_sample.quant_launches`` / ``attlstm_sample.quant_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.attlstm import attention_step, check_att_operands
from cst_captioning_torch.ops.decode_common import (
    KERNEL_DTYPES,
    KERNEL_TILE_V,
    MASK32,
    check_operands,
    check_quant_scales,
    check_tc_widths,
    decode_bias,
    gumbel_from_counter,
    masked_vocab,
    masked_vocab_q,
    mul32,
    sampler_pick_tiles,
    seed_words,
    split_seed,
    stage_tc_weights,
    unpack_quant,
)
from cst_captioning_torch.ops.quant import dequant_rows
from cst_captioning_torch.ops.rnn import dot_f32, gate_update


def stream_geometry(B: int, E: int, H: int, cdt: torch.dtype, V: int,
                    F: int = 0, A: int = 0):
    """(bt, V_pad) of the reference's multinomial stream; the attention
    operands (F frames, A attention width) count in the reference
    picker's residency, so they change the stream."""
    bt, Vt = sampler_pick_tiles(B, F, A, E, H, cdt.itemsize)
    return bt, -(-V // Vt) * Vt


def _inv_temp(greedy: bool, temperature: float) -> torch.Tensor:
    one = torch.tensor(1.0, dtype=torch.float32)
    if greedy:
        return one
    return one / torch.tensor(float(temperature), dtype=torch.float32)


def _sample_ref(gx_static, w_x, wh, att, emb, w_out, b_out, seed, *,
                max_len: int, greedy: bool, temperature: float,
                suppress_unk: bool, quant=None, compute_dtype=None):
    """The reference twin ``attlstm_sample_scan`` step for step; ``att``
    is ``(w_ctx, att_wh, att_v, att_proj, att_mask, att_vals)`` or None
    for the meanpool variant; ``quant`` the int8w scales (module doc)."""
    B = gx_static.shape[0]
    V = emb.shape[0]
    E = w_x.shape[0]
    H = wh.shape[0]
    cdt, quant = unpack_quant(quant, compute_dtype, wh)
    dev = gx_static.device
    F, A = (0, 0) if att is None else tuple(att[3].shape[1:])
    bt, V_pad = stream_geometry(B, E, H, cdt, V, F, A)
    bias = decode_bias(b_out, V, V, suppress_unk)
    bias_c = bias.to(cdt)
    w_out_c = w_out.to(cdt)
    emb_s, wout_s, ls, att_s = (None,) * 4 if quant is None else (
        x if x is None else x.float() for x in quant)
    rows = torch.arange(B, dtype=torch.long, device=dev)
    sw = seed_words(seed, rows, bt)[:, None]
    inv_temp = _inv_temp(greedy, temperature).to(dev)
    cols = torch.arange(V, dtype=torch.long, device=dev)[None, :]
    gx = gx_static.float()
    if att is not None:
        w_ctx, att_wh, att_v, att_proj, att_mask, att_vals = att
        maskf, vals_f = att_mask.float(), att_vals.float()
        vvec = att_v.float()[:, 0]

    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    fin = torch.zeros((B,), dtype=torch.bool, device=dev)
    tok = torch.full((B,), BOS_ID, dtype=torch.long, device=dev)
    toks, lps, msks = [], [], []
    for t in range(max_len):
        x = emb[tok] if emb_s is None else dequant_rows(emb, emb_s, tok, cdt)
        gates = gx + dot_f32(x, w_x, cdt, ls)
        if att is not None:
            ctx, _ = attention_step(h, att_wh, vvec, att_proj, maskf, vals_f,
                                    cdt, att_s)
            gates = gates + dot_f32(ctx, w_ctx, cdt, ls)
        gates = gates + dot_f32(h, wh, cdt, ls)
        h, c = gate_update(gates, c)
        if quant is None:
            logits = (dot_f32(h, w_out_c, cdt).to(cdt) + bias_c).float()
        else:
            logits = dot_f32(h, w_out_c, cdt, wout_s) + bias
        scaled = logits * inv_temp
        if greedy:
            z = scaled
        else:
            counter = (mul32(rows * max_len + t, V_pad)[:, None] + cols) & MASK32
            z = scaled + gumbel_from_counter(counter, sw)
        nxt = torch.argmax(z, dim=-1)
        lse = torch.logsumexp(scaled, dim=-1)
        tok_lp = scaled.gather(-1, nxt[:, None])[:, 0] - lse
        valid = ~fin
        out_tok = torch.where(valid, nxt, PAD_ID)
        toks.append(out_tok)
        lps.append(torch.where(valid, tok_lp, 0.0))
        msks.append(valid.float())
        fin = fin | (nxt == EOS_ID) | (nxt == PAD_ID)
        tok = torch.where(out_tok == PAD_ID, EOS_ID, out_tok)
    return (torch.stack(toks, 1).to(torch.int32), torch.stack(lps, 1),
            torch.stack(msks, 1))


def lstm_sample_ref(gx_static, w_x, wh, emb, w_out, b_out, seed, *,
                    max_len: int, greedy: bool, temperature: float = 1.0,
                    suppress_unk: bool = False, quant=None,
                    compute_dtype=None):
    """Plain version of :func:`lstm_sample` (any device)."""
    return _sample_ref(gx_static, w_x, wh, None, emb, w_out, b_out, seed,
                       max_len=max_len, greedy=greedy,
                       temperature=temperature, suppress_unk=suppress_unk,
                       quant=quant, compute_dtype=compute_dtype)


def attlstm_sample_ref(gx_static, w_x, wh, w_ctx, att_wh, att_v, att_proj,
                       att_mask, att_vals, emb, w_out, b_out, seed, *,
                       max_len: int, greedy: bool, temperature: float = 1.0,
                       suppress_unk: bool = False, quant=None,
                       compute_dtype=None):
    """Plain version of :func:`attlstm_sample` (any device)."""
    return _sample_ref(gx_static, w_x, wh,
                       (w_ctx, att_wh, att_v, att_proj, att_mask, att_vals),
                       emb, w_out, b_out, seed, max_len=max_len,
                       greedy=greedy, temperature=temperature,
                       suppress_unk=suppress_unk, quant=quant,
                       compute_dtype=compute_dtype)


def lstm_sample(gx_static, w_x, wh, emb, w_out, b_out, seed, *,
                max_len: int, greedy: bool, temperature: float = 1.0,
                suppress_unk: bool = False, quant=None, compute_dtype=None):
    """Fused autoregressive sample from zero state (meanpool fusion).

    Shapes as :func:`~cst_captioning_torch.ops.beam.lstm_beam`; ``seed``
    is an int or two 32-bit words (a tensor or a pair) — the hash
    stream's key.  Returns ``(tokens int32, logprobs f32, mask f32)``,
    each (B, max_len).  ``quant=(emb_scale, wout_scale, lstm_scale)``
    with int8 weight codes and ``compute_dtype``: the int8w mode.  At
    bf16 compute on the card E and H must be multiples of 32
    (``TensorCoreShapeError``).

    CPU tensors take :func:`lstm_sample_ref`; CUDA tensors launch the
    kernel (``lstm_sample.launches`` counts the float launches,
    ``lstm_sample.quant_launches`` the int8w ones)."""
    if gx_static.device.type == "cpu":
        return lstm_sample_ref(gx_static, w_x, wh, emb, w_out, b_out, seed,
                               max_len=max_len, greedy=greedy,
                               temperature=temperature,
                               suppress_unk=suppress_unk, quant=quant,
                               compute_dtype=compute_dtype)
    out = _launch("lstm_sample", gx_static, w_x, wh, None, emb, w_out, b_out,
                  seed, max_len, greedy, temperature, suppress_unk, quant,
                  compute_dtype)
    if quant is None:
        lstm_sample.launches += 1
    else:
        lstm_sample.quant_launches += 1
    return out


def attlstm_sample(gx_static, w_x, wh, w_ctx, att_wh, att_v, att_proj,
                   att_mask, att_vals, emb, w_out, b_out, seed, *,
                   max_len: int, greedy: bool, temperature: float = 1.0,
                   suppress_unk: bool = False, quant=None,
                   compute_dtype=None):
    """Fused autoregressive sample from zero state (attention fusion).

    Shapes as :func:`lstm_sample` (``gx_static`` is the lstm bias
    alone), plus the attention operands of
    :func:`~cst_captioning_torch.ops.beam.attlstm_beam`.  The hash
    stream's geometry includes F and A, as the reference's does.
    ``quant=(emb_scale, wout_scale, lstm_scale, att_scale)`` with int8
    codes for every weight (``w_ctx`` and ``att_wh`` too) and
    ``compute_dtype``: the int8w mode.  At bf16 compute on the card E,
    H and A must be multiples of 32 (``TensorCoreShapeError``).

    CPU tensors take :func:`attlstm_sample_ref`; CUDA tensors launch the
    kernel (``attlstm_sample.launches`` counts the float launches,
    ``attlstm_sample.quant_launches`` the int8w ones)."""
    att = (w_ctx, att_wh, att_v, att_proj, att_mask, att_vals)
    if gx_static.device.type == "cpu":
        return attlstm_sample_ref(gx_static, w_x, wh, *att, emb, w_out, b_out,
                                  seed, max_len=max_len, greedy=greedy,
                                  temperature=temperature,
                                  suppress_unk=suppress_unk, quant=quant,
                                  compute_dtype=compute_dtype)
    out = _launch("attlstm_sample", gx_static, w_x, wh, att, emb, w_out,
                  b_out, seed, max_len, greedy, temperature, suppress_unk,
                  quant, compute_dtype)
    if quant is None:
        attlstm_sample.launches += 1
    else:
        attlstm_sample.quant_launches += 1
    return out


def _launch(name, gx_static, w_x, wh, att, emb, w_out, b_out, seed, max_len,
            greedy, temperature, suppress_unk, quant, compute_dtype):
    T = int(max_len)
    cdt, quant = unpack_quant(quant, compute_dtype, wh)
    B, V, E, H, cdt = check_operands(name, gx_static, w_x, wh, emb,
                                     w_out, b_out,
                                     None if quant is None else cdt)
    if V <= 4:
        raise ValueError(f"{name}: vocab {V} has no real words")
    dev = gx_static.device
    if att is not None:
        F, A = check_att_operands(name, cdt, B, E, H, *att, dev,
                                  wdt=None if quant is None else torch.int8)
    else:
        F = A = 0
    # bf16 decodes on the tensor-core chain, or not at all.
    tc = cdt == torch.bfloat16
    if tc:
        check_tc_widths(name, E, H, None if att is None else A)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    bt, v_pad_stream = stream_geometry(B, E, H, cdt, V, F, A)
    s0, s1 = split_seed(seed)
    inv_temp = float(_inv_temp(greedy, temperature))
    Vp = -(-V // KERNEL_TILE_V) * KERNEL_TILE_V
    if quant is None:
        bias, w_out_p = masked_vocab(b_out, w_out, V, Vp, suppress_unk, cdt)
        scales = [None] * 4
    else:
        emb_s, wout_s, ls, att_s = check_quant_scales(name, quant, V, H, A,
                                                      dev)
        bias, w_out_p, ws_p = masked_vocab_q(b_out, w_out, wout_s, V, Vp,
                                             suppress_unk)
        scales = [emb_s, ls, att_s, ws_p]
    nT = Vp // KERNEL_TILE_V
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    gx = gx_static.float().contiguous()
    # The tensor-core chain keeps h in bf16: every reader rounds it so.
    hdt = dict(dtype=torch.bfloat16 if tc else torch.float32, device=dev)
    h_a = torch.zeros((B, H), **hdt)
    h_b = torch.empty((B, H), **hdt)
    c = torch.zeros((B, H), **f32)
    fin = torch.zeros((B,), **f32)
    tok = torch.full((B,), BOS_ID, **i32)
    out_tok = torch.empty((B, T), **i32)
    out_lp = torch.empty((B, T), **f32)
    out_mask = torch.empty((B, T), **f32)
    parts = [torch.empty((B, nT), **f32), torch.empty((B, nT), **f32),
             torch.empty((B, nT), **f32), torch.empty((B, nT), **i32),
             torch.empty((B, nT), **f32)]
    state = [fin, tok, out_tok, out_lp, out_mask, *parts]
    stream_args = [B, T, E, H, Vp, bt, v_pad_stream, s0, s1, inv_temp,
                   int(bool(greedy))]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _bound()
    sp = [None if x is None else x.data_ptr() for x in scales]
    if tc and att is None:
        table, wcat_t, _, w_out_t = stage_tc_weights(
            w_x, None, wh, None, emb, w_out_p, scales[0])
        err = lib.cst_lstm_sample_tc(
            *(x.data_ptr() for x in (gx, table, wcat_t, w_out_t, bias)),
            sp[1], sp[3], *(x.data_ptr() for x in (h_a, h_b, c, *state)),
            *stream_args, stream)
        _build.check(lib, err, name)
        return out_tok, out_lp, out_mask
    if tc:
        w_ctx, att_wh, att_v, att_proj, att_mask, att_vals = att
        staged = stage_tc_weights(w_x, w_ctx, wh, att_wh, emb, w_out_p,
                                  scales[0])
        q = torch.empty((B, A), **hdt)
        ctx = torch.empty((B, E), **hdt)
        ops = [att_v.contiguous(), att_proj.contiguous(),
               att_mask.float().contiguous(), att_vals.contiguous(), h_a,
               h_b, c, q, ctx, *state]
        err = lib.cst_attlstm_sample_tc(
            *(x.data_ptr() for x in (gx, *staged, bias)), *sp[1:],
            *(x.data_ptr() for x in ops), B, T, E, H, A, F,
            *stream_args[4:], stream)
        _build.check(lib, err, name)
        return out_tok, out_lp, out_mask
    ins = [t.contiguous() for t in (w_x, wh, emb, w_out_p)]
    common = [
        ins[0].data_ptr(), ins[1].data_ptr(), ins[2].data_ptr(),
        ins[3].data_ptr(), bias.data_ptr(),
        h_a.data_ptr(), h_b.data_ptr(), c.data_ptr(),
        *(x.data_ptr() for x in state), *stream_args,
    ]
    wq = int(quant is not None)
    if att is None:
        err = lib.cst_lstm_sample(KERNEL_DTYPES[cdt], wq, gx.data_ptr(),
                                  *common, sp[0], sp[1], sp[3], stream)
    else:
        w_ctx, att_wh, att_v, att_proj, att_mask, att_vals = att
        att_in = [x.contiguous() for x in (w_ctx, att_wh, att_v, att_proj)]
        mask = att_mask.float().contiguous()
        vals = att_vals.contiguous()
        q = torch.empty((B, A), **f32)
        ctx = torch.empty((B, E), **f32)
        err = lib.cst_attlstm_sample(
            KERNEL_DTYPES[cdt], wq, gx.data_ptr(), *common,
            *(x.data_ptr() for x in att_in), mask.data_ptr(),
            vals.data_ptr(), q.data_ptr(), ctx.data_ptr(), A, F, *sp, stream)
    _build.check(lib, err, name)
    return out_tok, out_lp, out_mask


lstm_sample.launches = 0
lstm_sample.quant_launches = 0
attlstm_sample.launches = 0
attlstm_sample.quant_launches = 0
_lib = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lstm_sample")
        P, I = ctypes.c_void_p, ctypes.c_int
        U, F = ctypes.c_uint, ctypes.c_float
        head = [I, I] + [P] * 19 + [I] * 7 + [U, U, F, I]
        lib.cst_lstm_sample.argtypes = head + [P] * 4
        lib.cst_lstm_sample.restype = I
        lib.cst_attlstm_sample.argtypes = (head + [P] * 8 + [I] * 2
                                           + [P] * 5)
        lib.cst_attlstm_sample.restype = I
        lib.cst_lstm_sample_tc.argtypes = [P] * 20 + [I] * 7 + [U, U, F, I,
                                                                 P]
        lib.cst_lstm_sample_tc.restype = I
        lib.cst_attlstm_sample_tc.argtypes = ([P] * 28 + [I] * 9 + [U, U, F, I]
                                              + [P])
        lib.cst_attlstm_sample_tc.restype = I
        _lib = lib
    return _lib
