"""Fused beam-search decode, meanpool and attention fusion: CUDA kernel
wrappers and their plain PyTorch versions.

Port of the JAX package's ``ops/pallas_beam.py::lstm_beam`` and
``attlstm_beam`` (TPU kernel ``_make_beam_kernel`` via ``_beam_impl``,
``static_ctx`` True and False).  Both kernels are in
``csrc/lstm_beam.cu`` (at bf16 compute both fusions run the tensor-core
chain of ``csrc/decode_tc.cuh`` on weights this wrapper stages once a
call, ``decode_common.stage_tc_weights``: three launches a step under
meanpool, five under attention; at float16 compute both fusions run the
chain's float16 instantiation); its header says what bounds them on
the H100 and how the design differs from the TPU kernel.
:func:`lstm_beam_ref` / :func:`attlstm_beam_ref` are the plain versions:
the reference's pure-XLA twin ``attlstm_beam_scan`` step for step
(decomposed gate GEMMs, vocab-tile-chunked online log-sum-exp with the
TPU picker's tile width for the real F and A, per-tile top-K merge, K·K
union select, parent gather), so the CPU tests hold them token-exact
against the JAX package.

Numerics (both versions): ``gates = ((gx_static + emb @ W_x) [+ ctx @
W_ctx]) + h @ W_h`` with compute-dtype operands and float32
accumulation, the attention context as ``ops/attlstm.py`` states it;
``h``/``c`` stay float32; logits are ``T(T(h @ W_out) + T(bias))`` then
float32, with PAD/BOS (and UNK under ``suppress_unk``) folded into the
bias as -1e30.

int8w (``quant=(emb_scale, wout_scale, lstm_scale[, att_scale])`` with
``compute_dtype``, the reference's ``quant=`` mode): int8 weight codes,
embedding rows ``T(code * row scale)``, each gate product scaled by the
shared LSTM scale before the sum, the query ``T((T(h) @ codes) *
att_scale)``, and logits ``(T(h) @ codes) * column scale + bias`` in
float32 with no rounding to T; the tile picker runs on the compute
dtype's itemsize, so the log-sum-exp chunks are the float path's.  The
CUDA wrappers count these launches in ``lstm_beam.quant_launches`` /
``attlstm_beam.quant_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.attlstm import attention_step, check_att_operands
from cst_captioning_torch.ops.decode_common import (
    F32_MIN,
    KERNEL_DTYPES,
    KERNEL_TILE_V,
    TC_DTYPES,
    NEG_INF,
    beam_pick_tiles,
    candidate_totals,
    check_operands,
    check_quant_scales,
    check_tc_widths,
    masked_vocab,
    masked_vocab_q,
    merge_topk,
    row_topk,
    select_beams,
    stage_tc_weights,
    unpack_quant,
)
from cst_captioning_torch.ops.quant import dequant_rows
from cst_captioning_torch.ops.rnn import dot_f32, gate_update

# The CUDA kernel's largest beam (lstm_beam.cu MAXK).
KERNEL_MAX_BEAM = 16


def beam_shapes_ok(B: int, K: int, V: int) -> bool:
    """The union argument needs >= K live candidates per row: the vocab
    must exceed K plus the masked specials (reference
    ``beam_shapes_ok``'s structural part)."""
    return K >= 1 and B >= 1 and V >= K + 4


def _beam_ref(gx_static, w_x, wh, att, emb, w_out, b_out, *,
              beam_size: int, max_len: int, suppress_unk: bool, quant=None,
              compute_dtype=None):
    """The reference twin ``attlstm_beam_scan`` step for step; ``att`` is
    ``(w_ctx, att_wh, att_v, att_proj, att_mask, att_vals)`` (per-video
    tensors) or None for the meanpool variant; ``quant`` the int8w
    scales (module doc)."""
    K = beam_size
    B = gx_static.shape[0]
    V = emb.shape[0]
    E = w_x.shape[0]
    H = wh.shape[0]
    T = max_len
    cdt, quant = unpack_quant(quant, compute_dtype, wh)
    dev = gx_static.device
    F, A = (0, 0) if att is None else tuple(att[3].shape[1:])
    _, Vt = beam_pick_tiles(B, K, F, A, E, H, T, cdt.itemsize)
    V_pad = -(-V // Vt) * Vt
    if quant is None:
        emb_s = ls = att_s = None
        bias, w_out_p = masked_vocab(b_out, w_out, V, V_pad, suppress_unk,
                                     cdt)
    else:
        emb_s, wout_s, ls, att_s = (x if x is None else x.float()
                                    for x in quant)
        bias, w_out_p, ws_p = masked_vocab_q(b_out, w_out, wout_s, V, V_pad,
                                             suppress_unk)
    bias_c = bias.to(cdt)
    gx_r = gx_static.float().repeat_interleave(K, dim=0)
    R = B * K
    if att is not None:
        w_ctx, att_wh, att_v, att_proj, att_mask, att_vals = att
        rep = lambda x: x.repeat_interleave(K, dim=0)  # noqa: E731
        proj_r, mask_r = rep(att_proj), rep(att_mask.float())
        vals_r, vvec = rep(att_vals).float(), att_v.float()[:, 0]
    cols = torch.arange(Vt, device=dev)[None, :].expand(R, Vt)

    h = torch.zeros((R, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    fin = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    beam = (torch.arange(R, device=dev) % K)[:, None]
    score = torch.where(beam == 0, 0.0, NEG_INF).to(torch.float32)
    seqs = torch.full((B, K, T), PAD_ID, dtype=torch.long, device=dev)
    tok = torch.full((R,), BOS_ID, dtype=torch.long, device=dev)
    bix = torch.arange(B, device=dev)[:, None]
    for t in range(T):
        x = emb[tok] if emb_s is None else dequant_rows(emb, emb_s, tok, cdt)
        gates = gx_r + dot_f32(x, w_x, cdt, ls)
        if att is not None:
            ctx, _ = attention_step(h, att_wh, vvec, proj_r, mask_r, vals_r,
                                    cdt, att_s)
            gates = gates + dot_f32(ctx, w_ctx, cdt, ls)
        gates = gates + dot_f32(h, wh, cdt, ls)
        h_new, c_new = gate_update(gates, c)
        if quant is None:
            logits = (dot_f32(h_new, w_out_p, cdt).to(cdt) + bias_c).float()
        else:
            logits = dot_f32(h_new, w_out_p, cdt, ws_p) + bias
        m = torch.full((R, 1), NEG_INF, dtype=torch.float32, device=dev)
        ssum = torch.zeros((R, 1), dtype=torch.float32, device=dev)
        top_v = torch.full((R, K), F32_MIN, dtype=torch.float32, device=dev)
        top_i = torch.arange(K, device=dev)[None, :].expand(R, K) + V_pad
        for k in range(V_pad // Vt):
            tile = logits[:, k * Vt: (k + 1) * Vt]
            mk = torch.maximum(m, tile.max(dim=-1, keepdim=True).values)
            ssum = ssum * torch.exp(m - mk) + torch.exp(tile - mk).sum(
                dim=-1, keepdim=True)
            m = mk
            tv, ti = row_topk(tile, cols + k * Vt, K)
            top_v, top_i = merge_topk(top_v, top_i, tv, ti, K)
        totals, keys = candidate_totals(top_v, top_i, m, ssum, score, fin,
                                        K, V)
        sc, parent, tok_sel = select_beams(
            totals.reshape(B, K * K), keys.reshape(B, K * K), K, V)
        seqs = seqs[bix, parent]
        seqs[:, :, t] = tok_sel
        ended = (tok_sel == EOS_ID) | (tok_sel == PAD_ID)
        fin = torch.maximum(fin.reshape(B, K)[bix, parent],
                            ended.float()).reshape(R, 1)
        flat_parent = (bix * K + parent).reshape(-1)
        h = h_new[flat_parent]
        c = c_new[flat_parent]
        tok = torch.where(tok_sel == PAD_ID, EOS_ID, tok_sel).reshape(-1)
        score = sc.reshape(R, 1)
    return seqs.to(torch.int32), score.reshape(B, K)


def lstm_beam_ref(gx_static, w_x, wh, emb, w_out, b_out, *,
                  beam_size: int, max_len: int, suppress_unk: bool = False,
                  quant=None, compute_dtype=None):
    """Plain version of :func:`lstm_beam` (any device)."""
    return _beam_ref(gx_static, w_x, wh, None, emb, w_out, b_out,
                     beam_size=beam_size, max_len=max_len,
                     suppress_unk=suppress_unk, quant=quant,
                     compute_dtype=compute_dtype)


def attlstm_beam_ref(gx_static, w_x, wh, w_ctx, att_wh, att_v, att_proj,
                     att_mask, att_vals, emb, w_out, b_out, *,
                     beam_size: int, max_len: int, suppress_unk: bool = False,
                     quant=None, compute_dtype=None):
    """Plain version of :func:`attlstm_beam` (any device)."""
    return _beam_ref(gx_static, w_x, wh,
                     (w_ctx, att_wh, att_v, att_proj, att_mask, att_vals),
                     emb, w_out, b_out, beam_size=beam_size, max_len=max_len,
                     suppress_unk=suppress_unk, quant=quant,
                     compute_dtype=compute_dtype)


def lstm_beam(gx_static, w_x, wh, emb, w_out, b_out, *,
              beam_size: int, max_len: int, suppress_unk: bool = False,
              quant=None, compute_dtype=None):
    """Fused beam search from zero state (meanpool fusion).

    Shapes: gx_static (B, 4H) f32 = lstm bias + static context gate
    contribution; w_x (E, 4H), wh (H, 4H), emb (V, E), w_out (H, V) in
    the compute dtype (float32, bfloat16 or float16); b_out (V,) f32.  Returns
    ``(seqs (B, K, max_len) int32, scores (B, K) float32)``, the raw
    beam state for ``decoding.beam.finalize_beams``.
    ``quant=(emb_scale, wout_scale, lstm_scale)`` with int8 weight codes
    and ``compute_dtype``: the int8w mode.  At 16-bit compute on the card
    E and H must be multiples of 32 (``TensorCoreShapeError``).

    CPU tensors take :func:`lstm_beam_ref`; CUDA tensors launch the
    kernel (``lstm_beam.launches`` counts the float launches,
    ``lstm_beam.quant_launches`` the int8w ones)."""
    if gx_static.device.type == "cpu":
        return lstm_beam_ref(gx_static, w_x, wh, emb, w_out, b_out,
                             beam_size=beam_size, max_len=max_len,
                             suppress_unk=suppress_unk, quant=quant,
                             compute_dtype=compute_dtype)
    out = _launch("lstm_beam", gx_static, w_x, wh, None, emb, w_out, b_out,
                  beam_size, max_len, suppress_unk, quant, compute_dtype)
    if quant is None:
        _build.count_launch(lstm_beam)
    else:
        _build.count_launch(lstm_beam, "quant_launches")
    return out


def attlstm_beam(gx_static, w_x, wh, w_ctx, att_wh, att_v, att_proj,
                 att_mask, att_vals, emb, w_out, b_out, *,
                 beam_size: int, max_len: int, suppress_unk: bool = False,
                 quant=None, compute_dtype=None):
    """Fused beam search from zero state (attention fusion).

    Shapes as :func:`lstm_beam` (``gx_static`` is the lstm bias alone),
    plus w_ctx (E, 4H), att_wh (H, A), att_v (A, 1), att_proj (B, F, A),
    att_vals (B, F, E) in the compute dtype and att_mask (B, F), all per
    VIDEO: the kernel serves a video's K beams from one copy.
    ``quant=(emb_scale, wout_scale, lstm_scale, att_scale)`` with int8
    codes for every weight (``w_ctx`` and ``att_wh`` too) and
    ``compute_dtype``: the int8w mode.  At bf16 compute on the card E,
    H and A must be multiples of 32 (``TensorCoreShapeError``).

    CPU tensors take :func:`attlstm_beam_ref`; CUDA tensors launch the
    kernel (``attlstm_beam.launches`` counts the float launches,
    ``attlstm_beam.quant_launches`` the int8w ones)."""
    att = (w_ctx, att_wh, att_v, att_proj, att_mask, att_vals)
    if gx_static.device.type == "cpu":
        return attlstm_beam_ref(gx_static, w_x, wh, *att, emb, w_out, b_out,
                                beam_size=beam_size, max_len=max_len,
                                suppress_unk=suppress_unk, quant=quant,
                                compute_dtype=compute_dtype)
    out = _launch("attlstm_beam", gx_static, w_x, wh, att, emb, w_out, b_out,
                  beam_size, max_len, suppress_unk, quant, compute_dtype)
    if quant is None:
        _build.count_launch(attlstm_beam)
    else:
        _build.count_launch(attlstm_beam, "quant_launches")
    return out


def _launch(name, gx_static, w_x, wh, att, emb, w_out, b_out, beam_size,
            max_len, suppress_unk, quant, compute_dtype):
    K, T = int(beam_size), int(max_len)
    cdt, quant = unpack_quant(quant, compute_dtype, wh)
    B, V, E, H, cdt = check_operands(name, gx_static, w_x, wh, emb,
                                     w_out, b_out,
                                     None if quant is None else cdt)
    if not beam_shapes_ok(B, K, V) or K > KERNEL_MAX_BEAM:
        raise ValueError(f"{name}: B={B}, K={K}, V={V} not supported")
    dev = gx_static.device
    wdt = None if quant is None else torch.int8
    F, A = (0, 0) if att is None else check_att_operands(
        name, cdt, B, E, H, *att, dev, wdt=wdt)
    # bf16 and f16 decode on the tensor-core chain, or not at all.
    tc = cdt in TC_DTYPES
    if tc:
        check_tc_widths(name, E, H, None if att is None else A)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
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
    R = B * K
    nT = Vp // KERNEL_TILE_V
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    gx_r = gx_static.float().repeat_interleave(K, dim=0).contiguous()
    # The tensor-core chain keeps h in the compute dtype: every reader
    # rounds it so.
    hdt = dict(dtype=cdt if tc else torch.float32, device=dev)
    h = torch.zeros((R, H), **hdt)
    c = torch.zeros((R, H), **f32)
    h_new = torch.empty((R, H), **hdt)
    c_new = torch.empty((R, H), **f32)
    fin = torch.zeros((R,), **f32)
    score = torch.full((R,), NEG_INF, **f32)
    score[::K] = 0.0
    seqs = torch.full((R, T), PAD_ID, **i32)
    tok = torch.full((R,), BOS_ID, **i32)
    pm = torch.empty((R, nT), **f32)
    ps = torch.empty((R, nT), **f32)
    pv = torch.empty((R, nT, K), **f32)
    pi = torch.empty((R, nT, K), **i32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _bound()
    sp = [None if x is None else x.data_ptr() for x in scales]
    state = [fin, score, seqs, tok, pm, ps, pv, pi]
    if tc and att is None:
        table, wcat_t, _, w_out_t = stage_tc_weights(
            w_x, None, wh, None, emb, w_out_p, scales[0], cdt)
        err = lib.cst_lstm_beam_tc(
            KERNEL_DTYPES[cdt],
            *(x.data_ptr() for x in (gx_r, table, wcat_t, w_out_t, bias)),
            sp[1], sp[3], *(x.data_ptr() for x in (h, c, h_new, c_new,
                                                    *state)),
            B, K, T, E, H, V, Vp, stream)
        _build.check(lib, err, name)
        return seqs.view(B, K, T), score.view(B, K)
    if tc:
        w_ctx, att_wh, att_v, att_proj, att_mask, att_vals = att
        staged = stage_tc_weights(w_x, w_ctx, wh, att_wh, emb, w_out_p,
                                  scales[0], cdt)
        q = torch.empty((R, A), **hdt)
        ctx = torch.empty((R, E), **hdt)
        ops = [att_v.contiguous(), att_proj.contiguous(),
               att_mask.float().contiguous(), att_vals.contiguous(), h, c,
               h_new, c_new, q, ctx, *state]
        err = lib.cst_attlstm_beam_tc(
            KERNEL_DTYPES[cdt],
            *(x.data_ptr() for x in (gx_r, *staged, bias)), *sp[1:],
            *(x.data_ptr() for x in ops), B, K, T, E, H, A, F, V, Vp, stream)
        _build.check(lib, err, name)
        return seqs.view(B, K, T), score.view(B, K)
    ins = [t.contiguous() for t in (w_x, wh, emb, w_out_p)]
    common = [
        ins[0].data_ptr(), ins[1].data_ptr(), ins[2].data_ptr(),
        ins[3].data_ptr(), bias.data_ptr(),
        h.data_ptr(), c.data_ptr(), h_new.data_ptr(), c_new.data_ptr(),
        *(x.data_ptr() for x in state), B, K, T, E, H, V, Vp,
    ]
    wq = int(quant is not None)
    if att is None:
        err = lib.cst_lstm_beam(KERNEL_DTYPES[cdt], wq, gx_r.data_ptr(),
                                *common, sp[0], sp[1], sp[3], stream)
    else:
        w_ctx, att_wh, att_v, att_proj, att_mask, att_vals = att
        att_in = [x.contiguous() for x in (w_ctx, att_wh, att_v, att_proj)]
        mask = att_mask.float().contiguous()
        vals = att_vals.contiguous()
        q = torch.empty((R, A), **f32)
        ctx = torch.empty((R, E), **f32)
        err = lib.cst_attlstm_beam(
            KERNEL_DTYPES[cdt], wq, gx_r.data_ptr(), *common,
            *(x.data_ptr() for x in att_in), mask.data_ptr(),
            vals.data_ptr(), q.data_ptr(), ctx.data_ptr(), A, F, *sp, stream)
    _build.check(lib, err, name)
    return seqs.view(B, K, T), score.view(B, K)


lstm_beam.launches = 0
lstm_beam.quant_launches = 0
attlstm_beam.launches = 0
attlstm_beam.quant_launches = 0
_lib = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lstm_beam")
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.cst_lstm_beam.argtypes = [I, I] + [P] * 18 + [I] * 7 + [P] * 4
        lib.cst_lstm_beam.restype = I
        lib.cst_attlstm_beam.argtypes = ([I, I] + [P] * 18 + [I] * 7
                                         + [P] * 8 + [I] * 2 + [P] * 5)
        lib.cst_attlstm_beam.restype = I
        lib.cst_lstm_beam_tc.argtypes = [I] + [P] * 19 + [I] * 7 + [P]
        lib.cst_lstm_beam_tc.restype = I
        lib.cst_attlstm_beam_tc.argtypes = [I] + [P] * 27 + [I] * 9 + [P]
        lib.cst_attlstm_beam_tc.restype = I
        _lib = lib
    return _lib
