"""Fused meanpool sampling decode (greedy argmax or hash-Gumbel
multinomial): CUDA kernel wrapper and its plain PyTorch version.

Port of the JAX package's ``ops/pallas_sampler.py::lstm_sample`` (TPU
kernel ``_make_sample_kernel`` via ``_sample_impl``).  The kernel is
``csrc/lstm_sample.cu``; its header says what bounds it on the H100.
:func:`lstm_sample_ref` is the plain version, step for step the
reference twin ``lstm_sample_scan``: global argmax (first index on a
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
"""

from __future__ import annotations

import ctypes

import torch

from cst_captioning_torch.constants import BOS_ID, EOS_ID, PAD_ID
from cst_captioning_torch.ops import _build
from cst_captioning_torch.ops.decode_common import (
    KERNEL_DTYPES,
    KERNEL_TILE_V,
    MASK32,
    check_operands,
    decode_bias,
    gumbel_from_counter,
    masked_vocab,
    mul32,
    sampler_pick_tiles,
    seed_words,
    split_seed,
)
from cst_captioning_torch.ops.rnn import dot_f32, gate_update


def stream_geometry(B: int, E: int, H: int, cdt: torch.dtype, V: int):
    """(bt, V_pad) of the reference's multinomial stream."""
    bt, Vt = sampler_pick_tiles(B, 0, 0, E, H, cdt.itemsize)
    return bt, -(-V // Vt) * Vt


def _inv_temp(greedy: bool, temperature: float) -> torch.Tensor:
    one = torch.tensor(1.0, dtype=torch.float32)
    if greedy:
        return one
    return one / torch.tensor(float(temperature), dtype=torch.float32)


def lstm_sample_ref(gx_static, w_x, wh, emb, w_out, b_out, seed, *,
                    max_len: int, greedy: bool, temperature: float = 1.0,
                    suppress_unk: bool = False):
    """Plain version of :func:`lstm_sample` (any device)."""
    B = gx_static.shape[0]
    V = emb.shape[0]
    E = w_x.shape[0]
    H = wh.shape[0]
    cdt = wh.dtype
    dev = gx_static.device
    bt, V_pad = stream_geometry(B, E, H, cdt, V)
    bias_c = decode_bias(b_out, V, V, suppress_unk).to(cdt)
    w_out_c = w_out.to(cdt)
    rows = torch.arange(B, dtype=torch.long, device=dev)
    sw = seed_words(seed, rows, bt)[:, None]
    inv_temp = _inv_temp(greedy, temperature).to(dev)
    cols = torch.arange(V, dtype=torch.long, device=dev)[None, :]
    gx = gx_static.float()

    h = torch.zeros((B, H), dtype=torch.float32, device=dev)
    c = torch.zeros_like(h)
    fin = torch.zeros((B,), dtype=torch.bool, device=dev)
    tok = torch.full((B,), BOS_ID, dtype=torch.long, device=dev)
    toks, lps, msks = [], [], []
    for t in range(max_len):
        gates = gx + dot_f32(emb[tok], w_x, cdt)
        gates = gates + dot_f32(h, wh, cdt)
        h, c = gate_update(gates, c)
        logits = (dot_f32(h, w_out_c, cdt).to(cdt) + bias_c).float()
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


def lstm_sample(gx_static, w_x, wh, emb, w_out, b_out, seed, *,
                max_len: int, greedy: bool, temperature: float = 1.0,
                suppress_unk: bool = False):
    """Fused autoregressive sample from zero state (meanpool fusion).

    Shapes as :func:`~cst_captioning_torch.ops.beam.lstm_beam`; ``seed``
    is an int or two 32-bit words (a tensor or a pair) — the hash
    stream's key.  Returns ``(tokens int32, logprobs f32, mask f32)``,
    each (B, max_len).

    CPU tensors take :func:`lstm_sample_ref`; CUDA tensors launch the
    kernel (``lstm_sample.launches`` counts the launches)."""
    if gx_static.device.type == "cpu":
        return lstm_sample_ref(gx_static, w_x, wh, emb, w_out, b_out, seed,
                               max_len=max_len, greedy=greedy,
                               temperature=temperature,
                               suppress_unk=suppress_unk)
    if gx_static.device.type != "cuda":
        raise ValueError(f"lstm_sample: unsupported device {gx_static.device}")
    T = int(max_len)
    B, V, E, H, cdt = check_operands("lstm_sample", gx_static, w_x, wh, emb,
                                     w_out, b_out)
    if V <= 4:
        raise ValueError(f"lstm_sample: vocab {V} has no real words")
    dev = gx_static.device
    bt, v_pad_stream = stream_geometry(B, E, H, cdt, V)
    s0, s1 = split_seed(seed)
    inv_temp = float(_inv_temp(greedy, temperature))
    Vp = -(-V // KERNEL_TILE_V) * KERNEL_TILE_V
    bias, w_out_p = masked_vocab(b_out, w_out, V, Vp, suppress_unk, cdt)
    nT = Vp // KERNEL_TILE_V
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    gx = gx_static.float().contiguous()
    h_a = torch.zeros((B, H), **f32)
    h_b = torch.empty((B, H), **f32)
    c = torch.zeros((B, H), **f32)
    fin = torch.zeros((B,), **f32)
    tok = torch.full((B,), BOS_ID, **i32)
    out_tok = torch.empty((B, T), **i32)
    out_lp = torch.empty((B, T), **f32)
    out_mask = torch.empty((B, T), **f32)
    parts = [torch.empty((B, nT), **f32), torch.empty((B, nT), **f32),
             torch.empty((B, nT), **f32), torch.empty((B, nT), **i32),
             torch.empty((B, nT), **f32)]
    ins = [t.contiguous() for t in (w_x, wh, emb, w_out_p)]
    lib = _bound()
    err = lib.cst_lstm_sample(
        KERNEL_DTYPES[cdt], gx.data_ptr(), ins[0].data_ptr(), ins[1].data_ptr(),
        ins[2].data_ptr(), ins[3].data_ptr(), bias.data_ptr(),
        h_a.data_ptr(), h_b.data_ptr(), c.data_ptr(), fin.data_ptr(),
        tok.data_ptr(), out_tok.data_ptr(), out_lp.data_ptr(),
        out_mask.data_ptr(), *(p.data_ptr() for p in parts),
        B, T, E, H, Vp, bt, v_pad_stream, s0, s1, inv_temp, int(bool(greedy)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, err, "lstm_sample")
    lstm_sample.launches += 1
    return out_tok, out_lp, out_mask


lstm_sample.launches = 0
_lib = None


def _bound() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("lstm_sample")
        P, I = ctypes.c_void_p, ctypes.c_int
        U, F = ctypes.c_uint, ctypes.c_float
        lib.cst_lstm_sample.argtypes = (
            [I] + [P] * 19 + [I] * 7 + [U, U, F, I, P])
        lib.cst_lstm_sample.restype = I
        _lib = lib
    return _lib
