#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``cst_captioning_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``), then build
   every CUDA kernel of the ported paths from ``cst_captioning_torch/
   csrc/`` with ``nvcc`` for ``sm_90a`` (one compiler per source, in
   parallel).
2. Hold each decode kernel against its plain PyTorch version on the card
   at the full ``msrvtt_serve_beam5`` shape (B=64, K=5, E=H=512,
   V=10,496, T=30) on synthetic weights with spread vocab logits (see
   ``make_inputs``): float32 tokens exact (beam, greedy, multinomial)
   with scores / log-probs within 1e-3 (30 steps of float32 sums in two
   orders); the same on edge shapes and on a saturated-gate case;
   bfloat16 caption agreement >= 0.95 with score rtol <= 1e-3 (the
   kernel tier, set from measured readings), which also clears the
   reference's relaxed-serving tier (>= 0.75, rtol 0.02).  A chaos
   witness at ``randn * 0.3`` recurrent weights is reported, not held
   (see ``chaos_witness``).  TF32 is off for the float32 phases.  Each
   kernel (5 calls) and its plain version (1 call) are timed with CUDA
   events after a warm-up call.
2b. Hold the ``lstm_recurrence`` kernel (the XE/WXE teacher-forced
   recurrence) against its plain version at the training shape (R =
   64 x 20 caption rows, T=29, H=512): forward, gradients through the
   autograd Function, and a saturated-gate case (``check_recurrence``
   states the tolerances).  Time it (bf16 and f32, with and without the
   cell output), its plain version, and cuDNN's LSTM on the same gates
   as the library yardstick.
2c. Hold the attention decode kernels ``attlstm_beam`` and
   ``attlstm_sample`` against their plain versions at the same shape with
   attention fusion (F = 2 x 28 frames, A = 512), every video with a
   random valid-frame count per modality and one with all its frames
   masked (``make_att_inputs``): float32 tokens exact with scores /
   log-probs within 1e-3, bfloat16 at the attention kernel tier on seed
   0 and, beam and greedy, pooled over four seeds, with an order witness
   (``att_order_witness``); timed as phase 2.
2d. Hold the ``attlstm_recurrence`` forward and backward kernels against
   their plain versions at the attention XE shape (R = 1280, T = 29,
   F = 56, E = H = A = 512): float32 h_seq, c_seq and the softmax
   weights, the backward kernel on the same residuals, all eight
   gradients through the autograd Function, bfloat16 h_seq and the
   bfloat16 backward kernel on the same residuals
   (``check_att_recurrence`` states the tolerances); timed in both dtypes.
3. Serve: ``CaptionServer`` on an ephemeral port with the
   ``msrvtt_serve_beam5`` preset, ``--serving.continuous false``,
   random-init weights and a generated 10,492-word vocabulary; a few
   concurrent ``POST /v1/caption`` requests in beam mode, then in greedy
   mode.  Captions must come back, ``/metrics`` must carry the latency
   histograms, and each kernel's launch count — zeroed just before its
   mode's requests — must rise.
3b. The same with ``--model.feature_fusion attention``: the
   ``attlstm_beam`` and ``attlstm_sample`` launch counts must rise.
4. Train: the port's ``Trainer`` on the ``msrvtt_resnet_c3d_xe`` preset
   (full width: resnet 2048 + c3d 4096 x 28 frames, E=H=512, V=10,496,
   64 videos x 20 captions per step, bf16) for 2 epochs of 4 steps over a
   generated MSR-VTT-width corpus (``make_msrvtt_corpus``), validating
   each epoch by greedy decode.  The loss must be finite and fall, the
   val entry must carry CIDEr, ``best`` and ``last`` must be written, and
   the ``lstm_recurrence`` and ``lstm_sample`` launch counts — zeroed
   just before ``fit`` — must rise.  Then one XE step at float32 through
   the kernel vs through the plain recurrence (loss rtol <= 1e-5,
   gradient gap <= 1e-4 of the gradient norm), and one instrumented
   bf16 step: where its time goes.
4b. The same with ``--model.feature_fusion attention`` (the flagship
   attention captioner): the ``attlstm_recurrence`` forward and backward
   and ``attlstm_sample`` launch counts must rise; the float32 XE step
   through both recurrence kernels vs the plain forward and backward.
5. Print one JSON line of per-kernel numbers, the card line again, then,
   as the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

H100_BF16_FLOPS = 989e12     # dense tensor-core peak (NVIDIA data sheet)
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3
RELAXED_SERVING_MATCH_FLOOR = 0.75
RELAXED_SERVING_SCORE_RTOL = 0.02
# Kernel vs plain version in bfloat16: both follow one rounding contract.
# Set from the readings of the H100 runs (PERF.md): caption match 0.9844
# (beam) and 1.0 (sampler), score rtol 7.3e-05 and 1.4e-04.
KERNEL_BF16_MATCH_FLOOR = 0.95
KERNEL_BF16_SCORE_RTOL = 1e-3
F32_ATOL = 1e-3


def decode_tolerance(floor: float) -> str:
    """The decode kernels' tolerance as the ``kernels`` line states it,
    for a bf16 caption-match floor."""
    return (f"f32: tokens exact, |score or logprob diff| <= {F32_ATOL:g} "
            f"(max_abs_err_f32); bf16: caption match >= {floor:g}, score "
            f"rtol <= {KERNEL_BF16_SCORE_RTOL:g}; max_abs_err is the bf16 "
            "|score diff| (sampler: summed log-probs) over matching captions")


TOLERANCE = decode_tolerance(KERNEL_BF16_MATCH_FLOOR)

B, K, E, H, V, T = 64, 5, 512, 512, 10_496, 30
DEVICE = "cuda"    # phases 2b and 4 (a CPU rehearsal may point it elsewhere)
SATURATED_T = 4
REPS = 5           # timed kernel calls (after one warm-up call)
N_REQUESTS = 12    # HTTP requests per decode mode
# The JAX reference package: named as a path for the report, never imported.
REFERENCE = "cst_captioning" + "_tpu"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------ helpers

def time_call(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, one
    warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_inputs(torch, seed: int, rec: float = 0.03, gx: float = 0.1):
    """Spread vocab weights (randn * 0.3: logits far from tied) over a
    recurrence at the model's own weight scale (``rec`` = randn * 0.03,
    about the std of the uniform ±1/sqrt(H) init).  At ``rec`` = 0.3 the
    recurrence is chaotic (``chaos_witness``).  The draws do not depend
    on the scales, so one seed gives the same directions at any scale."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=0.3: (torch.randn(*s, generator=g) * sc)  # noqa: E731
    return dict(
        gx_static=r(B, 4 * H, sc=gx),
        w_x=r(E, 4 * H, sc=rec), wh=r(H, 4 * H, sc=rec), emb=r(V, E),
        w_out=r(H, V), b_out=r(V, sc=0.1),
    )


def permute_hidden(torch, a, perm):
    """The same model with its hidden units reordered by ``perm``: every
    output is the same in exact arithmetic, but the sums over H run in
    another order."""
    cols = torch.cat([perm + j * H for j in range(4)])
    return dict(gx_static=a["gx_static"][:, cols], w_x=a["w_x"][:, cols],
                wh=a["wh"][perm][:, cols], emb=a["emb"],
                w_out=a["w_out"][perm], b_out=a["b_out"])


def to_card(torch, args, cdt):
    out = {}
    for k, v in args.items():
        dt = torch.float32 if k in ("gx_static", "b_out") else cdt
        out[k] = v.to("cuda", dt).contiguous()
    return out


def bound_ms(flops: float, nbytes: float, peak: float):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def decode_work(rows: int, itemsize: int, out_bytes: int):
    """FLOPs and compulsory bytes of one fused decode call."""
    flops = T * (2 * rows * (E + H) * 4 * H + 2 * rows * H * V)
    in_bytes = (B * 4 * H * 4 + (E + H) * 4 * H * itemsize
                + V * E * itemsize + H * V * itemsize + V * 4)
    return flops, in_bytes + out_bytes


# ------------------------------------------------------------ phase 2

def decoders(beam_mod, sam_mod, attention: bool):
    """(beam kernel, its plain version, sampler kernel, its plain
    version) of one fusion."""
    p = "att" if attention else ""
    return (getattr(beam_mod, p + "lstm_beam"),
            getattr(beam_mod, p + "lstm_beam_ref"),
            getattr(sam_mod, p + "lstm_sample"),
            getattr(sam_mod, p + "lstm_sample_ref"))


def hold_f32(torch, fns, vals, what: str, *, k: int, t: int,
             seed=(123, 456), temperature: float = 1.0,
             suppress_unk: bool = False):
    """float32 kernel vs plain version (``fns`` as ``decoders`` gives)
    on ``vals`` (card tensors): beam, greedy and multinomial tokens (and
    the sampler's mask) exact, scores and log-probs within ``F32_ATOL``.
    Returns (beam err, sample err, beam seqs)."""
    beam, beam_ref, sample, sample_ref = fns
    b = vals[0].shape[0]
    kw = dict(max_len=t, suppress_unk=suppress_unk)
    ks, kc = beam(*vals, beam_size=k, **kw)
    rs, rc = beam_ref(*vals, beam_size=k, **kw)
    torch.cuda.synchronize()
    bad = int((ks != rs).any(-1).sum())
    beam_err = float((kc - rc).abs().max())
    log(f"{what}: {beam.__name__} f32 mismatching beams {bad}/{b * k}, "
        f"max |score diff| {beam_err:.3e}")
    if bad or not beam_err <= F32_ATOL:
        fail(f"{what}: {beam.__name__} float32 disagrees with its plain "
             "version")
    sam_err = 0.0
    for greedy in (True, False):
        kt, kl, km = sample(*vals, seed, greedy=greedy,
                            temperature=temperature, **kw)
        rt, rl, rm = sample_ref(*vals, seed, greedy=greedy,
                                temperature=temperature, **kw)
        torch.cuda.synchronize()
        bad = int((kt != rt).any(-1).sum())
        err = float((kl - rl).abs().max())
        mode = "greedy" if greedy else "multinomial"
        log(f"{what}: {sample.__name__} f32 {mode} mismatching rows "
            f"{bad}/{b}, max |logprob diff| {err:.3e}")
        if bad or not err <= F32_ATOL or not torch.equal(km, rm):
            fail(f"{what}: {sample.__name__} float32 {mode} disagrees with "
                 "its plain version")
        sam_err = max(sam_err, err)
    return beam_err, sam_err, rs


def bf16_and_times(torch, fns, v16, v32, floor: float):
    """bfloat16 kernel vs plain version at the main shape (beam, greedy,
    multinomial; ``bf16_check`` with match ``floor``), then the kernel
    (REPS calls) and plain (1 call) times in bf16 and f32 and the bf16
    per-kernel breakdown.  Returns the readings."""
    from cst_captioning_torch.decoding.beam import finalize_beams

    beam, beam_ref, sample, sample_ref = fns
    res = {}
    kb = finalize_beams(*beam(*v16, beam_size=K, max_len=T))
    rb = finalize_beams(*beam_ref(*v16, beam_size=K, max_len=T))
    res["beam_bf16_err"] = bf16_check(
        f"{beam.__name__} bf16", kb.tokens, rb.tokens, kb.score, rb.score,
        floor)
    res["sample_bf16_err"] = 0.0
    for greedy, seed in ((True, (0, 0)), (False, (123, 456))):
        kt, kl, _ = sample(*v16, seed, max_len=T, greedy=greedy)
        rt, rl, _ = sample_ref(*v16, seed, max_len=T, greedy=greedy)
        mode = "greedy" if greedy else "multinomial"
        res["sample_bf16_err"] = max(res["sample_bf16_err"], bf16_check(
            f"{sample.__name__} bf16 {mode}", kt, rt, kl.sum(-1),
            rl.sum(-1), floor))
    for tag, args in (("bf16", v16), ("f32", v32)):
        res[f"beam_ms_{tag}"] = time_call(
            torch, lambda: beam(*args, beam_size=K, max_len=T), REPS)
        res[f"beam_plain_ms_{tag}"] = time_call(
            torch, lambda: beam_ref(*args, beam_size=K, max_len=T), 1)
        res[f"sample_ms_{tag}"] = time_call(
            torch, lambda: sample(*args, (0, 0), max_len=T, greedy=True),
            REPS)
        res[f"sample_plain_ms_{tag}"] = time_call(
            torch, lambda: sample_ref(*args, (0, 0), max_len=T, greedy=True),
            1)
        log(f"times {tag}: {beam.__name__} {res[f'beam_ms_{tag}']:.3f} ms "
            f"(plain {res[f'beam_plain_ms_{tag}']:.3f} ms), "
            f"{sample.__name__} greedy {res[f'sample_ms_{tag}']:.3f} ms "
            f"(plain {res[f'sample_plain_ms_{tag}']:.3f} ms)")
    for fn, call in (
        (beam, lambda: beam(*v16, beam_size=K, max_len=T)),
        (sample, lambda: sample(*v16, (0, 0), max_len=T, greedy=True)),
    ):
        for kname, ms, count in kernel_breakdown(torch, call):
            log(f"breakdown bf16 {fn.__name__}: {kname} {ms:.3f} ms over "
                f"{count} launches")
    return res


def check_kernels(torch, beam_mod, sam_mod):
    """Phase 2 (see module docstring)."""
    fns = decoders(beam_mod, sam_mod, attention=False)
    base = make_inputs(torch, 0)
    res = {}
    vals = list(to_card(torch, base, torch.float32).values())
    res["beam_f32_err"], res["sample_f32_err"], _ = hold_f32(
        torch, fns, vals, "main shape", k=K, t=T)
    check_edge_shapes(torch, fns)
    check_saturated(torch, fns)
    res["chaos"] = chaos_witness(torch, beam_mod)
    v16 = list(to_card(torch, base, torch.bfloat16).values())
    res.update(bf16_and_times(torch, fns, v16, vals, KERNEL_BF16_MATCH_FLOOR))
    return res


def check_edge_shapes(torch, fns):
    """float32 exactness off the main shape: ragged row and vocab tiles
    (B, V not multiples of the kernels' 32 x 128 tiling), K=1, a beam
    row with all five specials masked (suppress_unk), EOS rigged to
    win (frozen beams / finished rows), tempered multinomial."""
    cases = [
        # B, K, E, H, V, T, suppress_unk, eos_bias, temperature
        (3, 1, 64, 64, 1000, 7, False, 0.0, 1.0),
        (8, 3, 32, 96, 130, 5, True, 0.0, 0.7),
        (33, 5, 64, 32, 777, 9, False, 3.0, 1.3),
    ]
    for (b, k, e, h, v, t, unk, eos, temp) in cases:
        g = torch.Generator().manual_seed(b * 1000 + v)
        r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
        b_out = r(v, sc=0.1)
        b_out[2] += eos
        args = [x.to("cuda").contiguous() for x in (
            r(b, 4 * h, sc=0.1), r(e, 4 * h, sc=0.03), r(h, 4 * h, sc=0.03),
            r(v, e, sc=0.3), r(h, v, sc=0.3), b_out)]
        what = f"edge shape B={b} K={k} E={e} H={h} V={v} T={t} suppress_unk={unk}"
        _, _, rs = hold_f32(torch, fns, args, what, k=k, t=t,
                            seed=(b, v), temperature=temp, suppress_unk=unk)
        log(f"{what}: eos-finished beam rows {int((rs == 2).any(-1).sum())}")


def check_saturated(torch, fns):
    """float32 exactness with saturated gates at the main widths: gate
    pre-activations of std about 17 (gx_static randn * 16, recurrent
    weights randn * 0.3), where sigmoid and tanh sit at their limits,
    over SATURATED_T steps: too few for the chaos of such a recurrence
    to flip a beam."""
    from cst_captioning_torch.constants import BOS_ID

    a = make_inputs(torch, 1, rec=0.3, gx=16.0)
    gates1 = a["gx_static"] + a["emb"][BOS_ID] @ a["w_x"]
    sat = float((gates1.abs() > 10).float().mean())
    log(f"saturated gates: share of step-1 |pre-activation| > 10: {sat:.3f}")
    hold_f32(torch, fns, list(to_card(torch, a, torch.float32).values()),
             f"saturated gates T={SATURATED_T}", k=K, t=SATURATED_T)


def chaos_witness(torch, beam_mod):
    """float32 beams at randn * 0.3 recurrent weights, where the LSTM is
    chaotic: reported, not held.  Kernel vs plain version on the same
    inputs, and each of them vs itself on the model with its hidden
    units permuted (``permute_hidden``: the same function, summed in
    another order).  If a summation order alone flips about as many
    beams as kernel vs plain does, the kernel's gap there is chaos."""
    a = make_inputs(torch, 0, rec=0.3)
    perm = torch.randperm(H, generator=torch.Generator().manual_seed(5))
    x = list(to_card(torch, a, torch.float32).values())
    xp = list(to_card(torch, permute_hidden(torch, a, perm),
                      torch.float32).values())
    run = lambda fn, v: fn(*v, beam_size=K, max_len=T)  # noqa: E731
    ks, kc = run(beam_mod.lstm_beam, x)
    rs, rc = run(beam_mod.lstm_beam_ref, x)
    kps, kpc = run(beam_mod.lstm_beam, xp)
    rps, rpc = run(beam_mod.lstm_beam_ref, xp)
    torch.cuda.synchronize()
    out = {}
    for tag, (s1, c1, s2, c2) in (
            ("kernel_vs_plain", (ks, kc, rs, rc)),
            ("plain_vs_plain_permuted", (rs, rc, rps, rpc)),
            ("kernel_vs_kernel_permuted", (ks, kc, kps, kpc))):
        bad = int((s1 != s2).any(-1).sum())
        err = float((c1 - c2).abs().max())
        out[tag] = {"beams_differ": bad, "max_abs_score_diff": err}
        log(f"chaos witness (recurrent randn*0.3, f32): {tag}: beams differ "
            f"{bad}/{B * K}, max |score diff| {err:.3e}")
    return out


def bf16_check(what: str, k_tok, r_tok, k_score, r_score,
               floor: float = KERNEL_BF16_MATCH_FLOOR) -> float:
    """Kernel vs plain version in bfloat16: the share of captions (rows
    of token ids) that match must reach the kernel floor (``floor``),
    and on the matching ones the score's relative gap must stay within
    its bound; both are tighter than the reference's relaxed-serving
    tier.  Returns the max absolute score gap over the matches."""
    same = (k_tok == r_tok).all(-1)
    match = float(same.float().mean())
    if not bool(same.any()):
        fail(f"{what}: no caption matches its plain version")
    gap = (k_score - r_score)[same].abs()
    rtol = float((gap / r_score[same].abs().clamp_min(1e-6)).max())
    log(f"{what}: caption match {match:.4f}, max score rtol {rtol:.3e}")
    if match < RELAXED_SERVING_MATCH_FLOOR or rtol > RELAXED_SERVING_SCORE_RTOL:
        fail(f"{what} outside the relaxed-serving tier")
    if match < floor or rtol > KERNEL_BF16_SCORE_RTOL:
        fail(f"{what} outside the kernel tier (match >= "
             f"{floor}, rtol <= {KERNEL_BF16_SCORE_RTOL})")
    return float(gap.max())


def kernel_name(key: str) -> str:
    """A profiler key shortened to the kernel's name: no ``void``, no
    ``(anonymous namespace)::``, no argument list."""
    key = key.replace("(anonymous namespace)::", "")
    if key.startswith("void "):
        key = key[5:]
    return key.split("(")[0][:90]


def kernel_breakdown(torch, fn):
    """Device time by CUDA kernel name over one call (torch.profiler);
    empty when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
        if us:
            rows.append((kernel_name(e.key), us / 1e3, e.count))
    if not rows:
        log("breakdown: not measured (the profiler recorded no device time)")
    return sorted(rows, key=lambda r: -r[1])


# ------------------------------------------------------------ phase 2b

R_XE, T_XE = 64 * 20, 29   # caption rows x teacher-forced steps (XE batch)
# Kernel vs plain version of the recurrence (no token feedback, so no
# chaos): float32 h and c, bf16 h, bf16 c relative to max(|c|, 1),
# float32 gradients relative to each gradient's max |value|, saturated
# gates (gx randn * 16, recurrent randn * 0.3, T=4).
#
# The first H100 run read 0 for every one of these (the plain version's
# f32 GEMM accumulates in the kernel's order), so the bounds are
# tightened from 1e-4 / 8e-3 / 1e-3 / 1e-4 to what a change of
# summation order could still produce: f32 1e-5, bf16 h one bf16 ulp at
# |h| < 1 (4e-3), bf16 c 2e-4, gradients 1e-5.
REC_F32_ATOL = 1e-5
REC_BF16_H_ATOL = 4e-3
REC_BF16_C_RTOL = 2e-4
REC_GRAD_RTOL = 1e-5
REC_SATURATED_ATOL = 1e-5
REC_TOLERANCE = ("f32: |h|,|c| diff <= 1e-5 (max_abs_err_f32), grads "
                 "<= 1e-5 x max|grad|, saturated T=4 <= 1e-5; bf16: |h "
                 "diff| <= 4e-3 (max_abs_err), |c diff| <= 2e-4 x max(|c|, 1)")


def rec_inputs(torch, seed: int, R: int, T: int, gx_scale: float = 0.5,
               rec: float = 0.03):
    """Input gates, recurrent weights (model init scale by default) and
    an output cotangent, drawn on the card from ``seed``."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    kw = dict(generator=g, device=DEVICE)
    return (torch.randn(R, T, 4 * H, **kw) * gx_scale,
            torch.randn(H, 4 * H, **kw) * rec,
            torch.randn(R, T, H, **kw))


def max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rec_work(R: int, T: int, itemsize: int, with_cell: bool = True):
    """FLOPs and compulsory bytes of one recurrence call: read gx and
    W_h, write h_seq (and the f32 c_seq)."""
    flops = 2 * R * H * 4 * H * T
    nbytes = (R * T * 4 * H * 4 + H * 4 * H * itemsize + R * T * H * itemsize
              + (R * T * H * 4 if with_cell else 0))
    return flops, nbytes


def cudnn_lstm(torch, gx, wh, dtype):
    """cuDNN's LSTM computing the same recurrence: input = gx, W_ih =
    I_{4H} (one extra (R*T, 4H) x (4H, 4H) GEMM), W_hh = wh^T, zero
    biases; PyTorch's gate order is i|f|g|o too.  The yardstick only."""
    lstm = torch.nn.LSTM(4 * H, H, batch_first=True).to(DEVICE, dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H))
        lstm.weight_hh_l0.copy_(wh.T)
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    # One contiguous weight buffer, or cuDNN re-packs it on every call.
    lstm.flatten_parameters()
    x = gx.to(dtype)

    def call():
        with torch.no_grad():
            return lstm(x)[0]

    return call


def check_recurrence(torch, lstm_mod):
    """Phase 2b (see module docstring)."""
    fwd, ref = lstm_mod.lstm_recurrence_fwd, lstm_mod.lstm_recurrence_ref
    res = {}
    gx, wh32, dh = rec_inputs(torch, 11, R_XE, T_XE)
    wh16 = wh32.to(torch.bfloat16)

    kh, kc = fwd(gx, wh32, with_cell=True)
    rh, rc = ref(gx, wh32, with_cell=True)
    torch.cuda.synchronize()
    eh, ec = max_diff(kh, rh), max_diff(kc, rc)
    log(f"lstm_recurrence f32 R={R_XE} T={T_XE} H={H}: max |h diff| {eh:.3e}, "
        f"max |c diff| {ec:.3e}")
    if eh > REC_F32_ATOL or ec > REC_F32_ATOL:
        fail("lstm_recurrence float32 disagrees with its plain version")
    if not torch.equal(fwd(gx, wh32, with_cell=False), kh):
        fail("lstm_recurrence without the cell output differs from with it")
    res["f32_err"] = max(eh, ec)
    kh32 = kh

    kh, kc = fwd(gx, wh16, with_cell=True)
    rh, rc = ref(gx, wh16, with_cell=True)
    torch.cuda.synchronize()
    eh = max_diff(kh, rh)
    c_rel = float(((kc - rc).abs() / rc.abs().clamp_min(1.0)).max())
    h_ne = float((kh != rh).float().mean())
    log(f"lstm_recurrence bf16: max |h diff| {eh:.3e} (share of h differing "
        f"{h_ne:.2e}), max |c diff| / max(|c|, 1) {c_rel:.3e}")
    if eh > REC_BF16_H_ATOL or c_rel > REC_BF16_C_RTOL:
        fail("lstm_recurrence bfloat16 outside its tolerance")
    res["bf16_err"], res["bf16_c_rel"] = eh, c_rel

    gk = gx.clone().requires_grad_()
    wk = wh32.clone().requires_grad_()
    lstm_mod.lstm_recurrence(gk, wk).backward(dh)
    rh, rc = ref(gx, wh32, with_cell=True)
    dgx, dwh = lstm_mod.lstm_recurrence_bwd(gx, wh32, rh, rc, dh)
    torch.cuda.synchronize()
    g_gx = max_diff(gk.grad, dgx) / float(dgx.abs().max())
    g_wh = max_diff(wk.grad, dwh) / float(dwh.abs().max())
    log(f"lstm_recurrence f32 gradients, kernel forward vs all-plain: "
        f"dgx {g_gx:.3e}, dwh {g_wh:.3e} (of max |grad|)")
    if g_gx > REC_GRAD_RTOL or g_wh > REC_GRAD_RTOL:
        fail("lstm_recurrence gradients disagree with the plain path")
    res["grad_rel"] = max(g_gx, g_wh)
    del gk, wk, dgx, dwh

    sg, sw, _ = rec_inputs(torch, 12, R_XE, SATURATED_T, gx_scale=16.0,
                           rec=0.3)
    kh, kc = fwd(sg, sw, with_cell=True)
    rh, rc = ref(sg, sw, with_cell=True)
    torch.cuda.synchronize()
    es = max(max_diff(kh, rh), max_diff(kc, rc))
    sat = float((sg[:, 0].abs() > 10).float().mean())
    log(f"lstm_recurrence saturated gates T={SATURATED_T} (share of step-1 "
        f"|gx| > 10: {sat:.3f}): max |diff| {es:.3e}")
    if es > REC_SATURATED_ATOL:
        fail("lstm_recurrence saturated-gate case disagrees")
    res["saturated_err"] = es

    for tag, w in (("bf16", wh16), ("f32", wh32)):
        res[f"ms_{tag}"] = time_call(
            torch, lambda: fwd(gx, w, with_cell=True), REPS)
        res[f"ms_nocell_{tag}"] = time_call(
            torch, lambda: fwd(gx, w, with_cell=False), REPS)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: ref(gx, w, with_cell=True), 1)
        h_, c_ = ref(gx, w, with_cell=True)
        res[f"plain_bwd_ms_{tag}"] = time_call(
            torch, lambda: lstm_mod.lstm_recurrence_bwd(gx, w, h_, c_, dh), 1)
        lib = cudnn_lstm(torch, gx, wh32, torch.float32 if tag == "f32"
                         else torch.bfloat16)
        res[f"library_ms_{tag}"] = time_call(torch, lib, REPS)
        if tag == "f32":
            res["library_err_f32"] = max_diff(lib(), kh32)
        log(f"times {tag}: lstm_recurrence {res[f'ms_{tag}']:.3f} ms with "
            f"cell, {res[f'ms_nocell_{tag}']:.3f} ms without (plain "
            f"{res[f'plain_ms_{tag}']:.3f} ms, plain backward "
            f"{res[f'plain_bwd_ms_{tag}']:.3f} ms, cuDNN LSTM incl. the "
            f"identity input GEMM {res[f'library_ms_{tag}']:.3f} ms)")
    log(f"cuDNN LSTM vs kernel f32: max |h diff| {res['library_err_f32']:.3e}")
    for kname, ms, count in kernel_breakdown(
            torch, lambda: fwd(gx, wh16, with_cell=True)):
        log(f"breakdown bf16 lstm_recurrence: {kname} {ms:.3f} ms over "
            f"{count} launches")
    return res


# ------------------------------------------------------------ phase 2c

A_ATT, FR_ATT = 512, 28          # attention width; frames per modality
F_ATT = 2 * FR_ATT               # resnet + c3d frames, concatenated
# The attention decoders' bf16 kernel tier.  bf16 attention rounds the
# query and every tanh argument (A per frame per row per step) to bf16,
# so a one-ulp f32 difference in the query's sum flips a rounding and,
# over 30 fed-back steps, a caption; float32 stays token-exact.
# ``att_order_witness`` measures how many captions a change of summation
# order alone moves: the same model with its hidden, attention, frame
# and embedding units permuted (every sum over H, A, F and E reordered).
# The H100 readings (PERF.md), beam / greedy caption match:
#   kernel vs plain, seed 0:                     0.875  / 0.906
#   kernel vs plain, per seed over ATT_SEEDS:    0.859-0.922 / 0.906-0.984
#   plain vs permuted plain, pooled:             0.922  / 0.941
#   kernel vs permuted kernel, pooled:           0.883  / 0.926
#   kernel vs plain, pooled:                     0.891  / 0.949
# so order alone moves about as many captions as kernel vs plain does.
# Held: seed 0 (beam, greedy, multinomial) and the pooled beam / greedy
# match at >= 0.85, below the lowest order-only pooled reading (0.883);
# and the pooled kernel-vs-plain match no more than ATT_WITNESS_MARGIN
# below the plain version's own match against its permuted model.
KERNEL_ATT_BF16_MATCH_FLOOR = 0.85
ATT_WITNESS_MARGIN = 0.05
ATT_SEEDS = (0, 1, 2, 3)
ATT_TOLERANCE = (decode_tolerance(KERNEL_ATT_BF16_MATCH_FLOOR)
                 + f" (seed 0, and beam / greedy pooled over "
                 f"{len(ATT_SEEDS)} seeds, there also >= plain vs permuted "
                 f"plain - {ATT_WITNESS_MARGIN:g}); attention inputs: one "
                 "video all-masked")


def att_mask(torch, g, n_videos: int, device="cpu"):
    """(n_videos, F_ATT) float32: a random valid-frame count in
    [1, FR_ATT] per modality and video (masked tails), and video 0 with
    every frame masked (the kernels must give uniform weights, not
    NaN)."""
    n = torch.randint(1, FR_ATT + 1, (n_videos, 2), generator=g)
    pos = torch.arange(FR_ATT)[None, :]
    mask = torch.cat([(pos < n[:, :1]), (pos < n[:, 1:])], dim=1).float()
    mask[0] = 0.0
    return mask.to(device)


def make_att_inputs(torch, seed: int):
    """The attention decoders' operands at the serving shape: phase 2's
    spread vocab weights and init-scale recurrence (``make_inputs``),
    plus w_ctx and att_wh at init scale, att_v randn * 0.06 and the
    per-video att_proj / att_vals at unit-ish scale."""
    a = make_inputs(torch, seed)
    g = torch.Generator().manual_seed(seed + 100)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    att = dict(w_ctx=r(E, 4 * H, sc=0.03), att_wh=r(H, A_ATT, sc=0.03),
               att_v=r(A_ATT, 1, sc=0.06),
               att_proj=r(B, F_ATT, A_ATT, sc=0.5),
               att_mask=att_mask(torch, g, B),
               att_vals=r(B, F_ATT, E, sc=0.5))
    return {"gx_static": a["gx_static"], "w_x": a["w_x"], "wh": a["wh"],
            **att, "emb": a["emb"], "w_out": a["w_out"], "b_out": a["b_out"]}


def att_to_card(torch, args, cdt):
    out = {}
    for k, v in args.items():
        dt = torch.float32 if k in ("gx_static", "b_out", "att_mask") else cdt
        out[k] = v.to("cuda", dt).contiguous()
    return out


def check_att_decoders(torch, beam_mod, sam_mod):
    """Phase 2c (see module docstring)."""
    fns = decoders(beam_mod, sam_mod, attention=True)
    base = make_att_inputs(torch, 0)
    res = {}
    v32 = list(att_to_card(torch, base, torch.float32).values())
    res["beam_f32_err"], res["sample_f32_err"], _ = hold_f32(
        torch, fns, v32, "attention main shape", k=K, t=T)
    v16 = list(att_to_card(torch, base, torch.bfloat16).values())
    res.update(bf16_and_times(torch, fns, v16, v32,
                              KERNEL_ATT_BF16_MATCH_FLOOR))
    res["order_witness"] = att_order_witness(torch, fns)
    return res


def permute_att(torch, a, ph, pa, pf, pe):
    """The attention decoders' operands (``make_att_inputs``) of the
    same model with its hidden units reordered by ``ph``, attention units
    by ``pa``, frames by ``pf`` and embedding / context units by ``pe``:
    the same function in exact arithmetic, every sum over H, A, F and E
    in another order (those over the vocabulary are not permuted: that
    would move the token ids)."""
    cols = torch.cat([ph + j * H for j in range(4)])
    return dict(gx_static=a["gx_static"][:, cols],
                w_x=a["w_x"][pe][:, cols], wh=a["wh"][ph][:, cols],
                w_ctx=a["w_ctx"][pe][:, cols],
                att_wh=a["att_wh"][ph][:, pa], att_v=a["att_v"][pa],
                att_proj=a["att_proj"][:, pf][:, :, pa],
                att_mask=a["att_mask"][:, pf],
                att_vals=a["att_vals"][:, pf][:, :, pe],
                emb=a["emb"][:, pe], w_out=a["w_out"][ph], b_out=a["b_out"])


def att_order_witness(torch, fns):
    """bf16 beam and greedy captions over ATT_SEEDS: kernel vs plain
    version, and each of them vs itself on the permuted model
    (``permute_att``), i.e. how many captions a change of summation
    order alone moves.  Holds the pooled kernel-vs-plain match to the
    floor and to the order witness (see KERNEL_ATT_BF16_MATCH_FLOOR)."""
    from cst_captioning_torch.decoding.beam import finalize_beams

    beam, beam_ref, sample, sample_ref = fns
    pairs = ("kernel_vs_plain", "plain_vs_plain_permuted",
             "kernel_vs_kernel_permuted")
    out = {"seeds": list(ATT_SEEDS)}
    for mode in ("beam", "greedy"):
        for key in pairs:
            out[f"{mode}_{key}"] = []
    for seed in ATT_SEEDS:
        g = torch.Generator().manual_seed(1000 + seed)
        perms = [torch.randperm(n, generator=g)
                 for n in (H, A_ATT, F_ATT, E)]
        a = make_att_inputs(torch, seed)
        x = list(att_to_card(torch, a, torch.bfloat16).values())
        xp = list(att_to_card(torch, permute_att(torch, a, *perms),
                              torch.bfloat16).values())
        caps = {}
        for tag, (bfn, sfn) in (("kernel", (beam, sample)),
                                ("plain", (beam_ref, sample_ref))):
            for sfx, v in (("", x), ("_permuted", xp)):
                caps[("beam", tag + sfx)] = finalize_beams(
                    *bfn(*v, beam_size=K, max_len=T)).tokens
                caps[("greedy", tag + sfx)] = sfn(
                    *v, (0, 0), max_len=T, greedy=True)[0]
        torch.cuda.synchronize()
        for mode in ("beam", "greedy"):
            for key in pairs:
                one, two = key.split("_vs_")
                m = float((caps[(mode, one)] == caps[(mode, two)])
                          .all(-1).float().mean())
                out[f"{mode}_{key}"].append(m)
        log(f"attention bf16 order witness, seed {seed}: " + ", ".join(
            f"{mode} {key} {out[f'{mode}_{key}'][-1]:.4f}"
            for mode in ("beam", "greedy") for key in pairs))
    for mode in ("beam", "greedy"):
        for key in pairs:
            vals = out[f"{mode}_{key}"]
            out[f"{mode}_{key}_pooled"] = sum(vals) / len(vals)
        pooled = out[f"{mode}_kernel_vs_plain_pooled"]
        log(f"attention bf16 {mode} caption match pooled over "
            f"{len(ATT_SEEDS)} seeds: kernel vs plain {pooled:.4f}, plain "
            "vs permuted plain "
            f"{out[f'{mode}_plain_vs_plain_permuted_pooled']:.4f}, kernel "
            "vs permuted kernel "
            f"{out[f'{mode}_kernel_vs_kernel_permuted_pooled']:.4f}")
        order = out[f"{mode}_plain_vs_plain_permuted_pooled"]
        if pooled < KERNEL_ATT_BF16_MATCH_FLOOR:
            fail(f"attention bf16 {mode} pooled caption match {pooled:.4f} "
                 f"below the kernel floor {KERNEL_ATT_BF16_MATCH_FLOOR}")
        if pooled < order - ATT_WITNESS_MARGIN:
            fail(f"attention bf16 {mode}: kernel vs plain moves more "
                 f"captions ({pooled:.4f} match) than a change of summation "
                 f"order does ({order:.4f}) by over {ATT_WITNESS_MARGIN}")
    return out


def att_decode_work(rows: int, itemsize: int, out_bytes: int):
    """FLOPs, compulsory bytes and tanh count of one attention decode
    call: the meanpool work plus, per step and row, the query GEMM, the
    ctx gate GEMM, the score and the context mix."""
    flops, nbytes = decode_work(rows, itemsize, out_bytes)
    flops += T * 2 * rows * (H * A_ATT + E * 4 * H + F_ATT * (A_ATT + E))
    nbytes += (E * 4 * H + H * A_ATT + A_ATT) * itemsize
    nbytes += B * F_ATT * (A_ATT + E) * itemsize + B * F_ATT * 4
    return flops, nbytes, T * rows * F_ATT * A_ATT


# ------------------------------------------------------------ phase 2d

# Kernel vs plain version of the attention recurrence (no token
# feedback, so no chaos): float32 forward (h_seq, c_seq, a_seq), the
# backward kernel on the plain forward's residuals and the end-to-end
# gradients (each relative to its max |value|), bfloat16 h_seq.  The
# first H100 run read 3.6e-07 (forward), 1.3e-06 (backward kernel) and
# 1.4e-06 (end to end) against the 1e-4 start bounds, and a bf16 h gap
# of exactly one ulp at |h| < 1 (3.9e-3; 3.7% of h differ: the bf16
# rounding of the query flips where its f32 sum differs in the last
# bit).  So the float32 bounds are tightened to 1e-5, what a change of
# summation order could still produce; bf16 stays at one ulp (4e-3).
ATT_F32_ATOL = 1e-5
ATT_BF16_H_ATOL = 4e-3
ATT_GRAD_RTOL = 1e-5
# The bf16 backward kernel vs its plain version on the same residuals
# (the plain forward's): each cotangent in bf16 ulps of the larger of
# the two values, past an absolute allowance of ATT_BWD_BF16_ATOL_REL x
# its max |value| (near zero, where sums cancel, ulps mean nothing).
# dgx is float32 but rides on dgates rounded to bf16 before three
# products each step, so it is counted in bf16 ulps too.  The first H100
# run read at most 0.82 ulps (w_ctx; dgx 0), so the bound is 2 ulps,
# the CPU tests' bound for the plain version against the reference.
ATT_BWD_BF16_ULPS = 2.0
ATT_BWD_BF16_ATOL_REL = 1e-3
ATT_TOL_TEXT = (
    f"f32: |h|,|c|,|a| diff <= {ATT_F32_ATOL:g} (max_abs_err_f32), grads "
    f"(backward kernel on the same residuals, and end to end) <= "
    f"{ATT_GRAD_RTOL:g} x max|grad|; bf16: |h diff| <= {ATT_BF16_H_ATOL:g} "
    f"(max_abs_err); bf16 backward on the same residuals: every cotangent "
    f"within {ATT_BWD_BF16_ULPS:g} bf16 ulps past {ATT_BWD_BF16_ATOL_REL:g} "
    "x its max |value| (max_abs_err of the backward entry)")
GRAD_NAMES = ("gx", "wh", "w_ctx", "att_wh", "att_v", "att_proj",
              "att_mask", "att_vals")
BWD_NAMES = tuple(n for n in GRAD_NAMES if n != "att_mask")


def bf16_ulps(torch, got, want, atol_rel: float) -> float:
    """The largest gap between ``got`` and ``want`` in bf16 ulps of the
    larger of the two values, after an absolute allowance of ``atol_rel``
    x max |want|."""
    g, w = got.double(), want.double()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    gap = ((g - w).abs() - atol_rel * float(w.abs().max())).clamp_min(0)
    return float((gap / ulp).max())


def att_rec_inputs(torch, seed: int, R: int, T: int):
    """The attention recurrence's operands at model init scale, drawn on
    the card from ``seed``, plus an output cotangent; att_mask as
    ``att_mask`` gives (row 0 all masked)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    kw = dict(generator=g, device=DEVICE)
    args = [torch.randn(R, T, 4 * H, **kw) * 0.5,
            torch.randn(H, 4 * H, **kw) * 0.03,
            torch.randn(E, 4 * H, **kw) * 0.03,
            torch.randn(H, A_ATT, **kw) * 0.03,
            torch.randn(A_ATT, 1, **kw) * 0.06,
            torch.randn(R, F_ATT, A_ATT, **kw) * 0.5,
            att_mask(torch, torch.Generator().manual_seed(seed), R, DEVICE),
            torch.randn(R, F_ATT, E, **kw) * 0.5]
    return args, torch.randn(R, T, H, **kw)


def att_rec_cast(args, cdt):
    return [x if i in (0, 6) else x.to(cdt) for i, x in enumerate(args)]


def check_att_recurrence(torch, att_mod):
    """Phase 2d (see module docstring)."""
    fwd, ref = att_mod.attlstm_recurrence_fwd, att_mod.attlstm_recurrence_ref
    bwd, bwd_ref = att_mod.attlstm_recurrence_bwd, att_mod.attlstm_recurrence_bwd_ref
    res = {}
    a32, dh = att_rec_inputs(torch, 21, R_XE, T_XE)
    a16 = att_rec_cast(a32, torch.bfloat16)

    k = fwd(*a32, with_residuals=True)
    r = ref(*a32, with_residuals=True)
    torch.cuda.synchronize()
    errs = [max_diff(x, y) for x, y in zip(k, r)]
    log(f"attlstm_recurrence f32 R={R_XE} T={T_XE} F={F_ATT} A={A_ATT}: max "
        f"|h diff| {errs[0]:.3e}, |c diff| {errs[1]:.3e}, |a diff| "
        f"{errs[2]:.3e}; all-masked row uniform "
        f"{bool(torch.allclose(k[2][0], torch.full_like(k[2][0], 1 / F_ATT)))}")
    if not max(errs) <= ATT_F32_ATOL or not torch.isfinite(k[0]).all():
        fail("attlstm_recurrence float32 disagrees with its plain version")
    if not torch.equal(fwd(*a32), k[0]):
        fail("attlstm_recurrence without residuals differs from with them")
    res["f32_err"] = max(errs)

    kb = bwd(*a32[:6], a32[7], *r, dh)
    rb = bwd_ref(*a32[:6], a32[7], *r, dh)
    torch.cuda.synchronize()
    rel = {n: max_diff(x, y) / max(float(y.abs().max()), 1e-30)
           for n, x, y in zip(BWD_NAMES, kb, rb)}
    log("attlstm_recurrence_bwd f32, kernel vs plain on the same residuals "
        "(of max |grad|): " + ", ".join(f"{n} {v:.3e}" for n, v in rel.items()))
    if not max(rel.values()) <= ATT_GRAD_RTOL:
        fail("attlstm_recurrence backward kernel disagrees with its plain "
             "version")
    res["bwd_grad_rel"] = max(rel.values())
    res["bwd_f32_err"] = max(max_diff(x, y) for x, y in zip(kb, rb))
    del kb, rb

    leaves = [x.clone().requires_grad_() for x in a32]
    (att_mod.attlstm_recurrence(*leaves) * dh).sum().backward()
    want = list(bwd_ref(*a32[:6], a32[7], *r, dh))
    want.insert(6, torch.zeros_like(a32[6]))
    torch.cuda.synchronize()
    e2e = {}
    for n, x, y in zip(GRAD_NAMES, leaves, want):
        e2e[n] = max_diff(x.grad, y) / max(float(y.abs().max()), 1e-30)
    log("attlstm_recurrence f32 gradients end to end, kernels vs all-plain "
        "(of max |grad|; att_mask is zero on both): "
        + ", ".join(f"{n} {v:.3e}" for n, v in e2e.items()))
    if not max(e2e.values()) <= ATT_GRAD_RTOL:
        fail("attlstm_recurrence gradients disagree with the plain path")
    res["grad_rel"] = max(e2e.values())
    del leaves, want

    kh = fwd(*a16)
    rh = ref(*a16)
    torch.cuda.synchronize()
    res["bf16_err"] = max_diff(kh, rh)
    log(f"attlstm_recurrence bf16: max |h diff| {res['bf16_err']:.3e} (share "
        f"of h differing {float((kh != rh).float().mean()):.2e})")
    if not res["bf16_err"] <= ATT_BF16_H_ATOL:
        fail("attlstm_recurrence bfloat16 outside its tolerance")

    rr16 = ref(*a16, with_residuals=True)
    dh16 = dh.to(torch.bfloat16)
    kb = bwd(*a16[:6], a16[7], *rr16, dh16)
    rb = bwd_ref(*a16[:6], a16[7], *rr16, dh16)
    torch.cuda.synchronize()
    ulps = {n: bf16_ulps(torch, x, y, ATT_BWD_BF16_ATOL_REL)
            for n, x, y in zip(BWD_NAMES, kb, rb)}
    rel = {n: max_diff(x, y) / max(float(y.float().abs().max()), 1e-30)
           for n, x, y in zip(BWD_NAMES, kb, rb)}
    log("attlstm_recurrence_bwd bf16, kernel vs plain on the same "
        f"residuals: bf16 ulps past {ATT_BWD_BF16_ATOL_REL:g} x max "
        "|value|: " + ", ".join(f"{n} {v:.2f}" for n, v in ulps.items())
        + "; of max |grad|: " + ", ".join(f"{n} {v:.3e}"
                                          for n, v in rel.items()))
    if not max(ulps.values()) <= ATT_BWD_BF16_ULPS:
        fail("attlstm_recurrence backward kernel bfloat16 disagrees with "
             "its plain version")
    res["bwd_bf16_ulps"] = ulps
    res["bwd_bf16_err"] = max(max_diff(x, y) for x, y in zip(kb, rb))
    del kb, rb

    for tag, args in (("bf16", a16), ("f32", a32)):
        res[f"ms_{tag}"] = time_call(
            torch, lambda: fwd(*args, with_residuals=True), REPS)
        res[f"ms_nores_{tag}"] = time_call(torch, lambda: fwd(*args), REPS)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: ref(*args, with_residuals=True), 1)
        rr = ref(*args, with_residuals=True)
        dh_t = dh.to(args[1].dtype)
        res[f"bwd_ms_{tag}"] = time_call(
            torch, lambda: bwd(*args[:6], args[7], *rr, dh_t), REPS)
        res[f"bwd_plain_ms_{tag}"] = time_call(
            torch, lambda: bwd_ref(*args[:6], args[7], *rr, dh_t), 1)
        log(f"times {tag}: attlstm_recurrence {res[f'ms_{tag}']:.3f} ms with "
            f"residuals, {res[f'ms_nores_{tag}']:.3f} ms without (plain "
            f"{res[f'plain_ms_{tag}']:.3f} ms); backward kernel "
            f"{res[f'bwd_ms_{tag}']:.3f} ms incl. the three weight "
            f"contractions (plain {res[f'bwd_plain_ms_{tag}']:.3f} ms)")
        del rr
    for name, fn in (
        ("attlstm_recurrence", lambda: fwd(*a16, with_residuals=True)),
        ("attlstm_recurrence_bwd",
         lambda: bwd(*a16[:6], a16[7], *rr16, dh16)),
    ):
        for kname, ms, count in kernel_breakdown(torch, fn):
            log(f"breakdown bf16 {name}: {kname} {ms:.3f} ms over {count} "
                "launches")
    return res


def att_rec_work(R: int, T: int, itemsize: int):
    """(forward, backward) FLOPs, compulsory bytes and tanh counts of one
    attention recurrence call with residuals (the backward without the
    three weight contractions done outside it)."""
    RT = R * T
    att_in = R * F_ATT * (A_ATT + E) * itemsize + R * F_ATT * 4
    w = (H * 4 * H + E * 4 * H + H * A_ATT + A_ATT) * itemsize
    res = RT * H * itemsize + RT * H * 4 + RT * F_ATT * 4   # h, c, a
    f_flops = 2 * RT * (H * 4 * H + E * 4 * H + H * A_ATT
                        + F_ATT * (A_ATT + E))
    f_bytes = RT * 4 * H * 4 + w + att_in + res
    b_flops = (2 * RT * (2 * 4 * H * (E + H) + 2 * H * A_ATT)
               + RT * F_ATT * (6 * E + 8 * A_ATT))
    b_bytes = (RT * 4 * H * 4 + w + att_in + res + RT * H * itemsize
               + RT * 4 * H * 4 + RT * A_ATT * 4
               + R * F_ATT * (A_ATT + E) * 4 + A_ATT * 4)
    tanh = RT * F_ATT * A_ATT
    return (f_flops, f_bytes, tanh), (b_flops, b_bytes, tanh)


# SFU rate for tanh: 16 special-function results per SM per clock
# (H100 SM), 132 SMs at the 1.98 GHz boost clock.
H100_SFU_PER_S = 132 * 16 * 1.98e9


def sfu_floor_ms(n_tanh: float) -> float:
    return n_tanh / H100_SFU_PER_S * 1e3


# ------------------------------------------------------------ phase 3

def post(url: str, payload) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def serve_mode(torch, mode: str, params, vocab, counter_fn, reset_fn,
               fusion: str):
    """Boot the ladder server in ``mode`` with ``fusion``, POST
    concurrent requests, return (launches, responses, metrics text,
    stats)."""
    from cst_captioning_torch.config import parse_cli
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    cfg = parse_cli([
        "--preset", "msrvtt_serve_beam5", "--serving.continuous", "false",
        "--serving.port", "0", "--serving.decode_mode", mode,
        "--model.feature_fusion", fusion,
    ])
    engine = InferenceEngine(cfg, params=params, vocab=vocab, device="cuda")
    server = CaptionServer(engine).start()
    try:
        g = torch.Generator().manual_seed(7)
        payloads = []
        for _ in range(N_REQUESTS):
            feats = {
                m: (torch.randn(cfg.data.max_frames, cfg.data.feature_dims[m],
                                generator=g)).tolist()
                for m in cfg.data.feature_modalities
            }
            payloads.append({"features": feats})
        reset_fn()
        out = [None] * N_REQUESTS
        errs = []

        def worker(i):
            try:
                out[i] = post(server.url + "/v1/caption", payloads[i])
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(f"{type(e).__name__}: {e}")

        ths = [threading.Thread(target=worker, args=(i,))
               for i in range(N_REQUESTS)]
        t0 = time.perf_counter()
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = counter_fn()
        if errs:
            fail(f"{mode} requests failed: {errs[:3]}")
        with urllib.request.urlopen(server.url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(server.url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
    return launches, out, metrics, stats, wall


def check_engine(torch, kernels, fusion: str):
    """Phase 3 (meanpool) / 3b (attention): ``kernels`` maps each decode
    mode to the wrapper whose launches it must count."""
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config

    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    cfg = get_preset("msrvtt_serve_beam5")
    cfg.model.vocab_size = len(vocab)
    cfg.model.feature_fusion = fusion
    model = model_from_config(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.train.seed))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    res = {}
    for mode, fn in kernels.items():
        def reset(fn=fn):
            fn.launches = 0

        launches, out, metrics, stats, wall = serve_mode(
            torch, mode, params, vocab, lambda fn=fn: fn.launches, reset,
            fusion)
        for r in out:
            if not isinstance(r, dict) or not isinstance(r.get("caption"), str):
                fail(f"{mode}: bad response {str(r)[:200]}")
            toks = r["tokens"]
            if len(toks) != cfg.eval.max_decode_len or not all(
                    0 <= t < V for t in toks):
                fail(f"{mode}: bad tokens {toks[:10]}")
        for fam in ("caption_latency_queue_ms_bucket",
                    "caption_latency_device_ms_bucket",
                    "caption_requests_served_total"):
            if fam not in metrics:
                fail(f"{mode}: /metrics lacks {fam}")
        if launches < 1:
            fail(f"{fusion} {mode}: {fn.__name__} was not launched on the "
                 "serving path")
        lat = stats["latency_ms"]
        log(f"serve {fusion} {mode}: {N_REQUESTS} requests in {wall:.3f} s, "
            f"batches {stats['batches']}, {fn.__name__} launches {launches}, "
            f"device p50 {lat['device']['p50_ms']} ms, total p50 "
            f"{lat['total']['p50_ms']} ms")
        log(f"serve {fusion} {mode}: first caption "
            f"{out[0]['caption'][:80]!r}")
        res[mode] = launches
    return res


# ------------------------------------------------------------ phase 4

N_TRAIN_VIDEOS, N_VAL_VIDEOS = 256, 64
N_TOPICS, WORDS_PER_TOPIC = 64, 48
XE_LOSS_RTOL = 1e-5
XE_GRAD_GAP = 1e-4


def make_msrvtt_corpus(np, vocab, cfg, n_videos: int, seed: int):
    """An in-memory corpus at MSR-VTT widths with a learnable signal:
    each video has a topic; its frames (between F/2 and F of them) are
    the topic's fixed random embedding plus noise, per modality; its
    ``seq_per_img`` captions are 6..28 words drawn from the topic's
    words.  Topics are shared across seeds, so splits agree."""
    from cst_captioning_torch.data.datasets import InMemoryDataset

    d = cfg.data
    trng = np.random.RandomState(20261016)
    topic_embed = {m: trng.randn(N_TOPICS, d.feature_dims[m]).astype(np.float32)
                   for m in d.feature_modalities}
    topic_words = trng.randint(4, len(vocab), (N_TOPICS, WORDS_PER_TOPIC))
    rng = np.random.RandomState(seed)
    feats = {m: [] for m in d.feature_modalities}
    caps, refs = [], []
    max_words = d.max_seq_len - 2
    for _ in range(n_videos):
        t = rng.randint(N_TOPICS)
        nf = rng.randint(d.max_frames // 2, d.max_frames + 1)
        for m in d.feature_modalities:
            noise = rng.standard_normal((nf, d.feature_dims[m])).astype(np.float32)
            feats[m].append(topic_embed[m][t] + np.float32(0.5) * noise)
        sents = [" ".join(vocab.idx_to_word[w] for w in rng.choice(
            topic_words[t], rng.randint(6, max_words + 1)))
            for _ in range(d.seq_per_img)]
        refs.append(sents)
        caps.append(np.stack([vocab.encode(s.split(), max_words)
                              for s in sents]))
    ids = [f"video{seed}_{i}" for i in range(n_videos)]
    return InMemoryDataset(vocab, ids, feats, caps, refs)


def plain_recurrence(torch, lstm_mod):
    """The recurrence through its plain version, forward and backward
    (for the kernel-vs-plain XE step)."""

    class PlainRecurrence(torch.autograd.Function):
        @staticmethod
        def forward(ctx, gx, wh):
            h, c = lstm_mod.lstm_recurrence_ref(gx, wh, with_cell=True)
            ctx.save_for_backward(gx, wh, h, c)
            return h

        @staticmethod
        def backward(ctx, dh):
            return lstm_mod.lstm_recurrence_bwd(*ctx.saved_tensors, dh)

    return PlainRecurrence.apply


def plain_att_recurrence(torch, att_mod):
    """The attention recurrence through its plain forward and backward
    (for the kernel-vs-plain XE step)."""

    class PlainAttRecurrence(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            h, c, a = att_mod.attlstm_recurrence_ref(*args,
                                                     with_residuals=True)
            ctx.save_for_backward(*args, h, c, a)
            return h

        @staticmethod
        def backward(ctx, dh):
            gx, wh, w_ctx, att_wh, att_v, proj, _, vals, h, c, a = \
                ctx.saved_tensors
            g = att_mod.attlstm_recurrence_bwd_ref(
                gx, wh, w_ctx, att_wh, att_v, proj, vals, h, c, a, dh)
            return (*g[:6], None, g[6])

    return PlainAttRecurrence.apply


def check_xe_step(torch, trainer, cfg, kernel_name: str, plain_fn):
    """One XE step at float32 on the trained weights and one training
    batch: loss and gradients through the recurrence kernel(s) vs
    through ``plain_fn`` in place of ``captioner.<kernel_name>`` (the
    same dropout draw)."""
    import copy

    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.training.steps import global_norm, xe_loss

    c32 = copy.deepcopy(cfg)
    c32.model.compute_dtype = "float32"
    model = captioner.model_from_config(c32, device=DEVICE)
    model.load_state_dict(trainer.model.state_dict())
    batch = to_device(next(iter(trainer.train_iter.epoch(0))),
                      torch.device(DEVICE))
    params = list(model.parameters())

    def loss_and_grads():
        gen = torch.Generator(device=DEVICE).manual_seed(99)
        loss = xe_loss(model, batch.feats, batch.feat_masks, batch.captions,
                       torch.ones_like(batch.weights), gen)
        return float(loss.detach()), torch.autograd.grad(loss, params)

    k_loss, k_grads = loss_and_grads()
    kernel = getattr(captioner, kernel_name)
    setattr(captioner, kernel_name, plain_fn)
    try:
        p_loss, p_grads = loss_and_grads()
    finally:
        setattr(captioner, kernel_name, kernel)
    loss_rtol = abs(k_loss - p_loss) / abs(p_loss)
    gap = float(global_norm([a - b for a, b in zip(k_grads, p_grads)])
                / global_norm(p_grads))
    log(f"XE step f32 {cfg.model.feature_fusion} kernel vs plain: loss "
        f"{k_loss:.6f} vs {p_loss:.6f} "
        f"(rtol {loss_rtol:.3e}), |grad diff| / |grad| {gap:.3e}")
    if loss_rtol > XE_LOSS_RTOL or gap > XE_GRAD_GAP:
        fail("XE step through the kernel disagrees with the plain version")
    return {"loss_rtol": loss_rtol, "grad_gap": gap}


def step_breakdown(torch, trainer, card: str):
    """Where one bf16 XE step's time goes: CUDA events around its parts
    (after a warm-up step), then the profiler's top device kernels of
    the same step."""
    from cst_captioning_torch.constants import PAD_ID
    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.models.captioner import _repeat_cache
    from cst_captioning_torch.ops.losses import weighted_cross_entropy

    model, opt = trainer.model, trainer.optimizer
    names, params = zip(*model.named_parameters())
    b = to_device(next(iter(trainer.train_iter.epoch(0))),
                  torch.device(DEVICE))
    Bv, S, L = b.captions.shape
    caps = b.captions.long().reshape(Bv * S, L)
    inputs, targets = caps[:, :-1], caps[:, 1:]
    tmask = (targets != PAD_ID).float()
    w = torch.ones(Bv * S, device=DEVICE)
    parts = ("encode", "input GEMMs + recurrence kernel",
             "dropout + vocab GEMM", "loss (log-softmax)",
             "backward (autograd; " + (
                 "attlstm_recurrence_bwd kernel" if model.fusion == "attention"
                 else "plain recurrence backward") + ")", "optimizer")

    def one_step(ev=None):
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        mark(0)
        cache = _repeat_cache(model._encode(b.feats, b.feat_masks), S)
        mark(1)
        h_seq = (model._fused_attention_forward
                 if model.fusion == "attention"
                 else model._fused_forward)(cache, inputs)
        mark(2)
        logits = model._logits(model._output_dropout(h_seq, gen))
        mark(3)
        loss = weighted_cross_entropy(logits, targets, tmask, w)
        mark(4)
        grads = torch.autograd.grad(loss, params)
        mark(5)
        opt.step(dict(zip(names, grads)))
        mark(6)

    one_step()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    one_step(ev)
    torch.cuda.synchronize()
    out = {}
    for i, name in enumerate(parts):
        out[name] = ev[i].elapsed_time(ev[i + 1])
        log(f"XE step bf16 {model.fusion} part: {name} {out[name]:.3f} ms  "
            f"[{card}]")
    total = ev[0].elapsed_time(ev[6])
    log(f"XE step bf16 {model.fusion} total {total:.3f} ms  [{card}]")
    out["total"] = total
    for kname, ms, count in kernel_breakdown(torch, one_step)[:15]:
        log(f"breakdown XE step bf16 {model.fusion}: {kname} {ms:.3f} ms over "
            f"{count} launches")
    return out


def check_training(torch, card: str, fusion: str, counted, swap):
    """Phase 4 (meanpool) / 4b (attention), see the module docstring.
    ``counted`` maps names to the wrappers whose launches the training
    run must count; ``swap`` is (captioner attribute, plain autograd
    function) for the f32 XE step check.  Returns the launch counts of
    the training run and the readings."""
    import numpy as np

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.training.trainer import Trainer

    cfg = get_preset("msrvtt_resnet_c3d_xe")
    cfg.model.feature_fusion = fusion
    cfg.train.max_epochs = 2
    cfg.train.eval_every = 1
    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    t0 = time.perf_counter()
    train_ds = make_msrvtt_corpus(np, vocab, cfg, N_TRAIN_VIDEOS, seed=1)
    val_ds = make_msrvtt_corpus(np, vocab, cfg, N_VAL_VIDEOS, seed=2)
    log(f"train corpus: {N_TRAIN_VIDEOS} + {N_VAL_VIDEOS} videos at "
        f"{cfg.data.feature_dims} x {cfg.data.max_frames} frames, "
        f"{cfg.data.seq_per_img} captions each, V={len(vocab)}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg.train.checkpoint_dir = tmp
        trainer = Trainer(cfg, train_ds, val_ds, device=DEVICE)
        m = trainer.model
        if (m.vocab_size, m.rnn_size, m.embed_size) != (V, H, E):
            fail(f"model widths {(m.vocab_size, m.rnn_size, m.embed_size)}")
        seen = []
        inner = trainer._train_step

        def recording_step(*args):
            out = inner(*args)
            seen.append(out)
            return out

        trainer._train_step = recording_step
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        hist = trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counted.items()}
        trainer._train_step = inner
        losses = [float(x["loss"]) for x in seen]
        gnorms = [float(x["grad_norm"]) for x in seen]
        per_epoch = trainer.train_iter.num_batches()
        log(f"train {fusion}: {len(seen)} steps ({per_epoch} per epoch) in "
            f"{wall:.1f} s incl. validation; losses "
            f"{[round(x, 4) for x in losses]}, grad norms "
            f"{[round(x, 4) for x in gnorms]}")
        if per_epoch != 4 or len(seen) != 2 * per_epoch:
            fail(f"expected 2 x 4 steps, ran {len(seen)}")
        if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
            fail("non-finite loss or grad norm")
        if sorted(hist) != ["0", "1"]:
            fail(f"history epochs {sorted(hist)}")
        e0, e1 = hist["0"], hist["1"]
        log(f"train {fusion}: epoch 0 loss {e0['train_loss']:.4f} "
            f"({e0['steps_per_sec']:.3f} steps/s), epoch 1 loss "
            f"{e1['train_loss']:.4f} ({e1['steps_per_sec']:.3f} steps/s)  "
            f"[{card}]")
        if not e1["train_loss"] < e0["train_loss"]:
            fail("the mean train loss did not fall from epoch 0 to 1")
        for e in (e0, e1):
            if "CIDEr" not in e.get("val", {}):
                fail("validation entry without CIDEr")
        log(f"val {fusion}: epoch 0 {json.dumps(e0['val'])}; epoch 1 "
            f"{json.dumps(e1['val'])}")
        for d in ("best", "last"):
            if not os.path.exists(os.path.join(trainer.workdir, d,
                                               "params.pt")):
                fail(f"no {d} checkpoint")
        if min(launches.values()) < 1:
            fail(f"a kernel of the training path was not launched: {launches}")
        log(f"train {fusion}: launches {launches}")
        res["launches"] = launches
        res["steps_per_sec"] = [e0["steps_per_sec"], e1["steps_per_sec"]]
        res["xe_f32"] = check_xe_step(torch, trainer, cfg, *swap)
        res["step_ms"] = step_breakdown(torch, trainer, card)
    return res


def att_kernel_entries(res, rec, launches, train):
    """The four attention kernels' entries of the ``kernels`` line."""
    bf, bb, bt = att_decode_work(B * K, 2, B * K * T * 4 + B * K * 4)
    bf32 = att_decode_work(B * K, 4, B * K * T * 4 + B * K * 4)
    sf, sb, st = att_decode_work(B, 2, 3 * B * T * 4)
    sf32 = att_decode_work(B, 4, 3 * B * T * 4)
    (ff, fb, ft), (gf, gb, gt) = att_rec_work(R_XE, T_XE, 2)
    (ff32, fb32, _), (gf32, gb32, _) = att_rec_work(R_XE, T_XE, 4)
    common = {"route": "cuda", "library_ms": None,
              "library": "none (no single call)", "dtype": "bfloat16"}
    dec = dict(common, tolerance=ATT_TOLERANCE)
    out = []
    for name, src, line, key, n, (fl, by, th), f32w in (
            ("attlstm_beam", "lstm_beam.cu", "pallas_beam.py:649", "beam",
             launches["beam"], (bf, bb, bt), bf32),
            ("attlstm_sample", "lstm_sample.cu", "pallas_sampler.py:643",
             "sample", launches["greedy"], (sf, sb, st), sf32)):
        bound, by_what = bound_ms(fl, by, H100_BF16_FLOPS)
        out.append(dict(
            dec, name=name,
            source=f"cst_captioning_torch/csrc/{src}",
            replaces=f"{REFERENCE}/ops/{line}", launches=n,
            max_abs_err=res[f"{key}_bf16_err"], ms=res[f"{key}_ms_bf16"],
            plain_ms=res[f"{key}_plain_ms_bf16"], bound_ms=bound,
            bound_by=by_what, sfu_floor_ms=sfu_floor_ms(th),
            bf16_order_witness=res["order_witness"],
            max_abs_err_f32=res[f"{key}_f32_err"],
            ms_f32=res[f"{key}_ms_f32"],
            plain_ms_f32=res[f"{key}_plain_ms_f32"],
            bound_ms_f32=bound_ms(f32w[0], f32w[1], H100_F32_FLOPS)[0]))
    out[1]["train_launches"] = train["launches"]["attlstm_sample"]
    rec_common = dict(common, tolerance=ATT_TOL_TEXT,
                      source="cst_captioning_torch/csrc/attlstm_recurrence.cu")
    fbound, fby = bound_ms(ff, fb, H100_BF16_FLOPS)
    out.append(dict(
        rec_common, name="attlstm_recurrence",
        replaces=f"{REFERENCE}/ops/pallas_attlstm.py:544",
        launches=train["launches"]["attlstm_recurrence"],
        max_abs_err=rec["bf16_err"], ms=rec["ms_bf16"],
        plain_ms=rec["plain_ms_bf16"], bound_ms=fbound, bound_by=fby,
        sfu_floor_ms=sfu_floor_ms(ft), max_abs_err_f32=rec["f32_err"],
        ms_f32=rec["ms_f32"], plain_ms_f32=rec["plain_ms_f32"],
        bound_ms_f32=bound_ms(ff32, fb32, H100_F32_FLOPS)[0],
        ms_no_residuals=rec["ms_nores_bf16"],
        ms_no_residuals_f32=rec["ms_nores_f32"],
        grad_rel_f32=rec["grad_rel"],
        xe_step_f32_vs_plain=train["xe_f32"],
        train_steps_per_sec=train["steps_per_sec"],
        xe_step_ms=train["step_ms"]))
    gbound, gby = bound_ms(gf, gb, H100_BF16_FLOPS)
    out.append(dict(
        rec_common, name="attlstm_recurrence_bwd",
        replaces=f"{REFERENCE}/ops/pallas_attlstm.py:578",
        launches=train["launches"]["attlstm_recurrence_bwd"],
        max_abs_err=rec["bwd_bf16_err"], ms=rec["bwd_ms_bf16"],
        plain_ms=rec["bwd_plain_ms_bf16"], bound_ms=gbound, bound_by=gby,
        sfu_floor_ms=sfu_floor_ms(gt), max_abs_err_f32=rec["bwd_f32_err"],
        grad_rel_f32=rec["bwd_grad_rel"], bf16_ulps=rec["bwd_bf16_ulps"],
        max_abs_err_note="backward kernel vs plain on the same residuals, "
                         "over the seven cotangents",
        ms_f32=rec["bwd_ms_f32"], plain_ms_f32=rec["bwd_plain_ms_f32"],
        bound_ms_f32=bound_ms(gf32, gb32, H100_F32_FLOPS)[0],
        ms_note="includes the three weight contractions done outside the "
                "kernel (torch.matmul), as the reference's _vjp_bwd"))
    return out


# ------------------------------------------------------------ main

def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    try:
        from cst_captioning_torch.ops import _build
        from cst_captioning_torch.ops import attlstm as att_mod
        from cst_captioning_torch.ops import beam as beam_mod
        from cst_captioning_torch.ops import lstm as lstm_mod
        from cst_captioning_torch.ops import sampler as sam_mod
    except ImportError as e:
        fail(f"cannot import cst_captioning_torch ({e}); run from the repo root")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    res = check_kernels(torch, beam_mod, sam_mod)
    rec = check_recurrence(torch, lstm_mod)
    ares = check_att_decoders(torch, beam_mod, sam_mod)
    arec = check_att_recurrence(torch, att_mod)
    launches = check_engine(torch, {"beam": beam_mod.lstm_beam,
                                    "greedy": sam_mod.lstm_sample},
                            "meanpool")
    alaunches = check_engine(torch, {"beam": beam_mod.attlstm_beam,
                                     "greedy": sam_mod.attlstm_sample},
                             "attention")
    train = check_training(
        torch, card, "meanpool",
        {"lstm_recurrence": lstm_mod.lstm_recurrence,
         "lstm_sample": sam_mod.lstm_sample},
        ("lstm_recurrence", plain_recurrence(torch, lstm_mod)))
    atrain = check_training(
        torch, card, "attention",
        {"attlstm_recurrence": att_mod.attlstm_recurrence,
         "attlstm_recurrence_bwd": att_mod.attlstm_recurrence_bwd,
         "attlstm_sample": sam_mod.attlstm_sample},
        ("attlstm_recurrence", plain_att_recurrence(torch, att_mod)))

    beam_flops, beam_bytes = decode_work(B * K, 2, B * K * T * 4 + B * K * 4)
    samp_flops, samp_bytes = decode_work(B, 2, 3 * B * T * 4)
    bb, bb_by = bound_ms(beam_flops, beam_bytes, H100_BF16_FLOPS)
    sb, sb_by = bound_ms(samp_flops, samp_bytes, H100_BF16_FLOPS)
    rb, rb_by = bound_ms(*rec_work(R_XE, T_XE, 2), H100_BF16_FLOPS)
    kernels = [
        {"name": "lstm_beam", "route": "cuda",
         "source": "cst_captioning_torch/csrc/lstm_beam.cu",
         "replaces": f"{REFERENCE}/ops/pallas_beam.py:687",
         "launches": launches["beam"], "max_abs_err": res["beam_bf16_err"],
         "ms": res["beam_ms_bf16"], "plain_ms": res["beam_plain_ms_bf16"],
         "bound_ms": bb, "bound_by": bb_by, "library_ms": None,
         "max_abs_err_f32": res["beam_f32_err"], "tolerance": TOLERANCE,
         "dtype": "bfloat16", "ms_f32": res["beam_ms_f32"],
         "plain_ms_f32": res["beam_plain_ms_f32"],
         "bound_ms_f32": bound_ms(beam_flops, beam_bytes, H100_F32_FLOPS)[0],
         "chaos_witness_f32": res["chaos"]},
        {"name": "lstm_sample", "route": "cuda",
         "source": "cst_captioning_torch/csrc/lstm_sample.cu",
         "replaces": f"{REFERENCE}/ops/pallas_sampler.py:682",
         "launches": launches["greedy"], "max_abs_err": res["sample_bf16_err"],
         "ms": res["sample_ms_bf16"], "plain_ms": res["sample_plain_ms_bf16"],
         "bound_ms": sb, "bound_by": sb_by, "library_ms": None,
         "max_abs_err_f32": res["sample_f32_err"], "tolerance": TOLERANCE,
         "dtype": "bfloat16", "ms_f32": res["sample_ms_f32"],
         "plain_ms_f32": res["sample_plain_ms_f32"],
         "bound_ms_f32": bound_ms(samp_flops, samp_bytes, H100_F32_FLOPS)[0]},
        {"name": "lstm_recurrence", "route": "cuda",
         "source": "cst_captioning_torch/csrc/lstm_recurrence.cu",
         "replaces": f"{REFERENCE}/ops/pallas_lstm.py:172",
         "launches": train["launches"]["lstm_recurrence"],
         "max_abs_err": rec["bf16_err"], "ms": rec["ms_bf16"],
         "plain_ms": rec["plain_ms_bf16"], "bound_ms": rb, "bound_by": rb_by,
         "library_ms": rec["library_ms_bf16"],
         "library": "torch.nn.LSTM (cuDNN) on the same gates, plus its "
                    "identity input GEMM",
         "max_abs_err_f32": rec["f32_err"], "tolerance": REC_TOLERANCE,
         "dtype": "bfloat16", "ms_f32": rec["ms_f32"],
         "plain_ms_f32": rec["plain_ms_f32"],
         "bound_ms_f32": bound_ms(*rec_work(R_XE, T_XE, 4), H100_F32_FLOPS)[0],
         "library_ms_f32": rec["library_ms_f32"],
         "ms_no_cell": rec["ms_nocell_bf16"],
         "ms_no_cell_f32": rec["ms_nocell_f32"],
         "plain_bwd_ms": rec["plain_bwd_ms_bf16"],
         "grad_rel_f32": rec["grad_rel"],
         "xe_step_f32_vs_plain": train["xe_f32"],
         "train_steps_per_sec": train["steps_per_sec"],
         "train_launches_lstm_sample": train["launches"]["lstm_sample"],
         "xe_step_ms": train["step_ms"]},
    ]
    kernels += att_kernel_entries(res=ares, rec=arec, launches=alaunches,
                                  train=atrain)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
