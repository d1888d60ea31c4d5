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
3. Serve: ``CaptionServer`` on an ephemeral port with the
   ``msrvtt_serve_beam5`` preset, ``--serving.continuous false``,
   random-init weights and a generated 10,492-word vocabulary; a few
   concurrent ``POST /v1/caption`` requests in beam mode, then in greedy
   mode.  Captions must come back, ``/metrics`` must carry the latency
   histograms, and each kernel's launch count — zeroed just before its
   mode's requests — must rise.
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
TOLERANCE = ("f32: tokens exact, |score or logprob diff| <= 1e-3 "
             "(max_abs_err_f32); bf16: caption match >= 0.95, score rtol "
             "<= 1e-3; max_abs_err is the bf16 |score diff| (sampler: "
             "summed log-probs) over matching captions")

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

def hold_f32(torch, beam_mod, sam_mod, vals, what: str, *, k: int, t: int,
             seed=(123, 456), temperature: float = 1.0,
             suppress_unk: bool = False):
    """float32 kernel vs plain version on ``vals`` (card tensors): beam,
    greedy and multinomial tokens (and the sampler's mask) exact, scores
    and log-probs within ``F32_ATOL``.  Returns (beam err, sample err,
    beam seqs)."""
    b = vals[0].shape[0]
    kw = dict(max_len=t, suppress_unk=suppress_unk)
    ks, kc = beam_mod.lstm_beam(*vals, beam_size=k, **kw)
    rs, rc = beam_mod.lstm_beam_ref(*vals, beam_size=k, **kw)
    torch.cuda.synchronize()
    bad = int((ks != rs).any(-1).sum())
    beam_err = float((kc - rc).abs().max())
    log(f"{what}: lstm_beam f32 mismatching beams {bad}/{b * k}, "
        f"max |score diff| {beam_err:.3e}")
    if bad or beam_err > F32_ATOL:
        fail(f"{what}: lstm_beam float32 disagrees with its plain version")
    sam_err = 0.0
    for greedy in (True, False):
        kt, kl, km = sam_mod.lstm_sample(*vals, seed, greedy=greedy,
                                         temperature=temperature, **kw)
        rt, rl, rm = sam_mod.lstm_sample_ref(*vals, seed, greedy=greedy,
                                             temperature=temperature, **kw)
        torch.cuda.synchronize()
        bad = int((kt != rt).any(-1).sum())
        err = float((kl - rl).abs().max())
        mode = "greedy" if greedy else "multinomial"
        log(f"{what}: lstm_sample f32 {mode} mismatching rows {bad}/{b}, "
            f"max |logprob diff| {err:.3e}")
        if bad or err > F32_ATOL or not torch.equal(km, rm):
            fail(f"{what}: lstm_sample float32 {mode} disagrees with its "
                 f"plain version")
        sam_err = max(sam_err, err)
    return beam_err, sam_err, rs


def check_kernels(torch, beam_mod, sam_mod):
    from cst_captioning_torch.decoding.beam import finalize_beams

    base = make_inputs(torch, 0)
    res = {}

    # float32: exact tokens.
    a32 = to_card(torch, base, torch.float32)
    vals = list(a32.values())
    res["beam_f32_err"], res["sample_f32_err"], _ = hold_f32(
        torch, beam_mod, sam_mod, vals, "main shape", k=K, t=T)
    check_edge_shapes(torch, beam_mod, sam_mod)
    check_saturated(torch, beam_mod, sam_mod)
    res["chaos"] = chaos_witness(torch, beam_mod)

    # bfloat16 (the serving preset's compute dtype).
    a16 = to_card(torch, base, torch.bfloat16)
    v16 = list(a16.values())
    kb = finalize_beams(*beam_mod.lstm_beam(*v16, beam_size=K, max_len=T))
    rb = finalize_beams(*beam_mod.lstm_beam_ref(*v16, beam_size=K, max_len=T))
    res["beam_bf16_err"] = bf16_check(
        "lstm_beam bf16", kb.tokens, rb.tokens, kb.score, rb.score)
    res["sample_bf16_err"] = 0.0
    for greedy, seed in ((True, (0, 0)), (False, (123, 456))):
        kt, kl, _ = sam_mod.lstm_sample(*v16, seed, max_len=T, greedy=greedy)
        rt, rl, _ = sam_mod.lstm_sample_ref(*v16, seed, max_len=T, greedy=greedy)
        mode = "greedy" if greedy else "multinomial"
        res["sample_bf16_err"] = max(res["sample_bf16_err"], bf16_check(
            f"lstm_sample bf16 {mode}", kt, rt, kl.sum(-1), rl.sum(-1)))

    # Times at the main path's dtype (bf16) and at f32, kernel vs plain.
    for tag, args in (("bf16", v16), ("f32", vals)):
        res[f"beam_ms_{tag}"] = time_call(
            torch, lambda: beam_mod.lstm_beam(*args, beam_size=K, max_len=T), REPS)
        res[f"beam_plain_ms_{tag}"] = time_call(
            torch, lambda: beam_mod.lstm_beam_ref(*args, beam_size=K, max_len=T), 1)
        res[f"sample_ms_{tag}"] = time_call(
            torch, lambda: sam_mod.lstm_sample(*args, (0, 0), max_len=T, greedy=True), REPS)
        res[f"sample_plain_ms_{tag}"] = time_call(
            torch, lambda: sam_mod.lstm_sample_ref(*args, (0, 0), max_len=T, greedy=True), 1)
        log(f"times {tag}: lstm_beam {res[f'beam_ms_{tag}']:.3f} ms "
            f"(plain {res[f'beam_plain_ms_{tag}']:.3f} ms), lstm_sample greedy "
            f"{res[f'sample_ms_{tag}']:.3f} ms (plain {res[f'sample_plain_ms_{tag}']:.3f} ms)")
    for name, fn in (
        ("lstm_beam", lambda: beam_mod.lstm_beam(*v16, beam_size=K, max_len=T)),
        ("lstm_sample", lambda: sam_mod.lstm_sample(*v16, (0, 0), max_len=T,
                                                     greedy=True)),
    ):
        for kname, ms, count in kernel_breakdown(torch, fn):
            log(f"breakdown bf16 {name}: {kname} {ms:.3f} ms over {count} launches")
    return res


def check_edge_shapes(torch, beam_mod, sam_mod):
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
        _, _, rs = hold_f32(torch, beam_mod, sam_mod, args, what, k=k, t=t,
                            seed=(b, v), temperature=temp, suppress_unk=unk)
        log(f"{what}: eos-finished beam rows {int((rs == 2).any(-1).sum())}")


def check_saturated(torch, beam_mod, sam_mod):
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
    hold_f32(torch, beam_mod, sam_mod,
             list(to_card(torch, a, torch.float32).values()),
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


def bf16_check(what: str, k_tok, r_tok, k_score, r_score) -> float:
    """Kernel vs plain version in bfloat16: the share of captions (rows
    of token ids) that match must reach the kernel floor, and on the
    matching ones the score's relative gap must stay within its bound;
    both are tighter than the reference's relaxed-serving tier.  Returns
    the max absolute score gap over the matches."""
    same = (k_tok == r_tok).all(-1)
    match = float(same.float().mean())
    if not bool(same.any()):
        fail(f"{what}: no caption matches its plain version")
    gap = (k_score - r_score)[same].abs()
    rtol = float((gap / r_score[same].abs().clamp_min(1e-6)).max())
    log(f"{what}: caption match {match:.4f}, max score rtol {rtol:.3e}")
    if match < RELAXED_SERVING_MATCH_FLOOR or rtol > RELAXED_SERVING_SCORE_RTOL:
        fail(f"{what} outside the relaxed-serving tier")
    if match < KERNEL_BF16_MATCH_FLOOR or rtol > KERNEL_BF16_SCORE_RTOL:
        fail(f"{what} outside the kernel tier (match >= "
             f"{KERNEL_BF16_MATCH_FLOOR}, rtol <= {KERNEL_BF16_SCORE_RTOL})")
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


# ------------------------------------------------------------ phase 3

def post(url: str, payload) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def serve_mode(torch, mode: str, params, vocab, counter_fn, reset_fn):
    """Boot the ladder server in ``mode``, POST concurrent requests,
    return (launches, responses, metrics text, stats)."""
    from cst_captioning_torch.config import parse_cli
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    cfg = parse_cli([
        "--preset", "msrvtt_serve_beam5", "--serving.continuous", "false",
        "--serving.port", "0", "--serving.decode_mode", mode,
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


def check_engine(torch, beam_mod, sam_mod):
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config

    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    cfg = get_preset("msrvtt_serve_beam5")
    cfg.model.vocab_size = len(vocab)
    model = model_from_config(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(cfg.train.seed))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    res = {}
    for mode, fn in (("beam", beam_mod.lstm_beam),
                     ("greedy", sam_mod.lstm_sample)):
        def reset(fn=fn):
            fn.launches = 0

        launches, out, metrics, stats, wall = serve_mode(
            torch, mode, params, vocab, lambda fn=fn: fn.launches, reset)
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
            fail(f"{mode}: the kernel was not launched on the serving path")
        lat = stats["latency_ms"]
        log(f"serve {mode}: {N_REQUESTS} requests in {wall:.3f} s, "
            f"batches {stats['batches']}, launches {launches}, device p50 "
            f"{lat['device']['p50_ms']} ms, total p50 {lat['total']['p50_ms']} ms")
        log(f"serve {mode}: first caption {out[0]['caption'][:80]!r}")
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


def check_xe_step(torch, lstm_mod, trainer, cfg):
    """One XE step at float32 on the trained weights and one training
    batch: loss and gradients through the kernel vs through the plain
    recurrence (the same dropout draw)."""
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
    kernel = captioner.lstm_recurrence
    captioner.lstm_recurrence = plain_recurrence(torch, lstm_mod)
    try:
        p_loss, p_grads = loss_and_grads()
    finally:
        captioner.lstm_recurrence = kernel
    loss_rtol = abs(k_loss - p_loss) / abs(p_loss)
    gap = float(global_norm([a - b for a, b in zip(k_grads, p_grads)])
                / global_norm(p_grads))
    log(f"XE step f32 kernel vs plain: loss {k_loss:.6f} vs {p_loss:.6f} "
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
             "backward (autograd; plain recurrence backward)", "optimizer")

    def one_step(ev=None):
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        mark(0)
        cache = _repeat_cache(model._encode(b.feats, b.feat_masks), S)
        mark(1)
        h_seq = model._fused_forward(cache, inputs)
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
        log(f"XE step bf16 part: {name} {out[name]:.3f} ms  [{card}]")
    total = ev[0].elapsed_time(ev[6])
    log(f"XE step bf16 total {total:.3f} ms  [{card}]")
    out["total"] = total
    for kname, ms, count in kernel_breakdown(torch, one_step)[:15]:
        log(f"breakdown XE step bf16: {kname} {ms:.3f} ms over {count} "
            f"launches")
    return out


def check_training(torch, lstm_mod, sam_mod, card: str):
    """Phase 4 (see module docstring).  Returns the launch counts of the
    training run and the readings."""
    import numpy as np

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.training.trainer import Trainer

    cfg = get_preset("msrvtt_resnet_c3d_xe")
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
        lstm_mod.lstm_recurrence.launches = 0
        sam_mod.lstm_sample.launches = 0
        t0 = time.perf_counter()
        hist = trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"lstm_recurrence": lstm_mod.lstm_recurrence.launches,
                    "lstm_sample": sam_mod.lstm_sample.launches}
        trainer._train_step = inner
        losses = [float(x["loss"]) for x in seen]
        gnorms = [float(x["grad_norm"]) for x in seen]
        per_epoch = trainer.train_iter.num_batches()
        log(f"train: {len(seen)} steps ({per_epoch} per epoch) in "
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
        log(f"train: epoch 0 loss {e0['train_loss']:.4f} "
            f"({e0['steps_per_sec']:.3f} steps/s), epoch 1 loss "
            f"{e1['train_loss']:.4f} ({e1['steps_per_sec']:.3f} steps/s)  "
            f"[{card}]")
        if not e1["train_loss"] < e0["train_loss"]:
            fail("the mean train loss did not fall from epoch 0 to 1")
        for e in (e0, e1):
            if "CIDEr" not in e.get("val", {}):
                fail("validation entry without CIDEr")
        log(f"val: epoch 0 {json.dumps(e0['val'])}; epoch 1 "
            f"{json.dumps(e1['val'])}")
        for d in ("best", "last"):
            if not os.path.exists(os.path.join(trainer.workdir, d,
                                               "params.pt")):
                fail(f"no {d} checkpoint")
        if min(launches.values()) < 1:
            fail(f"a kernel of the training path was not launched: {launches}")
        log(f"train: launches {launches}")
        res["launches"] = launches
        res["steps_per_sec"] = [e0["steps_per_sec"], e1["steps_per_sec"]]
        res["xe_f32"] = check_xe_step(torch, lstm_mod, trainer, cfg)
        res["step_ms"] = step_breakdown(torch, trainer, card)
    return res


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
    launches = check_engine(torch, beam_mod, sam_mod)
    train = check_training(torch, lstm_mod, sam_mod, card)

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
