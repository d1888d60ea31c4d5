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
   (see ``chaos_witness``).  bf16 beam and greedy are also held pooled
   over four seeds, at the floor and no more than 0.05 below a bf16
   order witness: the plain version's captions on the model with its
   hidden and embedding units permuted, against its own
   (``meanpool_order_witness``; kernel vs permuted kernel and the
   witness's score rtol reported).  The bf16 calls run the tensor-core
   chain: one call must show 3 x T launches of the port's kernels in
   the profiler, and the first 1, 13 and 33 videos decoded alone must
   give bitwise the outputs of the same videos in the B = 64 call
   (``row_invariance``).  TF32 is off for the float32 phases.  Each
   kernel (5 calls) and its plain version (1 call) are timed with CUDA
   events after a warm-up call, and the multinomial sampler also at the
   CST rollout's 1,280 rows (``rollout_times``, a reading).
2b. Hold the ``lstm_recurrence`` kernel (the XE/WXE teacher-forced
   recurrence) against its plain version at the training shape (R =
   64 x 20 caption rows, T=29, H=512): forward, gradients through the
   autograd Function, and a saturated-gate case (``check_recurrence``
   states the tolerances).  Time it (bf16 and f32, with and without the
   cell output), its plain version, and cuDNN's LSTM on the same gates
   as the library yardstick.  One bf16 call must show exactly one launch
   of the recurrence kernel in the profiler's breakdown; its cluster
   plan and an order witness (the plain version with its product summed
   exactly, against the plain version: what the bf16 cell moves under
   any other order, reported, not held) are printed.
2c. Hold the attention decode kernels ``attlstm_beam`` and
   ``attlstm_sample`` against their plain versions at the same shape with
   attention fusion (F = 2 x 28 frames, A = 512), every video with a
   random valid-frame count per modality and one with all its frames
   masked (``make_att_inputs``): float32 tokens exact with scores /
   log-probs within 1e-3, bfloat16 at the attention kernel tier on seed
   0 and, beam and greedy, pooled over four seeds, with an order witness
   (``att_order_witness``); timed as phase 2.  The bf16 calls run the
   tensor-core chain: one call must show 5 x T launches of the port's
   kernels in the profiler, and the row invariance of phase 2 must hold.
   The multinomial sampler is also timed at the CST rollout's 1,280 rows
   (a reading).
2d. Hold the ``attlstm_recurrence`` forward and backward kernels against
   their plain versions at the attention XE shape (R = 1280 caption rows
   over 64 videos, rep = 20, the attention tensors per video with masked
   tails and video 0 all masked; T = 29, F = 56, E = H = A = 512):
   float32 h_seq, c_seq and the softmax weights, the backward kernel on
   the same residuals, all eight gradients through the autograd
   Function, bfloat16 h_seq and the bfloat16 backward kernel on the same
   residuals (``check_att_recurrence`` states the tolerances).  rep = 20
   against rep = 1 on the repeated tensors: the forward bitwise (kernel
   and plain, both dtypes); the backward's per-video d_proj / d_vals
   bitwise the rep = 1 rows folded in row order, f32 within 1e-5 of max
   of the plain gathered fold, bf16 within one ulp of the float64-exact
   fold (the reference's own order reported beside it).  The same checks
   off the main shape (``ATT_EDGE_SHAPES``: 3 videos x 7 captions, T = 3;
   T = 1).  The bf16 tanh table bitwise ``tanhf`` on all 65,536 bf16
   values.  An order witness
   (the plain forward and backward with exact products) is reported.
   Timed in both dtypes, at rep = 20 and on the repeated tensors; the
   profiler's launch count of one bf16 call held at 3T - 1 (forward)
   and 4T + 3 (backward).
2e. Hold the ``fused_context_attention`` kernel (the continuous slot
   loop's per-step attention context) against its plain version at F =
   56 (masked frame tails, one all-masked video), A = E = 512: R = 320
   rows over 64 videos at rep = 5 (a beam slot's K rows read one stored
   copy) and R = 64 at rep = 1 (greedy), in f32 and bf16 (``CTX_*``
   state the tolerances); rep = 5 must be bitwise the gathered layout.
   Timed (5 calls) by the event clock and by the profiler's device time
   (a window that recorded every launch), with the gathered layout at R
   = 320; one bf16 call must show exactly one kernel launch in the
   profiler.  The same checks off the main
   shapes
   (``CTX_EDGE_SHAPES``: one video; 3 videos x 7 rows over 7 frames at
   A = 264, E = 40; the smallest bank, R = 40).
2f. Hold ``row_gemm`` (``ops/rowgemm.py::row_dot``, the row-invariant
   product of the per-step decode and the admission encode) at the
   slot loop's products, for each operand case the path gives it (f32;
   bf16 W with f32 x, the encode; bf16 W and x, every bf16 decode
   step): every prefix of a 640-row call bitwise equal to the full
   call, values within ``RG_RTOL`` of cuBLAS; report how many rows
   cuBLAS itself changes with the call's row count.  Each operand case
   of each product timed at R = 320 beside ``torch.matmul`` on the same
   operands, by the profiler's device time (the event clock reads the
   host's enqueue at these sizes, so it is printed beside).  The int8-W
   path (int8w serving) the same way, for f32 and
   bf16 compute, bitwise the float path on the widened codes times the
   scale and within ``RG_RTOL`` of cuBLAS on the dequantized weights.
2g. Hold the ``fused_context_attention`` backward kernel (the context
   gradient of scheduled-sampling training) against its plain version at
   the training shape: R = 1280 caption rows over 64 videos (rep = 20),
   F = 56 with masked tails and one all-masked video, A = E = 512, on
   the forward kernel's own softmax weights; float32 and bfloat16
   (``CTXB_*`` state the tolerances); rep = 20 against the gathered
   layout (d_proj and d_vals folded in row order, as the kernel folds
   them: d_q, d_proj and d_vals bitwise).  Timed in both dtypes (5
   calls, event clock and profiler device time), with the plain backward
   (1 call) and the forward at the same shape; one bf16 call must show
   exactly two kernel launches in the profiler.  The same checks off the
   main shape (``CTXB_EDGE_SHAPES``: one video; 3 videos x 7 rows over 7
   frames at A = 264, E = 40; two videos of 20 rows).
2h. Hold the int8w decoders (the four fused decode kernels with
   ``quant=``) against their plain versions at phase 2's and 2c's shapes,
   on those weights quantized by ``quantize_params``: float32 compute
   tokens exact with scores / log-probs within 1e-3, bfloat16 compute at
   the float kernels' tiers (the attention decoders' launches per call
   held as in 2c); a V = 1,100 vocab (streamed tiles and a padded tail)
   at float32, no token in the padding.  Timed as phase 2; the bf16
   calls' launches held as in phase 2 and 2c.
2i. Hold the int8w recurrences (``lstm_recurrence_quant``,
   ``attlstm_recurrence_quant``) against their plain versions at R =
   1280, T = 29 (F = 56, the attention tensors per video at rep = 20,
   bitwise rep = 1 on the repeated tensors): float32 h_seq within 2b /
   2d's bound, bfloat16 within one bf16 ulp at |h| < 1 and two ulps past
   1e-3 x max |h|.  Timed.
3. Serve: ``CaptionServer`` on an ephemeral port with the
   ``msrvtt_serve_beam5`` preset, ``--serving.continuous false``,
   random-init weights and a generated 10,492-word vocabulary; a few
   concurrent ``POST /v1/caption`` requests in beam mode, then in greedy
   mode.  Captions must come back, ``/metrics`` must carry the latency
   histograms, and each kernel's launch count — zeroed just before its
   mode's requests — must rise.
3b. The same with ``--model.feature_fusion attention``: the
   ``attlstm_beam`` and ``attlstm_sample`` launch counts must rise.
3c. Continuous serving: ``msrvtt_serve_beam5`` with its defaults (the
   slot loop, 64 slots on the elastic bank ladder 8-64, one step per
   tick, bf16), each fusion, beam and greedy: 96 requests at once, then
   32 arrivals 20 ms apart, every one answered; the bank must resize,
   ``fused_context_attention`` launches must equal the attention decode
   steps (0 under meanpool) and ``row_dot`` must launch.  bf16 served
   captions are compared with the offline per-step decode and the
   ladder's fused kernels at the relaxed-serving tier; then two f32
   runs (``--model.compute_dtype float32``) in two arrival orders must
   give the same tokens, equal to the offline per-step decode on every
   request, and agree with the ladder's fused kernels to within
   ``SERVE_LADDER_F32_SLACK`` captions (or an order witness) with score
   rtol <= 1e-6.  Prints the stage latencies, the front end's host work
   per request (``front_end_cost``) and a per-step profile of a full
   bank (``slot_breakdown``).
3d. int8w and bf16 serving: the ladder with ``--serving.dtype int8w``,
   each fusion and mode, where the int8w decoders' launch counts must
   rise; the continuous default with ``--serving.dtype int8w`` after each
   3c case (``check_int8w_continuous``): int8 ``row_dot`` launches,
   ``describe()`` weight bytes equal to the closed form, served captions
   vs the same engine's offline per-step decode at the relaxed-serving
   tier and vs the f32 engine at that tier or an int8w-ladder witness,
   and two runs at float32 compute in two arrival orders equal to the
   offline per-step decode; one ``--serving.dtype bf16`` run (meanpool
   beam) equal to 3c's bf16 run; and the teacher-forced forward of an
   int8w model at the XE shape through the int8w recurrences (one launch
   each, f32-compute logits kernel vs plain within 1e-5).
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
4c. Scheduled sampling: the attention run of 4b with
   ``--model.scheduled_sampling_start 0``, ``increase_every 1`` and
   ``increase_prob 0.25``: epoch 0 (``ss_prob`` 0) trains through the
   fused recurrence, epoch 1 (0.25) through the model's per-step loop.
   Losses finite, checkpoints written, the ``fused_context_attention``
   forward and backward launches exactly T x 4 in epoch 1 and none in
   epoch 0, the share of rows fed a sample at t >= 1 within 5 binomial
   sigmas of 0.25.  Then one float32 step on the per-step path
   (``ss_prob`` a tensor 0, no dropout) through the kernels vs through
   the plain context step (loss rtol <= 1e-5, gradient gap <= 1e-4) and
   vs the fused ``attlstm_recurrence`` step (the same function summed in
   another order; the same bounds), and a per-part bf16 step breakdown.
5. CST (the main path's stage 3): the ``msrvtt_cst_ms_scb`` preset at
   full width (S = 20 rollouts of 64 videos, 1,280 rows, T = 30, the
   SCB baseline, the weighted 20-ref CIDEr-D reward on the native
   scorer, which must be the one built), warm-started from phase 4's
   meanpool ``best``, on phase 4's corpus.  One warm-up step, then 3
   timed steps of the trainer's split step: each phase's host ms
   (``phase_ms``), the device ms of the rollout chunks and of the update
   (CUDA events), the host scoring, and the wall time against the
   serial sum.  Launches held exactly: per step K = 4 ``lstm_sample``
   (the rollout chunks), 1 ``lstm_recurrence`` and 2 + K ``row_gemm``
   (the encode and the chunks' static gates); one step with a greedy
   baseline adds K greedy ``lstm_sample`` and K ``row_gemm``.  Held
   too: the native scorer's rewards on the card's tokens are the step's
   reward and agree with the Python scorer within rtol 1e-5 / atol 1e-6
   (the reference's tier for the pair); the f32 PG loss and gradients
   through the kernel vs the plain recurrence (phase 4's bounds); the
   parameters moved and are finite; ``overlap_rewards`` on, off and on
   again bitwise (deterministic algorithms on); the f32 rollout at R =
   1,280 kernel vs plain, token-exact.  Then one attention CST step
   (F = 56) from phase 4b's ``best``: K ``attlstm_sample``, 1
   ``attlstm_recurrence``, 1 backward and 3 ``row_gemm`` launches.
6. Print one JSON line of per-kernel numbers (sixteen entries; the
   int8 row_gemm's readings join the row_gemm entry, phase 5's launches
   and readings the entries of the kernels it ran), the card line
   again, then, as the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
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
DEVICE = "cuda"    # phases 2b, 2d-2i, 3-3d, 4-4c (a CPU rehearsal may point it elsewhere)
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


PROFILE_WINDOWS = 6  # profiler windows tried before a count fails


def profiled(torch, fn, reps: int, launches=None):
    """[(kernel name, device ms a call, launches a call)] from one
    profiler window of ``reps`` calls of ``fn`` (after a warm-up call, and
    a warm-up step of the profiler's own before the window).  The
    profiler now and then leaves launches at a window's start unrecorded
    (a window of five short calls has read none), so with ``launches``
    (the port's kernels, ``cstk::``, that one call launches) a window
    counts only if it recorded exactly ``reps * launches`` of them: more
    fails at once, fewer tries another window, and PROFILE_WINDOWS
    windows without the count fail.  Without ``launches`` a window counts
    if it recorded any device time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_WINDOWS):
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.append(p.key_averages())
                     ) as prof:
            for _ in range(2):  # the warm-up step, then the window
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        rows = []
        for e in (got[0] if got else []):
            us = (getattr(e, "device_time_total", 0)
                  or getattr(e, "cuda_time_total", 0))
            if us:
                rows.append((kernel_name(e.key), us / 1e3 / reps,
                             e.count / reps))
        n = round(sum(c for k, _, c in rows if k.startswith("cstk::")) * reps)
        if launches is None and rows:
            return rows
        if launches is not None and n == reps * launches:
            return rows
        if launches is not None and n > reps * launches:
            fail(f"profiled: {n} of the port's kernel launches over {reps} "
                 f"calls, {launches} a call expected")
        seen.append(n)
    fail(f"profiled: no profiler window recorded the expected launches "
         f"({seen} of {reps} x {launches})")


def device_ms(torch, fn, reps: int, launches=None) -> float:
    """Mean milliseconds of device time per ``fn()`` call: the sum over
    every kernel the calls launched, from a window of ``profiled`` (with
    ``launches``, one that recorded every launch of the port's kernels).
    For calls shorter than their host work, where ``time_call`` reads the
    host's enqueue rate."""
    return sum(ms for _, ms, _ in profiled(torch, fn, reps, launches))


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


def permute_hidden(torch, a, perm, pe=None):
    """The same model with its hidden units reordered by ``perm`` (and,
    given ``pe``, its embedding units: ``emb``'s columns and ``w_x``'s
    rows): every output is the same in exact arithmetic, but the sums
    over H (and E) run in another order."""
    cols = torch.cat([perm + j * H for j in range(4)])
    rows = slice(None) if pe is None else pe
    return dict(gx_static=a["gx_static"][:, cols], w_x=a["w_x"][rows][:, cols],
                wh=a["wh"][perm][:, cols], emb=a["emb"][:, rows],
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


def bf16_and_times(torch, fns, v16, v32, floor: float, launches=None):
    """bfloat16 kernel vs plain version at the main shape (beam, greedy,
    multinomial; ``bf16_check`` with match ``floor``), then the kernel
    (REPS calls) and plain (1 call) times in bf16 and f32 and the bf16
    per-kernel breakdown; given ``launches``, the profiler's count of
    the port's kernels in one bf16 call is held at it.  Returns the
    readings."""
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
    res["launches_per_call_bf16"] = decode_breakdowns(
        torch, beam, sample, v16, launches)
    return res


def decode_breakdowns(torch, beam, sample, v16, want=None):
    """The bf16 per-kernel breakdown of one beam and one greedy call;
    given ``want``, each call's launches of the port's kernels are held
    at it (``att_launches``).  Returns those counts (None: not held)."""
    out = {}
    for fn, key, call in (
        (beam, "beam", lambda: beam(*v16, beam_size=K, max_len=T)),
        (sample, "greedy", lambda: sample(*v16, (0, 0), max_len=T,
                                          greedy=True)),
    ):
        if want is not None:
            out[key] = att_launches(torch, call, fn.__name__, want)
            continue
        for kname, ms, count in kernel_breakdown(torch, call):
            log(f"breakdown bf16 {fn.__name__}: {kname} {ms:.3f} ms over "
                f"{count} launches")
    return out or None


def meanpool_order_witness(torch, fns):
    """bf16 beam and greedy captions of the meanpool decoders over
    ATT_SEEDS, kernel vs plain version and each of them vs itself on the
    model with its hidden and embedding units permuted
    (``permute_hidden``): held as ``order_witness`` states, at
    KERNEL_BF16_MATCH_FLOOR."""
    def inputs(seed):
        g = torch.Generator().manual_seed(2000 + seed)
        ph, pe = torch.randperm(H, generator=g), torch.randperm(E, generator=g)
        a = make_inputs(torch, seed)
        return (list(to_card(torch, a, torch.bfloat16).values()),
                list(to_card(torch, permute_hidden(torch, a, ph, pe),
                             torch.bfloat16).values()))

    return order_witness(torch, fns, "meanpool", inputs,
                         KERNEL_BF16_MATCH_FLOOR)


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
    a16 = to_card(torch, base, torch.bfloat16)
    res.update(bf16_and_times(torch, fns, list(a16.values()), vals,
                              KERNEL_BF16_MATCH_FLOOR,
                              MEANPOOL_DEC_LAUNCHES))
    res["row_invariance"] = row_invariance(torch, fns, a16, "meanpool")
    res.update(rollout_times(torch, fns[2], a16))
    res["order_witness"] = meanpool_order_witness(torch, fns)
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
    empty when the profiler records no device time in three windows (it
    now and then records none for a window, as ``device_ms`` found)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = (getattr(e, "device_time_total", 0)
                  or getattr(e, "cuda_time_total", 0))
            if us:
                rows.append((kernel_name(e.key), us / 1e3, e.count))
        if rows:
            return sorted(rows, key=lambda r: -r[1])
    log("breakdown: not measured (the profiler recorded no device time in "
        "three windows)")
    return []


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
    res["launch_plan"] = lstm_mod.bf16_launch_plan(R_XE, H)
    log("lstm_recurrence bf16 launch: {} clusters x {} CTAs, {} rows per "
        "cluster".format(*res["launch_plan"]))
    rec_launches = 0
    # The largest of three readings (att_launches says why).
    rows = max((kernel_breakdown(torch, lambda: fwd(gx, wh16, with_cell=True))
                for _ in range(3)),
               key=lambda r: sum(c for k, _, c in r if "lstm_rec" in k))
    for kname, ms, count in rows:
        log(f"breakdown bf16 lstm_recurrence: {kname} {ms:.3f} ms over "
            f"{count} launches")
        if "lstm_rec" in kname:
            rec_launches += count
    if rec_launches != 1:
        fail(f"one bf16 lstm_recurrence call launched its kernel "
             f"{rec_launches} times in the profiler's breakdown (want 1)")
    res["launches_per_call_bf16"] = rec_launches
    res["order_witness_c_rel"] = exact_product_witness(torch, lstm_mod, gx,
                                                       wh16)
    return res


def exact_product_witness(torch, lstm_mod, gx, wh):
    """Reported, not held: how far the plain version's bf16 cell moves
    when only the order of its product changes, to the float64 sum
    rounded once (the most exact order there is): max |c diff| / max(|c|,
    1).  The kernel keeps the plain version's own order (one ascending-k
    fmaf chain, bitwise), so REC_BF16_C_RTOL is met by construction; this
    records what any other order, tensor-core sums included, would read."""
    from cst_captioning_torch.ops.rnn import gate_update

    R, T, _ = gx.shape
    cdt = wh.dtype
    whd = wh.double()
    h = torch.zeros((R, H), device=gx.device)
    c = torch.zeros_like(h)
    c_seq = torch.empty((R, T, H), device=gx.device)
    for t in range(T):
        h, c = gate_update(gx[:, t] + (h.to(cdt).double() @ whd).float(), c)
        c_seq[:, t] = c
    _, rc = lstm_mod.lstm_recurrence_ref(gx, wh, with_cell=True)
    rel = float(((c_seq - rc).abs() / rc.abs().clamp_min(1.0)).max())
    log(f"lstm_recurrence bf16 order witness (not held): the plain version "
        f"with its product summed exactly vs the plain version, max |c diff| "
        f"/ max(|c|, 1) {rel:.3e} (REC_BF16_C_RTOL {REC_BF16_C_RTOL:g})")
    return rel


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
# The bf16 decoders' launches of the port's kernels per call
# (csrc/decode_tc.cuh): per step the gate GEMM with the update, the vocab
# tile GEMM with its partials and the select; attention adds the query
# and the attention step before the gates.
MEANPOOL_DEC_LAUNCHES = 3 * T
ATT_DEC_LAUNCHES = 5 * T
# Videos decoded alone against the same videos of the B-video call: B'
# K and B' rows that fill no 64-row tile (R = 5, 65, 165 beam rows).
ATT_ROW_VIDEOS = (1, 13, 33)
# Caption rows of the CST rollout (64 videos x 20 samples), at which
# the multinomial sampler is timed beside R = B (a reading, not a check).
ROLLOUT_ROWS = R_XE
ATT_TOLERANCE = (decode_tolerance(KERNEL_ATT_BF16_MATCH_FLOOR)
                 + f" (seed 0, and beam / greedy pooled over "
                 f"{len(ATT_SEEDS)} seeds, there also >= plain vs permuted "
                 f"plain - {ATT_WITNESS_MARGIN:g}); attention inputs: one "
                 "video all-masked")
MEANPOOL_TOLERANCE = (TOLERANCE + f" (seed 0, and beam / greedy pooled over "
                      f"{len(ATT_SEEDS)} seeds, there also >= plain vs "
                      f"permuted plain - {ATT_WITNESS_MARGIN:g})")


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
    a16 = att_to_card(torch, base, torch.bfloat16)
    v16 = list(a16.values())
    res.update(bf16_and_times(torch, fns, v16, v32,
                              KERNEL_ATT_BF16_MATCH_FLOOR, ATT_DEC_LAUNCHES))
    res["row_invariance"] = row_invariance(torch, fns, a16, "attention")
    res.update(rollout_times(torch, fns[2], a16))
    res["order_witness"] = att_order_witness(torch, fns)
    return res


PER_VIDEO = ("gx_static", "att_proj", "att_mask", "att_vals")


def row_invariance(torch, fns, a16, fusion: str):
    """bf16: the first B' videos of ``a16`` (ATT_ROW_VIDEOS; either
    fusion's operands, the per-video ones cut to B') decoded alone give
    bitwise the beam seqs and scores and the greedy tokens and log-probs
    of the same videos in the B-video call: the tensor-core tiles' edges
    and the gate GEMM's split change no row."""
    beam, _, sample, _ = fns
    v16 = list(a16.values())
    full_b = beam(*v16, beam_size=K, max_len=T)
    full_g = sample(*v16, (0, 0), max_len=T, greedy=True)[:2]
    out = {}
    for nb in ATT_ROW_VIDEOS:
        sub = [x[:nb] if k in PER_VIDEO else x for k, x in a16.items()]
        got_b = beam(*sub, beam_size=K, max_len=T)
        got_g = sample(*sub, (0, 0), max_len=T, greedy=True)[:2]
        torch.cuda.synchronize()
        same = all(bool(torch.equal(x, y[:nb]))
                   for x, y in zip(got_b + got_g, full_b + full_g))
        out[str(nb)] = same
        log(f"{fusion} bf16 row invariance: the first {nb} videos alone "
            f"({nb * K} beam rows, {nb} greedy rows) bitwise the B={B} "
            f"call: {same}")
        if not same:
            fail(f"{fusion} bf16 decoders: {nb} videos alone differ from "
                 f"the same videos of the B={B} call")
    return out


def rollout_times(torch, sample, a16):
    """The bf16 multinomial sampler's (either fusion's) time at B = 64
    rows and at the CST rollout's ROLLOUT_ROWS (each video's operands
    repeated to its rows), with the per-kernel breakdown at the
    rollout's rows: readings."""
    rep = ROLLOUT_ROWS // B
    big = [x.repeat_interleave(rep, 0) if k in PER_VIDEO else x
           for k, x in a16.items()]
    v16 = list(a16.values())
    out = {}
    for tag, args in ((f"R{B}", v16), (f"R{ROLLOUT_ROWS}", big)):
        out[f"sample_multinomial_ms_{tag}"] = time_call(
            torch, lambda: sample(*args, (123, 456), max_len=T, greedy=False),
            REPS)
    log(f"times bf16: {sample.__name__} multinomial "
        f"{out[f'sample_multinomial_ms_R{B}']:.3f} ms at R={B}, "
        f"{out[f'sample_multinomial_ms_R{ROLLOUT_ROWS}']:.3f} ms at "
        f"R={ROLLOUT_ROWS} (the CST rollout's rows)")
    for kname, ms, count in kernel_breakdown(
            torch, lambda: sample(*big, (123, 456), max_len=T, greedy=False)):
        log(f"breakdown bf16 {sample.__name__} multinomial R={ROLLOUT_ROWS}: "
            f"{kname} {ms:.3f} ms over {count} launches")
    return out


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
    """The attention decoders' ``order_witness``: the model permuted by
    ``permute_att`` (every sum over H, A, F and E reordered), held at
    KERNEL_ATT_BF16_MATCH_FLOOR."""
    def inputs(seed):
        g = torch.Generator().manual_seed(1000 + seed)
        perms = [torch.randperm(n, generator=g)
                 for n in (H, A_ATT, F_ATT, E)]
        a = make_att_inputs(torch, seed)
        return (list(att_to_card(torch, a, torch.bfloat16).values()),
                list(att_to_card(torch, permute_att(torch, a, *perms),
                                 torch.bfloat16).values()))

    return order_witness(torch, fns, "attention", inputs,
                         KERNEL_ATT_BF16_MATCH_FLOOR)


def order_witness(torch, fns, fusion: str, inputs, floor: float):
    """bf16 beam and greedy captions over ATT_SEEDS (``inputs(seed)``
    gives the operands and those of the same model permuted): kernel vs
    plain version, and each of them vs itself on the permuted model,
    i.e. how many captions a change of summation order alone moves.
    Holds the pooled kernel-vs-plain match to ``floor`` and to no more
    than ATT_WITNESS_MARGIN below plain vs permuted plain.  Also reports
    each pair's max score rtol over its matching captions (beam: the
    finalized score; greedy: the summed log-probs)."""
    from cst_captioning_torch.decoding.beam import finalize_beams

    beam, beam_ref, sample, sample_ref = fns
    pairs = ("kernel_vs_plain", "plain_vs_plain_permuted",
             "kernel_vs_kernel_permuted")
    out = {"seeds": list(ATT_SEEDS)}
    for mode in ("beam", "greedy"):
        for key in pairs:
            out[f"{mode}_{key}"] = []
            out[f"{mode}_{key}_score_rtol"] = 0.0
    for seed in ATT_SEEDS:
        x, xp = inputs(seed)
        caps = {}
        for tag, (bfn, sfn) in (("kernel", (beam, sample)),
                                ("plain", (beam_ref, sample_ref))):
            for sfx, v in (("", x), ("_permuted", xp)):
                fb = finalize_beams(*bfn(*v, beam_size=K, max_len=T))
                caps[("beam", tag + sfx)] = (fb.tokens, fb.score)
                tok, lp, _ = sfn(*v, (0, 0), max_len=T, greedy=True)
                caps[("greedy", tag + sfx)] = (tok, lp.sum(-1))
        torch.cuda.synchronize()
        for mode in ("beam", "greedy"):
            for key in pairs:
                one, two = key.split("_vs_")
                (t1, s1), (t2, s2) = caps[(mode, one)], caps[(mode, two)]
                same = (t1 == t2).all(-1)
                out[f"{mode}_{key}"].append(float(same.float().mean()))
                if bool(same.any()):
                    rtol = float(((s1 - s2)[same].abs()
                                  / s2[same].abs().clamp_min(1e-6)).max())
                    out[f"{mode}_{key}_score_rtol"] = max(
                        out[f"{mode}_{key}_score_rtol"], rtol)
        log(f"{fusion} bf16 order witness, seed {seed}: " + ", ".join(
            f"{mode} {key} {out[f'{mode}_{key}'][-1]:.4f}"
            for mode in ("beam", "greedy") for key in pairs))
    for mode in ("beam", "greedy"):
        for key in pairs:
            vals = out[f"{mode}_{key}"]
            out[f"{mode}_{key}_pooled"] = sum(vals) / len(vals)
        pooled = out[f"{mode}_kernel_vs_plain_pooled"]
        log(f"{fusion} bf16 {mode} caption match pooled over "
            f"{len(ATT_SEEDS)} seeds: kernel vs plain {pooled:.4f}, plain "
            "vs permuted plain "
            f"{out[f'{mode}_plain_vs_plain_permuted_pooled']:.4f}, kernel "
            "vs permuted kernel "
            f"{out[f'{mode}_kernel_vs_kernel_permuted_pooled']:.4f}; max "
            "score rtol over matching captions: " + ", ".join(
                f"{key} {out[f'{mode}_{key}_score_rtol']:.3e}"
                for key in pairs))
        order = out[f"{mode}_plain_vs_plain_permuted_pooled"]
        if pooled < floor:
            fail(f"{fusion} bf16 {mode} pooled caption match {pooled:.4f} "
                 f"below the kernel floor {floor}")
        if pooled < order - ATT_WITNESS_MARGIN:
            fail(f"{fusion} bf16 {mode}: kernel vs plain moves more "
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
# The tensor-core kernels (bf16 products in the mma order) read the same
# one ulp, and so does the order witness (att_rec_order_witness): the
# bound admits more than the plain version's own order.
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
# The XE path's layout: R_XE = 64 videos x ATT_REP caption rows, the
# attention tensors per video (row r reads video r // ATT_REP).
ATT_REP = 20
# bf16 d_proj / d_vals per video: the float32 fold (each row's sum over
# reversed time, then the rows in row order) rounded once, against the
# float64-exact fold of the same rows.  One rounding is at most half an
# ulp; the bound leaves the float32 sums' own error half an ulp more.
ATT_FOLD_BF16_ULPS = 1.0
ATT_TOL_TEXT = (
    f"f32: |h|,|c|,|a| diff <= {ATT_F32_ATOL:g} (max_abs_err_f32), grads "
    f"(backward kernel on the same residuals, and end to end) <= "
    f"{ATT_GRAD_RTOL:g} x max|grad|; bf16: |h diff| <= {ATT_BF16_H_ATOL:g} "
    f"(max_abs_err); bf16 backward on the same residuals: every cotangent "
    f"within {ATT_BWD_BF16_ULPS:g} bf16 ulps past {ATT_BWD_BF16_ATOL_REL:g} "
    f"x its max |value| (max_abs_err of the backward entry); rep = "
    f"{ATT_REP} (attention tensors per video): the forward bitwise rep = 1 "
    "on the repeated tensors (kernel and plain), d_proj / d_vals bitwise "
    "the rep = 1 rows folded in row order, f32 within "
    f"{ATT_GRAD_RTOL:g} x max of the plain gathered fold, bf16 within "
    f"{ATT_FOLD_BF16_ULPS:g} ulp of the float64-exact fold; the same at "
    "the edge shapes; the bf16 tanh table bitwise tanhf on every bf16 "
    "value but NaN (NaN there)")
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
    the card from ``seed``, plus an output cotangent: R caption rows over
    R // ATT_REP videos, the attention tensors per video and att_mask as
    ``att_mask`` gives (masked tails, video 0 all masked)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    kw = dict(generator=g, device=DEVICE)
    nv = R // ATT_REP
    args = [torch.randn(R, T, 4 * H, **kw) * 0.5,
            torch.randn(H, 4 * H, **kw) * 0.03,
            torch.randn(E, 4 * H, **kw) * 0.03,
            torch.randn(H, A_ATT, **kw) * 0.03,
            torch.randn(A_ATT, 1, **kw) * 0.06,
            torch.randn(nv, F_ATT, A_ATT, **kw) * 0.5,
            att_mask(torch, torch.Generator().manual_seed(seed), nv, DEVICE),
            torch.randn(nv, F_ATT, E, **kw) * 0.5]
    return args, torch.randn(R, T, H, **kw)


def att_rec_cast(args, cdt):
    return [x if i in (0, 6) else x.to(cdt) for i, x in enumerate(args)]


def att_rows(args, rep: int):
    """The gathered layout: the per-video attention tensors repeated to
    their caption rows, as the reference's ``_repeat_cache``."""
    return [x.repeat_interleave(rep, 0) if i in (5, 6, 7) else x
            for i, x in enumerate(args)]


def exact_dot(a, b, cdt):
    """``dot_f32`` with the products summed in float64 and rounded once
    to float32 (the order witness's products)."""
    return (a.to(cdt).double() @ b.to(cdt).double()).float()


def hold_att_rep_forward(torch, att_mod, a32, a16):
    """rep = ATT_REP against rep = 1 on the repeated tensors: h_seq,
    c_seq and a_seq bitwise, for the kernel and the plain version, in
    both dtypes."""
    out = {}
    for tag, args in (("f32", a32), ("bf16", a16)):
        rows = att_rows(args, ATT_REP)
        for who, fn in (("kernel", att_mod.attlstm_recurrence_fwd),
                        ("plain", att_mod.attlstm_recurrence_ref)):
            per_video = fn(*args, ATT_REP, with_residuals=True)
            gathered = fn(*rows, 1, with_residuals=True)
            torch.cuda.synchronize()
            same = all(bool(torch.equal(x, y))
                       for x, y in zip(per_video, gathered))
            log(f"attlstm_recurrence {tag} {who}: rep={ATT_REP} over "
                f"{R_XE // ATT_REP} videos vs rep=1 on the repeated tensors "
                f"bitwise: {same}")
            if not same:
                fail(f"attlstm_recurrence {tag} {who} at rep={ATT_REP} "
                     "differs from rep=1 on the repeated tensors")
            out[f"{tag}_{who}"] = same
    return out


def hold_att_fold(torch, att_mod, args, resid, dh, tag: str):
    """The backward's per-video d_proj / d_vals (rep = ATT_REP) against the
    gathered layout: the kernel at rep = 1 on the repeated tensors, its
    rows folded by the plain version's fold (``_fold_rows``, row order):
    bitwise, with dgx and dq bitwise too (per-row arithmetic).  f32: within
    ATT_GRAD_RTOL x max of the plain version's gathered rows folded.  bf16:
    the kernel's once-rounded d_proj / d_vals in ulps of the float64-exact
    fold of its rep = 1 rows (held at ATT_FOLD_BF16_ULPS), beside the
    reference's order (each row rounded, one rounded add per row)."""
    core = att_mod.attlstm_recurrence_bwd_core
    rows = att_rows(args, ATT_REP)
    c20 = core(*args[:6], args[7], *resid, dh, ATT_REP)
    c1 = core(*rows[:6], rows[7], *resid, dh, 1)
    torch.cuda.synchronize()
    out = {}
    same = [bool(torch.equal(c20[i], c1[i])) for i in (0, 1)]
    for i in (2, 3):  # d_proj, d_vals
        same.append(bool(torch.equal(c20[i],
                                     att_mod._fold_rows(c1[i], ATT_REP))))
    log(f"attlstm_recurrence_bwd {tag}: rep={ATT_REP} vs rep=1 rows "
        f"(dgx, dq bitwise; d_proj, d_vals folded in row order bitwise): "
        f"{same}")
    if not all(same):
        fail(f"attlstm_recurrence_bwd {tag}: the per-video fold differs from "
             "the gathered layout folded in row order")
    out["bitwise"] = all(same)
    if tag == "f32":
        p1 = att_mod._bwd_core_ref(*rows[:6], rows[7], *resid, dh, 1)
        rel = {n: max_diff(c20[i], att_mod._fold_rows(p1[i], ATT_REP))
               / max(float(c20[i].abs().max()), 1e-30)
               for i, n in ((2, "d_proj"), (3, "d_vals"))}
        log(f"attlstm_recurrence_bwd f32: per-video kernel vs the plain "
            f"gathered rows folded (of max): " + ", ".join(
                f"{n} {v:.3e}" for n, v in rel.items()))
        if not max(rel.values()) <= ATT_GRAD_RTOL:
            fail("attlstm_recurrence_bwd f32 per-video fold outside "
                 "ATT_GRAD_RTOL of the gathered layout")
        out["f32_rel"] = rel
        return out
    ulps, ref_ulps = {}, {}
    for i, n in ((2, "d_proj"), (3, "d_vals")):
        rows_i = c1[i].reshape(-1, ATT_REP, *c1[i].shape[1:])
        exact = rows_i.double().sum(1)
        ulps[n] = bf16_ulps(torch, c20[i].to(torch.bfloat16), exact,
                            ATT_BWD_BF16_ATOL_REL)
        acc = rows_i[:, 0].to(torch.bfloat16)
        for j in range(1, ATT_REP):
            acc = (acc.float() + rows_i[:, j].to(torch.bfloat16).float()
                   ).to(torch.bfloat16)
        ref_ulps[n] = bf16_ulps(torch, acc, exact, ATT_BWD_BF16_ATOL_REL)
    log("attlstm_recurrence_bwd bf16 per-video fold in ulps of the float64-"
        f"exact fold (past {ATT_BWD_BF16_ATOL_REL:g} x max): one rounding "
        + ", ".join(f"{n} {v:.2f}" for n, v in ulps.items())
        + "; the reference's order (rows rounded, one rounded add each) "
        + ", ".join(f"{n} {v:.2f}" for n, v in ref_ulps.items()))
    if not max(ulps.values()) <= ATT_FOLD_BF16_ULPS:
        fail("attlstm_recurrence_bwd bf16 per-video fold is not within "
             f"{ATT_FOLD_BF16_ULPS:g} ulp of the exact fold")
    out["bf16_ulps"], out["bf16_ulps_reference_order"] = ulps, ref_ulps
    return out


def att_rec_order_witness(torch, att_mod, a16, rr16, dh16, rh, rb):
    """Reported, not held: the plain forward and backward with every
    product summed exactly (``exact_dot``: float64, rounded once) against
    the plain version (``rh``, ``rb``), by 2d's bf16 measures: max |h
    diff| (ATT_BF16_H_ATOL) and each cotangent's bf16 ulps on the plain
    forward's residuals (ATT_BWD_BF16_ULPS).  What any other order of the
    products moves, the tensor cores' included."""
    real = att_mod._dot
    att_mod._dot = exact_dot
    try:
        wh_ = att_mod.attlstm_recurrence_ref(*a16, ATT_REP)
        wb = att_mod.attlstm_recurrence_bwd_ref(*a16[:6], a16[7], *rr16,
                                                dh16, ATT_REP)
    finally:
        att_mod._dot = real
    torch.cuda.synchronize()
    h_err = max_diff(wh_, rh)
    ulps = {n: bf16_ulps(torch, x, y, ATT_BWD_BF16_ATOL_REL)
            for n, x, y in zip(BWD_NAMES, wb, rb)}
    log(f"attlstm_recurrence bf16 order witness (not held): the plain "
        f"version with exact products vs the plain version: max |h diff| "
        f"{h_err:.3e} (share of h differing "
        f"{float((wh_ != rh).float().mean()):.2e}; ATT_BF16_H_ATOL "
        f"{ATT_BF16_H_ATOL:g}); backward bf16 ulps "
        + ", ".join(f"{n} {v:.2f}" for n, v in ulps.items())
        + f" (ATT_BWD_BF16_ULPS {ATT_BWD_BF16_ULPS:g})")
    return {"h_err": h_err, "bwd_ulps": ulps,
            "bwd_ulps_max": max(ulps.values())}


def att_launches(torch, fn, what: str, want: int):
    """The port's kernels launched by one call, from the profiler's
    breakdown (held at ``want`` when the profiler records them): the
    largest count of three readings, since a window now and then misses
    its call's first launches (one read 127 of attlstm_beam's 150)."""
    n = 0
    rows = max((kernel_breakdown(torch, fn) for _ in range(3)),
               key=lambda r: sum(c for k, _, c in r if k.startswith("cstk::")))
    for kname, ms, count in rows:
        log(f"breakdown bf16 {what}: {kname} {ms:.3f} ms over {count} "
            "launches")
        if kname.startswith("cstk::"):
            n += count
    log(f"{what} bf16: {n} kernel launches a call (want {want})")
    if n and n != want:
        fail(f"{what}: {n} kernel launches a call, want {want}")
    return n or None


# Off the XE shape, at the path's widths: 3 videos x 7 captions (rows
# that fill neither the GEMMs' 64-row tiles nor the attention blocks' 4
# rows) over T = 3, and T = 1 (the zero-state step alone) at rep = 1.
ATT_EDGE_SHAPES = ((3, 7, 3), (2, 1, 1))   # videos, rep, T


def check_att_edge_shapes(torch, att_mod):
    """2d off the main shape, in each dtype: the forward and backward
    kernels vs their plain versions at 2d's tolerances, rep vs rep = 1 on
    the repeated tensors (the forward bitwise, d_proj / d_vals bitwise
    the rows folded in row order).  Returns the largest readings."""
    fwd, ref = att_mod.attlstm_recurrence_fwd, att_mod.attlstm_recurrence_ref
    bwd, bwd_ref = att_mod.attlstm_recurrence_bwd, att_mod.attlstm_recurrence_bwd_ref
    core = att_mod.attlstm_recurrence_bwd_core
    out = {"f32_err": 0.0, "f32_grad_rel": 0.0, "bf16_err": 0.0,
           "bf16_ulps": 0.0}
    for nv, rep, t in ATT_EDGE_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(100 * nv + 10 * rep + t)
        kw = dict(generator=g, device=DEVICE)
        R = nv * rep
        a32 = [torch.randn(R, t, 4 * H, **kw) * 0.5,
               torch.randn(H, 4 * H, **kw) * 0.03,
               torch.randn(E, 4 * H, **kw) * 0.03,
               torch.randn(H, A_ATT, **kw) * 0.03,
               torch.randn(A_ATT, 1, **kw) * 0.06,
               torch.randn(nv, F_ATT, A_ATT, **kw) * 0.5,
               att_mask(torch, torch.Generator().manual_seed(nv), nv, DEVICE),
               torch.randn(nv, F_ATT, E, **kw) * 0.5]
        dh = torch.randn(R, t, H, **kw)
        for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            a = att_rec_cast(a32, cdt)
            rows = att_rows(a, rep)
            d = dh.to(cdt)
            k = fwd(*a, rep, with_residuals=True)
            r = ref(*a, rep, with_residuals=True)
            same = all(bool(torch.equal(x, y)) for x, y in
                       zip(k, fwd(*rows, 1, with_residuals=True)))
            kb = bwd(*a[:6], a[7], *r, d, rep)
            rb = bwd_ref(*a[:6], a[7], *r, d, rep)
            c_rep = core(*a[:6], a[7], *r, d, rep)
            c_one = core(*rows[:6], rows[7], *r, d, 1)
            torch.cuda.synchronize()
            same = same and all(
                bool(torch.equal(c_rep[i], att_mod._fold_rows(c_one[i], rep)))
                for i in (2, 3))
            what = (f"attlstm_recurrence edge shape {nv} videos x rep {rep}, "
                    f"T={t} ({tag})")
            if tag == "f32":
                err = max(max_diff(x, y) for x, y in zip(k, r))
                rel = max(max_diff(x, y) / max(float(y.abs().max()), 1e-30)
                          for x, y in zip(kb, rb))
                ok = err <= ATT_F32_ATOL and rel <= ATT_GRAD_RTOL
                out["f32_err"] = max(out["f32_err"], err)
                out["f32_grad_rel"] = max(out["f32_grad_rel"], rel)
                log(f"{what}: max |h,c,a diff| {err:.3e}, backward {rel:.3e} "
                    f"of max; rep vs rep=1 bitwise {same}")
            else:
                err = max_diff(k[0], r[0])
                ulps = max(bf16_ulps(torch, x, y, ATT_BWD_BF16_ATOL_REL)
                           for x, y in zip(kb, rb))
                ok = err <= ATT_BF16_H_ATOL and ulps <= ATT_BWD_BF16_ULPS
                out["bf16_err"] = max(out["bf16_err"], err)
                out["bf16_ulps"] = max(out["bf16_ulps"], ulps)
                log(f"{what}: max |h diff| {err:.3e}, backward {ulps:.2f} bf16 "
                    f"ulps; rep vs rep=1 bitwise {same}")
            if not (ok and same and bool(torch.isfinite(k[0].float()).all())):
                fail(f"{what} disagrees with its plain version or its "
                     "repeated layout")
    return out


def check_att_recurrence(torch, att_mod):
    """Phase 2d (see module docstring)."""
    fwd, ref = att_mod.attlstm_recurrence_fwd, att_mod.attlstm_recurrence_ref
    bwd, bwd_ref = att_mod.attlstm_recurrence_bwd, att_mod.attlstm_recurrence_bwd_ref
    rep = ATT_REP
    res = {}
    tt = att_mod.tanh_table_check(DEVICE)
    torch.cuda.synchronize()
    bits = tt.view(torch.int32)
    nan_in = (torch.arange(65536, device=tt.device) & 0x7fff) > 0x7f80
    n_bad = int(torch.where(nan_in, ~(tt[0].isnan() & tt[1].isnan()),
                            bits[0] != bits[1]).sum())
    log(f"attlstm bf16 tanh table vs tanhf on all 65,536 bf16 values "
        f"(bitwise; NaN for the {int(nan_in.sum())} NaN inputs): {n_bad} "
        "differ")
    if n_bad:
        fail("the bf16 kernels' tanh table differs from tanhf")
    res["tanh_table_exact"] = True
    a32, dh = att_rec_inputs(torch, 21, R_XE, T_XE)
    a16 = att_rec_cast(a32, torch.bfloat16)

    k = fwd(*a32, rep, with_residuals=True)
    r = ref(*a32, rep, with_residuals=True)
    torch.cuda.synchronize()
    errs = [max_diff(x, y) for x, y in zip(k, r)]
    log(f"attlstm_recurrence f32 R={R_XE} ({R_XE // rep} videos x {rep}) "
        f"T={T_XE} F={F_ATT} A={A_ATT}: max |h diff| {errs[0]:.3e}, |c diff| "
        f"{errs[1]:.3e}, |a diff| {errs[2]:.3e}; all-masked video uniform "
        f"{bool(torch.allclose(k[2][0], torch.full_like(k[2][0], 1 / F_ATT)))}")
    if not max(errs) <= ATT_F32_ATOL or not torch.isfinite(k[0]).all():
        fail("attlstm_recurrence float32 disagrees with its plain version")
    if not torch.equal(fwd(*a32, rep), k[0]):
        fail("attlstm_recurrence without residuals differs from with them")
    res["f32_err"] = max(errs)
    res["rep_forward"] = hold_att_rep_forward(torch, att_mod, a32, a16)

    kb = bwd(*a32[:6], a32[7], *r, dh, rep)
    rb = bwd_ref(*a32[:6], a32[7], *r, dh, rep)
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
    res["fold_f32"] = hold_att_fold(torch, att_mod, a32, r, dh, "f32")

    leaves = [x.clone().requires_grad_() for x in a32]
    (att_mod.attlstm_recurrence(*leaves, rep) * dh).sum().backward()
    want = list(bwd_ref(*a32[:6], a32[7], *r, dh, rep))
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

    kh = fwd(*a16, rep)
    rh = ref(*a16, rep)
    torch.cuda.synchronize()
    res["bf16_err"] = max_diff(kh, rh)
    res["bf16_share_differing"] = float((kh != rh).float().mean())
    log(f"attlstm_recurrence bf16: max |h diff| {res['bf16_err']:.3e} (share "
        f"of h differing {res['bf16_share_differing']:.2e})")
    if not res["bf16_err"] <= ATT_BF16_H_ATOL:
        fail("attlstm_recurrence bfloat16 outside its tolerance")

    rr16 = ref(*a16, rep, with_residuals=True)
    dh16 = dh.to(torch.bfloat16)
    kb = bwd(*a16[:6], a16[7], *rr16, dh16, rep)
    rb = bwd_ref(*a16[:6], a16[7], *rr16, dh16, rep)
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
    del kb
    res["fold_bf16"] = hold_att_fold(torch, att_mod, a16, rr16, dh16, "bf16")
    res["order_witness"] = att_rec_order_witness(torch, att_mod, a16, rr16,
                                                 dh16, rh, rb)
    del rb
    res["edge_shapes"] = check_att_edge_shapes(torch, att_mod)

    for tag, args in (("bf16", a16), ("f32", a32)):
        res[f"ms_{tag}"] = time_call(
            torch, lambda: fwd(*args, rep, with_residuals=True), REPS)
        res[f"ms_nores_{tag}"] = time_call(torch, lambda: fwd(*args, rep),
                                           REPS)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: ref(*args, rep, with_residuals=True), 1)
        rr = ref(*args, rep, with_residuals=True)
        dh_t = dh.to(args[1].dtype)
        res[f"bwd_ms_{tag}"] = time_call(
            torch, lambda: bwd(*args[:6], args[7], *rr, dh_t, rep), REPS)
        res[f"bwd_plain_ms_{tag}"] = time_call(
            torch, lambda: bwd_ref(*args[:6], args[7], *rr, dh_t, rep), 1)
        rows = att_rows(args, rep)
        res[f"ms_rep1_{tag}"] = time_call(
            torch, lambda: fwd(*rows, 1, with_residuals=True), REPS)
        res[f"bwd_ms_rep1_{tag}"] = time_call(
            torch, lambda: bwd(*rows[:6], rows[7], *rr, dh_t, 1), REPS)
        log(f"times {tag}: attlstm_recurrence {res[f'ms_{tag}']:.3f} ms with "
            f"residuals, {res[f'ms_nores_{tag}']:.3f} ms without (plain "
            f"{res[f'plain_ms_{tag}']:.3f} ms); backward kernel "
            f"{res[f'bwd_ms_{tag}']:.3f} ms incl. the three weight "
            f"contractions (plain {res[f'bwd_plain_ms_{tag}']:.3f} ms); at "
            f"rep=1 on the repeated tensors {res[f'ms_rep1_{tag}']:.3f} / "
            f"{res[f'bwd_ms_rep1_{tag}']:.3f} ms")
        del rr, rows
    res["launches_per_call"] = {
        "forward": att_launches(
            torch, lambda: fwd(*a16, rep, with_residuals=True),
            "attlstm_recurrence", 3 * T_XE - 1),
        "backward": att_launches(
            torch, lambda: bwd(*a16[:6], a16[7], *rr16, dh16, rep),
            "attlstm_recurrence_bwd", 4 * T_XE + 3)}
    return res


def att_rec_work(R: int, T: int, itemsize: int, rep: int = 1):
    """(forward, backward) FLOPs, compulsory bytes and tanh counts of one
    attention recurrence call with residuals (the backward without the
    three weight contractions done outside it), with the attention
    tensors per video (R // rep videos; rep = 1: per row)."""
    RT, nv = R * T, R // rep
    att_in = nv * F_ATT * (A_ATT + E) * itemsize + nv * F_ATT * 4
    w = (H * 4 * H + E * 4 * H + H * A_ATT + A_ATT) * itemsize
    res = RT * H * itemsize + RT * H * 4 + RT * F_ATT * 4   # h, c, a
    f_flops = 2 * RT * (H * 4 * H + E * 4 * H + H * A_ATT
                        + F_ATT * (A_ATT + E))
    f_bytes = RT * 4 * H * 4 + w + att_in + res
    b_flops = (2 * RT * (2 * 4 * H * (E + H) + 2 * H * A_ATT)
               + RT * F_ATT * (6 * E + 8 * A_ATT))
    b_bytes = (RT * 4 * H * 4 + w + att_in + res + RT * H * itemsize
               + RT * 4 * H * 4 + RT * A_ATT * 4
               + nv * F_ATT * (A_ATT + E) * 4 + A_ATT * 4)
    tanh = RT * F_ATT * A_ATT
    return (f_flops, f_bytes, tanh), (b_flops, b_bytes, tanh)


def rec_bound(flops: float, nbytes: float, tanh: float, peak: float):
    """(bound ms, "bytes" or "operations", the binding term): the larger
    of the byte floor, the other operations at ``peak`` and the tanh
    count at the SFU rate."""
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "products": flops / peak * 1e3, "tanh": sfu_floor_ms(tanh)}
    term = max(terms, key=terms.get)
    return terms[term], ("bytes" if term == "bytes" else "operations"), term


# SFU rate for tanh: 16 special-function results per SM per clock
# (H100 SM), 132 SMs at the 1.98 GHz boost clock.
H100_SFU_PER_S = 132 * 16 * 1.98e9


def sfu_floor_ms(n_tanh: float) -> float:
    return n_tanh / H100_SFU_PER_S * 1e3


# ------------------------------------------------------------ phase 2e

# fused_context_attention vs its plain version: float32 ctx and weights
# within CTX_F32_RTOL x max |value| (a change of summation order over A
# and F is all that differs); bfloat16 ctx within one bf16 ulp (the f32
# mix is rounded once, and an f32 difference in the last bit can flip
# that rounding) past an absolute CTX_BF16_ATOL_REL x max |value|, the
# weights (f32 in both dtypes) within 1e-5; rep = 5 bitwise the gathered
# layout at rep = 1.  The allowance: the first H100 run read 5 ulps on a
# few entries with |ctx| near 1e-5, where the f32 mix's own difference
# (<= 1.8e-7 in the f32 check, from the weights' last bits times |vals|)
# is several bf16 ulps of the entry; it is 50x that f32 reading.
CTX_F32_RTOL = 1e-5
CTX_BF16_ULPS = 1.0
CTX_BF16_ATOL_REL = 1e-5
CTX_BF16_ATTN_ATOL = 1e-5
CTX_TOLERANCE = (
    f"f32: |ctx|, |attn| diff <= {CTX_F32_RTOL:g} x max |value| "
    f"(max_abs_err_f32); bf16: ctx within {CTX_BF16_ULPS:g} bf16 ulp past "
    f"{CTX_BF16_ATOL_REL:g} x max |ctx| (max_abs_err: the bf16 |ctx "
    f"diff|), attn within {CTX_BF16_ATTN_ATOL:g}; rep=5 bitwise equal to "
    "rep=1 on the gathered tensors")


def ctx_inputs(torch, seed: int):
    """The context step's operands at the slot loop's beam shape: B*K
    queries, B videos' att_proj / att_vals / masks (``att_mask``: masked
    tails, video 0 all masked), att_v at the decoders' scale."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    return dict(q=r(B * K, A_ATT, sc=0.5), proj=r(B, F_ATT, A_ATT, sc=0.5),
                mask=att_mask(torch, g, B), vals=r(B, F_ATT, E, sc=0.5),
                v=r(A_ATT, 1, sc=0.06))


def ctx_work(R: int, n_videos: int, itemsize: int, attn_out: bool = False):
    """(FLOPs, compulsory bytes, tanh count) of one context call: read
    q, att_v and the videos' att_proj / att_vals / mask once, write ctx
    (and, with ``attn_out``, the float32 weights, which training saves;
    the serving path asks for none)."""
    flops = R * F_ATT * (2 * A_ATT + 2 * E)
    nbytes = ((R * A_ATT + A_ATT + n_videos * F_ATT * (A_ATT + E)
               + R * E) * itemsize + n_videos * F_ATT * 4
              + (R * F_ATT * 4 if attn_out else 0))
    return flops, nbytes, R * F_ATT * A_ATT


def ctx_bound(R: int, n_videos: int, itemsize: int, attn_out: bool = False):
    """The context step's bound: bytes, or tanh at the SFU rate and its
    other operations at the f32 rate."""
    return rec_bound(*ctx_work(R, n_videos, itemsize, attn_out),
                     H100_F32_FLOPS)[:2]


def check_context_attention(torch, att_mod):
    """Phase 2e (see module docstring)."""
    fca, ref = att_mod.fused_context_attention, att_mod.fused_context_attention_ref
    a = ctx_inputs(torch, 31)
    res = {}
    for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        proj, vals = a["proj"].to(DEVICE, cdt), a["vals"].to(DEVICE, cdt)
        mask, v = a["mask"].to(DEVICE), a["v"].to(DEVICE, cdt)
        for R, rep in ((B * K, K), (B, 1)):
            q = a["q"][:R].to(DEVICE, cdt)
            args = (q, proj, mask, vals, v)
            kc, ka = fca(*args, rep=rep, return_attn=True)
            rc, ra = ref(*args, rep=rep)
            torch.cuda.synchronize()
            ec, ea = max_diff(kc, rc), max_diff(ka, ra)
            what = f"fused_context_attention {tag} R={R} rep={rep}"
            uniform = bool(torch.allclose(
                ka[0], torch.full_like(ka[0], 1.0 / F_ATT)))
            if tag == "f32":
                ok = (ec <= CTX_F32_RTOL * float(rc.abs().max())
                      and ea <= CTX_F32_RTOL * float(ra.abs().max()))
                log(f"{what}: max |ctx diff| {ec:.3e}, |attn diff| {ea:.3e}; "
                    f"all-masked row uniform {uniform}")
            else:
                ulps = bf16_ulps(torch, kc, rc, CTX_BF16_ATOL_REL)
                raw = bf16_ulps(torch, kc, rc, 0.0)
                ok = ulps <= CTX_BF16_ULPS and ea <= CTX_BF16_ATTN_ATOL
                log(f"{what}: ctx {ulps:.2f} bf16 ulps past "
                    f"{CTX_BF16_ATOL_REL:g} x max ({raw:.2f} without), max "
                    f"|diff| {ec:.3e}, share differing "
                    f"{float((kc != rc).float().mean()):.2e}, |attn diff| "
                    f"{ea:.3e}; all-masked row uniform {uniform}")
            if not ok or not uniform or not torch.isfinite(kc.float()).all():
                fail(f"{what} disagrees with its plain version")
            res[f"err_{tag}_R{R}"] = ec
            res[f"attn_err_{tag}_R{R}"] = ea
            res[f"device_ms_{tag}_R{R}"] = device_ms(
                torch, lambda: fca(*args, rep=rep), REPS, CTX_LAUNCHES)
            if rep == 1:
                res[f"ms_{tag}_R{R}"] = time_call(
                    torch, lambda: fca(*args), REPS)
                res[f"plain_ms_{tag}_R{R}"] = time_call(
                    torch, lambda: ref(*args), 1)
                continue
            gp, gm, gv = (x.repeat_interleave(rep, dim=0)
                          for x in (proj, mask, vals))
            gc, ga = fca(q, gp, gm, gv, v, return_attn=True)
            if not (torch.equal(gc, kc) and torch.equal(ga, ka)):
                fail(f"{what}: rep={rep} differs from the gathered layout")
            res[f"ms_{tag}_R{R}"] = time_call(
                torch, lambda: fca(*args, rep=rep), REPS)
            res[f"gathered_ms_{tag}_R{R}"] = time_call(
                torch, lambda: fca(q, gp, gm, gv, v), REPS)
            res[f"plain_ms_{tag}_R{R}"] = time_call(
                torch, lambda: ref(*args, rep=rep), 1)
            log(f"{what}: rep={rep} bitwise equal to the gathered layout")
            if tag == "bf16":
                res["launches_per_call_bf16"] = ctx_launches(
                    torch, lambda: fca(*args, rep=rep),
                    "fused_context_attention", CTX_LAUNCHES)
        log(f"times {tag}: fused_context_attention R={B * K} rep={K} "
            f"{res[f'ms_{tag}_R{B * K}']:.4f} ms by the event clock, "
            f"{res[f'device_ms_{tag}_R{B * K}']:.4f} ms device (gathered "
            f"rep=1 {res[f'gathered_ms_{tag}_R{B * K}']:.4f} ms, plain "
            f"{res[f'plain_ms_{tag}_R{B * K}']:.4f} ms), R={B} rep=1 "
            f"{res[f'ms_{tag}_R{B}']:.4f} ms, "
            f"{res[f'device_ms_{tag}_R{B}']:.4f} ms device (plain "
            f"{res[f'plain_ms_{tag}_R{B}']:.4f} ms); bound "
            f"{ctx_bound(B * K, B, 2 if tag == 'bf16' else 4)[0]:.4f} ms")
    res["edges"] = check_context_edges(torch, att_mod)
    return res


# Off the main shapes (2e and 2g), at the same tolerances and with rep
# bitwise the gathered layout: (videos, rep, F, A, E).  One video (a
# cluster of 8 CTAs, 7 frames each); 3 videos x 7 rows over F = 7 frames
# at narrow widths the CUDA gate admits (A = 264 is 33 16-byte chunks,
# so a lane takes two; E = 40 is 5 chunks, fewer than the 8 CTAs, and
# one CTA owns no frame); the smallest bank (R = 40 at rep = K; the
# backward at two videos of CTXB_REP rows).
CTX_EDGE_SHAPES = ((1, K, F_ATT, A_ATT, E), (3, 7, 7, 264, 40),
                   (40 // K, K, F_ATT, A_ATT, E))
# One bf16 call's kernel launches in the profiler: the forward's one
# launch; the backward's cluster kernel and its d_v sum.
CTX_LAUNCHES = 1
CTXB_LAUNCHES = 2
CTX_PROFILED = 5  # calls in a launch-count window


def ctx_launches(torch, fn, what: str, launches: int) -> int:
    """The port's kernels launched by one bf16 call, held at exactly
    ``launches``: a profiler window of CTX_PROFILED calls that recorded
    every launch (``profiled`` fails when none does, or on more), its
    kernels logged."""
    rows = profiled(torch, fn, CTX_PROFILED, launches)
    for kname, ms, count in rows:
        log(f"breakdown bf16 {what}: {kname} {ms:.4f} ms over {count:g} "
            "launches a call")
    log(f"{what} bf16: {launches} kernel launches a call, as held")
    return launches


def ctx_edge_inputs(torch, seed: int, nv: int, rep: int, F: int, A: int,
                    Ee: int):
    """Operands of an off-main case: masked tails, video 0 all masked
    when there is more than one video."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    n = torch.randint(1, F + 1, (nv,), generator=g)
    mask = (torch.arange(F)[None, :] < n[:, None]).float()
    if nv > 1:
        mask[0] = 0.0
    return dict(q=r(nv * rep, A, sc=0.5), proj=r(nv, F, A, sc=0.5),
                mask=mask, vals=r(nv, F, Ee, sc=0.5), v=r(A, 1, sc=0.06),
                dctx=r(nv * rep, Ee, sc=1.0))


def check_context_edges(torch, att_mod):
    """Phase 2e off the main shapes (``CTX_EDGE_SHAPES``)."""
    fca, ref = att_mod.fused_context_attention, att_mod.fused_context_attention_ref
    out = []
    for i, (nv, rep, F, A, Ee) in enumerate(CTX_EDGE_SHAPES):
        a = ctx_edge_inputs(torch, 61 + i, nv, rep, F, A, Ee)
        for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, proj, vals, v = (a[k].to(DEVICE, cdt)
                                for k in ("q", "proj", "vals", "v"))
            mask = a["mask"].to(DEVICE)
            kc, ka = fca(q, proj, mask, vals, v, rep=rep, return_attn=True)
            rc, ra = ref(q, proj, mask, vals, v, rep=rep)
            gp, gm, gv = (x.repeat_interleave(rep, dim=0)
                          for x in (proj, mask, vals))
            gc, ga = fca(q, gp, gm, gv, v, return_attn=True)
            torch.cuda.synchronize()
            ec, ea = max_diff(kc, rc), max_diff(ka, ra)
            if tag == "f32":
                err = ec
                ok = (ec <= CTX_F32_RTOL * float(rc.abs().max())
                      and ea <= CTX_F32_RTOL * float(ra.abs().max()))
            else:
                err = bf16_ulps(torch, kc, rc, CTX_BF16_ATOL_REL)
                ok = err <= CTX_BF16_ULPS and ea <= CTX_BF16_ATTN_ATOL
            gathered = bool(torch.equal(gc, kc) and torch.equal(ga, ka))
            what = (f"fused_context_attention {tag} {nv} videos x rep={rep}, "
                    f"F={F}, A={A}, E={Ee}")
            log(f"{what}: ctx {'|diff|' if tag == 'f32' else 'bf16 ulps'} "
                f"{err:.3e}, |attn diff| {ea:.3e}; rep bitwise the gathered "
                f"layout {gathered}")
            if not ok or not torch.isfinite(kc.float()).all():
                fail(f"{what} disagrees with its plain version")
            if not gathered:
                fail(f"{what}: rep={rep} differs from the gathered layout")
            out.append(dict(videos=nv, rep=rep, F=F, A=A, E=Ee, dtype=tag,
                            ctx_err=err, attn_err=ea))
    return out


# ------------------------------------------------------------ phase 2f

# row_dot (csrc/row_gemm.cu): the per-step decode's and the admission
# encode's products.  Held: each row's bits are the same whatever the
# row count of the call (every prefix of RG_ROWS rows against the full
# call), and the values agree with the plain version (cuBLAS sgemm on the
# rounded operands, TF32 off) within RG_RTOL x max |value| (summation
# order only).  cuBLAS's own row invariance is measured and reported.
RG_RTOL = 1e-5
RG_ROWS = (1, 8, 40, 64, 80, 160, 320, 640)
RG_TIMED = 20  # timed calls per product (each well under a host launch)
RG_SHAPES = (("vocab", H, V), ("gates", 2 * E + H, 4 * H),
             ("query", H, A_ATT), ("encode_c3d", 4096, E))
# Three operand cases per product: f32 x and W (<float, float>); bf16 W
# with f32 x (<bf16, float>: the admission encode's feature rows); bf16 W
# with bf16 x (<bf16, bf16>: every per-step product of bf16 serving,
# whose x is h or the bf16 [emb | ctx | h]).  The kernels line's bf16
# numbers are the last case's.
RG_CASES = (("f32", "float32", "float32"), ("bf16_xf32", "bfloat16", "float32"),
            ("bf16", "bfloat16", "bfloat16"))
# int8w serving's products: int8 codes W with their per-column scale,
# x in the compute dtype (f32 compute with f32 x; bf16 compute with bf16
# x, every per-step product and the encode's att_wf).  Held bitwise to
# the float instantiation on the widened codes times the scale (the
# same ascending sum, then one float32 multiply), and within RG_RTOL x
# max |value| of cuBLAS on the dequantized weights.
RG_Q_CASES = (("int8_f32", "float32", "float32"),
              ("int8_bf16", "bfloat16", "bfloat16"))
RG_TOLERANCE = (f"rows bitwise invariant to the row count ({RG_ROWS}); "
                f"|diff| vs cuBLAS on the rounded operands <= {RG_RTOL:g} x "
                "max |value| (max_abs_err: bf16 W and x, max_abs_err_f32: "
                "f32, at the vocab product); int8 W: bitwise the float "
                "path on the widened codes times the scale, within "
                f"{RG_RTOL:g} x max |value| of cuBLAS on the dequantized W")


def rg_work(R: int, Kd: int, N: int, itemsize: int, x_itemsize: int):
    return 2 * R * Kd * N, R * Kd * x_itemsize + Kd * N * itemsize + R * N * 4


def check_row_gemm(torch, rg_mod):
    """Phase 2f (see module docstring)."""
    row_dot, ref = rg_mod.row_dot, rg_mod.row_dot_ref
    g = torch.Generator(device=DEVICE).manual_seed(41)
    res = {"cublas_rows_differing": {}}
    top = max(RG_ROWS)
    for name, Kd, N in RG_SHAPES:
        x32 = torch.randn(top, Kd, generator=g, device=DEVICE) * 0.5
        w = torch.randn(Kd, N, generator=g, device=DEVICE) * (1.0 / Kd ** 0.5)
        for tag, cname, xname in RG_CASES:
            cdt = getattr(torch, cname)
            x, wc = x32.to(getattr(torch, xname)), w.to(cdt)
            full = row_dot(x, wc, cdt)
            plain = ref(x, wc, cdt)
            torch.cuda.synchronize()
            err = max_diff(full, plain)
            rel = err / float(plain.abs().max())
            moved = [int((row_dot(x[:m], wc, cdt) != full[:m]).any(-1).sum())
                     for m in RG_ROWS]
            xr, wr = x.to(cdt).float(), wc.float()
            cub = {m: int(((xr[:m] @ wr) != plain[:m]).any(-1).sum())
                   for m in RG_ROWS}
            res["cublas_rows_differing"][f"{name}_{tag}"] = cub
            log(f"row_dot {name} K={Kd} N={N} {tag} (W {cname}, x {xname}): "
                f"|diff| vs cuBLAS "
                f"{err:.3e} ({rel:.2e} of max); rows moved by the row count "
                f"{sum(moved)}; cuBLAS rows differing from its {top}-row "
                f"call, by call rows: {cub}")
            if sum(moved) or not rel <= RG_RTOL:
                fail(f"row_dot {name} {tag}: not row-invariant or off its "
                     "plain version")
            t = time_row_dot(torch, res, name, tag,
                             lambda m: row_dot(x[:m], wc, cdt),
                             lambda m: xr[:m] @ wr,
                             "torch.matmul on the rounded operands")
            if name == "vocab" and tag != "bf16_xf32":
                R = B * K
                res[f"err_{tag}"] = err
                res[f"ms_{tag}"] = t["ms"]
                res[f"event_ms_{tag}"] = t["event_ms"]
                res[f"library_ms_{tag}"] = t["library_ms"]
                res[f"plain_ms_{tag}"] = time_call(
                    torch, lambda: ref(x[:R], wc, cdt), 1)
        check_row_gemm_int8(torch, rg_mod, res, name, x32, w)
    return res


def time_row_dot(torch, res, name: str, tag: str, kernel, library, lib: str):
    """Time ``kernel(m)`` and ``library(m)`` at the slot loop's beam rows
    (m = B * K) on one product: device ms per call from the profiler
    (``device_ms``; the kernel's own time), the event clock's ms beside
    it.  Recorded under ``res["shapes"][name][tag]``."""
    R = B * K
    t = {"ms": device_ms(torch, lambda: kernel(R), RG_TIMED),
         "event_ms": time_call(torch, lambda: kernel(R), RG_TIMED),
         "library_ms": device_ms(torch, lambda: library(R), RG_TIMED)}
    res.setdefault("shapes", {}).setdefault(name, {})[tag] = t
    log(f"times {tag}: row_dot {name} R={R} {t['ms']:.4f} ms device "
        f"({t['event_ms']:.4f} ms on the event clock), {lib} "
        f"{t['library_ms']:.4f} ms device")
    return t


def check_row_gemm_int8(torch, rg_mod, res, name, x32, w):
    """Phase 2f's int8-W cases (``RG_Q_CASES``) of one product."""
    from cst_captioning_torch.ops.quant import dequantize, quantize_per_channel

    row_dot, ref = rg_mod.row_dot, rg_mod.row_dot_ref
    codes, scale = (t.to(DEVICE) for t in quantize_per_channel(w.cpu(), 1))
    deq = dequantize(codes, scale, 1)
    Kd, N = w.shape
    for tag, cname, xname in RG_Q_CASES:
        cdt = getattr(torch, cname)
        x = x32.to(getattr(torch, xname))
        n0 = row_dot.quant_launches
        full = row_dot(x, codes, cdt, scale)
        widened = row_dot(x, codes.to(cdt), cdt) * scale
        cub = x.to(cdt).float() @ deq
        plain = ref(x, codes, cdt, scale)
        torch.cuda.synchronize()
        same = bool(torch.equal(full, widened))
        rel = max_diff(full, cub) / float(cub.abs().max())
        rel_plain = max_diff(full, plain) / float(plain.abs().max())
        moved = [int((row_dot(x[:m], codes, cdt, scale) != full[:m])
                      .any(-1).sum()) for m in RG_ROWS]
        log(f"row_dot {name} K={Kd} N={N} {tag} (int8 W, x {xname}, "
            f"compute {cname}): bitwise the widened-codes path {same}; "
            f"|diff| vs cuBLAS on the dequantized W {rel:.2e} of max, vs "
            f"the plain version {rel_plain:.2e}; rows moved by the row count "
            f"{sum(moved)}")
        if (not same or sum(moved) or not rel <= RG_RTOL
                or not rel_plain <= RG_RTOL
                or row_dot.quant_launches == n0):
            fail(f"row_dot {name} {tag}: int8 path not row-invariant, off "
                 "the float path on its codes, or off cuBLAS")
        xr = x.to(cdt).float()
        t = time_row_dot(torch, res, name, tag,
                         lambda m: row_dot(x[:m], codes, cdt, scale),
                         lambda m: xr[:m] @ deq,
                         "torch.matmul on the dequantized W")
        if name == "vocab":
            R = B * K
            res[f"err_{tag}"] = max_diff(full, cub)
            res[f"ms_{tag}"] = t["ms"]
            res[f"event_ms_{tag}"] = t["event_ms"]
            res[f"library_ms_{tag}"] = t["library_ms"]
            res[f"plain_ms_{tag}"] = time_call(
                torch, lambda: ref(x[:R], codes, cdt, scale), 1)


# ------------------------------------------------------------ phase 2g

# The backward kernel vs its plain version at the scheduled-sampling
# training shape (R_XE = 1280 caption rows over 64 videos, rep = 20, F =
# 56 with masked tails and video 0 all masked, A = E = 512), on the
# forward kernel's own weights: float32 cotangents within CTXB_F32_RTOL
# x their max |value| (a change of summation order is all that differs);
# bf16 within CTXB_BF16_ULPS bf16 ulps past CTXB_BF16_ATOL_REL x max
# |value| (phase 2d's measure: each row's rounded cotangent can flip
# with its float32 sum's last bit, and a video's 20 rounded rows are
# summed in bf16); rep = 20 vs the gathered layout (rep = 1 on the
# repeated tensors, then each video's rows folded in row order, as the
# kernel folds them): d_q, d_proj and d_vals bitwise, d_v (per-row
# partials reduced in another order) within the f32 bound.
CTXB_REP = 20
CTXB_F32_RTOL = 1e-5
CTXB_BF16_ULPS = 2.0
CTXB_BF16_ATOL_REL = 1e-3
CTXB_NAMES = ("d_q", "d_proj", "d_vals", "d_v")
CTXB_TOLERANCE = (
    f"f32: each cotangent within {CTXB_F32_RTOL:g} x its max |value| "
    f"(max_abs_err_f32: the largest |diff| over the four); bf16: within "
    f"{CTXB_BF16_ULPS:g} bf16 ulps past {CTXB_BF16_ATOL_REL:g} x max |value| "
    f"(max_abs_err: the largest bf16 |diff|); rep={CTXB_REP} vs the "
    "gathered layout folded in row order: d_q, d_proj, d_vals bitwise, d_v "
    "within the f32 bound; attention inputs: one video all masked (its "
    "rows get the kernel's non-zero gradient)")


def ctxb_inputs(torch, seed: int):
    """The backward's operands at the training shape: per-video proj /
    vals / mask, 20 query rows per video, att_v, a context cotangent."""
    nv = R_XE // CTXB_REP
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    return dict(q=r(R_XE, A_ATT, sc=0.5), proj=r(nv, F_ATT, A_ATT, sc=0.5),
                mask=att_mask(torch, g, nv), vals=r(nv, F_ATT, E, sc=0.5),
                v=r(A_ATT, 1, sc=0.06), dctx=r(R_XE, E, sc=1.0))


def ctxb_work(R: int, n_videos: int, itemsize: int):
    """(operations, compulsory bytes, tanh count) of one backward call:
    read q, dctx, the float32 weights, att_v and each video's proj / vals
    once; write d_q, d_proj, d_vals, d_v.  Per (row, frame): da and d_vals
    (4E); per (row, frame, column): 9 besides the tanh."""
    flops = R * F_ATT * (4 * E + 9 * A_ATT)
    per_video = n_videos * F_ATT * (A_ATT + E)
    nbytes = ((2 * R * A_ATT + R * E + 2 * per_video + 2 * A_ATT) * itemsize
              + R * F_ATT * 4)
    return flops, nbytes, R * F_ATT * A_ATT


def fold_rows(torch, x, rep: int):
    """Each video's ``rep`` rows of ``x`` summed in row order from zero,
    one float32 add per row rounded to ``x``'s dtype: the backward
    kernel's fold of a video's rows."""
    x = x.reshape(-1, rep, *x.shape[1:])
    acc = torch.zeros_like(x[:, 0], dtype=torch.float32)
    for r in range(rep):
        acc = (acc + x[:, r].float()).to(x.dtype).float()
    return acc.to(x.dtype)


def gathered_bwd(torch, bwd, args, rep: int):
    """The backward on the gathered layout (rep = 1 over the repeated
    tensors), each video's d_proj and d_vals rows then folded in row
    order (``fold_rows``)."""
    q, proj, vals, v, attn, dctx = args
    g = [x.repeat_interleave(rep, dim=0) for x in (proj, vals)]
    dq, dp, dvals, dv = bwd(q, g[0], g[1], v, attn, dctx, rep=1)
    return dq, fold_rows(torch, dp, rep), fold_rows(torch, dvals, rep), dv


def check_context_attention_bwd(torch, ctx_mod):
    """Phase 2g (see module docstring)."""
    fca, bwd = ctx_mod.fused_context_attention, ctx_mod.fused_context_attention_bwd
    bwd_ref = ctx_mod.fused_context_attention_bwd_ref
    a = ctxb_inputs(torch, 41)
    nv, rep = R_XE // CTXB_REP, CTXB_REP
    res = {}
    for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, proj, vals, v, dctx = (a[k].to(DEVICE, cdt) for k in
                                  ("q", "proj", "vals", "v", "dctx"))
        mask = a["mask"].to(DEVICE)
        _, attn = fca(q, proj, mask, vals, v, rep=rep, return_attn=True)
        args = (q, proj, vals, v, attn, dctx)
        kb = bwd(*args, rep=rep)
        rb = bwd_ref(*args, rep=rep)
        torch.cuda.synchronize()
        what = f"fused_context_attention_bwd {tag} R={R_XE} rep={rep}"
        rel = {n: max_diff(x, y) / max(float(y.float().abs().max()), 1e-30)
               for n, x, y in zip(CTXB_NAMES, kb, rb)}
        masked_rows = [float(x[:rep].float().abs().max()) for x in (kb[0],
                                                                    rb[0])]
        finite = all(bool(torch.isfinite(x.float()).all()) for x in kb)
        if tag == "f32":
            ok = max(rel.values()) <= CTXB_F32_RTOL
            log(f"{what}: kernel vs plain (of max |value|): " + ", ".join(
                f"{n} {x:.3e}" for n, x in rel.items()))
        else:
            ulps = {n: bf16_ulps(torch, x, y, CTXB_BF16_ATOL_REL)
                    for n, x, y in zip(CTXB_NAMES, kb, rb)}
            raw = {n: bf16_ulps(torch, x, y, 0.0)
                   for n, x, y in zip(CTXB_NAMES, kb, rb)}
            ok = max(ulps.values()) <= CTXB_BF16_ULPS
            res["bf16_ulps"] = ulps
            log(f"{what}: bf16 ulps past {CTXB_BF16_ATOL_REL:g} x max: "
                + ", ".join(f"{n} {x:.2f} ({raw[n]:.2f} without)"
                            for n, x in ulps.items())
                + "; of max |value|: "
                + ", ".join(f"{n} {x:.3e}" for n, x in rel.items()))
        log(f"{what}: all-masked video's rows max |d_q| kernel "
            f"{masked_rows[0]:.3e}, plain {masked_rows[1]:.3e}")
        if not ok or not finite or min(masked_rows) <= 0:
            fail(f"{what} disagrees with its plain version")
        res[f"err_{tag}"] = max(max_diff(x, y) for x, y in zip(kb, rb))
        res[f"rel_{tag}"] = rel
        if tag == "f32":
            gb = gathered_bwd(torch, bwd, args, rep)
            torch.cuda.synchronize()
            grel = {n: max_diff(x, y) / max(float(y.float().abs().max()),
                                             1e-30)
                    for n, x, y in zip(CTXB_NAMES, kb, gb)}
            bitwise = {n: bool(torch.equal(x, y))
                       for n, x, y in zip(CTXB_NAMES[:3], kb, gb)}
            log(f"{what}: rep={rep} vs the gathered layout folded in row "
                "order: bitwise " + ", ".join(
                    f"{n} {b}" for n, b in bitwise.items())
                + "; of max |value|: "
                + ", ".join(f"{n} {x:.3e}" for n, x in grel.items()))
            if not all(bitwise.values()) or not grel["d_v"] <= CTXB_F32_RTOL:
                fail(f"{what}: rep={rep} differs from the gathered layout")
            res["gathered_rel"] = max(grel.values())
            res["gathered_bitwise"] = bitwise
            del gb
        del kb, rb
        res[f"ms_{tag}"] = time_call(torch, lambda: bwd(*args, rep=rep), REPS)
        res[f"device_ms_{tag}"] = device_ms(
            torch, lambda: bwd(*args, rep=rep), REPS, CTXB_LAUNCHES)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: bwd_ref(*args, rep=rep), 1)
        res[f"fwd_ms_{tag}"] = time_call(
            torch, lambda: fca(q, proj, mask, vals, v, rep=rep,
                               return_attn=True), REPS)
        res[f"fwd_device_ms_{tag}"] = device_ms(
            torch, lambda: fca(q, proj, mask, vals, v, rep=rep,
                               return_attn=True), REPS, CTX_LAUNCHES)
        isz = 2 if tag == "bf16" else 4
        res[f"bound_{tag}"] = rec_bound(*ctxb_work(R_XE, nv, isz),
                                        H100_F32_FLOPS)[:2]
        res[f"fwd_bound_{tag}"] = ctx_bound(R_XE, nv, isz, attn_out=True)
        log(f"times {tag}: fused_context_attention_bwd R={R_XE} rep={rep} "
            f"{res[f'ms_{tag}']:.4f} ms by the event clock, "
            f"{res[f'device_ms_{tag}']:.4f} ms device (plain "
            f"{res[f'plain_ms_{tag}']:.4f} ms; bound "
            f"{res[f'bound_{tag}'][0]:.4f} ms, {res[f'bound_{tag}'][1]}; SFU "
            f"floor {sfu_floor_ms(ctxb_work(R_XE, nv, isz)[2]):.4f} ms); the "
            f"forward with weights {res[f'fwd_ms_{tag}']:.4f} ms, "
            f"{res[f'fwd_device_ms_{tag}']:.4f} ms device (bound "
            f"{res[f'fwd_bound_{tag}'][0]:.4f} ms)")
    res["launches_per_call_bf16"] = ctx_launches(
        torch, lambda: bwd(*args, rep=rep), "fused_context_attention_bwd",
        CTXB_LAUNCHES)
    res["edges"] = check_context_bwd_edges(torch, ctx_mod)
    return res


CTXB_EDGE_SHAPES = ((1, CTXB_REP, F_ATT, A_ATT, E), (3, 7, 7, 264, 40),
                    (2, CTXB_REP, F_ATT, A_ATT, E))


def check_context_bwd_edges(torch, ctx_mod):
    """Phase 2g off the main shapes (``CTXB_EDGE_SHAPES``, as 2e's): each
    cotangent at the CTXB_* tiers, and against the gathered layout folded
    in row order (d_q, d_proj, d_vals bitwise; f32 d_v within
    CTXB_F32_RTOL)."""
    fca, bwd = ctx_mod.fused_context_attention, ctx_mod.fused_context_attention_bwd
    bwd_ref = ctx_mod.fused_context_attention_bwd_ref
    out = []
    for i, (nv, rep, F, A, Ee) in enumerate(CTXB_EDGE_SHAPES):
        a = ctx_edge_inputs(torch, 71 + i, nv, rep, F, A, Ee)
        for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            q, proj, vals, v, dctx = (a[k].to(DEVICE, cdt) for k in
                                      ("q", "proj", "vals", "v", "dctx"))
            mask = a["mask"].to(DEVICE)
            _, attn = fca(q, proj, mask, vals, v, rep=rep, return_attn=True)
            args = (q, proj, vals, v, attn, dctx)
            kb = bwd(*args, rep=rep)
            rb = bwd_ref(*args, rep=rep)
            gb = gathered_bwd(torch, bwd, args, rep)
            torch.cuda.synchronize()
            rel = {n: max_diff(x, y) / max(float(y.float().abs().max()), 1e-30)
                   for n, x, y in zip(CTXB_NAMES, kb, rb)}
            if tag == "f32":
                err = max(rel.values())
                ok = err <= CTXB_F32_RTOL
            else:
                err = max(bf16_ulps(torch, x, y, CTXB_BF16_ATOL_REL)
                          for x, y in zip(kb, rb))
                ok = err <= CTXB_BF16_ULPS
            bitwise = all(bool(torch.equal(x, y))
                          for x, y in zip(kb[:3], gb[:3]))
            dv_rel = max_diff(kb[3], gb[3]) / max(
                float(gb[3].float().abs().max()), 1e-30)
            what = (f"fused_context_attention_bwd {tag} {nv} videos x "
                    f"rep={rep}, F={F}, A={A}, E={Ee}")
            log(f"{what}: {'of max |value|' if tag == 'f32' else 'bf16 ulps'}"
                f" {err:.3e}; d_q, d_proj, d_vals bitwise the gathered layout "
                f"folded in row order {bitwise}, d_v {dv_rel:.3e} of max")
            if not ok or not all(bool(torch.isfinite(x.float()).all())
                                 for x in kb):
                fail(f"{what} disagrees with its plain version")
            if not bitwise or (tag == "f32" and dv_rel > CTXB_F32_RTOL):
                fail(f"{what}: rep={rep} differs from the gathered layout")
            out.append(dict(videos=nv, rep=rep, F=F, A=A, E=Ee, dtype=tag,
                            err=err, gathered_dv_rel=dv_rel))
    return out


# ------------------------------------------------------------ phase 2h

# The int8w decoders (the four fused decode kernels with quant=) against
# their plain versions at the msrvtt_serve_beam5 shape, on phase 2 / 2c's
# weights quantized by the port's quantize_params in the model's layout
# (emb per row, w_out per column, one (4H,) scale over the stacked gate
# rows, att_wh per column).  float32 compute: tokens exact, scores /
# log-probs within F32_ATOL; bfloat16 compute at the float kernels' tiers
# (KERNEL_BF16_MATCH_FLOOR meanpool, KERNEL_ATT_BF16_MATCH_FLOOR
# attention, score rtol KERNEL_BF16_SCORE_RTOL); a multi-tile vocab with
# a padded tail (QV_TAIL, not a multiple of the kernels' 128 columns or
# the reference's tile) at float32, no token in the padding.
QV_TAIL = 1_100
Q_TOLERANCE = ("int8 weights with per-channel scales, " + TOLERANCE
               + f"; a V={QV_TAIL} padded tail at f32 exact, no token in "
               "the padding")
Q_ATT_TOLERANCE = ("int8 weights with per-channel scales, "
                   + decode_tolerance(KERNEL_ATT_BF16_MATCH_FLOOR)
                   + f" (seed 0); a V={QV_TAIL} padded tail at f32 exact")
Q_LIBRARY = ("none: no single PyTorch call computes it (cuDNN on "
             "dequantized weights would put the scale inside the sum)")


def quantize_decoder(torch, a, attention: bool):
    """Phase 2's float decoder operands ``a`` with their weights
    quantized by ``quantize_params`` as the model stores them.  Returns
    (operands with int8 codes, the quant tuple), on the CPU."""
    from cst_captioning_torch.ops.quant import quantize_params

    rows = ["w_x", "w_ctx", "wh"] if attention else ["w_x", "wh"]
    tree = {"word_embed": a["emb"], "logit_w": a["w_out"],
            "lstm0_w": torch.cat([a[k] for k in rows])}
    if attention:
        tree["att_wh"] = a["att_wh"]
    q = quantize_params(tree)
    out = dict(a, emb=q["word_embed"], w_out=q["logit_w"])
    r = 0
    for k in rows:
        out[k] = q["lstm0_w"][r: r + a[k].shape[0]]
        r += a[k].shape[0]
    quant = (q["word_embed_scale"], q["logit_w_scale"], q["lstm0_w_scale"])
    if attention:
        out["att_wh"] = q["att_wh"]
        quant += (q["att_wh_scale"],)
    return out, quant


def q_to_card(torch, qa, quant, cdt):
    """int8 codes and float32 scales to the card as they are; the float
    attention operands in ``cdt``; gx_static, b_out and att_mask f32."""
    out = {}
    for k, v in qa.items():
        if v.dtype == torch.int8 or k in ("gx_static", "b_out", "att_mask"):
            out[k] = v.to(DEVICE).contiguous()
        else:
            out[k] = v.to(DEVICE, cdt).contiguous()
    return list(out.values()), tuple(x.to(DEVICE) for x in quant)


def q_decoders(beam_mod, sam_mod, attention: bool, quant, cdt):
    """``decoders`` bound to the int8w mode: each call passes ``quant``
    and the compute dtype; the names gain ``_q``."""
    def bind(fn):
        def call(*args, **kw):
            return fn(*args, quant=quant, compute_dtype=cdt, **kw)
        call.__name__ = fn.__name__ + "_q"
        return call

    return tuple(bind(f) for f in decoders(beam_mod, sam_mod, attention))


def check_quant_decoders(torch, beam_mod, sam_mod, attention: bool):
    """Phase 2h for one fusion (see the module docstring)."""
    from cst_captioning_torch.decoding.beam import finalize_beams

    fusion = "attention" if attention else "meanpool"
    base = make_att_inputs(torch, 0) if attention else make_inputs(torch, 0)
    qa, quant = quantize_decoder(torch, base, attention)
    floor = (KERNEL_ATT_BF16_MATCH_FLOOR if attention
             else KERNEL_BF16_MATCH_FLOOR)
    res = {}
    v32, q32 = q_to_card(torch, qa, quant, torch.float32)
    f32_fns = q_decoders(beam_mod, sam_mod, attention, q32, torch.float32)
    res["beam_f32_err"], res["sample_f32_err"], _ = hold_f32(
        torch, f32_fns, v32, f"int8w {fusion} main shape", k=K, t=T)

    # the padded-tail vocab: the first QV_TAIL words of the same model
    tail = dict(qa)
    tail["emb"], tail["b_out"] = qa["emb"][:QV_TAIL], qa["b_out"][:QV_TAIL]
    tail["w_out"] = qa["w_out"][:, :QV_TAIL].contiguous()
    tq = (quant[0][:QV_TAIL], quant[1][:QV_TAIL]) + quant[2:]
    vt, qt = q_to_card(torch, tail, tq, torch.float32)
    fns_t = q_decoders(beam_mod, sam_mod, attention, qt, torch.float32)
    _, _, seqs = hold_f32(torch, fns_t, vt, f"int8w {fusion} V={QV_TAIL}",
                          k=K, t=T)
    greedy = fns_t[2](*vt, (0, 0), max_len=T, greedy=True)[0]
    top = max(int(seqs.max()), int(greedy.max()))
    log(f"int8w {fusion} V={QV_TAIL}: largest token id {top}")
    if top >= QV_TAIL:
        fail(f"int8w {fusion}: a token in the padded vocab tail")

    v16, q16 = q_to_card(torch, qa, quant, torch.bfloat16)
    beam, beam_ref, sample, sample_ref = q_decoders(
        beam_mod, sam_mod, attention, q16, torch.bfloat16)
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
    for tag, args, fns in (("bf16", v16, (beam, beam_ref, sample,
                                          sample_ref)),
                           ("f32", v32, f32_fns)):
        b_k, b_r, s_k, s_r = fns
        res[f"beam_ms_{tag}"] = time_call(
            torch, lambda: b_k(*args, beam_size=K, max_len=T), REPS)
        res[f"beam_plain_ms_{tag}"] = time_call(
            torch, lambda: b_r(*args, beam_size=K, max_len=T), 1)
        res[f"sample_ms_{tag}"] = time_call(
            torch, lambda: s_k(*args, (0, 0), max_len=T, greedy=True), REPS)
        res[f"sample_plain_ms_{tag}"] = time_call(
            torch, lambda: s_r(*args, (0, 0), max_len=T, greedy=True), 1)
        log(f"times {tag}: {b_k.__name__} {res[f'beam_ms_{tag}']:.3f} ms "
            f"(plain {res[f'beam_plain_ms_{tag}']:.3f} ms), {s_k.__name__} "
            f"greedy {res[f'sample_ms_{tag}']:.3f} ms (plain "
            f"{res[f'sample_plain_ms_{tag}']:.3f} ms)")
    res["launches_per_call_bf16"] = decode_breakdowns(
        torch, beam, sample, v16,
        ATT_DEC_LAUNCHES if attention else MEANPOOL_DEC_LAUNCHES)
    return res


def q_decode_work(rows: int, attention: bool, out_bytes: int):
    """FLOPs and compulsory bytes of one bf16-compute int8w decode call:
    the float call's operations; the weights as int8 codes plus their
    float32 scales."""
    if attention:
        flops, nbytes, _ = att_decode_work(rows, 2, out_bytes)
        w = E * 4 * H + H * A_ATT
        nbytes += A_ATT * 4 - w                   # 2 bytes -> 1, + scale
    else:
        flops, nbytes = decode_work(rows, 2, out_bytes)
    w = (E + H) * 4 * H + V * E + H * V
    nbytes -= w                                   # 2 bytes -> 1 a weight
    nbytes += (4 * H + 2 * V) * 4                 # the scales
    return flops, nbytes


# ------------------------------------------------------------ phase 2i

# The int8w recurrences against their plain versions at the XE shape (R
# = 1280, T = 29; attention F = 56, A = E = 512), on phase 2b / 2d's
# inputs with the weights quantized as the model stores them: float32
# h_seq within the 2b / 2d bound (REC_F32_ATOL); bfloat16 h_seq within
# REC_BF16_H_ATOL and QREC_BF16_ULPS bf16 ulps past ATT_BWD_BF16_ATOL_REL
# x max |h| (2d's measure).
QREC_BF16_ULPS = 2.0
QREC_TOLERANCE = (f"int8 weights with per-channel scales; f32: |h diff| <= "
                  f"{REC_F32_ATOL:g} (max_abs_err_f32); bf16: |h diff| <= "
                  f"{REC_BF16_H_ATOL:g} (max_abs_err) and within "
                  f"{QREC_BF16_ULPS:g} bf16 ulps past "
                  f"{ATT_BWD_BF16_ATOL_REL:g} x max |h|")


def q_rec_work(R: int, T: int, attention: bool):
    """(FLOPs, compulsory bytes, tanh count) of one bf16-compute int8w
    recurrence call: read gx, the int8 codes and their scales (and the
    per-video attention tensors), write h_seq; no residuals."""
    if attention:
        (flops, _, tanh), _ = att_rec_work(R, T, 2, ATT_REP)
        w = H * 4 * H + E * 4 * H + H * A_ATT
        nv = R // ATT_REP
        att_in = nv * F_ATT * (A_ATT + E) * 2 + nv * F_ATT * 4 + A_ATT * 2
        nbytes = (R * T * 4 * H * 4 + w + (4 * H + A_ATT) * 4 + att_in
                  + R * T * H * 2)
        return flops, nbytes, tanh
    flops = 2 * R * H * 4 * H * T
    return (flops, R * T * 4 * H * 4 + H * 4 * H + 4 * H * 4 + R * T * H * 2,
            0)


def hold_quant_rec(torch, what: str, kh, rh, res, tag: str):
    err = max_diff(kh, rh)
    if tag == "f32":
        ok = err <= REC_F32_ATOL
        log(f"{what} f32: max |h diff| {err:.3e}")
    else:
        ulps = bf16_ulps(torch, kh, rh, ATT_BWD_BF16_ATOL_REL)
        ok = err <= REC_BF16_H_ATOL and ulps <= QREC_BF16_ULPS
        res["bf16_ulps"] = ulps
        log(f"{what} bf16: max |h diff| {err:.3e}, {ulps:.2f} bf16 ulps past "
            f"{ATT_BWD_BF16_ATOL_REL:g} x max |h| (share of h differing "
            f"{float((kh != rh).float().mean()):.2e})")
    if not ok or not bool(torch.isfinite(kh.float()).all()):
        fail(f"{what} {tag} disagrees with its plain version")
    res[f"{tag}_err"] = err


def check_quant_recurrences(torch, lstm_mod, att_mod):
    """Phase 2i (see the module docstring)."""
    from cst_captioning_torch.ops.quant import quantize_per_channel

    out = {"lstm": {}, "att": {}}
    gx, wh, _ = rec_inputs(torch, 11, R_XE, T_XE)
    wq, ws = (x.to(DEVICE) for x in quantize_per_channel(wh.cpu(), 1))
    k_fn, r_fn = lstm_mod.lstm_recurrence_quant, lstm_mod.lstm_recurrence_quant_ref
    res = out["lstm"]
    for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        kh = k_fn(gx, wq, ws, cdt)
        rh = r_fn(gx, wq, ws, cdt)
        torch.cuda.synchronize()
        hold_quant_rec(torch, f"lstm_recurrence_q R={R_XE} T={T_XE}", kh, rh,
                       res, tag)
        res[f"ms_{tag}"] = time_call(torch, lambda: k_fn(gx, wq, ws, cdt),
                                     REPS)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: r_fn(gx, wq, ws, cdt), 1)
        log(f"times {tag}: lstm_recurrence_q {res[f'ms_{tag}']:.3f} ms "
            f"(plain {res[f'plain_ms_{tag}']:.3f} ms)")

    a32, _ = att_rec_inputs(torch, 21, R_XE, T_XE)
    gxa, wha, wctx, awh, av, proj, mask, vals = a32
    rows = att_rows(a32, ATT_REP)
    lq, ls = quantize_per_channel(torch.cat([wctx, wha]).cpu(), 1)
    lq = lq.to(DEVICE)
    wctx_q, wh_q = lq[:E], lq[E:]
    awh_q, asc = (x.to(DEVICE) for x in quantize_per_channel(awh.cpu(), 1))
    ls = ls.to(DEVICE)
    k_fn, r_fn = att_mod.attlstm_recurrence_quant, att_mod.attlstm_recurrence_quant_ref
    res = out["att"]
    for tag, cdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = (gxa, wh_q, wctx_q, ls, awh_q, asc, av.to(cdt), proj.to(cdt),
                mask, vals.to(cdt), cdt)
        gathered = args[:7] + (rows[5].to(cdt), rows[6], rows[7].to(cdt), cdt)
        kh = k_fn(*args, rep=ATT_REP)
        rh = r_fn(*args, rep=ATT_REP)
        same = bool(torch.equal(kh, k_fn(*gathered, rep=1)))
        torch.cuda.synchronize()
        hold_quant_rec(torch, f"attlstm_recurrence_q R={R_XE} "
                       f"(rep={ATT_REP}) T={T_XE} F={F_ATT}", kh, rh, res, tag)
        log(f"attlstm_recurrence_q {tag}: rep={ATT_REP} vs rep=1 on the "
            f"repeated tensors bitwise: {same}")
        if not same:
            fail(f"attlstm_recurrence_q {tag} at rep={ATT_REP} differs from "
                 "rep=1 on the repeated tensors")
        res[f"ms_{tag}"] = time_call(torch, lambda: k_fn(*args, rep=ATT_REP),
                                     REPS)
        res[f"plain_ms_{tag}"] = time_call(
            torch, lambda: r_fn(*args, rep=ATT_REP), 1)
        log(f"times {tag}: attlstm_recurrence_q {res[f'ms_{tag}']:.3f} ms "
            f"(plain {res[f'plain_ms_{tag}']:.3f} ms)")
        if tag == "bf16":
            for kname, ms, count in kernel_breakdown(
                    torch, lambda: k_fn(*args, rep=ATT_REP)):
                log(f"breakdown bf16 attlstm_recurrence_q: {kname} {ms:.3f} "
                    f"ms over {count} launches")
    return out


# ------------------------------------------------------------ phase 3

def post(url: str, payload) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def serve_mode(torch, mode: str, params, vocab, counter_fn, reset_fn,
               fusion: str, extra=()):
    """Boot the ladder server in ``mode`` with ``fusion`` (and the CLI
    flags ``extra``), POST concurrent requests, return (launches,
    responses, metrics text, stats, wall seconds, engine description)."""
    from cst_captioning_torch.config import parse_cli
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    cfg = parse_cli([
        "--preset", "msrvtt_serve_beam5", "--serving.continuous", "false",
        "--serving.port", "0", "--serving.decode_mode", mode,
        "--model.feature_fusion", fusion, *extra,
    ])
    engine = InferenceEngine(cfg, params=params, vocab=vocab, device=DEVICE)
    server = CaptionServer(engine).start()
    desc = engine.describe()
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
    return launches, out, metrics, stats, wall, desc


def check_engine(torch, kernels, fusion: str, dtype: str = "f32"):
    """Phase 3 (meanpool) / 3b (attention), and 3d's ladder runs at
    ``serving.dtype`` int8w: ``kernels`` maps each decode mode to the
    wrapper whose launches it must count (its ``launches``, or under
    int8w its ``quant_launches``)."""
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
    attr = "quant_launches" if dtype == "int8w" else "launches"
    for mode, fn in kernels.items():
        def reset(fn=fn):
            setattr(fn, attr, 0)

        launches, out, metrics, stats, wall, desc = serve_mode(
            torch, mode, params, vocab, lambda fn=fn: getattr(fn, attr),
            reset, fusion, extra=("--serving.dtype", dtype))
        if desc["serving_dtype"] != dtype:
            fail(f"{fusion} {mode}: the engine serves {desc['serving_dtype']}"
                 f", not {dtype}")
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
            fail(f"{fusion} {mode} {dtype}: {fn.__name__} ({attr}) was not "
                 "launched on the serving path")
        lat = stats["latency_ms"]
        log(f"serve {fusion} {mode} {dtype}: {N_REQUESTS} requests in "
            f"{wall:.3f} s, batches {stats['batches']}, {fn.__name__} "
            f"{attr} {launches}, "
            f"device p50 {lat['device']['p50_ms']} ms, total p50 "
            f"{lat['total']['p50_ms']} ms")
        log(f"serve {fusion} {mode}: first caption "
            f"{out[0]['caption'][:80]!r}")
        res[mode] = launches
    return res


# ------------------------------------------------------------ phase 3c

N_BURST, N_STAGGER = 96, 32   # requests per run: a burst, then arrivals
STAGGER_S = 0.02              # between staggered arrivals
BREAKDOWN_TICKS = 10
# bf16 served captions vs the ladder's fused kernels.  The two paths
# add the same products in other orders, and bf16 rounds h and the
# query every step, so a last-bit f32 difference can flip a rounding
# and, over 30 fed-back steps, a caption.  On a random-init model the
# logits carry no margins: the first H100 run read 0.4062 served vs
# ladder (meanpool beam), and a CPU run of the same model found each
# path's bf16 captions matching its own f32 captions on only 0.19-0.78
# of requests.  So the relaxed-serving floor (0.75) is held where the
# ladder kernel's own bf16-vs-f32 match allows it, else that witness
# less this margin (about two standard errors of a share over 128
# requests).
SERVE_WITNESS_MARGIN = 0.1
# f32 served captions vs the ladder's fused kernels: the two are
# independent code (the per-step products and context kernel vs the
# whole-decode kernel, each held to its plain version) that compute the
# same function and differ only in summation order.  Held at no more
# than SERVE_LADDER_F32_SLACK differing captions, or, if more, no more
# than summation order alone moves (the offline per-step decode vs
# itself on the model with its hidden units permuted,
# ``permuted_model``); score rtol over the matches <= SERVE_LADDER_F32_RTOL.
SERVE_LADDER_F32_SLACK = 2
SERVE_LADDER_F32_RTOL = 1e-6


def make_bodies(np, cfg, n: int, seed: int):
    """``n`` requests at MSR-VTT widths: per modality a random frame
    count in [1, max_frames] (masked tails) of standard normal features
    rounded to 3 decimals.  Returns (payloads with float32 arrays, the
    JSON bodies); the server parses the bodies to the same float32."""
    rng = np.random.RandomState(seed)
    payloads, bodies = [], []
    for _ in range(n):
        raw = {}
        for m in cfg.data.feature_modalities:
            nf = int(rng.randint(1, cfg.data.max_frames + 1))
            raw[m] = np.round(rng.standard_normal(
                (nf, cfg.data.feature_dims[m])), 3)
        payloads.append({"features": {m: a.astype(np.float32)
                                      for m, a in raw.items()}})
        bodies.append(json.dumps({"features": {
            m: a.tolist() for m, a in raw.items()}}).encode())
    return payloads, bodies


def post_body(url: str, body: bytes) -> dict:
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"},
        method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def continuous_cfg(mode: str, fusion: str, f32: bool, dtype: str = "f32"):
    from cst_captioning_torch.config import parse_cli

    argv = ["--preset", "msrvtt_serve_beam5", "--serving.port", "0",
            "--serving.decode_mode", mode, "--model.feature_fusion", fusion,
            "--serving.dtype", dtype]
    if f32:
        argv += ["--model.compute_dtype", "float32"]
    return parse_cli(argv)


def serve_continuous(torch, cfg, params, vocab, bodies, order, counted,
                     prep=None):
    """Boot the default (continuous) server, send ``bodies`` in
    ``order`` (a burst of N_BURST, then N_STAGGER arrivals STAGGER_S
    apart), with every count in ``counted`` zeroed just before (its
    ``quant_launches`` too, where it has one: read as ``<name>_quant``).
    ``prep(engine)`` runs before the server starts.  Returns the run's
    readings and the engine."""
    from cst_captioning_torch.serving.engine import InferenceEngine
    from cst_captioning_torch.serving.server import CaptionServer

    engine = InferenceEngine(cfg, params=params, vocab=vocab, device=DEVICE)
    if prep is not None:
        prep(engine)
    if not cfg.serving.continuous:
        fail("msrvtt_serve_beam5 no longer defaults to the slot loop")
    server = CaptionServer(engine).start()
    dec = engine.slot_decoder()
    out, errs = {}, []

    def worker(i):
        try:
            out[i] = post_body(server.url + "/v1/caption", bodies[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(f"{type(e).__name__}: {e}")

    try:
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
            if hasattr(fn, "quant_launches"):
                fn.quant_launches = 0
        steps0 = dec.steps_run
        t0 = time.perf_counter()
        ths = [threading.Thread(target=worker, args=(i,))
               for i in order[:N_BURST]]
        for t in ths:
            t.start()
        for i in order[N_BURST:]:
            time.sleep(STAGGER_S)
            ths.append(threading.Thread(target=worker, args=(i,)))
            ths[-1].start()
        for t in ths:
            t.join()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        launches.update({fn.__name__ + "_quant": fn.quant_launches
                         for fn in counted if hasattr(fn, "quant_launches")})
        steps = dec.steps_run - steps0
        with urllib.request.urlopen(server.url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        with urllib.request.urlopen(server.url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
    if errs:
        fail(f"continuous requests failed: {errs[:3]}")
    return dict(out=out, launches=launches, steps=steps, wall=wall,
                metrics=metrics, stats=stats), engine


def permuted_model(torch, model, seed: int):
    """A copy of ``model`` with its hidden units reordered: every output
    is the same in exact arithmetic, but the sums over H (gates, query,
    vocab logits) run in another order."""
    import copy

    m = copy.deepcopy(model)
    m._kw_key = None    # the copy's weight versions restart
    Hm, E2 = m.rnn_size, 2 * m.embed_size
    perm = torch.randperm(Hm, generator=torch.Generator().manual_seed(seed))
    perm = perm.to(m.device)
    cols = torch.cat([perm + j * Hm for j in range(4)])
    with torch.no_grad():
        w = m.lstm0_w[:, cols].clone()
        w[E2:] = w[E2:][perm]
        m.lstm0_w.copy_(w)
        m.lstm0_b.copy_(m.lstm0_b[cols].clone())
        m.logit_w.copy_(m.logit_w[perm].clone())
        if m.fusion == "attention":
            m.att_wh.copy_(m.att_wh[perm].clone())
    return m


def offline_decodes(torch, engine, payloads, witness: bool = False):
    """The same requests decoded offline, as one batch: the per-step
    decode (``beam_search_from_state`` / ``_sample_from_cache``) and the
    ladder's fused kernel (``beam_search`` / ``sample``, in chunks of the
    ladder top); with ``witness``, the per-step decode again on the
    model with its hidden units permuted ("per_step_permuted").  Returns
    {name: (tokens (n, L), scores (n,) or None)}."""
    from cst_captioning_torch.decoding.beam import (
        beam_search,
        beam_search_from_state,
    )

    m, ev = engine.model, engine.cfg.eval
    reqs = [engine.prepare(p) for p in payloads]
    feats, masks = engine._assemble(reqs, len(reqs))
    state, cache = m.init_decode(feats, masks)
    kw = dict(max_len=ev.max_decode_len)
    out = {}
    if witness:
        mp = permuted_model(torch, m, seed=5)
        if engine.decode_mode == "beam":
            r = beam_search_from_state(
                mp, *mp.init_decode(feats, masks), beam_size=ev.beam_size,
                length_normalize=ev.length_normalize, **kw)
            out["per_step_permuted"] = (r.tokens, r.score)
        else:
            out["per_step_permuted"] = (mp._sample_from_cache(
                *mp.init_decode(feats, masks), **kw).tokens, None)
        del mp
    if engine.decode_mode == "beam":
        r = beam_search_from_state(m, state, cache, beam_size=ev.beam_size,
                                   length_normalize=ev.length_normalize, **kw)
        out["per_step"] = (r.tokens, r.score)
        toks, scores = [], []
        for i in range(0, len(reqs), engine.max_batch):
            f = {k: v[i: i + engine.max_batch] for k, v in feats.items()}
            mk = {k: v[i: i + engine.max_batch] for k, v in masks.items()}
            r = beam_search(m, f, mk, beam_size=ev.beam_size,
                            length_normalize=ev.length_normalize, **kw)
            toks.append(r.tokens)
            scores.append(r.score)
        out["ladder"] = (torch.cat(toks), torch.cat(scores))
        return out
    out["per_step"] = (m._sample_from_cache(state, cache, **kw).tokens, None)
    toks = []
    for i in range(0, len(reqs), engine.max_batch):
        f = {k: v[i: i + engine.max_batch] for k, v in feats.items()}
        mk = {k: v[i: i + engine.max_batch] for k, v in masks.items()}
        toks.append(m.sample(f, mk, greedy=True, **kw).tokens)
    out["ladder"] = (torch.cat(toks), None)
    return out


def token_match(a, b) -> float:
    """Share of rows of ``a`` and ``b`` ((n, L) token ids) that agree."""
    return float((a.cpu() == b.cpu()).all(-1).float().mean())


def caption_match(served, tokens, scores):
    """(share of requests whose served tokens equal ``tokens``, max score
    rtol over the matches or None, max |score diff| over the matches)."""
    tok = tokens.cpu().numpy()
    same = [served[i]["tokens"] == [int(t) for t in tok[i]]
            for i in range(len(tok))]
    share = sum(same) / len(same)
    if scores is None or not any(same):
        return share, None, None
    sc = scores.float().cpu().numpy()
    gaps = [abs(served[i]["score"] - float(sc[i])) for i in range(len(sc))
            if same[i]]
    rtol = max(g / max(abs(float(sc[i])), 1e-6)
               for g, i in zip(gaps, [i for i in range(len(sc)) if same[i]]))
    return share, rtol, max(gaps)


def front_end_cost(engine, bodies, what: str):
    """The front end's host work per request, one request at a time on
    the scheduler's host: the body's ``json.loads`` (as the server's
    handler does) and ``engine.prepare``.  Under a burst the handler
    threads do this work concurrently with the scheduler thread, in the
    same process."""
    t_json = t_prep = 0.0
    for body in bodies:
        t0 = time.perf_counter()
        payload = json.loads(body)
        t1 = time.perf_counter()
        engine.prepare(payload)
        t_json += t1 - t0
        t_prep += time.perf_counter() - t1
    n = len(bodies)
    out = {"json_ms": t_json * 1e3 / n, "prepare_ms": t_prep * 1e3 / n,
           "body_mb": sum(len(b) for b in bodies) / n / 1e6,
           "serial_s": t_json + t_prep}
    log(f"{what}: front end host work per request (mean over {n}, "
        f"{out['body_mb']:.3f} MB bodies): json.loads {out['json_ms']:.3f} "
        f"ms, engine.prepare {out['prepare_ms']:.3f} ms; all {n} in series "
        f"{out['serial_s']:.3f} s")
    return out


def slot_breakdown(torch, engine, payloads, what: str, card: str):
    """Where one slot-loop step's time goes at the top bank, every slot
    occupied: host clock per tick (each tick ends in the host read of
    the done flags) over BREAKDOWN_TICKS ticks, then the profiler's
    device time by kernel over as many, grouped into the context
    kernel, the row-invariant GEMMs, the selection (top-K), the
    log-softmax and the rest; host gaps are the tick time the device
    spends idle."""
    from torch.profiler import ProfilerActivity, profile

    dec = engine.slot_decoder()
    dec.maybe_resize(dec.S_max)
    n = min(dec.S, dec.admit_cap, len(payloads))
    reqs = [engine.prepare(p) for p in payloads[:n]]
    dec.tick(reqs, list(range(n)))
    for _ in range(2):
        dec.tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BREAKDOWN_TICKS):
        dec.tick()
    tick_ms = (time.perf_counter() - t0) * 1e3 / BREAKDOWN_TICKS
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(BREAKDOWN_TICKS):
            dec.tick()
        torch.cuda.synchronize()
    groups = {"context kernel": 0.0, "row_gemm (query, gates, vocab)": 0.0,
              "selection (top-K)": 0.0, "log-softmax": 0.0, "other": 0.0}
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", 0)
              or getattr(e, "cuda_time_total", 0))
        if not us:
            continue
        k = e.key.lower()
        if "ctx_fwd_kernel" in k:
            g = "context kernel"
        elif "row_gemm" in k:
            g = "row_gemm (query, gates, vocab)"
        elif "topk" in k or "sort" in k or "radix" in k or "select" in k:
            g = "selection (top-K)"
        elif "softmax" in k:
            g = "log-softmax"
        else:
            g = "other"
        groups[g] += us / 1e3 / BREAKDOWN_TICKS
    for s in list(dec.occupied):
        dec.evict(s)
    busy = sum(groups.values())
    out = {"rows": n * dec.K, "tick_ms": tick_ms, "device_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / tick_ms), "groups": groups}
    log(f"slot step {what} ({n} slots, {n * dec.K} rows): {tick_ms:.3f} ms "
        f"per tick on the host clock, device busy {busy:.3f} ms (idle share "
        f"{out['idle_share']:.3f}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in groups.items()) + f"  [{card}]")
    if busy == 0.0:
        log("slot step breakdown: not measured (the profiler recorded no "
            "device time)")
    return out


def check_continuous(torch, card: str, fusion: str, counted):
    """Phase 3c for one fusion, beam and greedy: see the module
    docstring.  ``counted`` is the kernel wrappers whose launches each
    run reads: [fused_context_attention, row_dot]."""
    import numpy as np

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config

    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    base = get_preset("msrvtt_serve_beam5")
    base.model.vocab_size = len(vocab)
    base.model.feature_fusion = fusion
    model = model_from_config(base, device="cpu")
    model.init_weights(torch.Generator().manual_seed(base.train.seed))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    payloads, bodies = make_bodies(np, base, N_BURST + N_STAGGER, seed=17)
    n = len(bodies)
    res = {}
    for mode in ("beam", "greedy"):
        what = f"continuous {fusion} {mode}"
        r16, eng16 = serve_continuous(
            torch, continuous_cfg(mode, fusion, False), params, vocab,
            bodies, list(range(n)), counted)
        out = r16["out"]
        L = eng16.cfg.eval.max_decode_len
        for i in range(n):
            o = out.get(i)
            if not isinstance(o, dict) or not isinstance(o.get("caption"), str):
                fail(f"{what}: request {i} bad response {str(o)[:200]}")
            if len(o["tokens"]) != L or not all(0 <= t < V for t in o["tokens"]):
                fail(f"{what}: request {i} bad tokens {o['tokens'][:10]}")
        slots = r16["stats"]["slots"]
        lat = r16["stats"]["latency_ms"]
        ctx_n, rg_n = (r16["launches"][f.__name__] for f in counted)
        want_ctx = r16["steps"] if fusion == "attention" else 0
        log(f"{what} bf16: {n} requests in {r16['wall']:.3f} s, "
            f"{r16['steps']} decode steps, bank resizes "
            f"{slots['bank_resizes']}, steps/caption "
            f"{slots['steps_per_caption']}, launches "
            f"fused_context_attention {ctx_n}, row_dot {rg_n}; device p50 "
            f"{lat['device']['p50_ms']} p99 {lat['device']['p99_ms']} ms, "
            f"total p50 {lat['total']['p50_ms']} p99 "
            f"{lat['total']['p99_ms']} ms, admission p50 "
            f"{lat['admission']['p50_ms']} ms  [{card}]")
        if slots["bank_resizes"] < 1:
            fail(f"{what}: the slot bank never resized")
        if ctx_n != want_ctx or rg_n < 1:
            fail(f"{what}: fused_context_attention launched {ctx_n} times "
                 f"for {want_ctx} attention decode steps, row_dot {rg_n}")
        for fam in ("caption_slots_admitted_total", "caption_slot_bank_size",
                    "caption_latency_admission_ms_bucket",
                    "caption_steps_per_caption_bucket"):
            if fam not in r16["metrics"]:
                fail(f"{what}: /metrics lacks {fam}")
        row = res[f"{mode}_bf16"] = {
            "launches": r16["launches"], "steps": r16["steps"],
            "wall_s": r16["wall"], "bank_resizes": slots["bank_resizes"],
            "latency_ms": {k: lat[k] for k in ("admission", "device",
                                               "detok", "total")}}
        off16 = offline_decodes(torch, eng16, payloads)
        row["front_end"] = front_end_cost(eng16, bodies, what)
        row["step"] = slot_breakdown(torch, eng16, payloads,
                                     f"{fusion} {mode} bf16", card)
        del eng16

        runs = []
        for order in (list(range(n)), list(range(n))[::-1]):
            r32, eng32 = serve_continuous(
                torch, continuous_cfg(mode, fusion, True), params, vocab,
                bodies, order, counted)
            runs.append(r32)
        off32 = offline_decodes(torch, eng32, payloads, witness=True)
        del eng32
        a, b = runs[0]["out"], runs[1]["out"]
        moved = [i for i in range(n) if a[i]["tokens"] != b[i]["tokens"]]
        share, _, gap = caption_match(a, *off32["per_step"])
        lshare, lrtol, _ = caption_match(a, *off32["ladder"])
        l_off = round((1.0 - lshare) * n)
        w_off = round((1.0 - token_match(off32["per_step"][0],
                                         off32["per_step_permuted"][0])) * n)
        l_held = max(SERVE_LADDER_F32_SLACK, w_off)
        log(f"{what} f32: two arrival orders, requests whose tokens differ "
            f"{len(moved)}/{n}; served vs offline per-step decode caption "
            f"match {share:.4f} (max |score diff| {gap}); served vs the "
            f"ladder's fused kernel: captions differing {l_off}/{n} (held "
            f"<= {l_held}; order witness, the per-step decode vs itself "
            f"with hidden units permuted: {w_off}/{n}), score rtol over "
            f"matches {lrtol} (held <= {SERVE_LADDER_F32_RTOL:g})")
        if moved or share != 1.0:
            fail(f"{what} f32: served tokens depend on arrival order or "
                 "differ from the offline per-step decode")
        if l_off > l_held or (lrtol is not None
                              and lrtol > SERVE_LADDER_F32_RTOL):
            fail(f"{what} f32: served captions differ from the ladder's "
                 f"fused kernel on {l_off}/{n} requests (held <= {l_held}) "
                 f"or score rtol {lrtol}")
        res[f"{mode}_f32"] = {"orders_differ": len(moved),
                              "match_per_step": share,
                              "score_gap_per_step": gap,
                              "match_ladder": lshare,
                              "ladder_differ": l_off,
                              "ladder_differ_held": l_held,
                              "order_witness_differ": w_off,
                              "score_rtol_ladder": lrtol,
                              "steps": [x["steps"] for x in runs]}

        # bf16: the served captions against the offline per-step decode
        # (the same arithmetic) at the relaxed-serving tier; against the
        # ladder's fused kernel at that tier where this model allows it:
        # the floor drops to the ladder kernel's own bf16-vs-f32 match
        # less SERVE_WITNESS_MARGIN when bf16 rounding alone moves more
        # captions than the tier allows (see SERVE_WITNESS_MARGIN).
        witness = token_match(off16["ladder"][0], off32["ladder"][0])
        served_vs_f32 = token_match(
            torch.tensor([out[i]["tokens"] for i in range(n)]),
            off32["per_step"][0])
        floor = min(RELAXED_SERVING_MATCH_FLOOR,
                    witness - SERVE_WITNESS_MARGIN)
        for name in ("per_step", "ladder"):
            share, rtol, _ = caption_match(out, *off16[name])
            held = RELAXED_SERVING_MATCH_FLOOR if name == "per_step" else floor
            log(f"{what} bf16 served vs offline {name}: caption match "
                f"{share:.4f} (held >= {held:.4f}), max score rtol over "
                f"matches {rtol}")
            if share < held or (rtol is not None
                                and rtol > RELAXED_SERVING_SCORE_RTOL):
                fail(f"{what} bf16 vs offline {name} outside its tier")
            row[f"match_{name}"] = share
            row[f"score_rtol_{name}"] = rtol
        log(f"{what}: bf16 rounding witness, the ladder kernel's bf16 vs "
            f"f32 captions {witness:.4f}; served bf16 vs served f32 "
            f"{served_vs_f32:.4f}")
        row["ladder_bf16_vs_f32"] = witness
        row["served_bf16_vs_f32"] = served_vs_f32
        res[f"{mode}_int8w"] = check_int8w_continuous(
            torch, card, fusion, mode, params, vocab, payloads, bodies,
            off32, counted)
        if fusion == "meanpool" and mode == "beam":
            res["bf16_knob"] = check_bf16_serving(
                torch, card, params, vocab, bodies, out, counted)
    return res


# ------------------------------------------------------------ phase 3d

# int8w continuous serving (msrvtt_serve_beam5 --serving.dtype int8w, the
# slot loop with the int8 row_gemm): served captions against the same
# engine's offline per-step decode at the relaxed-serving tier (the same
# arithmetic), and against the float engine at f32 compute (phase 3c's
# offline per-step decode) at that tier where this random-init model
# allows it: as for bf16 in 3c, the floor drops to the int8w ladder
# kernel's own captions vs the f32 ladder's less SERVE_WITNESS_MARGIN
# when quantization and bf16 rounding alone move more captions than the
# tier allows.  Then two runs at float32 compute (``f32_compute``) in two
# arrival orders: the same tokens, equal to the offline per-step decode.
# The int8w engine's measured weight bytes must equal the closed form
# (quantized_leaf_bytes plus the float leaves), and its quantized leaves
# come to Q_BYTES_RATIO of their float32 bytes (0.25 plus the scales:
# 0.2517 at MSR-VTT widths).
Q_BYTES_RATIO = (0.25, 0.26)


def check_responses(out, n: int, L: int, what: str):
    for i in range(n):
        o = out.get(i)
        if not isinstance(o, dict) or not isinstance(o.get("caption"), str):
            fail(f"{what}: request {i} bad response {str(o)[:200]}")
        if len(o["tokens"]) != L or not all(0 <= t < V for t in o["tokens"]):
            fail(f"{what}: request {i} bad tokens {o['tokens'][:10]}")


def f32_compute(torch, engine):
    """An int8w engine's model switched to float32 compute (int8 codes,
    float32 activations: the reference's weight_quant model at
    compute_dtype float32), before its slot loop is built.  The serving
    knob always pairs int8w with bf16; this configuration makes the
    arrival-order and offline comparisons exact."""
    engine.model.compute_dtype = torch.float32
    engine.model._kw_key = None
    engine._slot_decoder = None


def expected_param_bytes(model):
    """The int8w engine's weight bytes in closed form: ``quantized_leaf_
    bytes`` for each quantized leaf plus 4 bytes an element for the rest;
    and the quantized leaves' bytes against their float32 bytes."""
    from cst_captioning_torch.ops.quant import (
        SCALE_SUFFIX,
        quant_axis,
        quantized_leaf_bytes,
    )

    total = q_bytes = f_bytes = 0
    for name, p in model.state_dict().items():
        if name.endswith(SCALE_SUFFIX):
            continue
        axis = quant_axis(name)
        if axis is None:
            total += p.numel() * 4
        else:
            codes, scales = quantized_leaf_bytes(tuple(p.shape), axis)
            total += codes + scales
            q_bytes += codes + scales
            f_bytes += p.numel() * 4
    return total, q_bytes / f_bytes


def check_int8w_continuous(torch, card, fusion, mode, params, vocab, payloads,
                           bodies, off32, counted):
    """Phase 3d for one fusion and mode (see above)."""
    n = len(bodies)
    what = f"int8w continuous {fusion} {mode}"
    rq, engq = serve_continuous(
        torch, continuous_cfg(mode, fusion, False, "int8w"), params, vocab,
        bodies, list(range(n)), counted)
    out = rq["out"]
    check_responses(out, n, engq.cfg.eval.max_decode_len, what)
    desc = engq.describe()
    want_bytes, q_ratio = expected_param_bytes(engq.model)
    ctx_n, rg_n = (rq["launches"][f.__name__] for f in counted)
    rq_n = rq["launches"]["row_dot_quant"]
    want_ctx = rq["steps"] if fusion == "attention" else 0
    lat = rq["stats"]["latency_ms"]
    log(f"{what}: {n} requests in {rq['wall']:.3f} s, {rq['steps']} decode "
        f"steps, launches fused_context_attention {ctx_n}, row_dot {rg_n} "
        f"(int8 {rq_n}); serving_dtype {desc['serving_dtype']}, "
        f"param_bytes_per_shard {desc['param_bytes_per_shard']} (closed form "
        f"{want_bytes}; quantized leaves {q_ratio:.4f} of their f32 bytes); "
        f"device p50 {lat['device']['p50_ms']} ms, total p50 "
        f"{lat['total']['p50_ms']} p99 {lat['total']['p99_ms']} ms  [{card}]")
    if desc["serving_dtype"] != "int8w" or \
            desc["param_bytes_per_shard"] != want_bytes or \
            not Q_BYTES_RATIO[0] <= q_ratio <= Q_BYTES_RATIO[1]:
        fail(f"{what}: not an int8w engine, or its weight bytes are off "
             "the closed form")
    if rq_n < 1 or ctx_n != want_ctx:
        fail(f"{what}: row_dot's int8 path launched {rq_n} times, "
             f"fused_context_attention {ctx_n} for {want_ctx} steps")
    row = {"launches": rq["launches"], "steps": rq["steps"],
           "wall_s": rq["wall"], "param_bytes_per_shard":
           desc["param_bytes_per_shard"], "quantized_leaf_ratio": q_ratio,
           "latency_ms": {k: lat[k] for k in ("admission", "device",
                                               "detok", "total")}}
    offq = offline_decodes(torch, engq, payloads)
    del engq
    share, rtol, _ = caption_match(out, *offq["per_step"])
    log(f"{what} served vs its offline per-step decode: caption match "
        f"{share:.4f} (held >= {RELAXED_SERVING_MATCH_FLOOR}), max score "
        f"rtol over matches {rtol}")
    if share < RELAXED_SERVING_MATCH_FLOOR or (
            rtol is not None and rtol > RELAXED_SERVING_SCORE_RTOL):
        fail(f"{what} vs its offline per-step decode outside the tier")
    witness = token_match(offq["ladder"][0], off32["ladder"][0])
    floor = min(RELAXED_SERVING_MATCH_FLOOR, witness - SERVE_WITNESS_MARGIN)
    fshare, frtol, _ = caption_match(out, *off32["per_step"])
    log(f"{what} served vs the f32 engine's per-step decode: caption match "
        f"{fshare:.4f} (held >= {floor:.4f}; witness, the int8w ladder "
        f"kernel vs the f32 ladder kernel: {witness:.4f}), max score rtol "
        f"over matches {frtol} (held <= {RELAXED_SERVING_SCORE_RTOL})")
    if fshare < floor or (frtol is not None
                          and frtol > RELAXED_SERVING_SCORE_RTOL):
        fail(f"{what} vs the f32 engine outside its tier")
    row.update(match_per_step=share, score_rtol_per_step=rtol,
               match_f32=fshare, match_f32_floor=floor,
               score_rtol_f32=frtol, ladder_int8w_vs_f32=witness)

    runs = []
    for order in (list(range(n)), list(range(n))[::-1]):
        cfg = continuous_cfg(mode, fusion, False, "int8w")
        cfg.serving.warmup = False
        r32, eng32 = serve_continuous(
            torch, cfg, params, vocab, bodies, order, counted,
            prep=lambda e: f32_compute(torch, e))
        runs.append(r32)
    off = offline_decodes(torch, eng32, payloads)
    del eng32
    a, b = runs[0]["out"], runs[1]["out"]
    moved = [i for i in range(n) if a[i]["tokens"] != b[i]["tokens"]]
    share, _, gap = caption_match(a, *off["per_step"])
    log(f"{what} at f32 compute: two arrival orders, requests whose tokens "
        f"differ {len(moved)}/{n}; served vs offline per-step decode "
        f"caption match {share:.4f} (max |score diff| {gap}); int8 row_dot "
        f"launches {[r['launches']['row_dot_quant'] for r in runs]}")
    if moved or share != 1.0 or min(r["launches"]["row_dot_quant"]
                                     for r in runs) < 1:
        fail(f"{what} at f32 compute: served tokens depend on arrival order "
             "or differ from the offline per-step decode")
    row["f32_compute"] = {"orders_differ": len(moved),
                          "match_per_step": share,
                          "score_gap_per_step": gap}
    return row


def check_bf16_serving(torch, card, params, vocab, bodies, bf16_out,
                       counted):
    """Phase 3d's bf16 run: meanpool beam through the slot loop with
    ``--serving.dtype bf16``; the preset already computes in bf16, so the
    served tokens must equal phase 3c's bf16 run's."""
    n = len(bodies)
    what = "bf16 continuous meanpool beam"
    r, eng = serve_continuous(
        torch, continuous_cfg("beam", "meanpool", False, "bf16"), params,
        vocab, bodies, list(range(n)), counted)
    check_responses(r["out"], n, eng.cfg.eval.max_decode_len, what)
    desc = eng.describe()
    same = sum(r["out"][i]["tokens"] == bf16_out[i]["tokens"]
               for i in range(n))
    log(f"{what}: serving_dtype {desc['serving_dtype']}, compute "
        f"{eng.model.compute_dtype}, captions equal to the f32-knob bf16 "
        f"run {same}/{n}, row_dot launches {r['launches']['row_dot']}  "
        f"[{card}]")
    if desc["serving_dtype"] != "bf16" or same != n or \
            eng.model.compute_dtype != torch.bfloat16:
        fail(f"{what}: not the bf16 model, or its tokens moved")
    return {"match_f32_knob_run": same / n, "steps": r["steps"]}


def check_int8w_forward(torch, card, fusion: str, rec_fn, plain_fn):
    """Phase 3d's teacher-forced forward of an int8w model (the reference
    ``__call__`` under weight_quant) at the XE shape, 64 videos x 20
    captions x T_XE steps, random features at MSR-VTT widths: through
    ``rec_fn`` (the int8w recurrence kernel, whose launches are counted)
    at the serving dtype's bf16 compute; then at float32 compute kernel
    vs plain recurrence (``plain_fn`` swapped into the model), logits
    within REC_F32_ATOL."""
    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.models.weights import load_params
    from cst_captioning_torch.ops.quant import quantize_params

    cfg = get_preset("msrvtt_serve_beam5")
    cfg.model.vocab_size = V
    cfg.model.feature_fusion = fusion
    fm = model_from_config(cfg, device="cpu")
    fm.init_weights(torch.Generator().manual_seed(cfg.train.seed))
    model = model_from_config(cfg, serving_dtype="int8w", device="cpu")
    load_params(model, quantize_params(fm.state_dict()))
    model = model.to(DEVICE).requires_grad_(False)
    g = torch.Generator().manual_seed(29)
    nv, rep = R_XE // 20, 20
    feats = {m: torch.randn(nv, cfg.data.max_frames, cfg.data.feature_dims[m],
                            generator=g).to(DEVICE)
             for m in cfg.data.feature_modalities}
    masks = {m: att_mask(torch, g, nv, DEVICE)[:, :cfg.data.max_frames]
             for m in cfg.data.feature_modalities}
    ids = torch.randint(4, V, (R_XE, T_XE), generator=g).to(DEVICE)
    ids[:, 0] = 1
    name = rec_fn.__name__
    with torch.no_grad():
        torch.cuda.synchronize()
        rec_fn.launches = 0
        logits = model(feats, masks, ids, repeat=rep)
        torch.cuda.synchronize()
        launches = rec_fn.launches
        finite = bool(torch.isfinite(logits).all())
        shape = tuple(logits.shape)
        del logits
        model.compute_dtype = torch.float32
        model._kw_key = None
        k32 = model(feats, masks, ids, repeat=rep)
        setattr(captioner, name, plain_fn)
        try:
            r32 = model(feats, masks, ids, repeat=rep)
        finally:
            setattr(captioner, name, rec_fn)
        torch.cuda.synchronize()
        err = max_diff(k32, r32)
    log(f"int8w teacher-forced forward {fusion} R={R_XE} T={T_XE}: {name} "
        f"launches {launches}, logits {shape} finite {finite}; at f32 "
        f"compute kernel vs plain recurrence max |logit diff| {err:.3e} "
        f"(held <= {REC_F32_ATOL:g})  [{card}]")
    if launches != 1 or not finite or shape != (R_XE, T_XE, V) or \
            not err <= REC_F32_ATOL:
        fail(f"int8w teacher-forced forward {fusion}: launches {launches}, "
             f"finite {finite}, or kernel vs plain {err:.3e}")
    return {"launches": launches, "logit_err_f32": err}


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
            *tensors, rep = args
            h, c, a = att_mod.attlstm_recurrence_ref(*tensors, rep,
                                                     with_residuals=True)
            ctx.save_for_backward(*tensors, h, c, a)
            ctx.rep = rep
            return h

        @staticmethod
        def backward(ctx, dh):
            gx, wh, w_ctx, att_wh, att_v, proj, _, vals, h, c, a = \
                ctx.saved_tensors
            g = att_mod.attlstm_recurrence_bwd_ref(
                gx, wh, w_ctx, att_wh, att_v, proj, vals, h, c, a, dh,
                ctx.rep)
            return (*g[:6], None, g[6], None)

    return PlainAttRecurrence.apply


def xe_step_fn(torch, trainer, cfg, dtype: str = "float32"):
    """A copy of the trained model in ``dtype`` (float32 unless given)
    and one training batch.
    Returns ``run(ss_prob, seed, swap)`` -> (loss, gradients) of one XE
    step; ``seed`` seeds the step's generator (None: no dropout), and
    ``swap`` = (captioner attribute, function) replaces a kernel wrapper
    the model calls for the duration of the step."""
    import copy

    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.training.steps import xe_loss

    c32 = copy.deepcopy(cfg)
    c32.model.compute_dtype = dtype
    model = captioner.model_from_config(c32, device=DEVICE)
    model.load_state_dict(trainer.model.state_dict())
    batch = to_device(next(iter(trainer.train_iter.epoch(0))),
                      torch.device(DEVICE))
    params = list(model.parameters())

    def run(ss_prob=0.0, seed=99, swap=None):
        gen = (None if seed is None
               else torch.Generator(device=DEVICE).manual_seed(seed))
        if swap is not None:
            kernel = getattr(captioner, swap[0])
            setattr(captioner, swap[0], swap[1])
        try:
            loss = xe_loss(model, batch.feats, batch.feat_masks,
                           batch.captions, torch.ones_like(batch.weights),
                           gen, ss_prob)
            return float(loss.detach()), torch.autograd.grad(loss, params)
        finally:
            if swap is not None:
                setattr(captioner, swap[0], kernel)

    return run


def step_gap(torch, a, b):
    """(loss rtol, |grad a - grad b| / |grad b|) of two (loss, grads)."""
    from cst_captioning_torch.training.steps import global_norm

    gap = float(global_norm([x - y for x, y in zip(a[1], b[1])])
                / global_norm(b[1]))
    return abs(a[0] - b[0]) / abs(b[0]), gap


def check_xe_step(torch, trainer, cfg, kernel_name: str, plain_fn):
    """One XE step at float32 on the trained weights and one training
    batch: loss and gradients through the recurrence kernel(s) vs
    through ``plain_fn`` in place of ``captioner.<kernel_name>`` (the
    same dropout draw)."""
    run = xe_step_fn(torch, trainer, cfg)
    k, p = run(), run(swap=(kernel_name, plain_fn))
    loss_rtol, gap = step_gap(torch, k, p)
    log(f"XE step f32 {cfg.model.feature_fusion} kernel vs plain: loss "
        f"{k[0]:.6f} vs {p[0]:.6f} "
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
        cache = model._encode(b.feats, b.feat_masks)
        if model.fusion != "attention":  # attention stays per video
            cache = _repeat_cache(cache, S)
        mark(1)
        if model.fusion == "attention":
            h_seq = model._fused_attention_forward(cache, inputs, S)
        else:
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
        log(f"XE step bf16 {model.fusion} part: {name} {out[name]:.3f} ms  "
            f"[{card}]")
    total = ev[0].elapsed_time(ev[6])
    log(f"XE step bf16 {model.fusion} total {total:.3f} ms  [{card}]")
    out["total"] = total
    for kname, ms, count in kernel_breakdown(torch, one_step)[:15]:
        log(f"breakdown XE step bf16 {model.fusion}: {kname} {ms:.3f} ms over "
            f"{count} launches")
    return out


def train_cfg(fusion: str):
    """``msrvtt_resnet_c3d_xe`` with ``fusion``, 2 epochs, validating
    each."""
    from cst_captioning_torch.config import get_preset

    cfg = get_preset("msrvtt_resnet_c3d_xe")
    cfg.model.feature_fusion = fusion
    cfg.train.max_epochs = 2
    cfg.train.eval_every = 1
    return cfg


def build_trainer(torch, cfg, workdir: str):
    """The port's ``Trainer`` on ``cfg`` at full width over a generated
    MSR-VTT-width corpus (``make_msrvtt_corpus``), checkpoints under
    ``workdir``."""
    import numpy as np

    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.training.trainer import Trainer

    vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
    t0 = time.perf_counter()
    train_ds = make_msrvtt_corpus(np, vocab, cfg, N_TRAIN_VIDEOS, seed=1)
    val_ds = make_msrvtt_corpus(np, vocab, cfg, N_VAL_VIDEOS, seed=2)
    log(f"train corpus: {N_TRAIN_VIDEOS} + {N_VAL_VIDEOS} videos at "
        f"{cfg.data.feature_dims} x {cfg.data.max_frames} frames, "
        f"{cfg.data.seq_per_img} captions each, V={len(vocab)}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg.train.checkpoint_dir = workdir
    trainer = Trainer(cfg, train_ds, val_ds, device=DEVICE)
    m = trainer.model
    if (m.vocab_size, m.rnn_size, m.embed_size) != (V, H, E):
        fail(f"model widths {(m.vocab_size, m.rnn_size, m.embed_size)}")
    return trainer


def check_training(torch, card: str, fusion: str, counted, swap,
                   workdir: str):
    """Phase 4 (meanpool) / 4b (attention), see the module docstring.
    ``counted`` maps names to the wrappers whose launches the training
    run must count; ``swap`` is (captioner attribute, plain autograd
    function) for the f32 XE step check.  Checkpoints go under
    ``workdir`` (phase 5 warm-starts from them).  Returns the launch
    counts of the training run, the readings and the ``best``
    checkpoint's path."""
    import numpy as np

    cfg = train_cfg(fusion)
    res = {}
    trainer = build_trainer(torch, cfg, workdir)
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
    res["best"] = os.path.join(trainer.workdir, "best")
    return res


# ------------------------------------------------------------ phase 4c

SS_PROB_EPOCH1 = 0.25
SS_SIGMAS = 5.0


def plain_context_attention(torch, ctx_mod):
    """The context step through its plain forward and backward (for the
    kernel-vs-plain step on the per-step path); same signature as
    ``fused_context_attention``."""

    class PlainContextAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, proj, mask, vals, v, rep):
            out, attn = ctx_mod.fused_context_attention_ref(q, proj, mask,
                                                            vals, v, rep)
            ctx.rep = rep
            ctx.save_for_backward(q, proj, vals, v, attn)
            return out

        @staticmethod
        def backward(ctx, dctx):
            q, proj, vals, v, attn = ctx.saved_tensors
            g = ctx_mod.fused_context_attention_bwd_ref(q, proj, vals, v,
                                                        attn, dctx, ctx.rep)
            return g[0], g[1], None, g[2], g[3], None

    def call(q, proj, mask, vals, v, rep=1):
        return PlainContextAttention.apply(q, proj, mask, vals, v, rep)

    return call


def ss_step_breakdown(torch, trainer, card: str, fused_ms):
    """Where one bf16 training step on the per-step path (``ss_prob``
    0.25) goes: CUDA events around its parts after a warm-up step, each
    beside the same part of phase 4b's fused step (``fused_ms``, in
    ``step_breakdown``'s order); the sampling logits and draws (inside
    the loop) timed alone, T - 1 calls at the loop's shape; then the
    profiler's top device kernels."""
    from cst_captioning_torch.constants import PAD_ID
    from cst_captioning_torch.data.loader import to_device
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
    parts = ("encode", f"per-step forward loop ({T_XE} steps, incl. sampling)",
             "dropout + vocab GEMM", "loss (log-softmax)",
             "backward (autograd; fused_context_attention_bwd per step)",
             "optimizer")
    hold = {}

    def one_step(ev=None):
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        gen = torch.Generator(device=DEVICE).manual_seed(7)
        mark(0)
        cache = model._encode(b.feats, b.feat_masks)
        mark(1)
        h_seq = model._per_step_forward(cache, inputs, SS_PROB_EPOCH1, gen, S)
        mark(2)
        logits = model._logits(model._output_dropout(h_seq, gen))
        mark(3)
        loss = weighted_cross_entropy(logits, targets, tmask, w)
        mark(4)
        grads = torch.autograd.grad(loss, params)
        mark(5)
        opt.step(dict(zip(names, grads)))
        mark(6)
        hold["h"] = h_seq[:, 0].detach()

    one_step()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    one_step(ev)
    torch.cuda.synchronize()
    out = {}
    for i, name in enumerate(parts):
        out[name] = ev[i].elapsed_time(ev[i + 1])
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    with torch.no_grad():
        sample_ms = time_call(torch, lambda: model._sample_tokens(
            model._logits(hold["h"]), gen), REPS)
    out["of which sampling logits + draws"] = sample_ms * (T_XE - 1)
    out["total"] = ev[0].elapsed_time(ev[6])
    fused = list(fused_ms.items())
    for i, (name, ms) in enumerate(out.items()):
        beside = ""
        if i < len(parts) or name == "total":
            fname, fms = fused[i] if i < len(parts) else fused[-1]
            beside = f" (4b fused step, {fname}: {fms:.3f} ms)"
        log(f"SS step bf16 attention part: {name} {ms:.3f} ms{beside}  "
            f"[{card}]")
    for kname, ms, count in kernel_breakdown(torch, one_step)[:15]:
        log(f"breakdown SS step bf16 attention: {kname} {ms:.3f} ms over "
            f"{count} launches")
    return out


def check_ss_training(torch, card: str, counted, plain_ctx, fused_ms):
    """Phase 4c, see the module docstring.  ``counted`` maps names to the
    wrappers whose launches each epoch counts (the context kernels and
    the fused recurrence kernels); ``plain_ctx`` is the context step
    through its plain versions; ``fused_ms`` phase 4b's step breakdown,
    printed beside this one."""
    import numpy as np

    cfg = train_cfg("attention")
    cfg.model.scheduled_sampling_start = 0
    cfg.model.scheduled_sampling_increase_every = 1
    cfg.model.scheduled_sampling_increase_prob = SS_PROB_EPOCH1
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = build_trainer(torch, cfg, tmp)
        per_epoch, draws, sizes = {}, [], []
        inner_epoch = trainer.train_epoch
        feed_mask = trainer.model._feed_mask

        def counting_epoch(epoch, **kw):
            before = {n: fn.launches for n, fn in counted.items()}
            out = inner_epoch(epoch, **kw)
            per_epoch[epoch] = {n: fn.launches - before[n]
                                for n, fn in counted.items()}
            return out

        def recording_mask(*args):
            m = feed_mask(*args)
            draws.append(m.sum())
            sizes.append(m.numel())
            return m

        trainer.train_epoch = counting_epoch
        trainer.model._feed_mask = recording_mask
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        hist = trainer.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counted.items()}
        del trainer.model._feed_mask
        trainer.train_epoch = inner_epoch
        steps = trainer.train_iter.num_batches()
        e0, e1 = hist.get("0", {}), hist.get("1", {})
        log(f"train attention + scheduled sampling: {2 * steps} steps in "
            f"{wall:.1f} s incl. validation; ss_prob {e0.get('ss_prob')} / "
            f"{e1.get('ss_prob')}; loss {e0.get('train_loss', 0):.4f} "
            f"({e0.get('steps_per_sec', 0):.3f} steps/s, fused) / "
            f"{e1.get('train_loss', 0):.4f} ({e1.get('steps_per_sec', 0):.3f} "
            f"steps/s, per step)  [{card}]; launches per epoch {per_epoch}")
        if steps != 4 or sorted(hist) != ["0", "1"]:
            fail(f"expected 2 x 4 steps, history {sorted(hist)}")
        if (e0["ss_prob"], e1["ss_prob"]) != (0.0, SS_PROB_EPOCH1):
            fail(f"ss_prob per epoch {e0['ss_prob']}, {e1['ss_prob']}")
        if not all(np.isfinite([e0["train_loss"], e1["train_loss"],
                                e0["grad_norm"], e1["grad_norm"]])):
            fail("non-finite loss or grad norm under scheduled sampling")
        for d in ("best", "last"):
            if not os.path.exists(os.path.join(trainer.workdir, d,
                                               "params.pt")):
                fail(f"no {d} checkpoint")
        want = T_XE * steps
        p0, p1 = per_epoch[0], per_epoch[1]
        if (p0["fused_context_attention"] or p0["fused_context_attention_bwd"]
                or p0["attlstm_recurrence"] != steps
                or p1["fused_context_attention"] != want
                or p1["fused_context_attention_bwd"] != want
                or p1["attlstm_recurrence"]):
            fail(f"epoch 0 must take the fused recurrence ({steps} launches) "
                 f"and epoch 1 the context kernels ({want} launches each): "
                 f"{per_epoch}")
        n = sum(sizes)
        share = float(torch.stack(draws).sum()) / n
        sigma = (SS_PROB_EPOCH1 * (1 - SS_PROB_EPOCH1) / n) ** 0.5
        log(f"fed-sample share at t >= 1 over {len(draws)} draws, {n} rows "
            f"in all: {share:.5f} (ss_prob {SS_PROB_EPOCH1}, "
            f"{abs(share - SS_PROB_EPOCH1) / sigma:.2f} binomial sigmas)")
        if len(draws) != (T_XE - 1) * steps or not (
                abs(share - SS_PROB_EPOCH1) <= SS_SIGMAS * sigma):
            fail("the fed-sample share is off the scheduled-sampling "
                 "probability")
        res.update(launches=launches, per_epoch=per_epoch, fed_share=share,
                   fed_sigmas=abs(share - SS_PROB_EPOCH1) / sigma,
                   steps_per_sec=[e0["steps_per_sec"], e1["steps_per_sec"]],
                   losses=[e0["train_loss"], e1["train_loss"]])

        run = xe_step_fn(torch, trainer, cfg)
        zero = torch.tensor(0.0)
        k = run(zero, None)
        p = run(zero, None, swap=("fused_context_attention", plain_ctx))
        f = run(0.0, None)
        kp, kf = step_gap(torch, k, p), step_gap(torch, k, f)
        log(f"SS step f32 (ss_prob a tensor 0, no dropout): kernels vs "
            f"plain loss {k[0]:.6f} vs {p[0]:.6f} (rtol {kp[0]:.3e}), "
            f"|grad diff| / |grad| {kp[1]:.3e}; vs the fused attlstm_"
            f"recurrence step {f[0]:.6f} (rtol {kf[0]:.3e}), |grad diff| / "
            f"|grad| {kf[1]:.3e}")
        if kp[0] > XE_LOSS_RTOL or kp[1] > XE_GRAD_GAP:
            fail("the per-step training step through the kernels disagrees "
                 "with the plain versions")
        if kf[0] > XE_LOSS_RTOL or kf[1] > XE_GRAD_GAP:
            fail("the per-step training step disagrees with the fused "
                 "attlstm_recurrence step")
        run16 = xe_step_fn(torch, trainer, cfg, "bfloat16")
        kb = step_gap(torch, run16(zero, None), run16(
            zero, None, swap=("fused_context_attention", plain_ctx)))
        log(f"SS step bf16 (reported, not held): kernels vs plain loss rtol "
            f"{kb[0]:.3e}, |grad diff| / |grad| {kb[1]:.3e}")
        res["step_bf16_vs_plain"] = {"loss_rtol": kb[0], "grad_gap": kb[1]}
        res["step_f32_vs_plain"] = {"loss_rtol": kp[0], "grad_gap": kp[1]}
        res["step_f32_vs_fused"] = {"loss_rtol": kf[0], "grad_gap": kf[1]}
        res["step_ms"] = ss_step_breakdown(torch, trainer, card, fused_ms)
    return res


# ------------------------------------------------------------ phase 5

CST_PRESET = "msrvtt_cst_ms_scb"
CST_TIMED = 3     # timed CST steps, after one warm-up step
# The native CIDEr-D scorer against the Python scorer on the card's
# tokens: the C++ scorer keeps the reference vectors in float32, the
# Python one in float64, so the two differ in the last bit of some
# rewards; held at the reference's own tier for this pair
# (tests/test_native_ciderd.py).
SCORER_RTOL, SCORER_ATOL = 1e-5, 1e-6
CST_SEED_WORDS = (0x2545F491, 0x9E3779B9)  # the f32 rollout check's stream


def cst_trainer(torch, fusion: str, start_from: str, workdir: str,
                train_ds=None):
    """The port's ``Trainer`` on ``msrvtt_cst_ms_scb`` at full width
    (``fusion``), warm-started from ``start_from``, over phase 4's
    generated corpus (256 videos, seed 1; built unless ``train_ds`` is
    given).  Returns (trainer, corpus, the corpus's batches on the
    card)."""
    import numpy as np

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.training.trainer import Trainer

    cfg = get_preset(CST_PRESET)
    cfg.model.feature_fusion = fusion
    cfg.train.start_from = start_from
    cfg.train.checkpoint_dir = workdir
    cfg.train.max_epochs = 1
    if train_ds is None:
        vocab = Vocabulary([f"w{i}" for i in range(V - 4)])
        train_ds = make_msrvtt_corpus(np, vocab, cfg, N_TRAIN_VIDEOS, seed=1)
    trainer = Trainer(cfg, train_ds, None, device=DEVICE)
    m = trainer.model
    if (m.vocab_size, m.rnn_size, m.embed_size, m.fusion) != (V, H, E, fusion):
        fail(f"CST model widths {(m.vocab_size, m.rnn_size, m.embed_size)}")
    backend = trainer._train_step.scorer.backend
    if backend != "native":
        fail(f"the CST reward scorer is {backend!r}, not the native one")
    batches = [to_device(b, torch.device(DEVICE))
               for b in trainer.train_iter.epoch(0)]
    return trainer, train_ds, batches


def cst_probe(torch, model):
    """CUDA events around each rollout / greedy decode and the PG update
    of a CST step (wrappers on ``model.sample_cache`` and
    ``cst._pg_update``; events only, no synchronisation), and the last
    update's tokens, mask and advantage.  Returns (windows, last,
    restore)."""
    from cst_captioning_torch.training import cst as cst_mod

    windows = {"rollout": [], "greedy": [], "update": []}
    last = {}
    inner_sample, inner_pg = model.sample_cache, cst_mod._pg_update

    def timed(kind, fn, *args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*args, **kw)
        ev[1].record()
        windows[kind].append(ev)
        return out

    def sample_cache(cache, seed, **kw):
        return timed("greedy" if kw["greedy"] else "rollout", inner_sample,
                     cache, seed, **kw)

    def pg_update(model_, opt, feats, masks, S, tokens, mask, adv, *args):
        last.update(tokens=tokens, mask=mask, adv=adv, feats=feats,
                    masks=masks)
        return timed("update", inner_pg, model_, opt, feats, masks, S,
                     tokens, mask, adv, *args)

    def restore():
        del model.sample_cache
        cst_mod._pg_update = inner_pg

    model.sample_cache = sample_cache
    cst_mod._pg_update = pg_update
    return windows, last, restore


def run_cst_step(torch, step, batch, seed: int, windows=None):
    """One CST step from an idle card: (metrics, phase_ms, wall ms to the
    end of its device work, device ms per probe window kind)."""
    if windows is not None:
        for v in windows.values():
            v.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = step(batch.feats, batch.feat_masks, batch.captions, batch.weights,
             batch.category, batch.video_idx,
             torch.Generator(device=DEVICE).manual_seed(seed), 0.0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    dev = {k: sum(a.elapsed_time(b) for a, b in v)
           for k, v in (windows or {}).items()}
    if windows is not None:
        dev["rollout_chunks"] = [round(a.elapsed_time(b), 3)
                                 for a, b in windows["rollout"]]
    return m, dict(step.phase_ms), wall, dev


def log_cst_step(what: str, m, phases, wall, dev, card: str):
    """One step's phases and the overlap: the wall time against the
    serial sum of device decode, host scoring and the device update."""
    score = phases.get("score_ms", 0.0) + phases.get("score_wait_ms", 0.0)
    serial = dev["rollout"] + dev["greedy"] + score + dev["update"]
    log(f"CST step {what}: loss {float(m['loss']):.5f} grad norm "
        f"{float(m['grad_norm']):.4f} reward {m['reward']:.5f} baseline "
        f"{m['baseline']:.5f} advantage {m['advantage']:.3e}; phases "
        f"{json.dumps(phases)}; device ms rollout {dev['rollout']:.3f} "
        f"(chunks {dev['rollout_chunks']}), greedy {dev['greedy']:.3f}, "
        f"update {dev['update']:.3f}; host scoring {score:.3f} ms; wall "
        f"{wall:.3f} ms vs serial sum {serial:.3f} ms (overlap "
        f"{serial - wall:.3f} ms)  [{card}]")
    for k in ("loss", "grad_norm", "reward", "baseline", "advantage"):
        if not math.isfinite(float(m[k])):
            fail(f"CST step {what}: non-finite {k}")
    return dict(phases, wall_ms=wall, serial_ms=serial, score_host_ms=score,
                **{f"device_{k}_ms": v for k, v in dev.items()})


def hold_launches(counted, want, what: str):
    got = {n: fn.launches for n, fn in counted.items()}
    log(f"CST launches, {what}: {got}")
    if got != want:
        fail(f"CST launches, {what}: {got}, want {want}")
    return got


def zero(counted):
    for fn in counted.values():
        fn.launches = 0


def snapshot(model, optimizer):
    import copy

    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            copy.deepcopy(optimizer.state_dict()))


def restore_snapshot(model, optimizer, snap):
    model.load_state_dict(snap[0])
    optimizer.load_state_dict(snap[1])


def check_f32_rollout(torch, trainer, batch, sam_mod):
    """The f32 rollout at R = 1,280 (64 videos x S) on init-scale
    weights, kernel vs plain version with the same seed words: tokens
    and masks exact, log-probs within F32_ATOL."""
    import copy

    from cst_captioning_torch.models import captioner

    cfg = copy.deepcopy(trainer.cfg)
    cfg.model.compute_dtype = "float32"
    m32 = captioner.model_from_config(cfg, device=DEVICE)
    m32.init_weights(torch.Generator().manual_seed(5))
    S, L = cfg.train.cst_num_samples, cfg.data.max_seq_len
    with torch.no_grad():
        cache = captioner._repeat_cache(
            m32._encode(batch.feats, batch.feat_masks), S)
    before = sam_mod.lstm_sample.launches

    def rollout():
        return m32.sample_cache(cache, CST_SEED_WORDS, max_len=L,
                                greedy=False)

    k = rollout()
    if sam_mod.lstm_sample.launches != before + 1:
        fail("the f32 rollout did not launch the lstm_sample kernel")
    captioner.lstm_sample = sam_mod.lstm_sample_ref
    try:
        p = rollout()
    finally:
        captioner.lstm_sample = sam_mod.lstm_sample
    R = k.tokens.shape[0]
    tok_diff = int((k.tokens != p.tokens).sum())
    mask_diff = int((k.mask != p.mask).sum())
    lp_err = float((k.logprobs - p.logprobs).abs().max())
    log(f"CST rollout f32 R={R} T={L} kernel vs plain: {tok_diff} tokens and "
        f"{mask_diff} mask entries differ, max |logprob diff| {lp_err:.3e}; "
        f"mean length {float(k.mask.sum(1).mean()):.2f}")
    if R != B * S or tok_diff or mask_diff or not lp_err <= F32_ATOL:
        fail("the f32 CST rollout through the kernel disagrees with the "
             "plain version")
    return {"rows": R, "tokens_differ": tok_diff, "max_abs_err": lp_err}


def check_pg_loss(torch, trainer, last, swap):
    """The PG loss and gradients at float32 on the last step's tokens,
    mask and advantage, through the recurrence kernel vs through its
    plain forward and backward (``swap``): loss within XE_LOSS_RTOL,
    gradient gap within XE_GRAD_GAP (phase 4's bounds)."""
    import copy

    from cst_captioning_torch.models import captioner
    from cst_captioning_torch.training import cst as cst_mod

    cfg = copy.deepcopy(trainer.cfg)
    cfg.model.compute_dtype = "float32"
    m32 = captioner.model_from_config(cfg, device=DEVICE)
    m32.load_state_dict(trainer.model.state_dict())
    params = list(m32.parameters())

    def run(plain=False):
        if plain:
            setattr(captioner, swap[0], swap[1])
        try:
            loss = cst_mod.pg_loss(
                m32, last["feats"], last["masks"], cfg.train.cst_num_samples,
                last["tokens"], last["mask"], last["adv"],
                cfg.train.sample_temperature)
            return float(loss.detach()), torch.autograd.grad(loss, params)
        finally:
            setattr(captioner, swap[0], swap[2])

    k, p = run(), run(plain=True)
    loss_rtol, gap = step_gap(torch, k, p)
    log(f"CST PG loss f32 kernel vs plain: {k[0]:.7f} vs {p[0]:.7f} (rtol "
        f"{loss_rtol:.3e}), |grad diff| / |grad| {gap:.3e}")
    if not loss_rtol <= XE_LOSS_RTOL or not gap <= XE_GRAD_GAP:
        fail("the f32 PG loss through the kernel disagrees with the plain "
             "version")
    return {"loss_rtol": loss_rtol, "grad_gap": gap}


def check_scorer(torch, trainer, train_ds, batch, last, metrics):
    """The native scorer on the last step's tokens: its mean is the
    step's reward (bitwise), and it agrees with the Python scorer within
    SCORER_RTOL / SCORER_ATOL; both timed per 1,280 rows (host clock)."""
    import numpy as np

    from cst_captioning_torch.training.rewards import CiderDRewarder

    scorer = trainer._train_step.scorer
    S = trainer.cfg.train.cst_num_samples
    vid = np.repeat(batch.video_idx.cpu().numpy(), S)
    toks = last["tokens"].cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(REPS):
        nat = scorer.score_ids(vid, toks)
    nat_ms = (time.perf_counter() - t0) * 1e3 / REPS
    py = CiderDRewarder(train_ds, backend="python",
                        weighted_refs=trainer.cfg.train.cst_weighted_reward)
    t0 = time.perf_counter()
    want = py.score_ids(vid, toks)
    py_ms = (time.perf_counter() - t0) * 1e3
    diff = np.abs(nat - want)
    log(f"CST scorer on the card's {len(vid)} rows: native {nat_ms:.3f} ms, "
        f"python {py_ms:.3f} ms; {int((nat != want).sum())} rows differ, "
        f"max |diff| {float(diff.max()):.3e}; mean reward {float(nat.mean()):.6f}"
        f", {int((nat > 0).sum())} rows > 0")
    if float(nat.mean()) != metrics["reward"]:
        fail("the native scorer's rewards are not the step's reward")
    if not np.all(diff <= SCORER_ATOL + SCORER_RTOL * np.abs(want)):
        fail("the native scorer disagrees with the Python scorer")
    return {"native_ms_per_1280_rows": nat_ms, "python_ms_per_1280_rows": py_ms,
            "rows_differ": int((nat != want).sum()),
            "max_abs_diff": float(diff.max())}


def check_overlap_parity(torch, trainer, batch):
    """``overlap_rewards`` on, off and on again, one step each from the
    same state and seed (deterministic algorithms on): rewards, loss and
    parameters bitwise equal."""
    import copy

    from cst_captioning_torch.training import cst as cst_mod

    model, opt = trainer.model, trainer.optimizer
    scorer = trainer._train_step.scorer
    snap = snapshot(model, opt)
    out = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for overlap in (True, False, True):
            cfg = copy.deepcopy(trainer.cfg)
            cfg.train.overlap_rewards = overlap
            step = cst_mod._make_split_step(model, opt, cfg, scorer)
            restore_snapshot(model, opt, snap)
            m, phases, wall, _ = run_cst_step(torch, step, batch, 77)
            out.append((m, {k: v.detach().clone()
                            for k, v in model.state_dict().items()},
                        wall, phases))
    finally:
        torch.use_deterministic_algorithms(False)
        restore_snapshot(model, opt, snap)

    def same(a, b):
        return (all(a[0][k] == b[0][k]
                    for k in ("reward", "baseline", "advantage"))
                and float(a[0]["loss"]) == float(b[0]["loss"])
                and all(torch.equal(v, b[1][k]) for k, v in a[1].items()))

    on_off, on_on = same(out[0], out[1]), same(out[0], out[2])
    log(f"CST overlap on vs off bitwise: {on_off}; on vs on again (the "
        f"update's determinism): {on_on}; wall ms on / off / on "
        f"{[round(o[2], 3) for o in out]} (deterministic algorithms on), "
        f"phases {[o[3] for o in out]}")
    if not on_on:
        fail("two identical CST steps differ: the update is not "
             "deterministic, so overlap parity cannot be read")
    if not on_off:
        fail("CST overlap on and off differ")
    return {"bitwise": on_off, "wall_ms_on_off_on": [o[2] for o in out]}


def check_cst(torch, card: str, start: dict, counted: dict, swap, sam_mod):
    """Phase 5, see the module docstring.  ``start`` maps each fusion to
    phase 4's ``best`` checkpoint; ``counted`` names the wrappers whose
    launches are held (the meanpool path's, the attention path's);
    ``swap`` = (captioner attribute, plain recurrence, kernel wrapper)
    for the f32 PG loss check; ``sam_mod`` the sampler's module."""
    from cst_captioning_torch.training import cst as cst_mod

    res = {"steps": []}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        trainer, train_ds, batches = cst_trainer(
            torch, "meanpool", start["meanpool"], tmp)
        cfg = trainer.cfg
        S, B_ = cfg.train.cst_num_samples, cfg.data.batch_size
        Kc = cst_mod._chunk_count(cfg.train.cst_score_chunks, B_)
        log(f"CST trainer ({CST_PRESET}, meanpool, S={S}, {B_} videos a "
            f"step, {Kc} chunks, {cfg.train.cst_baseline} baseline, native "
            f"scorer) warm-started from {start['meanpool']} in "
            f"{time.perf_counter() - t0:.1f} s")
        step = trainer._train_step
        windows, last, restore = cst_probe(torch, trainer.model)
        try:
            run_cst_step(torch, step, batches[0], 1, windows)  # warm-up
            before = snapshot(trainer.model, trainer.optimizer)[0]
            mp = counted["meanpool"]
            zero(mp)
            timed = [run_cst_step(torch, step, batches[i % len(batches)],
                                  10 + i, windows) for i in range(CST_TIMED)]
            res["launches_scb"] = hold_launches(
                mp, {"lstm_sample": CST_TIMED * Kc,
                     "lstm_recurrence": CST_TIMED,
                     "row_gemm": CST_TIMED * (2 + Kc)},
                f"{CST_TIMED} scb steps")
            for i, (m, ph, wall, dev) in enumerate(timed):
                res["steps"].append(log_cst_step(
                    f"meanpool scb {i}", m, ph, wall, dev, card))
            moved = any(not torch.equal(v, trainer.model.state_dict()[k])
                        for k, v in before.items())
            finite = all(bool(torch.isfinite(p).all())
                         for p in trainer.model.parameters())
            if not moved or not finite:
                fail(f"CST parameters moved: {moved}, finite: {finite}")
            batch = batches[(CST_TIMED - 1) % len(batches)]
            res["scorer"] = check_scorer(torch, trainer, train_ds, batch,
                                         last, timed[-1][0])
            res["pg_loss_f32"] = check_pg_loss(torch, trainer, last, swap)

            gcfg = copy_cfg(cfg, cst_baseline="greedy")
            gstep = cst_mod._make_split_step(trainer.model, trainer.optimizer,
                                             gcfg, step.scorer)
            zero(mp)
            g = run_cst_step(torch, gstep, batches[0], 20, windows)
            res["launches_greedy"] = hold_launches(
                mp, {"lstm_sample": 2 * Kc, "lstm_recurrence": 1,
                     "row_gemm": 2 + 2 * Kc}, "one greedy-baseline step")
            res["greedy_step"] = log_cst_step("meanpool greedy", *g, card)
            # A reading, not held: the rollout as one 1,280-row call.
            k1 = cst_mod._make_split_step(
                trainer.model, trainer.optimizer,
                copy_cfg(cfg, cst_score_chunks=1), step.scorer)
            run_cst_step(torch, k1, batches[1], 30, windows)
            res["k1_step"] = log_cst_step(
                "meanpool scb, one chunk (a reading)",
                *run_cst_step(torch, k1, batches[2], 31, windows), card)
        finally:
            restore()
        res["overlap"] = check_overlap_parity(torch, trainer, batches[0])
        res["rollout_f32"] = check_f32_rollout(torch, trainer, batches[0],
                                               sam_mod)
        del trainer, batches

        atrainer, _, abatches = cst_trainer(
            torch, "attention", start["attention"], os.path.join(tmp, "att"),
            train_ds)
        windows, _, restore = cst_probe(torch, atrainer.model)
        try:
            run_cst_step(torch, atrainer._train_step, abatches[0], 1, windows)
            zero(counted["attention"])
            a = run_cst_step(torch, atrainer._train_step, abatches[1], 2,
                             windows)
            res["launches_attention"] = hold_launches(
                counted["attention"],
                {"attlstm_sample": Kc, "attlstm_recurrence": 1,
                 "attlstm_recurrence_bwd": 1, "row_gemm": 3},
                "one attention scb step")
            res["attention_step"] = log_cst_step("attention scb", *a, card)
        finally:
            restore()
    return res


def copy_cfg(cfg, **train):
    import copy

    out = copy.deepcopy(cfg)
    for k, v in train.items():
        setattr(out.train, k, v)
    return out


def att_kernel_entries(res, rec, launches, train):
    """The four attention kernels' entries of the ``kernels`` line."""
    bf, bb, bt = att_decode_work(B * K, 2, B * K * T * 4 + B * K * 4)
    bf32 = att_decode_work(B * K, 4, B * K * T * 4 + B * K * 4)
    sf, sb, st = att_decode_work(B, 2, 3 * B * T * 4)
    sf32 = att_decode_work(B, 4, 3 * B * T * 4)
    (ff, fb, ft), (gf, gb, gt) = att_rec_work(R_XE, T_XE, 2, ATT_REP)
    (ff32, fb32, _), (gf32, gb32, _) = att_rec_work(R_XE, T_XE, 4, ATT_REP)
    fwd1, bwd1 = att_rec_work(R_XE, T_XE, 2, 1)
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
            launches_per_call_bf16=res["launches_per_call_bf16"][
                "beam" if key == "beam" else "greedy"],
            bf16_row_invariance=res["row_invariance"],
            max_abs_err_f32=res[f"{key}_f32_err"],
            ms_f32=res[f"{key}_ms_f32"],
            plain_ms_f32=res[f"{key}_plain_ms_f32"],
            bound_ms_f32=bound_ms(f32w[0], f32w[1], H100_F32_FLOPS)[0]))
    out[1]["train_launches"] = train["launches"]["attlstm_sample"]
    out[1].update({k: v for k, v in res.items()
                   if k.startswith("sample_multinomial_ms_")})
    rec_common = dict(common, tolerance=ATT_TOL_TEXT,
                      source="cst_captioning_torch/csrc/attlstm_recurrence.cu")
    rec_common.update(rep=ATT_REP, order_witness_bf16=rec["order_witness"],
                      launches_per_call_bf16=rec["launches_per_call"],
                      tanh_table_exact=rec["tanh_table_exact"])
    fbound, fby, fterm = rec_bound(ff, fb, ft, H100_BF16_FLOPS)
    f1 = rec_bound(*fwd1, H100_BF16_FLOPS)
    out.append(dict(
        rec_common, name="attlstm_recurrence",
        replaces=f"{REFERENCE}/ops/pallas_attlstm.py:544",
        launches=train["launches"]["attlstm_recurrence"],
        max_abs_err=rec["bf16_err"], ms=rec["ms_bf16"],
        plain_ms=rec["plain_ms_bf16"], bound_ms=fbound, bound_by=fby,
        bound_term=fterm, bound_ms_rep1=f1[0], bound_term_rep1=f1[2],
        ms_rep1=rec["ms_rep1_bf16"], rep_forward_bitwise=rec["rep_forward"],
        edge_shapes=rec["edge_shapes"],
        bf16_share_differing=rec["bf16_share_differing"],
        sfu_floor_ms=sfu_floor_ms(ft), max_abs_err_f32=rec["f32_err"],
        ms_f32=rec["ms_f32"], plain_ms_f32=rec["plain_ms_f32"],
        bound_ms_f32=rec_bound(ff32, fb32, ft, H100_F32_FLOPS)[0],
        ms_no_residuals=rec["ms_nores_bf16"],
        ms_no_residuals_f32=rec["ms_nores_f32"],
        grad_rel_f32=rec["grad_rel"],
        xe_step_f32_vs_plain=train["xe_f32"],
        train_steps_per_sec=train["steps_per_sec"],
        xe_step_ms=train["step_ms"]))
    gbound, gby, gterm = rec_bound(gf, gb, gt, H100_BF16_FLOPS)
    g1 = rec_bound(*bwd1, H100_BF16_FLOPS)
    out.append(dict(
        rec_common, name="attlstm_recurrence_bwd",
        replaces=f"{REFERENCE}/ops/pallas_attlstm.py:578",
        launches=train["launches"]["attlstm_recurrence_bwd"],
        max_abs_err=rec["bwd_bf16_err"], ms=rec["bwd_ms_bf16"],
        plain_ms=rec["bwd_plain_ms_bf16"], bound_ms=gbound, bound_by=gby,
        bound_term=gterm, bound_ms_rep1=g1[0], bound_term_rep1=g1[2],
        ms_rep1=rec["bwd_ms_rep1_bf16"], fold_f32=rec["fold_f32"],
        fold_bf16=rec["fold_bf16"],
        sfu_floor_ms=sfu_floor_ms(gt), max_abs_err_f32=rec["bwd_f32_err"],
        grad_rel_f32=rec["bwd_grad_rel"], bf16_ulps=rec["bwd_bf16_ulps"],
        max_abs_err_note="backward kernel vs plain on the same residuals, "
                         "over the seven cotangents",
        ms_f32=rec["bwd_ms_f32"], plain_ms_f32=rec["bwd_plain_ms_f32"],
        bound_ms_f32=rec_bound(gf32, gb32, gt, H100_F32_FLOPS)[0],
        ms_note="includes the three weight contractions done outside the "
                "kernel (torch.matmul), as the reference's _vjp_bwd"))
    return out


def continuous_kernel_entries(cres, rgres, cont, bres, ss):
    """The ``fused_context_attention`` and ``row_gemm`` entries of the
    ``kernels`` line: launches from the bf16 continuous runs (phase 3c),
    times and errors from phases 2e and 2f; the forward's time at the
    training shape (2g) and its launches in the scheduled-sampling run
    (4c)."""
    R = B * K
    runs = {f"{f} {m}": cont[f][f"{m}_bf16"]["launches"]
            for f in ("meanpool", "attention") for m in ("beam", "greedy")}
    cb, cby = ctx_bound(R, B, 2)
    ctx = dict(
        name="fused_context_attention", route="cuda",
        source="cst_captioning_torch/csrc/context_attention.cu",
        replaces=f"{REFERENCE}/ops/pallas_attention.py:214",
        launches=sum(r["fused_context_attention"] for r in runs.values()),
        launches_by_run={k: r["fused_context_attention"]
                         for k, r in runs.items()},
        max_abs_err=cres[f"err_bf16_R{R}"],
        ms=cres[f"device_ms_bf16_R{R}"],
        plain_ms=cres[f"plain_ms_bf16_R{R}"], bound_ms=cb, bound_by=cby,
        library_ms=None, library="none (no single call)",
        ms_note="ms, ms_f32, ms_greedy_R64 and ms_train_shape: profiler "
                "device time per call, from a window that recorded every "
                "launch; event_ms*: the event clock, which reads the "
                "host's enqueue at these sizes",
        event_ms=cres[f"ms_bf16_R{R}"], event_ms_f32=cres[f"ms_f32_R{R}"],
        launches_per_call_bf16=cres["launches_per_call_bf16"],
        tolerance=CTX_TOLERANCE, dtype="bfloat16",
        shape=f"R={R} rows over {B} videos (rep={K}), F={F_ATT}, "
              f"A={A_ATT}, E={E}",
        max_abs_err_f32=cres[f"err_f32_R{R}"],
        ms_f32=cres[f"device_ms_f32_R{R}"],
        plain_ms_f32=cres[f"plain_ms_f32_R{R}"],
        bound_ms_f32=ctx_bound(R, B, 4)[0],
        gathered_rep1_ms=cres[f"gathered_ms_bf16_R{R}"],
        gathered_rep1_ms_f32=cres[f"gathered_ms_f32_R{R}"],
        ms_greedy_R64=cres[f"device_ms_bf16_R{B}"],
        event_ms_greedy_R64=cres[f"ms_bf16_R{B}"],
        bound_ms_greedy_R64=ctx_bound(B, B, 2)[0],
        sfu_floor_ms=sfu_floor_ms(ctx_work(R, B, 2)[2]),
        edge_cases=cres["edges"],
        train_shape=f"R={R_XE} rows over {R_XE // CTXB_REP} videos "
                    f"(rep={CTXB_REP}), weights written",
        ms_train_shape=bres["fwd_device_ms_bf16"],
        event_ms_train_shape=bres["fwd_ms_bf16"],
        ms_train_shape_f32=bres["fwd_device_ms_f32"],
        bound_ms_train_shape=bres["fwd_bound_bf16"][0],
        bound_ms_train_shape_f32=bres["fwd_bound_f32"][0],
        ss_train_launches=ss["launches"]["fused_context_attention"])
    fl, by = rg_work(R, H, V, 2, 2)
    rb, rby = bound_ms(fl, by, H100_BF16_FLOPS)
    rg = dict(
        name="row_gemm", route="cuda",
        source="cst_captioning_torch/csrc/row_gemm.cu",
        replaces=f"{REFERENCE}/models/captioner.py:408",
        replaces_note="no TPU kernel: the per-step decoder's products "
                      "(query, gates, vocab) and the admission encode's "
                      "projections, which the reference leaves to XLA; "
                      "the kernel makes them row-invariant",
        launches=sum(r["row_dot"] for r in runs.values()),
        launches_by_run={k: r["row_dot"] for k, r in runs.items()},
        max_abs_err=rgres["err_bf16"], ms=rgres["ms_bf16"],
        plain_ms=rgres["plain_ms_bf16"], bound_ms=rb, bound_by=rby,
        library_ms=rgres["library_ms_bf16"],
        library="torch.matmul on the rounded operands (cuBLAS sgemm)",
        ms_note="ms, library_ms and by_shape: profiler device time per "
                "call; event_ms: the event clock, which reads the host's "
                "enqueue rate at these sizes",
        event_ms=rgres["event_ms_bf16"], by_shape=rgres["shapes"],
        tolerance=RG_TOLERANCE, dtype="bfloat16",
        shape=f"vocab product R={R}, K={H}, N={V}",
        max_abs_err_f32=rgres["err_f32"], ms_f32=rgres["ms_f32"],
        plain_ms_f32=rgres["plain_ms_f32"],
        library_ms_f32=rgres["library_ms_f32"],
        bound_ms_f32=bound_ms(*rg_work(R, H, V, 4, 4), H100_F32_FLOPS)[0],
        cublas_rows_differing=rgres["cublas_rows_differing"],
        continuous_serving=cont)
    return [ctx, rg]


def ss_kernel_entry(bres, ss):
    """The ``fused_context_attention_bwd`` entry of the ``kernels`` line:
    launches from the scheduled-sampling run (phase 4c), times and
    errors from phase 2g."""
    nv = R_XE // CTXB_REP
    return dict(
        name="fused_context_attention_bwd", route="cuda",
        source="cst_captioning_torch/csrc/context_attention_bwd.cu",
        replaces=f"{REFERENCE}/ops/pallas_attention.py:202",
        launches=ss["launches"]["fused_context_attention_bwd"],
        launches_by_epoch={str(e): c["fused_context_attention_bwd"]
                           for e, c in ss["per_epoch"].items()},
        max_abs_err=bres["err_bf16"], ms=bres["device_ms_bf16"],
        plain_ms=bres["plain_ms_bf16"], bound_ms=bres["bound_bf16"][0],
        bound_by=bres["bound_bf16"][1], library_ms=None,
        ms_note="ms and ms_f32: profiler device time per call (both "
                "launches), from a window that recorded every launch; "
                "event_ms*: the event clock",
        event_ms=bres["ms_bf16"], event_ms_f32=bres["ms_f32"],
        launches_per_call_bf16=bres["launches_per_call_bf16"],
        edge_cases=bres["edges"],
        library="none (no single call)", tolerance=CTXB_TOLERANCE,
        dtype="bfloat16",
        shape=f"R={R_XE} rows over {nv} videos (rep={CTXB_REP}), "
              f"F={F_ATT}, A={A_ATT}, E={E}",
        sfu_floor_ms=sfu_floor_ms(ctxb_work(R_XE, nv, 2)[2]),
        bf16_ulps=bres["bf16_ulps"], rel_err_f32=bres["rel_f32"],
        gathered_rel_f32=bres["gathered_rel"],
        max_abs_err_f32=bres["err_f32"], ms_f32=bres["device_ms_f32"],
        plain_ms_f32=bres["plain_ms_f32"], bound_ms_f32=bres["bound_f32"][0],
        ss_fed_share=ss["fed_share"], ss_fed_sigmas=ss["fed_sigmas"],
        ss_train_steps_per_sec=ss["steps_per_sec"],
        ss_step_f32_vs_plain=ss["step_f32_vs_plain"],
        ss_step_f32_vs_fused=ss["step_f32_vs_fused"],
        ss_step_bf16_vs_plain=ss["step_bf16_vs_plain"],
        ss_step_ms=ss["step_ms"])


def quant_kernel_entries(qdec, qrec, qlad, qfwd, cont, rgres):
    """The six int8w kernels' entries of the ``kernels`` line: launches
    from phase 3d's ladder runs (decoders) and teacher-forced forwards
    (recurrences), times and errors from phases 2h and 2i; and the int8
    row_gemm's readings, which join the row_gemm entry."""
    out = []
    for fusion, p in (("meanpool", ""), ("attention", "att")):
        r, att = qdec[fusion], fusion == "attention"
        tol = Q_ATT_TOLERANCE if att else Q_TOLERANCE
        for kind, src, line, rows, outb in (
                ("beam", "lstm_beam.cu",
                 "pallas_beam.py:649" if att else "pallas_beam.py:687",
                 B * K, B * K * T * 4 + B * K * 4),
                ("sample", "lstm_sample.cu",
                 "pallas_sampler.py:643" if att else "pallas_sampler.py:682",
                 B, 3 * B * T * 4)):
            fl, by = q_decode_work(rows, att, outb)
            bound, by_what = bound_ms(fl, by, H100_BF16_FLOPS)
            mode = "beam" if kind == "beam" else "greedy"
            out.append(dict(
                name=f"{p}lstm_{kind}_q", route="cuda",
                source=f"cst_captioning_torch/csrc/{src}",
                replaces=f"{REFERENCE}/ops/{line}",
                replaces_note="the quant= mode of the same pallas_call",
                launches=qlad[fusion][mode],
                max_abs_err=r[f"{kind}_bf16_err"], ms=r[f"{kind}_ms_bf16"],
                plain_ms=r[f"{kind}_plain_ms_bf16"], bound_ms=bound,
                bound_by=by_what, library_ms=None, library=Q_LIBRARY,
                tolerance=tol, dtype="int8 weights, bfloat16 compute",
                launches_per_call_bf16=(r["launches_per_call_bf16"] or {}).get(
                    mode),
                max_abs_err_f32=r[f"{kind}_f32_err"],
                ms_f32=r[f"{kind}_ms_f32"],
                plain_ms_f32=r[f"{kind}_plain_ms_f32"]))
    for fusion, name, line, key in (
            ("meanpool", "lstm_recurrence_q", "pallas_lstm.py:342", "lstm"),
            ("attention", "attlstm_recurrence_q", "pallas_attlstm.py:687",
             "att")):
        r = qrec[key]
        att = key == "att"
        bound, by_what, term = rec_bound(*q_rec_work(R_XE, T_XE, att),
                                         H100_BF16_FLOPS)
        out.append(dict(
            name=name, route="cuda",
            source="cst_captioning_torch/csrc/"
                   + ("attlstm_recurrence.cu" if att else "lstm_recurrence.cu"),
            replaces=f"{REFERENCE}/ops/{line}",
            replaces_note="via the same pallas_call with quant=True",
            launches=qfwd[fusion]["launches"], max_abs_err=r["bf16_err"],
            ms=r["ms_bf16"], plain_ms=r["plain_ms_bf16"], bound_ms=bound,
            bound_by=by_what, bound_term=term, library_ms=None,
            library=Q_LIBRARY,
            tolerance=QREC_TOLERANCE, dtype="int8 weights, bfloat16 compute",
            bf16_ulps=r["bf16_ulps"], max_abs_err_f32=r["f32_err"],
            ms_f32=r["ms_f32"], plain_ms_f32=r["plain_ms_f32"],
            forward_logit_err_f32=qfwd[fusion]["logit_err_f32"]))
    runs = {f"{f} {m}": cont[f][f"{m}_int8w"]["launches"]
            for f in ("meanpool", "attention") for m in ("beam", "greedy")}
    fl, by = rg_work(B * K, H, V, 1, 2)
    by += V * 4
    rg_int8 = dict(
        launches_int8=sum(r["row_dot_quant"] for r in runs.values()),
        launches_int8_by_run={k: r["row_dot_quant"] for k, r in runs.items()},
        ms_int8=rgres["ms_int8_bf16"], plain_ms_int8=rgres["plain_ms_int8_bf16"],
        library_ms_int8=rgres["library_ms_int8_bf16"],
        library_int8="torch.matmul on the dequantized W (cuBLAS sgemm)",
        bound_ms_int8=bound_ms(fl, by, H100_BF16_FLOPS)[0],
        max_abs_err_int8=rgres["err_int8_bf16"],
        ms_int8_f32=rgres["ms_int8_f32"],
        max_abs_err_int8_f32=rgres["err_int8_f32"])
    return out, rg_int8


def add_cst_readings(kernels, cst):
    """Phase 5's launches (``cst_launches``, per run) on the entries of
    the kernels the CST path ran, and its readings on the main path's
    two kernels' entries."""
    runs = {f"scb_steps_{CST_TIMED}": cst["launches_scb"],
            "greedy_step": cst["launches_greedy"],
            "attention_scb_step": cst["launches_attention"]}
    for k in kernels:
        got = {run: counts[k["name"]] for run, counts in runs.items()
               if k["name"] in counts}
        if got:
            k["cst_launches"] = got
    by_name = {k["name"]: k for k in kernels}
    by_name["lstm_sample"]["cst_rollout_f32_vs_plain"] = cst["rollout_f32"]
    by_name["lstm_recurrence"].update(
        cst_pg_loss_f32_vs_plain=cst["pg_loss_f32"],
        cst_steps_ms=cst["steps"], cst_greedy_step_ms=cst["greedy_step"],
        cst_scorer=cst["scorer"], cst_overlap=cst["overlap"],
        cst_one_chunk_step_ms=cst["k1_step"])
    by_name["attlstm_recurrence"]["cst_step_ms"] = cst["attention_step"]


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
        from cst_captioning_torch.ops import attention as ctx_mod
        from cst_captioning_torch.ops import attlstm as att_mod
        from cst_captioning_torch.ops import beam as beam_mod
        from cst_captioning_torch.ops import lstm as lstm_mod
        from cst_captioning_torch.ops import rowgemm as rg_mod
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
    cres = check_context_attention(torch, ctx_mod)
    rgres = check_row_gemm(torch, rg_mod)
    bres = check_context_attention_bwd(torch, ctx_mod)
    qdec = {f: check_quant_decoders(torch, beam_mod, sam_mod,
                                    f == "attention")
            for f in ("meanpool", "attention")}
    qrec = check_quant_recurrences(torch, lstm_mod, att_mod)
    launches = check_engine(torch, {"beam": beam_mod.lstm_beam,
                                    "greedy": sam_mod.lstm_sample},
                            "meanpool")
    alaunches = check_engine(torch, {"beam": beam_mod.attlstm_beam,
                                     "greedy": sam_mod.attlstm_sample},
                             "attention")
    qlad = {"meanpool": check_engine(
                torch, {"beam": beam_mod.lstm_beam,
                        "greedy": sam_mod.lstm_sample}, "meanpool", "int8w"),
            "attention": check_engine(
                torch, {"beam": beam_mod.attlstm_beam,
                        "greedy": sam_mod.attlstm_sample}, "attention",
                "int8w")}
    qfwd = {"meanpool": check_int8w_forward(
                torch, card, "meanpool", lstm_mod.lstm_recurrence_quant,
                lstm_mod.lstm_recurrence_quant_ref),
            "attention": check_int8w_forward(
                torch, card, "attention", att_mod.attlstm_recurrence_quant,
                att_mod.attlstm_recurrence_quant_ref)}
    cont = {f: check_continuous(torch, card, f, [ctx_mod.fused_context_attention,
                                                 rg_mod.row_dot])
            for f in ("meanpool", "attention")}
    with tempfile.TemporaryDirectory() as ckroot:
        train = check_training(
            torch, card, "meanpool",
            {"lstm_recurrence": lstm_mod.lstm_recurrence,
             "lstm_sample": sam_mod.lstm_sample},
            ("lstm_recurrence", plain_recurrence(torch, lstm_mod)),
            os.path.join(ckroot, "meanpool"))
        atrain = check_training(
            torch, card, "attention",
            {"attlstm_recurrence": att_mod.attlstm_recurrence,
             "attlstm_recurrence_bwd": att_mod.attlstm_recurrence_bwd,
             "attlstm_sample": sam_mod.attlstm_sample},
            ("attlstm_recurrence", plain_att_recurrence(torch, att_mod)),
            os.path.join(ckroot, "attention"))
        sstrain = check_ss_training(
            torch, card,
            {"fused_context_attention": ctx_mod.fused_context_attention,
             "fused_context_attention_bwd":
                 ctx_mod.fused_context_attention_bwd,
             "attlstm_recurrence": att_mod.attlstm_recurrence,
             "attlstm_recurrence_bwd": att_mod.attlstm_recurrence_bwd},
            plain_context_attention(torch, ctx_mod), atrain["step_ms"])
        cst = check_cst(
            torch, card,
            {"meanpool": train["best"], "attention": atrain["best"]},
            {"meanpool": {"lstm_sample": sam_mod.lstm_sample,
                          "lstm_recurrence": lstm_mod.lstm_recurrence,
                          "row_gemm": rg_mod.row_dot},
             "attention": {"attlstm_sample": sam_mod.attlstm_sample,
                           "attlstm_recurrence": att_mod.attlstm_recurrence,
                           "attlstm_recurrence_bwd":
                               att_mod.attlstm_recurrence_bwd,
                           "row_gemm": rg_mod.row_dot}},
            ("lstm_recurrence", plain_recurrence(torch, lstm_mod),
             lstm_mod.lstm_recurrence), sam_mod)

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
         "max_abs_err_f32": res["beam_f32_err"],
         "tolerance": MEANPOOL_TOLERANCE, "dtype": "bfloat16",
         "ms_f32": res["beam_ms_f32"],
         "plain_ms_f32": res["beam_plain_ms_f32"],
         "bound_ms_f32": bound_ms(beam_flops, beam_bytes, H100_F32_FLOPS)[0],
         "chaos_witness_f32": res["chaos"],
         "bf16_order_witness": res["order_witness"],
         "launches_per_call_bf16": res["launches_per_call_bf16"]["beam"],
         "bf16_row_invariance": res["row_invariance"]},
        {"name": "lstm_sample", "route": "cuda",
         "source": "cst_captioning_torch/csrc/lstm_sample.cu",
         "replaces": f"{REFERENCE}/ops/pallas_sampler.py:682",
         "launches": launches["greedy"], "max_abs_err": res["sample_bf16_err"],
         "ms": res["sample_ms_bf16"], "plain_ms": res["sample_plain_ms_bf16"],
         "bound_ms": sb, "bound_by": sb_by, "library_ms": None,
         "max_abs_err_f32": res["sample_f32_err"],
         "tolerance": MEANPOOL_TOLERANCE, "dtype": "bfloat16",
         "ms_f32": res["sample_ms_f32"],
         "plain_ms_f32": res["sample_plain_ms_f32"],
         "bound_ms_f32": bound_ms(samp_flops, samp_bytes, H100_F32_FLOPS)[0],
         "bf16_order_witness": res["order_witness"],
         "launches_per_call_bf16": res["launches_per_call_bf16"]["greedy"],
         "bf16_row_invariance": res["row_invariance"],
         **{k: v for k, v in res.items()
            if k.startswith("sample_multinomial_ms_")}},
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
         "launches_per_call_bf16": rec["launches_per_call_bf16"],
         "launch_plan_bf16": dict(zip(("clusters", "ctas_per_cluster",
                                       "rows_per_cluster"),
                                      rec["launch_plan"])),
         "order_witness_c_rel_bf16": rec["order_witness_c_rel"],
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
    kernels += continuous_kernel_entries(cres, rgres, cont, bres, sstrain)
    kernels.append(ss_kernel_entry(bres, sstrain))
    qentries, rg_int8 = quant_kernel_entries(qdec, qrec, qlad, qfwd, cont,
                                             rgres)
    next(k for k in kernels if k["name"] == "row_gemm").update(rg_int8)
    kernels += qentries
    add_cst_readings(kernels, cst)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
