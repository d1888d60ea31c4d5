"""Simulated-latency measurement of the chunked-scoring overlap (the port
of the JAX package's ``tools/overlap_sim.py``).

The CST split step (``training/cst.py::_make_split_step``) sends the
rollout out as ``train.cst_score_chunks`` chunks and scores each on the
host as it lands, while the device decodes the next ones.  Whether that
pays depends on what scoring costs.  This tool injects a scorer of
known cost: it wraps the rewarder with a sleep, a stand-in for real
scoring cost that, like the native scorer's C++ loop, leaves the device
and the interpreter free.  Then it measures the steady-state step time
at K=1 and K=N chunks on the same batch.

Theory: with per-chunk device compute D/K and per-chunk scoring S/K, the
K=1 layout serializes D + S, while K chunks hide min(S·(K-1)/K, device
tail) of the scoring, so the recoverable stall is ~S·(K-1)/K.  The tool
prints one JSON line with the measured recovery fraction
(``cst_overlap_sim_*`` keys, the reference's).
``cst_overlap_sim_dispatch_latency_ms`` has no JAX runtime behind it
here: it is the median host round trip of one trivial device op plus
``torch.cuda.synchronize()`` (of the op alone on the CPU).

Run (on the GPU unless ``simulate(device="cpu")``):

    python -m cst_captioning_torch.tools.overlap_sim [--sleep-ms 60]
        [--chunks 4] [--steps 5] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

DISPATCH_PROBES = 21


def credibility(rec_per_rep_ms, recoverable_ms: float):
    """Credibility reduction over per-rep recovered-stall samples.
    Returns ``(recovered_ms, frac, frac_raw, noisy)``: the headline
    fraction is clamped to [0, 1] (outside is a measurement artifact —
    the K=1 baseline moved under load — never a real recovery), and
    ``noisy`` is set when the spread swamps the signal (sd/|mean| > 0.3)
    or the raw fraction fell outside [0, 1]."""
    pp = np.asarray(rec_per_rep_ms, dtype=float)
    recovered = float(pp.mean())
    frac_raw = (
        recovered / recoverable_ms if recoverable_ms > 0 else 0.0
    )
    frac = min(max(frac_raw, 0.0), 1.0)
    spread_bad = len(pp) >= 2 and float(pp.std(ddof=1)) > 0.3 * max(
        abs(recovered), 1e-9
    )
    noisy = bool(spread_bad or frac_raw > 1.0 or frac_raw < 0.0)
    return recovered, frac, frac_raw, noisy


def dispatch_latency_ms(device) -> float:
    """Median host round trip of one trivial device op plus a
    synchronize (``torch.cuda.synchronize()`` on the card)."""
    import torch

    x = torch.zeros((), device=device)
    times = []
    for _ in range(DISPATCH_PROBES):
        t0 = time.perf_counter()
        x.add_(1.0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times) * 1e3)


def simulate(sleep_ms: float = 0.0, chunks: int = 4, steps: int = 5,
             batch: int = 48, rollouts: int = 8, reps: int = 1,
             device=None) -> dict:
    """``sleep_ms=0`` auto-sizes the injected scorer to the measured
    rollout compute.  Scoring can only overlap rollout chunks still
    computing, so the recoverable stall is bounded by both the scorer
    cost and the rollout tail; the workload (``synthetic_smoke`` at rnn
    512, batch*rollouts rows) gives the rollout real compute to overlap
    against.  ``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    import torch

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data import BatchIterator, make_synthetic_dataset
    from cst_captioning_torch.data.loader import to_device
    from cst_captioning_torch.device import resolve_device
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.training import cst as cst_mod
    from cst_captioning_torch.training.rewards import CiderDRewarder
    from cst_captioning_torch.training.steps import make_optimizer

    device = resolve_device(device)
    ds, _ = make_synthetic_dataset(
        num_videos=batch * 2, max_frames=6, max_words=10, seed=11
    )
    cfg = get_preset("synthetic_smoke")
    cfg.data.batch_size = batch
    cfg.data.seq_per_img = 2
    cfg.data.max_frames = 6
    cfg.data.max_seq_len = 10
    cfg.train.train_mode = "cst"
    cfg.train.cst_baseline = "scb"
    cfg.train.cst_num_samples = rollouts
    # Big enough that the rollout has real compute to overlap against.
    cfg.model.rnn_size = 512
    cfg.model.vocab_size = len(ds.vocab)
    it = BatchIterator(ds, batch_size=batch, seq_per_img=2, max_frames=6,
                       shuffle=False)
    b = to_device(next(iter(it.epoch(0))), device)

    def fresh():
        model = model_from_config(cfg, device=device)
        model.init_weights(torch.Generator().manual_seed(0))
        return model, make_optimizer(cfg.train, 10,
                                     dict(model.named_parameters()))

    total_rows = batch * rollouts

    # Measure the rollout-only compute the scorer can hide behind.
    model, _ = fresh()

    def roll(seed: int):
        g = torch.Generator(device=device).manual_seed(seed)
        return model.sample(b.feats, b.feat_masks, max_len=cfg.data.max_seq_len,
                            greedy=False, generator=g,
                            repeat=rollouts).tokens.cpu().numpy()

    roll(1)
    t0 = time.perf_counter()
    for i in range(3):
        roll(2 + i)
    rollout_ms = (time.perf_counter() - t0) / 3 * 1e3
    if sleep_ms <= 0:
        sleep_ms = round(rollout_ms, 1)

    class SleepyRewarder(CiderDRewarder):
        """Real scorer plus an injected per-row sleep totalling
        ``sleep_ms`` per full-batch scoring pass.  sleep() releases the
        GIL and burns no CPU — like a scorer running in the C++ backend's
        threads, it leaves the device pipeline free."""

        def score_ids(self, video_idx, token_ids):
            time.sleep(sleep_ms / 1e3 * token_ids.shape[0] / total_rows)
            return super().score_ids(video_idx, token_ids)

    rewarder = SleepyRewarder(ds)

    def run_step(step, seed: int) -> None:
        g = torch.Generator(device=device).manual_seed(seed)
        m = step(b.feats, b.feat_masks, b.captions, b.weights, None,
                 b.video_idx, g, 0.0)
        float(m["loss"])

    def build(k: int):
        cfg_k = cfg.replace(**{"train.cst_score_chunks": k})
        model_k, opt_k = fresh()
        step = cst_mod._make_split_step(model_k, opt_k, cfg_k, rewarder)
        run_step(step, 5)  # warm-up
        return step

    def sweep(step, rep: int) -> float:
        times = []
        for i in range(steps):
            t0 = time.perf_counter()
            run_step(step, (5 * 1_000_003 + rep) * 1_000_003 + i)
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    lat = dispatch_latency_ms(device)
    step1 = build(1)
    stepk = build(chunks)
    # INTERLEAVED repetitions: each rep measures K=1 then K=N back to
    # back so a load shift hits both layouts, and mean±sd across reps is
    # recorded.
    t1s, tks = [], []

    def one_rep():
        r = len(t1s)
        t1s.append(sweep(step1, r))
        tks.append(sweep(stepk, r))

    for _ in range(max(1, reps)):
        one_rep()
    # The rollout is scored (B*S rows) and SCB needs no greedy scoring;
    # K=1 serializes the full sleep, K chunks can hide ~ (K-1)/K of it.
    recoverable = sleep_ms * (chunks - 1) / chunks

    def rec_per_rep():
        return (np.asarray(t1s) - np.asarray(tks)) * 1e3

    # Auto-escalate reps while the spread swamps the signal (sd/|mean|
    # > 0.3): co-tenant noise averages out, and if it doesn't, the
    # record says so via ``noisy`` below.
    max_reps = int(os.environ.get(
        "CST_OVERLAP_SIM_MAX_REPS", str(max(9, 3 * max(1, reps)))
    ))
    while (
        len(t1s) > 1 and len(t1s) < max_reps
        and credibility(rec_per_rep(), recoverable)[3]
    ):
        one_rep()

    pp = rec_per_rep()
    t1 = float(np.asarray(t1s).mean())
    tk = float(np.asarray(tks).mean())
    recovered, frac, frac_raw, noisy = credibility(pp, recoverable)
    out = {
        "cst_overlap_sim_dispatch_latency_ms": round(lat, 3),
        "cst_overlap_sim_rollout_compute_ms": round(rollout_ms, 2),
        "cst_overlap_sim_injected_scorer_ms": sleep_ms,
        "cst_overlap_sim_k1_step_ms": round(t1 * 1e3, 2),
        f"cst_overlap_sim_k{chunks}_step_ms": round(tk * 1e3, 2),
        "cst_overlap_sim_recovered_ms": round(recovered, 2),
        "cst_overlap_sim_recoverable_ms": round(recoverable, 2),
        "cst_overlap_sim_recovered_frac": round(frac, 3),
        "cst_overlap_sim_reps": len(t1s),
        # Credibility marker: true when the spread still swamps the
        # signal after rep escalation, or the raw fraction fell outside
        # [0, 1].
        "cst_overlap_sim_noisy": noisy,
    }
    if round(frac_raw, 3) != round(frac, 3):
        out["cst_overlap_sim_recovered_frac_raw"] = round(frac_raw, 3)
    if len(t1s) > 1:
        out["cst_overlap_sim_recovered_ms_sd"] = round(
            float(pp.std(ddof=1)), 2
        )
        out["cst_overlap_sim_recovered_frac_sd"] = round(
            float(pp.std(ddof=1) / recoverable), 3
        ) if recoverable > 0 else 0.0
    return out


def main(argv=None, device=None) -> int:
    """``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    p = argparse.ArgumentParser("overlap_sim")
    p.add_argument("--sleep-ms", type=float, default=0.0,
                   help="injected scorer cost per full batch; 0 = "
                        "auto-size to the measured rollout compute")
    p.add_argument("--chunks", type=int, default=4)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--reps", type=int, default=3,
                   help="interleaved K=1/K=N measurement repetitions; "
                        "mean±sd recorded")
    a = p.parse_args(argv)
    print(json.dumps(simulate(a.sleep_ms, a.chunks, a.steps, reps=a.reps,
                              device=device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
