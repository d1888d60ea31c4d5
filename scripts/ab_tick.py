#!/usr/bin/env python3
"""Time the continuous slot loop's tick of two checkouts on one card, in
turns: parent, change, change, parent.

    python3 scripts/ab_tick.py --parent DIR [--change DIR] [--ticks 20]
                               [--runs 15] [--turns PCCPPCCP]

DIR is the root of a checkout (``--change`` defaults to this one); each
turn runs in its own process with that root first on ``sys.path`` and
builds that checkout's kernels at first use.  Each turn boots
``msrvtt_serve_beam5`` (bf16, random weights from the preset's seed, a
10,492-word vocabulary) under meanpool and attention fusion, beam and
greedy, fills the top bank (64 slots) of the engine's slot decoder and,
after three warm ticks, reads:

* ``tick_ms`` / ``tick_ms_median``: the synchronous ``SlotDecoder.tick``
  (dispatch, then the host's wait for the tick's done flags) on the
  host clock, the least and the median of ``--runs`` runs of
  ``--ticks`` ticks (the host's clock on a shared machine spreads);
* ``device_ms``: the profiler's device time a tick over ``--ticks``
  ticks, and ``idle_share`` = 1 - device / tick;
* where the checkout has ``tick_begin`` / ``tick_wait``,
  ``buffered_ms`` / ``buffered_ms_median``: the double-buffered order
  (dispatch tick t+1, then wait on tick t), the same way.

Prints one line per turn, the card's name and power limit, then one
JSON line with every reading.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CASES = (("meanpool", "beam"), ("meanpool", "greedy"),
         ("attention", "beam"), ("attention", "greedy"))


def worker(root: str, ticks: int, runs: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cst_captioning_torch.config import get_preset
    from cst_captioning_torch.data.vocab import Vocabulary
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.serving.engine import InferenceEngine

    vocab = Vocabulary([f"w{i}" for i in range(10_492)])
    out = {}
    for fusion, mode in CASES:
        cfg = get_preset("msrvtt_serve_beam5")
        cfg.model.vocab_size = len(vocab)
        cfg.model.feature_fusion = fusion
        cfg.serving.decode_mode = mode
        cfg.serving.warmup = False
        cfg.serving.replicas = 1
        model = model_from_config(cfg, device="cpu")
        model.init_weights(torch.Generator().manual_seed(cfg.train.seed))
        eng = InferenceEngine(cfg, params=model.state_dict(), vocab=vocab,
                              device="cuda")
        dec = eng.slot_decoder()
        dec.maybe_resize(dec.S_max)
        rng = np.random.RandomState(5)
        d = cfg.data
        reqs = [eng.prepare({"features": {
            m: rng.standard_normal((d.max_frames, d.feature_dims[m]))
            .astype(np.float32) for m in d.feature_modalities}})
            for _ in range(min(dec.S, dec.admit_cap))]
        dec.tick(reqs, list(range(len(reqs))))
        for _ in range(3):
            dec.tick()

        def sync():
            for _ in range(ticks):
                dec.tick()

        def buffered():
            prev = dec.tick_begin()
            for _ in range(ticks - 1):
                h = dec.tick_begin()
                dec.tick_wait(prev)
                prev = h
            dec.tick_wait(prev)

        def host_ms(fn):
            got = []
            for _ in range(runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                got.append((time.perf_counter() - t0) * 1e3 / ticks)
            return min(got), float(np.median(got))

        tick, tick_med = host_ms(sync)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync()
            torch.cuda.synchronize()
        busy = sum((getattr(e, "device_time_total", 0)
                    or getattr(e, "cuda_time_total", 0))
                   for e in prof.key_averages()) / 1e3 / ticks
        row = {"rows": len(reqs) * dec.K, "tick_ms": tick,
               "tick_ms_median": tick_med, "device_ms": busy,
               "idle_share": 1.0 - busy / tick_med}
        if hasattr(dec, "tick_begin"):
            row["buffered_ms"], row["buffered_ms_median"] = host_ms(buffered)
        out[f"{fusion}_{mode}"] = row
        del eng, dec, model
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--change",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--runs", type=int, default=15)
    ap.add_argument("--turns", default="PCCPPCCP")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.ticks, args.runs)),
              flush=True)
        return 0
    if not args.parent or set(args.turns) - {"P", "C"}:
        ap.error("--parent is required; --turns holds only P and C")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    roots = {"P": args.parent, "C": args.change}
    turns = []
    for label in args.turns:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             roots[label], "--ticks", str(args.ticks), "--runs",
             str(args.runs)],
            capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(run.stdout.strip().splitlines()[-1])
        turns.append({"turn": label, **turn})
        print(label, " ".join(
            f"{k} tick {x['tick_ms']:.3f}/{x['tick_ms_median']:.3f} device "
            f"{x['device_ms']:.3f}" + (
                f" buffered {x['buffered_ms']:.3f}/"
                f"{x['buffered_ms_median']:.3f}" if "buffered_ms" in x
                else "") for k, x in turn.items()), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
