#!/usr/bin/env python3
"""Time the context attention kernels of two checkouts on one card, in
turns: parent, change, change, parent.

    python3 scripts/ab_context.py --parent DIR [--change DIR] [--reps 20]
                                  [--turns PCCP] [--parent-launches 1,3]
                                  [--change-launches 1,2]

DIR is the root of a checkout (``--change`` defaults to this one);
``--turns`` is the order of turns (``P`` = parent, ``C`` = change), so
``--turns P`` reads the parent alone.  Each turn runs in its own process
with that root first on ``sys.path``; the checkout builds its own
``context_attention`` and ``context_attention_bwd`` libraries at first
use.  At A = E = 512 and F = 56 frames (two modalities of 28, masked
tails, video 0 all masked; inputs drawn from a fixed seed) each turn
times, in bf16 and f32:

* the forward ``fused_context_attention`` at the slot loop's shapes: R =
  320 and R = 40 rows at rep = 5 (beam, 64 and 8 videos), R = 64 at rep
  = 1 (greedy), R = 320 at rep = 1 (the non-deduplicated slot cache),
  and R = 1,280 at rep = 20 with the weights written (the teacher-forced
  steps of scheduled-sampling training);
* the backward ``fused_context_attention_bwd`` at R = 1,280, rep = 20.

Each reading is the profiler's device time per call (the sum over every
kernel the call launched, mean of ``--reps`` calls after a warm-up call
and a warm-up step of the profiler), with the CUDA-event clock beside it
(at these sizes it reads the host's enqueue), the kernels by name and
the launches per call.  The profiler now and then leaves launches at a
window's start unrecorded, so a window counts only if it recorded
exactly ``--reps`` times the checkout's kernel launches a call (``cstk::``
kernels): ``--parent-launches`` / ``--change-launches`` give them as
"forward,backward" (one ``att_context_kernel`` and a three-kernel
backward read 1,3; the cluster kernels 1,2).  More fails, and six
windows short of it fail.  Prints one line per turn, the card's name and
power limit, then one JSON line with every reading.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

A, E, FR = 512, 512, 28
F = 2 * FR
FWD_SHAPES = ((320, 5, False), (40, 5, False), (64, 1, False),
              (320, 1, False), (1280, 20, True))
BWD_SHAPE = (1280, 20)


def inputs(torch, R: int, rep: int, seed: int):
    """One call's operands (float32, on the card): q (R, A), per-video
    proj / vals / mask with masked tails and video 0 all masked, att_v,
    a context cotangent."""
    B = R // rep
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    n = torch.randint(1, FR + 1, (B, 2), generator=g)
    pos = torch.arange(FR)[None, :]
    mask = torch.cat([pos < n[:, :1], pos < n[:, 1:]], 1).float()
    mask[0] = 0.0
    a = dict(q=r(R, A, sc=0.5), proj=r(B, F, A, sc=0.5), mask=mask,
             vals=r(B, F, E, sc=0.5), v=r(A, 1, sc=0.06),
             dctx=r(R, E, sc=1.0))
    return {k: x.cuda() for k, x in a.items()}


def worker(root: str, reps: int, expect: tuple) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from cst_captioning_torch.ops import attention as am

    def events(fn):
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

    def device(fn, launches):
        """(device ms per call, {kernel: [ms per call, launches per
        call]}) from a profiler window that recorded ``reps * launches``
        of the port's kernels."""
        fn()
        torch.cuda.synchronize()
        seen = []
        for _ in range(6):
            got = []
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1),
                         on_trace_ready=lambda p: got.append(
                             p.key_averages())) as prof:
                for _ in range(2):  # the warm-up step, then the window
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                    prof.step()
            kern = {}
            for e in (got[0] if got else []):
                us = (getattr(e, "device_time_total", 0)
                      or getattr(e, "cuda_time_total", 0))
                if us:
                    kern[e.key[:60]] = [us / 1e3 / reps, e.count / reps]
            n = round(reps * sum(v[1] for k, v in kern.items()
                                 if "cstk::" in k))
            if n > reps * launches:
                raise RuntimeError(f"{n} kernel launches over {reps} calls, "
                                   f"{launches} a call expected")
            if n == reps * launches:
                return sum(v[0] for v in kern.values()), kern
            seen.append(n)
        raise RuntimeError(f"no profiler window recorded {reps} x {launches} "
                           f"launches: {seen}")

    def read(fn, launches):
        ms, kern = device(fn, launches)
        return {"device_ms": ms, "event_ms": events(fn),
                "launches_per_call": sum(v[1] for v in kern.values()),
                "kernels": kern}

    out = {"root": root}
    for tag, cdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for R, rep, attn in FWD_SHAPES:
            a = inputs(torch, R, rep, seed=R + rep)
            q, proj, vals, v = (a[k].to(cdt) for k in ("q", "proj", "vals",
                                                       "v"))
            out[f"fwd_{tag}_R{R}_rep{rep}"] = read(
                lambda: am.fused_context_attention(
                    q, proj, a["mask"], vals, v, rep=rep, return_attn=attn),
                expect[0])
        R, rep = BWD_SHAPE
        a = inputs(torch, R, rep, seed=7)
        q, proj, vals, v, dctx = (a[k].to(cdt) for k in
                                  ("q", "proj", "vals", "v", "dctx"))
        _, attn = am.fused_context_attention(q, proj, a["mask"], vals, v,
                                             rep=rep, return_attn=True)
        out[f"bwd_{tag}_R{R}_rep{rep}"] = read(
            lambda: am.fused_context_attention_bwd(q, proj, vals, v, attn,
                                                   dctx, rep=rep),
            expect[1])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--change",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--turns", default="PCCP")
    ap.add_argument("--parent-launches", default="1,3")
    ap.add_argument("--change-launches", default="1,2")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--expect", default="1,2", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        expect = tuple(int(x) for x in args.expect.split(","))
        print(json.dumps(worker(args.worker, args.reps, expect)), flush=True)
        return 0
    if not args.parent or set(args.turns) - {"P", "C"}:
        ap.error("--parent is required; --turns holds only P and C")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    roots = {"P": args.parent, "C": args.change}
    expects = {"P": args.parent_launches, "C": args.change_launches}
    turns = []
    for label in args.turns:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             roots[label], "--reps", str(args.reps), "--expect",
             expects[label]],
            capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(run.stdout.strip().splitlines()[-1])
        turn["turn"] = label
        turns.append(turn)
        print(label, " ".join(
            f"{k} {x['device_ms']:.4f}" for k, x in turn.items()
            if isinstance(x, dict)), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
