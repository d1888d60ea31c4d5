#!/usr/bin/env python3
"""Does a ``torch.profiler`` window opened on a thread of its own while
other threads launch kernels (the server's ``/debug/profile``) crash the
process, or leave later windows on the main thread short of launches
(``chip_smoke.profiled``'s counted windows)?

    python3 scripts/probe_profiler.py [--windows 60] [--thread-windows 24]
        [--drift-s 150] [--repeats 2]

Needs one CUDA card.  Each arm runs in a child process, so a crash reads
as the child's exit code (-11 for SIGSEGV):

* ``all_threads``: thread windows with CPU and CUDA activity and
  ``profile_all_threads`` (the server's options, ``serving/server.py``);
* ``cuda_only``: thread windows with CUDA activity alone;
* ``drift``: no thread window; for ``--drift-s`` seconds, every 15 s,
  the offset of the CUDA runtime's launch records from the operators
  that made them (``offset_ms``: a ``cudaLaunchKernel`` record's start
  minus its ``aten::add_``'s, both in the trace's host times; about
  +0.01 ms when the two clocks agree) and the share of 10 counted
  windows that recorded every launch, unpadded and with each step
  padded by 100 ms of host sleep on both sides (does a clock the
  process drifts away from drop launches near a window's edge?).

In the thread arms a child counts ``--windows`` main-thread windows
first; then three worker threads launch small GEMMs on streams
of their own while ``--thread-windows`` 200-ms windows open one after
another, each on a new thread, each exported as a Chrome trace; then the
workers stop and ``--windows`` main-thread windows are counted again.  A
counted window is ``chip_smoke.profiled``'s: a warm-up step and an active
step of 5 calls that launch one kernel each, so a whole window records
5 launches.  The arms run in the order drift, then ``--repeats`` times
all_threads and cuda_only.  Prints a JSON line for each run (the child's
exit code, the launches each counted window recorded before and after as
a histogram, the kernel events in each thread window's trace, the drift
readings), then one line with them all.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPS = 5


def counted_window(torch, fn, pad: float = 0.0):
    from torch.profiler import ProfilerActivity, profile, schedule

    got = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            time.sleep(pad)
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
    n = 0
    for e in (got[0] if got else []):
        us = (getattr(e, "device_time_total", 0)
              or getattr(e, "cuda_time_total", 0))
        if us:
            n += e.count
    return n


def thread_window(torch, arm: str, out_dir: str, i: int, found: list):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    kw = {}
    if arm == "all_threads":
        from torch._C._profiler import _ExperimentalConfig

        acts.insert(0, ProfilerActivity.CPU)
        kw = {"experimental_config":
              _ExperimentalConfig(profile_all_threads=True)}
    with profile(activities=acts, **kw) as prof:
        time.sleep(0.2)
    path = os.path.join(out_dir, f"w{i}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    found.append(len(names))


def launch_offset_ms(torch, fn, d: str) -> float:
    """Median over REPS calls of a launch record's start minus its
    operator's start, in the exported trace (host times, ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(d, "offset.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    ops = sorted(float(e["ts"]) for e in ev if e.get("name") == "aten::add_")
    rt = sorted(float(e["ts"]) for e in ev
                if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", ""))
    diffs = sorted((r - o) / 1e3 for o, r in zip(ops, rt))
    return diffs[len(diffs) // 2] if diffs else float("nan")


def child(arm: str, windows: int, thread_windows: int, drift_s: float):
    import torch

    x = torch.zeros(1 << 16, device="cuda")
    fn = lambda: x.add_(1.0)  # noqa: E731 — one kernel a call
    fn()
    torch.cuda.synchronize()
    out = {"before": [], "after": [], "thread_kernels": [], "drift": []}
    if arm == "drift":
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            while True:
                t = time.perf_counter() - t0
                row = {"t_s": round(t, 1),
                       "offset_ms": round(launch_offset_ms(torch, fn, d), 4)}
                for pad in (0.0, 0.1):
                    row[f"full_share_pad{pad:g}"] = sum(
                        counted_window(torch, fn, pad) == REPS
                        for _ in range(10)) / 10
                out["drift"].append(row)
                if t >= drift_s:
                    break
                time.sleep(max(0.0, 15.0 - (time.perf_counter() - t0 - t)))
        print("PROBE " + json.dumps(out), flush=True)
        return
    for _ in range(windows):
        out["before"].append(counted_window(torch, fn))
    if arm in ("all_threads", "cuda_only"):
        stop = threading.Event()

        def work(seed):
            s = torch.cuda.Stream()
            a = torch.randn(256, 256, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(seed))
            with torch.cuda.stream(s):
                while not stop.is_set():
                    for _ in range(20):
                        a = torch.tanh(a @ a)
                    s.synchronize()

        ws = [threading.Thread(target=work, args=(k,)) for k in range(3)]
        for w in ws:
            w.start()
        with tempfile.TemporaryDirectory() as d:
            for i in range(thread_windows):
                t = threading.Thread(target=thread_window,
                                     args=(torch, arm, d, i,
                                           out["thread_kernels"]))
                t.start()
                t.join()
        stop.set()
        for w in ws:
            w.join()
        torch.cuda.synchronize()
    for _ in range(windows):
        out["after"].append(counted_window(torch, fn))
    print("PROBE " + json.dumps(out), flush=True)


def hist(xs):
    return dict(sorted(collections.Counter(xs).items()))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--windows", type=int, default=60)
    p.add_argument("--thread-windows", type=int, default=24)
    p.add_argument("--drift-s", type=float, default=150.0)
    p.add_argument("--repeats", type=int, default=2)
    p.add_argument("--child", default="")
    a = p.parse_args()
    if a.child:
        child(a.child, a.windows, a.thread_windows, a.drift_s)
        return 0
    res = []
    arms = ["drift"] + ["all_threads", "cuda_only"] * a.repeats
    for i, arm in enumerate(arms):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", arm,
             "--windows", str(a.windows),
             "--thread-windows", str(a.thread_windows),
             "--drift-s", str(a.drift_s)],
            capture_output=True, text=True, timeout=600)
        got = {}
        for line in r.stdout.splitlines():
            if line.startswith("PROBE "):
                got = json.loads(line[6:])
        row = {"arm": arm, "run": i, "rc": r.returncode,
               "wall_s": round(time.perf_counter() - t0, 1),
               "before": hist(got.get("before", [])),
               "after": hist(got.get("after", [])),
               "thread_kernels": got.get("thread_kernels", [])}
        if arm == "drift":
            row["drift"] = got.get("drift", [])
        if r.returncode != 0:
            row["stderr_tail"] = r.stderr[-1500:]
        print(json.dumps(row), flush=True)
        res.append(row)
    print(json.dumps({"probe_profiler": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
