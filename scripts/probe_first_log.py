#!/usr/bin/env python3
"""Probe the accuracy of the first CPU ``log`` of a fresh process.

    python3 scripts/probe_first_log.py [--runs 96] [--threads 32]
                                       [--parallel 8] [--jax]

Each run is a fresh process that imports torch (with ``--jax``, first
imports jax and runs one XLA product on the CPU, as a test worker of
the suite has done before the port's tests), sets ``--threads`` OpenMP
threads and takes the log of a (64, 4096) float32 tensor of
uniforms in [1e-6, 1) as its first log, in one of two arms:

* ``cold``: ``torch.log`` straight away (the parallel path: the tensor
  is past the CPU grain size, so its chunks run on several threads);
* ``settled``: ``ops/threefry.py::_settle_cpu_log`` first (one log
  below the grain size, on the calling thread), as
  ``gumbel_from_bits`` does on a CPU tensor.

A run is ``bad`` when any element's relative error against the float64
log exceeds 1e-6 (an accurate float32 log is within an ulp, 6e-8).  The
arms alternate, ``--parallel`` processes at a time (the race shows
under load).  Prints one JSON line: runs and bad runs per arm, and the
worst relative error seen.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
import numpy as np
if sys.argv[3] == "jax":
    import jax.numpy as jnp
    (jnp.ones((512, 512)) @ jnp.ones((512, 512))).block_until_ready()
import torch
torch.set_num_threads(int(sys.argv[2]))
if sys.argv[1] == "settled":
    from cst_captioning_torch.ops import threefry
    threefry._settle_cpu_log()
u = np.random.RandomState(0).uniform(1e-6, 1.0, (64, 4096)).astype(np.float32)
got = torch.log(torch.from_numpy(u)).numpy().astype(np.float64)
want = np.log(u.astype(np.float64))
print(float(np.abs(got / want - 1).max()))
"""


def run_one(arm: str, threads: int, jax: bool) -> float:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _CHILD, arm, str(threads),
                          "jax" if jax else "-"],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300, check=True)
    return float(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=96, help="runs per arm")
    ap.add_argument("--threads", type=int, default=32)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--jax", action="store_true",
                    help="run one XLA product in each process first")
    args = ap.parse_args(argv)
    arms = ["cold", "settled"] * args.runs
    with ThreadPoolExecutor(args.parallel) as pool:
        errs = list(pool.map(
            lambda a: run_one(a, args.threads, args.jax), arms))
    rec = {"threads": args.threads, "parallel": args.parallel,
           "jax": args.jax}
    for arm in ("cold", "settled"):
        mine = [e for a, e in zip(arms, errs) if a == arm]
        rec[arm] = {"runs": len(mine), "bad": sum(e > 1e-6 for e in mine),
                    "worst_rel_err": max(mine)}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
