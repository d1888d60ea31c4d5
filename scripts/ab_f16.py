#!/usr/bin/env python3
"""Time the bfloat16 and float16 instantiations of the meanpool path's
four kernels on one card, in turns: bf16, f16, f16, bf16 (``--rounds``
times), on the same inputs.

    python3 scripts/ab_f16.py [--rounds 3] [--reps 5]

Each turn times, with CUDA events over ``--reps`` calls after a warm-up
call, ``lstm_beam`` (B = 64, K = 5) and ``lstm_sample`` (greedy at B =
64, multinomial at 1,280 rows) on ``chip_smoke.py``'s phase 2 inputs,
``lstm_recurrence`` on phase 2b's (R = 1,280, T = 29, with the cell
output), and ``row_gemm``'s vocab product (R = 320, K = 512, N = 10,496)
by the profiler's device time, all at E = H = 512, V = 10,496, T = 30,
the operands rounded to the turn's dtype.  Prints one line per turn, the
card's name and power limit, then one JSON line with every reading.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def turn(torch, cs, mods, cdt, reps: int) -> dict:
    beam, sampler, lstm, rowgemm = mods
    a = cs.to_card(torch, cs.make_inputs(torch, 0), cdt)
    v = list(a.values())
    big = [x.repeat_interleave(cs.ROLLOUT_ROWS // cs.B, 0)
           if k in cs.PER_VIDEO else x for k, x in a.items()]
    gx, wh, _ = cs.rec_inputs(torch, 11, cs.R_XE, cs.T_XE)
    wh = wh.to(cdt)
    g = torch.Generator(device="cuda").manual_seed(41)
    x = (torch.randn(cs.B * cs.K, cs.H, generator=g, device="cuda")
         * 0.5).to(cdt)
    w = (torch.randn(cs.H, cs.V, generator=g, device="cuda")
         / cs.H ** 0.5).to(cdt)
    T = cs.T
    return {
        "lstm_beam": cs.time_call(
            torch, lambda: beam.lstm_beam(*v, beam_size=cs.K, max_len=T),
            reps),
        "lstm_sample_greedy": cs.time_call(
            torch, lambda: sampler.lstm_sample(*v, (0, 0), max_len=T,
                                               greedy=True), reps),
        "lstm_sample_multinomial_R1280": cs.time_call(
            torch, lambda: sampler.lstm_sample(*big, (123, 456), max_len=T,
                                               greedy=False), reps),
        "lstm_recurrence": cs.time_call(
            torch, lambda: lstm.lstm_recurrence_fwd(gx, wh, with_cell=True),
            reps),
        "row_gemm_vocab_device": cs.device_ms(
            torch, lambda: rowgemm.row_dot(x, w, cdt), cs.RG_TIMED),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from cst_captioning_torch.ops import _build, beam, lstm, rowgemm, sampler

    if not torch.cuda.is_available():
        print("ab_f16: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _build.build(["lstm_beam", "lstm_sample", "lstm_recurrence", "row_gemm"])
    mods = (beam, sampler, lstm, rowgemm)
    out = []
    for r in range(args.rounds):
        for name in ("bfloat16", "float16", "float16", "bfloat16"):
            got = turn(torch, cs, mods, getattr(torch, name), args.reps)
            out.append({"round": r, "dtype": name, **got})
            print(f"round {r} {name}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in got.items()), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "turns": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
