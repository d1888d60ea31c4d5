#!/usr/bin/env python3
"""Time the attention recurrence kernels of two checkouts on one card, in
turns: parent, change, change, parent.

    python3 scripts/ab_attlstm.py --parent DIR [--change DIR] [--reps 5]

DIR is the root of a checkout (``--change`` defaults to this one).  Each
turn runs in its own process with that root first on ``sys.path``; the
checkout builds its own ``attlstm_recurrence`` library at first use.  At
the attention XE shape (R = 1,280 caption rows of 64 videos, T = 29, F =
56, E = H = A = 512; inputs drawn from a fixed seed) each turn times with
CUDA events, after one warm-up call: the bf16 forward with residuals, the
bf16 backward with its three weight contractions, the int8w forward at
bf16 compute, and the float32 forward and backward.  A checkout whose
wrappers take ``rep`` is given the per-video attention tensors at rep =
20, as its model passes them; an older one the tensors repeated to the
rows, as its model passed them.  Prints one line per turn, the card's
name and power limit, then one JSON line with every reading.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

R, T, H, E, A, FR, REP = 1280, 29, 512, 512, 512, 28, 20
F = 2 * FR


def worker(root: str, reps: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import inspect

    import torch

    from cst_captioning_torch.ops import attlstm as am
    from cst_captioning_torch.ops.quant import quantize_per_channel

    torch.backends.cuda.matmul.allow_tf32 = False
    takes_rep = "rep" in inspect.signature(am.attlstm_recurrence_ref).parameters
    g = torch.Generator(device="cuda").manual_seed(21)
    kw = dict(generator=g, device="cuda")
    nv = R // REP
    n = torch.randint(1, FR + 1, (nv, 2),
                      generator=torch.Generator().manual_seed(21))
    pos = torch.arange(FR)[None, :]
    mask = torch.cat([pos < n[:, :1], pos < n[:, 1:]], 1).float().cuda()
    mask[0] = 0.0
    a32 = [torch.randn(R, T, 4 * H, **kw) * 0.5,
           torch.randn(H, 4 * H, **kw) * 0.03,
           torch.randn(E, 4 * H, **kw) * 0.03,
           torch.randn(H, A, **kw) * 0.03,
           torch.randn(A, 1, **kw) * 0.06,
           torch.randn(nv, F, A, **kw) * 0.5, mask,
           torch.randn(nv, F, E, **kw) * 0.5]
    dh = torch.randn(R, T, H, **kw)
    if not takes_rep:
        a32 = [x.repeat_interleave(REP, 0) if i in (5, 6, 7) else x
               for i, x in enumerate(a32)]
    rep = (REP,) if takes_rep else ()
    qkw = {"rep": REP} if takes_rep else {}

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

    out = {"root": root, "rep": REP if takes_rep else 1}
    for tag, cdt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        a = [x if i in (0, 6) else x.to(cdt) for i, x in enumerate(a32)]
        res = am.attlstm_recurrence_ref(*a, *rep, with_residuals=True)
        d = dh.to(cdt)
        out[f"fwd_{tag}"] = events(
            lambda: am.attlstm_recurrence_fwd(*a, *rep, with_residuals=True))
        out[f"bwd_{tag}"] = events(
            lambda: am.attlstm_recurrence_bwd(*a[:6], a[7], *res, d, *rep))
    gx, wh, wctx, awh, av, proj, msk, vals = a32
    lq, ls = quantize_per_channel(torch.cat([wctx, wh]).cpu(), 1)
    aq, asc = quantize_per_channel(awh.cpu(), 1)
    lq, ls, aq, asc = (x.cuda() for x in (lq, ls, aq, asc))
    bf = torch.bfloat16
    qargs = (gx, lq[E:], lq[:E], ls, aq, asc, av.to(bf), proj.to(bf), msk,
             vals.to(bf), bf)
    out["quant_bf16"] = events(
        lambda: am.attlstm_recurrence_quant(*qargs, **qkw))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--change",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.reps)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    turns = []
    for label, root in (("P", args.parent), ("C", args.change),
                        ("C", args.change), ("P", args.parent)):
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root,
             "--reps", str(args.reps)], capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        turn = json.loads(run.stdout.strip().splitlines()[-1])
        turn["turn"] = label
        turns.append(turn)
        print(label, json.dumps(turn), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
