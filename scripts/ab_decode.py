#!/usr/bin/env python3
"""Time the fused decode kernels of two checkouts on one card, in turns:
parent, change, change, parent.

    python3 scripts/ab_decode.py --parent DIR [--change DIR] [--reps 5]

DIR is the root of a checkout (``--change`` defaults to this one).  Each
turn runs in its own process with that root first on ``sys.path``; the
checkout builds its own ``lstm_beam`` and ``lstm_sample`` libraries at
first use.  At the serving shape of ``msrvtt_serve_beam5`` (B = 64
videos, K = 5, E = H = A = 512, V = 10,496, T = 30; under attention F =
56 frames with masked tails; inputs drawn from a fixed seed) each turn
times with CUDA events, after one warm-up call, for each fusion (the
meanpool decoders ``lstm_beam`` / ``lstm_sample``, keys ``mp_*``; the
attention decoders ``attlstm_beam`` / ``attlstm_sample``): beam and
greedy sampling at bf16 compute with bf16 weights and with int8 weights
(int8w, ``quantize_per_channel`` as the model stores them), and the
multinomial sampler at bf16 on 64 rows and on the CST rollout's 1,280
(each video's operands repeated to 20 rows).  Prints one line per turn,
the card's name and power limit, then one JSON line with every reading.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

B, K, E, H, A, V, T, FR = 64, 5, 512, 512, 512, 10_496, 30, 28
F = 2 * FR
ROLLOUT = 20
# The decoders' positional operands, per fusion.
MP_ORDER = ("gx_static", "w_x", "wh", "emb", "w_out", "b_out")
ATT_ORDER = ("gx_static", "w_x", "wh", "w_ctx", "att_wh", "att_v",
             "att_proj", "att_mask", "att_vals", "emb", "w_out", "b_out")


def inputs(torch):
    """The attention decoders' operands (float32, on the card): vocab
    weights spread (randn * 0.3), recurrence at init scale (randn * 0.03),
    every video with a random valid-frame count per modality, video 0
    all masked."""
    g = torch.Generator().manual_seed(9)
    r = lambda *s, sc: torch.randn(*s, generator=g) * sc  # noqa: E731
    n = torch.randint(1, FR + 1, (B, 2), generator=g)
    pos = torch.arange(FR)[None, :]
    mask = torch.cat([pos < n[:, :1], pos < n[:, 1:]], 1).float()
    mask[0] = 0.0
    a = dict(gx_static=r(B, 4 * H, sc=0.1), w_x=r(E, 4 * H, sc=0.03),
             wh=r(H, 4 * H, sc=0.03), w_ctx=r(E, 4 * H, sc=0.03),
             att_wh=r(H, A, sc=0.03), att_v=r(A, 1, sc=0.06),
             att_proj=r(B, F, A, sc=0.5), att_mask=mask,
             att_vals=r(B, F, E, sc=0.5), emb=r(V, E, sc=0.3),
             w_out=r(H, V, sc=0.3), b_out=r(V, sc=0.1))
    return {k: v.cuda() for k, v in a.items()}


def worker(root: str, reps: int) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from cst_captioning_torch.ops import beam as bm
    from cst_captioning_torch.ops import sampler as sm
    from cst_captioning_torch.ops.quant import quantize_per_channel

    a = inputs(torch)
    bf = torch.bfloat16
    f32_keys = ("gx_static", "att_mask", "b_out")
    v16 = {k: x if k in f32_keys else x.to(bf) for k, x in a.items()}
    q = lambda w, axis: [x.cuda() for x in  # noqa: E731
                         quantize_per_channel(w.cpu(), axis)]
    emb_q, emb_s = q(a["emb"], 0)
    out_q, out_s = q(a["w_out"], 1)
    per_video = ("gx_static", "att_proj", "att_mask", "att_vals")

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

    out = {"root": root}
    big = {k: x.repeat_interleave(ROLLOUT, 0) if k in per_video else x
           for k, x in v16.items()}
    for pre, att in (("mp_", False), ("", True)):
        # int8w: one (4H,) scale over the stacked gate weights, as the
        # model stores lstm0_w.
        gate = ["w_x", "w_ctx", "wh"] if att else ["w_x", "wh"]
        lstm_q, lstm_s = q(torch.cat([a[k] for k in gate]), 1)
        vq = dict(v16, emb=emb_q, w_out=out_q)
        for k, w in zip(gate, lstm_q.split([a[k].shape[0] for k in gate])):
            vq[k] = w
        scales = (emb_s, out_s, lstm_s)
        if att:
            vq["att_wh"], att_s = q(a["att_wh"], 1)
            scales += (att_s,)
        quant = dict(quant=scales, compute_dtype=bf)
        order = ATT_ORDER if att else MP_ORDER
        beam = bm.attlstm_beam if att else bm.lstm_beam
        sample = sm.attlstm_sample if att else sm.lstm_sample

        def args(d):
            return [d[k] for k in order]

        for tag, d, kw in (("bf16", v16, {}), ("int8w", vq, quant)):
            out[f"{pre}beam_{tag}"] = events(lambda: beam(
                *args(d), beam_size=K, max_len=T, **kw))
            out[f"{pre}greedy_{tag}"] = events(lambda: sample(
                *args(d), (0, 0), max_len=T, greedy=True, **kw))
        for tag, d in ((f"R{B}", v16), (f"R{B * ROLLOUT}", big)):
            out[f"{pre}multinomial_bf16_{tag}"] = events(lambda: sample(
                *args(d), (123, 456), max_len=T, greedy=False))
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
