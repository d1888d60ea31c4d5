#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py``'s gradient tiers (13b's P13_GRAD_GAP,
14b's P14_ATT_GRAD_GAP at float16 compute).

    python3 scripts/probe_grad_faults.py [--steps 3] [--fault-steps 2]
        [--pdt bfloat16|float16|float32] [--cdt float16]

Needs one CUDA card.  Builds the kernels, then runs 13b's XE steps on
``--pdt`` leaves (``model.param_dtype``, ``msrvtt_resnet_c3d_xe`` at
full width, at ``--cdt`` compute, the preset's bfloat16 unless given;
float16 leaves or compute hold the gradients of P13_F16_GRAD_SCALE x
the loss, as 13b and 14b do) on the checkout as it is: the meanpool and
attention arms, ``--steps`` steps each.  Then, for each fault in ``FAULTS``, it
copies ``chip_smoke.py``, ``scripts/`` and the package (its built
kernels too) into a temporary directory, faults one output of
the attention backward kernel's wrapper there (a line after its
launch in ``ops/attlstm.py::attlstm_recurrence_bwd_core``) and runs
the attention arm in that copy for ``--fault-steps`` steps, in a child
process, with 13b's failures logged instead of raised.  The checkout
itself is never changed; each copy is removed after its run.

Each step reports the per-leaf gradient gap |g_kernel - g_plain| /
|g_plain| on the same leaves before the update (``chip_smoke.leaf_gaps``)
and the loss rtol.  Prints one JSON line: per arm or fault, the held
worst gap of each step (``held``), on float16 leaves the unscaled one
as well (``unscaled``), each gap's leaf in turn (``worst``), and the
tier.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = "        _build.count_launch(attlstm_recurrence_bwd)\n"
TARGET = os.path.join("cst_captioning_torch", "ops", "attlstm.py")
FAULTS = ("dv.mul_(1.01)", "dvals.mul_(1.01)", "dgx[:, -1].zero_()",
          "dgx.mul_(1.001)")
COPIED = ("chip_smoke.py", "scripts", "cst_captioning_torch")


def run_arm(fusion: str, steps: int, quiet_fail: bool, pdt: str,
            cdt=None) -> dict:
    """13b's ``fusion`` arm on ``pdt`` leaves (``cdt`` compute) for
    ``steps`` steps in this process; the worst gap of each step and its
    leaf."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from cst_captioning_torch.ops import attlstm, lstm

    if quiet_fail:
        cs.fail = lambda m: print(f"FAIL: {m}", flush=True)
    worst = []
    real = cs.leaf_gaps

    def gaps(torch_, got, want):
        out = real(torch_, got, want)
        k = max(out, key=out.get)
        worst.append([k, out[k]])
        return out

    cs.leaf_gaps = gaps
    try:
        return _arm(torch, cs, attlstm, lstm, fusion, steps, worst, pdt,
                    cdt)
    finally:
        cs.leaf_gaps = real


def _arm(torch, cs, attlstm, lstm, fusion, steps, worst, pdt, cdt) -> dict:
    cfg = cs.p13_cfg("msrvtt_resnet_c3d_xe", pdt=pdt, cdt=cdt)
    _, _, batch = cs.p13_batch(torch, cfg)
    if fusion == "meanpool":
        counted = {"lstm_recurrence": lstm.lstm_recurrence}
        swap = ("lstm_recurrence", cs.plain_recurrence(torch, lstm))
    else:
        counted = {"attlstm_recurrence": attlstm.attlstm_recurrence,
                   "attlstm_recurrence_bwd": attlstm.attlstm_recurrence_bwd}
        swap = ("attlstm_recurrence", cs.plain_att_recurrence(torch, attlstm))
    # float16 compute: 14b's scale and tier (P14_ATT_GRAD_GAP).
    f16 = cdt == "float16"
    scale = cs.P13_F16_GRAD_SCALE if f16 else None
    tier = cs.P14_ATT_GRAD_GAP if f16 else cs.P13_GRAD_GAP
    r, _, _ = cs.p13_xe(torch, card_line(),
                        cs.p13_cfg("msrvtt_resnet_c3d_xe", fusion, pdt, cdt),
                        batch, counted, swap, steps, scale=scale,
                        gap_tier=tier)
    return {"held": r["grad_gap"], "unscaled": r["grad_gap_unscaled"],
            "grad_scale": r["grad_scale"], "worst": worst,
            "loss_rtol": r["loss_rtol"], "tier": tier}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def faulted_copy(fault: str) -> str:
    """A temporary copy of what the arm runs (``COPIED``, the built
    kernels included) with ``fault`` after the backward kernel's
    launch."""
    dst = tempfile.mkdtemp(prefix="grad_fault_")
    for name in COPIED:
        src = os.path.join(REPO, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, name),
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            shutil.copy2(src, dst)
    path = os.path.join(dst, TARGET)
    with open(path) as f:
        src = f.read()
    if src.count(ANCHOR) != 1:
        raise SystemExit(f"the fault's anchor is not once in {TARGET}")
    with open(path, "w") as f:
        f.write(src.replace(ANCHOR, f"{ANCHOR}        {fault}\n"))
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--fault-steps", type=int, default=2)
    ap.add_argument("--pdt", default="bfloat16",
                    choices=("bfloat16", "float16", "float32"))
    ap.add_argument("--cdt", default=None, choices=("bfloat16", "float16"))
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print("RESULT " + json.dumps(run_arm(a.child, a.fault_steps, True,
                                             a.pdt, a.cdt)), flush=True)
        return 0
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    from cst_captioning_torch.ops import _build

    _build.build()          # the copies reuse _kernels_build: no nvcc there
    out = {"pdt": a.pdt, "cdt": a.cdt,
           "sound": {f: run_arm(f, a.steps, False, a.pdt, a.cdt)
                     for f in ("meanpool", "attention")},
           "faults": {}}
    for fault in FAULTS:
        dst = faulted_copy(fault)
        try:
            p = subprocess.run(
                [sys.executable, os.path.join("scripts", "probe_grad_faults.py"),
                 "--child", "attention", "--fault-steps", str(a.fault_steps),
                 "--pdt", a.pdt] + (["--cdt", a.cdt] if a.cdt else []),
                cwd=dst, capture_output=True, text=True, check=False)
        finally:
            shutil.rmtree(dst, ignore_errors=True)
        print(p.stdout, end="", flush=True)
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        if p.returncode or not line:
            print(p.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"fault {fault!r}: the child failed")
        out["faults"][fault] = json.loads(line[-1][len("RESULT "):])
    print(card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
