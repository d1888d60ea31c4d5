"""The rehearsal over several training seeds on one fabricated corpus:
the reference's multi-seed table (``docs/REHEARSAL.md``, Round 4) on the
port.

For each training seed, ``rehearsal.run`` trains ``xe,wxe`` (its final
beam-5 eval scores WXE's best checkpoint on the test split), then, on
the same corpus, ``cst`` warm-started from WXE's best (its eval scores
CST's best).  The corpus is built once, by the first seed, and reused.
With ``--plain-beam`` each of the two checkpoints is decoded again by
the plain beam on the CPU, and the row says how many test captions the
two decodes share and what the plain decode scores: a witness of the
eval path beside the kernel's.

Run (the defaults are the reference's Round-4 branch-trap protocol and
its nine training seeds)::

    python -m cst_captioning_torch.tools.rehearsal_seeds --out-dir OUT \\
        [--train-seeds 213,7,1009] [--mle-epochs 12] [--cst-epochs 16] \\
        [--plain-beam] [rehearsal flags, e.g. --videos 600]

Prints one JSON line: ``rows`` (one a seed: best val CIDEr per stage,
the epoch keep-best picked, the test scores of WXE's and CST's best,
the last CST reward) and ``mean`` / ``sd`` of every number column.
``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, List

import numpy as np

from cst_captioning_torch.tools import rehearsal

log = logging.getLogger("cst_captioning_torch.rehearsal")

ROUND4_SEEDS = (213, 7, 1009, 42, 555, 31337, 99, 777, 1234)
ROUND4_ARGS = ("--corpus", "branch-trap", "--videos", "600", "--seed", "0")


def stage_history(out_dir: str, run: str) -> Dict[str, list]:
    """Val CIDEr and mean reward per epoch of checkpoint run ``run``."""
    with open(os.path.join(out_dir, "checkpoints", run, "history.json")) as f:
        hist = json.load(f)
    epochs = sorted(hist, key=int)
    return {"val": [hist[e]["val"]["CIDEr"] for e in epochs],
            "reward": [hist[e]["reward"] for e in epochs if "reward" in hist[e]]}


def plain_beam_eval(args, checkpoint: str, kernel_predictions: str,
                    device: str = "cpu") -> Dict:
    """Decode the test split with ``checkpoint`` by the plain beam on the
    CPU (on ``device``; a CUDA caller swaps the plain beam in itself);
    its scores and how many captions equal the kernel's decode in
    ``kernel_predictions``."""
    from cst_captioning_torch.data.build import build_dataset
    from cst_captioning_torch.evaluation import evaluate_dataset
    from cst_captioning_torch.models.captioner import model_from_config
    from cst_captioning_torch.training.checkpoint import restore_params

    with open(os.path.join(args.out_dir, "prep", "manifest.json")) as f:
        prep = json.load(f)["prep"]
    cfg = rehearsal.rehearsal_config(args, prep)
    if rehearsal.data_route(prep) == "memory":
        ds = rehearsal.memory_splits(
            os.path.join(args.out_dir, "raw", rehearsal.ANNOTATIONS), prep,
            os.path.join(args.out_dir, "packed"), cfg.data.feature_modalities,
            args.max_words)["test"]
    else:
        ds, _ = build_dataset(cfg, "test")
    cfg.model.vocab_size = len(ds.vocab)
    model = model_from_config(cfg, device=device)
    restore_params(checkpoint, model)
    scores, preds = evaluate_dataset(model, ds, cfg, device=device)
    with open(kernel_predictions) as f:
        kernel = {p["image_id"]: p["caption"] for p in json.load(f)}
    return {"scores": scores,
            "same_captions": sum(preds[v] == kernel.get(v) for v in preds),
            "captions": len(preds)}


def seed_row(out_dir: str, seed: int, rest: List[str], mle_epochs: int,
             cst_epochs: int, reuse: bool, plain_beam: bool,
             device=None) -> Dict:
    """Both rehearsal runs of one training seed; the table's row."""
    run = f"s{seed}"
    base = ["--out-dir", out_dir, *rest, "--train-seed", str(seed)]
    mle = rehearsal.parser().parse_args(
        base + ["--stages", "xe,wxe", "--epochs", str(mle_epochs),
                "--run-name", run] + (["--reuse-data"] if reuse else []))
    s1 = rehearsal.run(mle, device=device)
    wxe_best = os.path.join(out_dir, "checkpoints", f"{run}_wxe", "best")
    cst = rehearsal.parser().parse_args(
        base + ["--stages", "cst", "--epochs", str(cst_epochs),
                "--run-name", f"{run}c", "--reuse-data",
                "--start-from", wxe_best])
    s2 = rehearsal.run(cst, device=device)
    hist = {st: stage_history(out_dir, f"{r}_{st}") for st, r in
            (("xe", run), ("wxe", run), ("cst", f"{run}c"))}
    row = {"seed": seed}
    for st in ("xe", "wxe", "cst"):
        val = hist[st]["val"]
        row[f"{st}_val"] = max(val)
        row[f"{st}_best_epoch"] = int(np.argmax(val))
        row[f"{st}_val_per_epoch"] = [round(v, 4) for v in val]
    for st, s in (("wxe", s1), ("cst", s2)):
        row[f"{st}_test_cider"] = s["test_scores"]["CIDEr"]
        row[f"{st}_test_bleu4"] = s["test_scores"]["Bleu_4"]
    row["cst_reward_first"] = hist["cst"]["reward"][0]
    row["cst_reward_last"] = hist["cst"]["reward"][-1]
    if plain_beam:
        for st, ns, r in (("wxe", mle, run), ("cst", cst, f"{run}c")):
            best = os.path.join(out_dir, "checkpoints", f"{r}_{st}", "best")
            got = plain_beam_eval(ns, best, os.path.join(
                out_dir, "checkpoints", r, "eval", "predictions.json"))
            row[f"{st}_plain_test_cider"] = got["scores"]["CIDEr"]
            row[f"{st}_plain_test_bleu4"] = got["scores"]["Bleu_4"]
            row[f"{st}_plain_same_captions"] = got["same_captions"]
            row["test_captions"] = got["captions"]
    log.info("rehearsal seed %d: %s", seed, json.dumps(row))
    return row


def table(rows: List[Dict]) -> Dict:
    """``rows`` with the mean and sd (ddof 1, as the reference's table)
    of every number column."""
    cols = [k for k, v in rows[0].items()
            if k != "seed" and isinstance(v, (int, float))]
    ddof = 1 if len(rows) > 1 else 0
    return {"rows": rows,
            "mean": {c: float(np.mean([r[c] for r in rows])) for c in cols},
            "sd": {c: float(np.std([r[c] for r in rows], ddof=ddof))
                   for c in cols}}


def main(argv=None, device=None) -> int:
    """``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("rehearsal_seeds")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--train-seeds",
                   default=",".join(str(s) for s in ROUND4_SEEDS))
    p.add_argument("--mle-epochs", type=int, default=12)
    p.add_argument("--cst-epochs", type=int, default=16)
    p.add_argument("--plain-beam", action="store_true",
                   help="decode each best checkpoint again by the plain "
                        "beam on the CPU")
    args, rest = p.parse_known_args(argv)
    if not rest:
        rest = list(ROUND4_ARGS)
    seeds = [int(s) for s in args.train_seeds.split(",") if s.strip()]
    rows = [seed_row(args.out_dir, s, rest, args.mle_epochs,
                     args.cst_epochs, i > 0, args.plain_beam, device)
            for i, s in enumerate(seeds)]
    print(json.dumps(table(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
