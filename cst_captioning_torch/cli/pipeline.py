"""Staged experiment pipeline of the port (the JAX package's
``cli/pipeline.py``): the paper's XE -> WXE -> CST regimes chained with
warm starts, ending with a beam-search evaluation, on the GPU.

  python -m cst_captioning_torch.cli.pipeline --preset msrvtt_resnet_c3d_xe \\
      [--stages xe,wxe,cst] [--eval-split test] [--<section>.<field> ...]

Each stage trains to keep-best on val CIDEr, and the next stage
warm-starts from that checkpoint (or from ``last`` without a val
split).  The final eval restores the last stage's checkpoint into a
model on the trainer's device and runs ``evaluation.evaluate_dataset``
(the ``lstm_beam`` kernel).  ``<checkpoint_dir>/<name>/pipeline.json``
records every stage's history and the eval.  A preempted stage stops
the pipeline, and ``main`` returns 75 (EX_TEMPFAIL) so the job is
rescheduled; ``train.resume`` continues that stage.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, List, Optional

from cst_captioning_torch.config import Config, parse_cli
from cst_captioning_torch.data.build import build_dataset
from cst_captioning_torch.data.datasets import CaptionDataset
from cst_captioning_torch.device import resolve_device

log = logging.getLogger("cst_captioning_torch.pipeline")

# Stage recipes: overrides applied on top of the base config.  The
# learning rates follow the reference's fine-tune convention (lower
# after a warm start).
STAGE_RECIPES: Dict[str, Dict] = {
    "xe": {"train.train_mode": "xe"},
    "wxe": {"train.train_mode": "wxe", "train.learning_rate": 1e-4},
    "cst": {
        "train.train_mode": "cst",
        "train.cst_baseline": "scb",
        "train.learning_rate": 1e-4,
    },
    "cst_greedy": {
        "train.train_mode": "cst",
        "train.cst_baseline": "greedy",
        "train.learning_rate": 1e-4,
    },
}


def run_pipeline(
    base_cfg: Config,
    stages: List[str],
    eval_split: Optional[str] = "test",
    stage_overrides: Optional[Dict[str, Dict]] = None,
    device=None,
    datasets: Optional[Dict[str, CaptionDataset]] = None,
) -> Dict[str, dict]:
    """Run the staged pipeline; returns {stage: history} and, after the
    eval, ``"eval"``: {"split", "scores", "out_dir"}.

    ``stage_overrides``: {stage: {dotted.key: value}} applied after the
    stage recipe.  ``device``: ``cuda`` unless the caller passes
    ``"cpu"``.  ``datasets``: prebuilt splits ({"train", "val", "test"}
    -> dataset, e.g. ``PackedDataset``s), used instead of building them
    from ``base_cfg.data``; the vocabulary is the train split's."""
    from cst_captioning_torch.training.trainer import Trainer

    device = resolve_device(device)
    if datasets is not None:
        train_ds = datasets["train"]
        vocab = train_ds.vocab
        val_ds = datasets.get("val")
        if val_ds is None:
            log.warning("no val split — stages keep their last checkpoint")
    else:
        train_ds, vocab = build_dataset(base_cfg, "train")
        try:
            val_ds, _ = build_dataset(base_cfg, "val", vocab=vocab)
        except (KeyError, FileNotFoundError, ValueError):
            log.warning("no val split — stages keep their last checkpoint")
            val_ds = None

    results: Dict[str, dict] = {}
    prev_best = base_cfg.train.start_from
    last_cfg = base_cfg
    for stage in stages:
        if stage not in STAGE_RECIPES:
            raise KeyError(
                f"unknown stage {stage!r}; have {sorted(STAGE_RECIPES)}")
        recipe = dict(STAGE_RECIPES[stage])
        recipe.update((stage_overrides or {}).get(stage, {}))
        cfg = base_cfg.replace(**recipe)
        cfg.name = f"{base_cfg.name}_{stage}"
        cfg.train.start_from = prev_best
        trainer = Trainer(cfg, train_ds=train_ds, val_ds=val_ds,
                          device=device)
        log.info("=== stage %s (mode=%s, warm_start=%s) ===",
                 stage, cfg.train.train_mode, prev_best or "none")
        results[stage] = trainer.fit()
        best = os.path.join(trainer.workdir, "best")
        last = os.path.join(trainer.workdir, "last")
        prev_best = best if os.path.exists(best) else last
        last_cfg = cfg
        if trainer.preempted:
            # Later stages would warm-start from a truncated checkpoint
            # and the eval would score it: stop, and say where.
            results["preempted"] = {"stage": stage, "checkpoint": last}
            log.warning("pipeline preempted during stage %s — stopping "
                        "(resume with train.resume=True to continue)", stage)
            return results
        log.info("stage %s done; checkpoint %s", stage, prev_best)

    if eval_split:
        from cst_captioning_torch.evaluation import evaluate_dataset
        from cst_captioning_torch.models.captioner import model_from_config
        from cst_captioning_torch.training.checkpoint import restore_params

        if datasets is not None:
            eval_ds = datasets[eval_split]
        else:
            eval_ds, _ = build_dataset(last_cfg, eval_split, vocab=vocab)
        model = model_from_config(last_cfg, device=device)
        restore_params(prev_best, model)
        out_dir = os.path.join(last_cfg.train.checkpoint_dir, base_cfg.name,
                               "eval")
        scores, _ = evaluate_dataset(model, eval_ds, last_cfg,
                                     out_dir=out_dir, device=device)
        results["eval"] = {"split": eval_split, "scores": scores,
                           "out_dir": out_dir}
        log.info("final eval (%s): %s", eval_split, scores)
    return results


def main(argv=None, device=None) -> int:
    """``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--stages", default="xe,wxe,cst")
    parser.add_argument("--eval-split", default="test")
    known, rest = parser.parse_known_args(argv)
    cfg = parse_cli(rest)
    stages = [s.strip() for s in known.stages.split(",") if s.strip()]
    results = run_pipeline(cfg, stages, eval_split=known.eval_split or None,
                           device=device)
    out = os.path.join(cfg.train.checkpoint_dir, cfg.name, "pipeline.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(json.dumps(results.get("eval", {}), default=str))
    if "preempted" in results:
        # 75 = EX_TEMPFAIL: transient, reschedule; resume continues the
        # stage.
        return 75
    return 0


if __name__ == "__main__":
    sys.exit(main())
