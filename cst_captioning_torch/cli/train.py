"""Training CLI of the port (the JAX package's ``cli/train.py``), on the
GPU:

  python -m cst_captioning_torch.cli.train --preset synthetic_smoke \
      [--model.feature_fusion attention] \
      [--model.scheduled_sampling_start N] [--train.remat true] \
      [--train.train_mode cst --train.cst_baseline scb \
       --train.cst_num_samples 4 --train.start_from <workdir>/best \
       [--train.cst_rollout slot|padded]]

trains on the synthetic corpus and writes ``checkpoints/<name>/{best,
last}`` and ``history.json`` (under CST with the epoch means of the
reward and of the step's phases).  Real data comes from an h5 label
file (``--data.vocab_file``, ``--data.label_file`` with a ``{split}``
placeholder) and per-video feature h5s or packed feature directories
(``--data.feature_files``, JSON).  ``--preset msrvtt_xe_2d`` trains on
a (data x model) mesh of the host's cards (``train.mesh_shape``; the
``-1`` axis takes every card left), the vocab split over ``model``
(``training/sharded.py``); a mesh larger than the host refuses.
"""

from __future__ import annotations

import logging
import sys

from cst_captioning_torch.config import parse_cli
from cst_captioning_torch.data.build import build_dataset
from cst_captioning_torch.training.trainer import Trainer


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    cfg = parse_cli(argv)
    train_ds, vocab = build_dataset(cfg, "train")
    try:
        val_ds, _ = build_dataset(cfg, "val", vocab=vocab)
    except (KeyError, FileNotFoundError, ValueError):
        logging.warning("no val split found — training without validation")
        val_ds = None
    trainer = Trainer(cfg, train_ds=train_ds, val_ds=val_ds, device="cuda")
    trainer.fit()
    logging.info(
        "done: best val score %.4f (epoch %d), checkpoints in %s",
        trainer.best_score, trainer.best_epoch, trainer.workdir,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
