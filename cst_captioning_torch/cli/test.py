"""Evaluation CLI of the port (the JAX package's ``cli/test.py``), on
the GPU: checkpoint -> beam decode -> predictions.json + scores.json.

  python -m cst_captioning_torch.cli.test --preset msrvtt_eval_beam5 \\
      --checkpoint checkpoints/msrvtt_cst_ms_scb/best \\
      --data.vocab_file vocab.json --data.label_file 'labels_{split}.h5' \\
      --data.feature_files '{"resnet": "packed_test", "c3d": "packed_test"}' \\
      [--eval.eval_split test] [--eval.out_dir eval_out]

``--checkpoint`` is a port checkpoint directory (``params.pt``: what
the trainer writes, or a params-only one such as
``tools/import_jax_checkpoint`` makes of a JAX-trained model); an orbax
directory itself is refused with the commands that convert it.  Under
``--model.use_category true`` the split's category ids reach the beam
search.  The beam search
runs the ``lstm_beam`` kernel (``attlstm_beam`` under
``--model.feature_fusion attention``), one call per batch.
"""

from __future__ import annotations

import argparse
import logging
import sys

from cst_captioning_torch.config import parse_cli
from cst_captioning_torch.data.build import build_dataset
from cst_captioning_torch.evaluation import evaluate_dataset
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.training.checkpoint import restore_params


def main(argv=None, device=None) -> int:
    """``device``: ``cuda`` unless the caller passes ``"cpu"``."""
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--checkpoint", required=True)
    known, rest = parser.parse_known_args(argv)
    cfg = parse_cli(rest)

    ds, vocab = build_dataset(cfg, cfg.eval.eval_split)
    if cfg.model.vocab_size == 0:
        cfg.model.vocab_size = len(vocab)
    model = model_from_config(cfg, device=device)
    restore_params(known.checkpoint, model)
    scores, _ = evaluate_dataset(model, ds, cfg, out_dir=cfg.eval.out_dir,
                                 device=device)
    for k, v in scores.items():
        # Non-numeric entries (e.g. METEOR_backend) print verbatim.
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
