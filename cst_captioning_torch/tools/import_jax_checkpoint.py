"""Import a JAX-trained checkpoint into the port: the second of the two
conversion steps (the first, ``scripts/export_jax_checkpoint.py``, runs
where ``jax`` and ``orbax.checkpoint`` are installed and writes the
flat ``params.npz`` this tool reads; this one needs only torch and
numpy).

Run::

    python -m cst_captioning_torch.tools.import_jax_checkpoint \\
        --export EXPORT_DIR --out PORT_DIR --preset PRESET [overrides]

The configuration (``--preset`` plus ``--model.*`` / ``--data.*``
overrides) must be the checkpoint's: the arrays go through
``models/weights.py::params_to_state_dict`` (int8 codes stay int8, the
rest their exact float32 widening) and load strictly into
``model_from_config(cfg)`` (a ``weight_quant`` twin for a quantized
export), so every name and shape is held against the configuration
before anything is written.  Each float leaf rounds back into
``model.param_dtype``: a JAX run trained with bf16 leaves imports
bitwise with ``--model.param_dtype bfloat16``.  The
output is a params-only port checkpoint (``training/checkpoint.py::
save_params``: ``params.pt`` and ``infos.json``, no ``opt.pt``): serve
it with ``cli/serve.py --checkpoint PORT_DIR``, evaluate it with
``cli/test.py``, or warm-start training from it with
``--train.start_from PORT_DIR``.  The optimizer state is not converted:
a JAX run restarts its optimizer in the port, as the reference's
``--start_from`` does.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

from cst_captioning_torch.config import Config, parse_cli
from cst_captioning_torch.models.captioner import model_from_config
from cst_captioning_torch.models.weights import load_params, params_to_state_dict
from cst_captioning_torch.ops.quant import is_quantized
from cst_captioning_torch.training.checkpoint import save_params

log = logging.getLogger("cst_captioning_torch.tools")

NPZ_FILE = "params.npz"


def _vocab_size(cfg: Config) -> int:
    """``model.vocab_size``, else ``data.vocab_file``'s, else the
    synthetic corpus's (the exporter resolves it the same way)."""
    if cfg.model.vocab_size:
        return int(cfg.model.vocab_size)
    if cfg.data.vocab_file:
        from cst_captioning_torch.data.vocab import Vocabulary

        return len(Vocabulary.load(cfg.data.vocab_file))
    if cfg.data.dataset == "synthetic":
        from cst_captioning_torch.data.build import build_dataset

        return len(build_dataset(cfg, cfg.eval.eval_split)[1])
    raise ValueError("set --model.vocab_size or --data.vocab_file")


def read_export(export_dir: str):
    """The export's state dict (CPU tensors) and its ``infos.json``."""
    with np.load(os.path.join(export_dir, NPZ_FILE)) as z:
        sd = params_to_state_dict({name: z[name] for name in z.files})
    infos_path = os.path.join(export_dir, "infos.json")
    infos = {}
    if os.path.exists(infos_path):
        with open(infos_path) as f:
            infos = json.load(f)
    return sd, infos


def import_checkpoint(export_dir: str, out_dir: str, cfg: Config) -> str:
    """Check the export against ``cfg`` and write it to ``out_dir`` as a
    params-only port checkpoint; returns ``out_dir``."""
    sd, infos = read_export(export_dir)
    cfg.model.vocab_size = _vocab_size(cfg)
    quantized = is_quantized(sd)
    model = model_from_config(cfg, serving_dtype="int8w" if quantized
                              else None, device="cpu")
    load_params(model, sd)
    infos = dict(infos, imported_from=os.path.abspath(export_dir),
                 quantized=quantized)
    save_params(out_dir, model, infos)
    log.info("imported %s (%d tensors%s) into %s", export_dir, len(sd),
             ", int8w" if quantized else "", out_dir)
    return out_dir


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--export", required=True)
    parser.add_argument("--out", required=True)
    known, rest = parser.parse_known_args(argv)
    print(f"wrote {import_checkpoint(known.export, known.out, parse_cli(rest))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
