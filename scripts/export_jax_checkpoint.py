#!/usr/bin/env python3
"""Export a checkpoint of the JAX package (orbax) to the flat npz that
the PyTorch port imports: the first of the two conversion steps.

    python scripts/export_jax_checkpoint.py --checkpoint ORBAX_DIR \\
        --out EXPORT_DIR --preset PRESET [config overrides]

Run it where ``jax`` and ``orbax.checkpoint`` are installed; the second
step, ``python -m cst_captioning_torch.tools.import_jax_checkpoint``,
needs only torch and numpy.  ``ORBAX_DIR`` is a directory the JAX
package's ``training/checkpoint.py::save_checkpoint`` wrote (its
``params/`` item is read; ``opt/`` is not: the port warm-starts a JAX
run, it does not resume it).  The configuration (``--preset`` plus
``--model.*`` / ``--data.*`` overrides, as the JAX CLIs take them) must
be the one the checkpoint was trained with: the restore template is
built from it, as the JAX serving engine builds its own
(``serving/engine.py::InferenceEngine._restore``): the float model's
parameter shapes, or under ``--serving.dtype int8w`` first the
quantized twin of that template (a save that already holds int8 codes
and their scales), then the float one.

Writes ``EXPORT_DIR/params.npz`` (one array per parameter under its flat
name: int8 codes stay int8, every other leaf float32) and copies the
checkpoint's ``infos.json`` beside it.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

NPZ_FILE = "params.npz"


def _vocab_size(cfg) -> int:
    """The vocabulary size the JAX engine resolves: ``model.vocab_size``,
    else ``data.vocab_file``'s, else the synthetic corpus's."""
    if cfg.model.vocab_size:
        return int(cfg.model.vocab_size)
    if cfg.data.vocab_file:
        from cst_captioning_tpu.data.vocab import Vocabulary

        return len(Vocabulary.load(cfg.data.vocab_file))
    if cfg.data.dataset == "synthetic":
        from cst_captioning_tpu.data.build import build_dataset

        return len(build_dataset(cfg, cfg.eval.eval_split)[1])
    raise ValueError("set --model.vocab_size or --data.vocab_file")


def restore_jax_params(checkpoint: str, cfg):
    """The ``{"params": {...}}`` tree of ``checkpoint`` as numpy arrays,
    restored with the JAX package's ``restore_params`` against the
    template its serving engine builds."""
    import jax
    import jax.numpy as jnp

    from cst_captioning_tpu.models.captioner import model_from_config
    from cst_captioning_tpu.ops import quant
    from cst_captioning_tpu.training.checkpoint import restore_params

    cfg.model.vocab_size = _vocab_size(cfg)
    model = model_from_config(cfg)  # the float twin, never weight_quant
    d = cfg.data
    feats = {m: jnp.zeros((1, d.max_frames, dim))
             for m, dim in d.feature_dims.items()}
    masks = {m: jnp.ones((1, d.max_frames)) for m in feats}
    ids = jnp.zeros((1, 2), jnp.int32)
    cat = jnp.zeros((1,), jnp.int32) if model.use_category else None
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), feats, masks, ids, category=cat))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), template)
    params = None
    if str(cfg.serving.dtype or "f32") == "int8w":
        try:
            params = restore_params(checkpoint,
                                    quant.quantize_template(template))
        except Exception:  # noqa: BLE001 — not a quantized save
            params = None
    if params is None:
        params = restore_params(checkpoint, template)
    return jax.tree.map(np.asarray, params)


def export(checkpoint: str, out_dir: str, cfg) -> str:
    """Write ``out_dir/params.npz`` (+ ``infos.json``); returns the npz
    path."""
    params = restore_jax_params(checkpoint, cfg)["params"]
    flat = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            raise ValueError(f"nested parameter group {name!r}: the caption "
                             "model has a flat parameter tree")
        a = np.asarray(leaf)
        flat[name] = a if a.dtype == np.int8 else a.astype(np.float32)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, NPZ_FILE)
    np.savez(path, **flat)
    infos = os.path.join(checkpoint, "infos.json")
    if os.path.exists(infos):
        shutil.copyfile(infos, os.path.join(out_dir, "infos.json"))
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--out", required=True)
    known, rest = parser.parse_known_args(argv)
    from cst_captioning_tpu.config import parse_cli

    path = export(known.checkpoint, known.out, parse_cli(rest))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
