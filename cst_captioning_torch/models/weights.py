"""Weight bridge between the JAX package's parameter tree and the port.

The JAX model keeps its weights as ``{"params": {name: array}}`` with
the names of ``CaptionModel.setup``; the port's :class:`~cst_captioning_
torch.models.captioner.CaptionModel` registers parameters under the same
names, so the bridge is a name-for-name copy in float32 — no transposes:
both sides store ``x @ W`` weights as (in, out), and ``lstm0_w`` stacks
the rows [emb | ctx | cat | hidden] x 4H (cat under ``use_category``,
whose ``cat_embed`` crosses like any float leaf) with gates i|f|g|o on
both sides.
An int8w tree (``ops/quant.py``) crosses as it is: int8 codes stay int8
and each ``<name>_scale`` leaf crosses name for name in float32, so a
float tree (quantized at the port's boot) and an already quantized tree
both load.

The JAX side is handed over as numpy arrays (``jax.device_get`` on the
caller's side), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": {name: array}}`` (or the inner dict) -> a state dict
    of CPU tensors with the same names: int8 codes stay int8, every
    other leaf becomes float32."""
    inner = params.get("params", params)
    out = {}
    for name, value in inner.items():
        if isinstance(value, Mapping):
            raise ValueError(
                f"nested parameter group {name!r}: the caption model has "
                "a flat parameter tree")
        out[name] = torch.from_numpy(np.array(value, dtype=_leaf_dtype(value),
                                              copy=True))
    return out


def _leaf_dtype(value) -> np.dtype:
    dt = getattr(value, "dtype", None)
    if dt is torch.int8 or (not isinstance(dt, torch.dtype) and dt is not None
                            and np.dtype(dt) == np.int8):
        return np.dtype(np.int8)
    return np.dtype(np.float32)


def state_dict_to_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse: a port state dict -> ``{"params": {name: ndarray}}``
    (int8 codes as int8, the rest float32), ready for
    ``jax.numpy.asarray`` on the JAX side."""
    return {"params": {
        name: t.detach().to("cpu", t.dtype if t.dtype == torch.int8
                            else torch.float32).numpy().copy()
        for name, t in state_dict.items()
    }}


def load_params(model: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a JAX parameter tree into ``model`` (strict: every name on
    both sides must match, shapes included)."""
    sd = params_to_state_dict(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(
            f"parameter names differ: missing {missing}, unexpected {extra}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(
                f"{k}: shape {tuple(v.shape)} != model {tuple(own[k].shape)}")
        if (v.dtype == torch.int8) != (own[k].dtype == torch.int8):
            raise ValueError(f"{k}: {v.dtype} leaf for a {own[k].dtype} "
                             "parameter (quantize the tree, or build the "
                             "model with the matching weight_quant)")
    model.load_state_dict(sd)
    return model
