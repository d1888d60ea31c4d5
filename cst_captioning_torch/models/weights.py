"""Weight bridge between the JAX package's parameter tree and the port.

The JAX model keeps its weights as ``{"params": {name: array}}`` with
the names of ``CaptionModel.setup``; the port's :class:`~cst_captioning_
torch.models.captioner.CaptionModel` registers parameters under the same
names, so the bridge is a name-for-name copy in float32 — no transposes:
both sides store ``x @ W`` weights as (in, out), and ``lstm0_w`` stacks
the rows [emb | ctx | hidden] x 4H with gates i|f|g|o on both sides.

The JAX side is handed over as numpy arrays (``jax.device_get`` on the
caller's side), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": {name: array}}`` (or the inner dict) -> a state dict
    of float32 CPU tensors with the same names."""
    inner = params.get("params", params)
    out = {}
    for name, value in inner.items():
        if isinstance(value, Mapping):
            raise ValueError(
                f"nested parameter group {name!r}: the caption model has "
                "a flat parameter tree")
        out[name] = torch.from_numpy(
            np.array(value, dtype=np.float32, copy=True))
    return out


def state_dict_to_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse: a port state dict -> ``{"params": {name: ndarray}}``
    in float32, ready for ``jax.numpy.asarray`` on the JAX side."""
    return {"params": {
        name: t.detach().to("cpu", torch.float32).numpy().copy()
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
    model.load_state_dict(sd)
    return model
