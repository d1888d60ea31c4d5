"""Weight bridge between the JAX package's parameter tree and the port.

The JAX model keeps its weights as ``{"params": {name: array}}`` with
the names of ``CaptionModel.setup``; the port's :class:`~cst_captioning_
torch.models.captioner.CaptionModel` registers parameters under the same
names, so the bridge is a name-for-name copy — no transposes: both sides
store ``x @ W`` weights as (in, out), and ``lstm0_w`` stacks the rows
[emb | ctx | cat | hidden] x 4H (cat under ``use_category``, whose
``cat_embed`` crosses like any float leaf) with gates i|f|g|o on both
sides.

Float leaves cross in float32, whatever their dtype on either side
(``model.param_dtype``: float32, bfloat16 or float16): a bf16 / f16 leaf
(an ``ml_dtypes`` array on the JAX side, a torch tensor on the port's)
widens exactly to float32, and :func:`load_params` rounds it into the
model's own parameter dtype, which is exact for a value that was in that
dtype.  So a bf16 tree crosses bitwise both ways, and a float32 tree
loaded into a bf16 model rounds once to nearest even, as an orbax
restore of a float32 checkpoint into a bf16 template does.  numpy has
no bfloat16, and the port needs no ``ml_dtypes``.
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
    """``{"params": {name: array}}`` (or the inner dict) of numpy arrays
    or torch tensors -> a state dict of CPU tensors with the same
    names: int8 codes stay int8, every other leaf becomes its exact
    float32 widening (a float64 leaf rounds to float32)."""
    inner = params.get("params", params)
    out = {}
    for name, value in inner.items():
        if isinstance(value, Mapping):
            raise ValueError(
                f"nested parameter group {name!r}: the caption model has "
                "a flat parameter tree")
        out[name] = _leaf_tensor(value)
    return out


def _leaf_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        t = value.detach().to("cpu")
        return (t.clone() if t.dtype == torch.int8
                else t.to(torch.float32, copy=True))
    a = np.asarray(value)
    return torch.from_numpy(np.array(
        a, dtype=np.int8 if a.dtype == np.int8 else np.float32, copy=True))


def state_dict_to_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse: a port state dict -> ``{"params": {name: ndarray}}``
    (int8 codes as int8, every float leaf its exact float32 widening,
    which the JAX side casts to its tree's dtype), ready for
    ``jax.numpy.asarray``."""
    return {"params": {
        name: t.detach().to("cpu", t.dtype if t.dtype == torch.int8
                            else torch.float32).numpy().copy()
        for name, t in state_dict.items()
    }}


def load_params(model: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a JAX parameter tree (or a port state dict) into ``model``
    (strict: every name on both sides must match, shapes included); each
    float leaf rounds from its float32 widening into the parameter's own
    dtype (``model.param_dtype``; the int8w scales float32)."""
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
