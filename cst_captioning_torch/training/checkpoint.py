"""Checkpoints of the port, with keep-best and warm-start semantics (the
port-native counterpart of the JAX package's ``training/checkpoint.py``).

Layout of one checkpoint directory (``<workdir>/best``, ``<workdir>/
last``), as in the reference: ``params.pt`` (the model's state dict)
and ``opt.pt`` (optimizer state and update count) are separate files,
so a warm start (params only — each stage restarts its optimizer and LR
schedule) never needs the previous stage's optimizer, and
``infos.json`` is the human-readable sidecar (epoch, val metrics,
resume counters).  Tensors go through ``torch.save`` and load with
``weights_only=True``.

A directory with ``params.pt`` and no ``opt.pt`` is a params-only
checkpoint (:func:`save_params`; what ``tools/import_jax_checkpoint``
writes): :func:`restore_params` (warm start, serving, eval) loads it,
:func:`restore_checkpoint` (resume) refuses it.  Loading is strict:
names, shapes and int8-ness must match the model
(``models/weights.py::load_params``).

A directory written by the JAX package (orbax items ``params/`` and
``opt/``) is refused with the two commands that convert it
(:data:`CONVERT_HINT`): ``scripts/export_jax_checkpoint.py`` where
``jax`` and ``orbax.checkpoint`` are installed, then
``python -m cst_captioning_torch.tools.import_jax_checkpoint``.  The
optimizer state is not converted: a JAX run is warm-started, not
resumed.

A mesh run (``training/sharded.py::MeshModel``) saves in the same
full-tensor format: the vocab shards and their Adam moments are gathered
first, and the sidecar records the mesh (``mesh_shape``, ``mesh_axes``)
and every leaf's spec (:func:`saved_sharding`).  Loading reshards onto
whatever mesh the loading run has, bit for bit: a reshard moves bytes,
never does arithmetic.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from cst_captioning_torch.models.weights import load_params

PARAMS_FILE = "params.pt"
OPT_FILE = "opt.pt"
INFOS_FILE = "infos.json"

CONVERT_HINT = (
    "convert it in two steps: `python scripts/export_jax_checkpoint.py "
    "--checkpoint {path} --out EXPORT_DIR --preset PRESET [overrides]` "
    "where jax and orbax.checkpoint are installed, then `python -m "
    "cst_captioning_torch.tools.import_jax_checkpoint --export EXPORT_DIR "
    "--out PORT_DIR --preset PRESET [overrides]`, and pass PORT_DIR")


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(os.path.join(path, "params")):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint of the JAX package, which the "
            "port does not read; " + CONVERT_HINT.format(path=path))


def _write(path: str, name: str, obj) -> None:
    tmp = os.path.join(path, name + ".tmp")
    if name.endswith(".json"):
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=2, default=str)
    else:
        torch.save(obj, tmp)
    os.replace(tmp, os.path.join(path, name))


def _params_of(model) -> Dict[str, torch.Tensor]:
    if hasattr(model, "gathered_state_dict"):
        return model.gathered_state_dict()
    if hasattr(model, "full_state_dict"):
        return {k: v.detach().cpu() for k, v in
                model.full_state_dict().items()}
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_checkpoint(path: str, model: torch.nn.Module, optimizer,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write params, optimizer state and the json sidecar under
    ``path``; each file is written to a temporary name and renamed, so a
    crash never leaves a torn file."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    opt = optimizer.state_dict()
    opt = {"count": opt["count"],
           "mu": {k: v.detach().cpu() for k, v in opt["mu"].items()},
           "nu": {k: v.detach().cpu() for k, v in opt["nu"].items()}}
    _write(path, PARAMS_FILE, _params_of(model))
    _write(path, OPT_FILE, opt)
    infos = dict(extra or {})
    if hasattr(model, "sharding_meta"):
        infos["sharding"] = model.sharding_meta()
    _write(path, INFOS_FILE, infos)


def save_params(path: str, model, extra: Optional[Dict[str, Any]] = None
                ) -> None:
    """Write a params-only checkpoint under ``path``: ``params.pt``
    (``model``'s state dict, or a state dict) and ``infos.json``; an
    ``opt.pt`` left there by an earlier save is removed, so the
    directory never pairs these params with another run's optimizer."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _write(path, PARAMS_FILE, _params_of(model))
    if os.path.exists(os.path.join(path, OPT_FILE)):
        os.remove(os.path.join(path, OPT_FILE))
    _write(path, INFOS_FILE, dict(extra or {}))


def load_params_file(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in ``<path>/params.pt`` (CPU tensors); an orbax
    directory is refused with the conversion commands."""
    path = os.path.abspath(path)
    _refuse_orbax(path)
    f = os.path.join(path, PARAMS_FILE)
    if not os.path.exists(f):
        raise FileNotFoundError(f"no {PARAMS_FILE} in {path}: not a "
                                "checkpoint of the port")
    return torch.load(f, map_location="cpu", weights_only=True)


def load_infos(path: str) -> Dict[str, Any]:
    p = os.path.join(os.path.abspath(path), INFOS_FILE)
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def restore_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Warm start (reference ``--start_from``): parameters only, copied
    in place into ``model`` (strict names, shapes and int8-ness), or
    resharded onto a ``MeshModel``'s replicas.  Takes full and
    params-only checkpoints."""
    if hasattr(model, "load_full_state_dict"):
        model.load_full_state_dict(load_params_file(path))
        return model
    return load_params(model, load_params_file(path))


def saved_sharding(path: str) -> Dict[str, Any]:
    """The mesh record of a checkpoint's sidecar (``mesh_shape``,
    ``mesh_axes``, ``specs``); a one-device save records ``1x1``."""
    return load_infos(path).get("sharding", {
        "mesh_shape": "1x1", "mesh_axes": ["data", "model"], "specs": {}})


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer) -> int:
    """Full resume: params and optimizer state into ``model`` and
    ``optimizer``.  Returns the restored update count.  A params-only
    checkpoint raises ``ValueError``: it holds no optimizer state."""
    path = os.path.abspath(path)
    _refuse_orbax(path)
    if not os.path.exists(os.path.join(path, OPT_FILE)):
        raise ValueError(
            f"{path} holds no optimizer state (a params-only checkpoint, "
            "e.g. an imported JAX model): it cannot be resumed; warm-start "
            "from it with train.start_from")
    restore_params(path, model)
    opt = torch.load(os.path.join(path, OPT_FILE), map_location="cpu",
                     weights_only=True)
    optimizer.load_state_dict(opt)
    return optimizer.count
