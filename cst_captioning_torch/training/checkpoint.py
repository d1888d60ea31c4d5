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

A directory written by the JAX package (orbax items ``params/`` and
``opt/``) is refused: its loader is not ported (ROADMAP.md Queue 1,
item 5).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from cst_captioning_torch.models.captioner import not_ported

PARAMS_FILE = "params.pt"
OPT_FILE = "opt.pt"
INFOS_FILE = "infos.json"


def _refuse_orbax(path: str) -> None:
    if os.path.isdir(os.path.join(path, "params")):
        raise not_ported(f"the orbax checkpoint at {path}",
                         "Queue 1, item 5 (orbax checkpoint loader)")


def save_checkpoint(path: str, model: torch.nn.Module, optimizer,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write params, optimizer state and the json sidecar under
    ``path``; each file is written to a temporary name and renamed, so a
    crash never leaves a torn file."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    opt = optimizer.state_dict()
    opt = {"count": opt["count"],
           "mu": {k: v.detach().cpu() for k, v in opt["mu"].items()},
           "nu": {k: v.detach().cpu() for k, v in opt["nu"].items()}}
    for name, obj in ((PARAMS_FILE, params), (OPT_FILE, opt)):
        tmp = os.path.join(path, name + ".tmp")
        torch.save(obj, tmp)
        os.replace(tmp, os.path.join(path, name))
    tmp = os.path.join(path, INFOS_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(dict(extra or {}), f, indent=2, default=str)
    os.replace(tmp, os.path.join(path, INFOS_FILE))


def load_infos(path: str) -> Dict[str, Any]:
    p = os.path.join(os.path.abspath(path), INFOS_FILE)
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def restore_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Warm start (reference ``--start_from``): parameters only, copied
    in place into ``model`` (strict names and shapes)."""
    path = os.path.abspath(path)
    _refuse_orbax(path)
    sd = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                    weights_only=True)
    model.load_state_dict(sd)
    return model


def restore_checkpoint(path: str, model: torch.nn.Module, optimizer) -> int:
    """Full resume: params and optimizer state into ``model`` and
    ``optimizer``.  Returns the restored update count."""
    path = os.path.abspath(path)
    restore_params(path, model)
    opt = torch.load(os.path.join(path, OPT_FILE), map_location="cpu",
                     weights_only=True)
    optimizer.load_state_dict(opt)
    return optimizer.count
