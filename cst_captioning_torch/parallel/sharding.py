"""Placement of state dicts on a mesh by the rule table (port of the JAX
package's ``parallel/sharding.py`` and the placement half of
``partition.py``).

:func:`shard_tree` places every leaf of a flat ``{name: tensor}`` dict:
a :class:`Placed` leaf holds its spec and an object ndarray of the mesh's
shape whose entry at each position is that position's local tensor (a
row block of ``word_embed``, a column block of ``logit_w``, a full copy
of a replicated leaf).  Every position gets its own copy, so in-place
updates never alias across shards, even where one device stands at
several positions.  :func:`gather_tree` reassembles full tensors from the
positions at index 0 of every other axis: a reshard is a layout change,
never arithmetic, so gather(shard(x)) is x bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from cst_captioning_torch.parallel.partition import Spec, tree_specs


class Placed(NamedTuple):
    spec: Spec
    shards: np.ndarray   # object ndarray, mesh shape, of local tensors


def _slices(t: torch.Tensor, spec: Spec, mesh, pos) -> torch.Tensor:
    out = t
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape.get(axis, 1) == 1:
            continue
        n = mesh.shape[axis]
        i = pos[mesh.axis_names.index(axis)]
        size = t.shape[dim] // n
        out = out.narrow(dim, i * size, size)
    return out


def shard_leaf(t: torch.Tensor, spec: Spec, mesh) -> Placed:
    grid = np.empty(mesh.devices.shape, dtype=object)
    for pos in mesh.positions():
        grid[pos] = _slices(t.detach(), spec, mesh, pos).to(
            mesh.devices[pos], copy=True).contiguous()
    return Placed(tuple(spec), grid)


def shard_tree(tree: Mapping[str, torch.Tensor], mesh, rules=None
               ) -> Dict[str, Placed]:
    """Every leaf of ``tree`` on ``mesh`` per the rules (with the
    divisibility fallback of ``partition.tree_specs``)."""
    specs = tree_specs(tree, mesh, rules=rules)
    return {k: shard_leaf(v, specs[k], mesh) for k, v in tree.items()}


def gather_leaf(p: Placed, mesh, device="cpu") -> torch.Tensor:
    """The full tensor of a placed leaf on ``device``: its shards along
    each split axis (index 0 on the others) concatenated in order."""
    def rec(pos: List[int], dim_axes: Sequence):
        if not dim_axes:
            return p.shards[tuple(pos)].to(device)
        dim, axis = dim_axes[0]
        ax = mesh.axis_names.index(axis)
        parts = []
        for i in range(mesh.shape[axis]):
            pos2 = list(pos)
            pos2[ax] = i
            parts.append(rec(pos2, dim_axes[1:]))
        return torch.cat(parts, dim=dim)

    split = [(d, a) for d, a in enumerate(p.spec)
             if a is not None and mesh.shape.get(a, 1) > 1]
    return rec([0] * mesh.devices.ndim, split)


def gather_tree(tree: Mapping[str, Placed], mesh, device="cpu"
                ) -> Dict[str, torch.Tensor]:
    return {k: gather_leaf(v, mesh, device) for k, v in tree.items()}
