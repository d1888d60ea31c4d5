"""The vocab-sized leaves of a caption model split over the ``model``
axis of one mesh row (the port's counterpart of the reference's
``word_embed`` / ``logit_w`` / ``logit_b`` under
``NamedSharding(mesh, P("model", ...))``).

Shard j on ``devices[j]`` holds rows [j·V/M, (j+1)·V/M) of
``word_embed`` (and of its int8w ``word_embed_scale``) and the same
columns of ``logit_w``, ``logit_b`` (and ``logit_w_scale``), per
``parallel/partition.py``.  :meth:`VocabShards.embed` is the masked
row-sharded lookup plus the fixed-order sum; :meth:`VocabShards.logits`
runs each shard's (H, V/M) product on its own device (``dot_f32`` under
autograd, the row-invariant ``row_gemm`` kernel without it, so each
logit column is bitwise the single-device column, r12) and returns
``VocabShardedLogits``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from cst_captioning_torch.ops.rnn import dot_f32
from cst_captioning_torch.ops.rowgemm import row_dot
from cst_captioning_torch.parallel.collectives import (
    VocabShardedLogits,
    embedding_rows,
)
from cst_captioning_torch.parallel.mesh import row_mesh
from cst_captioning_torch.parallel.partition import spec_for_leaf, tree_specs
from cst_captioning_torch.parallel.sharding import (
    Placed,
    gather_leaf,
    gather_tree,
    shard_leaf,
    shard_tree,
)


def is_vocab_leaf(name: str) -> bool:
    """Whether the rule table splits leaf ``name`` over ``model``."""
    return "model" in spec_for_leaf(name, strict=False)


class VocabShards:
    """See module doc.  ``leaves[name][j]`` is shard j's tensor (an
    ``nn.Parameter``) at position (0, j) of ``mesh``, the (1, M) row the
    shards stand on, split per ``specs`` (the rule table's);  ``lead``
    is the model's own device, where lookups and merges land.  Placing
    and gathering go through ``parallel/sharding.py``."""

    def __init__(self, leaves: Dict[str, List[torch.Tensor]], mesh,
                 specs: Dict[str, tuple], lead):
        self.leaves = leaves
        self.mesh = mesh
        self.specs = specs
        self.devices = list(mesh.model_row(0))
        self.lead = torch.device(lead)
        self.M = len(self.devices)
        self.V = sum(int(x.shape[0]) for x in leaves["word_embed"])
        self._tiles_key = None
        self._tiles = None

    @classmethod
    def split(cls, full: Dict[str, torch.Tensor], devices: Sequence, lead,
              requires_grad: bool = True) -> "VocabShards":
        """Shards of the full tensors ``full`` over ``devices`` by
        ``parallel/sharding.py::shard_tree`` (a copy per device position,
        so shards never alias); a leaf the rule table would leave
        replicated (its vocab does not divide M) raises."""
        mesh = row_mesh(devices)
        specs = tree_specs(full, mesh)
        for name, spec in specs.items():
            if spec == ():
                raise ValueError(f"{name}: vocab {tuple(full[name].shape)} "
                                 f"does not split over {len(devices)} "
                                 "model shards")
        leaves = {
            name: [nn.Parameter(x, requires_grad=(
                requires_grad and x.dtype != torch.int8))
                for x in p.shards[0]]
            for name, p in shard_tree(full, mesh).items()}
        return cls(leaves, mesh, specs, lead)

    def place(self, name: str, full: torch.Tensor) -> List[torch.Tensor]:
        """Shard j's part of a full tensor laid out like leaf ``name`` (a
        parameter or its Adam moment), each on its device."""
        return list(shard_leaf(full, self.specs[name], self.mesh).shards[0])

    @torch.no_grad()
    def load(self, name: str, full: torch.Tensor) -> None:
        """Copy a full tensor into leaf ``name``'s shards in place."""
        for dst, src in zip(self.leaves[name], self.place(name, full)):
            dst.copy_(src)

    def gather_parts(self, name: str, parts: Sequence[torch.Tensor],
                     device="cpu") -> torch.Tensor:
        """The full tensor of per-shard ``parts`` laid out like leaf
        ``name`` (``parallel/sharding.py::gather_leaf``)."""
        grid = np.empty((1, self.M), dtype=object)
        for j, x in enumerate(parts):
            grid[0, j] = x.detach()
        return gather_leaf(Placed(self.specs[name], grid), self.mesh, device)

    def requires_grad_(self, flag: bool) -> "VocabShards":
        for name, xs in self.leaves.items():
            for x in xs:
                if x.dtype != torch.int8:
                    x.requires_grad_(flag)
        return self

    def scales(self, name: str) -> Optional[List[torch.Tensor]]:
        return self.leaves.get(name + "_scale")

    def gather(self, device="cpu") -> Dict[str, torch.Tensor]:
        """Full tensors of every leaf on ``device``
        (``parallel/sharding.py::gather_tree``)."""
        placed = {}
        for name, xs in self.leaves.items():
            grid = np.empty((1, self.M), dtype=object)
            for j, x in enumerate(xs):
                grid[0, j] = x.detach()
            placed[name] = Placed(self.specs[name], grid)
        return gather_tree(placed, self.mesh, device)

    def versions(self) -> tuple:
        return tuple(x._version for xs in self.leaves.values() for x in xs)

    def tiles(self, cdt: torch.dtype) -> List[torch.Tensor]:
        """Each shard's ``logit_w`` tile in the compute dtype (int8 codes
        as they are), cached per parameter version; a float tile is a
        copy even where the leaf is already in ``cdt``, so it never
        aliases a leaf an optimizer step rewrites in place."""
        key = self.versions() + (cdt,)
        if self._tiles_key != key:
            self._tiles = [
                w.detach().contiguous() if w.dtype == torch.int8
                else w.detach().to(cdt, memory_format=torch.contiguous_format,
                                   copy=True)
                for w in self.leaves["logit_w"]]
            self._tiles_key = key
        return self._tiles

    def embed(self, ids: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
        """Embedding rows of ``ids`` (on ``lead``) in ``cdt``."""
        return embedding_rows(self.leaves["word_embed"], ids, cdt,
                              self.scales("word_embed"))

    def logits(self, h: torch.Tensor, cdt: torch.dtype
               ) -> VocabShardedLogits:
        """float32 logits of ``h`` (..., H) as vocab tiles: under
        autograd ``dot_f32`` on the parameters, otherwise ``row_dot`` on
        the cached compute-dtype tiles."""
        ws = self.scales("logit_w") or [None] * self.M
        grad = torch.is_grad_enabled()
        tiles = self.leaves["logit_w"] if grad else self.tiles(cdt)
        dot = dot_f32 if grad else row_dot
        out = []
        for w, b, s, d in zip(tiles, self.leaves["logit_b"], ws,
                              self.devices):
            out.append(dot(h.to(d), w, cdt, s) + b.float())
        return VocabShardedLogits(out, self.lead)
