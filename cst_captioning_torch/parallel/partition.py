"""Regex partition rules over the parameters and the optimizer moments
(port of the JAX package's ``parallel/partition.py``; the port's own
copy of ``PARTITION_RULES`` and ``KNOWN_PARAM_LEAVES``, held equal to
the reference's by ``tests/test_torch_mesh.py``).

A spec is a tuple with one entry per tensor dimension, each a mesh axis
name or None; ``()`` is full replication.  Vocab-sized tensors shard
over ``model`` (rows of the embedding, columns of the logit head and
their int8w scales); everything else is small and replicated.  Adam's
moments mirror the parameters leaf for leaf, so the same regexes match
their paths (``mu/word_embed``); scalar leaves are never partitioned.
Every known leaf matches exactly one rule (:func:`spec_for_leaf` raises
otherwise), and a leaf whose sharded dimension does not divide its mesh
axis stays replicated (:func:`tree_specs`).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

PARTITION_RULES = (
    (r"word_embed$", ("model", None)),       # (V, E): vocab rows
    (r"logit_w$", (None, "model")),          # (H, V): vocab columns
    (r"logit_b$", ("model",)),               # (V,)
    (r"lstm\d+_[wb]$", ()),                  # recurrence: replicated
    (r"proj_[A-Za-z0-9]+_[wb]$", ()),        # feature projections
    (r"att_(b|v|wf|wh)$", ()),               # Bahdanau attention MLP
    (r"cat_embed$", ()),                     # category embedding
    # int8w scales shard on the axis of the channel they scale.
    (r"word_embed_scale$", ("model",)),      # (V,): rows of word_embed
    (r"logit_w_scale$", ("model",)),         # (V,): columns of logit_w
    (r"lstm\d+_w_scale$", ()),               # (4H,): replicated kernels
    (r"att_w[fh]_scale$", ()),               # (A,): replicated att MLP
    # The speculative draft tree: small, replicated on every shard.
    (r"draft_(embed|cell_[wb]|head_[wb])$", ()),
)

KNOWN_PARAM_LEAVES = (
    "word_embed",
    "logit_w",
    "logit_b",
    "lstm0_w",
    "lstm0_b",
    "lstm1_w",
    "lstm1_b",
    "proj_resnet_w",
    "proj_resnet_b",
    "proj_c3d_w",
    "proj_c3d_b",
    "att_b",
    "att_v",
    "att_wf",
    "att_wh",
    "cat_embed",
    "word_embed_scale",
    "logit_w_scale",
    "lstm0_w_scale",
    "lstm1_w_scale",
    "att_wf_scale",
    "att_wh_scale",
    "draft_embed",
    "draft_cell_w",
    "draft_cell_b",
    "draft_head_w",
    "draft_head_b",
)

Spec = Tuple[Optional[str], ...]


def compiled_rules(rules: Sequence[Tuple[str, tuple]] = PARTITION_RULES):
    """[(compiled regex, spec tuple)] from the literal table."""
    return [(re.compile(pat), tuple(spec)) for pat, spec in rules]


def _is_scalar(leaf) -> bool:
    shape = getattr(leaf, "shape", None)
    if shape is None or len(shape) == 0:
        return True
    n = 1
    for s in shape:
        n *= int(s)
    return n == 1


def spec_for_leaf(name: str, leaf=None, rules=None,
                  strict: bool = True) -> Spec:
    """Spec of one leaf path.  Scalars are never partitioned.  With
    ``strict`` a leaf matching zero or several rules raises."""
    if leaf is not None and _is_scalar(leaf):
        return ()
    rules = rules if rules is not None else compiled_rules()
    hits = [(pat.pattern, spec) for pat, spec in rules if pat.search(name)]
    if len(hits) == 1:
        return hits[0][1]
    if not strict:
        return hits[0][1] if hits else ()
    if not hits:
        raise ValueError(
            f"no partition rule matches param leaf {name!r} — add a rule "
            "to parallel/partition.py::PARTITION_RULES (and its name to "
            "KNOWN_PARAM_LEAVES)")
    raise ValueError(
        f"param leaf {name!r} matches {len(hits)} partition rules "
        f"({[h[0] for h in hits]}) — rules must partition the leaves "
        "exactly once")


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def match_partition_rules(rules, tree, strict: bool = True) -> Dict[str, Spec]:
    """``{path: spec}`` for every leaf of ``tree`` (a state dict, an
    optimizer state dict ``{"count", "mu": {...}, "nu": {...}}``, or a
    nest of them); paths join keys with ``/``.  Non-tensor leaves (the
    update count) and scalars map to ``()``."""
    if rules and isinstance(rules[0][0], str):
        rules = compiled_rules(rules)
    out = {}
    for path, leaf in _flatten(tree).items():
        if not isinstance(leaf, torch.Tensor):
            out[path] = ()
            continue
        out[path] = spec_for_leaf(path, leaf, rules, strict=strict)
    return out


def divisible(shape: Sequence[int], spec: Spec, mesh_shape: Mapping[str, int]
              ) -> bool:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim >= len(shape) or int(shape[dim]) % mesh_shape.get(axis, 1):
            return False
    return True


def tree_specs(tree, mesh, rules=None, strict: bool = True) -> Dict[str, Spec]:
    """The placement spec of every leaf on ``mesh``: the rule's spec, or
    ``()`` where the sharded dimension does not divide its axis (or the
    axis is 1 or absent: nothing to split)."""
    rules = compiled_rules(rules if rules is not None else PARTITION_RULES)
    specs = match_partition_rules(rules, tree, strict=strict)
    leaves = _flatten(tree)
    out = {}
    for path, spec in specs.items():
        leaf = leaves[path]
        shape = tuple(getattr(leaf, "shape", ()))
        if (not spec or not divisible(shape, spec, mesh.shape)
                or all(a is None or mesh.shape.get(a, 1) == 1 for a in spec)):
            spec = ()
        out[path] = spec
    return out


def mesh_shape_str(mesh) -> str:
    """``"2x4"``-style string, axes in declared order; ``"1x1"`` off-mesh."""
    if mesh is None:
        return "1x1"
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
