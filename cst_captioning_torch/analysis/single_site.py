"""CST-DEC: single-definition-site rules for the decode recurrence.

The per-step decode recurrence exists once — ``decoding/core.py``'s
``decode_step`` — and admission never re-grows the K-times replicated
decode cache the deduplicated slot layout removed.  The kernels' plain
versions keep in-kernel recurrences by necessity (they are held against
the kernels and the reference bit for bit); the allowlists name them.

* CST-DEC-001 — a ``topk`` call (``torch.topk``, ``x.topk(...)``, an
  aliased import) outside :data:`TOP_K_ALLOWED`.
* CST-DEC-002 — the finish update ``(tok == EOS_ID) | (tok == PAD_ID)``
  outside :data:`FINISH_ALLOWED`.
* CST-DEC-003 — the PAD->EOS feed ``torch.where(x == PAD_ID, EOS_ID,
  ...)`` outside :data:`FEED_ALLOWED`.
* CST-DEC-004 — replication: ``repeat_interleave`` (function or
  method), ``x.expand(...).reshape(...)`` / ``.flatten()``, and
  ``np.repeat`` outside :data:`REPEAT_ALLOWED` (replicating cached
  decode state at admission is the K-times memory regression).
"""

from __future__ import annotations

import ast
from typing import List

from cst_captioning_torch.analysis.astutil import (
    ModuleInfo,
    dotted,
    resolved_call,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

# Files allowed to hold each pattern.  Removing an entry that still
# holds it makes the pass fail at the exact file:line.
TOP_K_ALLOWED = frozenset({
    "decoding/core.py",
    # The decode kernels' plain versions: the vocab-tile top-K the beam
    # kernel runs in shared memory, spelled once for the plain beam,
    # its int8w twin and the sharded port.
    "ops/decode_common.py",
})
# The kernels' plain versions (beam, sampler, their sharded port) run
# the recurrence in-kernel, as the reference's Pallas bodies do.
FINISH_ALLOWED = frozenset({
    "decoding/core.py",
    "ops/beam.py",
    "ops/sampler.py",
    "ops/shard_decode.py",
})
# training/cst.py: the PG update's input shift, not a decode loop.
FEED_ALLOWED = FINISH_ALLOWED | {"training/cst.py"}
# Replication that is not the decode cache's: the offline beam's
# initial state fan-out (decoding/beam.py); the model's seq_per_img
# rollout fan-out and its per-video attention tensors repeated to rows
# under the replicated layout (models/captioner.py); the kernels' plain
# versions staging per-video or per-beam operands (ops/attention.py,
# ops/attlstm.py, ops/beam.py, ops/shard_decode.py); CST's host reward
# broadcast (training/cst.py, numpy); the slot loop's flag-gated
# replicated layout, serving.dedup_cache=false (serving/slots.py).
REPEAT_ALLOWED = frozenset({
    "decoding/beam.py",
    "models/captioner.py",
    "ops/attention.py",
    "ops/attlstm.py",
    "ops/beam.py",
    "ops/shard_decode.py",
    "serving/slots.py",
    "training/cst.py",
})

_EOS_NAMES = frozenset({"EOS_ID"})
_PAD_NAMES = frozenset({"PAD_ID"})


def _cmp_against(node: ast.AST, names: frozenset) -> bool:
    """True for ``X == NAME`` / ``NAME == X`` Compare nodes."""
    if not (isinstance(node, ast.Compare) and len(node.ops) == 1):
        return False
    if not isinstance(node.ops[0], ast.Eq):
        return False
    sides = [node.left, node.comparators[0]]
    return any(isinstance(s, ast.Name) and s.id in names for s in sides)


def _is_or(node: ast.AST) -> bool:
    return (isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr)) \
        or (isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or))


def _finish_update(node: ast.AST) -> bool:
    """``(x == EOS_ID) | (y == PAD_ID)`` in either order, possibly nested
    in a wider ``|`` chain, or the ``or`` spelling."""
    if not _is_or(node):
        return False
    terms: List[ast.AST] = []

    def flatten(n: ast.AST) -> None:
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.BitOr):
            flatten(n.left)
            flatten(n.right)
        elif isinstance(n, ast.BoolOp) and isinstance(n.op, ast.Or):
            for v in n.values:
                flatten(v)
        else:
            terms.append(n)

    flatten(node)
    return (any(_cmp_against(t, _EOS_NAMES) for t in terms)
            and any(_cmp_against(t, _PAD_NAMES) for t in terms))


def _pad_eos_feed(node: ast.Call) -> bool:
    """``where(x == PAD_ID, EOS_ID, ...)`` (torch.where, np.where, a
    bare or method ``where``)."""
    if dotted(node.func).split(".")[-1] != "where" or len(node.args) < 2:
        return False
    cond, then = node.args[0], node.args[1]
    return (_cmp_against(cond, _PAD_NAMES)
            and isinstance(then, ast.Name) and then.id in _EOS_NAMES)


def _is_top_k(mi: ModuleInfo, node: ast.Call) -> bool:
    if isinstance(node.func, ast.Attribute) and node.func.attr == "topk":
        return True
    return resolved_call(mi, node).split(".")[-1] == "topk"


def _is_repeat(mi: ModuleInfo, node: ast.Call) -> bool:
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr == "repeat_interleave":
            return True
        if f.attr in ("reshape", "flatten", "view") and isinstance(
            f.value, ast.Call
        ) and isinstance(f.value.func, ast.Attribute) and (
            f.value.func.attr == "expand"
        ):
            return True
    name = resolved_call(mi, node)
    return name in ("torch.repeat_interleave", "numpy.repeat", "np.repeat")


@register_checker("single_site")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    out: List[Finding] = []
    for mi in modules:
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call):
                if _is_top_k(mi, node) and mi.rel not in TOP_K_ALLOWED:
                    out.append(Finding(
                        "CST-DEC-001", mi.rel, node.lineno,
                        mi.qualname_of(node),
                        "beam-selection recurrence (topk) outside "
                        "decoding/core.py — call decoding.core."
                        "decode_step / select_top instead (a kernel's "
                        "plain version: extend TOP_K_ALLOWED "
                        "consciously)",
                    ))
                if _pad_eos_feed(node) and mi.rel not in FEED_ALLOWED:
                    out.append(Finding(
                        "CST-DEC-003", mi.rel, node.lineno,
                        mi.qualname_of(node),
                        "PAD->EOS feed of finished rows re-implemented "
                        "outside decoding/core.py",
                    ))
                if _is_repeat(mi, node) and mi.rel not in REPEAT_ALLOWED:
                    out.append(Finding(
                        "CST-DEC-004", mi.rel, node.lineno,
                        mi.qualname_of(node),
                        "repeat_interleave-style replication outside the "
                        "allowlist — replicating cached decode state at "
                        "admission is the K-times memory regression the "
                        "deduplicated slot layout removed; read the "
                        "shared row through row // K instead",
                    ))
            elif (
                _finish_update(node)
                and mi.rel not in FINISH_ALLOWED
                # only the outermost node of an | chain fires
                and not _is_or(mi.parent.get(node))
            ):
                out.append(Finding(
                    "CST-DEC-002", mi.rel, node.lineno,
                    mi.qualname_of(node),
                    "EOS/PAD finish update re-implemented outside "
                    "decoding/core.py",
                ))
    return out
