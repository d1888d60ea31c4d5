"""CST-SHD: partition-rule, placement and collective discipline.

Every placement decision of the port's (data x model) mesh hangs off
one literal table — ``parallel/partition.py``'s ``PARTITION_RULES`` —
and its explicit, fixed-order collectives (``parallel/collectives.py``,
``parallel/ring.py``, ``parallel/distributed.py``).  Both rot silently:
a new parameter falls through to an accidental default, a collective or
a placement appears with no recorded story, a renamed tensor leaves a
rule matching nothing.

* **CST-SHD-001** — every leaf in ``KNOWN_PARAM_LEAVES`` matches exactly
  one rule regex (none: no placement decision; two: an ambiguous
  table).
* **CST-SHD-002** — every placement pin outside ``parallel/`` (a call to
  ``shard_tree`` / ``shard_leaf`` / ``gather_tree``) is registered in
  ``jit_registry.py::SHARDING_CONSTRAINT_REGISTRY`` with what the pin
  buys; stale entries fire too.
* **CST-SHD-003** — a rule whose regex matches no known leaf is stale.
* **CST-SHD-004** — every call into ``parallel/collectives.py`` or
  ``parallel/ring.py`` from outside ``parallel/``, and every
  ``torch.distributed`` collective anywhere, is registered in
  ``SHARD_MAP_REGISTRY`` with the collective layout it buys (which
  gather it avoids, in what fixed order it sums); stale entries fire.
* **CST-SHD-005** — the decode-kernel gate is table-driven:
  ``DECODE_KERNEL_CAPS`` (``decoding/core.py``) is a literal dict
  covering exactly the ``use_pallas_*`` fields ``ModelConfig`` declares,
  and a gate function (``_decode_kernel_gate``, the port's
  ``_mesh_gates``) consults ``kernel_supports``.

Table-driven off the AST, so it applies to any scanned module defining
the names (the corpus seeds violations in toy tables).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from cst_captioning_torch.analysis import jit_registry
from cst_captioning_torch.analysis.astutil import (
    ModuleInfo,
    call_name,
    resolved_call,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

RULES_NAME = "PARTITION_RULES"
LEAVES_NAME = "KNOWN_PARAM_LEAVES"

def _module_assign(mi: ModuleInfo, name: str) -> Optional[ast.Assign]:
    for node in mi.tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    return node
    return None


def _rule_table(
    node: ast.Assign,
) -> Optional[List[Tuple[str, int]]]:
    """[(regex string, lineno)] from a literal PARTITION_RULES tuple —
    None when the assignment isn't the expected literal shape."""
    val = node.value
    if not isinstance(val, (ast.Tuple, ast.List)):
        return None
    out: List[Tuple[str, int]] = []
    for elt in val.elts:
        if not (
            isinstance(elt, (ast.Tuple, ast.List))
            and elt.elts
            and isinstance(elt.elts[0], ast.Constant)
            and isinstance(elt.elts[0].value, str)
        ):
            return None
        out.append((elt.elts[0].value, elt.elts[0].lineno))
    return out


def _leaf_list(node: ast.Assign) -> Optional[List[str]]:
    try:
        val = ast.literal_eval(node.value)
    except (ValueError, SyntaxError):
        return None
    if isinstance(val, (tuple, list)) and all(
        isinstance(x, str) for x in val
    ):
        return list(val)
    return None


def _check_rule_tables(mi: ModuleInfo) -> List[Finding]:
    rules_node = _module_assign(mi, RULES_NAME)
    leaves_node = _module_assign(mi, LEAVES_NAME)
    if rules_node is None or leaves_node is None:
        return []
    rules = _rule_table(rules_node)
    leaves = _leaf_list(leaves_node)
    out: List[Finding] = []
    if rules is None or leaves is None:
        out.append(Finding(
            "CST-SHD-001", mi.rel,
            (rules_node if rules is None else leaves_node).lineno,
            "<module>",
            f"{RULES_NAME}/{LEAVES_NAME} must be literal tuples the "
            "pass can read off the AST",
        ))
        return out
    compiled: List[Tuple[str, int, re.Pattern]] = []
    for pat, lineno in rules:
        try:
            compiled.append((pat, lineno, re.compile(pat)))
        except re.error as e:
            out.append(Finding(
                "CST-SHD-001", mi.rel, lineno, RULES_NAME,
                f"rule regex {pat!r} does not compile: {e}",
            ))
    for leaf in leaves:
        hits = [pat for pat, _, rx in compiled if rx.search(leaf)]
        if len(hits) == 1:
            continue
        what = (
            "matches NO partition rule — a new tensor has no placement "
            "decision; add a rule"
            if not hits
            else f"matches {len(hits)} rules {hits} — the table is "
            "ambiguous; rules must partition the leaves exactly once"
        )
        out.append(Finding(
            "CST-SHD-001", mi.rel, leaves_node.lineno, LEAVES_NAME,
            f"param leaf {leaf!r} {what}",
        ))
    for pat, lineno, rx in compiled:
        if not any(rx.search(leaf) for leaf in leaves):
            out.append(Finding(
                "CST-SHD-003", mi.rel, lineno, RULES_NAME,
                f"partition rule {pat!r} matches no known param leaf — "
                "the tensor it governed was renamed or removed; update "
                "or delete the rule",
            ))
    return out


PARALLEL = "cst_captioning_torch.parallel"
PIN_FNS = frozenset({"shard_tree", "shard_leaf", "gather_tree"})
COLLECTIVE_MODULES = (f"{PARALLEL}.collectives.", f"{PARALLEL}.ring.")
DIST_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "broadcast_object_list", "all_to_all",
    "all_to_all_single", "reduce", "gather", "scatter", "send", "recv",
    "isend", "irecv", "barrier",
})


def _outside_parallel(mi: ModuleInfo) -> bool:
    return not mi.rel.startswith("parallel/")


def is_pin_call(mi: ModuleInfo, node: ast.Call) -> bool:
    name = resolved_call(mi, node)
    return (
        _outside_parallel(mi) and name.startswith(PARALLEL + ".")
        and name.rsplit(".", 1)[-1] in PIN_FNS
    )


def is_collective_call(mi: ModuleInfo, node: ast.Call) -> bool:
    name = resolved_call(mi, node)
    if name.startswith("torch.distributed."):
        return name.rsplit(".", 1)[-1] in DIST_COLLECTIVES
    return _outside_parallel(mi) and name.startswith(COLLECTIVE_MODULES)


def _registered_sites(mi, seen, registry, pred, rule, what, story):
    out: List[Finding] = []
    flagged = set()
    for node in ast.walk(mi.tree):
        if not (isinstance(node, ast.Call) and pred(mi, node)):
            continue
        sym = mi.qualname_of(node)
        key = f"{mi.rel}::{sym}"
        seen[key] = (mi.rel, node.lineno, sym)
        if key in registry or key in flagged:
            continue
        flagged.add(key)
        out.append(Finding(
            rule, mi.rel, node.lineno, sym,
            f"{what} site `{key}` ({call_name(node)}) is not registered "
            f"— add it to analysis/jit_registry.py with {story}",
        ))
    return out


# ----------------------------------------- kernel-gate capability table

CAPS_NAME = "DECODE_KERNEL_CAPS"
_CAPS_AXES = ("model", "data")
# The reference's gate function, and the port's (models/captioner.py).
_GATE_FNS = ("_decode_kernel_gate", "_mesh_gates")
_CAPS_LOOKUP = "kernel_supports"


def _caps_table(node: ast.Assign, mi: ModuleInfo) -> Optional[dict]:
    try:
        val = ast.literal_eval(node.value)
    except (ValueError, SyntaxError):
        return None
    if not isinstance(val, dict):
        return None
    for flag, caps in val.items():
        if not (
            isinstance(flag, str)
            and isinstance(caps, dict)
            and set(caps) == set(_CAPS_AXES)
            and all(isinstance(v, bool) for v in caps.values())
        ):
            return None
    return val


def _model_config_flags(mi: ModuleInfo) -> Optional[List[str]]:
    """``use_pallas_*`` field names of a ``class ModelConfig`` in this
    module, or None when the module declares no such class."""
    for node in ast.walk(mi.tree):
        if isinstance(node, ast.ClassDef) and node.name == "ModelConfig":
            flags = []
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    if stmt.target.id.startswith("use_pallas_"):
                        flags.append(stmt.target.id)
            return flags
    return None


def _gate_functions(mi: ModuleInfo) -> List[ast.FunctionDef]:
    return [
        node for node in ast.walk(mi.tree)
        if isinstance(node, ast.FunctionDef) and node.name in _GATE_FNS
    ]


def _check_kernel_caps(modules: List[ModuleInfo]) -> List[Finding]:
    """CST-SHD-005: cross-module capability-table discipline (see the
    module doc).  Only judged when a scanned module defines the table —
    a corpus scan seeds its own toy table + ModelConfig + gate."""
    tables: List[Tuple[ModuleInfo, ast.Assign, Optional[dict]]] = []
    flags: Optional[List[str]] = None
    gates: List[Tuple[ModuleInfo, ast.FunctionDef]] = []
    for mi in modules:
        node = _module_assign(mi, CAPS_NAME)
        if node is not None:
            tables.append((mi, node, _caps_table(node, mi)))
        f = _model_config_flags(mi)
        if f is not None:
            flags = (flags or []) + f
        for g in _gate_functions(mi):
            gates.append((mi, g))
    if not tables:
        return []
    out: List[Finding] = []
    caps: dict = {}
    for mi, node, parsed in tables:
        if parsed is None:
            out.append(Finding(
                "CST-SHD-005", mi.rel, node.lineno, "<module>",
                f"{CAPS_NAME} must be a literal dict of "
                "{'use_pallas_*': {'model': bool, 'data': bool}} the "
                "pass can read off the AST",
            ))
        else:
            caps.update(parsed)
            caps_mi, caps_node = mi, node
    if flags is not None and caps:
        for flag in flags:
            if flag not in caps:
                out.append(Finding(
                    "CST-SHD-005", caps_mi.rel, caps_node.lineno,
                    CAPS_NAME,
                    f"kernel flag {flag!r} (ModelConfig) has no "
                    f"{CAPS_NAME} row — every fused-kernel gate "
                    "decision must come from the table, not an ad-hoc "
                    "mesh condition",
                ))
        for flag in caps:
            if flag not in flags:
                out.append(Finding(
                    "CST-SHD-005", caps_mi.rel, caps_node.lineno,
                    CAPS_NAME,
                    f"stale {CAPS_NAME} row {flag!r} names no declared "
                    "ModelConfig flag — the kernel it gated was "
                    "renamed or removed",
                ))
    for mi, g in gates:
        calls = [
            n for n in ast.walk(g)
            if isinstance(n, ast.Call)
            and (call_name(n) or "").rsplit(".", 1)[-1] == _CAPS_LOOKUP
        ]
        if not calls:
            out.append(Finding(
                "CST-SHD-005", mi.rel, g.lineno, mi.qualname_of(g),
                f"{g.name} never consults {_CAPS_LOOKUP} — the gate "
                f"condition must be driven by {CAPS_NAME}, not a "
                "hardcoded mesh check",
            ))
    return out


@register_checker("partitioning")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    out: List[Finding] = []
    seen: Dict[str, Tuple[str, int, str]] = {}
    seen_sm: Dict[str, Tuple[str, int, str]] = {}
    scanned_rels = set()
    for mi in modules:
        scanned_rels.add(mi.rel)
        out.extend(_check_rule_tables(mi))
        out.extend(_registered_sites(
            mi, seen, jit_registry.SHARDING_CONSTRAINT_REGISTRY,
            is_pin_call, "CST-SHD-002", "placement-pin",
            "what the pin buys (which gather or copy it places, and "
            "why there)"))
        out.extend(_registered_sites(
            mi, seen_sm, jit_registry.SHARD_MAP_REGISTRY,
            is_collective_call, "CST-SHD-004", "collective",
            "the collective layout it buys (which gather it avoids, "
            "the fixed order of its sums)"))
    out.extend(_check_kernel_caps(modules))
    # Stale entries: judged only for files this scan covered (a corpus
    # scan must not flag the package's entries).
    for reg, hits, rule, what in (
        (jit_registry.SHARDING_CONSTRAINT_REGISTRY, seen, "CST-SHD-002",
         "placement-pin"),
        (jit_registry.SHARD_MAP_REGISTRY, seen_sm, "CST-SHD-004",
         "collective"),
    ):
        for key in sorted(reg):
            if key.split("::", 1)[0] in scanned_rels and key not in hits:
                out.append(Finding(
                    rule, "analysis/jit_registry.py", 1, key,
                    f"stale {what} registry entry `{key}` matches no "
                    "site — the code moved; update or remove it",
                ))
    return out
