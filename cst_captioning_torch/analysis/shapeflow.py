"""CST-SHP: shape-ladder discipline.

The registries say what shapes each kernel site sees; the discipline
that makes that true — the engine's batch ladder, the slot loop's bank
ladder and padded admit buckets — lives in code the registries never
see.  These rules close the gap:

* **CST-SHP-001** — every kernel site (``_build.load``) has a
  ``jit_registry.py::SHAPE_LADDER_REGISTRY`` entry declaring the shape
  family its launches see (``fixed`` / ``enumerated`` / ``probe``) and,
  for an enumerated ladder, the bucket functions that quantize runtime
  counts onto it; stale entries and bucket functions that resolve to no
  live def fire too.  The dataflow half: in ``serving/`` or
  ``decoding/`` dispatch code, a device tensor created with a dimension
  the interpreter proves derives from ``len(...)`` with no registered
  bucket function in between — a launch shape per distinct queue depth.
* **CST-SHP-002** — AOT enumeration drift in a class that ships the
  artifact contract (``aot_variant_keys`` and ``_variants``, the port's
  ``serving/slots.py::SlotDecoder``): (a) an ``aot_variant_keys`` that
  does not delegate to ``_variants`` emits the same key families; (b)
  every variant kind ``_variants`` yields has a runner (the method named
  ``_<kind>_fn``, ``<kind>`` or ``_<kind>``, or the one
  ``AOT_VARIANT_RUNNERS`` names) reachable from ``warmup`` through the
  class's own calls; (c) the ladder sources ``warmup`` walks
  (``bank_ladder``, ``warm_admit_counts``) also drive the enumeration.
* **CST-SHP-003** — a Python ``for`` / ``while`` whose trip count reads
  ``.shape`` / ``.size()`` inside the CST-JIT traced set: the loop unrolls at trace
  time, once per shape.  The port has no traced root, so this judges
  nothing on its own source today.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cst_captioning_torch.analysis import jit_registry
from cst_captioning_torch.analysis import typeflow as tfmod
from cst_captioning_torch.analysis.astutil import (
    ModuleInfo,
    call_name,
    dotted,
    resolved_call,
    walk_body,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)
from cst_captioning_torch.analysis.typeflow import dim_is_data_dependent

_CREATORS = frozenset({"zeros", "ones", "empty", "full", "rand", "randn"})
_DISPATCH_DIRS = ("serving", "decoding")
_KINDS = ("fixed", "enumerated", "probe")


def _in_dispatch_dirs(rel: str) -> bool:
    return any(seg in _DISPATCH_DIRS for seg in rel.split("/")[:-1])


def _check_ladder_registry(modules: List[ModuleInfo]) -> List[Finding]:
    from cst_captioning_torch.analysis.donation import collect_kernel_sites

    out: List[Finding] = []
    reg = jit_registry.SHAPE_LADDER_REGISTRY
    seen: Set[str] = set()
    for key, mi, call, qn, _ in collect_kernel_sites(modules):
        seen.add(key)
        entry = reg.get(key)
        if entry is None:
            out.append(Finding(
                "CST-SHP-001", mi.rel, call.lineno, qn,
                f"kernel site `{key}` has no SHAPE_LADDER_REGISTRY entry "
                "— declare the shape family its launches see (fixed / "
                "enumerated ladder / probe) and, for a ladder, the "
                "bucket functions that enforce it",
            ))
            continue
        bad = None
        if entry.kind not in _KINDS:
            bad = f"unknown ladder kind {entry.kind!r}"
        elif entry.kind == "enumerated" and not entry.bucket_fns:
            bad = ("an enumerated ladder must name the bucket function(s) "
                   "that quantize runtime counts onto it")
        if bad:
            out.append(Finding(
                "CST-SHP-001", mi.rel, call.lineno, qn,
                f"SHAPE_LADDER_REGISTRY entry `{key}`: {bad}",
            ))
    scanned = {m.rel for m in modules}
    defined = {f"{mi.rel}::{qn}" for mi in modules for qn in mi.functions}
    for key in sorted(reg):
        if key.split("::", 1)[0] not in scanned:
            continue
        if key not in seen:
            out.append(Finding(
                "CST-SHP-001", "analysis/jit_registry.py", 1, key,
                f"stale SHAPE_LADDER_REGISTRY entry `{key}` matches no "
                "live kernel site — the code moved; update or remove it",
            ))
        for fq in reg[key].bucket_fns:
            if fq.split("::", 1)[0] in scanned and fq not in defined:
                out.append(Finding(
                    "CST-SHP-001", "analysis/jit_registry.py", 1, key,
                    f"ladder entry `{key}` names bucket function `{fq}`, "
                    "which resolves to no live def — the quantizer was "
                    "renamed or removed",
                ))
    return out


def _check_data_dependent_dims(modules: List[ModuleInfo],
                               tf) -> List[Finding]:
    out: List[Finding] = []
    for mi in modules:
        if not _in_dispatch_dirs(mi.rel):
            continue
        for qn, fn in mi.functions.items():
            if not isinstance(fn.node, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                continue
            types = tf.types_of(fn)
            for node in walk_body(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = resolved_call(mi, node)
                # torch creators only: a len()-shaped numpy buffer is
                # host-side result assembly
                if not (name.startswith("torch.")
                        and name.rsplit(".", 1)[-1] in _CREATORS):
                    continue
                shape = types.shape_arg(node)
                for d in shape or ():
                    if dim_is_data_dependent(d):
                        out.append(Finding(
                            "CST-SHP-001", mi.rel, node.lineno, qn,
                            f"device tensor created with data-dependent "
                            f"dim `{d}` (from len(...) with no registered "
                            "ladder bucket in the chain) — a launch shape "
                            "per distinct count; route the count through "
                            "the site's bucket function first",
                        ))
                        break
    return out


# --------------------------------------------------- AOT drift (SHP-002)

def _key_prefixes(fn_node: ast.AST) -> Set[str]:
    """Families (text up to the first ':') of the f-string / str
    literals that look like variant keys (``tick:S8:A4``)."""
    out: Set[str] = set()
    for n in ast.walk(fn_node):
        if isinstance(n, ast.JoinedStr):
            first = n.values[0] if n.values else None
            if isinstance(first, ast.Constant) and isinstance(
                first.value, str
            ) and ":" in first.value:
                out.add(first.value.split(":", 1)[0])
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            if ":" in n.value and n.value.split(":", 1)[0].isidentifier():
                out.add(n.value.split(":", 1)[0])
    return out


def _self_attr_reads(fn_node: ast.AST) -> Set[str]:
    return {
        n.attr for n in ast.walk(fn_node)
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
        and n.value.id == "self"
    }


def _yielded_kinds(fn_node: ast.AST) -> Dict[str, int]:
    """Variant kind -> line, from ``yield key, ("kind", ...)``."""
    out: Dict[str, int] = {}
    for n in ast.walk(fn_node):
        if isinstance(n, ast.Yield) and isinstance(n.value, ast.Tuple) \
                and len(n.value.elts) == 2:
            spec = n.value.elts[1]
            if isinstance(spec, ast.Tuple) and spec.elts and isinstance(
                spec.elts[0], ast.Constant
            ) and isinstance(spec.elts[0].value, str):
                out.setdefault(spec.elts[0].value, n.lineno)
    return out


_LADDER_SOURCES = ("bank_ladder", "warm_admit_counts")


def aot_contract_classes(
    modules: List[ModuleInfo],
) -> List[Tuple[ModuleInfo, str, Dict[str, ast.AST]]]:
    """Classes defining both ``aot_variant_keys`` and ``_variants``."""
    out = []
    for mi in modules:
        for cls_name, cls in mi.classes.items():
            methods = {
                s.name: s for s in cls.body
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            if "aot_variant_keys" in methods and "_variants" in methods:
                out.append((mi, cls_name, methods))
    return out


def variant_runner(mi: ModuleInfo, cls: str, methods: Dict[str, ast.AST],
                   kind: str) -> Optional[str]:
    """The method that runs variant ``kind`` (registry first, then the
    naming convention)."""
    named = jit_registry.AOT_VARIANT_RUNNERS.get(f"{mi.rel}::{cls}", {})
    if kind in named:
        return named[kind]
    for cand in (f"_{kind}_fn", kind, f"_{kind}"):
        if cand in methods:
            return cand
    return None


def _reachable_methods(methods: Dict[str, ast.AST], start: str) -> Set[str]:
    """Methods reachable from ``start`` through ``self.<m>(...)`` calls."""
    seen = {start}
    work = [start]
    while work:
        m = methods.get(work.pop())
        if m is None:
            continue
        for n in ast.walk(m):
            if isinstance(n, ast.Call):
                name = call_name(n)
                if name.startswith("self.") and name.count(".") == 1:
                    callee = name[5:]
                    if callee in methods and callee not in seen:
                        seen.add(callee)
                        work.append(callee)
    return seen


def _check_aot_drift(modules: List[ModuleInfo]) -> List[Finding]:
    out: List[Finding] = []
    for mi, cls, methods in aot_contract_classes(modules):
        keys_fn = methods["aot_variant_keys"]
        var_fn = methods["_variants"]
        key_reads = _self_attr_reads(keys_fn)
        delegates = "_variants" in key_reads
        enum_reads = key_reads | (_self_attr_reads(var_fn) if delegates
                                  else set())
        if not delegates:
            kp, vp = _key_prefixes(keys_fn), _key_prefixes(var_fn)
            if kp != vp:
                out.append(Finding(
                    "CST-SHP-002", mi.rel, keys_fn.lineno,
                    f"{cls}.aot_variant_keys",
                    f"variant-key families drifted: aot_variant_keys emits "
                    f"{sorted(kp)} but _variants yields {sorted(vp)} — "
                    "the artifact's key-set refusal cannot catch a family "
                    "the enumeration never names",
                ))
        warm = _reachable_methods(methods, "warmup") if "warmup" in methods \
            else set()
        for kind, line in sorted(_yielded_kinds(var_fn).items()):
            runner = variant_runner(mi, cls, methods, kind)
            if runner is None or runner not in methods:
                out.append(Finding(
                    "CST-SHP-002", mi.rel, line, f"{cls}._variants",
                    f"variant kind {kind!r} has no runner method in {cls} "
                    "(name it _<kind>_fn / <kind> / _<kind>, or register "
                    "it in jit_registry.AOT_VARIANT_RUNNERS)",
                ))
            elif "warmup" in methods and runner not in warm:
                out.append(Finding(
                    "CST-SHP-002", mi.rel, methods[runner].lineno,
                    f"{cls}.{runner}",
                    f"variant kind {kind!r}'s runner `{runner}` is never "
                    "reached from warmup — its first run pays its build "
                    "and first-launch cost at first traffic, the cold "
                    "start the artifact exists to remove",
                ))
        if "warmup" in methods:
            warm_reads = _self_attr_reads(methods["warmup"])
            for src in _LADDER_SOURCES:
                if src in warm_reads and src not in enum_reads:
                    out.append(Finding(
                        "CST-SHP-002", mi.rel, keys_fn.lineno,
                        f"{cls}.aot_variant_keys",
                        f"warmup walks `{src}` but the enumeration never "
                        "reads it — it cannot cover combinations it does "
                        "not iterate; drive both from the same ladder "
                        "source",
                    ))
    for key, runners in sorted(jit_registry.AOT_VARIANT_RUNNERS.items()):
        rel, _, cls = key.partition("::")
        mi = next((m for m in modules if m.rel == rel), None)
        if mi is None:
            continue
        node = mi.classes.get(cls)
        names = {s.name for s in node.body
                 if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))
                 } if node is not None else set()
        for kind, runner in sorted(runners.items()):
            if runner not in names:
                out.append(Finding(
                    "CST-SHP-002", "analysis/jit_registry.py", 1, key,
                    f"stale AOT_VARIANT_RUNNERS entry `{key}`: {kind!r} -> "
                    f"`{runner}` names no method of the class",
                ))
    return out


# ------------------------------------------- trace-time unroll (SHP-003)

def _reads_shape(expr: ast.AST, types) -> Optional[str]:
    """A ``.shape`` read inside ``expr``, directly or through the
    def-use chains, rendered for the message."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim"):
            return dotted(n) or f"<expr>.{n.attr}"
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("size", "dim"):
            return f"{dotted(n.func)}(...)"
        if isinstance(n, ast.Name):
            b = types.du.reaching_def(n)
            if b is not None and b.value is not None and b.kind in (
                "assign", "walrus",
            ):
                for sub in ast.walk(b.value):
                    if isinstance(sub, ast.Attribute) and sub.attr in (
                        "shape", "ndim",
                    ):
                        return dotted(sub) or f"<expr>.{sub.attr}"
    return None


def _check_shape_unroll(tf) -> List[Finding]:
    out: List[Finding] = []
    for fn in tf.traced_functions():
        mi = fn.module
        types = tf.types_of(fn)
        for node in walk_body(fn):
            if isinstance(node, ast.For):
                it = node.iter
                if isinstance(it, ast.Call) and (
                    call_name(it) or ""
                ).rsplit(".", 1)[-1] == "range":
                    for a in it.args:
                        hit = _reads_shape(a, types)
                        if hit:
                            out.append(Finding(
                                "CST-SHP-003", mi.rel, it.lineno,
                                fn.qualname,
                                f"Python `for ... in range({hit})` inside "
                                "traced code unrolls at trace time, once "
                                "per shape; keep the loop outside the "
                                "traced function or make its bound static",
                            ))
                            break
            elif isinstance(node, ast.While):
                hit = _reads_shape(node.test, types)
                if hit:
                    out.append(Finding(
                        "CST-SHP-003", mi.rel, node.lineno, fn.qualname,
                        f"Python `while` on `{hit}` inside traced code — "
                        "the trip count is fixed at trace time",
                    ))
    return out


@register_checker("shapeflow")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    tf = tfmod.build(modules, ctx)
    out: List[Finding] = []
    out.extend(_check_ladder_registry(modules))
    out.extend(_check_data_dependent_dims(modules, tf))
    out.extend(_check_aot_drift(modules))
    out.extend(_check_shape_unroll(tf))
    return out
