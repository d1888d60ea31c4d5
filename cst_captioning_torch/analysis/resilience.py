"""CST-RES: fault-injection invariants (chaos engine —
``serving/chaos.py``).

A fault injector is only trustworthy if it provably cannot change the
serving path when it is off, and provably covers the failure modes it
claims to — so those are rules, not prose:

* CST-RES-001 — every ``chaos.fire("<site>")`` literal anywhere in the
  package must name a site registered in
  ``serving/chaos.py::FAULT_SITES`` (the ``METRIC_HELP`` discipline
  applied to injection points); on a full-package scan, every registered
  site must also have at least one live call site (a site that is never
  injected reads as chaos coverage that isn't there) and be documented
  in docs/SERVING.md's failure-modes table.
* CST-RES-002 — every ``chaos.fire`` call site must be guarded so
  chaos-off costs NOTHING: the call must sit under an ``is not None`` /
  truthiness check of a chaos-named expression (``if self.chaos is not
  None and self.chaos.fire(...)`` counts — the guard is the left
  operand).  On a full-package scan the ``ServingConfig.chaos`` field
  must also default to an EMPTY dict, so chaos is off unless explicitly
  configured.
* CST-RES-003 — no ``chaos.fire`` call (or any call resolving into
  ``serving/chaos.py``) reachable from traced code, through the CST-JIT
  traced set: a fault decision inside a replayed graph would be baked
  in at trace time and replayed forever, the opposite of a
  schedule-driven injection.

Emission sites are recognized structurally: a ``.fire`` call on a
receiver whose final name contains ``chaos`` — the naming convention the
serving call sites follow.  ``FAULT_SITES`` is read from the scanned
tree's ``serving/chaos.py`` by AST, never imported; the registry file
itself is excluded from site checks (its own machinery is not an
injection point).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from cst_captioning_torch.analysis.astutil import (
    ModuleInfo,
    catalogue_names,
    dotted,
    registry_module,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

REGISTRY_FILE = "serving/chaos.py"
CONFIG_FILE = "config.py"
DOC_FILE = "SERVING.md"


def load_sites(modules: List[ModuleInfo]) -> List[str]:
    """Every registered fault-site name, in registry order."""
    mi = registry_module(modules, REGISTRY_FILE)
    if mi is None:
        return []
    return catalogue_names(mi, "FAULT_SITES")


def _chaos_name(node: ast.AST) -> bool:
    """Whether ``node`` is a Name/Attribute chain whose final identifier
    names a chaos engine (``chaos``, ``self.chaos``, ``self._chaos``)."""
    base = dotted(node)
    if not base:
        return False
    return "chaos" in base.split(".")[-1].lstrip("_").lower()


def _fire_call(node: ast.Call) -> bool:
    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr == "fire"
        and _chaos_name(node.func.value)
    )


def _site_literal(node: ast.Call) -> Optional[Tuple[str, int]]:
    if not node.args:
        return None
    a = node.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, a.lineno
    return None


def _guard_expr(e: ast.AST) -> bool:
    """Whether an expression reads as a chaos-off guard: any chaos-named
    Name/Attribute inside it (covers ``x is not None``, bare truthiness,
    and boolean combinations thereof)."""
    return any(
        isinstance(n, (ast.Name, ast.Attribute)) and _chaos_name(n)
        for n in ast.walk(e)
    )


def _is_guarded(mi: ModuleInfo, call: ast.Call) -> bool:
    """Whether a ``chaos.fire`` call is dominated by a chaos-off guard:
    an enclosing ``if``/ternary whose test mentions the chaos engine, or
    an ``and`` chain whose EARLIER operand does (short-circuit guard)."""
    child: ast.AST = call
    cur = mi.parent.get(call)
    while cur is not None:
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return False
        if isinstance(cur, (ast.If, ast.While, ast.IfExp)):
            if cur.test is not child and _guard_expr(cur.test):
                return True
        if isinstance(cur, ast.BoolOp) and isinstance(cur.op, ast.And):
            for v in cur.values:
                if v is child or any(
                    v is n for n in ast.walk(child)
                ):
                    break
                if _guard_expr(v):
                    return True
        child = cur
        cur = mi.parent.get(cur)
    return False


def fire_sites(
    modules: List[ModuleInfo],
) -> List[Tuple[ModuleInfo, ast.Call, Optional[str]]]:
    """Every recognized ``chaos.fire`` call site in the package with its
    literal site name when the first argument is a string constant (the
    vacuous-green guard in tests asserts this finds the real serving
    injection points)."""
    out = []
    for mi in modules:
        if mi.rel == REGISTRY_FILE:
            continue
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call) and _fire_call(node):
                lit = _site_literal(node)
                out.append((mi, node, lit[0] if lit else None))
    return out


def _config_default_off(mi: ModuleInfo) -> Optional[int]:
    """Return the line of the ``ServingConfig.chaos`` field when its
    default is NOT an empty-dict factory (None = compliant or absent).
    Compliant shape: ``chaos: ... = field(default_factory=dict)``."""
    cls = mi.classes.get("ServingConfig")
    if cls is None:
        return None
    for node in cls.body:
        if not (
            isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and node.target.id == "chaos"
        ):
            continue
        v = node.value
        if (
            isinstance(v, ast.Call)
            and dotted(v.func).endswith("field")
            and any(
                kw.arg == "default_factory"
                and isinstance(kw.value, ast.Name)
                and kw.value.id == "dict"
                for kw in v.keywords
            )
        ):
            return None
        return node.lineno
    return None


@register_checker("resilience")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    out: List[Finding] = []
    names = set(load_sites(modules))
    full_scan = any(m.rel == REGISTRY_FILE for m in modules)

    # ---- RES-001: every fired site registered; registry covered ------
    seen_names = set()
    for mi, node, name in fire_sites(modules):
        if name is None:
            continue
        seen_names.add(name)
        if name not in names:
            out.append(Finding(
                "CST-RES-001", mi.rel, node.lineno,
                mi.qualname_of(node),
                f"chaos site `{name}` matches no entry in "
                "serving/chaos.py::FAULT_SITES — register it and "
                f"document it in docs/{DOC_FILE} before injecting",
            ))
        # ---- RES-002: the site must be guarded (chaos-off is free) ---
        if not _is_guarded(mi, node):
            out.append(Finding(
                "CST-RES-002", mi.rel, node.lineno,
                mi.qualname_of(node),
                "unguarded `chaos.fire` call — every injection point "
                "must sit behind an `is not None`/truthiness check of "
                "the chaos engine so the default (chaos-off) serving "
                "path is byte-identical and pays nothing",
            ))
    if full_scan:
        for name in sorted(names - seen_names):
            out.append(Finding(
                "CST-RES-001", REGISTRY_FILE, 1, name,
                f"registered fault site `{name}` has no live "
                "`chaos.fire` call site — chaos coverage that is "
                "registered but never injected reads as survival "
                "certification that isn't there",
            ))
        if ctx.docs_root is not None:
            doc_path = ctx.docs_root / DOC_FILE
            doc_text = doc_path.read_text() if doc_path.exists() else ""
            for name in sorted(names):
                if name not in doc_text:
                    out.append(Finding(
                        "CST-RES-001", REGISTRY_FILE, 1, name,
                        f"registered fault site `{name}` is not "
                        f"documented in docs/{DOC_FILE} — operators "
                        "discover the failure-mode vocabulary in the "
                        "degradation-ladder table; add it",
                    ))
        # ---- RES-002(b): config defaults chaos OFF -------------------
        cfg_mi = next(
            (m for m in modules if m.rel == CONFIG_FILE), None
        )
        if cfg_mi is not None:
            bad_line = _config_default_off(cfg_mi)
            if bad_line is not None:
                out.append(Finding(
                    "CST-RES-002", CONFIG_FILE, bad_line,
                    "ServingConfig.chaos",
                    "serving.chaos must default to an EMPTY dict "
                    "(field(default_factory=dict)) — chaos is opt-in; "
                    "a non-empty default would inject faults into "
                    "every serving process",
                ))

    # ---- RES-003: no chaos decision reachable from traced code ------
    from cst_captioning_torch.analysis.jit_boundary import traced_nodes

    for mi, fn, reason, nodes in traced_nodes(modules, ctx):
        if mi.rel == REGISTRY_FILE:
            continue
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            if _fire_call(node):
                out.append(Finding(
                    "CST-RES-003", mi.rel, node.lineno, fn.qualname,
                    f"chaos.fire inside traced code ({reason}) — the "
                    "fault decision would be baked in at trace time and "
                    "replayed forever; inject at the host-side tick "
                    "boundary instead",
                ))
                continue
            for callee in ctx.index.resolve_call(mi, fn, node):
                if callee.module.rel == REGISTRY_FILE:
                    out.append(Finding(
                        "CST-RES-003", mi.rel, node.lineno, fn.qualname,
                        f"call into {REGISTRY_FILE} from traced code "
                        f"({reason}) — the chaos layer is host-side only",
                    ))
    return out
