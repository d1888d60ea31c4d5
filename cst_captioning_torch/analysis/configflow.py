"""CST-CFG: config-knob lifecycle rules over the def-use layer.

The port's config surface (``config.py``, field for field the JAX
package's) is read through unchecked attribute chains: a typo'd knob read silently evaluates the
dataclass default (``Config.from_dict`` validates WRITES from JSON,
nothing validates reads), a knob nothing reads is dead weight every
operator still has to reason about, and the docs knob catalogue can
rot silently.  These rules close the loop:

* CST-CFG-001 — a dotted config read (``cfg.serving.X``,
  ``self.cfg.train.X``, ``getattr(cfg.train, "X", default)``, a read
  through a section alias ``sv = cfg.serving; sv.X``, or through a
  section held on an object, ``self.cfg_train = cfg_train`` then
  ``self.cfg_train.X``) resolving to no declared dataclass field of
  that section.  Reads through aliases ride
  :mod:`analysis.dataflow`'s per-function def-use chains.
* CST-CFG-002 — a declared field with ZERO reads anywhere in the
  package (dead knob): either wire it or delete it.  Fires only on a
  full-package scan (the config module present).
* CST-CFG-003 — a declared field missing from the docs/ANALYSIS.md
  knob catalogue (the ``METRIC_HELP`` doc discipline applied to
  config: operators discover knob vocabulary there).
* CST-CFG-004 — a preset (any function in the config module)
  assigning an UNDECLARED field: the assignment silently creates a
  new attribute instead of configuring anything.

Section expressions are recognized structurally: ``<base>.<section>``
where ``<section>`` is a field of the ``Config`` dataclass and
``<base>``'s attribute chain contains a config-flavored name (``cfg``,
``config``, ``c``, ``*cfg``) — the naming convention every call site
follows.  A section reaches a function as a parameter through calls,
constructions included (``Optimizer(params, cfg.train, n)`` binds
``Optimizer.__init__``'s ``cfg_train``), and a constant knob name
reaches a ``getattr`` through parameters and through ``for``-loops
over literal tuples (``for what, flag in (("beam",
"use_pallas_beam"), ...): gate(flag)``).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cst_captioning_torch.analysis.astutil import (
    FuncInfo,
    ModuleInfo,
    dotted,
    walk_body,
)
from cst_captioning_torch.analysis.dataflow import (
    Binding,
    DefUse,
    _enclosing_scopes,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

DOC_FILE = "ANALYSIS.md"

_CFG_BASES = {"cfg", "config", "c"}


def find_config_module(modules: List[ModuleInfo]) -> Optional[ModuleInfo]:
    """The module declaring the ``Config`` dataclass tree —
    ``config.py`` at the package root (or the corpus twin)."""
    for mi in modules:
        if (
            (mi.rel == "config.py" or mi.rel.endswith("/config.py"))
            and "Config" in mi.classes
        ):
            return mi
    return None


def declared_fields(
    config_mi: ModuleInfo,
) -> Dict[str, Dict[str, int]]:
    """``{section: {field: lineno}}`` from the dataclass declarations:
    ``Config``'s annotated fields name the sections, each section
    class's annotated fields are the knobs."""
    cfg_cls = config_mi.classes["Config"]
    sections: Dict[str, str] = {}
    for node in cfg_cls.body:
        if (
            isinstance(node, ast.AnnAssign)
            and isinstance(node.target, ast.Name)
            and isinstance(node.annotation, ast.Name)
            and node.annotation.id in config_mi.classes
        ):
            sections[node.target.id] = node.annotation.id
    out: Dict[str, Dict[str, int]] = {}
    for sect, clsname in sections.items():
        cls = config_mi.classes[clsname]
        out[sect] = {
            n.target.id: n.lineno
            for n in cls.body
            if isinstance(n, ast.AnnAssign)
            and isinstance(n.target, ast.Name)
        }
    return out


def _base_is_cfg(node: ast.AST) -> bool:
    """Whether an expression reads as a config object: its attribute
    chain (climbing through subscripts/calls) contains a
    config-flavored name."""
    tokens: List[str] = []
    cur = node
    while True:
        if isinstance(cur, ast.Attribute):
            tokens.append(cur.attr)
            cur = cur.value
        elif isinstance(cur, ast.Subscript):
            cur = cur.value
        elif isinstance(cur, ast.Call):
            cur = cur.func
        elif isinstance(cur, ast.Name):
            tokens.append(cur.id)
            break
        else:
            break
    return any(
        t in _CFG_BASES or t.endswith("cfg") or t.endswith("config")
        for t in tokens
    )


def _section_expr(
    node: ast.AST, sections: Set[str]
) -> Optional[str]:
    """``"serving"`` when ``node`` is a config-section expression
    (``cfg.serving`` / ``self.cfg.serving`` / ``engines[0].cfg.serving``)."""
    if (
        isinstance(node, ast.Attribute)
        and node.attr in sections
        and _base_is_cfg(node.value)
    ):
        return node.attr
    return None


# One observed knob access.
#   kind: "load" | "store" | "getattr"
Access = Tuple[str, str, str, int, str]   # (section, field, rel, line, kind)

FnKey = Tuple[str, str]                   # (rel, qualname)


def _fn_key(fn: FuncInfo) -> FnKey:
    return (fn.module.rel, fn.qualname)


def _target_path(target: ast.AST, name: str) -> Optional[List[int]]:
    """Index path of ``name`` inside a (nested) tuple assignment
    target: ``[1]`` for ``flag`` in ``what, flag``; None if absent."""
    if isinstance(target, ast.Name):
        return [] if target.id == name else None
    if isinstance(target, (ast.Tuple, ast.List)):
        for i, el in enumerate(target.elts):
            sub = _target_path(el, name)
            if sub is not None:
                return [i] + sub
    return None


def _loop_strings(b: Binding) -> Optional[Set[str]]:
    """Constant strings a ``for``/comprehension target takes when it
    iterates a literal tuple/list (``for what, flag in (("beam",
    "use_pallas_beam"), ...)`` → ``{"use_pallas_beam", ...}`` for
    ``flag``)."""
    loop = b.stmt
    path = _target_path(getattr(loop, "target", None), b.name)
    it = getattr(loop, "iter", None)
    if path is None or not isinstance(it, (ast.Tuple, ast.List)):
        return None
    out: Set[str] = set()
    for el in it.elts:
        for i in path:
            if not (
                isinstance(el, (ast.Tuple, ast.List)) and i < len(el.elts)
            ):
                return None
            el = el.elts[i]
        if not (isinstance(el, ast.Constant) and isinstance(el.value, str)):
            return None
        out.add(el.value)
    return out or None


class _Flow:
    """The interprocedural section-alias state: which function
    PARAMETERS are config sections (``make_optimizer(cfg.train, …)``
    or ``Optimizer(params, cfg.train, …)`` → ``cfg_train`` is the
    train section inside), which instance ATTRIBUTES hold a section
    (``self.cfg_train = cfg_train`` in any method of the class), and
    which string-typed parameters carry constant field names
    (``gate("use_pallas_beam")`` → ``getattr(m, flag)`` reads that
    knob).  Computed to a fixpoint over the call graph so aliases
    chain (``make_optimizer`` → ``Optimizer.__init__`` →
    ``make_lr_schedule``)."""

    def __init__(self, modules, ctx, sections: Set[str]):
        self.modules = modules
        self.ctx = ctx
        self.sections = sections
        self._du: Dict[FnKey, DefUse] = {}
        self.param_section: Dict[Tuple[FnKey, str], str] = {}
        self.param_strings: Dict[Tuple[FnKey, str], Set[str]] = {}
        # (module rel, class, attribute) -> section held there
        self.attr_section: Dict[Tuple[str, str, str], str] = {}
        self._fixpoint()

    def du(self, fn: FuncInfo) -> DefUse:
        k = _fn_key(fn)
        if k not in self._du:
            self._du[k] = DefUse(fn)
        return self._du[k]

    # ----------------------------------------------- alias resolution
    def section_of(
        self, fn: FuncInfo, expr: ast.AST
    ) -> Optional[str]:
        """The config section ``expr`` evaluates to, chasing local
        bindings, parameters (interprocedural), section-holding
        ``self`` attributes, and enclosing-scope closures."""
        sect = _section_expr(expr, self.sections)
        if sect is not None:
            return sect
        if isinstance(expr, ast.Attribute):
            return self.held_section(fn, expr)
        if not isinstance(expr, ast.Name):
            return None
        return self._name_section(fn, expr)

    def _self_class(self, fn: FuncInfo) -> Optional[str]:
        """The class whose ``self`` a function sees: its own for a
        method, the outermost enclosing class for a nested def."""
        if fn.cls is not None:
            return fn.cls
        head = fn.qualname.split(".", 1)[0]
        return head if head in fn.module.classes else None

    def held_section(
        self, fn: FuncInfo, expr: ast.AST
    ) -> Optional[str]:
        """The section held by ``self.<attr>`` (looked up through the
        class's package bases), else None."""
        if not (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            return None
        cls = self._self_class(fn)
        if cls is None:
            return None
        index = self.ctx.index
        work = [(fn.module, cls)]
        seen = set()
        while work:
            mi, c = work.pop(0)
            if (mi.rel, c) in seen:
                continue
            seen.add((mi.rel, c))
            sect = self.attr_section.get((mi.rel, c, expr.attr))
            if sect is not None:
                return sect
            for base in mi.classes[c].bases:
                ref = index.class_ref(mi, dotted(base))
                if ref is not None:
                    work.append(ref)
        return None

    def _name_section(
        self, fn: FuncInfo, use: ast.Name
    ) -> Optional[str]:
        du = self.du(fn)
        b = du.reaching_def(use)
        if b is not None:
            if b.kind == "param":
                return self.param_section.get((_fn_key(fn), use.id))
            if b.value is not None and b.kind not in ("for", "comp"):
                return self.section_of(fn, b.value)
            return None
        if du.is_local(use.id):
            return None
        # closure read: an enclosing scope's binding or parameter
        for enc in _enclosing_scopes(fn):
            enc_du = self.du(enc)
            if use.id in enc.params:
                return self.param_section.get((_fn_key(enc), use.id))
            for b in enc_du.bindings_of(use.id):
                if b.value is not None and b.kind not in ("for", "comp"):
                    sect = self.section_of(enc, b.value)
                    if sect is not None:
                        return sect
            if enc_du.is_local(use.id):
                return None
        return None

    def string_values(
        self, fn: FuncInfo, expr: ast.AST
    ) -> Optional[Set[str]]:
        """Constant string value(s) of ``expr``: a literal, a binding
        of one, a loop target over a literal tuple of them, or a
        parameter whose call sites all pass literals."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return {expr.value}
        if not isinstance(expr, ast.Name):
            return None
        du = self.du(fn)
        b = du.reaching_def(expr)
        if b is not None and b.kind == "param":
            return self.param_strings.get((_fn_key(fn), expr.id))
        if b is not None and b.kind in ("for", "comp"):
            return _loop_strings(b)
        if b is not None and b.value is not None:
            return self.string_values(fn, b.value)
        return None

    # ------------------------------------------------------- fixpoint
    def _map_args(
        self, callee: FuncInfo, call: ast.Call
    ) -> List[Tuple[str, ast.AST]]:
        params = callee.params
        if callee.cls is not None and params and params[0] in (
            "self", "cls"
        ):
            params = params[1:]
        pairs = list(zip(params, call.args))
        for kw in call.keywords:
            if kw.arg and kw.arg in callee.params:
                pairs.append((kw.arg, kw.value))
        return pairs

    def _fixpoint(self) -> None:
        for _ in range(8):   # package alias chains are ~2 deep
            changed = False
            for mi in self.modules:
                for qn, fn in mi.functions.items():
                    if self._self_class(fn) is not None:
                        changed |= self._collect_held(fn)
                    for call in (
                        n for n in walk_body(fn)
                        if isinstance(n, ast.Call)
                    ):
                        callees = self.ctx.index.resolve_call(
                            mi, fn, call
                        )
                        for callee in callees:
                            for pname, arg in self._map_args(
                                callee, call
                            ):
                                ck = (_fn_key(callee), pname)
                                sect = self.section_of(fn, arg)
                                if sect is not None and (
                                    self.param_section.get(ck) != sect
                                ):
                                    self.param_section[ck] = sect
                                    changed = True
                                strs = self.string_values(fn, arg)
                                if strs:
                                    have = self.param_strings.setdefault(
                                        ck, set()
                                    )
                                    if not strs <= have:
                                        have.update(strs)
                                        changed = True
            if not changed:
                break

    def _collect_held(self, fn: FuncInfo) -> bool:
        """Record ``self.<attr> = <section>`` stores in ``fn``; True
        when one was new."""
        changed = False
        cls = self._self_class(fn)
        for node in walk_body(fn):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            if node.value is None:
                continue
            for t in targets:
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                sect = self.section_of(fn, node.value)
                key = (fn.module.rel, cls, t.attr)
                if sect is not None and self.attr_section.get(key) != sect:
                    self.attr_section[key] = sect
                    changed = True
        return changed


def collect_accesses(
    modules: List[ModuleInfo], ctx, sections: Set[str]
) -> List[Access]:
    """Every recognized knob access in the scanned modules — direct
    dotted chains, ``getattr``/``hasattr`` string reads (constant or
    dataflow-resolved names), alias reads through the def-use chains
    (``sv = cfg.serving; sv.X``), closure reads, reads through
    section-typed parameters (``make_optimizer(cfg.train)`` →
    ``cfg_train.beta1``) and through section-holding attributes
    (``self.cfg_train.learning_rate``).  The tests' vacuous-green guard pins that
    this discovers the real read surface."""
    flow = _Flow(modules, ctx, sections)
    out: List[Access] = []
    for mi in modules:
        # ---- direct dotted accesses (module level + functions) -----
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Attribute):
                sect = _section_expr(node.value, sections)
                if sect is None:
                    continue
                kind = "store" if isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ) else "load"
                out.append((sect, node.attr, mi.rel, node.lineno, kind))
        # ---- alias / parameter / closure / held / getattr reads ----
        for qn, fn in mi.functions.items():
            for node in walk_body(fn):
                if not isinstance(node, ast.Attribute):
                    continue
                sect = flow.held_section(fn, node.value)
                if sect is None:
                    continue
                kind = "store" if isinstance(
                    node.ctx, (ast.Store, ast.Del)
                ) else "load"
                out.append((sect, node.attr, mi.rel, node.lineno, kind))
            du = flow.du(fn)
            for use in du.uses:
                sect = flow._name_section(fn, use)
                if sect is None:
                    continue
                parent = mi.parent.get(use)
                if isinstance(parent, ast.Attribute) and (
                    parent.value is use
                ):
                    kind = "store" if isinstance(
                        parent.ctx, (ast.Store, ast.Del)
                    ) else "load"
                    out.append((
                        sect, parent.attr, mi.rel, parent.lineno, kind
                    ))
            # getattr/hasattr on anything section-typed
            for call in (
                n for n in walk_body(fn) if isinstance(n, ast.Call)
            ):
                if not (
                    isinstance(call.func, ast.Name)
                    and call.func.id in ("getattr", "hasattr")
                    and len(call.args) >= 2
                ):
                    continue
                sect = flow.section_of(fn, call.args[0])
                if sect is None:
                    continue
                names = flow.string_values(fn, call.args[1])
                for field in sorted(names or ()):
                    out.append((
                        sect, field, mi.rel, call.lineno, "getattr"
                    ))
    return out


@register_checker("configflow")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    config_mi = find_config_module(modules)
    if config_mi is None:
        return []
    fields = declared_fields(config_mi)
    sections = set(fields)
    accesses = collect_accesses(modules, ctx, sections)
    out: List[Finding] = []

    # ---- CFG-001 / CFG-004: every access names a declared field ------
    for sect, field, rel, line, kind in accesses:
        if field in fields[sect]:
            continue
        mi = ctx.index.by_rel.get(rel)
        symbol = "<module>"
        if mi is not None:
            for node in ast.walk(mi.tree):
                if getattr(node, "lineno", None) == line and isinstance(
                    node, (ast.Attribute, ast.Call)
                ):
                    symbol = mi.qualname_of(node)
                    break
        if rel == config_mi.rel and kind == "store":
            out.append(Finding(
                "CST-CFG-004", rel, line, symbol,
                f"preset assigns `{sect}.{field}`, which is not a "
                f"declared field of {sect!r} — the assignment "
                "silently creates a new attribute instead of "
                "configuring anything; fix the name or declare the "
                "field",
            ))
        else:
            out.append(Finding(
                "CST-CFG-001", rel, line, symbol,
                f"config read `{sect}.{field}` resolves to no "
                f"declared field of {sect!r} — a typo'd knob "
                "silently falls back to defaults; fix the name or "
                "declare the field in config.py",
            ))

    # Corpus scans stop here unless they carry the real config module;
    # the package-wide lifecycle rules need the full read surface.
    full_scan = config_mi.rel == "config.py" or len(modules) > 1
    if not full_scan:
        return out

    # ---- CFG-002: dead knobs ----------------------------------------
    read_fields = {
        (s, f)
        for s, f, rel, _, kind in accesses
        if kind in ("load", "getattr") and rel != config_mi.rel
    }
    for sect in sorted(fields):
        for field, line in sorted(fields[sect].items()):
            if (sect, field) not in read_fields:
                out.append(Finding(
                    "CST-CFG-002", config_mi.rel, line,
                    f"{sect}.{field}",
                    f"declared knob `{sect}.{field}` has zero reads "
                    "anywhere in the package — a dead knob misleads "
                    "every operator who sets it; wire it or delete "
                    "it",
                ))

    # ---- CFG-003: docs knob catalogue coverage ----------------------
    if ctx.docs_root is not None:
        doc_path = ctx.docs_root / DOC_FILE
        doc_text = doc_path.read_text() if doc_path.exists() else ""
        for sect in sorted(fields):
            for field, line in sorted(fields[sect].items()):
                if f"{sect}.{field}" not in doc_text:
                    out.append(Finding(
                        "CST-CFG-003", config_mi.rel, line,
                        f"{sect}.{field}",
                        f"knob `{sect}.{field}` is missing from the "
                        f"docs/{DOC_FILE} knob catalogue — operators "
                        "discover the config vocabulary there; add "
                        "the row",
                    ))
    return out
