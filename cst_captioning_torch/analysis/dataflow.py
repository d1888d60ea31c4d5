"""Shared def-use dataflow layer for the invariant engine.

Two primitives the rule families share:

* :class:`DefUse` — per-function def-use chains in LEXICAL event
  order: every binding (parameter, assignment, walrus, loop target,
  ``with``-as, ``except``-as) and every ``Name`` read, with
  ``reaching_def`` resolving a read to the latest earlier binding of
  that name.  Lexical order is a conscious approximation of control
  flow (a textually-later def inside a loop is treated as not
  reaching an earlier read); the checkers built on top are tuned so
  the approximation only ever costs recall, never package-clean
  precision.  CST-CFG resolves section aliases (``sv = cfg.serving``)
  through it.
* :func:`provenance_chain` — walk a value expression backwards through
  the chains (``k = fold_in(rng, i)`` -> ``rng`` -> parameter) until it
  bottoms out at a parameter, an enclosing-scope binding, an attribute
  read, a constant or a call; CST-RNG traces threefry keys with it.
* :func:`expand_call_closure` — a seed set of functions closed over
  nested defs plus ``PackageIndex.resolve_call``; CST-EXC uses it for
  thread-root reachability.

Pure stdlib-``ast`` like the rest of the engine: reads source, never
imports the package under analysis.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional

from cst_captioning_torch.analysis.astutil import (
    FuncInfo,
    ModuleInfo,
    walk_body,
)

__all__ = [
    "Binding",
    "DefUse",
    "Origin",
    "expand_call_closure",
    "provenance_chain",
]


@dataclass(frozen=True)
class Binding:
    """One name binding inside a function body."""

    name: str
    index: int                    # lexical event index (params = -1)
    kind: str                     # param | assign | aug | walrus | for
    #                               | with | except | comp
    value: Optional[ast.AST]      # RHS expression bound to the name
    #                               (None for params / loop targets)
    stmt: Optional[ast.AST]       # the binding statement/handler node

    @property
    def line(self) -> int:
        if self.stmt is not None and hasattr(self.stmt, "lineno"):
            return self.stmt.lineno
        return 0


def _ordered_children(node: ast.AST) -> Iterator[ast.AST]:
    """Children of ``node`` in EVALUATION order (values before the
    targets they bind — ``x = f(x)`` reads the old ``x`` first)."""
    if isinstance(node, ast.Assign):
        yield node.value
        for t in node.targets:
            yield t
    elif isinstance(node, ast.AnnAssign):
        if node.value is not None:
            yield node.value
        yield node.target
    elif isinstance(node, ast.AugAssign):
        yield node.value
        yield node.target
    elif isinstance(node, ast.NamedExpr):
        yield node.value
        yield node.target
    elif isinstance(node, (ast.For, ast.AsyncFor)):
        yield node.iter
        yield node.target
        for s in node.body + node.orelse:
            yield s
    elif isinstance(node, ast.comprehension):
        yield node.iter
        yield node.target
        for c in node.ifs:
            yield c
    else:
        yield from ast.iter_child_nodes(node)


class DefUse:
    """Lexical def-use chains for one function body.

    ``events`` interleaves bindings and reads in source-evaluation
    order; ``reaching_def(name_node)`` resolves a ``Name`` read to the
    latest earlier :class:`Binding` of that name (or None — a free
    variable: parameter of an enclosing scope, module global, or
    builtin).  Nested ``def``/``lambda`` bodies are NOT walked (they
    are their own :class:`FuncInfo`/``DefUse``); reads inside them see
    this function's bindings through :func:`free_names`.
    """

    def __init__(self, fn: FuncInfo):
        self.fn = fn
        self.bindings: List[Binding] = []
        self._by_name: Dict[str, List[Binding]] = {}
        self._use_index: Dict[int, int] = {}     # id(Name node) -> index
        self.uses: List[ast.Name] = []
        for p in fn.params:
            self._record(Binding(p, -1, "param", None, fn.node))
        self._walk(fn.node)

    # ------------------------------------------------------------ build
    def _record(self, b: Binding) -> None:
        self.bindings.append(b)
        self._by_name.setdefault(b.name, []).append(b)

    def _bind_target(
        self, target: ast.AST, index: int, kind: str,
        value: Optional[ast.AST], stmt: ast.AST,
    ) -> None:
        """Bind an assignment target, pairing tuple targets with tuple
        values element-wise (``m, d = cfg.model, cfg.data``)."""
        if isinstance(target, ast.Name):
            self._record(Binding(target.id, index, kind, value, stmt))
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals: List[Optional[ast.AST]] = [None] * len(target.elts)
            if isinstance(value, (ast.Tuple, ast.List)) and len(
                value.elts
            ) == len(target.elts):
                vals = list(value.elts)
            elif isinstance(value, ast.Call):
                # ``k_w, k_b = split(rng)``: every element is a
                # projection of the one call — keep the derivation.
                vals = [value] * len(target.elts)
            for t, v in zip(target.elts, vals):
                self._bind_target(t, index, kind, v, stmt)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, index, kind, None, stmt)
        # Attribute / Subscript stores bind no local name.

    def _walk(self, root: ast.AST) -> None:
        index = 0

        def visit(node: ast.AST, stmt: ast.AST) -> None:
            nonlocal index
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ) and node is not root:
                # nested scope: its def-name still binds here
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    index += 1
                    self._record(
                        Binding(node.name, index, "assign", node, node)
                    )
                return
            if isinstance(node, ast.Name):
                index += 1
                if isinstance(node.ctx, ast.Load):
                    self._use_index[id(node)] = index
                    self.uses.append(node)
                return
            if isinstance(node, ast.Assign):
                visit(node.value, stmt)
                index += 1
                for t in node.targets:
                    self._bind_target(t, index, "assign", node.value, node)
                return
            if isinstance(node, ast.AnnAssign):
                if node.value is not None:
                    visit(node.value, stmt)
                index += 1
                self._bind_target(
                    node.target, index, "assign", node.value, node
                )
                return
            if isinstance(node, ast.AugAssign):
                visit(node.value, stmt)
                if isinstance(node.target, ast.Name):
                    # aug reads the old binding then rebinds
                    index += 1
                    self._use_index[id(node.target)] = index
                    index += 1
                    self._record(Binding(
                        node.target.id, index, "aug", node.value, node
                    ))
                else:
                    visit(node.target, stmt)
                return
            if isinstance(node, ast.NamedExpr):
                visit(node.value, stmt)
                index += 1
                self._bind_target(
                    node.target, index, "walrus", node.value, node
                )
                return
            if isinstance(node, (ast.For, ast.AsyncFor)):
                visit(node.iter, stmt)
                index += 1
                self._bind_target(node.target, index, "for", node.iter, node)
                for s in node.body + node.orelse:
                    visit(s, s)
                return
            if isinstance(node, ast.comprehension):
                visit(node.iter, stmt)
                index += 1
                self._bind_target(node.target, index, "comp", node.iter, node)
                for c in node.ifs:
                    visit(c, stmt)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    visit(item.context_expr, stmt)
                    if item.optional_vars is not None:
                        index += 1
                        self._bind_target(
                            item.optional_vars, index, "with",
                            item.context_expr, node,
                        )
                for s in node.body:
                    visit(s, s)
                return
            if isinstance(node, ast.ExceptHandler):
                if node.name:
                    index += 1
                    self._record(
                        Binding(node.name, index, "except", node.type, node)
                    )
                for s in node.body:
                    visit(s, s)
                return
            for child in _ordered_children(node):
                visit(child, stmt if not isinstance(
                    child, ast.stmt
                ) else child)

        body = getattr(root, "body", [])
        if isinstance(body, list):
            for s in body:
                visit(s, s)
        else:                     # Lambda
            visit(body, root)

    # ---------------------------------------------------------- queries
    def reaching_def(self, use: ast.Name) -> Optional[Binding]:
        """Latest binding of ``use.id`` strictly before the read, or
        None for free variables."""
        at = self._use_index.get(id(use))
        if at is None:
            return None
        best = None
        for b in self._by_name.get(use.id, ()):
            if b.index < at and (best is None or b.index > best.index):
                best = b
        return best

    def bindings_of(self, name: str) -> List[Binding]:
        return list(self._by_name.get(name, ()))

    def is_local(self, name: str) -> bool:
        return name in self._by_name


# ----------------------------------------------------------- provenance

@dataclass(frozen=True)
class Origin:
    """Where a value expression bottoms out after chasing bindings.

    ``kind``: ``"param"`` (a parameter of the function itself),
    ``"enclosing"`` (bound in an enclosing function scope), ``"attribute"``
    (an attribute chain such as ``self._base``), ``"constant"``,
    ``"call"`` (``node`` is the Call), ``"free"`` (a module global,
    builtin or undefined name) or ``"opaque"`` (anything else).
    """

    kind: str
    node: ast.AST
    name: str = ""


# ------------------------------------------------------ enclosing scopes

def _enclosing_scopes(fn: FuncInfo) -> List[FuncInfo]:
    """Enclosing FuncInfos, innermost first, by qualname prefix."""
    out: List[FuncInfo] = []
    qn = fn.qualname
    while "." in qn:
        qn = qn.rsplit(".", 1)[0]
        parent = fn.module.functions.get(qn)
        if parent is not None:
            out.append(parent)
    return out


def provenance_chain(
    fn: FuncInfo,
    du: DefUse,
    expr: ast.AST,
    *,
    through: Callable[[ast.Call], Optional[ast.AST]] = lambda c: None,
    _depth: int = 0,
) -> Origin:
    """Chase ``expr`` backwards through the def-use chains to its
    origin.  ``through(call)`` declares derivation calls transparent:
    it returns the operand to keep chasing (``fold_in(rng, i)`` ->
    ``rng``), or None to stop at the call."""
    if _depth > 32:
        return Origin("opaque", expr)
    if isinstance(expr, ast.Name):
        b = du.reaching_def(expr)
        if b is None:
            if not du.is_local(expr.id):
                for enc in _enclosing_scopes(fn):
                    if DefUse(enc).is_local(expr.id):
                        return Origin("enclosing", expr, expr.id)
            return Origin("free", expr, expr.id)
        if b.kind == "param":
            return Origin("param", expr, expr.id)
        if b.value is None:
            return Origin("opaque", expr, expr.id)
        return provenance_chain(
            fn, du, b.value, through=through, _depth=_depth + 1
        )
    if isinstance(expr, ast.Call):
        onward = through(expr)
        if onward is not None:
            return provenance_chain(
                fn, du, onward, through=through, _depth=_depth + 1
            )
        return Origin("call", expr)
    if isinstance(expr, ast.Attribute):
        return Origin("attribute", expr)
    if isinstance(expr, ast.Constant):
        return Origin("constant", expr)
    return Origin("opaque", expr)


# -------------------------------------------------- call-graph closure

def expand_call_closure(
    modules: List[ModuleInfo],
    ctx,  # CheckContext (duck-typed: only ctx.index.resolve_call used)
    seeds: List[FuncInfo],
    add: Callable[[FuncInfo, str], bool],
) -> None:
    """Close a seed set over nested defs + the intra-package call
    graph.  ``add(fn, reason)`` must return True exactly when ``fn``
    was newly admitted (drives the worklist); the reasons read
    ``"nested in traced <qualname>"`` /
    ``"called from traced <rel>::<qualname>"`` (the JAX package's
    wording, so a finding's text is the same in both engines).
    """
    work = list(seeds)
    while work:
        fn = work.pop()
        mi = fn.module
        prefix = fn.qualname + "."
        for qn, sub in mi.functions.items():
            if qn.startswith(prefix) and add(
                sub, f"nested in traced {fn.qualname}"
            ):
                work.append(sub)
        for call in (
            n for n in walk_body(fn) if isinstance(n, ast.Call)
        ):
            for callee in ctx.index.resolve_call(mi, fn, call):
                if add(
                    callee,
                    f"called from traced {mi.rel}::{fn.qualname}",
                ):
                    work.append(callee)
