"""CST-JIT: host-state and control-flow audit of traced code.

A function that ``torch.compile`` traces, that TorchScript scripts or
traces, or that a CUDA graph captures is run once to build a graph
that is then replayed: a host decision inside it (a clock read, a host
random draw, a print, a ``.item()`` sync, a Python branch on a tensor's
value) is baked into the graph, or breaks it, silently.  This checker:

1. collects every traced ROOT — a function decorated with
   ``@torch.compile`` (bare, called, or through ``functools.partial``),
   ``@torch.jit.script`` / ``@torch.jit.trace``; a function or lambda
   passed to ``torch.compile(fn, ...)``, ``torch.jit.script`` /
   ``trace``, or ``torch.cuda.make_graphed_callables(fn, ...)``; and
   every package function called inside the body of a
   ``with torch.cuda.graph(g):`` capture (the body itself is checked as
   traced code too);
2. expands the traced set over the package call graph (nested defs,
   class construction, ``super()``, ``Fn.apply`` -> ``forward``);
3. inside traced code flags:

   * CST-JIT-001 — host state: ``time.*``, host RNG (``np.random.*``,
     stdlib ``random.*``), ``print``, ``.item()`` / ``.tolist()`` /
     ``.cpu()`` / ``.numpy()``, ``torch.cuda.synchronize``;
   * CST-JIT-002 — a Python ``if`` / ``while`` / ternary on a root's
     tensor parameter.  The host-static tests are exempt (``is None``,
     ``isinstance``, ``.shape`` / ``.ndim`` / ``.dtype`` reads, string
     compares, ``self`` config reads), and torch has no
     ``static_argnums``: a parameter annotated, or defaulted, as a
     Python ``bool`` / ``int`` / ``str`` is a guarded constant, static;
   * CST-JIT-003 — iteration over a ``set`` (hash-seed order: a
     nondeterministic trace).

The port has no traced root today (its kernels are hand-written and
launched eagerly), so on its own source the traced set is empty; the
rules guard the day one is added, and CST-OBS-003 / CST-RES-003 and
CST-SHP-003 read the same set.  CST-JIT-002 is a heuristic by
construction; a false positive goes in the suppression file with its
justification.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cst_captioning_torch.analysis.astutil import (
    FuncInfo,
    ModuleInfo,
    call_name,
    dotted,
    resolved,
    resolved_call,
    walk_body,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

# Resolved callees that trace (or capture) their function argument.
TRACERS = frozenset({
    "torch.compile",
    "torch.jit.script",
    "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
})
GRAPH_CAPTURE = frozenset({"torch.cuda.graph"})
_PARTIAL_NAMES = frozenset({"functools.partial", "partial"})

_HOST_CALL_PREFIXES = ("time.", "numpy.random.", "np.random.", "random.")
_HOST_CALLS = frozenset({"print", "torch.cuda.synchronize"})
_HOST_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy"})

# Test shapes that are host-static even when they mention a parameter.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device"}
_STATIC_CALLS = {"isinstance", "len", "hasattr", "getattr", "callable"}
# Parameters torch.compile guards on as Python constants.
_STATIC_TYPES = frozenset({"bool", "int", "str"})


def _tracer(mi: ModuleInfo, node: ast.AST) -> Optional[str]:
    """The resolved tracer a decorator or callee expression applies,
    else None: ``torch.compile``, ``torch.compile(...)``,
    ``functools.partial(torch.compile, ...)``."""
    name = resolved(mi, dotted(node))
    if name in TRACERS:
        return name
    if isinstance(node, ast.Call):
        name = resolved_call(mi, node)
        if name in TRACERS:
            return name
        if name in _PARTIAL_NAMES and node.args:
            inner = resolved(mi, dotted(node.args[0]))
            if inner in TRACERS:
                return inner
    return None


def static_params(fn: FuncInfo) -> Set[str]:
    """Parameters annotated or defaulted as a Python bool / int / str."""
    a = fn.node.args
    if not isinstance(fn.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set()
    out: Set[str] = set()
    pos = a.posonlyargs + a.args
    defaults: Dict[str, ast.AST] = dict(
        zip([p.arg for p in pos][len(pos) - len(a.defaults):], a.defaults)
    )
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            defaults[p.arg] = d
    for p in pos + a.kwonlyargs:
        ann = p.annotation
        if ann is not None and (
            (isinstance(ann, ast.Name) and ann.id in _STATIC_TYPES)
            or (isinstance(ann, ast.Constant) and ann.value in _STATIC_TYPES)
        ):
            out.add(p.arg)
            continue
        d = defaults.get(p.arg)
        if isinstance(d, ast.Constant) and isinstance(
            d.value, (bool, int, str)
        ):
            out.add(p.arg)
    return out


class TracedSet:
    """Traced functions, the roots among them, and the captured
    ``with torch.cuda.graph(...)`` bodies."""

    def __init__(self) -> None:
        self.reason: Dict[Tuple[str, str], str] = {}
        # ROOTS: the function IS the trace boundary, so every non-static
        # parameter is a tensor the graph is built on (CST-JIT-002 is
        # judged only here; a callee's parameters are usually host
        # config).
        self.roots: Set[Tuple[str, str]] = set()
        self.regions: List[Tuple[ModuleInfo, ast.With]] = []

    @staticmethod
    def key(fn: FuncInfo) -> Tuple[str, str]:
        return (fn.module.rel, fn.qualname)

    def add(self, fn: FuncInfo, reason: str, *, root: bool = False) -> bool:
        k = self.key(fn)
        if root:
            self.roots.add(k)
        if k in self.reason:
            return False
        self.reason[k] = reason
        return True

    def __contains__(self, fn: FuncInfo) -> bool:
        return self.key(fn) in self.reason

    def functions(self, modules: List[ModuleInfo]) -> List[FuncInfo]:
        by_mod = {m.rel: m for m in modules}
        return [
            by_mod[rel].functions[qn]
            for rel, qn in sorted(self.reason)
            if rel in by_mod and qn in by_mod[rel].functions
        ]


def _target_fn(
    mi: ModuleInfo, node: ast.AST, target: ast.AST
) -> Optional[FuncInfo]:
    """The function a tracer call's first argument names: a def in the
    enclosing scope chain or at module level, a lambda, or
    ``self.method``."""
    if isinstance(target, ast.Lambda):
        return next(
            (fn for fn in mi.functions.values() if fn.node is target), None
        )
    scope = mi.qualname_of(node)
    if isinstance(target, ast.Name):
        parts = scope.split(".") if scope != "<module>" else []
        for i in range(len(parts), -1, -1):
            qn = ".".join(parts[:i] + [target.id])
            if qn in mi.functions:
                return mi.functions[qn]
        return None
    name = dotted(target)
    if name.startswith("self.") and name.count(".") == 1:
        fn = mi.functions.get(scope)
        if fn is not None and fn.cls is not None:
            return mi.functions.get(f"{fn.cls}.{name[5:]}")
    return None


def collect_roots(modules: List[ModuleInfo], ctx: CheckContext,
                  traced: TracedSet) -> None:
    for mi in modules:
        for fn in mi.functions.values():
            if isinstance(fn.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in fn.node.decorator_list:
                    name = _tracer(mi, dec)
                    if name is not None:
                        traced.add(fn, f"@{name}", root=True)
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call) and node.args:
                name = resolved_call(mi, node)
                if name in TRACERS:
                    fn = _target_fn(mi, node, node.args[0])
                    if fn is not None:
                        traced.add(fn, f"{name}(...) call", root=True)
            elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call)
                and resolved_call(mi, it.context_expr) in GRAPH_CAPTURE
                for it in node.items
            ):
                traced.regions.append((mi, node))
                caller = mi.functions.get(mi.qualname_of(node))
                if caller is None:
                    continue
                for n in _region_nodes(node):
                    if isinstance(n, ast.Call):
                        for callee in ctx.index.resolve_call(mi, caller, n):
                            traced.add(callee, "captured by torch.cuda.graph",
                                       root=True)


def _region_nodes(region: ast.With):
    """Every node of a capture body, nested defs excluded."""
    stack = list(region.body)
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def expand(modules: List[ModuleInfo], ctx: CheckContext,
           traced: TracedSet) -> None:
    """Close the traced set over nested defs and the package call graph
    (the shared :func:`dataflow.expand_call_closure` worklist)."""
    from cst_captioning_torch.analysis.dataflow import expand_call_closure

    def admit(fn: FuncInfo, reason: str) -> bool:
        return traced.add(fn, reason)

    expand_call_closure(modules, ctx, traced.functions(modules), admit)


_CACHE: List[Tuple[object, TracedSet]] = []


def traced_set(modules: List[ModuleInfo], ctx: CheckContext) -> TracedSet:
    """The traced set of a scan, built once per module list (CST-JIT,
    CST-OBS-003, CST-RES-003 and the type flow share it)."""
    for obj, ts in _CACHE:
        if obj is modules:
            return ts
    ts = TracedSet()
    collect_roots(modules, ctx, ts)
    expand(modules, ctx, ts)
    _CACHE[:] = [(modules, ts)]
    return ts


def traced_nodes(modules: List[ModuleInfo], ctx: CheckContext):
    """``(module, symbol, reason, nodes)`` for every traced function
    body and every captured region: what the host-side-only rules
    (CST-JIT-001/003, CST-OBS-003, CST-RES-003) walk."""
    ts = traced_set(modules, ctx)
    for fn in ts.functions(modules):
        yield fn.module, fn, ts.reason[ts.key(fn)], walk_body(fn)
    for mi, region in ts.regions:
        fn = mi.functions.get(mi.qualname_of(region))
        if fn is not None:
            yield mi, fn, "captured by torch.cuda.graph", _region_nodes(region)


def _test_is_static(test: ast.AST) -> bool:
    """Host-static test shapes: shape/dtype reads, None checks,
    isinstance/len, string-constant comparisons."""
    for node in ast.walk(test):
        if isinstance(node, ast.Compare):
            if any(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in node.ops
            ):
                return True
            sides = [node.left, *node.comparators]
            if any(
                isinstance(s, ast.Constant) and isinstance(s.value, str)
                for s in sides
            ):
                return True
            if any(
                isinstance(s, (ast.Tuple, ast.List))
                and all(isinstance(e, ast.Constant) for e in s.elts)
                for s in sides
            ):
                return True
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return True
        if isinstance(node, ast.Call) and call_name(node) in _STATIC_CALLS:
            return True
    return False


def _traced_param_in_test(
    test: ast.AST, fn: FuncInfo, static_names: Set[str]
) -> Optional[str]:
    params = {
        p for p in fn.params
        if p not in ("self", "cls") and p not in static_names
    }
    for node in ast.walk(test):
        if isinstance(node, ast.Name) and node.id in params:
            return node.id
    return None


def _host_call(mi: ModuleInfo, node: ast.Call) -> Optional[str]:
    """What makes ``node`` a host-state call inside traced code."""
    name = resolved_call(mi, node)
    if name in _HOST_CALLS or name.startswith(_HOST_CALL_PREFIXES):
        return f"`{call_name(node)}(...)`"
    if (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _HOST_SYNC_ATTRS
        and not node.args and not node.keywords
    ):
        return f"`.{node.func.attr}()`"
    return None


@register_checker("jit_boundary")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    ts = traced_set(modules, ctx)
    out: List[Finding] = []
    for mi, fn, reason, nodes in traced_nodes(modules, ctx):
        qn = fn.qualname
        root = ts.key(fn) in ts.roots
        statics = static_params(fn) if root else set()
        for node in nodes:
            if isinstance(node, ast.Call):
                what = _host_call(mi, node)
                if what is not None:
                    out.append(Finding(
                        "CST-JIT-001", mi.rel, node.lineno, qn,
                        f"host-state call {what} inside traced code "
                        f"({reason}) — its value is baked into the graph "
                        "(or breaks it); hoist it out of the traced "
                        "function or pass it in as a tensor",
                    ))
            if root and isinstance(node, (ast.If, ast.While, ast.IfExp)):
                test = node.test
                if not _test_is_static(test):
                    p = _traced_param_in_test(test, fn, statics)
                    if p is not None:
                        out.append(Finding(
                            "CST-JIT-002", mi.rel, test.lineno, qn,
                            f"Python `{type(node).__name__.lower()}` on "
                            f"parameter `{p}` inside traced code — the "
                            "branch taken at trace time is replayed for "
                            "every value; use torch.where, or annotate "
                            "the parameter as a Python bool / int / str",
                        ))
            if isinstance(node, (ast.For, ast.comprehension)):
                it = node.iter
                if isinstance(it, ast.Set) or (
                    isinstance(it, ast.Call) and call_name(it) == "set"
                ):
                    out.append(Finding(
                        "CST-JIT-003", mi.rel, it.lineno, qn,
                        "iteration over a set inside traced code — set "
                        "order is hash-seed dependent, so the traced "
                        "graph is nondeterministic; sort it",
                    ))
    return out
