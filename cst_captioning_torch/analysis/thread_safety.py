"""CST-THR: static thread-safety pass over the serving layer.

The serving stack is ~20 lock/thread sites across 9 files: HTTP handler
threads (one per in-flight request), one or N scheduler threads, control
callers (``stop``/``shutdown``/``kill_replica``), all sharing batcher
queues, replica tables, metrics, and caches.  Nothing checked ordering
or guarding until now.  Two rules:

* CST-THR-001 — **lock-order inversion**: build the static
  lock-acquisition graph — which locks are HELD (``with lock:`` /
  ``.acquire()`` AST shapes, propagated through the intra-serving call
  graph) when other locks are acquired — and flag any cycle.  Two locks
  ever taken in both orders on different paths is a latent deadlock
  regardless of how rarely the paths race.  The dynamic twin
  (``analysis/lockwatch.py``) asserts the same acyclicity on the REAL
  acquisition order under stub traffic in the tests and under replica
  traffic on the card.
* CST-THR-002 — **unguarded shared-state mutation**: an instance
  attribute written with NO lock held in a method reachable from a
  concurrent entry point (HTTP handlers, ``submit``, multi-instance
  worker threads, external control calls) — or from two different
  entry points — is a data race unless the owning object is
  single-owner by contract.  Classes may declare that contract in
  source (``_analysis_single_owner = True``), which both silences the
  rule for their attributes and documents the ownership model where
  the next reader needs it.

Entry-point model: a function passed to ``threading.Thread(target=…)``
is a worker root — MULTI when the Thread is constructed inside a loop
(one thread per replica), SINGLE otherwise; ``do_GET``/``do_POST`` and
the public submit/control surface are MULTI (any number of caller
threads).  Reachability propagates the set of held locks along call
edges, so a write inside a method only ever called under ``self._cond``
is correctly seen as guarded.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from cst_captioning_torch.analysis.astutil import (
    FuncInfo,
    ModuleInfo,
    call_name,
    dotted,
    walk_body,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

# Files the pass covers (training/rewards.py is a PROCESS pool —
# apply_async + get, no shared-memory threading — and stays out).
SCOPE_PREFIXES = ("serving/",)

_LOCK_CTORS = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
}

# Public surface callable from arbitrary threads.  Method name -> why.
EXTERNAL_ROOTS: Dict[str, str] = {
    "submit": "HTTP handler threads (one per in-flight request)",
    "stop": "external control callers",
    "shutdown": "SIGTERM thread / context exits / serve_forever finally",
    "begin_drain": "external control callers",
    "kill_replica": "operational control callers",
}
_HANDLER_ROOTS = {"do_GET", "do_POST"}


@dataclass
class MethodFacts:
    fn: FuncInfo
    cls: str
    # (lock_id, line, locks-held-at-acquisition-site)
    acquisitions: List[Tuple[str, int, FrozenSet[str]]] = field(
        default_factory=list
    )
    # (owner_class, attr, line, locks-held)
    writes: List[Tuple[str, str, int, FrozenSet[str]]] = field(
        default_factory=list
    )
    # (callee FuncInfo, locks-held-at-call)
    calls: List[Tuple[FuncInfo, FrozenSet[str]]] = field(
        default_factory=list
    )


class _World:
    """Everything the two rules need, extracted in one pass."""

    def __init__(self, modules: List[ModuleInfo], ctx: CheckContext):
        self.modules = [
            m for m in modules if m.rel.startswith(SCOPE_PREFIXES)
        ]
        self.ctx = ctx
        # "Class.attr" lock ids, from self.<attr> = threading.Lock()
        self.locks: Set[str] = set()
        # attr name -> owning classes (from __init__/__slots__ writes)
        self.attr_owner: Dict[str, Set[str]] = {}
        # attr of a class -> inferred class of the attribute value
        # (self.router = Router(...) -> {"ReplicaSet.router": "Router"})
        self.attr_class: Dict[str, str] = {}
        self.single_owner: Set[str] = set()
        self.class_bases: Dict[str, List[str]] = {}
        self.methods: Dict[Tuple[str, str], MethodFacts] = {}
        # (class name, method name) -> FuncInfo, for receiver-typed
        # call resolution (self.metrics.replica -> ServingMetrics.replica)
        self.cls_methods: Dict[Tuple[str, str], FuncInfo] = {}
        for mi in self.modules:
            for qn, fn in mi.functions.items():
                if fn.cls is not None:
                    self.cls_methods[(fn.cls, fn.name)] = fn
        self._collect_classes()
        self._collect_methods()

    # ------------------------------------------------------------ classes
    def _collect_classes(self) -> None:
        for mi in self.modules:
            for cname, cnode in mi.classes.items():
                self.class_bases[cname] = [
                    dotted(b).split(".")[-1] for b in cnode.bases
                ]
                for stmt in cnode.body:
                    # _analysis_single_owner = True marker
                    if (
                        isinstance(stmt, ast.Assign)
                        and any(
                            isinstance(t, ast.Name)
                            and t.id == "_analysis_single_owner"
                            for t in stmt.targets
                        )
                        and isinstance(stmt.value, ast.Constant)
                        and stmt.value.value is True
                    ):
                        self.single_owner.add(cname)
                    # __slots__ attribute ownership
                    if (
                        isinstance(stmt, ast.Assign)
                        and any(
                            isinstance(t, ast.Name) and t.id == "__slots__"
                            for t in stmt.targets
                        )
                        and isinstance(stmt.value, (ast.Tuple, ast.List))
                    ):
                        for el in stmt.value.elts:
                            if isinstance(el, ast.Constant):
                                self.attr_owner.setdefault(
                                    str(el.value), set()
                                ).add(cname)
                init = mi.functions.get(f"{cname}.__init__")
                if init is None:
                    continue
                for node in walk_body(init):
                    if not isinstance(node, ast.Assign):
                        continue
                    for t in node.targets:
                        if not (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            continue
                        self.attr_owner.setdefault(t.attr, set()).add(cname)
                        v = node.value
                        vname = (
                            call_name(v) if isinstance(v, ast.Call) else ""
                        )
                        if vname in _LOCK_CTORS:
                            self.locks.add(f"{cname}.{t.attr}")
                        # self.x = C(...) / self.x = y or C(...)
                        ctor = ""
                        if isinstance(v, ast.Call):
                            ctor = vname.split(".")[-1]
                        elif isinstance(v, ast.BoolOp) and isinstance(
                            v.op, ast.Or
                        ):
                            for alt in v.values:
                                if isinstance(alt, ast.Call):
                                    ctor = call_name(alt).split(".")[-1]
                        if ctor and ctor.lstrip("_")[:1].isupper():
                            self.attr_class[f"{cname}.{t.attr}"] = ctor

        # inherited locks/attrs: subclasses own their bases' locks
        for cname, bases in self.class_bases.items():
            for b in bases:
                for lock in list(self.locks):
                    owner, attr = lock.split(".", 1)
                    if owner == b:
                        self.locks.add(f"{cname}.{attr}")
                for attr, owners in self.attr_owner.items():
                    if b in owners:
                        owners.add(cname)

    def lock_id(self, cls: Optional[str], attr: str) -> Optional[str]:
        """Canonical lock id for self.<attr> in class ``cls`` — bases'
        locks canonicalize to the BASE class (one shared graph node for
        _BatcherBase._cond across its subclasses)."""
        if cls is None:
            return None
        seen, stack = set(), [cls]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            stack.extend(self.class_bases.get(c, []))
        # the DEFINING base wins so one graph node covers the lock
        # across subclasses (_BatcherBase._cond, not MicroBatcher._cond)
        owners = [
            c for c in sorted(seen) if f"{c}.{attr}" in self.locks
        ]
        if not owners:
            return None
        base_cands = [
            c for c in owners
            if any(c in self.class_bases.get(c2, ())
                   for c2 in owners if c2 != c)
        ]
        pick = sorted(base_cands or owners)[0]
        return f"{pick}.{attr}"

    # ------------------------------------------------------------ methods
    def _collect_methods(self) -> None:
        for mi in self.modules:
            for qn, fn in mi.functions.items():
                if fn.cls is None:
                    continue
                mf = MethodFacts(fn=fn, cls=fn.cls)
                self.methods[(mi.rel, qn)] = mf
                self._walk_method(mi, fn, mf)

    def _self_lock(self, mf: MethodFacts, expr: ast.AST) -> Optional[str]:
        """self.<attr> (or bare name aliasing a self lock attr is not
        tracked) resolving to a known lock id."""
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            return self.lock_id(mf.cls, expr.attr)
        # obj.attr where obj's class was inferred from __init__
        if isinstance(expr, ast.Attribute):
            recv_cls = self._recv_class(mf, expr.value)
            if recv_cls is not None:
                return self.lock_id(recv_cls, expr.attr)
        return None

    def _attr_class_mro(self, cls: str, attr: str) -> Optional[str]:
        stack, seen = [cls], set()
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            got = self.attr_class.get(f"{c}.{attr}")
            if got:
                return got
            stack.extend(self.class_bases.get(c, []))
        return None

    def _recv_class(self, mf: MethodFacts, recv: ast.AST) -> Optional[str]:
        """Inferred class of a receiver expression, recursively through
        attribute chains: ``self.metrics`` -> ServingMetrics,
        ``self.metrics.requests_total`` -> Counter (via the __init__
        constructor map)."""
        if isinstance(recv, ast.Name):
            return None  # locals are untyped; the unique-attr fallback
        if isinstance(recv, ast.Attribute):
            if (
                isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
            ):
                return self._attr_class_mro(mf.cls, recv.attr)
            inner = self._recv_class(mf, recv.value)
            if inner is not None:
                return self._attr_class_mro(inner, recv.attr)
        return None

    def _walk_method(
        self, mi: ModuleInfo, fn: FuncInfo, mf: MethodFacts
    ) -> None:
        def walk(node: ast.AST, held: FrozenSet[str]) -> None:
            if isinstance(node, ast.With):
                inner = held
                for item in node.items:
                    lid = self._self_lock(mf, item.context_expr)
                    if lid is not None:
                        mf.acquisitions.append(
                            (lid, item.context_expr.lineno, inner)
                        )
                        inner = inner | {lid}
                for stmt in node.body:
                    walk(stmt, inner)
                return
            if isinstance(node, ast.Call):
                if (
                    call_name(node).endswith(".acquire")
                    and isinstance(node.func, ast.Attribute)
                ):
                    lid = self._self_lock(mf, node.func.value)
                    if lid is not None:
                        mf.acquisitions.append((lid, node.lineno, held))
                callees = self.ctx.index.resolve_call(mi, fn, node)
                if not callees and isinstance(node.func, ast.Attribute):
                    # receiver-typed resolution: obj.m() where obj's
                    # class is inferable from the __init__ ctor map
                    recv_cls = self._recv_class(mf, node.func.value)
                    if recv_cls is not None:
                        got = self.cls_methods.get(
                            (recv_cls, node.func.attr)
                        )
                        if got is not None:
                            callees = [got]
                for callee in callees:
                    mf.calls.append((callee, held))
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    base = t
                    # unwrap subscript stores: self.d[k] = v mutates d
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    if not isinstance(base, ast.Attribute):
                        continue
                    owner: Optional[str] = None
                    if (
                        isinstance(base.value, ast.Name)
                        and base.value.id == "self"
                    ):
                        owner = mf.cls
                    else:
                        owner = self._recv_class(mf, base.value)
                        if owner is None and isinstance(
                            base.value, ast.Name
                        ):
                            # unique-attr fallback: rep.healthy ->
                            # Replica when exactly one class owns it
                            owners = self.attr_owner.get(base.attr, set())
                            if len(owners) == 1:
                                owner = next(iter(owners))
                    if owner is not None:
                        mf.writes.append(
                            (owner, base.attr, base.lineno, held)
                        )
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                return
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        if isinstance(fn.node, ast.Lambda):
            return
        for stmt in fn.node.body:
            walk(stmt, frozenset())


# ------------------------------------------------------------ entry roots

def _collect_roots(world: _World) -> Dict[Tuple[str, str], Tuple[str, str]]:
    """(module rel, qualname) -> (kind, why).  kind: "multi" | "single"."""
    roots: Dict[Tuple[str, str], Tuple[str, str]] = {}
    for mi in world.modules:
        for qn, fn in mi.functions.items():
            if fn.cls is not None and fn.name in _HANDLER_ROOTS:
                roots[(mi.rel, qn)] = (
                    "multi", "HTTP handler (thread per request)"
                )
            if fn.cls is not None and fn.name in EXTERNAL_ROOTS:
                roots[(mi.rel, qn)] = ("multi", EXTERNAL_ROOTS[fn.name])
        for node in ast.walk(mi.tree):
            if not (
                isinstance(node, ast.Call)
                and call_name(node) in (
                    "threading.Thread", "Thread",
                )
            ):
                continue
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None:
                continue
            tname = dotted(target)
            if not tname.startswith("self."):
                continue
            # worker multiplicity: Thread() constructed inside a loop
            # => one thread per item => MULTI entry
            multi = False
            cur = mi.parent.get(node)
            while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                if isinstance(cur, (ast.For, ast.While)):
                    multi = True
                cur = mi.parent.get(cur)
            encl = mi.qualname_of(node)
            cls = encl.split(".")[0] if "." in encl else None
            if cls is None:
                continue
            mname = tname.split(".", 1)[1]
            qn = f"{cls}.{mname}"
            if qn in mi.functions:
                kind = "multi" if multi else "single"
                # never downgrade an already-multi root (a method can be
                # both a thread target and public control surface)
                if roots.get((mi.rel, qn), ("", ""))[0] != "multi":
                    roots[(mi.rel, qn)] = (
                        kind,
                        "thread target "
                        + ("(per-replica workers)" if multi
                           else "(scheduler thread)"),
                    )
    return roots


# ------------------------------------------------------------------ rules

def _reachability(
    world: _World,
    roots: Dict[Tuple[str, str], Tuple[str, str]],
):
    """BFS over (method, held-locks) states from every root.

    Returns (write_roots, edges):
    * write_roots: (owner_cls, attr) -> {root_key: (file, line, qualname)}
      for writes seen with NO lock held;
    * edges: lock digraph {(A, B): (file, line, qualname)} — B acquired
      while A held.
    """
    write_roots: Dict[Tuple[str, str], Dict] = {}
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    for root_key, _ in roots.items():
        seen: Set[Tuple[str, str, FrozenSet[str]]] = set()
        stack: List[Tuple[Tuple[str, str], FrozenSet[str]]] = [
            (root_key, frozenset())
        ]
        while stack:
            (rel, qn), held = stack.pop()
            state = (rel, qn, held)
            if state in seen:
                continue
            seen.add(state)
            mf = world.methods.get((rel, qn))
            if mf is None:
                continue
            for lid, line, local_held in mf.acquisitions:
                for a in held | local_held:
                    if a != lid:
                        edges.setdefault((a, lid), (rel, line, qn))
            for owner, attr, line, local_held in mf.writes:
                if qn.endswith("__init__"):
                    continue
                if owner in world.single_owner:
                    continue
                if not (held | local_held):
                    write_roots.setdefault((owner, attr), {})[root_key] = (
                        rel, line, qn
                    )
            for callee, local_held in mf.calls:
                stack.append((
                    (callee.module.rel, callee.qualname),
                    held | local_held,
                ))
    return write_roots, edges


def _find_cycles(
    edges: Dict[Tuple[str, str], Tuple[str, int, str]]
) -> List[List[str]]:
    graph: Dict[str, Set[str]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    cycles: List[List[str]] = []
    color: Dict[str, int] = {}
    path: List[str] = []

    def dfs(n: str) -> None:
        color[n] = 1
        path.append(n)
        for m in sorted(graph[n]):
            if color.get(m, 0) == 0:
                dfs(m)
            elif color.get(m) == 1:
                cyc = path[path.index(m):] + [m]
                if not any(set(cyc) == set(c) for c in cycles):
                    cycles.append(cyc)
        path.pop()
        color[n] = 2

    for n in sorted(graph):
        if color.get(n, 0) == 0:
            dfs(n)
    return cycles


@register_checker("thread_safety")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    world = _World(modules, ctx)
    roots = _collect_roots(world)
    write_roots, edges = _reachability(world, roots)
    out: List[Finding] = []

    for cyc in _find_cycles(edges):
        pairs = list(zip(cyc, cyc[1:]))
        sites = "; ".join(
            f"{a}->{b} at {edges[(a, b)][0]}:{edges[(a, b)][1]}"
            for a, b in pairs
            if (a, b) in edges
        )
        rel, line, qn = edges[pairs[0]] if pairs[0] in edges else (
            "serving/", 1, "<graph>"
        )
        out.append(Finding(
            "CST-THR-001", rel, line, qn,
            "lock-order inversion: cycle "
            + " -> ".join(cyc) + f" ({sites}) — two locks taken in "
            "both orders on different paths is a latent deadlock; "
            "pick one global order",
        ))

    for (owner, attr), by_root in sorted(write_roots.items()):
        kinds = {roots[rk][0] for rk in by_root}
        if "multi" in kinds or len(by_root) >= 2:
            rel, line, qn = sorted(by_root.values())[0]
            whys = sorted(
                f"{rk[1]} [{roots[rk][0]}]" for rk in by_root
            )
            out.append(Finding(
                "CST-THR-002", rel, line, qn,
                f"`{owner}.{attr}` is mutated with no lock held, "
                f"reachable from concurrent entry point(s): "
                f"{', '.join(whys)} — guard the write, or declare the "
                "owning class `_analysis_single_owner = True` if one "
                "thread owns it by contract",
            ))
    return out
