"""CST-EXC: silent-exception audit of the threaded serving/training
surface.

A worker or scheduler thread that swallows ``Exception`` dies SILENTLY
— the queue backs up, deadlines expire, and the flight recorder built
to explain crashes records nothing, because nothing crashed.
The same failure mode hides in thread-target functions whose
exceptions escape the target: ``threading`` prints them to stderr (if
anything) and the thread is simply gone.  Two rules over the
:mod:`analysis.dataflow` call-graph closure:

* CST-EXC-001 — a ``try/except`` catching ``Exception``/
  ``BaseException``/bare that neither re-raises, logs, emits a flight
  event, nor ROUTES the caught exception onward (referencing the
  bound name — the ``_settle_exception(p, e)`` / poison-pill ``_put(e)``
  patterns), on code reachable from the concurrency roots: package
  ``threading.Thread`` targets, HTTP handler methods, the
  ``RewardPool`` and its worker module.
* CST-EXC-002 — a package function used as a ``Thread`` target whose
  body is not exception-contained: some top-level statement sits
  outside every ``try`` that has a broad, non-silent handler, so an
  exception there escapes the thread unlogged.  (Lambda targets must
  delegate to a contained function.)

Both rules are scoped to the reachable set on purpose: a broad
``except`` on a REQUEST path that maps failures to HTTP 500s, or a
best-effort ``__del__``, answers to different contracts.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cst_captioning_torch.analysis.astutil import (
    FuncInfo,
    ModuleInfo,
    call_name,
    dotted,
    walk_body,
)
from cst_captioning_torch.analysis.dataflow import expand_call_closure
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

_THREAD_CTORS = {"threading.Thread", "Thread"}
_LOG_METHODS = {
    "debug", "info", "warning", "warn", "error", "exception",
    "critical", "log",
}
_FLIGHT_METHODS = {"event", "dump"}
# The reward-scoring pool: worker death here is exactly the silent
# failure the rules exist for (rows never come back, training hangs).
_POOL_FILES = ("training/rewards.py", "metrics/reward_worker.py")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Tuple):
        names = [dotted(e) for e in t.elts]
    else:
        names = [dotted(t)]
    return any(
        n.split(".")[-1] in ("Exception", "BaseException") for n in names
    )


def _handler_is_silent(handler: ast.ExceptHandler) -> bool:
    """Whether a handler swallows: no raise, no logging-flavored call,
    no flight event, and the bound exception name (if any) is never
    referenced (referencing it routes the failure onward)."""
    bound = handler.name
    for node in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Name) and bound and node.id == bound:
            return False
        if isinstance(node, ast.Call):
            name = call_name(node)
            parts = name.split(".") if name else []
            if parts and parts[-1] in _LOG_METHODS and (
                len(parts) == 1
                or any(
                    "log" in p.lower() or "warn" in p.lower()
                    for p in parts[:-1]
                )
                or isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Call)
            ):
                return False
            if name in ("warnings.warn", "traceback.print_exc"):
                return False
            if isinstance(node.func, ast.Attribute) and (
                node.func.attr in _FLIGHT_METHODS
                and "flight" in dotted(node.func.value).lower()
            ):
                return False
    return True


def _resolve_target(
    mi: ModuleInfo, node: ast.AST, scope_qn: str
) -> Optional[FuncInfo]:
    """Resolve a ``Thread(target=X)`` expression to a package
    function: local/enclosing names, ``self.method`` (enclosing class
    from the qualname chain), and lambdas."""
    if isinstance(node, ast.Lambda):
        for fn in mi.functions.values():
            if fn.node is node:
                return fn
        return None
    name = dotted(node)
    if not name:
        return None
    head, _, rest = name.partition(".")
    if head == "self" and rest and "." not in rest:
        for seg in scope_qn.split("."):
            if seg in mi.classes:
                return mi.functions.get(f"{seg}.{rest}")
        return None
    if not rest:
        # plain name: innermost enclosing scope first
        parts = scope_qn.split(".") if scope_qn != "<module>" else []
        for i in range(len(parts), -1, -1):
            qn = ".".join(parts[:i] + [head]) if i else head
            fn = mi.functions.get(qn)
            if fn is not None:
                return fn
    return None


def thread_targets(
    modules: List[ModuleInfo],
) -> List[Tuple[ModuleInfo, ast.Call, Optional[FuncInfo]]]:
    """Every ``threading.Thread(...)`` construction with its resolved
    package target (None for stdlib/unresolvable targets).  The tests'
    vacuous-green guard pins that this finds the real serving worker
    threads."""
    out = []
    for mi in modules:
        for node in ast.walk(mi.tree):
            if not (
                isinstance(node, ast.Call)
                and call_name(node) in _THREAD_CTORS
            ):
                continue
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    target = kw.value
            if target is None and len(node.args) >= 2:
                target = node.args[1]
            if target is None:
                continue
            fn = _resolve_target(mi, target, mi.qualname_of(node))
            out.append((mi, node, fn))
    return out


def collect_roots(
    modules: List[ModuleInfo],
) -> Dict[Tuple[str, str], str]:
    """Concurrency roots: thread targets, HTTP ``do_*`` handler
    methods, and the reward pool + its worker module."""
    roots: Dict[Tuple[str, str], str] = {}
    for mi, node, fn in thread_targets(modules):
        if fn is not None:
            roots.setdefault(
                (mi.rel, fn.qualname),
                f"Thread target at {mi.rel}:{node.lineno}",
            )
    for mi in modules:
        for qn, fn in mi.functions.items():
            if fn.cls is not None and fn.name.startswith("do_"):
                roots.setdefault(
                    (mi.rel, qn), "HTTP handler thread"
                )
            if mi.rel in _POOL_FILES and (
                fn.cls == "RewardPool" or mi.rel.endswith(
                    "reward_worker.py"
                )
            ):
                roots.setdefault((mi.rel, qn), "reward pool")
    return roots


def reachable_from_roots(
    modules: List[ModuleInfo], ctx: CheckContext,
) -> Dict[Tuple[str, str], str]:
    """The roots closed over nested defs + the package call graph —
    the CST-JIT traced-set machinery pointed at concurrency roots."""
    roots = collect_roots(modules)
    by_mod = {m.rel: m for m in modules}
    reach: Dict[Tuple[str, str], str] = dict(roots)
    seeds = [
        by_mod[rel].functions[qn]
        for (rel, qn) in roots
        if rel in by_mod and qn in by_mod[rel].functions
    ]

    def admit(fn: FuncInfo, reason: str) -> bool:
        k = (fn.module.rel, fn.qualname)
        if k in reach:
            return False
        reach[k] = reason
        return True

    expand_call_closure(modules, ctx, seeds, admit)
    return reach


def broad_handlers(
    modules: List[ModuleInfo],
) -> List[Tuple[ModuleInfo, FuncInfo, ast.ExceptHandler, bool]]:
    """Every broad ``except`` in every function:
    ``(module, function, handler, is_silent)``."""
    out = []
    for mi in modules:
        for qn, fn in mi.functions.items():
            for node in walk_body(fn):
                if isinstance(node, ast.ExceptHandler) and _is_broad(
                    node
                ):
                    out.append((mi, fn, node, _handler_is_silent(node)))
    return out


def _is_contained(fn: FuncInfo) -> bool:
    """Whether a thread target's body is exception-contained: every
    non-docstring top-level statement sits inside a ``try`` whose
    handlers include a broad, NON-silent one."""
    node = fn.node
    if isinstance(node, ast.Lambda):
        return False
    body = list(node.body)
    if body and isinstance(body[0], ast.Expr) and isinstance(
        body[0].value, ast.Constant
    ) and isinstance(body[0].value.value, str):
        body = body[1:]
    for stmt in body:
        if isinstance(stmt, ast.Try) and any(
            _is_broad(h) and not _handler_is_silent(h)
            for h in stmt.handlers
        ):
            continue
        return False
    return bool(body)


@register_checker("exceptions")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    out: List[Finding] = []
    reach = reachable_from_roots(modules, ctx)

    # ---- EXC-001: silent broad swallow on reachable code -------------
    for mi, fn, handler, silent in broad_handlers(modules):
        if not silent:
            continue
        k = (mi.rel, fn.qualname)
        if k not in reach:
            continue
        out.append(Finding(
            "CST-EXC-001", mi.rel, handler.lineno, fn.qualname,
            "broad `except` swallows the exception on code reachable "
            f"from a concurrency root ({reach[k]}) — a silently dead "
            "worker is exactly what the flight recorder exists to "
            "catch; re-raise, log, emit a flight event, or route the "
            "exception to the submitter",
        ))

    # ---- EXC-002: thread targets must be exception-contained ---------
    seen: Set[Tuple[str, str]] = set()
    for mi, node, fn in thread_targets(modules):
        if fn is None:
            continue
        k = (fn.module.rel, fn.qualname)
        if k in seen:
            continue
        seen.add(k)
        if isinstance(fn.node, ast.Lambda):
            # a lambda target delegating to a contained function is
            # fine; anything else cannot contain exceptions
            body = fn.node.body
            delegate = None
            if isinstance(body, ast.Call):
                delegate = _resolve_target(
                    fn.module, body.func, mi.qualname_of(node)
                )
            if delegate is not None and _is_contained(delegate):
                continue
            out.append(Finding(
                "CST-EXC-002", mi.rel, node.lineno,
                mi.qualname_of(node),
                "lambda thread target cannot contain exceptions — "
                "point the thread at a function whose body is wrapped "
                "in a logging broad `except`",
            ))
            continue
        if not _is_contained(fn):
            out.append(Finding(
                "CST-EXC-002", fn.module.rel, fn.line, fn.qualname,
                "thread-target function is not exception-contained — "
                "an exception here kills the thread with at best a "
                "stderr traceback nothing collects; wrap the body in "
                "`try/except Exception` that logs (and flight-dumps "
                "on worker death)",
            ))
    return out
