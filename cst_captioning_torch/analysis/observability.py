"""CST-OBS: observability-layer invariants (span tracing / flight
recorder — ``cst_captioning_torch/observability/``).

The tracing layer is only trustworthy if these hold everywhere, forever
— so they are rules, not prose:

* CST-OBS-001 — no wall-clock ``time.time()`` on a span path: anywhere
  inside ``observability/``, or in any function that emits spans or
  flight events.  Wall clocks step under NTP; a span that goes
  backwards poisons every duration computed from it.  Span paths use
  ``time.monotonic()`` (the tracer's shared base).
* CST-OBS-002 — every span/event name emitted as a literal anywhere in
  the package must match a family registered in
  ``observability/trace.py::SPAN_CATALOGUE`` / ``EVENT_CATALOGUE``
  (f-string placeholders normalize to ``*``), and every registered
  family must be documented in docs/OBSERVABILITY.md — the
  ``METRIC_HELP`` discipline applied to spans.
* CST-OBS-003 — no tracer/flight call, and no call into
  ``observability/``, reachable from traced code (the CST-JIT traced
  set: ``torch.compile`` / TorchScript roots and CUDA-graph captures,
  closed over the package call graph): a span inside a replayed graph
  records trace time once and nothing thereafter, while looking
  instrumented.

Emission sites are recognized structurally: a ``.record`` /
``.start_span`` / ``.span`` call on a receiver whose final name is
``tracer``-like, or an ``.event`` call on a ``flight``/``recorder``
receiver — the naming convention the serving/training call sites follow
(and docs/OBSERVABILITY.md documents).  The catalogues are read from
the scanned tree's ``observability/trace.py`` by AST, never imported.
"""

from __future__ import annotations

import ast
from fnmatch import fnmatchcase
from typing import List, Optional, Tuple

from cst_captioning_torch.analysis.astutil import (
    ModuleInfo,
    call_name,
    catalogue_names,
    dotted,
    registry_module,
    walk_body,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

OBS_SCOPE = "observability/"
REGISTRY_FILE = "observability/trace.py"
DOC_FILE = "OBSERVABILITY.md"

# The emission-surface convention (documented in docs/OBSERVABILITY.md):
# span emitters are methods named here, called on a receiver whose final
# identifier names a tracer / flight recorder.
_SPAN_ATTRS = {"record", "start_span", "span"}
_EVENT_ATTRS = {"event"}
_FLIGHT_HINTS = {"flight", "recorder"}


def load_patterns(modules: List[ModuleInfo]) -> List[str]:
    """Every registered span and event family, in catalogue order."""
    mi = registry_module(modules, REGISTRY_FILE)
    if mi is None:
        return []
    return (
        catalogue_names(mi, "SPAN_CATALOGUE")
        + catalogue_names(mi, "EVENT_CATALOGUE")
    )


def _emission_call(node: ast.Call) -> bool:
    """Whether this Call is a span/event emission per the receiver-name
    convention (``tracer.record(…)``, ``self.tracer.span(…)``,
    ``rep.flight.event(…)``, …)."""
    if not isinstance(node.func, ast.Attribute):
        return False
    base = dotted(node.func.value)
    if not base:
        return False
    last = base.split(".")[-1].lstrip("_").lower()
    attr = node.func.attr
    if attr in _SPAN_ATTRS and "tracer" in last:
        return True
    if attr in _EVENT_ATTRS and last in _FLIGHT_HINTS:
        return True
    return False


def _literal_name(node: ast.Call) -> Optional[Tuple[str, int]]:
    """The emitted name when the first argument is a (possibly
    formatted) string literal — FormattedValues normalize to ``*``,
    the metrics_registry convention.  Non-literal names are skipped
    (the runtime catalogue check still refuses them)."""
    if not node.args:
        return None
    a = node.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value, a.lineno
    if isinstance(a, ast.JoinedStr):
        parts = []
        for v in a.values:
            parts.append(str(v.value) if isinstance(v, ast.Constant) else "*")
        return "".join(parts), a.lineno
    return None


def emission_sites(
    modules: List[ModuleInfo],
) -> List[Tuple[ModuleInfo, ast.Call]]:
    """Every recognized span/event emission call in the package (the
    vacuous-green guard in tests asserts this finds the real serving
    and training sites)."""
    out = []
    for mi in modules:
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call) and _emission_call(node):
                out.append((mi, node))
    return out


@register_checker("observability")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    out: List[Finding] = []
    patterns = load_patterns(modules)

    # ---- OBS-001: wall clock on a span path -------------------------
    # (a) anywhere inside the observability package itself;
    for mi in modules:
        if not mi.rel.startswith(OBS_SCOPE):
            continue
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call) and call_name(node) == "time.time":
                out.append(Finding(
                    "CST-OBS-001", mi.rel, node.lineno,
                    mi.qualname_of(node),
                    "wall-clock `time.time()` inside the observability "
                    "layer — span paths must use the monotonic base "
                    "(`time.monotonic()`); wall clocks step under NTP",
                ))
    # (b) any function elsewhere that both emits spans/events and reads
    # the wall clock.
    for mi in modules:
        if mi.rel.startswith(OBS_SCOPE):
            continue
        for qn, fn in mi.functions.items():
            body = list(walk_body(fn))
            if not any(
                isinstance(n, ast.Call) and _emission_call(n) for n in body
            ):
                continue
            for n in body:
                if isinstance(n, ast.Call) and call_name(n) == "time.time":
                    out.append(Finding(
                        "CST-OBS-001", mi.rel, n.lineno, qn,
                        "`time.time()` in a function that emits spans — "
                        "span timestamps share one monotonic base; use "
                        "`time.monotonic()` here",
                    ))

    # ---- OBS-002: every emitted name registered + documented --------
    for mi, node in emission_sites(modules):
        lit = _literal_name(node)
        if lit is None:
            continue
        name, line = lit
        if not any(fnmatchcase(name, p) or name == p for p in patterns):
            out.append(Finding(
                "CST-OBS-002", mi.rel, line, name,
                f"emitted span/event name `{name}` matches no family in "
                "observability/trace.py::SPAN_CATALOGUE / "
                "EVENT_CATALOGUE — register it and document it in "
                f"docs/{DOC_FILE}",
            ))
    if ctx.docs_root is not None:
        doc_path = ctx.docs_root / DOC_FILE
        doc_text = doc_path.read_text() if doc_path.exists() else ""
        for pattern in patterns:
            if pattern not in doc_text:
                out.append(Finding(
                    "CST-OBS-002", REGISTRY_FILE, 1, pattern,
                    f"registered span/event family `{pattern}` is not "
                    f"documented in docs/{DOC_FILE} — operators discover "
                    "the timeline vocabulary there; add it to the "
                    "catalogue table",
                ))

    # ---- OBS-003: no tracer calls reachable from traced code -------
    from cst_captioning_torch.analysis.jit_boundary import traced_nodes

    for mi, fn, reason, nodes in traced_nodes(modules, ctx):
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            if _emission_call(node):
                out.append(Finding(
                    "CST-OBS-003", mi.rel, node.lineno, fn.qualname,
                    f"tracer/flight call inside traced code ({reason}) "
                    "— it would record trace time once and nothing "
                    "thereafter; record around the host-side dispatch "
                    "instead",
                ))
                continue
            for callee in ctx.index.resolve_call(mi, fn, node):
                if callee.module.rel.startswith(OBS_SCOPE):
                    out.append(Finding(
                        "CST-OBS-003", mi.rel, node.lineno, fn.qualname,
                        f"call into {callee.module.rel} from traced code "
                        f"({reason}) — the observability layer is "
                        "host-side only",
                    ))
    return out
