"""CST-MET: Prometheus metric-name registry lint.

Dashboards scrape ``/metrics`` by NAME; a renamed, duplicated, or
undocumented series breaks them silently.  The registry
(``serving/metrics.py::METRIC_HELP`` — one HELP line per family, next
to the emitters) is the single source of truth; these rules keep it
honest:

* CST-MET-001 — a ``caption_*`` name emitted anywhere in ``serving/``
  that matches no registered family (f-string placeholders normalize to
  ``*``, label blocks and space-separated values are stripped);
* CST-MET-002 — a registered family missing from docs/SERVING.md (the
  docs table must name every family verbatim);
* CST-MET-003 — a family registered more than once.  The registry is a
  dict literal, so a second entry under the same key silently replaces
  the first at import; the rule reads the literal's keys from the
  source, where both are still visible.

The registry is read from the scanned tree's ``serving/metrics.py`` by
AST (:func:`~.astutil.registry_module`), never imported, so the pass
stays torch-free and ``--root`` works on a corpus.
"""

from __future__ import annotations

import ast
import re
from fnmatch import fnmatchcase
from typing import List, Optional, Tuple

from cst_captioning_torch.analysis.astutil import (
    ModuleInfo,
    module_literal,
    registry_module,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

_NAME_RE = re.compile(r"^caption_[a-z0-9_*]+$")
REGISTRY_FILE = "serving/metrics.py"
REGISTRY_NAME = "METRIC_HELP"
DOC_FILE = "SERVING.md"


def load_registry(modules: List[ModuleInfo]) -> List[Tuple[str, int]]:
    """``(family pattern, line)`` for every key of the ``METRIC_HELP``
    dict literal, duplicates included, in source order."""
    mi = registry_module(modules, REGISTRY_FILE)
    value = module_literal(mi, REGISTRY_NAME) if mi is not None else None
    if not isinstance(value, ast.Dict):
        return []
    return [
        (k.value, k.lineno)
        for k in value.keys
        if isinstance(k, ast.Constant) and isinstance(k.value, str)
    ]


def _normalize(raw: str) -> Optional[str]:
    """A candidate emitted-name literal -> canonical family string.
    Placeholders are already ``*``; strip the label block and anything
    after the first space, then the exposition suffixes."""
    name = raw.split("{", 1)[0].split(" ", 1)[0]
    for suffix in ("_bucket", "_count", "_sum"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    if not _NAME_RE.match(name):
        return None
    return name


def _literal_strings(mi: ModuleInfo):
    """(string value, line) for every Constant str and every JoinedStr
    with FormattedValues replaced by ``*`` — skipping docstrings (prose
    mentions are documentation, not emission)."""
    skip = set()
    for node in ast.walk(mi.tree):
        if isinstance(
            node,
            (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef),
        ):
            body = node.body
            if (
                body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)
            ):
                skip.add(id(body[0].value))
        elif isinstance(node, ast.JoinedStr):
            # constant fragments of an f-string are surfaced via the
            # normalized JoinedStr, not as bare literals
            for v in node.values:
                skip.add(id(v))
    for node in ast.walk(mi.tree):
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and id(node) not in skip
        ):
            yield node.value, node.lineno
        elif isinstance(node, ast.JoinedStr):
            parts = []
            for v in node.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                else:
                    parts.append("*")
            yield "".join(parts), node.lineno


@register_checker("metrics_registry")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    out: List[Finding] = []
    registry = load_registry(modules)

    # MET-003: duplicate registration (a repeated key of the literal)
    seen = set()
    for pattern, line in registry:
        if pattern in seen:
            out.append(Finding(
                "CST-MET-003", REGISTRY_FILE, line,
                f"{REGISTRY_NAME}[{pattern}]",
                f"metric family `{pattern}` registered more than once — "
                "the later dict entry silently replaces the earlier "
                "one's help text",
            ))
        seen.add(pattern)

    patterns = sorted(seen)

    # MET-001: every emitted caption_* literal matches a family
    for mi in modules:
        if not mi.rel.startswith("serving/"):
            continue
        for raw, line in _literal_strings(mi):
            name = _normalize(raw)
            if name is None:
                continue
            if not any(fnmatchcase(name, p) or name == p for p in patterns):
                out.append(Finding(
                    "CST-MET-001", mi.rel, line, name,
                    f"emitted metric name `{name}` matches no "
                    "registered family — register it in "
                    f"{REGISTRY_FILE}::{REGISTRY_NAME} and document "
                    "it in docs/SERVING.md",
                ))

    # MET-002: every family documented in docs/SERVING.md
    if ctx.docs_root is not None:
        doc_path = ctx.docs_root / DOC_FILE
        doc_text = doc_path.read_text() if doc_path.exists() else ""
        for pattern in patterns:
            if pattern not in doc_text:
                out.append(Finding(
                    "CST-MET-002", REGISTRY_FILE, 1, pattern,
                    f"registered metric family `{pattern}` is not "
                    f"documented in docs/{DOC_FILE} — scrape consumers "
                    "discover names there; add it to the metrics table",
                ))
    return out
