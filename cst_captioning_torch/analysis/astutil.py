"""Shared AST plumbing for the invariant engine: the module index
(parse the package once), dotted-name resolution, enclosing-scope
qualnames, and the intra-package call graph the checkers walk.

Pure stdlib-``ast`` on purpose: the analysis pass runs as a pre-commit
preflight, inside the tests and on the card host before the kernels
build,
so it must not import torch (or the package under analysis) — it READS
source, it never executes it.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

PACKAGE = "cst_captioning_torch"


def dotted(node: ast.AST) -> str:
    """``a.b.c`` for a Name/Attribute chain, ``""`` for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    """Dotted name of a call's callee (``""`` for computed callees)."""
    return dotted(node.func)


@dataclass
class FuncInfo:
    """One function/method definition (incl. nested defs and lambdas)."""

    module: "ModuleInfo"
    qualname: str                  # e.g. "ReplicaSet._worker_loop"
    node: ast.AST                  # FunctionDef | AsyncFunctionDef | Lambda
    cls: Optional[str] = None      # enclosing class name, if a method

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    @property
    def params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    @property
    def line(self) -> int:
        return self.node.lineno


@dataclass
class ModuleInfo:
    """One parsed source file of the package under analysis."""

    path: Path
    rel: str                       # package-relative posix path
    tree: ast.Module
    source: str
    # name in this module -> fully dotted target it was imported from
    # ("cst_captioning_torch.decoding.core.decode_step" for symbols,
    #  "cst_captioning_torch.decoding.core" for module aliases).
    imports: Dict[str, str] = field(default_factory=dict)
    functions: Dict[str, FuncInfo] = field(default_factory=dict)
    classes: Dict[str, ast.ClassDef] = field(default_factory=dict)
    parent: Dict[ast.AST, ast.AST] = field(default_factory=dict)

    @property
    def modname(self) -> str:
        stem = self.rel[:-3].replace("/", ".")
        if stem.endswith(".__init__"):
            stem = stem[: -len(".__init__")]
        return f"{PACKAGE}.{stem}" if stem else PACKAGE

    def qualname_of(self, node: ast.AST) -> str:
        """Dotted path of enclosing defs/classes for any node
        ("<module>" at top level)."""
        parts: List[str] = []
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                parts.append(cur.name)
            cur = self.parent.get(cur)
        return ".".join(reversed(parts)) or "<module>"


def _index_module(mi: ModuleInfo) -> None:
    for node in ast.walk(mi.tree):
        for child in ast.iter_child_nodes(node):
            mi.parent[child] = node

    for node in ast.walk(mi.tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                mi.imports[al.asname or al.name.split(".")[0]] = al.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            base = node.module
            if node.level:  # relative import -> resolve against package
                pkg_parts = mi.modname.split(".")[: -node.level]
                base = ".".join(pkg_parts + ([node.module] if node.module else []))
            for al in node.names:
                mi.imports[al.asname or al.name] = f"{base}.{al.name}"

    class _V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.stack: List[str] = []
            self.lambda_seq = 0

        def _add(self, node, name: str, cls: Optional[str]) -> None:
            qn = ".".join(self.stack + [name])
            mi.functions[qn] = FuncInfo(mi, qn, node, cls=cls)

        def visit_ClassDef(self, node: ast.ClassDef) -> None:
            mi.classes[node.name] = node
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
            cls = self.stack[-1] if (
                self.stack and self.stack[-1] in mi.classes
            ) else None
            self._add(node, node.name, cls)
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

        def visit_Lambda(self, node: ast.Lambda) -> None:
            self.lambda_seq += 1
            self._add(node, f"<lambda#{self.lambda_seq}>", None)
            self.generic_visit(node)

    _V().visit(mi.tree)


def scan_package(root: Path) -> List[ModuleInfo]:
    """Parse every ``.py`` under ``root`` once, sorted by relative path.
    ``root`` is the package directory (the one holding ``__init__.py``)
    or any directory of loose files (the seeded-violation corpus)."""
    mods: List[ModuleInfo] = []
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(root).as_posix()
        src = path.read_text()
        try:
            tree = ast.parse(src, filename=str(path))
        except SyntaxError as e:  # corpus files must still be valid py
            raise SyntaxError(f"{rel}: {e}") from e
        mi = ModuleInfo(path=path, rel=rel, tree=tree, source=src)
        _index_module(mi)
        mods.append(mi)
    return mods


class PackageIndex:
    """Cross-module symbol table + call-graph resolution."""

    def __init__(self, modules: List[ModuleInfo]):
        self.modules = modules
        self.by_rel: Dict[str, ModuleInfo] = {m.rel: m for m in modules}
        self.by_modname: Dict[str, ModuleInfo] = {
            m.modname: m for m in modules
        }

    def class_ref(
        self, mi: ModuleInfo, name: str
    ) -> Optional[Tuple[ModuleInfo, str]]:
        """``(defining module, class name)`` for a local or imported
        package class referenced as ``name`` (``Optimizer``,
        ``sharded.MeshOptimizer``), else None."""
        head, _, rest = name.partition(".")
        if not rest and head in mi.classes:
            return mi, head
        imp = mi.imports.get(head)
        if not (imp and imp.startswith(PACKAGE)):
            return None
        if rest:
            m2 = self.by_modname.get(imp)
            if m2 is not None and "." not in rest and rest in m2.classes:
                return m2, rest
            return None
        modname, _, clsname = imp.rpartition(".")
        m2 = self.by_modname.get(modname)
        if m2 is not None and clsname in m2.classes:
            return m2, clsname
        return None

    def class_method(
        self, mi: ModuleInfo, cls: str, method: str
    ) -> Optional[FuncInfo]:
        """``cls.method`` looked up through the package bases of
        ``cls`` (first match in declaration order), so a subclass
        without its own ``__init__`` resolves to its base's."""
        seen = set()
        work = [(mi, cls)]
        while work:
            m, c = work.pop(0)
            if (m.rel, c) in seen:
                continue
            seen.add((m.rel, c))
            fi = m.functions.get(f"{c}.{method}")
            if fi is not None:
                return fi
            for base in m.classes[c].bases:
                ref = self.class_ref(m, dotted(base))
                if ref is not None:
                    work.append(ref)
        return None

    def resolve_call(
        self, mi: ModuleInfo, caller: FuncInfo, node: ast.Call
    ) -> List[FuncInfo]:
        """Best-effort resolution of a call to package functions.

        Handles: local names, ``from pkg.x import f`` names, module
        aliases (``core.decode_step``), ``self.method`` within a class,
        class construction (``Optimizer(...)`` and
        ``super().__init__(...)`` resolve to the ``__init__`` the
        instance runs, inherited ones included), and the autograd
        ``Fn.apply(...)`` indirection (resolved to ``Fn.forward``).
        Unresolvable callees return [].
        """
        # super().m(...) inside a method: the first package base's m
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Call)
            and call_name(f.value) == "super"
            and caller.cls is not None
            and caller.cls in mi.classes
        ):
            for base in mi.classes[caller.cls].bases:
                ref = self.class_ref(mi, dotted(base))
                if ref is not None:
                    fi = self.class_method(ref[0], ref[1], f.attr)
                    if fi is not None:
                        return [fi]
            return []

        name = call_name(node)
        out: List[FuncInfo] = []
        if not name:
            return out

        # class construction runs the (possibly inherited) __init__
        ref = self.class_ref(mi, name)
        if ref is not None:
            fi = self.class_method(ref[0], ref[1], "__init__")
            return [fi] if fi else []

        # torch.autograd.Function indirection: Fn.apply(...) -> forward
        if name.endswith(".apply"):
            ref = self.class_ref(mi, name[: -len(".apply")])
            if ref is not None:
                fi = self.class_method(ref[0], ref[1], "forward")
                return [fi] if fi else []
            return out

        head, _, rest = name.partition(".")
        if head == "self" and caller.cls is not None:
            if rest and "." not in rest:
                fi = mi.functions.get(f"{caller.cls}.{rest}")
                return [fi] if fi else []
            return out
        if not rest:
            # plain name: sibling def in the same scope chain, then
            # module level, then imports
            scope = caller.qualname.rsplit(".", 1)[0]
            for qn in (f"{scope}.{head}", head):
                fi = mi.functions.get(qn)
                if fi:
                    return [fi]
            imp = mi.imports.get(head)
            if imp and imp.startswith(PACKAGE):
                modname, _, sym = imp.rpartition(".")
                m2 = self.by_modname.get(modname)
                if m2 and sym in m2.functions:
                    return [m2.functions[sym]]
            return out
        # dotted: module alias (core.decode_step), imported class
        # (ChaosEngine.from_config), or local class attr
        imp = mi.imports.get(head)
        if imp and imp.startswith(PACKAGE):
            m2 = self.by_modname.get(imp)
            if m2 and rest in m2.functions:
                return [m2.functions[rest]]
            modname, _, clsname = imp.rpartition(".")
            m2 = self.by_modname.get(modname)
            if m2 and f"{clsname}.{rest}" in m2.functions:
                return [m2.functions[f"{clsname}.{rest}"]]
        if head in mi.classes and "." not in rest:
            fi = mi.functions.get(f"{head}.{rest}")
            if fi:
                return [fi]
        return out


def registry_module(
    modules: List[ModuleInfo], rel: str
) -> Optional[ModuleInfo]:
    """The module at package-relative ``rel`` that holds a registry
    (``serving/metrics.py``, ``observability/trace.py``,
    ``serving/chaos.py``): the scanned one when the scan has it, else
    the package's own file, parsed — never imported.  A corpus scan so
    checks its seeded emissions against the real registry, and a
    corpus that carries its own twin of the file is checked against
    that."""
    for mi in modules:
        if mi.rel == rel:
            return mi
    path = Path(__file__).resolve().parent.parent / rel
    if not path.is_file():
        return None
    src = path.read_text()
    mi = ModuleInfo(
        path=path, rel=rel, tree=ast.parse(src, filename=str(path)),
        source=src,
    )
    _index_module(mi)
    return mi


def module_literal(mi: ModuleInfo, name: str) -> Optional[ast.AST]:
    """The value expression of the module-level assignment to ``name``
    (plain or annotated), None when the module binds no such name."""
    for stmt in mi.tree.body:
        if isinstance(stmt, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in stmt.targets
        ):
            return stmt.value
        if (
            isinstance(stmt, ast.AnnAssign)
            and isinstance(stmt.target, ast.Name)
            and stmt.target.id == name
        ):
            return stmt.value
    return None


def catalogue_names(mi: ModuleInfo, name: str) -> List[str]:
    """The first field of every tuple in the module-level list literal
    ``name`` (``SPAN_CATALOGUE``, ``FAULT_SITES``: rows of
    ``(pattern, ...)``)."""
    value = module_literal(mi, name)
    if not isinstance(value, (ast.List, ast.Tuple)):
        return []
    return [
        row.elts[0].value
        for row in value.elts
        if isinstance(row, ast.Tuple)
        and row.elts
        and isinstance(row.elts[0], ast.Constant)
        and isinstance(row.elts[0].value, str)
    ]


def walk_body(fn: FuncInfo, *, into_nested: bool = False):
    """Walk a function's own body; by default stop at nested def/lambda
    boundaries (nested defs are their own FuncInfo — decorators and
    default expressions of a nested def still belong to the parent and
    are walked)."""
    stack = list(ast.iter_child_nodes(fn.node))
    while stack:
        node = stack.pop()
        if not into_nested and isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            # still surface the nested def's decorators/defaults
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(node.decorator_list)
                stack.extend(
                    d
                    for d in node.args.defaults + node.args.kw_defaults
                    if d is not None
                )
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def func_body_calls(fn: FuncInfo) -> Iterable[ast.Call]:
    """Every Call in a function's own body (nested defs excluded)."""
    for node in walk_body(fn):
        if isinstance(node, ast.Call):
            yield node




def resolved(mi: ModuleInfo, name: str) -> str:
    """``name`` (a dotted callee or decorator) with its head resolved
    through the module's import map, so ``from torch import topk as tk;
    tk(...)`` reads ``torch.topk`` and ``import torch.distributed as
    dist; dist.all_reduce`` reads ``torch.distributed.all_reduce``."""
    if not name:
        return ""
    head, _, rest = name.partition(".")
    target = mi.imports.get(head)
    if target:
        return target + (("." + rest) if rest else "")
    return name


def resolved_call(mi: ModuleInfo, node: ast.Call) -> str:
    """The resolved dotted callee of a call (``""`` when computed)."""
    return resolved(mi, call_name(node))
