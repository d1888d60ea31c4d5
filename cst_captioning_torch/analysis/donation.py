"""CST-DON: kernel-site, AOT and in-place-update discipline.

The reference's donation rules guard its jit sites: every compile site
has a retrace story, every AOT compile or executable install is
registered, and every update step donates its state.  The port has no
jit sites; its counterparts are:

* **Kernel sites** (CST-DON-002 / 003): every ``_build.load("<kernel>")``
  call, where a CUDA library is built (one ``nvcc`` per source digest
  and arch into the build directory) or an artifact's copy is served,
  must be registered in ``jit_registry.py::JIT_SITE_REGISTRY`` keyed
  ``<file>::<qualname>``, naming the kernel it loads and what bounds
  the builds there.  An unregistered site, or an entry naming another
  kernel, fires CST-DON-002; an entry matching no live site fires
  CST-DON-003.
* **AOT sites** (CST-DON-004 / 005): a call that builds kernels ahead of
  their first launch (``_build.build``), installs libraries built in
  another process (``_build.load_artifact_kernels``), or exports /
  loads a compiled program (``torch.export``, ``torch.jit.load``,
  ``torch._inductor.aot_compile``) must be registered in
  ``AOT_SITE_REGISTRY`` with what enumerates its variants and what
  refuses a stale or foreign build; stale entries fire CST-DON-005.
* **Update steps** (CST-DON-001): the torch meaning of donation is that
  old and new state never coexist — parameters and optimizer moments
  are written in place (``copy_``, ``add_``, ``mul_``, ``addcdiv_``,
  ``lerp_``, ``torch._foreach_*``).  Inside a site registered
  ``update_step=True``, a rebinding assignment of a new tensor into the
  state fires: ``p = p - lr * u`` on a name bound from the parameters,
  ``self.mu[k] = ...`` into a state dict, ``self.nu = {...}`` over one.
  The model keeps the old tensor, and the update is lost.  An
  ``update_step`` entry whose def is gone fires CST-DON-003.

Site keys are ``<file>::<qualname>``, stable under reformatting.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cst_captioning_torch.analysis import jit_registry
from cst_captioning_torch.analysis.astutil import (
    FuncInfo,
    ModuleInfo,
    resolved_call,
    walk_body,
)
from cst_captioning_torch.analysis.dataflow import DefUse
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

BUILD_MODULE = "cst_captioning_torch.ops._build"
KERNEL_LOADER = f"{BUILD_MODULE}.load"
AOT_CALLS = frozenset({
    f"{BUILD_MODULE}.build",
    f"{BUILD_MODULE}.load_artifact_kernels",
    "torch.export.export",
    "torch.export.load",
    "torch.jit.load",
    "torch._inductor.aot_compile",
})
# In-place writes that update a tensor without rebinding it.
INPLACE_METHODS = frozenset({
    "copy_", "add_", "sub_", "mul_", "div_", "addcdiv_", "addcmul_",
    "lerp_", "clamp_", "zero_", "fill_", "sqrt_", "neg_", "masked_fill_",
    "index_copy_", "index_add_", "scatter_", "set_",
})


def is_inplace_write(mi: ModuleInfo, node: ast.Call) -> bool:
    """``t.add_(...)``-style in-place method or ``torch._foreach_*_``."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in INPLACE_METHODS:
        return True
    name = resolved_call(mi, node)
    return name.startswith("torch._foreach_") and name.endswith("_")


def collect_kernel_sites(
    modules: List[ModuleInfo],
) -> List[Tuple[str, ModuleInfo, ast.Call, str, Optional[str]]]:
    """Every ``_build.load`` call as ``(key, module, call, qualname,
    kernel name literal or None)``."""
    out = []
    for mi in modules:
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call) and (
                resolved_call(mi, node) == KERNEL_LOADER
            ):
                qn = mi.qualname_of(node)
                arg = node.args[0] if node.args else None
                name = (
                    arg.value if isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) else None
                )
                out.append((f"{mi.rel}::{qn}", mi, node, qn, name))
    return out


def collect_aot_sites(
    modules: List[ModuleInfo],
) -> List[Tuple[str, ModuleInfo, ast.Call, str]]:
    """Every AOT build / install / export site as ``(key, module, call,
    callee)``, keyed on the enclosing qualname (one entry covers a
    function's whole build loop)."""
    out = []
    for mi in modules:
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call):
                name = resolved_call(mi, node)
                if name in AOT_CALLS:
                    out.append((
                        f"{mi.rel}::{mi.qualname_of(node)}", mi, node, name,
                    ))
    return out


def update_step_sites(
    modules: List[ModuleInfo],
) -> List[Tuple[str, FuncInfo]]:
    """``(key, def)`` of every scanned ``update_step=True`` entry."""
    by_rel = {m.rel: m for m in modules}
    out = []
    for key, entry in sorted(jit_registry.JIT_SITE_REGISTRY.items()):
        if not entry.update_step:
            continue
        rel, _, qn = key.partition("::")
        mi = by_rel.get(rel)
        if mi is not None and qn in mi.functions:
            out.append((key, mi.functions[qn]))
    return out


# ------------------------------------------------ state rebinding (001)

def _state_root(expr: ast.AST, params: Set[str]) -> bool:
    """Whether ``expr`` reads the state: an attribute / subscript /
    method chain rooted at ``self`` or at a parameter."""
    while isinstance(expr, (ast.Attribute, ast.Subscript, ast.Call)):
        expr = expr.func if isinstance(expr, ast.Call) else expr.value
    return isinstance(expr, ast.Name) and (
        expr.id == "self" or expr.id in params
    )


def _items_call(expr: ast.AST) -> bool:
    return (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr == "items"
    )


def _alias_names(fn: FuncInfo) -> Tuple[Dict[str, int], Set[str]]:
    """Names that alias state tensors (name -> the DefUse index of their
    alias binding) and the ``self`` attributes holding state dicts."""
    params = {p for p in fn.params if p not in ("self", "cls")}
    aliases: Dict[str, int] = {}
    containers: Set[str] = set()
    du = DefUse(fn)
    for b in du.bindings:
        if b.kind == "for" and isinstance(b.stmt, (ast.For, ast.AsyncFor)):
            it = b.stmt.iter
            if not _state_root(it, params):
                continue
            tgt = b.stmt.target
            if _items_call(it):
                # ``for k, p in state.items()``: the value is the tensor
                if not (
                    isinstance(tgt, ast.Tuple) and tgt.elts
                    and isinstance(tgt.elts[-1], ast.Name)
                    and tgt.elts[-1].id == b.name
                ):
                    continue
            aliases.setdefault(b.name, b.index)
            _note_container(it, containers)
        elif b.kind == "assign" and isinstance(
            b.value, (ast.Subscript,)
        ) and _state_root(b.value, params):
            aliases.setdefault(b.name, b.index)
            _note_container(b.value, containers)
    return aliases, containers


def _note_container(expr: ast.AST, containers: Set[str]) -> None:
    """Record ``X`` for a state expression rooted at ``self.X``."""
    while isinstance(expr, (ast.Subscript, ast.Call)) or (
        isinstance(expr, ast.Attribute)
        and not (isinstance(expr.value, ast.Name)
                 and expr.value.id == "self")
    ):
        expr = expr.func if isinstance(expr, ast.Call) else expr.value
    if isinstance(expr, ast.Attribute):
        containers.add(expr.attr)


def state_rebinds(fn: FuncInfo) -> List[Tuple[ast.AST, str]]:
    """``(statement, what)`` for every rebinding of state inside an
    update step (see the module doc)."""
    params = {p for p in fn.params if p not in ("self", "cls")}
    aliases, containers = _alias_names(fn)
    du = DefUse(fn)
    out: List[Tuple[ast.AST, str]] = []
    for b in du.bindings:
        start = aliases.get(b.name)
        if (
            start is not None and b.index > start
            and b.kind in ("assign", "walrus")
            and not (isinstance(b.value, ast.Subscript)
                     and _state_root(b.value, params))
        ):
            out.append((b.stmt, f"`{b.name}`, bound from the state, is "
                                "rebound to a new tensor"))
    for node in walk_body(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Subscript) and _state_root(t, params):
                out.append((node, f"`{ast.unparse(t)}` replaces a state "
                                  "tensor in its dict"))
            elif (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name) and t.value.id == "self"
                and t.attr in containers
            ):
                out.append((node, f"`self.{t.attr}` is rebound to new "
                                  "state"))
    return out


@register_checker("donation")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    out: List[Finding] = []
    reg = jit_registry.JIT_SITE_REGISTRY
    scanned = {m.rel for m in modules}
    seen: Set[str] = set()
    for key, mi, call, qn, kernel in collect_kernel_sites(modules):
        seen.add(key)
        entry = reg.get(key)
        if entry is None:
            out.append(Finding(
                "CST-DON-002", mi.rel, call.lineno, qn,
                f"kernel site `{key}` is not registered — add it to "
                "analysis/jit_registry.py::JIT_SITE_REGISTRY with the "
                "kernel it loads and what bounds its builds",
            ))
        elif kernel is None or kernel not in entry.kernels:
            out.append(Finding(
                "CST-DON-002", mi.rel, call.lineno, qn,
                f"kernel site `{key}` loads {kernel!r}, but its registry "
                f"entry names {list(entry.kernels)} — the site and its "
                "build budget drifted apart",
            ))
    for key, entry in sorted(reg.items()):
        rel, _, qn = key.partition("::")
        if rel not in scanned:
            continue
        mi = next(m for m in modules if m.rel == rel)
        live = (qn in mi.functions) if entry.update_step else key in seen
        if not live:
            out.append(Finding(
                "CST-DON-003", "analysis/jit_registry.py", 1, key,
                f"stale kernel-site registry entry `{key}` matches no "
                + ("def" if entry.update_step else "`_build.load` site")
                + " — the code moved; update or remove the entry",
            ))
    # ---- update steps write their state in place ---------------------
    for key, fn in update_step_sites(modules):
        for stmt, what in state_rebinds(fn):
            out.append(Finding(
                "CST-DON-001", fn.module.rel, stmt.lineno, fn.qualname,
                f"update step `{key}`: {what} — the model keeps the old "
                "tensor and the update is lost (old and new state "
                "coexist); write it in place (copy_ / add_ / "
                "torch._foreach_*)",
            ))
    # ---- AOT builds and installs -------------------------------------
    seen_aot: Set[str] = set()
    for key, mi, call, name in collect_aot_sites(modules):
        seen_aot.add(key)
        if key not in jit_registry.AOT_SITE_REGISTRY:
            out.append(Finding(
                "CST-DON-004", mi.rel, call.lineno, mi.qualname_of(call),
                f"AOT site `{key}` ({name.rsplit('.', 1)[-1]}) is not "
                "registered — add it to analysis/jit_registry.py::"
                "AOT_SITE_REGISTRY with what enumerates its variants and "
                "what refuses a stale or foreign build",
            ))
    for key in sorted(jit_registry.AOT_SITE_REGISTRY):
        if key.split("::", 1)[0] in scanned and key not in seen_aot:
            out.append(Finding(
                "CST-DON-005", "analysis/jit_registry.py", 1, key,
                f"stale AOT-registry entry `{key}` matches no build, "
                "install or export site — the code moved; update or "
                "remove the entry",
            ))
    return out
