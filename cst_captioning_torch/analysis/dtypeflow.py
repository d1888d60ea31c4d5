"""CST-DTY: dtype-flow discipline over the device surface.

The parity tiers (docs/PARITY.md) are dtype contracts: "token-exact"
survives only while every precision change on a decode or loss path is
deliberate, registered and justified.  The surface is the type flow's
(``analysis/typeflow.py``): the CST-JIT traced set plus the closure of
``jit_registry.DEVICE_ROOTS`` — the kernel wrappers, the decode step,
the loss and update steps, the model's forward and decode methods, and
everything they call in the package.

* **CST-DTY-001** — every dtype cast on the surface (``.to(dtype)``,
  ``.to(tensor)``, ``.to(device, dtype)``, ``.type(dtype)``,
  ``.float()`` / ``.half()`` / ``.bfloat16()`` / ``.long()`` ...) is
  covered by ``jit_registry.py::CAST_REGISTRY`` (keyed
  ``<file>::<qualname>``, lambdas folded) with a tier in
  ``PARITY_TIERS`` and a justification; a stale entry or an illegal
  tier fires too.
* **CST-DTY-002** — a tensor the interpreter proves integer meets a
  bare Python float literal: torch floats it to the default float with
  no cast in sight (``tokens * 0.5`` is float32).
* **CST-DTY-003** — inside an entry declaring ``low_precision=True``, a
  bare product (``@``, ``torch.matmul`` / ``mm`` / ``bmm`` /
  ``einsum`` / ``F.linear`` ...) on operands that may be bfloat16 fires.
  On the card cuBLAS may reduce bf16 products in reduced precision
  (``allow_bf16_reduced_precision_reduction`` defaults to True); only
  the pinned f32-accumulating helpers (``row_dot``, ``dot_f32``) or
  operands proven float32 pass.
* **CST-DTY-004** — the torch meaning of the reference's "cast donated
  input": inside a site registered ``update_step=True``, an in-place
  update whose target is a cast of the state (``p.float().add_(u)``,
  ``p.to(torch.float32).copy_(x)``).  A cast returns a temporary when
  the dtype changes — a bfloat16 leaf, say — so the update lands in the
  temporary and the state is silently unchanged.
"""

from __future__ import annotations

import ast
from typing import List, Set

from cst_captioning_torch.analysis import jit_registry
from cst_captioning_torch.analysis import typeflow as tfmod
from cst_captioning_torch.analysis.astutil import (
    ModuleInfo,
    resolved_call,
    walk_body,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)
from cst_captioning_torch.analysis.typeflow import (
    cast_sites,
    is_int,
    site_key,
)

PRODUCTS = frozenset({"matmul", "mm", "bmm", "einsum", "linear", "addmm",
                      "baddbmm", "tensordot", "mv"})
_F32 = frozenset({"f32", "f64"})


def _check_cast_registry(modules: List[ModuleInfo], tf) -> List[Finding]:
    out: List[Finding] = []
    seen: Set[str] = set()
    flagged: Set[str] = set()
    for key, mi, fn, call, kind, target in cast_sites(tf):
        seen.add(key)
        if key in jit_registry.CAST_REGISTRY or key in flagged:
            continue
        flagged.add(key)
        out.append(Finding(
            "CST-DTY-001", mi.rel, call.lineno, fn.qualname,
            f"cast site `{key}` ({kind} -> {target}) is on the device "
            f"surface ({tf.surface[(mi.rel, fn.qualname)]}) but not "
            "registered — add it to analysis/jit_registry.py::"
            "CAST_REGISTRY with the parity tier it preserves and why",
        ))
    scanned = {m.rel for m in modules}
    for key in sorted(jit_registry.CAST_REGISTRY):
        if key.split("::", 1)[0] not in scanned:
            continue
        if key not in seen:
            out.append(Finding(
                "CST-DTY-001", "analysis/jit_registry.py", 1, key,
                f"stale CAST_REGISTRY entry `{key}` matches no cast on "
                "the device surface — the code moved; update or remove "
                "the entry",
            ))
        tier = jit_registry.CAST_REGISTRY[key].tier
        if tier not in jit_registry.PARITY_TIERS:
            out.append(Finding(
                "CST-DTY-001", "analysis/jit_registry.py", 1, key,
                f"CAST_REGISTRY entry `{key}` names illegal parity tier "
                f"{tier!r} — legal tiers are "
                f"{sorted(jit_registry.PARITY_TIERS)} (docs/PARITY.md)",
            ))
    return out


def _check_weak_promotion(tf) -> List[Finding]:
    out: List[Finding] = []
    for fn in tf.surface_functions():
        types = tf.types_of(fn)
        for node in walk_body(fn):
            if not isinstance(node, ast.BinOp) or isinstance(
                node.op, ast.MatMult
            ):
                continue
            for lit, other in ((node.right, node.left),
                               (node.left, node.right)):
                if not (isinstance(lit, ast.Constant)
                        and isinstance(lit.value, float)):
                    continue
                v = types.value_of(other)
                if v.array and is_int(v.dtype):
                    out.append(Finding(
                        "CST-DTY-002", fn.module.rel, node.lineno,
                        fn.qualname,
                        f"integer tensor ({v.dtype}) combined with the "
                        f"bare float literal {lit.value!r} — torch "
                        "silently floats it to the default float (an "
                        "unregistered precision change on this path); "
                        "cast explicitly or keep the arithmetic integral",
                    ))
                    break
    return out


def _may_be_low(v) -> bool:
    return not (v.array and v.dtype in _F32)


def _check_accumulation(tf) -> List[Finding]:
    low = {k for k, e in jit_registry.CAST_REGISTRY.items()
           if e.low_precision}
    if not low:
        return []
    out: List[Finding] = []
    for fn in tf.surface_functions():
        mi = fn.module
        if site_key(mi, fn.qualname) not in low:
            continue
        types = tf.types_of(fn)
        for node in walk_body(fn):
            if isinstance(node, ast.BinOp) and isinstance(
                node.op, ast.MatMult
            ):
                ops = [node.left, node.right]
                what = "`@`"
            elif isinstance(node, ast.Call) and (
                resolved_call(mi, node).rsplit(".", 1)[-1] in PRODUCTS
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr in PRODUCTS)
            ):
                name = resolved_call(mi, node).rsplit(".", 1)[-1] or (
                    node.func.attr)
                ops = [a for a in node.args if not (
                    isinstance(a, ast.Constant) and isinstance(a.value, str))]
                if isinstance(node.func, ast.Attribute) and not resolved_call(
                    mi, node
                ).startswith("torch."):
                    ops = [node.func.value] + ops
                if name == "linear":
                    ops = ops[:2]
                what = f"`{name}`"
            else:
                continue
            if any(_may_be_low(types.value_of(o)) for o in ops):
                out.append(Finding(
                    "CST-DTY-003", mi.rel, node.lineno, fn.qualname,
                    f"bare {what} product on a registered low-precision "
                    "path with operands that may be bfloat16 — cuBLAS "
                    "may reduce bf16 products in bf16 on the card; use "
                    "the f32-accumulating row_dot / dot_f32, or make "
                    "both operands float32",
                ))
    return out


def _check_inplace_on_cast(modules: List[ModuleInfo], tf) -> List[Finding]:
    from cst_captioning_torch.analysis.donation import (
        is_inplace_write,
        update_step_sites,
    )

    out: List[Finding] = []
    for key, fn in update_step_sites(modules):
        types = tf.types_of(fn)
        for node in walk_body(fn, into_nested=True):
            if not (isinstance(node, ast.Call)
                    and is_inplace_write(fn.module, node)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Call)):
                continue
            cast = types.cast_target(node.func.value)
            if cast is None:
                continue
            out.append(Finding(
                "CST-DTY-004", fn.module.rel, node.lineno, fn.qualname,
                f"in-place `{node.func.attr}` on `{cast[0]}` of the state "
                f"in update step `{key}` — a cast that changes the dtype "
                "returns a temporary, so the update lands there and the "
                "state is silently unchanged; update the state itself "
                "(p.add_(u.to(p.dtype)))",
            ))
    return out


@register_checker("dtypeflow")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    tf = tfmod.build(modules, ctx)
    out: List[Finding] = []
    out.extend(_check_cast_registry(modules, tf))
    out.extend(_check_weak_promotion(tf))
    out.extend(_check_accumulation(tf))
    out.extend(_check_inplace_on_cast(modules, tf))
    return out
