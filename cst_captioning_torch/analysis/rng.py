"""CST-RNG: random-stream discipline over the def-use dataflow layer.

The port replays JAX's threefry streams bit for bit
(``ops/threefry.py``: a key is two 32-bit words, ``fold_in`` / ``split``
derive keys, ``random_bits`` / ``categorical_ref`` / ``threefry_sample``
draw), and draws everything else from seeded ``torch.Generator``
streams.  Every fixed-seed parity pin rests on that discipline:

* CST-RNG-001 — a threefry key binding consumed by two draws without an
  intervening ``split`` / ``fold_in`` (silently correlated randomness),
  including the loop flavour: a draw inside a ``for`` / ``while`` whose
  key is bound outside the loop reuses the key every iteration.  Draws
  on the two arms of one ``if`` / ``else`` are exclusive and do not
  fire.
* CST-RNG-002 — untracked entropy: a key root (``key_words``) or a
  ``manual_seed`` seeded from a nondeterministic source (``time.*``,
  host RNG, ``os.urandom``, ``secrets``, ``uuid``, ``torch.seed``); a
  draw keyed by a name bound nowhere; ``torch.seed()`` itself; a
  ``torch.Generator`` that is never ``manual_seed``-ed; and a draw
  (``torch.rand*`` / ``randn*`` / ``randint*`` / ``bernoulli`` /
  ``multinomial`` / ``randperm`` / ``normal`` / ``poisson``,
  ``F.dropout``, in-place ``uniform_`` / ``normal_`` / ``bernoulli_``
  ...) without ``generator=``, which draws from the process-global
  stream.
* CST-RNG-003 — a token draw (``threefry_sample``, ``categorical_ref``)
  outside :data:`ROW_KEYED_ALLOWED`: the row-keyed contract lives in
  ``decoding/core.py`` (``row_sample_fn``, ``fold_in(fold_in(base,
  row_id), t)``), the batch stream in ``models/captioner.py``, the draw
  itself in ``ops/threefry.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from cst_captioning_torch.analysis.astutil import (
    FuncInfo,
    ModuleInfo,
    resolved_call,
    walk_body,
)
from cst_captioning_torch.analysis.dataflow import (
    Binding,
    DefUse,
    provenance_chain,
)
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    Finding,
    register_checker,
)

ROW_KEYED_ALLOWED = frozenset({
    "decoding/core.py",
    "models/captioner.py",
    "ops/threefry.py",
})

THREEFRY = "cst_captioning_torch.ops.threefry"
# draw -> the keyword(s) naming its key (random_bits also takes it
# first, positionally)
DRAW_FNS = {
    "random_bits": ("key",),
    "categorical_ref": ("key", "base"),
    "threefry_sample": ("key", "base"),
}
TOKEN_DRAWS = frozenset({"categorical_ref", "threefry_sample"})
DERIVE_FNS = frozenset({"fold_in", "split", "row_keys"})
ROOT_FNS = frozenset({"key_words"})

# torch draws from a stream: callee -> whether it takes generator=
TORCH_DRAWS = frozenset({
    "torch.rand", "torch.randn", "torch.randint", "torch.rand_like",
    "torch.randn_like", "torch.randint_like", "torch.bernoulli",
    "torch.multinomial", "torch.randperm", "torch.normal",
    "torch.poisson",
})
NO_GENERATOR_DRAWS = frozenset({
    "torch.nn.functional.dropout", "torch.dropout",
    "torch.nn.functional.dropout1d", "torch.nn.functional.dropout2d",
})
INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "bernoulli_", "exponential_", "random_",
    "geometric_", "cauchy_", "log_normal_",
})
GENERATOR = "torch.Generator"
_GLOBAL_SEEDS = frozenset({"torch.seed", "torch.random.seed"})

_NONDET_PREFIXES = (
    "time.", "numpy.random.", "np.random.", "random.", "secrets.",
    "uuid.", "os.urandom", "os.getrandom", "torch.seed",
    "torch.random.seed", "torch.initial_seed",
)


def _threefry_fn(mi: ModuleInfo, node: ast.Call) -> str:
    """``"random_bits"`` for any spelling of an ``ops/threefry.py``
    function, ``""`` otherwise (inside that module, its own names)."""
    name = resolved_call(mi, node)
    if name.startswith(THREEFRY + "."):
        return name[len(THREEFRY) + 1:]
    if mi.modname == THREEFRY and name in mi.functions:
        return name
    return ""


def key_arg(fn_name: str, node: ast.Call) -> Optional[ast.AST]:
    """The key operand of a threefry draw / derivation / root call."""
    names = DRAW_FNS.get(fn_name, ("key", "base"))
    for kw in node.keywords:
        if kw.arg in names and not (
            isinstance(kw.value, ast.Constant) and kw.value.value is None
        ):
            return kw.value
    if fn_name in TOKEN_DRAWS:
        return None
    return node.args[0] if node.args else None


def draw_sites(
    modules: List[ModuleInfo],
) -> List[Tuple[ModuleInfo, FuncInfo, ast.Call, str]]:
    """Every threefry draw in the package: ``(module, function, call,
    draw name)`` (the surface the tests hold the rules to)."""
    out = []
    for mi in modules:
        for fn in mi.functions.values():
            for node in walk_body(fn):
                if isinstance(node, ast.Call):
                    name = _threefry_fn(mi, node)
                    if name in DRAW_FNS:
                        out.append((mi, fn, node, name))
    return out


def _in_subtree(root: ast.AST, node: ast.AST, mi: ModuleInfo) -> bool:
    cur = node
    while cur is not None:
        if cur is root:
            return True
        cur = mi.parent.get(cur)
    return False


def _ancestors(mi: ModuleInfo, node: ast.AST) -> List[ast.AST]:
    out = []
    cur = mi.parent.get(node)
    while cur is not None:
        out.append(cur)
        cur = mi.parent.get(cur)
    return out


def _disjoint_branches(mi: ModuleInfo, a: ast.AST, b: ast.AST) -> bool:
    """Whether two nodes sit on exclusive arms of one ``if`` / ``else``
    (or ``try`` / ``except``)."""
    for anc in _ancestors(mi, a):
        if isinstance(anc, ast.If):
            pairs = ((anc.body, anc.orelse), (anc.orelse, anc.body))
        elif isinstance(anc, ast.Try):
            pairs = ((anc.body, anc.handlers), (anc.handlers, anc.body))
        else:
            continue
        for arm_a, arm_b in pairs:
            if any(_in_subtree(s, a, mi) for s in arm_a) and any(
                _in_subtree(s, b, mi) for s in arm_b
            ):
                return True
    return False


def _enclosing_loops(mi: ModuleInfo, node: ast.AST,
                     fn: FuncInfo) -> List[ast.AST]:
    out = []
    cur = mi.parent.get(node)
    while cur is not None and cur is not fn.node:
        if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
            out.append(cur)
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            break
        cur = mi.parent.get(cur)
    return out


def _nondet_entropy(mi: ModuleInfo, expr: Optional[ast.AST]) -> Optional[str]:
    if expr is None:
        return None
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            name = resolved_call(mi, node)
            if name.startswith(_NONDET_PREFIXES):
                return name
    return None


def _module_level_names(mi: ModuleInfo) -> set:
    names = set(mi.imports)
    for node in mi.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            names.add(node.target.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            names.add(node.name)
    return names


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


def _torch_stream_draw(mi: ModuleInfo, node: ast.Call) -> Optional[str]:
    """The name of a draw from the process-global torch stream."""
    name = resolved_call(mi, node)
    if name in NO_GENERATOR_DRAWS:
        for kw in node.keywords:
            if kw.arg == "training" and isinstance(
                kw.value, ast.Constant
            ) and kw.value.value is False:
                return None
        return name
    if name in TORCH_DRAWS and not _has_generator(node):
        return name
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in INPLACE_DRAWS and (
        not _has_generator(node)
    ):
        return f".{f.attr}"
    return None


def _seeded(mi: ModuleInfo, fn: FuncInfo,
            gen: ast.Call) -> Tuple[bool, Optional[ast.AST]]:
    """Whether a ``torch.Generator(...)`` construction is
    ``manual_seed``-ed (chained, or through the name it is bound to,
    later in the same function), and the seed expression."""
    parent = mi.parent.get(gen)
    if (
        isinstance(parent, ast.Attribute) and parent.attr == "manual_seed"
        and isinstance(mi.parent.get(parent), ast.Call)
    ):
        call = mi.parent.get(parent)
        return True, call.args[0] if call.args else None
    stmt = parent
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and (
        isinstance(stmt.targets[0], ast.Name)
    ):
        name = stmt.targets[0].id
        for node in walk_body(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "manual_seed"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == name
                and node.lineno >= stmt.lineno
            ):
                return True, node.args[0] if node.args else None
    return False, None


def _generator_findings(mi: ModuleInfo, fn: FuncInfo) -> List[Finding]:
    out: List[Finding] = []
    qn = fn.qualname
    for node in walk_body(fn):
        if not isinstance(node, ast.Call):
            continue
        name = resolved_call(mi, node)
        if name in _GLOBAL_SEEDS:
            out.append(Finding(
                "CST-RNG-002", mi.rel, node.lineno, qn,
                f"`{name}()` reseeds the global stream from "
                "nondeterministic entropy — every fixed-seed pin breaks; "
                "seed a torch.Generator from the config seed instead",
            ))
        elif name == GENERATOR:
            seeded, seed = _seeded(mi, fn, node)
            if not seeded:
                out.append(Finding(
                    "CST-RNG-002", mi.rel, node.lineno, qn,
                    "torch.Generator never manual_seed-ed — it starts "
                    "from a fixed default seed no config names; seed it "
                    "from the run's seed (train.seed and its "
                    "derivations)",
                ))
            chained = isinstance(mi.parent.get(node), ast.Attribute)
            src = _nondet_entropy(mi, seed) if chained else None
            if src is not None:
                out.append(Finding(
                    "CST-RNG-002", mi.rel, node.lineno, qn,
                    f"torch.Generator seeded from `{src}` — "
                    "nondeterministic entropy breaks every fixed-seed "
                    "pin; seed from the config",
                ))
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "manual_seed"
            and not isinstance(node.func.value, ast.Call)
        ):
            src = _nondet_entropy(mi, node.args[0] if node.args else None)
            if src is not None:
                out.append(Finding(
                    "CST-RNG-002", mi.rel, node.lineno, qn,
                    f"manual_seed from `{src}` — nondeterministic "
                    "entropy breaks every fixed-seed pin; seed from the "
                    "config",
                ))
        else:
            what = _torch_stream_draw(mi, node)
            if what is not None:
                out.append(Finding(
                    "CST-RNG-002", mi.rel, node.lineno, qn,
                    f"`{what}` draws from the process-global stream (no "
                    "generator=) — its values depend on every draw "
                    "before it in the process; pass the step's seeded "
                    "torch.Generator",
                ))
    return out


def _key_through(mi: ModuleInfo):
    """Provenance hook: derivations are transparent to the walk."""
    def through(call: ast.Call) -> Optional[ast.AST]:
        name = _threefry_fn(mi, call)
        if name in DERIVE_FNS:
            return key_arg(name, call)
        return None

    return through


@register_checker("rng")
def check(modules: List[ModuleInfo], ctx: CheckContext) -> List[Finding]:
    out: List[Finding] = []
    for mi in modules:
        mod_names = None
        for qn, fn in mi.functions.items():
            sites = []
            for node in walk_body(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = _threefry_fn(mi, node)
                if name in ROOT_FNS:
                    src = _nondet_entropy(
                        mi, node.args[0] if node.args else node
                    )
                    if src is not None:
                        out.append(Finding(
                            "CST-RNG-002", mi.rel, node.lineno, qn,
                            f"threefry key root seeded from `{src}` — "
                            "nondeterministic entropy breaks every "
                            "fixed-seed bit-identical pin; seed from the "
                            "config (train.seed) and derive with fold_in "
                            "/ split",
                        ))
                elif name in DRAW_FNS:
                    sites.append((node, name, key_arg(name, node)))
            out.extend(_generator_findings(mi, fn))
            if not sites:
                continue
            du = DefUse(fn)
            sites.sort(key=lambda s: (s[0].lineno, s[0].col_offset))
            through = _key_through(mi)
            consumed: Dict[int, Tuple[ast.AST, Binding]] = {}
            for node, name, key in sites:
                if name in TOKEN_DRAWS and mi.rel not in ROW_KEYED_ALLOWED:
                    out.append(Finding(
                        "CST-RNG-003", mi.rel, node.lineno, qn,
                        f"token draw `{name}` outside the row-keyed "
                        "allowlist — sampled tokens come from "
                        "decoding/core.py's row-keyed machinery "
                        "(fold_in(fold_in(base, row_id), t)) so slot "
                        "geometry and admission order cannot change any "
                        "token",
                    ))
                if not isinstance(key, ast.Name):
                    continue
                orig = provenance_chain(fn, du, key, through=through)
                if orig.kind == "free":
                    if mod_names is None:
                        mod_names = _module_level_names(mi)
                    if orig.name not in mod_names:
                        out.append(Finding(
                            "CST-RNG-002", mi.rel, node.lineno, qn,
                            f"draw `{name}` keyed by `{orig.name}`, which "
                            "is bound nowhere (not a parameter, enclosing "
                            "scope, module global or import) — untracked "
                            "entropy; thread the key in from the seeded "
                            "root",
                        ))
                b = du.reaching_def(key)
                if b is None:
                    continue
                prev = consumed.get(id(b))
                if prev is not None and not _disjoint_branches(
                    mi, prev[0], node
                ):
                    out.append(Finding(
                        "CST-RNG-001", mi.rel, node.lineno, qn,
                        f"key `{key.id}` consumed again by `{name}` "
                        f"(first drawn at line {prev[0].lineno}) without "
                        "an intervening split / fold_in — reused keys "
                        "draw correlated randomness silently",
                    ))
                else:
                    consumed[id(b)] = (node, b)
                for loop in _enclosing_loops(mi, node, fn):
                    inside = (
                        b.stmt is not None and b.kind != "param"
                        and _in_subtree(loop, b.stmt, mi)
                    )
                    if not inside:
                        out.append(Finding(
                            "CST-RNG-001", mi.rel, node.lineno, qn,
                            f"key `{key.id}` drawn inside a loop but "
                            "bound outside it — every iteration reuses "
                            "the same key; derive a per-iteration key "
                            "with fold_in(key, i)",
                        ))
                        break
    return out
