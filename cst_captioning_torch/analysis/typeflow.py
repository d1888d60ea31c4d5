"""The dtype / shape abstract interpreter: the layer under CST-DTY and
CST-SHP.

A precision change on a decode or loss path is a parity-tier change:
one implicit upcast and "token-exact" silently becomes "close enough".
This module turns the port's dtypes into dataflow facts:

* an :class:`AbstractValue` is a dtype-lattice element, a shape of
  symbolic dims, whether the value is a tensor (``array``) and whether
  it is a zero-dim tensor (``zero``), and for a tuple its elements.
  ``any`` is top, so the rules only ever err toward silence;
* the lattice is **torch's**, not JAX's (:func:`result_type` follows
  ``torch.result_type``): operands rank as dimensioned tensors, then
  zero-dim tensors, then Python scalars, and a lower rank only moves the
  result when it is of a higher category (bool < integer < float).  So a
  Python float against an integer tensor gives the default float
  (float32), a Python scalar or a zero-dim float32 tensor against a
  bfloat16 tensor keeps bfloat16, integer ``/`` integer gives the
  default float, comparisons give bool; where a tensor might or might
  not be zero-dim the result is proven only if both readings agree;
* creators take their dtype from ``dtype=`` or the default
  (``torch.zeros`` / ``full`` / ``arange`` / ``tensor`` infer from their
  fill or data as torch does); casts are ``.to(dtype)``,
  ``.to(other_tensor)``, ``.to(device, dtype)``, ``.type(dtype)`` and
  ``.float()`` / ``.half()`` / ``.bfloat16()`` / ``.double()`` /
  ``.long()`` / ``.int()`` ..., while ``.to(device)`` is no cast;
  products (``@``, ``torch.matmul`` / ``mm`` / ``bmm`` / ``einsum``,
  ``F.linear``) keep their operands' dtype, and the port's
  f32-accumulating helpers (``ops/rnn.py::dot_f32``,
  ``ops/rowgemm.py::row_dot``) are read through their bodies like any
  package call;
* shapes are symbolic over the same config knobs CST-CFG resolves; a
  dim derived from ``len(...)`` is data-dependent (``?``) unless a
  registered ladder bucket function quantizes it;
* a call into the package evaluates the callee's returns under the
  caller's argument values — memoised per argument signature,
  depth-bounded — and prunes the branches a known argument decides
  (``x is None``, ``isinstance(tensor, PackageClass)``).

The surface is the CST-JIT traced set plus the closure of
``jit_registry.DEVICE_ROOTS`` over the package call graph.  Pure
stdlib ``ast``: reads source, never imports torch.
"""

from __future__ import annotations

import ast
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from cst_captioning_torch.analysis.astutil import (
    FuncInfo,
    ModuleInfo,
    call_name,
    dotted,
    resolved,
    resolved_call,
    walk_body,
)
from cst_captioning_torch.analysis.dataflow import DefUse

__all__ = [
    "AbstractValue",
    "TypeFlow",
    "binop_value",
    "build",
    "cast_call",
    "cast_sites",
    "promote_types",
    "result_type",
    "site_key",
    "tensor",
]

# --------------------------------------------------------- dtype lattice
#
# Concrete tensor dtypes, the Python scalars ("wi" int, "wf" float, "wb"
# bool), "none" (Python None), "any" (top) and "bottom".

FLOATS = ("f64", "f32", "bf16", "f16")
INTS = ("i64", "i32", "i16", "i8", "u8")
CONCRETE = FLOATS + INTS + ("bool",)
DEFAULT_FLOAT = "f32"       # torch.get_default_dtype(); the port keeps it
MAX_CALL_DEPTH = 8          # package calls followed into their returns

_FLOAT_RANK = {"f16": 1, "bf16": 1, "f32": 2, "f64": 3}
_INT_RANK = {"u8": 1, "i8": 1, "i16": 2, "i32": 3, "i64": 4}
_SCALAR_DTYPE = {"wi": "i64", "wf": DEFAULT_FLOAT, "wb": "bool"}

# torch.<name> dtype spellings -> lattice element
TORCH_DTYPES = {
    "float32": "f32", "float": "f32", "float64": "f64", "double": "f64",
    "bfloat16": "bf16", "float16": "f16", "half": "f16", "int64": "i64",
    "long": "i64", "int32": "i32", "int": "i32", "int16": "i16",
    "short": "i16", "int8": "i8", "uint8": "u8", "bool": "bool",
}
# Tensor cast methods -> target
CAST_METHODS = {
    "float": "f32", "double": "f64", "half": "f16", "bfloat16": "bf16",
    "long": "i64", "int": "i32", "short": "i16", "char": "i8",
    "byte": "u8", "bool": "bool",
}


def is_float(dt: str) -> bool:
    return dt in _FLOAT_RANK


def is_int(dt: str) -> bool:
    return dt in _INT_RANK


def promote_types(a: Optional[str], b: Optional[str]) -> Optional[str]:
    """``torch.promote_types`` over concrete dtypes (None: undefined)."""
    if a is None:
        return b
    if b is None or a == b:
        return a
    if a == "bool":
        return b
    if b == "bool":
        return a
    if is_float(a) and is_float(b):
        if {a, b} == {"bf16", "f16"}:
            return "f32"
        return a if _FLOAT_RANK[a] >= _FLOAT_RANK[b] else b
    if is_float(a) or is_float(b):
        return a if is_float(a) else b
    if {a, b} == {"u8", "i8"}:
        return "i16"
    if "u8" in (a, b):
        return b if a == "u8" else a
    return a if _INT_RANK[a] >= _INT_RANK[b] else b


def _combine(higher: Optional[str], lower: Optional[str]) -> Optional[str]:
    """ATen's ``combine_categories`` (no complex types here)."""
    if higher is None:
        return lower
    if is_float(higher) or lower is None:
        return higher
    if higher == "bool" or is_float(lower):
        return promote_types(higher, lower)
    return higher


@dataclass(frozen=True)
class AbstractValue:
    """One lattice point.  ``array``: True a tensor, False a Python
    value, None unknown; ``zero``: whether a tensor is zero-dim (None
    unknown); ``elts``: a tuple's elements."""

    dtype: str = "any"
    shape: Optional[Tuple["Dim", ...]] = None
    array: Optional[bool] = None
    zero: Optional[bool] = None
    elts: Optional[Tuple["AbstractValue", ...]] = None


def tensor(dt: str, zero: Optional[bool] = None, shape=None) -> AbstractValue:
    if shape is not None and zero is None:
        zero = len(shape) == 0
    return AbstractValue(dt, shape, True, zero)


ANY = AbstractValue()
NONE = AbstractValue("none", None, False)
PY = AbstractValue("any", None, False)
WI = AbstractValue("wi", (), False)
WF = AbstractValue("wf", (), False)
WB = AbstractValue("wb", (), False)


def result_type(operands: Sequence[AbstractValue]) -> str:
    """``torch.result_type`` over abstract operands: dimensioned tensors,
    then zero-dim tensors, then Python scalars, each rank moving the
    result only when of a higher category.  A tensor whose rank is
    unknown is tried both ways; the result is proven only if they
    agree."""
    for i, v in enumerate(operands):
        if v.array is True and v.zero is None:
            a = result_type([*operands[:i], _rank(v, True),
                             *operands[i + 1:]])
            b = result_type([*operands[:i], _rank(v, False),
                             *operands[i + 1:]])
            return a if a == b else "any"
    dim = zero = wrapped = None
    for v in operands:
        if v.array is None or v.dtype not in CONCRETE + ("wi", "wf", "wb"):
            return "any"
        if v.array is False:
            if v.dtype not in _SCALAR_DTYPE:
                return "any"
            wrapped = promote_types(wrapped, _SCALAR_DTYPE[v.dtype])
        elif v.zero:
            zero = promote_types(zero, v.dtype)
        else:
            dim = promote_types(dim, v.dtype)
    out = _combine(dim, _combine(zero, wrapped))
    return out or "any"


def _rank(v: AbstractValue, zero: bool) -> AbstractValue:
    return AbstractValue(v.dtype, v.shape, True, zero)


def _py_binop(op: ast.AST, a: str, b: str) -> str:
    """Python scalar arithmetic."""
    if isinstance(op, ast.Div):
        return "wf"
    if "wf" in (a, b):
        return "wf"
    if isinstance(op, (ast.BitAnd, ast.BitOr, ast.BitXor)) and a == b == "wb":
        return "wb"
    return "wi"


def binop_value(op: ast.AST, a: AbstractValue,
                b: AbstractValue) -> AbstractValue:
    """The abstract result of ``a <op> b``."""
    if a.array is False and b.array is False:
        if a.dtype in _SCALAR_DTYPE and b.dtype in _SCALAR_DTYPE:
            return AbstractValue(_py_binop(op, a.dtype, b.dtype), (), False)
        return PY
    arr = True if (a.array or b.array) else None
    dt = result_type([a, b])
    if isinstance(op, ast.Div) and (dt == "bool" or is_int(dt)):
        dt = DEFAULT_FLOAT         # true division of integers
    zero = (a.zero if b.array is False else b.zero if a.array is False
            else (a.zero and b.zero) if a.zero is not None
            and b.zero is not None else None)
    return AbstractValue(dt, None, arr, zero if arr else None)


# ---------------------------------------------------------- shape dims
#
# A dim is an int, a symbol (config knob / attribute chain / derived
# expression), or a DATA-DEPENDENT symbol prefixed "?" (derived from
# len(...) with no ladder bucket in between).

Dim = Union[int, str]

_OPS = {
    ast.Add: "+", ast.Sub: "-", ast.Mult: "*",
    ast.FloorDiv: "//", ast.Div: "/", ast.Mod: "%",
}


def dim_is_data_dependent(d: Dim) -> bool:
    return isinstance(d, str) and d.startswith("?")


def _dim_binop(op: ast.AST, a: Dim, b: Dim) -> Dim:
    if isinstance(a, int) and isinstance(b, int):
        if isinstance(op, ast.Add):
            return a + b
        if isinstance(op, ast.Sub):
            return a - b
        if isinstance(op, ast.Mult):
            return a * b
        if isinstance(op, ast.FloorDiv) and b:
            return a // b
    sym = f"({a}{_OPS.get(type(op), '?')}{b})"
    if dim_is_data_dependent(a) or dim_is_data_dependent(b):
        return "?" + sym
    return sym


# ------------------------------------------------------ call vocabulary

_FLOAT_CREATORS = frozenset({"zeros", "ones", "empty", "rand", "randn"})
_LIKE = frozenset({"zeros_like", "ones_like", "empty_like", "full_like",
                   "rand_like", "randn_like", "randint_like"})
_NEW = frozenset({"new_zeros", "new_ones", "new_empty", "new_full",
                  "new_tensor"})
_PRODUCTS = frozenset({"matmul", "mm", "bmm", "einsum", "linear", "addmm",
                       "baddbmm", "tensordot", "dot", "mv"})
_PASSTHROUGH = frozenset({
    "abs", "neg", "negative", "exp", "exp2", "log", "log1p", "log2", "expm1",
    "sqrt", "rsqrt", "tanh", "sigmoid", "sin", "cos", "relu", "gelu",
    "silu", "softmax", "clamp", "clamp_min", "clamp_max", "clip",
    "reshape", "permute", "transpose", "t", "contiguous", "clone",
    "detach", "squeeze", "unsqueeze", "expand", "expand_as", "repeat",
    "repeat_interleave", "flip", "roll", "narrow", "select",
    "index_select", "gather", "take_along_dim", "masked_fill",
    "masked_select", "tril", "triu", "flatten", "unflatten", "pad",
    "floor", "ceil", "round", "trunc", "sign", "square", "nan_to_num",
    "cpu", "cuda", "pin_memory", "requires_grad_", "movedim", "diagonal",
    "index_put", "scatter", "scatter_add", "index_add", "index_copy",
    "cummax", "cummin", "tile", "broadcast_to", "fliplr", "narrow_copy",
    "lerp", "addcmul", "addcdiv", "as_strided", "unfold", "chunk_",
})
_INPLACE_KEEP = frozenset({
    "add_", "sub_", "mul_", "div_", "copy_", "zero_", "fill_", "clamp_",
    "masked_fill_", "index_copy_", "index_add_", "scatter_", "addcdiv_",
    "addcmul_", "lerp_", "sqrt_", "neg_", "exp_", "log_", "tanh_",
    "sigmoid_", "uniform_", "normal_", "bernoulli_",
})
_BINARY = {"add": ast.Add(), "sub": ast.Sub(), "mul": ast.Mult(),
           "div": ast.Div(), "true_divide": ast.Div(),
           "floor_divide": ast.FloorDiv(), "remainder": ast.Mod(),
           "fmod": ast.Mod(), "maximum": ast.Add(), "minimum": ast.Add(),
           "pow": ast.Pow(), "bitwise_and": ast.BitAnd(),
           "bitwise_or": ast.BitOr(), "bitwise_xor": ast.BitXor(),
           "logical_and": None, "logical_or": None, "logical_not": None,
           "logical_xor": None}
_BOOL_FNS = frozenset({"isinf", "isnan", "isfinite", "eq", "ne", "lt",
                       "gt", "le", "ge", "any", "all", "isclose",
                       "equal", "logical_and", "logical_or",
                       "logical_not", "logical_xor", "signbit",
                       "isin"})
_INDEX_FNS = frozenset({"argmax", "argmin", "argsort", "nonzero",
                        "searchsorted", "bucketize", "multinomial",
                        "randperm", "randint", "unique_consecutive"})
_PAIR_FNS = frozenset({"topk", "sort", "kthvalue", "mode", "cummax",
                       "cummin"})
_REDUCTIONS = frozenset({"sum", "nansum", "prod", "mean", "std", "var",
                         "norm", "logsumexp", "amax", "amin", "max",
                         "min", "median", "cumsum", "cumprod"})
_INT_RESULT = frozenset({"numel", "dim", "ndimension", "nelement",
                         "element_size", "len", "int", "stride",
                         "data_ptr", "get_device"})


def site_key(mi: ModuleInfo, qualname: str) -> str:
    """Registry key for a cast site: ``<file>::<qualname>`` with
    ``<lambda#N>`` segments folded into their enclosing def."""
    parts = [p for p in qualname.split(".") if not p.startswith("<lambda")]
    return f"{mi.rel}::{'.'.join(parts) or '<module>'}"


def _torch_dtype_name(mi: ModuleInfo, expr: ast.AST) -> Optional[str]:
    name = resolved(mi, dotted(expr))
    if name.startswith("torch."):
        return TORCH_DTYPES.get(name[len("torch."):])
    return None


_DTYPE_HINTS = ("dtype", "cdt")
_DEVICE_HINTS = ("dev", "device")


def _hint(name: str) -> Optional[str]:
    low = name.lower()
    if any(h in low for h in _DTYPE_HINTS) or low in ("dt", "cd", "sdt"):
        return "dtype"
    if any(h in low for h in _DEVICE_HINTS):
        return "device"
    return None


def _ann_kind(ann: Optional[ast.AST]) -> Optional[str]:
    text = ast.unparse(ann) if ann is not None else ""
    if "dtype" in text:
        return "dtype"
    if "device" in text or text == "str":
        return "device"
    return None


class _FnTypes:
    """Abstract values for one function's expressions, evaluated over
    the def-use chains."""

    def __init__(self, tf: "TypeFlow", fn: FuncInfo, call_depth: int = 0):
        self.tf = tf
        self.fn = fn
        self.mi = fn.module
        self.du = tf.defuse(fn)
        self.call_depth = call_depth      # interprocedural nesting
        self._memo: Dict[int, AbstractValue] = {}

    # ----------------------------------------------------------- values
    def value_of(self, node: ast.AST, depth: int = 0) -> AbstractValue:
        key = id(node)
        if key in self._memo:
            return self._memo[key]
        if depth > 24:
            return ANY
        self._memo[key] = ANY            # cycle guard
        v = self._eval(node, depth)
        self._memo[key] = v
        return v

    def param_value(self, name: str) -> AbstractValue:
        return ANY

    def _name_value(self, node: ast.Name, depth: int) -> AbstractValue:
        b = self.du.reaching_def(node)
        if b is None:
            return self.tf.free_value(self.fn, node.id) if (
                not self.du.is_local(node.id)
            ) else ANY
        if b.kind == "param":
            return self.param_value(node.id)
        stmt = b.stmt
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and isinstance(
            getattr(stmt, "targets", [getattr(stmt, "target", None)])[0],
            (ast.Tuple, ast.List),
        ):
            # ``a, b = f(...)``: project the element
            tgt = (stmt.targets[0] if isinstance(stmt, ast.Assign)
                   else stmt.target)
            idx = next((i for i, e in enumerate(tgt.elts)
                        if isinstance(e, ast.Name) and e.id == node.id), None)
            if b.value is not None and not isinstance(
                stmt.value, (ast.Tuple, ast.List)
            ):
                whole = self.value_of(stmt.value, depth + 1)
                if whole.elts is not None and idx is not None and (
                    idx < len(whole.elts)
                ):
                    return whole.elts[idx]
                return ANY
            if b.value is None and _is_shape_expr(stmt.value):
                return WI
        if b.kind in ("for", "comp", "with", "except", "aug"):
            if b.kind == "aug" and isinstance(stmt, ast.AugAssign):
                prev = self.value_of(stmt.value, depth + 1)
                return binop_value(stmt.op, ANY, prev)
            return ANY
        if b.value is None:
            return ANY
        if isinstance(b.value, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return PY
        return self.value_of(b.value, depth + 1)

    def _eval(self, node: ast.AST, depth: int) -> AbstractValue:
        if isinstance(node, ast.Constant):
            v = node.value
            if v is None:
                return NONE
            if isinstance(v, bool):
                return WB
            if isinstance(v, int):
                return WI
            if isinstance(v, float):
                return WF
            return PY
        if isinstance(node, ast.Name):
            return self._name_value(node, depth)
        if isinstance(node, ast.BinOp):
            a = self.value_of(node.left, depth + 1)
            b = self.value_of(node.right, depth + 1)
            if isinstance(node.op, ast.MatMult):
                return self._product([a, b])
            return binop_value(node.op, a, b)
        if isinstance(node, ast.UnaryOp):
            v = self.value_of(node.operand, depth + 1)
            if isinstance(node.op, ast.Not):
                return WB
            return v
        if isinstance(node, ast.Compare):
            sides = [self.value_of(s, depth + 1)
                     for s in [node.left, *node.comparators]]
            if all(s.array is False for s in sides):
                return WB
            if any(s.array for s in sides):
                return AbstractValue("bool", None, True)
            return AbstractValue("bool", None, None)
        if isinstance(node, ast.BoolOp):
            return ANY
        if isinstance(node, ast.IfExp):
            truth = self.static_truth(node.test, depth)
            if truth is True:
                return self.value_of(node.body, depth + 1)
            if truth is False:
                return self.value_of(node.orelse, depth + 1)
            return join(self.value_of(node.body, depth + 1),
                        self.value_of(node.orelse, depth + 1))
        if isinstance(node, ast.Call):
            return self._eval_call(node, depth)
        if isinstance(node, ast.Subscript):
            base = self.value_of(node.value, depth + 1)
            if base.elts is not None:
                sl = node.slice
                if isinstance(sl, ast.Constant) and isinstance(sl.value, int):
                    if -len(base.elts) <= sl.value < len(base.elts):
                        return base.elts[sl.value]
                return ANY
            if _is_shape_expr(node.value):
                return WI
            if base.array:
                return AbstractValue(base.dtype, None, True, None)
            return ANY
        if isinstance(node, ast.Attribute):
            if node.attr in ("T", "mT", "real", "data"):
                return self.value_of(node.value, depth + 1)
            if node.attr in ("values", "indices"):
                base = self.value_of(node.value, depth + 1)
                if base.elts is not None and len(base.elts) == 2:
                    return base.elts[0 if node.attr == "values" else 1]
                return ANY
            if node.attr in ("shape", "dtype", "device"):
                return PY
            return ANY
        if isinstance(node, (ast.Tuple, ast.List)):
            return AbstractValue("any", None, False, None, tuple(
                self.value_of(e, depth + 1) for e in node.elts))
        if isinstance(node, (ast.JoinedStr, ast.Dict, ast.Set,
                             ast.ListComp, ast.DictComp, ast.SetComp,
                             ast.GeneratorExp, ast.Lambda)):
            return PY
        return ANY

    # ------------------------------------------------- static branching
    def static_truth(self, test: ast.AST, depth: int = 0) -> Optional[bool]:
        """True / False when the test is decided by what is known of the
        values it reads (``x is None``, ``isinstance(tensor, C)``), else
        None."""
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            t = self.static_truth(test.operand, depth)
            return None if t is None else not t
        if isinstance(test, ast.BoolOp):
            vals = [self.static_truth(v, depth) for v in test.values]
            if isinstance(test.op, ast.And):
                if False in vals:
                    return False
                return True if all(v is True for v in vals) else None
            if True in vals:
                return True
            return False if all(v is False for v in vals) else None
        if (
            isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], (ast.Is, ast.IsNot))
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
        ):
            v = self.value_of(test.left, depth + 1)
            is_none = (True if v.dtype == "none" else
                       False if v.array is True else None)
            if is_none is None:
                return None
            return is_none if isinstance(test.ops[0], ast.Is) else (
                not is_none)
        if isinstance(test, ast.Call) and call_name(test) == "isinstance" \
                and len(test.args) == 2:
            v = self.value_of(test.args[0], depth + 1)
            cls = resolved(self.mi, dotted(test.args[1]))
            if v.array is True and cls:
                return cls == "torch.Tensor"
        return None

    # ------------------------------------------------------------ dtypes
    def dtype_arg(self, expr: ast.AST, depth: int = 0) -> Optional[str]:
        """The lattice element a dtype-position expression names ("any"
        for a dtype not known statically), None when it is no dtype."""
        dt = _torch_dtype_name(self.mi, expr)
        if dt:
            return dt
        if isinstance(expr, ast.Attribute) and expr.attr == "dtype":
            v = self.value_of(expr.value, depth + 1)
            return v.dtype if v.dtype in CONCRETE else "any"
        if isinstance(expr, ast.Name) and depth < 12:
            b = self.du.reaching_def(expr)
            if b is not None and b.kind == "assign" and b.value is not None:
                dt = self.dtype_arg(b.value, depth + 1)
                if dt is not None:
                    return dt
        kind = self.arg_kind(expr, depth)
        return "any" if kind == "dtype" else None

    def arg_kind(self, expr: ast.AST, depth: int = 0) -> str:
        """``"dtype"``, ``"device"``, ``"tensor"`` or ``"unknown"`` for
        an argument of ``.to(...)``."""
        if depth > 12:
            return "unknown"
        if _torch_dtype_name(self.mi, expr):
            return "dtype"
        if isinstance(expr, ast.Constant):
            return "device" if isinstance(expr.value, (str, int)) or (
                expr.value is None) else "unknown"
        if isinstance(expr, ast.Attribute):
            if expr.attr == "dtype":
                return "dtype"
            if expr.attr == "device":
                return "device"
            h = _hint(expr.attr)
            if h:
                return h
        if isinstance(expr, ast.Call):
            name = resolved_call(self.mi, expr)
            if name == "torch.device":
                return "device"
            last = name.rsplit(".", 1)[-1]
            if "dtype" in last or last == "promote_types":
                return "dtype"
        if isinstance(expr, ast.Name):
            b = self.du.reaching_def(expr)
            if b is not None and b.kind == "param":
                k = _ann_kind(_param_annotation(self.fn, expr.id))
                if k:
                    return k
            elif b is not None and b.kind == "for":
                src = _loop_source(b.stmt, expr.id)
                h = _hint(dotted(src).rsplit(".", 1)[-1]) if src is not None \
                    else None
                if h:
                    return h
            elif b is not None and b.value is not None and not isinstance(
                b.value, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                k = self.arg_kind(b.value, depth + 1)
                if k != "unknown":
                    return k
            elif b is None and not self.du.is_local(expr.id):
                k = self.tf.enclosing_kind(self.fn, expr.id, depth)
                if k != "unknown":
                    return k
            h = _hint(expr.id)
            if h:
                return h
        v = self.value_of(expr, depth + 1)
        if v.array:
            return "tensor"
        return "unknown"

    def cast_target(self, node: ast.Call, depth: int = 0
                    ) -> Optional[Tuple[str, ast.AST, str]]:
        """``(kind, operand, target dtype)`` when ``node`` casts a
        tensor's dtype, else None (``.to(device)`` is no cast)."""
        f = node.func
        if not isinstance(f, ast.Attribute):
            return None
        if f.attr in CAST_METHODS and not node.args and not any(
            kw.arg not in ("memory_format",) for kw in node.keywords
        ):
            if isinstance(f.value, ast.Name) and f.value.id in (
                "torch", "np", "numpy", "math", "builtins"
            ):
                return None
            return (f".{f.attr}()", f.value, CAST_METHODS[f.attr])
        if f.attr == "type" and (node.args or node.keywords):
            arg = node.args[0] if node.args else node.keywords[0].value
            return (".type()", f.value, self.dtype_arg(arg, depth) or "any")
        if f.attr != "to":
            return None
        for kw in node.keywords:
            if kw.arg == "dtype":
                return (".to(dtype=)", f.value,
                        self.dtype_arg(kw.value, depth) or "any")
        if not node.args:
            return None
        kinds = [self.arg_kind(a, depth) for a in node.args[:2]]
        if kinds[0] == "dtype":
            return (".to(dtype)", f.value,
                    self.dtype_arg(node.args[0], depth) or "any")
        if kinds[0] == "tensor":
            return (".to(tensor)", f.value,
                    self.value_of(node.args[0], depth + 1).dtype)
        if len(kinds) > 1 and kinds[1] == "dtype":
            return (".to(device, dtype)", f.value,
                    self.dtype_arg(node.args[1], depth) or "any")
        if kinds[0] == "device":
            return None
        return (".to(?)", f.value, "any")

    def _product(self, ops: List[AbstractValue]) -> AbstractValue:
        if not ops:
            return ANY
        return AbstractValue(result_type(
            [AbstractValue(o.dtype, None, o.array, False) for o in ops]),
            None, True, None)

    def _kw(self, node: ast.Call, name: str) -> Optional[ast.AST]:
        return next((kw.value for kw in node.keywords if kw.arg == name),
                    None)

    def _dtype_kw(self, node: ast.Call, depth: int) -> Optional[str]:
        e = self._kw(node, "dtype")
        return None if e is None else (self.dtype_arg(e, depth) or "any")

    def _eval_call(self, node: ast.Call, depth: int) -> AbstractValue:
        cast = self.cast_target(node, depth)
        if cast is not None:
            base = self.value_of(cast[1], depth + 1)
            return AbstractValue(cast[2], base.shape, True, base.zero)
        name = resolved_call(self.mi, node)
        f = node.func
        base_name = name.rsplit(".", 1)[-1] if name else (
            f.attr if isinstance(f, ast.Attribute) else "")
        is_torch = name.startswith("torch.")
        method = isinstance(f, ast.Attribute) and not is_torch and not (
            isinstance(f.value, ast.Name) and f.value.id in self.mi.imports
        )
        recv = self.value_of(f.value, depth + 1) if method else None
        args = node.args
        dkw = self._dtype_kw(node, depth) if node.keywords else None

        if base_name in _INT_RESULT and (method or name == base_name):
            return WI
        if name == "float":
            return WF
        if name == "bool":
            return WB
        if method and base_name == "item" and recv is not None:
            if recv.dtype in CONCRETE:
                return (WB if recv.dtype == "bool" else
                        WI if is_int(recv.dtype) else WF)
            return PY
        if method and base_name in ("size",) and not args:
            return PY
        if method and base_name == "tolist":
            return PY
        if is_torch and base_name in _FLOAT_CREATORS:
            return tensor(dkw or DEFAULT_FLOAT, shape=self._shape(args, depth))
        if is_torch and base_name == "full" and len(args) >= 2:
            fill = self.value_of(args[1], depth + 1)
            dt = dkw or (_SCALAR_DTYPE.get(fill.dtype) if fill.array is False
                         else fill.dtype if fill.array else None) or "any"
            return tensor(dt, shape=self._shape(args[:1], depth))
        if is_torch and base_name == "arange":
            if dkw:
                return tensor(dkw, zero=False)
            vals = [self.value_of(a, depth + 1) for a in args]
            if any(v.dtype in ("wf",) or is_float(v.dtype) for v in vals):
                return tensor(DEFAULT_FLOAT, zero=False)
            if vals and all(v.dtype == "wi" or is_int(v.dtype)
                            for v in vals):
                return tensor("i64", zero=False)
            return tensor("any", zero=False)
        if is_torch and base_name in ("tensor", "as_tensor") and args:
            if dkw:
                return tensor(dkw, zero=_scalar_node(args[0]))
            v = self.value_of(args[0], depth + 1)
            if v.array:
                return v
            if v.array is False and v.dtype in _SCALAR_DTYPE:
                return tensor(_SCALAR_DTYPE[v.dtype], zero=True)
            if v.elts:
                dt = None
                for e in v.elts:
                    if e.dtype not in _SCALAR_DTYPE:
                        return tensor("any", zero=False)
                    dt = promote_types(dt, _SCALAR_DTYPE[e.dtype])
                return tensor(dt or "any", zero=False)
            return tensor("any")
        if is_torch and base_name in _LIKE and args:
            v = self.value_of(args[0], depth + 1)
            dt = dkw or (v.dtype if base_name not in (
                "rand_like", "randn_like") or is_float(v.dtype) else "any")
            return tensor(dt, zero=v.zero)
        if method and base_name in _NEW and recv is not None:
            return tensor(dkw or recv.dtype)
        if is_torch and base_name in ("randint", "randperm"):
            return tensor(dkw or "i64", zero=False)
        if base_name in _INDEX_FNS and (is_torch or method):
            return tensor("i64")
        if base_name in _BOOL_FNS and (is_torch or method):
            return tensor("bool")
        if base_name in _PAIR_FNS and (is_torch or method):
            v = recv if method else (self.value_of(args[0], depth + 1)
                                     if args else ANY)
            return AbstractValue("any", None, False, None, (
                tensor(v.dtype if v.array else "any"), tensor("i64")))
        if base_name in _REDUCTIONS and (is_torch or method):
            v = recv if method else (self.value_of(args[0], depth + 1)
                                     if args else ANY)
            rest = args if method else args[1:]
            has_dim = bool(rest) or self._kw(node, "dim") is not None
            dt = v.dtype if v.array else "any"
            if base_name in ("sum", "nansum", "prod", "cumsum", "cumprod") \
                    and (dt == "bool" or is_int(dt)):
                dt = "i64"
            if dkw:
                dt = dkw
            if base_name in ("max", "min", "median") and has_dim:
                return AbstractValue("any", None, False, None, (
                    tensor(dt), tensor("i64")))
            zero = None if has_dim else True
            if base_name in ("cumsum", "cumprod"):
                zero = v.zero
            return tensor(dt, zero=zero)
        if base_name in ("log_softmax", "softmax") and (is_torch or method):
            v = recv if method else (self.value_of(args[0], depth + 1)
                                     if args else ANY)
            return tensor(dkw or (v.dtype if v.array else "any"),
                          zero=v.zero)
        if base_name in _PRODUCTS and (is_torch or method):
            ops = ([recv] if method else []) + [
                self.value_of(a, depth + 1) for a in args
                if not (isinstance(a, ast.Constant)
                        and isinstance(a.value, str))]
            if base_name == "linear":
                ops = ops[:2]
            return self._product(ops)
        if is_torch and base_name == "where" and len(args) == 3:
            a = self.value_of(args[1], depth + 1)
            b = self.value_of(args[2], depth + 1)
            return AbstractValue(result_type([a, b]), None, True, None)
        if base_name in ("cat", "stack", "concat", "concatenate", "hstack",
                         "vstack") and is_torch and args:
            seq = self.value_of(args[0], depth + 1)
            if seq.elts:
                dt = None
                for e in seq.elts:
                    if not e.array or e.dtype not in CONCRETE:
                        return tensor("any", zero=False)
                    dt = promote_types(dt, e.dtype)
                return tensor(dt or "any", zero=False)
            return tensor("any", zero=False)
        if base_name in _BINARY and (is_torch or method):
            ops = ([recv] if method else []) + [
                self.value_of(a, depth + 1) for a in args]
            op = _BINARY[base_name]
            if op is None:
                return tensor("bool")
            if len(ops) >= 2:
                return binop_value(op, ops[0], ops[1])
        if base_name == "embedding" and is_torch and len(args) >= 2:
            w = self.value_of(args[1], depth + 1)
            return tensor(w.dtype if w.array else "any")
        if base_name == "view" and method and recv is not None:
            if args and _torch_dtype_name(self.mi, args[0]):
                return tensor(_torch_dtype_name(self.mi, args[0]))
            return AbstractValue(recv.dtype, None, recv.array, None)
        if base_name in _PASSTHROUGH and (is_torch or method):
            v = recv if method else (self.value_of(args[0], depth + 1)
                                     if args else ANY)
            if not v.array:
                return ANY
            keep_zero = base_name in ("clone", "detach", "contiguous",
                                      "abs", "neg", "exp", "log", "sqrt",
                                      "tanh", "sigmoid", "clamp", "cpu",
                                      "cuda", "floor", "ceil", "round")
            return AbstractValue(v.dtype, None, True,
                                 v.zero if keep_zero else None)
        if method and base_name == "to" and recv is not None and recv.array:
            return recv              # a device move keeps the dtype
        if method and base_name in _INPLACE_KEEP and recv is not None:
            return recv if recv.array else ANY
        callees = self.tf.resolve(self.mi, self.fn, node)
        if callees:
            return self.tf.return_value(callees[0], node, self, depth)
        return ANY

    def _shape(self, args: Sequence[ast.AST], depth: int
               ) -> Optional[Tuple[Dim, ...]]:
        if not args:
            return None
        if len(args) == 1 and isinstance(args[0], (ast.Tuple, ast.List)):
            return tuple(self.dim_of(e, depth + 1) for e in args[0].elts)
        if len(args) == 1 and not isinstance(args[0], ast.Constant):
            v = self.value_of(args[0], depth + 1)
            if v.array is not False or v.dtype != "wi":
                return None
        return tuple(self.dim_of(a, depth + 1) for a in args)

    def shape_arg(self, node: ast.Call) -> Optional[Tuple[Dim, ...]]:
        """The symbolic shape a creator call builds."""
        return self._shape(node.args, 0)

    def dim_of(self, expr: ast.AST, depth: int = 0) -> Dim:
        """Symbolic value of one shape-dimension expression: ints fold,
        attribute chains become knob symbols, ``len(...)`` taints the
        dim data-dependent, a registered bucket call launders it."""
        if depth > 24:
            return "?"
        if isinstance(expr, ast.Constant) and isinstance(expr.value, int):
            return expr.value
        if isinstance(expr, ast.Name):
            b = self.du.reaching_def(expr)
            if b is None or b.kind == "param":
                return expr.id
            if b.value is None or b.kind in ("for", "comp"):
                return expr.id
            return self.dim_of(b.value, depth + 1)
        if isinstance(expr, ast.Attribute):
            return dotted(expr) or expr.attr
        if isinstance(expr, ast.BinOp):
            return _dim_binop(expr.op, self.dim_of(expr.left, depth + 1),
                              self.dim_of(expr.right, depth + 1))
        if isinstance(expr, ast.Call):
            name = (call_name(expr) or "").rsplit(".", 1)[-1]
            if name == "len":
                if expr.args and self._config_chain(expr.args[0], depth):
                    return f"len({dotted(expr.args[0]) or '...'})"
                return "?len"
            if name in self.tf.bucket_fn_names:
                return f"bucket:{name}"
            if name in ("min", "max") and expr.args:
                dims = [self.dim_of(a, depth + 1) for a in expr.args]
                sym = f"{name}({','.join(map(str, dims))})"
                return "?" + sym if any(
                    dim_is_data_dependent(d) for d in dims) else sym
            if name == "int" and expr.args:
                return self.dim_of(expr.args[0], depth + 1)
            return f"{name}()"
        if isinstance(expr, ast.Subscript) and isinstance(
            expr.value, ast.Attribute
        ) and expr.value.attr == "shape":
            return f"{dotted(expr.value.value) or 'x'}.shape[...]"
        return "unknown"

    def _config_chain(self, expr: ast.AST, depth: int) -> bool:
        """Whether ``expr`` reads a config section (``cfg.data.x``, or a
        name bound from one): its length is a knob, fixed per process."""
        for _ in range(8):
            name = dotted(expr)
            if not name:
                return False
            if any(p in ("cfg", "config") for p in name.split(".")):
                return True
            head = expr
            while isinstance(head, ast.Attribute):
                head = head.value
            if not isinstance(head, ast.Name):
                return False
            b = self.du.reaching_def(head)
            if b is None or b.value is None:
                return False
            expr = b.value
        return False

    # ----------------------------------------------------------- returns
    def returns(self, depth: int = 0) -> List[ast.Return]:
        """The return statements that can run, the branches the known
        values decide pruned."""
        out: List[ast.Return] = []

        def visit(stmts) -> None:
            for s in stmts:
                if isinstance(s, ast.Return):
                    out.append(s)
                elif isinstance(s, ast.If):
                    t = self.static_truth(s.test, depth)
                    if t is not False:
                        visit(s.body)
                    if t is not True:
                        visit(s.orelse)
                elif isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
                    visit(s.body)
                    visit(s.orelse)
                elif isinstance(s, (ast.With, ast.AsyncWith)):
                    visit(s.body)
                elif isinstance(s, ast.Try):
                    visit(s.body)
                    for h in s.handlers:
                        visit(h.body)
                    visit(s.orelse)
                    visit(s.finalbody)

        body = getattr(self.fn.node, "body", [])
        if isinstance(body, list):
            visit(body)
        return out


def _loop_source(stmt: ast.AST, name: str) -> Optional[ast.AST]:
    """What a ``for`` target ``name`` iterates: the loop's iterable, or
    the matching ``zip`` argument for a tuple target."""
    if not isinstance(stmt, (ast.For, ast.AsyncFor)):
        return None
    tgt, it = stmt.target, stmt.iter
    if isinstance(tgt, ast.Name):
        return it
    if isinstance(tgt, ast.Tuple) and isinstance(it, ast.Call) and \
            call_name(it) == "zip":
        for e, a in zip(tgt.elts, it.args):
            if isinstance(e, ast.Name) and e.id == name:
                return a
    return None


def _scalar_node(node: ast.AST) -> Optional[bool]:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return False
    return None


def _is_shape_expr(node: Optional[ast.AST]) -> bool:
    """``x.shape`` / ``x.shape[i]`` / ``x.size()`` (Python ints)."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr == "shape":
        return True
    return isinstance(node, ast.Call) and isinstance(
        node.func, ast.Attribute) and node.func.attr == "size"


def _param_annotation(fn: FuncInfo, name: str) -> Optional[ast.AST]:
    a = fn.node.args
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        if p.arg == name:
            return p.annotation
    return None


def join(a: AbstractValue, b: AbstractValue) -> AbstractValue:
    """Least upper bound of two values (both branches of a choice)."""
    if a == b:
        return a
    if a.dtype == "bottom":
        return b
    if b.dtype == "bottom":
        return a
    if a.elts is not None and b.elts is not None and len(a.elts) == len(
        b.elts
    ):
        return AbstractValue("any", None, False, None, tuple(
            join(x, y) for x, y in zip(a.elts, b.elts)))
    dt = a.dtype if a.dtype == b.dtype else "any"
    arr = a.array if a.array == b.array else None
    zero = a.zero if a.zero == b.zero else None
    return AbstractValue(dt, a.shape if a.shape == b.shape else None, arr,
                         zero)


class _CalleeTypes(_FnTypes):
    """A callee evaluated under the caller's argument values: positional
    and keyword arguments map onto parameters, an unpassed parameter
    defaulting to None is None, the rest stay top."""

    def __init__(self, tf: "TypeFlow", fn: FuncInfo,
                 args: Dict[str, AbstractValue], call_depth: int):
        super().__init__(tf, fn, call_depth)
        self._args = args

    def param_value(self, name: str) -> AbstractValue:
        return self._args.get(name, ANY)


def _bind_args(fn: FuncInfo, args: Sequence[AbstractValue],
               kwargs: Dict[str, AbstractValue]) -> Dict[str, AbstractValue]:
    a = fn.node.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    if pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    out: Dict[str, AbstractValue] = {}
    for p, v in zip(pos, args):
        out[p] = v
    out.update({k: v for k, v in kwargs.items() if k is not None})
    all_pos = a.posonlyargs + a.args
    for p, d in zip(all_pos[len(all_pos) - len(a.defaults):], a.defaults):
        if p.arg not in out and isinstance(d, ast.Constant) and d.value is None:
            out[p.arg] = NONE
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if p.arg not in out and isinstance(d, ast.Constant) and d.value is None:
            out[p.arg] = NONE
    return out


class TypeFlow:
    """The package-wide flow: the surface (traced set plus the
    ``DEVICE_ROOTS`` closure) and lazy per-function environments."""

    def __init__(self, modules: List[ModuleInfo], ctx):
        t0 = time.perf_counter()
        from cst_captioning_torch.analysis import jit_boundary as jb

        self.modules = modules
        self.ctx = ctx
        self.by_rel = {m.rel: m for m in modules}
        self.traced = jb.traced_set(modules, ctx)
        self.surface: Dict[Tuple[str, str], str] = dict(self.traced.reason)
        self._close_device_roots()
        self._du: Dict[Tuple[str, str], DefUse] = {}
        self._fn_types: Dict[Tuple[str, str], _FnTypes] = {}
        self._ret_memo: Dict[tuple, AbstractValue] = {}
        self.bucket_fn_names = self._bucket_fn_names()
        self.duration_s = time.perf_counter() - t0

    def _close_device_roots(self) -> None:
        from cst_captioning_torch.analysis import jit_registry
        from cst_captioning_torch.analysis.dataflow import expand_call_closure

        seeds = []
        for key, why in jit_registry.DEVICE_ROOTS.items():
            rel, _, qn = key.partition("::")
            mi = self.by_rel.get(rel)
            if mi is not None and qn in mi.functions:
                fn = mi.functions[qn]
                if (rel, qn) not in self.surface:
                    self.surface[(rel, qn)] = f"device root: {why}"
                seeds.append(fn)

        def admit(fn: FuncInfo, reason: str) -> bool:
            k = (fn.module.rel, fn.qualname)
            if k in self.surface:
                return False
            self.surface[k] = reason
            return True

        expand_call_closure(self.modules, self.ctx, seeds, admit)

    @staticmethod
    def _bucket_fn_names() -> frozenset:
        from cst_captioning_torch.analysis import jit_registry

        return frozenset(
            fq.split("::")[-1].rsplit(".", 1)[-1]
            for e in jit_registry.SHAPE_LADDER_REGISTRY.values()
            for fq in e.bucket_fns
        )

    # --------------------------------------------------------- plumbing
    def defuse(self, fn: FuncInfo) -> DefUse:
        k = (fn.module.rel, fn.qualname)
        if k not in self._du:
            self._du[k] = DefUse(fn)
        return self._du[k]

    def types_of(self, fn: FuncInfo) -> _FnTypes:
        k = (fn.module.rel, fn.qualname)
        if k not in self._fn_types:
            self._fn_types[k] = _FnTypes(self, fn)
        return self._fn_types[k]

    def resolve(self, mi: ModuleInfo, fn: FuncInfo, call: ast.Call):
        return self.ctx.index.resolve_call(mi, fn, call)

    def surface_functions(self) -> List[FuncInfo]:
        out = []
        for rel, qn in sorted(self.surface):
            mi = self.by_rel.get(rel)
            if mi is not None and qn in mi.functions:
                out.append(mi.functions[qn])
        return out

    def traced_functions(self) -> List[FuncInfo]:
        return self.traced.functions(self.modules)

    def enclosing_kind(self, fn: FuncInfo, name: str, depth: int) -> str:
        """:meth:`_FnTypes.arg_kind` of a closure read: the last binding
        of ``name`` in the nearest enclosing function that binds it."""
        from cst_captioning_torch.analysis.dataflow import _enclosing_scopes

        for enc in _enclosing_scopes(fn):
            types = self.types_of(enc)
            bs = types.du.bindings_of(name)
            if bs:
                b = bs[-1]
                if b.value is None or isinstance(
                    b.value, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    return "unknown"
                return types.arg_kind(b.value, depth + 1)
        return "unknown"

    def free_value(self, fn: FuncInfo, name: str) -> AbstractValue:
        """A module-level constant read by name (``NEG_INF = -1e30``)."""
        from cst_captioning_torch.analysis.astutil import module_literal

        mi = fn.module
        imp = mi.imports.get(name)
        if imp is not None:
            modname, _, sym = imp.rpartition(".")
            mi = self.ctx.index.by_modname.get(modname)
            if mi is None:
                return ANY
            name = sym
        value = module_literal(mi, name)
        if isinstance(value, ast.Constant):
            v = value.value
            if isinstance(v, bool):
                return WB
            if isinstance(v, int):
                return WI
            if isinstance(v, float):
                return WF
        return ANY

    # ------------------------------------------- interprocedural return
    def return_value(self, callee: FuncInfo, call: ast.Call,
                     caller: _FnTypes, depth: int) -> AbstractValue:
        if caller.call_depth >= MAX_CALL_DEPTH or not isinstance(
            callee.node, (ast.FunctionDef, ast.AsyncFunctionDef)
        ) or any(isinstance(a, ast.Starred) for a in call.args):
            return ANY
        args = [caller.value_of(a, depth + 1) for a in call.args]
        kwargs = {kw.arg: caller.value_of(kw.value, depth + 1)
                  for kw in call.keywords if kw.arg}
        return self.call_value(callee, args, kwargs, caller.call_depth + 1)

    def call_value(self, callee: FuncInfo, args: Sequence[AbstractValue],
                   kwargs: Dict[str, AbstractValue],
                   depth: int = 0) -> AbstractValue:
        """The join of ``callee``'s reachable returns under the given
        argument values (``depth``: calls deep, bounded by
        :data:`MAX_CALL_DEPTH`)."""
        bound = _bind_args(callee, args, kwargs)
        sig = tuple(sorted(bound.items(), key=lambda kv: kv[0]))
        mk = (callee.module.rel, callee.qualname, sig)
        if mk in self._ret_memo:
            return self._ret_memo[mk]
        self._ret_memo[mk] = ANY            # recursion guard
        types = _CalleeTypes(self, callee, bound, depth)
        out = AbstractValue("bottom")
        for r in types.returns():
            v = types.value_of(r.value) if r.value is not None else NONE
            out = join(out, v)
        if out.dtype == "bottom" and out.elts is None:
            out = NONE if not types.returns() else ANY
        self._ret_memo[mk] = out
        return out

    def prove(self, key: str, args: Sequence[AbstractValue] = (),
              kwargs: Optional[Dict[str, AbstractValue]] = None
              ) -> AbstractValue:
        """What ``<file>::<qualname>`` returns under the given argument
        values (the live check of chip_smoke phase 12d)."""
        rel, _, qn = key.partition("::")
        mi = self.by_rel[rel]
        return self.call_value(mi.functions[qn], list(args),
                               dict(kwargs or {}))


# --------------------------------------------------------- cast surface

def cast_call(types: _FnTypes, node: ast.Call):
    """``(kind, target)`` when ``node`` casts a dtype, else None."""
    t = types.cast_target(node)
    return None if t is None else (t[0], t[2])


def cast_sites(tf: TypeFlow):
    """Every dtype cast inside the surface, as ``(registry_key, module,
    function, call, kind, target)`` — what CST-DTY-001 audits."""
    out = []
    for fn in tf.surface_functions():
        types = tf.types_of(fn)
        calls = sorted((n for n in walk_body(fn) if isinstance(n, ast.Call)),
                       key=lambda n: (n.lineno, n.col_offset))
        for node in calls:
            if isinstance(node, ast.Call):
                c = cast_call(types, node)
                if c is not None:
                    out.append((site_key(fn.module, fn.qualname),
                                fn.module, fn, node, c[0], c[1]))
    return out


# ------------------------------------------------------------ lifecycle

_CACHE: List[Tuple[object, tuple, TypeFlow]] = []


def build(modules: List[ModuleInfo], ctx) -> TypeFlow:
    """Build (or reuse: CST-DTY and CST-SHP share one flow per engine
    run) the TypeFlow of a scanned module list and the registries it
    reads."""
    from cst_captioning_torch.analysis import jit_registry

    stamp = (tuple(sorted(jit_registry.DEVICE_ROOTS)),
             tuple(sorted(jit_registry.SHAPE_LADDER_REGISTRY.items())))
    for obj, st, tf in _CACHE:
        if obj is modules and st == stamp:
            return tf
    tf = TypeFlow(modules, ctx)
    _CACHE[:] = [(modules, stamp, tf)]
    return tf
