"""The type flow (``analysis/typeflow.py``) against torch itself, on the
CPU: the engine never imports torch, so these tests are where its
promotion lattice and its proofs meet the real library.

* :func:`typeflow.result_type` equals ``torch.result_type`` over a grid
  of dtypes as dimensioned tensors, zero-dim tensors and Python scalars,
  and true division of integers gives the default float;
* small functions parsed from source: the dtype the interpreter proves
  for each equals the dtype torch gives when the same function runs;
* the port's own functions whose result dtype the flow proves (what
  chip_smoke phase 12d holds on the card in bf16): ``greedy_pick``,
  ``beam_log_softmax``, ``row_dot``, ``weighted_cross_entropy``,
  ``pg_loss``'s loss and ``mask_decode_logits``, each run here on CPU
  tensors and compared.
"""

import ast
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from cst_captioning_torch.analysis import typeflow as T
from cst_captioning_torch.analysis.astutil import PackageIndex, scan_package
from cst_captioning_torch.analysis.engine import CheckContext

PACKAGE_ROOT = Path(__file__).resolve().parent.parent / "cst_captioning_torch"

TORCH = {
    "f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
    "f16": torch.float16, "i64": torch.int64, "i32": torch.int32,
    "i16": torch.int16, "i8": torch.int8, "u8": torch.uint8,
    "bool": torch.bool,
}
LATTICE = {v: k for k, v in TORCH.items()}
SCALARS = {"wf": 1.5, "wi": 2, "wb": True}


def _operands():
    for dt in TORCH:
        yield ("dim", dt), T.tensor(dt, zero=False), torch.ones(
            2, dtype=TORCH[dt])
        yield ("zero", dt), T.tensor(dt, zero=True), torch.ones(
            (), dtype=TORCH[dt])
    for w, v in SCALARS.items():
        yield ("scalar", w), T.AbstractValue(w, (), False), v


OPERANDS = list(_operands())


@pytest.mark.parametrize(
    "left", [o for o in OPERANDS if o[0][0] != "scalar"],
    ids=lambda o: f"{o[0][0]}-{o[0][1]}")
def test_result_type_is_torchs(left):
    (_, _), a_abs, a = left
    for (kind, name), b_abs, b in OPERANDS:
        want = LATTICE[torch.result_type(a, b)]
        assert T.result_type([a_abs, b_abs]) == want, (left[0], name)
        # true division of integers (and bools) gives the default float
        if not (a.dtype == torch.bool and kind == "scalar"
                and isinstance(b, bool)):
            got = T.binop_value(ast.Div(), a_abs, b_abs).dtype
            assert got == LATTICE[(a / b).dtype], (left[0], name)
        # comparisons give bool
        assert T.AbstractValue("bool").dtype == LATTICE[(a > b).dtype]


def test_an_unknown_rank_is_proven_only_when_both_readings_agree():
    f32, bf16 = T.tensor("f32"), T.tensor("bf16")
    assert f32.zero is None
    # f32 beside a dimensioned bf16: bf16 if the f32 is zero-dim, f32
    # if it has dims — unknown
    assert T.result_type([f32, T.tensor("bf16", zero=False)]) == "any"
    # f32 with dims beside a bf16 of any rank: f32 either way
    assert T.result_type([T.tensor("f32", zero=False), bf16]) == "f32"
    # a Python float never moves a float tensor
    assert T.result_type([bf16, T.WF]) == "bf16"


# -------------------------------------------- proofs of parsed functions

SNIPPETS = '''
import torch


def int_times_float(x):
    return torch.arange(4) * 0.5


def bf16_times_float(x):
    return x.to(torch.bfloat16) * 3.0


def bf16_times_zero_dim_f32(x):
    return x.to(torch.bfloat16) * torch.tensor(2.0)


def zero_dim_int_times_f16(x):
    return torch.tensor(3) * x.to(torch.float16)


def int_div_int(x):
    return torch.arange(4) / torch.arange(1, 5)


def floor_div_int(x):
    return torch.arange(4) // 2


def compare(x):
    return torch.arange(4) > 1


def zeros_default(x):
    return torch.zeros((2, 3))


def full_int(x):
    return torch.full((2,), 7)


def full_float(x):
    return torch.full((2,), 7.0)


def arange_float(x):
    return torch.arange(0.0, 1.0, 0.25)


def to_device(x):
    return x.to("cpu")


def to_device_dtype(x):
    return x.to("cpu", torch.float16)


def to_other(x):
    return x.to(torch.arange(3))


def type_cast(x):
    return x.type(torch.float64)


def long_cast(x):
    return x.long()


def sum_of_bools(x):
    return (x > 0).sum()


def bf16_product(x):
    return x.to(torch.bfloat16) @ x.to(torch.bfloat16).T


def where_f16_and_float(x):
    return torch.where(x > 0, x.to(torch.float16), 0.0)


def cat_floats(x):
    return torch.cat([x.float(), x.half()])


def max_indices(x):
    return x.max(dim=0).indices


def topk_values(x):
    return torch.topk(x.to(torch.bfloat16), 2).values


def log_softmax_f32(x):
    return torch.log_softmax(x.half().float(), dim=-1)


def through_a_call(x):
    return _helper(x.to(torch.bfloat16), None)


def _helper(h, scale=None):
    out = h.float() * 2.0
    return out if scale is None else out * scale
'''


@pytest.fixture(scope="module")
def snippets(tmp_path_factory):
    root = tmp_path_factory.mktemp("flow")
    (root / "snippets.py").write_text(SNIPPETS)
    mods = scan_package(root)
    ctx = CheckContext(index=PackageIndex(mods), package_root=root,
                       docs_root=None)
    spec = importlib.util.spec_from_file_location("snippets",
                                                  root / "snippets.py")
    live = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(live)
    return T.TypeFlow(mods, ctx), live


NAMES = [n.name for n in ast.parse(SNIPPETS).body
         if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]


@pytest.mark.parametrize("name", NAMES)
def test_the_proven_dtype_is_the_live_one(snippets, name):
    tf, live = snippets
    x = torch.ones((3, 3), dtype=torch.float32)
    got = getattr(live, name)(x)
    proven = tf.prove(f"snippets.py::{name}", [T.tensor("f32", zero=False)])
    assert proven.array and proven.dtype == LATTICE[got.dtype], name


def test_a_device_move_is_no_cast(snippets):
    tf, _ = snippets
    fn = tf.by_rel["snippets.py"].functions
    kinds = {}
    for name in ("to_device", "to_device_dtype", "to_other", "type_cast",
                 "long_cast"):
        types = tf.types_of(fn[name])
        calls = [n for n in ast.walk(fn[name].node)
                 if isinstance(n, ast.Call)]
        kinds[name] = [T.cast_call(types, c) for c in calls
                       if T.cast_call(types, c)]
    assert kinds["to_device"] == []
    assert kinds["to_device_dtype"] == [(".to(device, dtype)", "f16")]
    assert kinds["to_other"] == [(".to(tensor)", "i64")]
    assert kinds["type_cast"] == [(".type()", "f64")]
    assert kinds["long_cast"] == [(".long()", "i64")]


# ------------------------------------------ the port's proven functions

@pytest.fixture(scope="module")
def port_flow():
    mods = [m for m in scan_package(PACKAGE_ROOT)
            if not m.rel.startswith("analysis/")]
    ctx = CheckContext(index=PackageIndex(mods), package_root=PACKAGE_ROOT,
                       docs_root=None)
    return T.TypeFlow(mods, ctx)


def _abs(t):
    return T.tensor(LATTICE[t.dtype], zero=t.dim() == 0)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
def test_the_ports_proofs_are_the_live_dtypes(port_flow, cdt):
    from cst_captioning_torch.decoding.core import (
        beam_log_softmax,
        greedy_pick,
    )
    from cst_captioning_torch.models.captioner import CaptionModel
    from cst_captioning_torch.ops.losses import weighted_cross_entropy
    from cst_captioning_torch.ops.rowgemm import row_dot

    g = torch.Generator().manual_seed(0)
    h = torch.randn((6, 16), generator=g).to(cdt)
    w = torch.randn((16, 40), generator=g).to(cdt)
    proofs = []
    logits = row_dot(h, w, cdt)
    proofs.append(("ops/rowgemm.py::row_dot", [_abs(h), _abs(w), T.PY],
                   logits))
    masked = CaptionModel.mask_decode_logits(logits)
    proofs.append(("models/captioner.py::CaptionModel.mask_decode_logits",
                   [_abs(logits)], masked))
    proofs.append(("decoding/core.py::beam_log_softmax", [_abs(masked)],
                   beam_log_softmax(masked)))
    tok, lp = greedy_pick(masked)
    proven = port_flow.prove("decoding/core.py::greedy_pick",
                             [_abs(masked)])
    assert [e.dtype for e in proven.elts] == [LATTICE[tok.dtype],
                                              LATTICE[lp.dtype]]
    seq_logits = torch.randn((2, 5, 40), generator=g).to(cdt)
    targets = torch.from_numpy(np.arange(10).reshape(2, 5) % 40)
    mask = torch.ones((2, 5))
    weights = torch.ones((2,))
    loss = weighted_cross_entropy(seq_logits, targets, mask, weights)
    proofs.append(("ops/losses.py::weighted_cross_entropy",
                   [_abs(seq_logits), _abs(targets), _abs(mask),
                    _abs(weights)], loss))
    for key, args, live in proofs:
        proven = port_flow.prove(key, args)
        assert proven.dtype == LATTICE[live.dtype], key
    assert port_flow.prove("training/cst.py::pg_loss").dtype == "f32"
    assert {LATTICE[tok.dtype], LATTICE[loss.dtype]} == {"i64", "f32"}


def test_the_lattice_names_every_torch_dtype_it_uses():
    for name, el in T.TORCH_DTYPES.items():
        assert LATTICE[getattr(torch, name)] == el
    for a, b in itertools.product(TORCH, repeat=2):
        assert T.promote_types(a, b) == LATTICE[
            torch.promote_types(TORCH[a], TORCH[b])], (a, b)
