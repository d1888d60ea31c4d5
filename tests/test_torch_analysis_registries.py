"""The port's registries (``analysis/jit_registry.py``) guarded both ways
on the port's own source: take a live site's entry out and its rule
fires at the site; add an entry no site matches and it fires at the
registry.  Plus the two update-step rules on a copy of the package whose
``Optimizer.step`` loses its update (CST-DON-001, CST-DTY-004).

Every case runs one family's checker over one shared scan of the
package (module-scoped), with the registry patched for the case alone.
"""

import shutil
from pathlib import Path

import pytest

from cst_captioning_torch.analysis import jit_registry as jr
from cst_captioning_torch.analysis import run_analysis
from cst_captioning_torch.analysis.astutil import PackageIndex, scan_package
from cst_captioning_torch.analysis.engine import (
    CHECKERS,
    CheckContext,
    _load_checkers,
    default_suppressions_path,
    load_suppressions,
)

PACKAGE_ROOT = Path(__file__).resolve().parent.parent / "cst_captioning_torch"
REGISTRY = "analysis/jit_registry.py"


@pytest.fixture(scope="module")
def world():
    _load_checkers()
    mods = [m for m in scan_package(PACKAGE_ROOT)
            if not m.rel.startswith("analysis/")]
    return mods, CheckContext(index=PackageIndex(mods),
                              package_root=PACKAGE_ROOT, docs_root=None)


def _run(world, family):
    mods, ctx = world
    return CHECKERS[family](mods, ctx)


def _at(findings, rule):
    return {(f.file, f.line, f.symbol) for f in findings if f.rule == rule}


def _dropped(monkeypatch, name, key):
    reg = dict(getattr(jr, name))
    entry = reg.pop(key)
    monkeypatch.setattr(jr, name, reg)
    return entry


@pytest.mark.parametrize("family", ["donation", "dtypeflow", "shapeflow",
                                    "partitioning"])
def test_each_registry_family_is_clean_as_committed(world, family):
    sups, problems = load_suppressions(default_suppressions_path())
    assert not problems
    left = [f for f in _run(world, family) if not any(
        (s.rule, s.file, s.symbol) == (f.rule, f.file, f.symbol)
        for s in sups)]
    assert left == []


# ---------------------------------------------------- kernel sites (DON)

def test_unregistering_a_kernel_site_fires_don002(world, monkeypatch):
    _dropped(monkeypatch, "JIT_SITE_REGISTRY", "ops/rowgemm.py::_bound")
    assert _at(_run(world, "donation"), "CST-DON-002") == {
        ("ops/rowgemm.py", 109, "_bound")}


def test_an_entry_naming_another_kernel_fires_don002(world, monkeypatch):
    monkeypatch.setitem(jr.JIT_SITE_REGISTRY, "ops/beam.py::_bound",
                        jr.JitSite("wrong kernel", ("lstm_sample",)))
    found = _at(_run(world, "donation"), "CST-DON-002")
    assert {(f, s) for f, _, s in found} == {("ops/beam.py", "_bound")}


@pytest.mark.parametrize("key,site", [
    ("ops/lstm.py::_gone", jr.JitSite("moved", ("lstm_recurrence",))),
    ("training/steps.py::Optimizer.gone", jr.JitSite(
        "moved", update_step=True)),
])
def test_a_stale_kernel_site_entry_fires_don003(world, monkeypatch, key,
                                                site):
    monkeypatch.setitem(jr.JIT_SITE_REGISTRY, key, site)
    assert _at(_run(world, "donation"), "CST-DON-003") == {
        (REGISTRY, 1, key)}


def test_unregistering_an_aot_site_fires_don004(world, monkeypatch):
    _dropped(monkeypatch, "AOT_SITE_REGISTRY",
             "serving/artifact.py::load_engine")
    found = _at(_run(world, "donation"), "CST-DON-004")
    assert {(f, s) for f, _, s in found} == {
        ("serving/artifact.py", "load_engine")}


def test_a_stale_aot_entry_fires_don005(world, monkeypatch):
    key = "serving/artifact.py::build_artifact_v0"
    monkeypatch.setitem(jr.AOT_SITE_REGISTRY, key, "moved")
    assert _at(_run(world, "donation"), "CST-DON-005") == {
        (REGISTRY, 1, key)}


# ------------------------------------------------------------- casts (DTY)

def test_unregistering_a_cast_site_fires_dty001(world, monkeypatch):
    _dropped(monkeypatch, "CAST_REGISTRY", "ops/losses.py::reward_criterion")
    found = _at(_run(world, "dtypeflow"), "CST-DTY-001")
    assert found == {("ops/losses.py", 64, "reward_criterion")}


@pytest.mark.parametrize("tier", ["token_exact", "close-enough", ""])
def test_an_illegal_cast_tier_fires_dty001(world, monkeypatch, tier):
    key = "decoding/core.py::decode_step"
    old = jr.CAST_REGISTRY[key]
    monkeypatch.setitem(jr.CAST_REGISTRY, key,
                        jr.CastSite(tier, old.justification))
    found = [f for f in _run(world, "dtypeflow") if f.rule == "CST-DTY-001"]
    assert [(f.file, f.symbol) for f in found] == [(REGISTRY, key)]
    assert "illegal parity tier" in found[0].message


def test_a_stale_cast_entry_fires_dty001(world, monkeypatch):
    key = "ops/losses.py::gone"
    monkeypatch.setitem(jr.CAST_REGISTRY, key,
                        jr.CastSite("bit-exact", "moved"))
    assert _at(_run(world, "dtypeflow"), "CST-DTY-001") == {
        (REGISTRY, 1, key)}


def test_a_low_precision_entry_holds_its_products(world, monkeypatch):
    """``_finish_bwd``'s context ``bmm`` and its three weight-cotangent
    ``@`` products run in the work dtype, which the flow cannot prove
    float32: marked low-precision, each fires CST-DTY-003."""
    key = "ops/attlstm.py::_finish_bwd"
    old = jr.CAST_REGISTRY[key]
    monkeypatch.setitem(jr.CAST_REGISTRY, key, old._replace(
        low_precision=True))
    found = {f for f in _at(_run(world, "dtypeflow"), "CST-DTY-003")
             if f[0] == "ops/attlstm.py"}
    assert {s for _, _, s in found} == {"_finish_bwd"}
    assert sorted(ln for _, ln, _ in found) == [591, 596, 597, 598]


# ---------------------------------------------------- shape ladders (SHP)

def test_a_missing_ladder_entry_fires_shp001(world, monkeypatch):
    _dropped(monkeypatch, "SHAPE_LADDER_REGISTRY",
             "ops/attention.py::_bound_bwd")
    assert _at(_run(world, "shapeflow"), "CST-SHP-001") == {
        ("ops/attention.py", 412, "_bound_bwd")}


def test_a_stale_ladder_entry_fires_shp001(world, monkeypatch):
    key = "ops/attention.py::_bound_v0"
    monkeypatch.setitem(jr.SHAPE_LADDER_REGISTRY, key,
                        jr.ShapeLadder("fixed", "moved"))
    assert _at(_run(world, "shapeflow"), "CST-SHP-001") == {
        (REGISTRY, 1, key)}


def test_a_dead_bucket_function_fires_shp001(world, monkeypatch):
    key = "ops/beam.py::_bound"
    old = jr.SHAPE_LADDER_REGISTRY[key]
    monkeypatch.setitem(jr.SHAPE_LADDER_REGISTRY, key, old._replace(
        bucket_fns=old.bucket_fns + ("serving/engine.py::_gone_ladder",)))
    found = [f for f in _run(world, "shapeflow")
             if f.rule == "CST-SHP-001"]
    assert [(f.file, f.symbol) for f in found] == [(REGISTRY, key)]
    assert "_gone_ladder" in found[0].message


def test_an_enumerated_ladder_without_buckets_fires_shp001(world,
                                                          monkeypatch):
    key = "ops/rowgemm.py::_bound"
    monkeypatch.setitem(jr.SHAPE_LADDER_REGISTRY, key,
                        jr.ShapeLadder("enumerated", "no quantizer"))
    assert _at(_run(world, "shapeflow"), "CST-SHP-001") == {
        ("ops/rowgemm.py", 109, "_bound")}


def test_an_unrunnable_variant_kind_fires_shp002(world, monkeypatch):
    monkeypatch.setattr(jr, "AOT_VARIANT_RUNNERS", {})
    found = _at(_run(world, "shapeflow"), "CST-SHP-002")
    assert {(f, s) for f, _, s in found} == {
        ("serving/slots.py", "SlotDecoder._variants")}


def test_a_stale_variant_runner_fires_shp002(world, monkeypatch):
    monkeypatch.setattr(jr, "AOT_VARIANT_RUNNERS", {
        "serving/slots.py::SlotDecoder": {"free": "_free_rows"}})
    found = _at(_run(world, "shapeflow"), "CST-SHP-002")
    assert (REGISTRY, 1, "serving/slots.py::SlotDecoder") in found


# --------------------------------------- collectives and pins (SHD)

def test_unregistering_a_collective_fires_shd004(world, monkeypatch):
    _dropped(monkeypatch, "SHARD_MAP_REGISTRY",
             "parallel/distributed.py::stop_agreed")
    found = _at(_run(world, "partitioning"), "CST-SHD-004")
    assert {(f, s) for f, _, s in found} == {
        ("parallel/distributed.py", "stop_agreed")}


def test_a_stale_collective_entry_fires_shd004(world, monkeypatch):
    key = "training/sharded.py::_fold_v0"
    monkeypatch.setitem(jr.SHARD_MAP_REGISTRY, key, "moved")
    assert _at(_run(world, "partitioning"), "CST-SHD-004") == {
        (REGISTRY, 1, key)}


def test_a_stale_placement_pin_fires_shd002(world, monkeypatch):
    key = "models/vocab_shards.py::VocabShards.split_v0"
    monkeypatch.setitem(jr.SHARDING_CONSTRAINT_REGISTRY, key, "moved")
    assert _at(_run(world, "partitioning"), "CST-SHD-002") == {
        (REGISTRY, 1, key)}


# ------------------------------------------ the update step, mutated

@pytest.mark.parametrize("edit,rules", [
    # the parameter rebound to a new tensor: the model keeps the old one
    ("p = p + lr.to(p.device) * u", ["CST-DON-001"]),
    # the moment replaced in its dict
    ("self.mu[k] = mu + 0", ["CST-DON-001"]),
    # the update written into a cast of the parameter, which is also a
    # cast the update step's registry entry does not cover
    ("p.float().add_(lr.to(p.device) * u)", ["CST-DTY-001",
                                               "CST-DTY-004"]),
])
def test_a_lossy_update_step_fires(tmp_path, edit, rules):
    root = tmp_path / "pkg"
    shutil.copytree(PACKAGE_ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "_kernels_build", "*.so", "*.cu", "*.cuh"))
    steps = root / "training" / "steps.py"
    src = steps.read_text()
    live = "            p.add_(lr.to(p.device) * u)\n"
    assert src.count(live) == 1
    steps.write_text(src.replace(live, f"            {edit}\n"))
    line = steps.read_text().splitlines().index(f"            {edit}") + 1
    family = "dtypeflow" if "CST-DTY-004" in rules else "donation"
    rep = run_analysis(root, rules=[family])
    assert [(f.rule, f.file, f.line, f.symbol) for f in rep.findings] == [
        (rule, "training/steps.py", line, "Optimizer.step")
        for rule in rules]
