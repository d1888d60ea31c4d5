"""The port's invariant engine (``cst_captioning_torch/analysis/``) over
the port's own source:

* the whole package runs CLEAN — zero unsuppressed findings, every
  suppression justified and matched (one module-scoped run);
* each family SEES the surface it guards (locks and roots, knob reads
  in the port's idioms, thread targets, fault sites, span emissions,
  kernel / AOT / collective / placement sites, update steps, threefry
  draws and seeded generators, the device surface's casts, an empty
  traced set), so a clean run cannot be a blind one;
* the report and SARIF documents validate; the CLI's exit codes
  (0 / 1 / 2, the budget forced, not measured), ``--baseline`` /
  ``--fail-on-new`` and ``--changed-only`` on a copy of the package;
* the suppression file's discipline and the incremental cache;
* importing the engine or running its CLI pulls in neither torch nor
  jax nor the JAX package.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cst_captioning_torch.analysis import (
    CHECKERS,
    run_analysis,
    to_sarif,
    validate_report,
    validate_sarif,
)
from cst_captioning_torch.analysis.__main__ import main as cli_main
from cst_captioning_torch.analysis.astutil import PackageIndex, scan_package
from cst_captioning_torch.analysis.engine import (
    CheckContext,
    default_suppressions_path,
    load_suppressions,
)

REPO = Path(__file__).resolve().parent.parent
PACKAGE_ROOT = REPO / "cst_captioning_torch"
CORPUS = Path(__file__).resolve().parent / "torch_analysis_corpus"

FAMILIES = {
    "configflow", "donation", "dtypeflow", "exceptions", "jit_boundary",
    "metrics_registry", "observability", "partitioning", "resilience",
    "rng", "shapeflow", "single_site", "thread_safety",
}


@pytest.fixture(scope="module")
def report():
    return run_analysis()


@pytest.fixture(scope="module")
def world():
    mods = [
        m for m in scan_package(PACKAGE_ROOT)
        if not m.rel.startswith("analysis/")
    ]
    ctx = CheckContext(
        index=PackageIndex(mods), package_root=PACKAGE_ROOT, docs_root=None
    )
    return mods, ctx


def _copy_package(dst: Path) -> Path:
    shutil.copytree(
        PACKAGE_ROOT, dst,
        ignore=shutil.ignore_patterns(
            "__pycache__", "_kernels_build", "*.so", "*.cu", "*.cuh"
        ),
    )
    return dst


# --------------------------------------------------- the package is clean

class TestPackageClean:
    def test_zero_unsuppressed_findings(self, report):
        assert report.clean, "\n" + report.render()
        assert report.files_scanned > 50
        assert set(report.rules_run) == FAMILIES == set(CHECKERS)
        assert set(report.family_s) == FAMILIES
        # suppressions must not rot: every entry still matches a finding
        assert not report.unused_suppressions, report.unused_suppressions

    def test_every_suppression_is_justified_and_no_resolver_gap(
        self, report
    ):
        entries, problems = load_suppressions(default_suppressions_path())
        assert not problems
        assert entries
        for s in entries:
            assert len(s.justification.split()) >= 20, s
        # the knobs the port reads in its own idioms are resolved, not
        # suppressed
        suppressed = {f.symbol for f, _ in report.suppressed}
        for knob in (
            "train.optimizer", "train.learning_rate", "train.beta1",
            "train.epsilon", "train.grad_clip", "model.use_pallas_beam",
            "model.param_dtype",
        ):
            assert knob not in suppressed

    def test_json_report_validates(self, report):
        rec = report.to_dict()
        assert validate_report(rec) is rec
        assert rec["suppressed"] and all(
            s["justification"] for s in rec["suppressed"]
        )

    def test_sarif_document_validates(self, report):
        doc = validate_sarif(to_sarif(report.to_dict()))
        results = doc["runs"][0]["results"]
        assert len(results) == len(report.suppressed)
        assert all(r["level"] == "note" and r["suppressions"]
                   for r in results)


# --------------------------------- the families see what they guard

class TestFamiliesSeeThePort:
    def test_thread_pass_sees_the_serving_lock_graph(self, world):
        from cst_captioning_torch.analysis import thread_safety as ts

        mods, ctx = world
        w = ts._World(mods, ctx)
        assert {
            "_BatcherBase._cond", "ReplicaSet._cond",
            "ServingMetrics._replicas_lock", "LRUCache._lock",
            "CaptionServer._shutdown_lock",
        } <= w.locks
        roots = ts._collect_roots(w)
        kinds = {qn: kind for (_, qn), (kind, _) in roots.items()}
        assert kinds.get("_BatcherBase.submit") == "multi"
        assert kinds.get("ReplicaSet.kill_replica") == "multi"
        assert kinds.get("_Handler.do_POST") == "multi"
        assert "ReplicaSet._worker" in kinds
        _, edges = ts._reachability(w, roots)
        assert any(a == "_BatcherBase._cond" for (a, b) in edges), edges
        assert not ts._find_cycles(edges)

    def test_configflow_sees_the_port_read_idioms(self, world):
        from cst_captioning_torch.analysis import configflow as cf

        mods, ctx = world
        fields = cf.declared_fields(cf.find_config_module(mods))
        assert set(fields) == {"data", "model", "train", "eval", "serving"}
        accesses = cf.collect_accesses(mods, ctx, set(fields))
        knobs = {(s, f) for s, f, _, _, k in accesses if k != "store"}
        # Optimizer(params, cfg_train, ...) binds __init__'s parameter
        for f in ("optimizer", "learning_rate", "lr_decay",
                  "lr_decay_every", "grad_clip", "weight_decay", "beta1",
                  "beta2", "epsilon"):
            assert ("train", f) in knobs, f
        # for what, flag in ((..., "use_pallas_beam"), ...): gate(flag)
        assert ("model", "use_pallas_beam") in knobs
        assert ("model", "use_pallas_sampler") in knobs
        # getattr(sv, "...") on a section parameter
        assert ("serving", "trace_buffer_spans") in knobs
        assert ("serving", "flight_events") in knobs
        assert ("model", "param_dtype") in knobs

    def test_exceptions_pass_sees_the_thread_surface(self, world):
        from cst_captioning_torch.analysis import exceptions as ex

        mods, ctx = world
        targets = {
            fn.qualname for _, _, fn in ex.thread_targets(mods)
            if fn is not None
        }
        assert {
            "_BatcherBase._run", "ReplicaSet._worker",
            "prefetch_to_device.worker", "CaptionServer._signal_shutdown",
        } <= targets
        assert "CaptionServer.shutdown" not in targets
        roots = ex.collect_roots(mods)
        assert "reward pool" in roots.values()
        assert any(qn == "_Handler.do_POST" for (_, qn) in roots)
        reach = ex.reachable_from_roots(mods, ctx)
        assert len(reach) > len(roots)
        reachable = [
            h for h in ex.broad_handlers(mods)
            if (h[0].rel, h[1].qualname) in reach
        ]
        assert len(reachable) >= 5
        assert all(not silent for *_, silent in reachable)

    def test_resilience_pass_sees_the_injection_sites(self, world):
        from cst_captioning_torch.analysis import resilience as rz

        mods, _ = world
        sites = rz.fire_sites(mods)
        assert len(sites) >= 6
        assert {n for _, _, n in sites if n} == set(rz.load_sites(mods))
        assert {m.rel for m, _, _ in sites} == {
            "serving/batcher.py", "serving/replicas.py"
        }
        for mi, node, name in sites:
            assert rz._is_guarded(mi, node), f"{mi.rel}:{node.lineno}"

    def test_registries_are_read_from_source(self, world):
        from cst_captioning_torch.analysis import metrics_registry as mr
        from cst_captioning_torch.analysis import observability as ob

        mods, _ = world
        metrics = [p for p, _ in mr.load_registry(mods)]
        assert len(metrics) == len(set(metrics)) > 30
        assert "caption_latency_*_ms" in metrics
        patterns = ob.load_patterns(mods)
        assert {"request", "cst/step", "phase/*", "worker_death"} <= set(
            patterns
        )
        emitting = {mi.rel for mi, _ in ob.emission_sites(mods)}
        assert {"serving/batcher.py", "serving/replicas.py",
                "training/steps.py"} <= emitting


class TestTorchFamiliesSeeThePort:
    """The seven families of the traced surface and the registries, read
    in their torch meaning: what each finds on the port's source."""

    def test_the_traced_set_is_empty(self, world):
        """The port has no torch.compile / TorchScript / CUDA-graph
        root, so CST-JIT, CST-OBS-003, CST-RES-003 and CST-SHP-003 judge
        nothing on its source today; the corpus shows they fire."""
        from cst_captioning_torch.analysis import jit_boundary as jb

        mods, ctx = world
        ts = jb.traced_set(mods, ctx)
        assert ts.reason == {} and ts.roots == set() and ts.regions == []

    def test_kernel_and_aot_sites_match_the_build(self, world):
        from cst_captioning_torch.analysis import donation
        from cst_captioning_torch.analysis import jit_registry as jr
        from cst_captioning_torch.ops import _build

        mods, _ = world
        sites = donation.collect_kernel_sites(mods)
        assert len(sites) == 8
        assert {k for *_, k in sites} == set(_build.SOURCES) == set(
            jr.kernel_names())
        assert jr.nvcc_budget() == len(_build.SOURCES)
        aot = donation.collect_aot_sites(mods)
        assert sorted(k for k, *_ in aot) == sorted(jr.AOT_SITE_REGISTRY)
        assert len(aot) == 2

    def test_update_steps_write_in_place(self, world):
        from cst_captioning_torch.analysis import donation

        mods, _ = world
        steps = dict(donation.update_step_sites(mods))
        assert set(steps) == {"training/steps.py::Optimizer.step",
                              "training/sharded.py::MeshModel.broadcast"}
        aliases, containers = donation._alias_names(
            steps["training/steps.py::Optimizer.step"])
        assert {"p", "mu", "nu"} <= set(aliases)
        assert {"params", "mu", "nu"} <= containers
        for fn in steps.values():
            assert donation.state_rebinds(fn) == []

    def test_random_streams(self, world):
        from cst_captioning_torch.analysis import rng

        mods, _ = world
        draws = {(mi.rel, fn.qualname, name)
                 for mi, fn, _, name in rng.draw_sites(mods)}
        assert draws == {
            ("decoding/core.py", "decode_step", "threefry_sample"),
            ("decoding/core.py", "row_sample_fn.fn", "threefry_sample"),
            ("ops/threefry.py", "threefry_sample", "categorical_ref"),
        }
        gens = [
            (mi.rel, node.lineno) for mi in mods for node in ast.walk(mi.tree)
            if isinstance(node, ast.Call)
            and rng.resolved_call(mi, node) == rng.GENERATOR
        ]
        assert len(gens) == 8
        assert {r for r, _ in gens} >= {"training/trainer.py",
                                        "training/sharded.py",
                                        "models/captioner.py"}

    def test_collectives_and_placement_pins(self, world):
        from cst_captioning_torch.analysis import jit_registry as jr
        from cst_captioning_torch.analysis import partitioning as pt

        mods, _ = world
        coll, pins = set(), set()
        for mi in mods:
            for node in ast.walk(mi.tree):
                if isinstance(node, ast.Call):
                    key = f"{mi.rel}::{mi.qualname_of(node)}"
                    if pt.is_collective_call(mi, node):
                        coll.add(key)
                    if pt.is_pin_call(mi, node):
                        pins.add(key)
        assert coll == set(jr.SHARD_MAP_REGISTRY) and len(coll) == 13
        assert pins == set(jr.SHARDING_CONSTRAINT_REGISTRY) and len(pins) == 3
        assert any(k.startswith("parallel/distributed.py") for k in coll)

    def test_device_surface_and_its_casts(self, world):
        from cst_captioning_torch.analysis import jit_registry as jr
        from cst_captioning_torch.analysis import typeflow

        mods, ctx = world
        tf = typeflow.build(mods, ctx)
        for key in jr.DEVICE_ROOTS:
            assert tuple(key.split("::")) in tf.surface, key
        assert len(tf.surface) > 150
        sites = typeflow.cast_sites(tf)
        assert {k for k, *_ in sites} == set(jr.CAST_REGISTRY)
        assert len(jr.CAST_REGISTRY) == 59 and len(sites) > 150
        kinds = {kind for *_, kind, _ in sites}
        assert {".float()", ".long()", ".int()", ".to(dtype)"} <= kinds
        # a device move is no cast
        assert not any(
            "training/steps.py::global_norm" == k and "to(dev" in
            ast.unparse(call) for k, _, _, call, *_ in sites)

    def test_slot_loop_variants_reach_warmup(self, world):
        from cst_captioning_torch.analysis import shapeflow as sf

        mods, _ = world
        [(mi, cls, methods)] = sf.aot_contract_classes(mods)
        assert (mi.rel, cls) == ("serving/slots.py", "SlotDecoder")
        kinds = sf._yielded_kinds(methods["_variants"])
        assert set(kinds) == {"tick", "free", "resize"}
        warm = sf._reachable_methods(methods, "warmup")
        runners = {k: sf.variant_runner(mi, cls, methods, k) for k in kinds}
        assert runners == {"tick": "tick", "free": "_zero_slots",
                           "resize": "_resize"}
        assert set(runners.values()) <= warm


# --------------------------------------------------------------- the CLI

class TestCLI:
    def test_json_exit_zero_and_valid(self, capsys):
        assert cli_main(["--json", "--rules", "resilience,metrics_registry"]) == 0
        rec = validate_report(json.loads(capsys.readouterr().out))
        assert rec["clean"] and rec["files_scanned"] > 50

    def test_sarif_on_the_corpus_exits_one(self, capsys):
        rc = cli_main(["--sarif", "--root", str(CORPUS),
                       "--rules", "resilience"])
        assert rc == 1
        doc = validate_sarif(json.loads(capsys.readouterr().out))
        ids = {r["ruleId"] for r in doc["runs"][0]["results"]}
        # RES-003 reads the traced set: the corpus seeds it in a
        # CUDA-graph capture and in the reference corpus's twin
        assert ids == {"CST-RES-001", "CST-RES-002", "CST-RES-003"}

    @pytest.mark.parametrize("cache", [False, True])
    def test_forced_budget_exits_two(self, tmp_path, monkeypatch, capsys,
                                     cache):
        monkeypatch.setenv("ANALYSIS_BUDGET_S", "1e-9")
        args = ["--root", str(CORPUS), "--rules", "resilience"]
        if cache:
            args += ["--cache-dir", str(tmp_path / "cache")]
            monkeypatch.setenv("ANALYSIS_BUDGET_S", "0")
            assert cli_main(args) == 1          # budget off: findings
            monkeypatch.setenv("ANALYSIS_BUDGET_S", "1e-9")
        assert cli_main(args) == 2
        assert "ANALYSIS BUDGET EXCEEDED" in capsys.readouterr().err

    def test_baseline_and_fail_on_new(self, tmp_path, capsys):
        root = _copy_package(tmp_path / "pkg")
        rules = ["--root", str(root), "--rules", "resilience,metrics_registry"]
        assert cli_main(["--json", *rules]) == 0
        base = tmp_path / "base.json"
        base.write_text(capsys.readouterr().out)
        bad = root / "serving" / "added.py"
        bad.write_text(
            "def tick(self):\n"
            "    self.chaos.fire('tick_stall')\n"
            "    return 'caption_new_series_total 1'\n"
        )
        assert cli_main([*rules, "--baseline", str(base),
                         "--fail-on-new"]) == 1
        out = capsys.readouterr().out
        assert "NEW: serving/added.py:2: CST-RES-002" in out
        assert "NEW: serving/added.py:3: CST-MET-001" in out
        assert "0 known finding(s) absorbed, 2 new" in out
        # the same findings, once in the baseline, are absorbed
        assert cli_main(["--json", *rules]) == 1
        base.write_text(capsys.readouterr().out)
        assert cli_main([*rules, "--baseline", str(base),
                         "--fail-on-new"]) == 0
        assert "2 known finding(s) absorbed, 0 new" in capsys.readouterr().out
        assert cli_main([*rules, "--baseline", str(base)]) == 1
        bad_base = tmp_path / "bad.json"
        bad_base.write_text("[{\"rule\": 1}]")
        with pytest.raises(SystemExit) as e:
            cli_main([*rules, "--baseline", str(bad_base)])
        assert e.value.code == 2

    def test_changed_only(self, tmp_path, capsys):
        root = _copy_package(tmp_path / "pkg")
        args = ["--changed-only", "--root", str(root),
                "--rules", "resilience", "--cache-dir",
                str(tmp_path / "cache")]
        assert cli_main(args) == 0            # no baseline: all, clean
        capsys.readouterr()
        replicas = root / "serving" / "replicas.py"
        replicas.write_text(
            replicas.read_text()
            + "\n\ndef _unguarded(self):\n"
              "    self.chaos.fire('replica_kill')\n"
        )
        assert cli_main(args) == 1
        out = capsys.readouterr().out
        assert "serving/replicas.py" in out and "CST-RES-002" in out
        assert "1 changed file(s)" in out
        assert cli_main(args) == 0            # nothing changed since
        assert "0 finding(s)" in capsys.readouterr().out


# ------------------------------------------------- suppressions and cache

def _finding_file(tmp_path, entries):
    p = tmp_path / "sup.json"
    p.write_text(json.dumps({"entries": entries}))
    return p


class TestSuppressions:
    RULES = ["resilience"]

    def test_entry_without_justification_is_a_finding(self, tmp_path):
        p = _finding_file(tmp_path, [{
            "rule": "CST-RES-002", "file": "resilience/chaos_bad.py",
            "symbol": "Scheduler.tick", "justification": "  ",
        }])
        rep = run_analysis(CORPUS, rules=self.RULES, suppressions_path=p)
        assert "CST-SUP-001" in {f.rule for f in rep.findings}
        assert "CST-RES-002" in {f.rule for f in rep.findings}

    def test_matching_suppression_moves_finding_aside(self, tmp_path):
        p = _finding_file(tmp_path, [{
            "rule": "CST-RES-002", "file": "resilience/chaos_bad.py",
            "symbol": "Scheduler.tick",
            "justification": "corpus: the seeded unguarded fire",
        }])
        rep = run_analysis(CORPUS, rules=self.RULES, suppressions_path=p)
        assert [f.rule for f in rep.findings
                if f.file == "resilience/chaos_bad.py"] == ["CST-RES-001"]
        assert [f.rule for f, _ in rep.suppressed] == ["CST-RES-002"]
        assert not rep.unused_suppressions

    def test_stale_and_expired_entries_surface(self, tmp_path):
        p = _finding_file(tmp_path, [
            {"rule": "CST-RES-001", "file": "nowhere.py", "symbol": "x",
             "justification": "matches nothing"},
            {"rule": "CST-RES-001", "file": "resilience/chaos_bad.py",
             "symbol": "Scheduler.tick", "justification": "old debt",
             "expires": "2000-01-01"},
        ])
        rep = run_analysis(CORPUS, rules=self.RULES, suppressions_path=p)
        assert [s.file for s in rep.unused_suppressions] == ["nowhere.py"]
        assert "CST-SUP-002" in {f.rule for f in rep.findings}

    def test_malformed_file_is_a_finding_not_a_crash(self, tmp_path):
        p = tmp_path / "sup.json"
        p.write_text("{not json")
        rep = run_analysis(CORPUS, rules=self.RULES, suppressions_path=p)
        assert "CST-SUP-001" in {f.rule for f in rep.findings}


class TestIncrementalCache:
    def test_warm_run_is_byte_identical_and_invalidates(self, tmp_path):
        root = tmp_path / "corpus"
        shutil.copytree(CORPUS, root)
        cache = tmp_path / "cache"
        rules = ["resilience", "observability"]
        cold = run_analysis(root, rules=rules, cache_dir=cache)
        warm = run_analysis(root, rules=rules, cache_dir=cache)
        assert cold.cache_hit_files == 0
        assert warm.cache_hit_files == warm.files_scanned > 0
        assert warm.family_s == {}
        assert json.dumps(cold.to_stable_dict(), sort_keys=True) == \
            json.dumps(warm.to_stable_dict(), sort_keys=True)
        other = run_analysis(root, rules=["resilience"], cache_dir=cache)
        assert other.cache_hit_files == 0
        bad = root / "resilience" / "chaos_bad.py"
        bad.write_text(bad.read_text().replace(
            '"nccl_timeout"', '"replica_kill"'))
        again = run_analysis(root, rules=rules, cache_dir=cache)
        assert again.cache_hit_files == 0
        assert "CST-RES-001" not in {
            f.rule for f in again.findings
            if f.file == "resilience/chaos_bad.py"}


# ---------------------------------------------------- no framework imports

@pytest.mark.parametrize("code", [
    "import cst_captioning_torch.analysis",
    "from cst_captioning_torch.analysis.__main__ import main; "
    "rc = main(['--rules', 'resilience,metrics_registry'])",
    "from cst_captioning_torch.analysis import lockwatch",
])
def test_no_framework_imports(code):
    probe = (
        f"{code}\nimport sys\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'cst_captioning_tpu'))\n"
        "print('LOADED', bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe], cwd=str(REPO),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
