"""The port's invariant engine against the JAX package's on the JAX
package's own seeded corpus (``tests/analysis_corpus/``), family by
family, all thirteen families.  Each family's files are copied twice
into ``tmp_path``: the reference side as they are, the port side either
renamed (``cst_captioning_tpu`` -> ``cst_captioning_torch``: the files
whose constructs are framework-free — lock graphs, knob reads, metric
and span names, fault sites, the partition and capability tables) or as
their line-aligned twin in the port's idioms from
``tests/torch_analysis_corpus/parity/`` (the files written in JAX idioms:
``jax.jit`` roots, ``jax.random`` keys, ``astype``, ``shard_map``).
Each engine's ``run_analysis`` runs over its copy, and the (rule, file,
line, symbol) sets must be equal.

Two readings make the sets comparable, and nothing else is left out:

* the reference keys a jit-by-call site ``<scope>::<target>``, the port
  keys every site by its qualname, so symbols compare with ``::`` read
  as ``.``;
* each registry holds its own package's sites, so findings at the
  registries themselves (stale entries, ``analysis/jit_registry.py``)
  are not compared; the corpus's update steps and low-precision paths
  are registered in each engine's registry for the run (the JAX
  package's corpus test registers the same ones).

:data:`UNTRANSLATABLE` names any reference finding with no torch
construct behind it; every line of these files has a counterpart.
"""

from pathlib import Path

import pytest

from cst_captioning_torch.analysis import jit_registry as port_reg
from cst_captioning_torch.analysis import run_analysis as torch_run
from cst_captioning_tpu.analysis import jit_registry as ref_reg
from cst_captioning_tpu.analysis import run_analysis as jax_run

TESTS = Path(__file__).resolve().parent
CORPUS = TESTS / "analysis_corpus"
TWINS = TESTS / "torch_analysis_corpus" / "parity"

FILES = {
    "thread_safety": ("serving/lock_inversion.py",),
    "metrics_registry": ("serving/metrics_bad.py",),
    "configflow": ("configflow/config.py", "configflow/knobs_bad.py",
                   "configflow/docs/ANALYSIS.md"),
    "exceptions": ("exceptions/exc_bad.py",),
    "observability": ("observability/trace_bad.py",),
    "resilience": ("resilience/chaos_bad.py",),
    "jit_boundary": ("jit_host_state.py",),
    "donation": ("donation_bad.py",),
    "single_site": ("decode_reimpl.py",),
    "rng": ("rng/rng_bad.py",),
    "partitioning": ("partition_bad.py", "shard_caps_bad.py"),
    "dtypeflow": ("typeflow/dty_bad.py", "typeflow/quant_bad.py",
                  "typeflow/quant_kernel_bad.py"),
    "shapeflow": ("typeflow/shp_bad.py", "serving/dispatch_bad.py"),
}
# (rule, file, line) of a reference finding with no torch construct
# behind it -> why.  Empty: every seeded line has a torch counterpart.
UNTRANSLATABLE = {}
NOT_PORTED = set()

REF_SITES = {
    "donation_bad.py::make_bad_update_step::train_step": ref_reg.JitSite(
        "corpus-injected update step", update_step=True),
}
PORT_SITES = {
    "donation_bad.py::make_bad_update_step.train_step": port_reg.JitSite(
        "corpus-injected update step", update_step=True),
    # the port's DTY-004 reads update steps where the reference reads
    # donate_argnums
    "typeflow/dty_bad.py::donated_step": port_reg.JitSite(
        "corpus-injected update step", update_step=True),
}
LOW_PRECISION = {
    "typeflow/dty_bad.py::registered_low_precision": "relaxed-rtol",
    "typeflow/quant_bad.py::registered_quant_path": "relaxed-serving",
    "typeflow/quant_kernel_bad.py::registered_kernel_dequant":
        "relaxed-serving",
}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    base = tmp_path_factory.mktemp("parity")
    for family, files in FILES.items():
        for rel in files:
            twin = TWINS / rel
            for side, src in (("ref", CORPUS / rel),
                              ("port", twin if twin.exists()
                               else CORPUS / rel)):
                text = src.read_text()
                if side == "port":
                    text = text.replace("cst_captioning_tpu",
                                        "cst_captioning_torch")
                dst = base / family / side / rel
                dst.parent.mkdir(parents=True, exist_ok=True)
                dst.write_text(text)
    return base


@pytest.fixture
def registered(monkeypatch):
    """The corpus's update steps and low-precision paths, in each
    engine's registry for one test."""
    for reg, sites in ((ref_reg, REF_SITES), (port_reg, PORT_SITES)):
        for k, v in sites.items():
            monkeypatch.setitem(reg.JIT_SITE_REGISTRY, k, v)
        for k, tier in LOW_PRECISION.items():
            monkeypatch.setitem(reg.CAST_REGISTRY, k, reg.CastSite(
                tier, "corpus-injected low-precision path",
                low_precision=True))


def _keys(report, files):
    return {
        (f.rule, f.file, f.line, f.symbol.replace("::", "."))
        for f in report.findings
        if f.file in files and f.rule not in NOT_PORTED
        and (f.rule, f.file, f.line) not in UNTRANSLATABLE
    }


@pytest.mark.parametrize("family", sorted(FILES))
def test_same_findings_as_the_reference(corpora, family, tmp_path,
                                        registered):
    files = FILES[family]
    ref, port = corpora / family / "ref", corpora / family / "port"
    # CST-CFG-003 reads the corpus's docs twin; the other families run
    # doc-less, as the reference corpus test runs them.
    cfg = family == "configflow"
    none = tmp_path / "no-suppressions.json"
    want = _keys(jax_run(
        ref, rules=[family], suppressions_path=none,
        docs_root=ref / "configflow" / "docs" if cfg else None), files)
    got = _keys(torch_run(
        port, rules=[family], suppressions_path=none,
        docs_root=port / "configflow" / "docs" if cfg else None), files)
    assert want, f"{family}: the reference found nothing on its corpus"
    assert got == want, (
        f"{family}: port-only {sorted(got - want)}, "
        f"reference-only {sorted(want - got)}"
    )


def test_every_twin_is_line_aligned_and_every_family_compared():
    """A twin seeds the same ``# expect:`` lines as its original, and no
    family or rule is left out of the comparison."""
    import re

    def expects(path):
        return {
            (n, tuple(sorted(r.strip() for r in m.group(1).split(","))))
            for n, line in enumerate(path.read_text().splitlines(), 1)
            for m in [re.search(r"#\s*expect:\s*(CST[-A-Z0-9, ]+)$", line)]
            if m
        }

    twins = sorted(p.relative_to(TWINS).as_posix()
                   for p in TWINS.rglob("*.py"))
    assert twins and set(twins) <= {f for fs in FILES.values() for f in fs}
    for rel in twins:
        assert expects(TWINS / rel) == expects(CORPUS / rel), rel
    from cst_captioning_torch.analysis.engine import CHECKERS, _load_checkers

    _load_checkers()
    assert set(FILES) == set(CHECKERS)
    assert not NOT_PORTED and not UNTRANSLATABLE
