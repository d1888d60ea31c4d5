"""The port's invariant engine against the JAX package's on the JAX
package's own seeded corpus (``tests/analysis_corpus/``), family by
family: the corpus files of this slice's families are copied twice into
``tmp_path``, once as they are and once with ``cst_captioning_tpu``
renamed ``cst_captioning_torch``, and each engine's ``run_analysis``
runs over its copy.  The (rule, file, line, symbol) sets must be equal.

The only findings left out are CST-OBS-003 and CST-RES-003: they read
the jit-boundary family's traced set, which the port's engine does not
run yet.
"""

from pathlib import Path

import pytest

from cst_captioning_torch.analysis import run_analysis as torch_run
from cst_captioning_tpu.analysis import run_analysis as jax_run

CORPUS = Path(__file__).resolve().parent / "analysis_corpus"

FILES = (
    "serving/lock_inversion.py",
    "serving/metrics_bad.py",
    "configflow/config.py",
    "configflow/knobs_bad.py",
    "configflow/docs/ANALYSIS.md",
    "exceptions/exc_bad.py",
    "observability/trace_bad.py",
    "resilience/chaos_bad.py",
)
NOT_PORTED = {"CST-OBS-003", "CST-RES-003"}
FAMILIES = (
    "thread_safety", "configflow", "metrics_registry", "exceptions",
    "observability", "resilience",
)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    base = tmp_path_factory.mktemp("parity")
    for side, rename in (("ref", False), ("port", True)):
        for rel in FILES:
            text = (CORPUS / rel).read_text()
            if rename:
                text = text.replace("cst_captioning_tpu",
                                    "cst_captioning_torch")
            dst = base / side / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text(text)
    return base / "ref", base / "port"


def _keys(report):
    return {
        (f.rule, f.file, f.line, f.symbol)
        for f in report.findings
        if f.rule not in NOT_PORTED and not f.rule.startswith("CST-SUP")
    }


@pytest.mark.parametrize("family", FAMILIES)
def test_same_findings_as_the_reference(corpora, family, tmp_path):
    ref, port = corpora
    # CST-CFG-003 reads the corpus's docs twin; the other families run
    # doc-less, as the reference corpus test runs them.
    # (No docs/ beside the copies, so docs_root=None finds none.)
    cfg = family == "configflow"
    none = tmp_path / "no-suppressions.json"
    want = _keys(jax_run(
        ref, rules=[family], suppressions_path=none,
        docs_root=ref / "configflow" / "docs" if cfg else None))
    got = _keys(torch_run(
        port, rules=[family], suppressions_path=none,
        docs_root=port / "configflow" / "docs" if cfg else None))
    assert want, f"{family}: the reference found nothing on its corpus"
    assert got == want, (
        f"{family}: port-only {sorted(got - want)}, "
        f"reference-only {sorted(want - got)}"
    )
