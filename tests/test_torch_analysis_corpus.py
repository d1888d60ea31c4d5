"""The port's seeded corpus (``tests/torch_analysis_corpus/``): every
annotated violation fires exactly its rule at exactly its line, nothing
fires on the negative cases, and every rule family of the port's engine
fires somewhere in the corpus.  The corpus holds the port's idioms the
JAX package's corpus lacks: knobs read through a section held on
``self`` and bound by a constructor or ``super().__init__``, knob names
from a loop over literal tuples, a ``METRIC_HELP`` literal with a
duplicated key, a SIGTERM thread whose target is ``shutdown``, the
TorchScript / CUDA-graph roots, ``torch.Generator`` streams, torch's
promotion and cast spellings, an update step that rebinds its state.

``parity/`` holds the line-aligned twins of the JAX corpus's files
(``tests/test_torch_analysis_parity.py``); it is scanned as a root of
its own, laid out as the JAX corpus is.  The update steps and
low-precision paths the corpus seeds are registered for the run
(:data:`INJECTED_SITES`, :data:`INJECTED_CASTS`), as the JAX package's
corpus test registers its own.
"""

import re
from pathlib import Path

import pytest

from cst_captioning_torch.analysis import jit_registry as jr
from cst_captioning_torch.analysis.astutil import PackageIndex, scan_package
from cst_captioning_torch.analysis.engine import (
    CHECKERS,
    CheckContext,
    _load_checkers,
)

CORPUS = Path(__file__).resolve().parent / "torch_analysis_corpus"
PARITY = CORPUS / "parity"

INJECTED_SITES = {
    "donation_bad.py::make_bad_update_step.train_step": jr.JitSite(
        "corpus-injected update step", update_step=True),
    "typeflow/dty_bad.py::donated_step": jr.JitSite(
        "corpus-injected update step", update_step=True),
    "typeflow/update_bad.py::LossyOptimizer.step": jr.JitSite(
        "corpus-injected update step", update_step=True),
}
INJECTED_CASTS = {
    "typeflow/dty_bad.py::registered_low_precision": jr.CastSite(
        "relaxed-rtol", "corpus-injected low-precision path",
        low_precision=True),
    "typeflow/quant_bad.py::registered_quant_path": jr.CastSite(
        "relaxed-serving", "corpus-injected quantized decision path",
        low_precision=True),
    "typeflow/quant_kernel_bad.py::registered_kernel_dequant": jr.CastSite(
        "relaxed-serving", "corpus-injected in-kernel dequant path",
        low_precision=True),
    "typeflow/torch_lattice_bad.py::low_precision_products": jr.CastSite(
        "relaxed-serving", "corpus-injected low-precision path",
        low_precision=True),
}
# Every rule of the families this port added fires at a corpus line,
# but the stale-entry rules, which fire at the registry itself
# (tests/test_torch_analysis_registries.py).
NEW_RULES = {
    "CST-JIT-001", "CST-JIT-002", "CST-JIT-003", "CST-OBS-003",
    "CST-RES-003", "CST-DON-001", "CST-DON-002", "CST-DON-004",
    "CST-DEC-001", "CST-DEC-002", "CST-DEC-003", "CST-DEC-004",
    "CST-RNG-001", "CST-RNG-002", "CST-RNG-003", "CST-SHD-001",
    "CST-SHD-002", "CST-SHD-003", "CST-SHD-004", "CST-SHD-005",
    "CST-DTY-001", "CST-DTY-002", "CST-DTY-003", "CST-DTY-004",
    "CST-SHP-001", "CST-SHP-002", "CST-SHP-003",
}

_FAMILY_OF_PREFIX = {
    "CST-THR": "thread_safety",
    "CST-MET": "metrics_registry",
    "CST-OBS": "observability",
    "CST-RES": "resilience",
    "CST-CFG": "configflow",
    "CST-EXC": "exceptions",
    "CST-JIT": "jit_boundary",
    "CST-DON": "donation",
    "CST-DEC": "single_site",
    "CST-RNG": "rng",
    "CST-SHD": "partitioning",
    "CST-DTY": "dtypeflow",
    "CST-SHP": "shapeflow",
}


def _family(rule: str) -> str:
    return _FAMILY_OF_PREFIX[rule.rsplit("-", 1)[0]]


def _scan(root):
    mods = scan_package(root)
    if root == CORPUS:
        mods = [m for m in mods if not m.rel.startswith("parity/")]
    return mods


def _parse_corpus(root=CORPUS):
    """[(module, header families, anywhere rules, {line: set(rule)})]"""
    out = []
    for mi in _scan(root):
        families, anywhere, expects = set(), set(), {}
        for lineno, line in enumerate(mi.source.splitlines(), 1):
            m = re.search(r"#\s*corpus-rules:\s*(.+)$", line)
            if m:
                families |= {f.strip() for f in m.group(1).split(",")}
            m = re.search(r"#\s*corpus-expect-anywhere:\s*(.+)$", line)
            if m:
                anywhere |= {r.strip() for r in m.group(1).split(",")}
            m = re.search(r"#\s*expect:\s*(CST[-A-Z0-9, ]+)$", line)
            if m:
                expects[lineno] = {r.strip() for r in m.group(1).split(",")}
        assert families, f"{mi.rel}: missing # corpus-rules header"
        out.append((mi, families, anywhere, expects))
    return out


def _run_all(root):
    """Every family over one corpus root, with the corpus's update steps
    and low-precision paths registered for the run."""
    mods = _scan(root)
    ctx = CheckContext(
        index=PackageIndex(mods), package_root=root, docs_root=None
    )
    cfg_ctx = CheckContext(
        index=ctx.index, package_root=root,
        docs_root=root / "configflow" / "docs",
    )
    jr.JIT_SITE_REGISTRY.update(INJECTED_SITES)
    jr.CAST_REGISTRY.update(INJECTED_CASTS)
    try:
        findings = []
        for name in sorted(CHECKERS):
            findings.extend(CHECKERS[name](
                mods, cfg_ctx if name == "configflow" else ctx
            ))
    finally:
        for k in INJECTED_SITES:
            del jr.JIT_SITE_REGISTRY[k]
        for k in INJECTED_CASTS:
            del jr.CAST_REGISTRY[k]
    return findings


@pytest.fixture(scope="module")
def corpus_findings():
    _load_checkers()
    return {CORPUS: _run_all(CORPUS), PARITY: _run_all(PARITY)}


CASES = sorted(
    [(CORPUS, mi.rel) for mi, *_ in _parse_corpus(CORPUS)]
    + [(PARITY, mi.rel) for mi, *_ in _parse_corpus(PARITY)],
    key=lambda c: str(c[0] / c[1]),
)


@pytest.mark.parametrize(
    "root,rel", CASES,
    ids=[("parity/" if r == PARITY else "") + rel for r, rel in CASES],
)
def test_every_seeded_violation_fires_exactly_its_rule(
    corpus_findings, root, rel
):
    mi, families, anywhere, expects = next(
        c for c in _parse_corpus(root) if c[0].rel == rel
    )
    got = [
        f for f in corpus_findings[root]
        if f.file == mi.rel and _family(f.rule) in families
    ]
    got_by_line = {}
    for f in got:
        got_by_line.setdefault(f.line, set()).add(f.rule)
    assert {f.rule for f in got if f.rule in anywhere} == anywhere
    got_lines = {
        ln: rules for ln, rules in got_by_line.items()
        if not rules <= anywhere
    }
    assert got_lines == expects, (
        f"{mi.rel}: expected {expects}, got {got_lines}"
    )


def test_corpus_covers_every_rule_family(corpus_findings):
    own = corpus_findings[CORPUS]
    fired = {_family(f.rule) for f in own}
    assert fired == set(CHECKERS), sorted(fired)
    # and the torch-idiom cases the JAX corpus lacks
    rules_at = {(f.file, f.rule) for f in own}
    assert ("serving/metrics.py", "CST-MET-003") in rules_at
    assert ("exceptions/server_bad.py", "CST-EXC-002") in rules_at
    assert not any(
        f.rule == "CST-CFG-002" and f.symbol in (
            "train.learning_rate", "train.beta1", "train.grad_clip",
            "train.undocumented_rate", "model.use_pallas_beam",
            "model.use_pallas_sampler",
        )
        for f in own
    )


def test_every_new_rule_fires_at_an_expected_line(corpus_findings):
    """Each rule of the families this port added is seeded at an
    ``# expect:`` line, in the port's own corpus or its parity twins,
    and fires there (the per-file test holds the lines)."""
    expected = set()
    for root in (CORPUS, PARITY):
        for _, _, _, expects in _parse_corpus(root):
            for rules in expects.values():
                expected |= rules
    fired = {f.rule for root in (CORPUS, PARITY)
             for f in corpus_findings[root]}
    assert NEW_RULES <= expected, sorted(NEW_RULES - expected)
    assert NEW_RULES <= fired, sorted(NEW_RULES - fired)
    # the port's own corpus alone covers every new family
    own = {_family(f.rule) for f in corpus_findings[CORPUS]}
    assert {"jit_boundary", "donation", "single_site", "rng",
            "partitioning", "dtypeflow", "shapeflow"} <= own
