"""The port's seeded corpus (``tests/torch_analysis_corpus/``): every
annotated violation fires exactly its rule at exactly its line, nothing
fires on the negative cases, and every rule family of the port's engine
fires somewhere in the corpus.  The corpus holds the port's idioms the
JAX package's corpus lacks: knobs read through a section held on
``self`` and bound by a constructor or ``super().__init__``, knob names
from a loop over literal tuples, a ``METRIC_HELP`` literal with a
duplicated key, and a SIGTERM thread whose target is ``shutdown``.
"""

import re
from pathlib import Path

import pytest

from cst_captioning_torch.analysis.astutil import PackageIndex, scan_package
from cst_captioning_torch.analysis.engine import (
    CHECKERS,
    CheckContext,
    _load_checkers,
)

CORPUS = Path(__file__).resolve().parent / "torch_analysis_corpus"

_FAMILY_OF_PREFIX = {
    "CST-THR": "thread_safety",
    "CST-MET": "metrics_registry",
    "CST-OBS": "observability",
    "CST-RES": "resilience",
    "CST-CFG": "configflow",
    "CST-EXC": "exceptions",
}


def _family(rule: str) -> str:
    return _FAMILY_OF_PREFIX[rule.rsplit("-", 1)[0]]


def _parse_corpus():
    """[(module, header families, anywhere rules, {line: set(rule)})]"""
    out = []
    for mi in scan_package(CORPUS):
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


@pytest.fixture(scope="module")
def corpus_findings():
    _load_checkers()
    mods = scan_package(CORPUS)
    ctx = CheckContext(
        index=PackageIndex(mods), package_root=CORPUS, docs_root=None
    )
    cfg_ctx = CheckContext(
        index=ctx.index, package_root=CORPUS,
        docs_root=CORPUS / "configflow" / "docs",
    )
    findings = []
    for name in sorted(CHECKERS):
        findings.extend(CHECKERS[name](
            mods, cfg_ctx if name == "configflow" else ctx
        ))
    return findings


@pytest.mark.parametrize(
    "rel", sorted(mi.rel for mi, *_ in _parse_corpus())
)
def test_every_seeded_violation_fires_exactly_its_rule(
    corpus_findings, rel
):
    mi, families, anywhere, expects = next(
        c for c in _parse_corpus() if c[0].rel == rel
    )
    got = [
        f for f in corpus_findings
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
    fired = {_family(f.rule) for f in corpus_findings}
    assert fired == set(CHECKERS), sorted(fired)
    # and the torch-idiom cases the JAX corpus lacks
    rules_at = {(f.file, f.rule) for f in corpus_findings}
    assert ("serving/metrics.py", "CST-MET-003") in rules_at
    assert ("exceptions/server_bad.py", "CST-EXC-002") in rules_at
    assert not any(
        f.rule == "CST-CFG-002" and f.symbol in (
            "train.learning_rate", "train.beta1", "train.grad_clip",
            "train.undocumented_rate", "model.use_pallas_beam",
            "model.use_pallas_sampler",
        )
        for f in corpus_findings
    )
