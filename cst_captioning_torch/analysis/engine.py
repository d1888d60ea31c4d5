"""The invariant engine: parse the package once, run pluggable
checkers, report ``file:line`` findings with rule IDs.

The port's correctness contracts — lock order and guarded state in the
serving layer, knobs that are read, metric / span / fault-site
vocabularies that match their registries and docs, threads that cannot
die silently, registered kernel / collective / cast sites, random
streams that are keyed and seeded, dtypes the device surface proves —
are checked here over the port's own source, as the JAX package's
engine checks its source:

* every checker is a function ``(modules, ctx) -> [Finding]`` registered
  in :data:`CHECKERS` under a rule-family name;
* findings carry a stable rule ID (catalogue in docs/ANALYSIS.md), the
  package-relative ``file:line``, and the enclosing symbol;
* one annotated suppression file (``suppressions.json``) silences known
  false positives — every entry REQUIRES a non-empty justification
  string, and stale (never-matched) entries are surfaced so the file
  cannot rot;
* ``python -m cst_captioning_torch.analysis`` runs the pass standalone
  and exits non-zero on any unsuppressed finding; the tests run it
  in-process (tests/test_torch_analysis.py).

Everything here is stdlib-only and pure-AST — the pass reads source, it
never imports torch or the package under analysis, so it runs on a
host with neither the kernels built nor a card.
"""

from __future__ import annotations

import datetime as _dt
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from cst_captioning_torch.analysis.astutil import (
    ModuleInfo,
    PackageIndex,
    scan_package,
)

REPORT_VERSION = 1


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str        # e.g. "CST-DEC-001"
    file: str        # package-relative posix path
    line: int
    symbol: str      # enclosing qualname or logical symbol
    message: str

    def location(self) -> str:
        return f"{self.file}:{self.line}"

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} [{self.symbol}] {self.message}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
        }


@dataclass
class CheckContext:
    """What checkers get besides the parsed modules."""

    index: PackageIndex
    package_root: Path
    docs_root: Optional[Path]    # repo docs/ dir (None when absent)


Checker = Callable[[List[ModuleInfo], CheckContext], List[Finding]]

# Rule-family name -> checker.  Populated by register_checker at import
# of the checker modules (see _load_checkers).
CHECKERS: Dict[str, Checker] = {}


def register_checker(name: str) -> Callable[[Checker], Checker]:
    def deco(fn: Checker) -> Checker:
        CHECKERS[name] = fn
        return fn

    return deco


def _load_checkers() -> None:
    # Import-for-side-effect: each module registers its rule family.
    from cst_captioning_torch.analysis import (  # noqa: F401
        configflow,
        donation,
        dtypeflow,
        exceptions,
        jit_boundary,
        metrics_registry,
        observability,
        partitioning,
        resilience,
        rng,
        shapeflow,
        single_site,
        thread_safety,
    )


# ----------------------------------------------------------- suppressions

@dataclass(frozen=True)
class Suppression:
    """One annotated suppression: silences findings whose (rule, file,
    symbol) all match.  ``justification`` is REQUIRED non-empty prose —
    an unexplained suppression is itself a finding.  ``expires``
    (optional, ``"YYYY-MM-DD"``) dates the debt: past the date the
    entry fires CST-SUP-002, so a "temporary" suppression surfaces
    instead of rotting."""

    rule: str
    file: str
    symbol: str
    justification: str
    expires: Optional[str] = None

    def expired(self, today: Optional["_dt.date"] = None) -> bool:
        if not self.expires:
            return False
        today = today or _dt.date.today()
        return _dt.date.fromisoformat(self.expires) < today


def load_suppressions(
    path: Path,
) -> Tuple[List[Suppression], List[Finding]]:
    """Parse the suppression file; malformed entries come back as
    CST-SUP-001 findings instead of silently dropping rules."""
    entries: List[Suppression] = []
    problems: List[Finding] = []
    if not path.exists():
        return entries, problems
    try:
        data = json.loads(path.read_text())
    except json.JSONDecodeError as e:
        return entries, [
            Finding(
                "CST-SUP-001", path.name, 1, "<file>",
                f"suppression file is not valid JSON: {e}",
            )
        ]
    raw = data.get("entries") if isinstance(data, dict) else None
    if not isinstance(raw, list):
        return entries, [
            Finding(
                "CST-SUP-001", path.name, 1, "<file>",
                "suppression file must be {\"entries\": [...]}"
            )
        ]
    for i, e in enumerate(raw):
        where = f"entries[{i}]"
        if not isinstance(e, dict):
            problems.append(Finding(
                "CST-SUP-001", path.name, 1, where, "entry is not an object"
            ))
            continue
        missing = [
            k for k in ("rule", "file", "symbol", "justification")
            if not isinstance(e.get(k), str)
        ]
        if missing:
            problems.append(Finding(
                "CST-SUP-001", path.name, 1, where,
                f"entry missing string field(s) {missing}",
            ))
            continue
        if not e["justification"].strip():
            problems.append(Finding(
                "CST-SUP-001", path.name, 1, where,
                f"suppression of {e['rule']} at {e['file']} has an empty "
                "justification — every suppression must say WHY",
            ))
            continue
        expires = e.get("expires")
        if expires is not None:
            if not isinstance(expires, str):
                problems.append(Finding(
                    "CST-SUP-001", path.name, 1, where,
                    "'expires' must be a \"YYYY-MM-DD\" string",
                ))
                continue
            try:
                _dt.date.fromisoformat(expires)
            except ValueError:
                problems.append(Finding(
                    "CST-SUP-001", path.name, 1, where,
                    f"'expires' {expires!r} is not a valid "
                    "YYYY-MM-DD date",
                ))
                continue
        entries.append(Suppression(
            rule=e["rule"], file=e["file"], symbol=e["symbol"],
            justification=e["justification"], expires=expires,
        ))
    return entries, problems


def _matches(s: Suppression, f: Finding) -> bool:
    return s.rule == f.rule and s.file == f.file and s.symbol == f.symbol


# ----------------------------------------------------------------- report

@dataclass
class Report:
    findings: List[Finding]                    # unsuppressed
    suppressed: List[Tuple[Finding, Suppression]]
    unused_suppressions: List[Suppression]
    rules_run: List[str]
    files_scanned: int
    duration_s: float
    cache_hit_files: int = 0    # files served from the incremental cache
    # seconds each rule family took (empty on a cache hit)
    family_s: Dict[str, float] = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.findings

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": REPORT_VERSION,
            "clean": self.clean,
            "duration_s": round(self.duration_s, 3),
            "files_scanned": self.files_scanned,
            "cache_hit_files": self.cache_hit_files,
            "family_s": {
                k: round(v, 3) for k, v in self.family_s.items()
            },
            "rules_run": list(self.rules_run),
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [
                dict(f.to_dict(), justification=s.justification)
                for f, s in self.suppressed
            ],
            "unused_suppressions": [
                {"rule": s.rule, "file": s.file, "symbol": s.symbol}
                for s in self.unused_suppressions
            ],
        }

    def to_stable_dict(self) -> Dict[str, Any]:
        """The run-invariant payload: everything except the measured
        ``duration_s`` and the cache provenance — the byte-identical
        contract cold and warm cached runs are pinned against."""
        d = self.to_dict()
        d.pop("duration_s")
        d.pop("cache_hit_files")
        d.pop("family_s")
        return d

    @classmethod
    def from_stable_dict(
        cls, d: Dict[str, Any], *, duration_s: float,
        cache_hit_files: int,
    ) -> "Report":
        """Rebuild a Report from a stored stable payload (the cache
        warm path)."""
        findings = [Finding(**f) for f in d["findings"]]
        suppressed = []
        for f in d["suppressed"]:
            just = f["justification"]
            core = {k: v for k, v in f.items() if k != "justification"}
            suppressed.append((
                Finding(**core),
                Suppression(
                    rule=core["rule"], file=core["file"],
                    symbol=core["symbol"], justification=just,
                ),
            ))
        unused = [
            Suppression(justification="", **u)
            for u in d["unused_suppressions"]
        ]
        return cls(
            findings=findings,
            suppressed=suppressed,
            unused_suppressions=unused,
            rules_run=list(d["rules_run"]),
            files_scanned=d["files_scanned"],
            duration_s=duration_s,
            cache_hit_files=cache_hit_files,
        )

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"analysis: {len(self.findings)} finding(s), "
            f"{len(self.suppressed)} suppressed, "
            f"{self.files_scanned} files, {self.duration_s:.2f}s"
        )
        if self.unused_suppressions:
            lines.append(
                "stale suppressions (matched nothing): "
                + ", ".join(
                    f"{s.rule}@{s.file}[{s.symbol}]"
                    for s in self.unused_suppressions
                )
            )
        return "\n".join(lines)


def validate_report(rec: Any) -> Dict[str, Any]:
    """Schema-validate one ``--json`` analysis report (the same contract
    discipline as ``validate_sarif``).  Returns the record
    or raises ValueError naming the violation."""

    def fail(msg: str) -> None:
        raise ValueError(f"malformed analysis report: {msg}")

    if not isinstance(rec, dict):
        fail("not a dict")
    for key in (
        "version", "clean", "duration_s", "files_scanned", "rules_run",
        "findings", "suppressed", "unused_suppressions",
    ):
        if key not in rec:
            fail(f"missing required key {key!r}")
    if rec["version"] != REPORT_VERSION:
        fail(f"unknown version {rec['version']!r}")
    if not isinstance(rec["clean"], bool):
        fail("'clean' must be a bool")
    if isinstance(rec["duration_s"], bool) or not isinstance(
        rec["duration_s"], (int, float)
    ):
        fail("'duration_s' must be a number")
    if isinstance(rec["files_scanned"], bool) or not isinstance(
        rec["files_scanned"], int
    ) or rec["files_scanned"] < 0:
        fail("'files_scanned' must be a non-negative int")
    if "cache_hit_files" in rec:
        v = rec["cache_hit_files"]
        if isinstance(v, bool) or not isinstance(v, int) or v < 0:
            fail("'cache_hit_files' must be a non-negative int")
        if v > rec["files_scanned"]:
            fail("'cache_hit_files' exceeds 'files_scanned'")
    if "family_s" in rec:
        fs = rec["family_s"]
        if not isinstance(fs, dict) or not all(
            isinstance(k, str) and not isinstance(v, bool)
            and isinstance(v, (int, float)) and v >= 0
            for k, v in fs.items()
        ):
            fail("'family_s' must map family names to seconds")
    if not (
        isinstance(rec["rules_run"], list)
        and all(isinstance(r, str) and r for r in rec["rules_run"])
    ):
        fail("'rules_run' must be a list of non-empty strings")
    for section in ("findings", "suppressed"):
        if not isinstance(rec[section], list):
            fail(f"'{section}' must be a list")
        for i, f in enumerate(rec[section]):
            if not isinstance(f, dict):
                fail(f"{section}[{i}] is not an object")
            for k in ("rule", "file", "symbol", "message"):
                if not (isinstance(f.get(k), str) and f[k]):
                    fail(f"{section}[{i}].{k} must be a non-empty string")
            if isinstance(f.get("line"), bool) or not isinstance(
                f.get("line"), int
            ) or f["line"] < 1:
                fail(f"{section}[{i}].line must be a positive int")
            if section == "suppressed" and not (
                isinstance(f.get("justification"), str)
                and f["justification"].strip()
            ):
                fail(
                    f"suppressed[{i}] lacks a non-empty justification"
                )
    if rec["clean"] != (len(rec["findings"]) == 0):
        fail("'clean' contradicts the findings list")
    return rec


# ------------------------------------------------------------------- run

def default_package_root() -> Path:
    return Path(__file__).resolve().parent.parent


def default_suppressions_path() -> Path:
    return Path(__file__).resolve().parent / "suppressions.json"


def run_analysis(
    package_root: Optional[Path] = None,
    *,
    rules: Optional[Sequence[str]] = None,
    suppressions_path: Optional[Path] = None,
    docs_root: Optional[Path] = None,
    cache_dir: Optional[Path] = None,
) -> Report:
    """Parse ``package_root`` once, run the requested rule families
    (default: all), apply suppressions, return the :class:`Report`.

    ``cache_dir`` enables the incremental cache (analysis/cache.py):
    when nothing that can change the report changed — sources,
    suppressions, docs, rule selection — the stored report is
    reconstructed without parsing or checking anything
    (``cache_hit_files`` reports the reuse; the stable payload is
    byte-identical to a cold run by construction)."""
    t0 = time.perf_counter()
    _load_checkers()
    root = Path(package_root) if package_root else default_package_root()
    if docs_root is None:
        cand = root.parent / "docs"
        docs_root = cand if cand.is_dir() else None
    names = list(rules) if rules else sorted(CHECKERS)
    spath_early = Path(suppressions_path or default_suppressions_path())
    cache_key = None
    cache_files = None
    if cache_dir is not None:
        from cst_captioning_torch.analysis import cache as _cache

        cache_key, cache_files = _cache.compute_key(
            root,
            rules=names,
            suppressions_path=spath_early,
            docs_root=docs_root,
            report_version=REPORT_VERSION,
        )
        hit = _cache.load(Path(cache_dir), cache_key)
        if hit is not None:
            return Report.from_stable_dict(
                hit,
                duration_s=time.perf_counter() - t0,
                cache_hit_files=hit["files_scanned"],
            )
    modules = scan_package(root)
    # The analysis package audits the rest of the package; its own
    # sources (pattern tables, rule text, the lockwatch harness) are
    # detection code, not the code under contract.
    modules = [m for m in modules if not m.rel.startswith("analysis/")]
    ctx = CheckContext(
        index=PackageIndex(modules), package_root=root, docs_root=docs_root
    )
    unknown = [n for n in names if n not in CHECKERS]
    if unknown:
        raise ValueError(
            f"unknown rule families {unknown}; have {sorted(CHECKERS)}"
        )
    all_findings: List[Finding] = []
    family_s: Dict[str, float] = {}
    for name in names:
        t_fam = time.perf_counter()
        all_findings.extend(CHECKERS[name](modules, ctx))
        family_s[name] = time.perf_counter() - t_fam
    sups, sup_problems = load_suppressions(spath_early)
    all_findings.extend(sup_problems)
    # Dated debt surfaces (CST-SUP-002): an entry past its ``expires``
    # date keeps matching (so its target shows up exactly once, here)
    # but the expiry itself is an unsuppressable finding.
    for s in sups:
        if s.expired():
            all_findings.append(Finding(
                "CST-SUP-002", spath_early.name, 1,
                f"{s.rule}@{s.file}[{s.symbol}]",
                f"suppression of {s.rule} at {s.file} expired on "
                f"{s.expires} — the recorded debt "
                f"({s.justification!r:.120}) is due: fix the finding "
                "or re-justify with a new date",
            ))

    kept: List[Finding] = []
    suppressed: List[Tuple[Finding, Suppression]] = []
    used = set()
    for f in sorted(all_findings, key=lambda f: (f.file, f.line, f.rule)):
        hit = next((s for s in sups if _matches(s, f)), None)
        if hit is not None and not f.rule.startswith("CST-SUP-"):
            suppressed.append((f, hit))
            used.add((hit.rule, hit.file, hit.symbol))
        else:
            kept.append(f)
    unused = [
        s for s in sups if (s.rule, s.file, s.symbol) not in used
    ]
    report = Report(
        findings=kept,
        suppressed=suppressed,
        unused_suppressions=unused,
        rules_run=names,
        files_scanned=len(modules),
        duration_s=time.perf_counter() - t0,
        family_s=family_s,
    )
    if cache_dir is not None and cache_key is not None:
        from cst_captioning_torch.analysis import cache as _cache

        _cache.store(
            Path(cache_dir), cache_key, report.to_stable_dict(),
            cache_files or {},
        )
    return report
