"""CLI for the invariant engine — the pre-commit / card-host preflight.

    python -m cst_captioning_torch.analysis            # human output
    python -m cst_captioning_torch.analysis --json     # machine-readable
    python -m cst_captioning_torch.analysis --sarif    # SARIF 2.1.0
    python -m cst_captioning_torch.analysis --rules single_site,donation
    python -m cst_captioning_torch.analysis --cache          # warm reuse
    python -m cst_captioning_torch.analysis --changed-only   # diff focus
    python -m cst_captioning_torch.analysis \
        --baseline BASELINE.analysis.json --fail-on-new    # adoption

Exit codes: 0 clean, 1 unsuppressed findings, 2 over the wall-clock
budget (``ANALYSIS_BUDGET_S``, default 30; 0 turns it off — a slow pass
silently eats the headroom of every run that gates on it).

The incremental cache (``--cache`` / ``--cache-dir PATH``, default
store ``.analysis_cache/``) reuses the full report when nothing that
can change it changed; ``--changed-only`` additionally restricts the
REPORTED findings (and the exit code) to files whose content hash
moved since the last cached run — the "what did my diff introduce"
view.  Both are plain content-hash machinery (analysis/cache.py), no
daemon, no state beyond one JSON file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from cst_captioning_torch.analysis.engine import run_analysis, validate_report

DEFAULT_BUDGET_S = 30.0
DEFAULT_CACHE_DIR = ".analysis_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cst_captioning_torch.analysis",
        description="Run the invariant engine over the package.",
    )
    out_fmt = ap.add_mutually_exclusive_group()
    out_fmt.add_argument(
        "--json", action="store_true",
        help="emit the machine-readable report on stdout",
    )
    out_fmt.add_argument(
        "--sarif", action="store_true",
        help="emit a SARIF 2.1.0 document on stdout",
    )
    ap.add_argument(
        "--rules", default="",
        help="comma-separated rule families (default: all)",
    )
    ap.add_argument(
        "--root", default="",
        help="package root to scan (default: the installed package)",
    )
    ap.add_argument(
        "--cache", action="store_true",
        help=f"enable the incremental cache ({DEFAULT_CACHE_DIR}/)",
    )
    ap.add_argument(
        "--cache-dir", default="",
        help="cache store directory (implies --cache)",
    )
    ap.add_argument(
        "--changed-only", action="store_true",
        help="report only findings in files changed since the last "
             "cached run (implies --cache)",
    )
    ap.add_argument(
        "--baseline", default="",
        help="committed baseline report JSON (a prior --json output); "
             "findings already in the baseline are reported as known",
    )
    ap.add_argument(
        "--fail-on-new", action="store_true",
        help="with --baseline: exit 1 only on findings NOT in the "
             "baseline — the incremental-adoption mode for new noisy "
             "rules",
    )
    args = ap.parse_args(argv)

    if args.fail_on_new and not args.baseline:
        ap.error("--fail-on-new requires --baseline")

    cache_dir = None
    if args.cache or args.cache_dir or args.changed_only:
        cache_dir = Path(args.cache_dir or DEFAULT_CACHE_DIR)

    budget = float(os.environ.get("ANALYSIS_BUDGET_S", DEFAULT_BUDGET_S))
    root = Path(args.root) if args.root else None

    changed = None
    if args.changed_only and cache_dir is not None:
        # Baseline BEFORE the run (the run overwrites the store).
        from cst_captioning_torch.analysis import cache as _cache
        from cst_captioning_torch.analysis.engine import (
            default_package_root,
        )

        files = _cache.file_digests(root or default_package_root())
        changed = _cache.changed_files(cache_dir, files)

    report = run_analysis(
        root,
        rules=[r for r in args.rules.split(",") if r] or None,
        cache_dir=cache_dir,
    )
    findings = report.findings
    if changed is not None:
        changed_set = set(changed)
        findings = [f for f in findings if f.file in changed_set]

    # Baseline diffing: a committed baseline report absorbs
    # KNOWN findings so a new noisy rule can be adopted incrementally —
    # the gate only trips on findings the baseline has never seen.
    # Identity is the (rule, file, symbol) triple, count-aware (two
    # same-triple findings against one baseline entry = one new), and
    # line-number-free so unrelated edits can't churn the diff.
    new_findings = None
    if args.baseline:
        new_findings = _diff_baseline(Path(args.baseline), findings)

    if args.json:
        rec = validate_report(report.to_dict())
        if new_findings is not None:
            rec["new_findings"] = [f.to_dict() for f in new_findings]
        print(json.dumps(rec, indent=2))
    elif args.sarif:
        from cst_captioning_torch.analysis.sarif import (
            to_sarif,
            validate_sarif,
        )

        doc = validate_sarif(to_sarif(report.to_dict()))
        print(json.dumps(doc, indent=2))
    else:
        if changed is not None:
            lines = [f.render() for f in findings]
            lines.append(
                f"analysis (changed-only, {len(changed)} changed "
                f"file(s)): {len(findings)} finding(s), "
                f"{report.files_scanned} files, "
                f"{report.duration_s:.2f}s"
            )
            print("\n".join(lines))
        else:
            print(report.render())
    if new_findings is not None and not args.json:
        known = len(findings) - len(new_findings)
        lines = [f"NEW: {f.render()}" for f in new_findings]
        lines.append(
            f"baseline: {known} known finding(s) absorbed, "
            f"{len(new_findings)} new"
        )
        print("\n".join(lines))
    if budget and report.duration_s > budget:
        print(
            f"ANALYSIS BUDGET EXCEEDED: {report.duration_s:.1f}s > "
            f"ANALYSIS_BUDGET_S={budget:.0f}s",
            file=sys.stderr,
        )
        return 2
    if args.fail_on_new:
        return 0 if not new_findings else 1
    return 0 if not findings else 1


def _diff_baseline(path: Path, findings):
    """Findings not absorbed by the baseline report at ``path`` (a
    prior ``--json`` output, or a bare list of finding objects).
    Raises SystemExit(2) with a named reason on an unreadable or
    malformed baseline — a silently-empty baseline would absorb
    nothing and fail every adopter, or worse, absorb everything."""
    try:
        data = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        print(f"baseline {path} unreadable: {e}", file=sys.stderr)
        raise SystemExit(2)
    raw = data.get("findings") if isinstance(data, dict) else data
    if not isinstance(raw, list) or not all(
        isinstance(f, dict)
        and all(isinstance(f.get(k), str) for k in ("rule", "file", "symbol"))
        for f in raw
    ):
        print(
            f"baseline {path} malformed: expected a --json report or a "
            "list of {rule, file, symbol} objects",
            file=sys.stderr,
        )
        raise SystemExit(2)
    budgets: dict = {}
    for f in raw:
        key = (f["rule"], f["file"], f["symbol"])
        budgets[key] = budgets.get(key, 0) + 1
    new = []
    for f in findings:
        key = (f.rule, f.file, f.symbol)
        if budgets.get(key, 0) > 0:
            budgets[key] -= 1
        else:
            new.append(f)
    return new


if __name__ == "__main__":
    sys.exit(main())
