"""Incremental analysis cache: content-hash-keyed report reuse.

The pass is a preflight — it runs inside the tests and before the
card smoke run — so the common case is re-running it over an UNCHANGED
tree.
Parsing ~70 files and walking every checker costs a few seconds; the
cache makes the warm case cost only the hashing:

* the cache KEY digests everything that can change the report: every
  ``.py`` under the package root (the analysis package's own sources
  included — a rule edit invalidates), the suppression file, the docs
  the doc-coverage rules read, the requested rule families, and the
  report schema version.  Suppression files that carry ``expires``
  dates additionally fold in today's date, so an entry expiring
  overnight cannot hide behind a stale hit.
* a HIT reconstructs the full :class:`~.engine.Report` from the
  stored payload — byte-identical findings (pinned by
  ``Report.to_stable_dict`` in tests) with ``cache_hit_files`` set to
  the file count; only ``duration_s`` is re-measured (it reports THIS
  run).
* the store also records the per-file digest map, which powers the
  CLI ``--changed-only`` mode: report only findings in files whose
  content changed since the last stored run.

Storage is a single JSON file under ``--cache-dir`` (default
``.analysis_cache/``); stdlib-only like the rest of the engine.
"""

from __future__ import annotations

import datetime
import hashlib
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CACHE_VERSION = 1
_STORE_NAME = "analysis_report.json"


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def file_digests(root: Path) -> Dict[str, str]:
    """``{package-relative posix path: sha256}`` for every ``.py``
    under ``root`` (reads bytes, never parses — the warm-path cost)."""
    out: Dict[str, str] = {}
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        out[path.relative_to(root).as_posix()] = _digest(
            path.read_bytes()
        )
    return out


def compute_key(
    root: Path,
    *,
    rules: Sequence[str],
    suppressions_path: Path,
    docs_root: Optional[Path],
    report_version: int,
    files: Optional[Dict[str, str]] = None,
) -> Tuple[str, Dict[str, str]]:
    """The cache key + the per-file digest map it was computed from."""
    files = files if files is not None else file_digests(root)
    h = hashlib.sha256()
    h.update(f"cache-v{CACHE_VERSION}/report-v{report_version}".encode())
    for rel, dig in sorted(files.items()):
        h.update(f"\x00{rel}\x01{dig}".encode())
    h.update(b"\x02rules" + ",".join(rules).encode())
    sup = b""
    if suppressions_path.exists():
        sup = suppressions_path.read_bytes()
    h.update(b"\x02sup" + _digest(sup).encode())
    if b"expires" in sup:
        # date-dependent semantics: an entry can expire overnight
        h.update(datetime.date.today().isoformat().encode())
    if docs_root is not None and docs_root.is_dir():
        for doc in sorted(docs_root.glob("*.md")):
            h.update(
                f"\x02doc{doc.name}\x01".encode()
                + _digest(doc.read_bytes()).encode()
            )
    return h.hexdigest(), files


def store_path(cache_dir: Path) -> Path:
    return Path(cache_dir) / _STORE_NAME


def load(cache_dir: Path, key: str) -> Optional[dict]:
    """The stored report payload when the key matches, else None."""
    p = store_path(cache_dir)
    if not p.exists():
        return None
    try:
        data = json.loads(p.read_text())
    except (json.JSONDecodeError, OSError):
        return None
    if not isinstance(data, dict) or data.get("key") != key:
        return None
    rep = data.get("report")
    return rep if isinstance(rep, dict) else None


def last_files(cache_dir: Path) -> Dict[str, str]:
    """The per-file digest map of the last stored run (empty when no
    store exists) — the ``--changed-only`` baseline."""
    p = store_path(cache_dir)
    if not p.exists():
        return {}
    try:
        data = json.loads(p.read_text())
    except (json.JSONDecodeError, OSError):
        return {}
    files = data.get("files")
    return files if isinstance(files, dict) else {}


def store(
    cache_dir: Path, key: str, report: dict, files: Dict[str, str]
) -> None:
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    tmp = store_path(cache_dir).with_suffix(".tmp")
    tmp.write_text(json.dumps({
        "version": CACHE_VERSION,
        "key": key,
        "files": files,
        "report": report,
    }, indent=1, sort_keys=True))
    tmp.replace(store_path(cache_dir))


def changed_files(
    cache_dir: Path, files: Dict[str, str]
) -> Optional[List[str]]:
    """Files whose digest differs from (or is absent in) the last
    stored run; None when no baseline exists (everything is
    "changed")."""
    base = last_files(cache_dir)
    if not base:
        return None
    return sorted(
        rel for rel, dig in files.items() if base.get(rel) != dig
    )
