"""SARIF 2.1.0 export of the analysis report (minimal profile).

SARIF is the interchange format every code-scanning UI ingests
(GitHub code scanning, VS Code SARIF viewer, …).  The export carries
exactly what the findings carry — rule ID, file, region, level,
message — nothing invented:

* unsuppressed findings export at ``level: "error"`` (they fail the
  pass);
* suppressed findings export at ``level: "note"`` with a SARIF
  ``suppressions`` entry carrying the annotated justification, so a
  viewer shows the recorded argument instead of hiding the site;
* ``tool.driver.rules`` lists every rule ID that appears, each with
  the rule's first message as its short description.

``validate_sarif`` is the same hand-rolled schema discipline as
``validate_report``: the minimal-profile
shape is pinned by tests, not by an external jsonschema dependency.
"""

from __future__ import annotations

from typing import Any, Dict, List

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
TOOL_NAME = "cst-invariant-engine"


def _result(f: Dict[str, Any], level: str, rule_index: int) -> dict:
    out = {
        "ruleId": f["rule"],
        "ruleIndex": rule_index,
        "level": level,
        "message": {"text": f"[{f['symbol']}] {f['message']}"},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f["file"]},
                "region": {"startLine": f["line"]},
            },
        }],
    }
    if "justification" in f:
        out["suppressions"] = [{
            "kind": "external",
            "justification": f["justification"],
        }]
    return out


def to_sarif(report_dict: Dict[str, Any]) -> Dict[str, Any]:
    """SARIF 2.1.0 document from a ``Report.to_dict()`` payload."""
    rule_ids: List[str] = []
    rule_text: Dict[str, str] = {}
    for f in list(report_dict["findings"]) + list(
        report_dict["suppressed"]
    ):
        if f["rule"] not in rule_ids:
            rule_ids.append(f["rule"])
            rule_text[f["rule"]] = f["message"]
    rule_index = {r: i for i, r in enumerate(rule_ids)}
    results = [
        _result(f, "error", rule_index[f["rule"]])
        for f in report_dict["findings"]
    ] + [
        _result(f, "note", rule_index[f["rule"]])
        for f in report_dict["suppressed"]
    ]
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": TOOL_NAME,
                    "informationUri": "docs/ANALYSIS.md",
                    "rules": [
                        {
                            "id": r,
                            "shortDescription": {
                                "text": rule_text[r][:200]
                            },
                        }
                        for r in rule_ids
                    ],
                },
            },
            "results": results,
        }],
    }


def validate_sarif(doc: Any) -> Dict[str, Any]:
    """Schema-check a minimal-profile SARIF 2.1.0 document; returns it
    or raises ValueError naming the violation."""

    def fail(msg: str) -> None:
        raise ValueError(f"malformed SARIF document: {msg}")

    if not isinstance(doc, dict):
        fail("not a dict")
    if doc.get("version") != SARIF_VERSION:
        fail(f"version must be {SARIF_VERSION!r}")
    if not (
        isinstance(doc.get("$schema"), str) and "sarif" in doc["$schema"]
    ):
        fail("'$schema' must name a SARIF schema")
    runs = doc.get("runs")
    if not (isinstance(runs, list) and len(runs) == 1):
        fail("'runs' must be a one-element list")
    run = runs[0]
    if not isinstance(run, dict):
        fail("runs[0] is not an object")
    driver = run.get("tool", {}).get("driver") if isinstance(
        run.get("tool"), dict
    ) else None
    if not isinstance(driver, dict) or not (
        isinstance(driver.get("name"), str) and driver["name"]
    ):
        fail("tool.driver.name must be a non-empty string")
    rules = driver.get("rules")
    if not isinstance(rules, list):
        fail("tool.driver.rules must be a list")
    ids = []
    for i, r in enumerate(rules):
        if not (
            isinstance(r, dict)
            and isinstance(r.get("id"), str) and r["id"]
        ):
            fail(f"rules[{i}].id must be a non-empty string")
        ids.append(r["id"])
    if len(set(ids)) != len(ids):
        fail("duplicate rule ids in tool.driver.rules")
    results = run.get("results")
    if not isinstance(results, list):
        fail("'results' must be a list")
    for i, res in enumerate(results):
        if not isinstance(res, dict):
            fail(f"results[{i}] is not an object")
        if res.get("ruleId") not in ids:
            fail(
                f"results[{i}].ruleId {res.get('ruleId')!r} not in "
                "tool.driver.rules"
            )
        ri = res.get("ruleIndex")
        if not (
            isinstance(ri, int) and not isinstance(ri, bool)
            and 0 <= ri < len(ids) and ids[ri] == res["ruleId"]
        ):
            fail(f"results[{i}].ruleIndex disagrees with ruleId")
        if res.get("level") not in ("error", "warning", "note"):
            fail(f"results[{i}].level must be error/warning/note")
        msg = res.get("message")
        if not (
            isinstance(msg, dict)
            and isinstance(msg.get("text"), str) and msg["text"]
        ):
            fail(f"results[{i}].message.text must be non-empty")
        locs = res.get("locations")
        if not (isinstance(locs, list) and len(locs) >= 1):
            fail(f"results[{i}].locations must be non-empty")
        phys = locs[0].get("physicalLocation") if isinstance(
            locs[0], dict
        ) else None
        if not isinstance(phys, dict):
            fail(f"results[{i}] missing physicalLocation")
        art = phys.get("artifactLocation")
        if not (
            isinstance(art, dict)
            and isinstance(art.get("uri"), str) and art["uri"]
        ):
            fail(f"results[{i}] artifactLocation.uri must be non-empty")
        region = phys.get("region")
        line = region.get("startLine") if isinstance(
            region, dict
        ) else None
        if not (
            isinstance(line, int) and not isinstance(line, bool)
            and line >= 1
        ):
            fail(f"results[{i}] region.startLine must be a positive int")
    return doc
