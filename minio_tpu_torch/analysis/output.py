"""Machine-readable finding output: stable JSON and SARIF 2.1.0.

Both serializations are deterministic for a given tree (findings sorted,
no timestamps, no absolute paths beyond what the caller passed) so CI
can diff consecutive runs and upload artifacts without churn. SARIF is
the minimal subset GitHub code scanning and VS Code's SARIF viewer
consume: one run, one driver, rule ids + per-result physical locations.
"""

from __future__ import annotations

import json

from .core import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

# every rule id anchors a heading in the rule index of docs/ANALYSIS.md;
# code-scanning UIs surface this next to each annotation
HELP_BASE = "docs/ANALYSIS.md"


def findings_json(findings: list[Finding], stats: dict | None = None) -> str:
    doc: dict = {
        "tool": "miniovet",
        "findings": [
            {
                "file": f.file,
                "line": f.line,
                "rule": f.rule,
                "message": f.message,
            }
            for f in sorted(findings)
        ],
    }
    if stats:
        # timings are NOT stable run to run; keep them out of the diffable
        # part by rounding to the counters CI actually asserts on
        doc["stats"] = {
            k: v for k, v in sorted(stats.items())
            if not k.endswith("_s")
        }
    return json.dumps(doc, indent=2, sort_keys=False) + "\n"


def _region(f: Finding, line_cache: dict) -> dict:
    """Full region for a finding: the whole source line, so code-scanning
    annotations highlight the statement instead of a zero-width caret at
    column 1. Start column skips the indentation; files that cannot be
    read fall back to the start position only (still valid SARIF)."""
    start = max(f.line, 1)
    region: dict = {"startLine": start}
    lines = line_cache.get(f.file)
    if lines is None:
        try:
            with open(f.file, "r", encoding="utf-8",
                      errors="replace") as fh:
                lines = fh.read().splitlines()
        except OSError:
            lines = []
        line_cache[f.file] = lines
    if 0 < start <= len(lines):
        text = lines[start - 1]
        stripped = text.rstrip()
        indent = len(text) - len(text.lstrip())
        if stripped:
            region["startColumn"] = indent + 1
            region["endLine"] = start
            region["endColumn"] = len(stripped) + 1
    return region


def findings_sarif(findings: list[Finding]) -> str:
    rules = sorted({f.rule for f in findings})
    line_cache: dict = {}
    results = [
        {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.file},
                        "region": _region(f, line_cache),
                    }
                }
            ],
        }
        for f in sorted(findings)
    ]
    doc = {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "miniovet",
                        "rules": [
                            {"id": r, "helpUri": f"{HELP_BASE}#{r}"}
                            for r in rules
                        ],
                    }
                },
                "results": results,
            }
        ],
    }
    return json.dumps(doc, indent=2) + "\n"
