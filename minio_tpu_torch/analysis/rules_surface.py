"""Surface rule: reference parity + guardrail exhaustiveness over the
observable-surface manifest (analysis/surface.py).

Two families of findings, both rule id ``surface``:

**Reference parity.** ``reference_surface.json`` (vendored next to this
module, a byte-for-byte copy of the JAX package's; regenerable from
MinIO's ``cmd/metrics-v3-*.go`` with scripts/gen_reference_surface.py)
pins the metrics-v3 series names the reference exposes, split
into parity groups. Each pinned group must be covered at >= its pin
(0.8): every miss is enumerated by name, and an empty reference group is
itself a finding — the gate must never pass vacuously.

**Guardrail exhaustiveness.** The observability triad is trace type +
metrics series + fault boundary: a subsystem wired into one without the
other two has an unobservable failure mode. The SUBSYSTEMS table below
says which trace type and metrics prefix each fault boundary maps to;
a boundary whose trace type is never published, whose metrics prefix
matches nothing, or that no ``check()`` call site ever consults is a
finding. Trace types declared in obs/trace.py but never published
anywhere in the package are findings too (anchored at the declaration,
where a ``# miniovet: ignore[surface]`` pragma can absolve them).

The pass no-ops (empty manifest, no findings) when the analyzed tree
has no server/metrics.py — subset runs aren't whole-program.
"""

from __future__ import annotations

import json
import os

from .core import Finding
from . import surface as surface_mod

RULE_ID = "surface"

REFERENCE_BASENAME = "reference_surface.json"

# fault boundary -> (trace type, metrics series prefix): the triad a
# subsystem must register completely. BOUNDARIES not listed here are a
# finding — extending fault/registry.py means extending this table (and
# therefore deciding how the new boundary is observed).
SUBSYSTEMS = (
    ("storage", "storage", "minio_system_drive_"),
    ("network", "internal", "minio_system_network_internode_"),
    ("tpu", "tpu", "minio_tpu_"),
    ("topology", "rebalance", "minio_topology_"),
    ("diag", "diag", "minio_diag_"),
)


def load_reference() -> dict | None:
    path = os.path.join(os.path.dirname(__file__), REFERENCE_BASENAME)
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def compute_parity(manifest: dict, reference: dict) -> dict:
    """Per-group coverage of the pinned reference names by the extracted
    series set. ``{"pin": f, "groups": {g: {"ratio", "hits", "total",
    "misses", "extras"}}}`` — misses are reference names we don't
    expose; extras (informational) are ours matching the group's prefix
    family but absent from the reference."""
    ours = {s["name"] for s in manifest.get("metrics", ())}
    pin = float(reference.get("pin", 0.8))
    groups: dict[str, dict] = {}
    for g, names in sorted(reference.get("groups", {}).items()):
        ref = set(names)
        hits = ref & ours
        groups[g] = {
            "ratio": round(len(hits) / len(ref), 4) if ref else 0.0,
            "hits": len(hits),
            "total": len(ref),
            "misses": sorted(ref - ours),
        }
    # admin-op parity rides the same gate: the reference's admin_groups
    # pin op NAMES (from the reference admin router) against our
    # extracted admin_routes — a diagnostics op we drop is a miss
    # exactly like a dropped metrics series
    our_ops = {r["op"] for r in manifest.get("admin_routes", ())}
    for g, names in sorted(reference.get("admin_groups", {}).items()):
        ref = set(names)
        hits = ref & our_ops
        groups[f"admin-{g}"] = {
            "ratio": round(len(hits) / len(ref), 4) if ref else 0.0,
            "hits": len(hits),
            "total": len(ref),
            "misses": sorted(ref - our_ops),
        }
    return {"pin": pin, "groups": groups}


def run(index, suppressed) -> tuple[list[Finding], dict]:
    """-> (findings, surface record). The record —
    ``{"manifest": ..., "parity": ...}`` — rides IPResult/ProjectResult
    into the interproc cache and the --gen-surface doc."""
    if "server/metrics.py" not in index.paths:
        return [], {}
    manifest = surface_mod.extract(index)
    findings: list[Finding] = []

    def add(relpath: str, line: int, msg: str) -> None:
        if not suppressed(relpath, line, RULE_ID):
            findings.append(Finding(relpath, line, RULE_ID, msg))

    # ---- reference parity ----
    reference = load_reference()
    parity: dict = {}
    if reference is None:
        add("server/metrics.py", 1,
            f"{REFERENCE_BASENAME} missing or unreadable — the "
            "reference-parity gate cannot run")
    else:
        parity = compute_parity(manifest, reference)
        for g, st in parity["groups"].items():
            if st["total"] == 0:
                add("server/metrics.py", 1,
                    f"reference parity group '{g}' is empty — the pin "
                    "would pass vacuously; curate its series list in "
                    f"{REFERENCE_BASENAME}")
                continue
            if st["ratio"] < parity["pin"]:
                missed = ", ".join(st["misses"])
                add("server/metrics.py", 1,
                    f"reference parity for group '{g}' is "
                    f"{st['hits']}/{st['total']} = {st['ratio']:.2f} "
                    f"< pin {parity['pin']:.2f}; missing: {missed}")

    # ---- guardrail exhaustiveness ----
    fault = manifest.get("fault", {})
    boundaries = list(fault.get("boundaries", ()))
    mode_lines = fault.get("mode_lines", {})
    checks_by_boundary: dict[str, int] = {}
    for c in fault.get("checks", ()):
        checks_by_boundary[c["boundary"]] = (
            checks_by_boundary.get(c["boundary"], 0) + 1
        )
    series_names = {s["name"] for s in manifest.get("metrics", ())}
    traces = manifest.get("trace_types", {})
    mapped = {b for b, _, _ in SUBSYSTEMS}

    for b in boundaries:
        line = mode_lines.get(b, 1)
        if b not in mapped:
            add(surface_mod.FAULT_FILE, line,
                f"fault boundary '{b}' has no subsystem triple in "
                "rules_surface.SUBSYSTEMS — declare which trace type "
                "and metrics prefix observe it")
    for b, trace_type, prefix in SUBSYSTEMS:
        if b not in boundaries:
            continue  # triple for a boundary this tree doesn't declare
        line = mode_lines.get(b, 1)
        if not checks_by_boundary.get(b):
            add(surface_mod.FAULT_FILE, line,
                f"fault boundary '{b}' is declared but no check() call "
                "site ever consults it — its failure modes cannot be "
                "injected")
        t = traces.get(trace_type)
        if t is None:
            add(surface_mod.FAULT_FILE, line,
                f"fault boundary '{b}' maps to trace type "
                f"'{trace_type}' which obs/trace.py does not declare")
        elif not t["published"]:
            add(surface_mod.FAULT_FILE, line,
                f"fault boundary '{b}' maps to trace type "
                f"'{trace_type}' which is declared but never published")
        if not any(n.startswith(prefix) for n in series_names):
            add(surface_mod.FAULT_FILE, line,
                f"fault boundary '{b}' maps to metrics prefix "
                f"'{prefix}' which matches no extracted series")

    for value, t in sorted(traces.items()):
        if not t["published"]:
            add(surface_mod.TRACE_FILE, t["line"],
                f"trace type '{value}' ({t['const']}) is declared but "
                "never published — dead observable surface")

    return findings, {"manifest": manifest, "parity": parity}


# ---- minio_tpu_torch/docs/SURFACE.md ------------------------------------------------------


def generate_surface_md(record: dict) -> str:
    """minio_tpu_torch/docs/SURFACE.md content from one surface record. Deterministic —
    no timestamps — so the CI drift gate can diff it."""
    manifest = record.get("manifest", {})
    parity = record.get("parity", {})
    out = [
        "# Observable surface",
        "",
        "Generated from the `surface` interprocedural pass by",
        "`python -m minio_tpu_torch.analysis --gen-surface` — do not edit by",
        "hand. This is the whole-program inventory of everything the",
        "server exposes to an operator: metrics series, admin/S3/STS",
        "routes, trace types, fault-injection boundaries, config knobs",
        "and S3 error codes — extracted statically, cross-validated",
        "against a live scrape in tests/test_analysis_surface.py, and",
        "held to reference parity against the pinned series lists in",
        "`minio_tpu_torch/analysis/reference_surface.json`.",
        "",
        "## Reference parity",
        "",
        f"Pin: every group below must be covered at >= "
        f"{parity.get('pin', 0.8):.2f}.",
        "",
        "| Group | Coverage | Ratio | Missing |",
        "|---|---|---|---|",
    ]
    for g, st in sorted(parity.get("groups", {}).items()):
        missed = ", ".join(f"`{m}`" for m in st["misses"]) or "—"
        out.append(
            f"| {g} | {st['hits']}/{st['total']} | {st['ratio']:.2f} "
            f"| {missed} |"
        )

    out += ["", "## Metrics series", ""]
    by_group: dict[str, list[dict]] = {}
    for s in manifest.get("metrics", ()):
        by_group.setdefault(s["group"], []).append(s)
    total = sum(len(v) for v in by_group.values())
    out.append(f"{total} series across {len(by_group)} collector paths. "
               "`cond` marks series only emitted under a runtime "
               "condition (feature enabled, worker pool, ...).")
    for g in sorted(by_group):
        out += ["", f"### `{g}`", "", "| Series | Type | Labels | Cond |",
                "|---|---|---|---|"]
        seen = set()
        for s in sorted(by_group[g], key=lambda s: s["name"]):
            if s["name"] in seen:
                continue
            seen.add(s["name"])
            labels = ", ".join(f"`{x}`" for x in s["labels"]) or "—"
            cond = "y" if s["conditional"] else ""
            out.append(f"| `{s['name']}` | {s['type']} | {labels} | {cond} |")

    out += ["", "## Routes", "", "### S3", "", "| Method | Path |",
            "|---|---|"]
    for r in manifest.get("s3_routes", ()):
        out.append(f"| {r['method']} | `{r['path']}` |")
    out += ["", "### Admin (`/minio/admin/v3/<op>`)", "",
            "| Op | Methods |", "|---|---|"]
    seen = set()
    for r in sorted(manifest.get("admin_routes", ()),
                    key=lambda r: r["op"]):
        key = (r["op"], tuple(r["methods"]))
        if key in seen:
            continue
        seen.add(key)
        out.append(f"| `{r['op']}` | {', '.join(r['methods'])} |")
    out += ["", "### STS actions", ""]
    for r in sorted(manifest.get("sts_actions", ()),
                    key=lambda r: r["op"]):
        out.append(f"- `{r['op']}`")

    out += ["", "## Trace types", "",
            "| Type | Constant | Publish sites |", "|---|---|---|"]
    for value, t in sorted(manifest.get("trace_types", {}).items()):
        out.append(f"| `{value}` | `{t['const']}` | {len(t['published'])} |")

    fault = manifest.get("fault", {})
    out += ["", "## Fault injection", "",
            "| Boundary | Modes | Check sites |", "|---|---|---|"]
    sites: dict[str, list[str]] = {}
    for c in fault.get("checks", ()):
        sites.setdefault(c["boundary"], []).append(
            f"`{c['file']}:{c['line']}`"
        )
    for b in fault.get("boundaries", ()):
        modes = ", ".join(f"`{m}`" for m in fault.get("modes", {}).get(b, ()))
        out.append(f"| {b} | {modes} | {', '.join(sites.get(b, [])) or '—'} |")

    out += ["", "## Error codes", "",
            f"{len(manifest.get('error_codes', ()))} S3 error codes "
            "(server/s3err.py).", "",
            "| Code | HTTP status |", "|---|---|"]
    for e in sorted(manifest.get("error_codes", ()),
                    key=lambda e: e["code"]):
        out.append(f"| `{e['code']}` | {e['status']} |")

    out += ["", "## Config knobs", "",
            f"{len(manifest.get('knobs', ()))} declared knobs — see "
            "minio_tpu_torch/docs/CONFIG.md for the full generated registry.", ""]
    return "\n".join(out)
