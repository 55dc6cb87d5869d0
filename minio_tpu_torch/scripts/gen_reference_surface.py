"""Regenerate minio_tpu_torch/analysis/reference_surface.json from the
reference tree's metrics-v3 sources.

Counterpart of the repository's ``scripts/gen_reference_surface.py``,
writing the port's vendored copy. Usage::

    python -m minio_tpu_torch.scripts.gen_reference_surface [REFERENCE_ROOT]

With no REFERENCE_ROOT it harvests nothing and writes nothing. The
script greps the ``cmd/metrics-v3-*.go`` descriptor files for series-name constants
(``"<name>"`` passed to NewCounterMD/NewGaugeMD, or assembled from the
``minio_<subsystem>_`` prefix conventions), buckets them into the four
pinned parity groups (api / cluster / system / drive), harvests the
diagnostic admin-op names from ``cmd/admin-router.go`` into the
``admin_groups`` pin set, and rewrites the vendored JSON in place —
preserving the pin and the comment header.

When no reference tree is given or mounted (the normal case in CI) it
exits 0 without touching anything: the vendored JSON stays the hand-curated
pin set, and editing it by hand remains legitimate — the surface pass
hashes it into the engine digest, so any edit busts the analysis cache.
"""

from __future__ import annotations

import json
import os
import re
import sys

VENDORED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "analysis", "reference_surface.json",
)

# descriptor files -> parity group. drive series live in the system-*
# descriptor but carry the minio_system_drive_ prefix, split below.
_GROUP_BY_FILE = (
    ("metrics-v3-api-", "api"),
    ("metrics-v3-cluster-", "cluster"),
    ("metrics-v3-system-", "system"),
)

# `xxxMD = NewCounterMD(xxx, ...)` name constants: the series name is a
# quoted snake_case string in the same file
_NAME_RE = re.compile(r'"((?:[a-z0-9]+_)+[a-z0-9]+)"')

# admin-router registrations: adminRouter.Methods(...).Path(adminVersion +
# "/speedtest/drive") — harvest the op path tails
_ADMIN_OP_RE = re.compile(r'adminAPIVersionPrefix\s*\+\s*"/([a-z][a-z0-9/_-]*)"'
                          r'|adminVersion\s*\+\s*"/([a-z][a-z0-9/_-]*)"')

# the curated diagnostics subset: the reference router registers ~100
# ops; parity pins only the self-measurement plane this tree mirrors
_DIAG_OPS = frozenset({
    "speedtest", "speedtest/drive", "speedtest/net", "speedtest/object",
    "healthinfo", "inspect-data", "profile", "trace", "top/locks",
})


def harvest_admin_ops(reference_root: str) -> set[str]:
    """Diagnostic admin-op names from the reference admin router,
    intersected with the curated allowlist (the reference registers far
    more ops than this tree pins parity on)."""
    path = os.path.join(reference_root, "cmd", "admin-router.go")
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            src = fh.read()
    except OSError:
        return set()
    ops = set()
    for m in _ADMIN_OP_RE.finditer(src):
        op = (m.group(1) or m.group(2)).strip("/")
        if op in _DIAG_OPS:
            ops.add(op)
    return ops


def harvest(reference_root: str) -> dict[str, set[str]] | None:
    cmd = os.path.join(reference_root, "cmd")
    if not os.path.isdir(cmd):
        return None
    groups: dict[str, set[str]] = {
        "api": set(), "cluster": set(), "system": set(), "drive": set(),
    }
    for fn in sorted(os.listdir(cmd)):
        if not (fn.startswith("metrics-v3-") and fn.endswith(".go")):
            continue
        group = next(
            (g for pre, g in _GROUP_BY_FILE if fn.startswith(pre)), None
        )
        if group is None:
            continue
        with open(os.path.join(cmd, fn), "r", encoding="utf-8",
                  errors="replace") as fh:
            src = fh.read()
        # v3 exposition prefixes every series with minio_<group-path>;
        # descriptor constants carry the tail only
        for m in _NAME_RE.finditer(src):
            tail = m.group(1)
            if tail.startswith("minio_"):
                name = tail
            else:
                continue  # tails are resolved via the full-name form only
            g = group
            if name.startswith("minio_system_drive_"):
                g = "drive"
            groups[g].add(name)
    return groups


def main() -> int:
    if len(sys.argv) < 2:
        print("gen_reference_surface: no REFERENCE_ROOT given — nothing harvested, "
              "vendored reference_surface.json left untouched", file=sys.stderr)
        return 0
    root = sys.argv[1]
    harvested = harvest(root)
    if harvested is None:
        print(
            f"gen_reference_surface: {root} not mounted — vendored "
            "reference_surface.json left untouched", file=sys.stderr,
        )
        return 0
    with open(VENDORED, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    for g, names in harvested.items():
        if names:
            doc["groups"][g] = sorted(names)
    admin_ops = harvest_admin_ops(root)
    if admin_ops:
        doc.setdefault("admin_groups", {})["diagnostics"] = sorted(admin_ops)
    with open(VENDORED, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")
    print(f"wrote {VENDORED}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
