"""Knob-registry rule: every ``MINIO_*`` env var read must be declared.

The registry (analysis/knobs.py) is the single source of truth for
config knobs — name, default, description, owning subsystem — and
minio_tpu_torch/docs/CONFIG.md is generated from it (``python -m minio_tpu_torch.analysis
--gen-config-docs``). An undeclared read fails the gate; a read whose
inline default disagrees with the declared default fails too (two call
sites silently disagreeing about a default is how the QoS fraction bug
class happens).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from .core import Finding, dotted_name, rule
from .knobs import KNOBS, PREFIX_KNOBS

_KNOB_RE = re.compile(r"^MINIO_[A-Z0-9_]*$")

_DECL_RE = re.compile(r'_k\(\s*"(MINIO_[A-Z0-9_]*)"')

# call attrs that read from an env mapping; .get/.pop/.setdefault cover
# os.environ and its local aliases/copies, startswith covers the
# iterate-environ-and-match pattern in events/audit
_READ_ATTRS = {"get", "pop", "setdefault", "startswith"}


def _knob_literal(node: ast.AST) -> tuple[str, bool] | None:
    """(name, is_prefix) when `node` is a MINIO_* key expression."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        # bare "MINIO_" is the whole namespace (startswith scans over
        # environ), not a knob
        if _KNOB_RE.match(node.value) and node.value != "MINIO_":
            return node.value, node.value.endswith("_")
        return None
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        if (
            isinstance(head, ast.Constant)
            and isinstance(head.value, str)
            and _KNOB_RE.match(head.value)
            and len(node.values) > 1
        ):
            return head.value, True
    return None


def _declared(name: str, prefix: bool) -> bool:
    if prefix:
        return name in PREFIX_KNOBS
    if name in KNOBS:
        return True
    return any(name.startswith(p) for p in PREFIX_KNOBS)


def _default_literal(call: ast.Call, key_index: int) -> str | None:
    if len(call.args) > key_index + 1:
        d = call.args[key_index + 1]
        if isinstance(d, ast.Constant) and isinstance(d.value, str):
            return d.value
    return None


def _declaration_lines() -> dict[str, int]:
    """Registry knob name -> its declaration line in knobs.py (where a
    dead-knob finding anchors, and where its pragma lives)."""
    import os

    path = os.path.join(os.path.dirname(__file__), "knobs.py")
    out: dict[str, int] = {}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                m = _DECL_RE.search(line)
                if m and m.group(1) not in out:
                    out[m.group(1)] = i
    except OSError:
        pass
    return out


def dead_knob_findings(index, native_reads, suppressed) -> list[Finding]:
    """``dead-knob`` interprocedural pass: a knob declared in the
    registry that no Python or native source reads is dead config — the
    docs advertise a switch wired to nothing. A read is any ``MINIO_*``
    string literal in a non-analysis source file (exact name, or a
    literal prefix ending in ``_`` that the name extends — the
    f-string/concat family idiom). Only runs when the registry file AND
    the serving code that reads knobs are both in the analyzed tree —
    a fixture run must not inherit the registry as findings, and an
    analysis-subpackage-only run must not flag every knob the unscanned
    server/erasure sources actually read."""
    from .knobs import KNOBS, PREFIX_KNOBS

    if "analysis/knobs.py" not in index.summaries \
            or "server/app.py" not in index.summaries:
        return []
    exact: set[str] = set(native_reads)
    prefixes: set[str] = {n for n in native_reads if n.endswith("_")}
    for s in index.summaries.values():
        exact.update(s.get("knob_reads", ()))
        prefixes.update(s.get("knob_prefix_reads", ()))
    decl = _declaration_lines()
    findings: list[Finding] = []
    for name in sorted(set(KNOBS) | set(PREFIX_KNOBS)):
        if name in exact or any(name.startswith(p) for p in prefixes):
            continue
        line = decl.get(name, 1)
        if suppressed("analysis/knobs.py", line, "dead-knob"):
            continue
        findings.append(Finding(
            "analysis/knobs.py", line, "dead-knob",
            f"knob `{name}` is declared in the registry but no Python "
            "or native source reads it — dead config advertised in "
            "minio_tpu_torch/docs/CONFIG.md; delete the declaration (and regenerate "
            "the docs) or wire the knob up",
        ))
    return findings


@rule("knob")
def check_knobs(tree: ast.AST, ctx) -> Iterator[Finding]:
    findings: list[Finding] = []

    def report_undeclared(node: ast.AST, name: str, prefix: bool,
                          default: str | None) -> None:
        kind = "prefix knob" if prefix else "knob"
        seen = "" if default is None else f" (default seen: {default!r})"
        findings.append(
            Finding(
                ctx.path, node.lineno, "knob",
                f"undeclared {kind} `{name}`{seen}: declare it in "
                "minio_tpu_torch/analysis/knobs.py with a default and "
                "description, then regenerate minio_tpu_torch/docs/CONFIG.md",
            )
        )

    def check_key(node: ast.AST, key: ast.AST, call: ast.Call | None,
                  key_index: int = 0) -> None:
        lit = _knob_literal(key)
        if lit is None:
            return
        name, prefix = lit
        default = (
            _default_literal(call, key_index) if call is not None else None
        )
        if not _declared(name, prefix):
            report_undeclared(node, name, prefix, default)
            return
        if default is not None:
            declared = PREFIX_KNOBS.get(name) if prefix else KNOBS.get(name)
            if declared is not None and declared.default != default:
                findings.append(
                    Finding(
                        ctx.path, node.lineno, "knob",
                        f"knob `{name}` read with default {default!r} but "
                        f"registry declares {declared.default!r}; align "
                        "the call site or the registry",
                    )
                )

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = dotted_name(node.func) or ""
            is_env_call = (
                (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _READ_ATTRS
                )
                or fname.endswith("getenv")
            )
            if is_env_call and node.args:
                check_key(node, node.args[0], node)
            elif node.args:
                # project helpers (`setting(...)`, `_int(...)`) read env
                # through wrappers: any knob literal in call args still
                # needs a declaration (no default compare — the second
                # arg may be a config key, not a default)
                for a in node.args:
                    lit = _knob_literal(a)
                    if lit is not None and not _declared(*lit):
                        report_undeclared(node, lit[0], lit[1], None)
        elif isinstance(node, ast.Subscript):
            base = dotted_name(node.value) or ""
            if base.endswith("environ"):
                check_key(node, node.slice, None)
        elif isinstance(node, ast.Compare):
            for side in [node.left, *node.comparators]:
                lit = _knob_literal(side)
                if lit is not None and not _declared(*lit):
                    report_undeclared(node, lit[0], lit[1], None)
    return findings
