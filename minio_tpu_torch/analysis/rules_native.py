"""knob-native rule: ``getenv("MINIO_*")`` reads in native sources must
be declared in the knob registry.

The Python ``knob`` rule walks ASTs, so a knob read from C++ (the native
data plane reads ``MINIO_TPU_NATIVE_THREADS`` at ``dp_put_open`` time)
was invisible to the gate — a worker-plane knob could ship undocumented
and un-generated into minio_tpu_torch/docs/CONFIG.md. This rule regex-scans native
sources (``.cpp``/``.cc``/``.h``, and the CUDA kernels' ``.cu``/``.cuh``)
for ``getenv`` of a ``MINIO_*`` name
and fails on any name the registry doesn't declare.

Suppression uses the same pragma syntax as Python rules, in a C++
comment on the same line::

    getenv("MINIO_X")  // miniovet: ignore[knob-native] -- reason
"""

from __future__ import annotations

import re

from .core import ALL_RULES, Finding
from .knobs import KNOBS, PREFIX_KNOBS

NATIVE_EXTS = (".cpp", ".cc", ".cxx", ".h", ".hpp", ".cu", ".cuh")

_GETENV_RE = re.compile(r'\bgetenv\s*\(\s*"(MINIO_[A-Z0-9_]*)"\s*\)')
_PRAGMA_RE = re.compile(r"//\s*miniovet:\s*ignore\[([a-z0-9_,\s-]+)\]")

RULE_ID = "knob-native"


def _declared(name: str) -> bool:
    if name in KNOBS:
        return True
    return any(name.startswith(p) for p in PREFIX_KNOBS)


def scan_native_source(source: str, path: str) -> list[Finding]:
    findings: list[Finding] = []
    for lineno, line in enumerate(source.splitlines(), 1):
        pragma = _PRAGMA_RE.search(line)
        suppressed = pragma is not None and (
            RULE_ID in pragma.group(1) or "*" in pragma.group(1)
        )
        for m in _GETENV_RE.finditer(line):
            name = m.group(1)
            if _declared(name) or suppressed:
                continue
            findings.append(
                Finding(
                    path, lineno, RULE_ID,
                    f"undeclared knob `{name}` read from native code: "
                    "declare it in minio_tpu_torch/analysis/knobs.py with a "
                    "default and description, then regenerate "
                    "minio_tpu_torch/docs/CONFIG.md",
                )
            )
    return findings


def scan_native_file(path: str) -> list[Finding]:
    with open(path, "r", encoding="utf-8", errors="replace") as fh:
        return scan_native_source(fh.read(), path)


_KNOB_LIT_RE = re.compile(r'"(MINIO_[A-Z0-9_]*)"')


def native_knob_reads(path: str) -> set[str]:
    """Every quoted MINIO_* literal in a native source — conservative
    read evidence for the dead-knob pass (a mention is a read)."""
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            return {
                m for m in _KNOB_LIT_RE.findall(fh.read())
                if m != "MINIO_"
            }
    except OSError:
        return set()


def _noop_python_rule(tree, ctx):
    """Registered so --select/--list-rules know the id; the real scan
    runs over native sources in analyze_paths (no AST to walk here)."""
    return ()


_noop_python_rule.rule_id = RULE_ID
ALL_RULES[RULE_ID] = _noop_python_rule
