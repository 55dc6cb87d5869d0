"""``copy-discipline``: byte materialization on the data plane is budgeted.

The zero-copy data plane (erasure/bufpool.py) moves stripe bytes from
streaming-PUT ingest through the dispatcher and back out of GET gather
as views over pooled arenas; every full-buffer copy that remains is a
named, counted site (``bufpool.count_copy``) so the ingest bench can
gate ``staging == 0`` and PERF.md can attribute the survivors. A new
``.tobytes()`` or ``np.frombuffer(bytes(...))``-style materialization
quietly re-introduces the per-shard copy tax this plane removed — on a
64 MiB ingest batch that is 64 MiB of memcpy per call site per batch.

The rule flags ``.tobytes()`` and ``*.frombuffer(...)`` calls in the
hot-path files outside the (file, function) boundary sites where the
materialization is the point:

- coder's legacy/tail framing (``frame-tobytes`` / ``tail-block``
  counted sites — the numpy codec boundary needs real bytes),
- GET gather / repair / heal functions whose ``frombuffer`` wraps an
  incoming shard buffer as a zero-copy uint8 view for decode (NumPy's
  ``frombuffer`` does not copy; it is listed so additions stay
  deliberate, not because it costs a memcpy).

New sites either become views, or get counted via
``bufpool.count_copy`` and added to the boundary table here with a
reason — same contract as the ``hostsync`` boundary.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Iterator

from .core import Finding, FunctionStackVisitor, rule

# files whose function bodies count as data-plane hot path
_HOT_PATH_GLOBS = (
    "erasure/set.py",
    "erasure/coder.py",
    "parallel/dispatcher.py",
)

# (relpath, function name) pairs where materialization is the point.
# Everything else needs a pragma with a reason or a boundary entry.
COPY_BOUNDARY: dict[str, set[str]] = {
    # numpy-codec framing boundary: shard rows become bytes exactly once
    # per frame, counted as `frame-tobytes` / `tail-block`
    "erasure/coder.py": {"_encode_full_buffer", "_encode_tail_buffer"},
    # GET gather + repair + heal: frombuffer wraps shard payloads as
    # zero-copy uint8 views for the decode kernels; the heal plane's
    # tobytes feeds the bitrot re-framing writer (cold path, per-object)
    "erasure/set.py": {
        "read_sub_chunk", "repair_read_block", "decode_window",
        "assemble_repair", "read_sub", "assemble", "finish_fb",
        "repair_part_windowed", "_heal_object_locked",
    },
    # the dispatcher assembles into pooled bucket arenas; no
    # materialization site is legitimate there
    "parallel/dispatcher.py": set(),
}


def _in_hot_path(relpath: str) -> bool:
    return any(fnmatch.fnmatch(relpath, g) for g in _HOT_PATH_GLOBS)


@rule("copy-discipline")
def check_copy_discipline(tree: ast.AST, ctx) -> Iterator[Finding]:
    if not _in_hot_path(ctx.relpath):
        return []
    boundary = COPY_BOUNDARY.get(ctx.relpath, set())
    findings: list[Finding] = []

    class V(FunctionStackVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            fn = self.current_function
            # module scope (import-time constants) and boundary
            # functions are exempt
            if fn is not None and fn.name not in boundary:
                label = None
                if isinstance(node.func, ast.Attribute):
                    if node.func.attr == "tobytes":
                        label = "`.tobytes()`"
                    elif node.func.attr == "frombuffer":
                        label = "`.frombuffer()`"
                if label is not None:
                    findings.append(
                        Finding(
                            ctx.path, node.lineno, "copy-discipline",
                            f"{label} in data-plane hot path `{fn.name}` "
                            "re-introduces an uncounted buffer "
                            "materialization; serve a memoryview/array "
                            "view instead, or count the copy via "
                            "`bufpool.count_copy` and add the function "
                            "to rules_copy.COPY_BOUNDARY with a reason",
                        )
                    )
            self.generic_visit(node)

    V().visit(tree)
    return findings
