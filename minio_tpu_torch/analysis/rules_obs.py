"""Tracing-discipline rule: ``span``.

Trace spans (minio_tpu_torch/obs) set a contextvar on entry and publish +
reset it on exit; a ``span_start``-style call with no guaranteed
``finally`` would leak the context token and corrupt every tree that
request touches. The only supported way to open a span is therefore the
context-manager API::

    with obs.span(obs.TYPE_STORAGE, "readfile", drive=ep) as sp:
        ...

This rule flags, everywhere outside ``obs/`` itself:

- any ``obs.span(...)`` / ``trace.span(...)`` / imported ``span(...)``
  call that is not the context expression of a ``with`` (or
  ``async with``) item — including ``span(...).__enter__()`` trickery;
- direct ``Span(...)`` construction and any ``span_start``/``start_span``
  call (no such API exists; if one appears, it is a bug by definition).
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, dotted_name, rule

_ORPHAN_NAMES = {"span_start", "start_span"}


def _is_span_call(node: ast.Call, span_imported: bool) -> bool:
    name = dotted_name(node.func)
    if name is None:
        return False
    if name == "span":
        return span_imported
    return name.endswith(".span") and name.split(".")[-2] in ("obs", "trace")


def _span_imported_from_obs(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
            node.module == "obs" or node.module.endswith(".obs")
            or node.module.endswith("obs.trace")
        ):
            if any(a.name == "span" for a in node.names):
                return True
    return False


@rule("span")
def check_span_discipline(tree: ast.AST, ctx) -> Iterator[Finding]:
    if ctx.relpath.startswith("obs/"):
        return  # the span implementation itself
    span_imported = _span_imported_from_obs(tree)
    with_exprs: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                with_exprs.add(id(item.context_expr))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func) or ""
        short = name.split(".")[-1]
        if short in _ORPHAN_NAMES:
            yield Finding(
                ctx.path, node.lineno, "span",
                f"{name}(): open spans via the context-manager API "
                "(`with obs.span(...)`) — a start without a guaranteed "
                "finally leaks the trace context token",
            )
            continue
        if short == "Span" and (name == "Span" or name.endswith("obs.Span")
                                or name.endswith("trace.Span")):
            yield Finding(
                ctx.path, node.lineno, "span",
                "direct Span construction: use obs.span(...), which is "
                "zero-cost when tracing is idle",
            )
            continue
        if _is_span_call(node, span_imported) and id(node) not in with_exprs:
            yield Finding(
                ctx.path, node.lineno, "span",
                f"{name}(...) outside a `with` statement: spans must be "
                "opened via the context-manager API so the exit (publish "
                "+ contextvar reset) always runs",
            )
