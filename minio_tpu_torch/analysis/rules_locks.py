"""Lock-discipline rule.

Two ways this codebase has historically leaked or deadlocked:

1. ``await`` while holding a *sync* ``threading.Lock`` — the coroutine
   parks at the await still owning the lock; any other coroutine (or an
   executor thread calling back into the loop) that wants the lock now
   blocks the event loop itself. Sync locks and awaits must not overlap.

2. A namespace-lock acquire (``mtx.lock()`` / ``mtx.rlock()`` /
   ``_lock_dyn(mtx, ...)``) whose release is not pinned down by an
   immediately-following ``try/finally`` — any exception between acquire
   and release strands the object locked until the TTL expires (30 s of
   unavailability per leak).
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from .core import (
    Finding,
    FunctionStackVisitor,
    contains_await,
    dotted_name,
    rule,
)

_LOCKISH_RE = re.compile(r"(?i)(lock|mutex|_cv\b|cond)")
_ACQUIRE_ATTRS = {"lock", "rlock", "acquire"}
_RELEASE_ATTRS = {"unlock", "runlock", "release"}


def _lockish_expr(node: ast.AST) -> str | None:
    """Name of a lock-looking context expr (``self._lock``, ``mtx``)."""
    if isinstance(node, ast.Attribute) and _LOCKISH_RE.search(node.attr):
        return node.attr
    if isinstance(node, ast.Name) and _LOCKISH_RE.search(node.id):
        return node.id
    return None


@rule("lock-discipline")
def check_locks(tree: ast.AST, ctx) -> Iterator[Finding]:
    findings: list[Finding] = []

    class V(FunctionStackVisitor):
        def visit_With(self, node: ast.With) -> None:
            if self.in_async:
                for item in node.items:
                    name = _lockish_expr(item.context_expr)
                    if name and contains_await(node.body):
                        findings.append(
                            Finding(
                                ctx.path, node.lineno, "lock-discipline",
                                f"`await` while holding sync lock `{name}`"
                                " parks the coroutine with the lock held;"
                                " use an asyncio.Lock or release before"
                                " awaiting",
                            )
                        )
                        break
            self.generic_visit(node)

        def visit_FunctionDef(self, node):
            self._check_acquire_finally(node)
            super().visit_FunctionDef(node)

        def visit_AsyncFunctionDef(self, node):
            self._check_acquire_finally(node)
            super().visit_AsyncFunctionDef(node)

        def _check_acquire_finally(self, fn) -> None:
            for body in _blocks(fn):
                for i, stmt in enumerate(body):
                    acq = _acquire_in_stmt(stmt)
                    if acq is None:
                        continue
                    if not _released_after(body[i + 1:], stmt):
                        findings.append(
                            Finding(
                                ctx.path, stmt.lineno, "lock-discipline",
                                f"`{acq}` acquired without a try/finally "
                                "release in the same block; an exception "
                                "here strands the lock until TTL expiry",
                            )
                        )

    def _blocks(fn) -> Iterator[list[ast.stmt]]:
        """Every statement list in the function, nested defs excluded."""
        stack: list[ast.AST] = [fn]
        first = True
        while stack:
            node = stack.pop()
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not first
            ):
                continue
            first = False
            for name in ("body", "orelse", "finalbody"):
                block = getattr(node, name, None)
                if block:
                    yield block
                    stack.extend(block)
            for h in getattr(node, "handlers", []) or []:
                yield h.body
                stack.extend(h.body)

    def _acquire_in_stmt(stmt: ast.stmt) -> str | None:
        """Dotted acquire call in an Assign/Expr/If-test statement (not
        inside a `with`, which releases by construction)."""
        roots: list[ast.AST] = []
        if isinstance(stmt, ast.Expr) or isinstance(stmt, ast.Assign):
            roots.append(stmt.value)
        elif isinstance(stmt, ast.If):
            roots.append(stmt.test)
        for root in roots:
            for n in ast.walk(root):
                if not isinstance(n, ast.Call):
                    continue
                name = dotted_name(n.func)
                if name == "_lock_dyn" and n.args:
                    return "_lock_dyn(%s)" % (dotted_name(n.args[0]) or "…")
                if (
                    isinstance(n.func, ast.Attribute)
                    and n.func.attr in _ACQUIRE_ATTRS
                    and _lockish_expr(n.func.value)
                ):
                    return f"{dotted_name(n.func)}()"
        return None

    def _releases(stmts: list[ast.stmt]) -> bool:
        for n in ast.walk(ast.Module(body=list(stmts), type_ignores=[])):
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr in _RELEASE_ATTRS
            ):
                return True
        return False

    def _released_after(rest: list[ast.stmt], acq_stmt: ast.stmt) -> bool:
        """Discipline = a following sibling `try` that pins the release
        down: either a `finally` that releases, or (ownership-transfer
        pattern, e.g. open_object handing the lock to a streaming
        handle) a broad handler that releases then re-raises — in that
        case the success path must end inside the try (`return`), or
        post-try statements would run unprotected."""
        for stmt in rest:
            if not isinstance(stmt, ast.Try):
                continue
            if stmt.finalbody and _releases(stmt.finalbody):
                return True
            for h in stmt.handlers:
                name = dotted_name(h.type) if h.type is not None else None
                if name in (None, "BaseException", "Exception"):
                    if _releases(h.body) and any(
                        isinstance(n, ast.Raise) and n.exc is None
                        for n in ast.walk(
                            ast.Module(body=list(h.body), type_ignores=[])
                        )
                    ):
                        # transfer pattern only counts when nothing
                        # runs between the try and the end of the block
                        # (a trailing statement raising would strand
                        # the lock)
                        returns_inside = any(
                            isinstance(n, ast.Return)
                            for n in ast.walk(
                                ast.Module(body=list(stmt.body), type_ignores=[])
                            )
                        )
                        if returns_inside and stmt is rest[-1]:
                            return True
        return False

    V().visit(tree)
    return findings
