"""Async-plane rules: ``blocking`` and ``cancellation``.

The serving plane is one asyncio event loop per process; a single
blocking call inside an ``async def`` stalls every in-flight S3 request,
and a broad ``except`` that eats ``asyncio.CancelledError`` turns client
disconnects into half-finished work that still runs to completion.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import (
    Finding,
    FunctionStackVisitor,
    contains_await,
    dotted_name,
    iter_nodes_outside_nested_functions,
    rule,
)

# call targets that block the calling thread. Inside async def these
# stall the loop; time.sleep additionally gets flagged in sync code so
# every sleep site is either moved or explicitly classified as a
# daemon-thread pacing sleep via `# miniovet: ignore[blocking]`.
_BLOCKING_EXACT = {
    "time.sleep": "use `await asyncio.sleep(...)` or run on an executor",
    "socket.create_connection": "resolve/connect via the event loop or an executor",
    "socket.getaddrinfo": "use `loop.getaddrinfo(...)`",
    "socket.gethostbyname": "use `loop.getaddrinfo(...)`",
    "urllib.request.urlopen": "use an executor (`loop.run_in_executor`)",
    "urllib.request.urlretrieve": "use an executor (`loop.run_in_executor`)",
}
_BLOCKING_MODULES = {
    "requests": "blocking HTTP client; use an executor",
    "subprocess": "blocking child-process call; use "
                  "`asyncio.create_subprocess_exec` or an executor",
}
_SYNC_FILE_IO = {
    "open": "sync file I/O on the event loop; use an executor",
    "os.fsync": "sync disk flush on the event loop; use an executor",
    "shutil.copyfileobj": "sync file copy on the event loop; use an executor",
}
# Path methods that hit the disk; flagged only for calls spelled
# `<something>.read_bytes()` etc. inside async bodies.
_PATH_IO_ATTRS = {"read_bytes", "read_text", "write_bytes", "write_text"}


def _blocking_reason(call: ast.Call, in_async: bool) -> str | None:
    name = dotted_name(call.func)
    if name is None:
        return None
    if name in _BLOCKING_EXACT:
        if name == "time.sleep" or in_async:
            return _BLOCKING_EXACT[name]
        return None
    if not in_async:
        return None
    root = name.split(".", 1)[0]
    if root in _BLOCKING_MODULES and "." in name:
        return _BLOCKING_MODULES[root]
    if name in _SYNC_FILE_IO:
        return _SYNC_FILE_IO[name]
    if isinstance(call.func, ast.Attribute) and call.func.attr in _PATH_IO_ATTRS:
        return "sync file I/O on the event loop; use an executor"
    return None


@rule("blocking")
def check_blocking(tree: ast.AST, ctx) -> Iterator[Finding]:
    """Blocking calls inside ``async def`` (and ``time.sleep`` anywhere:
    daemon-thread pacing sleeps must be classified with a pragma)."""

    findings: list[Finding] = []

    class V(FunctionStackVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            reason = _blocking_reason(node, self.in_async)
            if reason is not None:
                name = dotted_name(node.func)
                where = (
                    "inside async def stalls the event loop"
                    if self.in_async
                    else "outside a coroutine: classify (daemon thread?) "
                         "or move it"
                )
                findings.append(
                    Finding(
                        ctx.path, node.lineno, "blocking",
                        f"blocking call `{name}` {where}; {reason}",
                    )
                )
            self.generic_visit(node)

    V().visit(tree)
    return findings


# -- cancellation hygiene --------------------------------------------------

_BROAD = {"Exception", "BaseException"}


def _is_broad(handler: ast.ExceptHandler) -> str | None:
    """'Exception'/'BaseException'/'bare' when the handler is broad."""
    t = handler.type
    if t is None:
        return "bare"
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        name = dotted_name(n)
        if name in _BROAD:
            return name
    return None


def _is_cancelled_type(node: ast.AST) -> bool:
    name = dotted_name(node)
    return name is not None and name.split(".")[-1] == "CancelledError"


def _reraises(handler: ast.ExceptHandler) -> bool:
    """Does the handler body re-raise the caught exception (bare `raise`
    or `raise <caught-name>`, possibly under an `if`)?"""
    for n in iter_nodes_outside_nested_functions(handler.body):
        if isinstance(n, ast.Raise):
            if n.exc is None:
                return True
            if (
                handler.name
                and isinstance(n.exc, ast.Name)
                and n.exc.id == handler.name
            ):
                return True
            # `raise X from e` replaces the exception, keep scanning
    return False


@rule("cancellation")
def check_cancellation(tree: ast.AST, ctx) -> Iterator[Finding]:
    """Broad handlers around ``await`` must let cancellation out: add an
    ``except asyncio.CancelledError: raise`` clause before them, narrow
    the type, re-raise, or annotate with a reason."""

    findings: list[Finding] = []

    class V(FunctionStackVisitor):
        def visit_Try(self, node: ast.Try) -> None:
            if self.in_async and contains_await(node.body):
                cancel_handled = False
                for h in node.handlers:
                    if h.type is not None and not _is_broad(h):
                        hts = (
                            h.type.elts
                            if isinstance(h.type, ast.Tuple)
                            else [h.type]
                        )
                        if any(_is_cancelled_type(t) for t in hts):
                            cancel_handled = _reraises(h)
                        continue
                    broad = _is_broad(h)
                    if broad and not cancel_handled and not _reraises(h):
                        label = (
                            "bare `except:`"
                            if broad == "bare"
                            else f"`except {broad}`"
                        )
                        findings.append(
                            Finding(
                                ctx.path, h.lineno, "cancellation",
                                f"{label} around `await` can swallow "
                                "cancellation (client disconnect); add "
                                "`except asyncio.CancelledError: raise` "
                                "before it, narrow it, or re-raise",
                            )
                        )
            self.generic_visit(node)

    V().visit(tree)
    return findings
