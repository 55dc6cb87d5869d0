"""``retry-discipline``: every retry goes through ``fault/retry.py``.

An ad-hoc retry loop — ``time.sleep`` pacing a loop that keeps calling a
network/storage operation whose failures it swallows — picks its own
backoff curve, forgets jitter, and ignores idempotency classes. The
shared policy (``fault/retry.RetryPolicy`` / ``Backoff``) exists so that
retry behaviour is tuned in exactly one place (``MINIO_TPU_RETRY_*``);
this rule flags the loops that bypass it.

Heuristic: a ``while``/``for`` body (outside nested defs) containing
BOTH a ``time.sleep`` call AND a network/storage-shaped call that the
loop can retry — i.e. the call is not inside a ``try`` whose broad
handlers all EXIT the loop (return/raise/break). Heartbeat loops whose
error handler tears down and returns therefore pass; swallow-and-go-
around loops do not. ``fault/retry.py`` itself is exempt — its sleep is
the one sanctioned implementation.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import (
    Finding,
    dotted_name,
    iter_nodes_outside_nested_functions,
    rule,
)

# call names (final dotted segment) that talk to the network or a drive:
# the ops a retry loop would be wrapping
_NET_STORAGE_CALLS = frozenset({
    # http / sockets
    "request", "getresponse", "urlopen", "http_connection",
    "create_connection", "connect", "sendall", "send_binary", "recv",
    # grid / storage rpc
    "call", "stream", "_rpc", "rpc",
    # StorageAPI ops
    "read_file", "read_file_stream", "create_file", "append_file",
    "write_metadata", "update_metadata", "read_version", "read_versions",
    "rename_data", "rename_file", "delete_version", "verify_file",
    "disk_info", "stat_vol", "make_vol",
    # lock plane + executor fan-out of any of the above
    "lock", "rlock", "submit",
})

_EXEMPT_RELPATHS = ("fault/retry.py",)


def _handler_exits_loop(handler: ast.ExceptHandler) -> bool:
    """True when every path through the handler leaves the loop (return /
    raise / break as a direct statement) — teardown, not retry."""
    for stmt in handler.body:
        if isinstance(stmt, (ast.Return, ast.Raise, ast.Break)):
            return True
    return False


def _retryable_net_call(loop: ast.AST, call: ast.Call) -> bool:
    """Is `call` positioned so the loop can go around after its failure —
    i.e. NOT inside a try whose handlers all exit the loop?"""
    # find the innermost Try between the loop and the call
    path: list[ast.AST] = []

    def dfs(node: ast.AST) -> bool:
        if node is call:
            return True
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            path.append(child)
            if dfs(child):
                return True
            path.pop()
        return False

    if not dfs(loop):
        return False
    for node in reversed(path):
        if isinstance(node, ast.Try):
            handlers = node.handlers
            if handlers and all(_handler_exits_loop(h) for h in handlers):
                return False
            return True
    return True  # bare call in the loop body


@rule("retry-discipline")
def check_retry_discipline(tree: ast.AST, ctx) -> Iterator[Finding]:
    if ctx.relpath in _EXEMPT_RELPATHS:
        return []
    findings: list[Finding] = []

    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.While, ast.For)):
            continue
        sleep_node = None
        net_call = None
        for n in iter_nodes_outside_nested_functions(loop.body):
            if not isinstance(n, ast.Call):
                continue
            name = dotted_name(n.func) or ""
            if name == "time.sleep" and sleep_node is None:
                sleep_node = n
            last = name.rsplit(".", 1)[-1]
            if (
                net_call is None
                and last in _NET_STORAGE_CALLS
                and name != "time.sleep"
            ):
                if _retryable_net_call(loop, n):
                    net_call = n
        if sleep_node is not None and net_call is not None:
            callee = dotted_name(net_call.func) or "<call>"
            findings.append(
                Finding(
                    ctx.path, sleep_node.lineno, "retry-discipline",
                    f"ad-hoc retry loop: `time.sleep` paces a loop around "
                    f"`{callee}`; route the retry through "
                    "fault/retry.py (RetryPolicy.run or Backoff.sleep) so "
                    "backoff, jitter, and idempotency stay centralized",
                )
            )
    return findings
