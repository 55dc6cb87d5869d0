"""Whole-program analysis driver: symbol table, call graph, summaries.

The per-file rules (rules_*.py) see one tree at a time; everything that
needs to understand the *program* — "is this blocking call reachable
from an async def through three sync helpers", "do these two subsystems
acquire locks in opposite orders" — runs here. The pipeline:

1. every ``.py`` file is parsed once and reduced to a serializable
   **FileSummary**: functions with their call sites (classified as plain
   calls vs executor/thread submissions, which sever the event-loop
   context), blocking primitives, lock definitions and lock-held
   regions, per-return-path call sets, and broad try/except blocks;
2. summaries are indexed into a **ProjectIndex**: module-qualified
   symbol table (functions, classes with bases, import aliases) and a
   resolver mapping call expressions (``self._helper``, ``mod.fn``,
   ``Backoff(...).sleep`` via local type inference, unique-name
   fallback) to definitions;
3. the interprocedural passes (interproc.py) walk the resulting call
   graph.

Summaries — not trees — are what the **incremental cache** stores: a
JSON file keyed by content hash, plus a digest of the analysis package
itself so rule changes bust everything. A warm run re-parses only
changed files; the interprocedural passes always re-run (they are
whole-program by nature) but on cached summaries they cost milliseconds.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
import time
from dataclasses import dataclass, field

from .core import (
    FileContext,
    Finding,
    analyze_tree,
    iter_python_files,
    unused_pragma_findings,
    _package_relpath,
)

# bump to invalidate every cache entry on engine-format changes
ENGINE_VERSION = "miniovet-ip-4"

# interprocedural pass ids (per-file rule ids live in core.ALL_RULES)
INTERPROC_PASSES = (
    "blocking-reachable",
    "lock-order",
    "coherence-path",
    "cancellation-reachable",
    "races",
    "resources",
    "error-taint",
    "dead-knob",
    "surface",
)

# blocking primitives for reachability (names matched on the dotted call
# expression). Sync file I/O is deliberately NOT here: the per-file
# `blocking` rule flags direct use in async defs, and flagging every
# helper that opens a file would drown the signal — the executor
# boundary is where file I/O is supposed to live.
_BLOCKING_PRIMS = {
    "time.sleep": "time.sleep",
    "socket.create_connection": "sync connect",
    "socket.getaddrinfo": "sync DNS",
    "socket.gethostbyname": "sync DNS",
    "subprocess.run": "subprocess",
    "subprocess.call": "subprocess",
    "subprocess.check_call": "subprocess",
    "subprocess.check_output": "subprocess",
    "urllib.request.urlopen": "sync HTTP",
    "urllib.request.urlretrieve": "sync HTTP",
}
_BLOCKING_ROOTS = {"requests"}  # requests.get/post/... sync HTTP client

# attribute calls that park the calling thread on a future/queue — the
# cancellation-relevant sync waits (concurrent.futures Future.result
# raises CancelledError; a broad except around a helper that calls it
# swallows cancellation exactly like one around an await)
_WAIT_ATTRS = {"result"}

_LOCKISH_ATTRS = ("lock", "mutex", "_mu", "_cv", "cond")

# receiver-method calls that mutate the receiver's container in place:
# `self.queue.append(x)` is a WRITE to the `queue` attribute for the
# data-race pass even though the attribute expression itself is a Load
_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "clear", "discard", "extend", "insert",
    "pop", "popleft", "popitem", "remove", "update", "setdefault",
    "move_to_end", "sort", "reverse", "rotate",
})


# -- resource lifetimes (the `resources` pass) ------------------------------
#
# Acquisition shapes that hand the caller something it must release,
# transfer, or deliberately anchor. Per kind: the methods that balance
# the acquisition when called on the bound name. The per-exit proof
# lives in rules_resources.py; the extractor only records the raw facts.
RESOURCE_RELEASES: dict[str, tuple[str, ...]] = {
    "nslock": ("unlock", "runlock", "close"),
    "future": ("result", "cancel", "exception", "add_done_callback"),
    "task": ("cancel", "result", "add_done_callback"),
    "spool": ("close", "cleanup", "unlink"),
    "file": ("close",),
    "span": ("close", "finish"),
}

# free functions that release/consume the resource passed as an argument
FREE_RELEASERS = frozenset({
    "os.close", "os.unlink", "os.remove", "os.replace", "os.rename",
    "os.rmdir", "os.removedirs", "shutil.rmtree", "shutil.move",
})

# calls that anchor futures/tasks handed to them (the waiter owns them)
WAITER_CALLS = frozenset({
    "as_completed", "concurrent.futures.as_completed",
    "futures.as_completed", "concurrent.futures.wait", "futures.wait",
    "asyncio.wait", "asyncio.gather", "asyncio.wait_for",
    "asyncio.wrap_future",
})

_SPOOL_CTORS = frozenset({
    "tempfile.NamedTemporaryFile", "NamedTemporaryFile",
    "tempfile.TemporaryDirectory", "TemporaryDirectory",
    "tempfile.mkstemp", "mkstemp", "tempfile.mkdtemp", "mkdtemp",
})

_FILE_CTORS = frozenset({"open", "io.open", "os.fdopen"})

# container-add methods whose Name arguments escape to the container's
# lifetime (an anchored future/task is the collection owner's problem)
_CONTAINER_ADDS = frozenset({"append", "appendleft", "add", "put",
                             "register", "add_done_callback"})

_ALL_RELEASE_ATTRS = frozenset(
    a for attrs in RESOURCE_RELEASES.values() for a in attrs
)

_KNOB_LIT_RE = re.compile(r"^MINIO_[A-Z0-9_]*$")


def acquisition_kind(expr: str) -> str | None:
    """Resource kind acquired by a call with this dotted shape, or None."""
    attr = expr.split(".")[-1]
    if attr == "submit":
        return "future"
    if attr in ("create_task", "ensure_future"):
        return "task"
    if expr in _SPOOL_CTORS:
        return "spool"
    return None


def _is_lockish(name: str) -> bool:
    low = name.lower()
    return any(t in low for t in _LOCKISH_ATTRS) and "unlock" not in low


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for pure Name/Attribute chains; chains rooted in a call or
    subscript (``self.set_for(x).put_object``) come back as '?.put_object'
    so the method name survives for heuristic resolution."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    if parts and isinstance(node, (ast.Call, ast.Subscript, ast.Await)):
        return "?." + parts[0]  # keep only the method actually invoked
    return None


def _module_name(relpath: str) -> str:
    """'erasure/set.py' -> 'erasure.set'; 'cache/__init__.py' -> 'cache';
    '__init__.py' -> '' (the package root)."""
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    if mod.endswith("__init__"):
        mod = mod[: -len("__init__")].rstrip(".")
    return mod


# -- per-file summary extraction -------------------------------------------


def _unwrap_callable_arg(node: ast.AST) -> ast.AST:
    """run_in_executor(None, bind_context(fn)) / partial(fn, x) -> fn."""
    if isinstance(node, ast.Call):
        fname = _dotted(node.func) or ""
        if fname.split(".")[-1] in ("bind_context", "partial") and node.args:
            return _unwrap_callable_arg(node.args[0])
    return node


def _callable_ref(node: ast.AST) -> str | None:
    node = _unwrap_callable_arg(node)
    return _dotted(node)


def _boundary_via(expr: str, attr: str, call: ast.Call) -> str:
    """Identity of the executor pool / thread a boundary submission runs
    on — the data-race pass keys execution contexts on it. Pools are
    named by the receiver attribute (``self._io_pool.submit`` ->
    ``_io_pool``) so two submissions to the same pool share a context
    and submissions to different pools do not."""
    if attr == "submit":
        recv = expr.rsplit(".", 1)[0] if "." in expr else expr
        return recv.split(".")[-1] or "pool"
    if attr == "to_thread":
        return "to_thread"
    if attr == "_run":
        return "_io_pool"
    if attr == "run_in_executor":
        if call.args:
            ex = _dotted(call.args[0])
            if ex and ex != "None":
                return ex.split(".")[-1]
        return "default-executor"
    if attr == "Thread":
        for kw in call.keywords:
            if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
            if kw.arg == "name" and isinstance(kw.value, ast.JoinedStr) \
                    and kw.value.values \
                    and isinstance(kw.value.values[0], ast.Constant) \
                    and isinstance(kw.value.values[0].value, str):
                # f"device-dispatch-{d}+{p}": the constant head is the
                # thread's identity (parameterized suffix)
                return kw.value.values[0].value
        for kw in call.keywords:
            if kw.arg == "target":
                ref = _callable_ref(kw.value)
                if ref:
                    return ref.split(".")[-1]
        return "thread"
    return attr


class _FunctionExtractor:
    """Walks one function body (nested defs excluded — they get their own
    summaries) collecting calls, blocking primitives, lock regions."""

    def __init__(self, fn: ast.AST, qualname: str, cls: str | None,
                 want_exits: bool):
        self.fn = fn
        args = fn.args
        params = [a.arg for a in
                  (args.posonlyargs + args.args + args.kwonlyargs)]
        self.sum: dict = {
            "name": qualname,
            "line": fn.lineno,
            "async": isinstance(fn, ast.AsyncFunctionDef),
            "class": cls,
            "params": params,  # declared parameter names, in order
            "calls": [],       # {expr, line, kind[, argv, kw]}
            "prims": [],       # {what, line}
            "waits": [],       # {expr, line} -- .result()-style sync waits
            "holds": [],       # {lock, line, calls, acquires}
            "acquires": [],    # {lock, line} -- every acquire in this fn
            "locals": {},      # var -> class-ref expr (light type inference)
            "broad_trys": [],  # {line, calls} (async fns only)
            "exits": [],       # {line, kind, before, tail, names}
            "attrs": [],       # {recv, attr, rw, line, locks} (races pass)
            "resources": [],   # {kind, var, line, expr, cm, loose}
            "releases": [],    # {var, how, line} -- release-shaped events
            "escapes": [],     # names stored on self/containers (lifetime
                               # escapes: the owner releases, not this fn)
            "raises": [],      # {type, line}
            "swallows": [],    # {line, cleanup} broad no-reraise handlers
            "catches": [],     # typed exception names caught here
        }
        self.want_exits = want_exits
        self._active_holds: list[dict] = []
        self._loop_depth = 0     # inside For/While: exits can't see body
        self._branch_depth = 0   # inside If/except: acquisition conditional
        self._cleanup_depth = 0  # inside except/finally: unwinding context
        self._finally_trys: list[int] = []  # try linenos whose finally
        # we are inside: releases there credit exits of THAT try only

    def run(self) -> dict:
        self._walk_block(self.fn.body)
        if self.want_exits:
            self.sum["exits"] = _exit_paths(self.fn)
        if isinstance(self.fn, ast.AsyncFunctionDef):
            self._collect_broad_trys()
        # serialize sets
        for h in self.sum["holds"]:
            h["calls"] = sorted(set(h["calls"]))
            h["acquires"] = sorted(set(h["acquires"]))
        self.sum["escapes"] = sorted(set(self.sum["escapes"]))
        self.sum["catches"] = sorted(set(self.sum["catches"]))
        return self.sum

    # -- expression-level collection ------------------------------------

    def _scan_expr(self, node: ast.AST) -> None:
        """Record calls/prims/waits in an expression tree, not descending
        into nested function/class definitions."""
        awaited: set[int] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Await):
                if isinstance(n.value, ast.Call):
                    awaited.add(id(n.value))
                elif isinstance(n.value, ast.Name):
                    # `await task` anchors the task: the awaiter owns it
                    self.sum["releases"].append(
                        {"var": n.value.id, "how": "await",
                         "line": n.lineno}
                    )
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                self._record_call(n, awaited=id(n) in awaited)
        self._scan_attrs(node)

    def _scan_attrs(self, node: ast.AST) -> None:
        """Attribute accesses with the lockset held at the access — the
        raw facts of the data-race pass. An access is a WRITE when the
        attribute is a Store/Del target, the base of a subscript store
        (``self.stats["k"] += 1``), or the receiver of an in-place
        container mutator (``self.queue.append(x)``); everything else is
        a read. Lock attributes themselves and called method attributes
        are skipped (they are guards and code, not shared data)."""
        callfuncs: set[int] = set()
        forced_writes: set[int] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                callfuncs.add(id(n.func))
                f = n.func
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr in _MUTATOR_METHODS
                    and isinstance(f.value, ast.Attribute)
                ):
                    forced_writes.add(id(f.value))
            elif isinstance(n, ast.Subscript) and isinstance(
                n.ctx, (ast.Store, ast.Del)
            ):
                if isinstance(n.value, ast.Attribute):
                    forced_writes.add(id(n.value))
        held = sorted({h["lock"] for h in self._active_holds})
        seen: set[tuple] = set()
        for n in ast.walk(node):
            if not isinstance(n, ast.Attribute):
                continue
            if id(n) in callfuncs and id(n) not in forced_writes:
                continue  # plain method call: code, not data
            if _is_lockish(n.attr) or n.attr.startswith("__"):
                continue
            recv = _dotted(n.value)
            if recv is None or recv.startswith("?."):
                continue
            rw = (
                "w"
                if isinstance(n.ctx, (ast.Store, ast.Del))
                or id(n) in forced_writes
                else "r"
            )
            key = (recv, n.attr, rw, n.lineno)
            if key in seen:
                continue
            seen.add(key)
            self.sum["attrs"].append({
                "recv": recv, "attr": n.attr, "rw": rw,
                "line": n.lineno, "locks": held,
            })

    def _record_call(self, call: ast.Call, awaited: bool = False) -> None:
        expr = _dotted(call.func)
        if expr is None:
            return
        line = call.lineno
        attr = expr.split(".")[-1]
        # raw facts for the resources pass: Name arguments (release by
        # free function, ownership transfer into callees), release-shaped
        # method calls on locals, and container-add escapes
        argv = [a.id for a in call.args if isinstance(a, ast.Name)]
        kwv = {
            kw.arg: kw.value.id for kw in call.keywords
            if kw.arg and isinstance(kw.value, ast.Name)
        }
        parts = expr.split(".")
        if len(parts) == 2 and attr in _ALL_RELEASE_ATTRS:
            rel: dict = {"var": parts[0], "how": attr, "line": line}
            if self._finally_trys:
                rel["fin"] = self._finally_trys[-1]
            self.sum["releases"].append(rel)
        if expr in FREE_RELEASERS or expr in WAITER_CALLS \
                or attr in ("as_completed", "wait_futures"):
            for name in argv:
                rel = {"var": name, "how": expr, "line": line}
                if self._finally_trys:
                    rel["fin"] = self._finally_trys[-1]
                self.sum["releases"].append(rel)
        if attr in _CONTAINER_ADDS:
            self.sum["escapes"].extend(argv)
            self.sum["escapes"].extend(kwv.values())
        if expr == "isinstance" and len(call.args) == 2:
            # isinstance dispatch is typed handling too (the quorum
            # reducer / retry predicates classify errors this way)
            t = call.args[1]
            for el in (t.elts if isinstance(t, ast.Tuple) else [t]):
                d = _dotted(el)
                if d:
                    self.sum["catches"].append(d.split(".")[-1])
        # executor/thread boundaries: the submitted callable runs off the
        # event loop — record the edge with its kind so reachability can
        # stop (executor/thread) or continue (task: runs ON the loop)
        boundary: tuple[str, int] | None = None  # (kind, arg index)
        if attr == "submit":
            boundary = ("executor", 0)
        elif attr == "to_thread":
            boundary = ("executor", 0)
        elif attr == "run_in_executor":
            boundary = ("executor", 1)
        elif attr == "_run":
            # the server's `await self._run(fn, ...)` indirection: the
            # callable arg runs on the I/O executor pool. The `_run` call
            # itself still records below (it is also an awaited edge).
            boundary = ("executor", 0)
        elif attr == "Thread" and expr in ("threading.Thread", "Thread"):
            boundary = ("thread", -1)  # target= keyword
        elif attr in ("call_soon", "call_soon_threadsafe"):
            boundary = ("task", 0)
        elif attr == "call_later":
            boundary = ("task", 1)
        if boundary is not None:
            kind, idx = boundary
            target: ast.AST | None = None
            if idx == -1:
                for kw in call.keywords:
                    if kw.arg == "target":
                        target = kw.value
            elif len(call.args) > idx:
                target = call.args[idx]
            if target is not None:
                ref = _callable_ref(target)
                if ref:
                    self.sum["calls"].append(
                        {"expr": ref, "line": line, "kind": kind,
                         "via": _boundary_via(expr, attr, call)}
                    )
            if attr != "_run":
                return
        # blocking primitives
        root = expr.split(".", 1)[0]
        if expr in _BLOCKING_PRIMS:
            self.sum["prims"].append({"what": expr, "line": line})
        elif root in _BLOCKING_ROOTS and "." in expr:
            self.sum["prims"].append({"what": expr, "line": line})
        elif not awaited and attr in _WAIT_ATTRS and "." in expr:
            self.sum["waits"].append({"expr": expr, "line": line})
        # an awaited call can only target an awaitable — linking it to a
        # sync def (via the unique-name fallback, say) would be wrong by
        # construction, so the edge carries its own kind
        rec: dict = {"expr": expr, "line": line,
                     "kind": "await" if awaited else "call"}
        if argv:
            rec["argv"] = argv
        if kwv:
            rec["kw"] = kwv
        self.sum["calls"].append(rec)
        for h in self._active_holds:
            h["calls"].append(expr)

    # -- statement-level walk (tracks lock-held regions) -----------------

    def _acquire(self, lock_expr: str, line: int) -> None:
        self.sum["acquires"].append({"lock": lock_expr, "line": line})
        for h in self._active_holds:
            h["acquires"].append(lock_expr)

    def _open_hold(self, lock_expr: str, line: int) -> dict:
        self._acquire(lock_expr, line)
        h = {"lock": lock_expr, "line": line, "calls": [], "acquires": []}
        self.sum["holds"].append(h)
        self._active_holds.append(h)
        return h

    def _close_hold(self, h: dict) -> None:
        self._active_holds.remove(h)

    def _walk_block(self, stmts: list[ast.stmt]) -> None:
        pending_nslock: int | None = None
        for st in stmts:
            # ns-lock idiom: an acquire statement (`if not _lock_dyn(mtx):
            # raise` / `ok = mtx.lock(...)`) whose held region is the
            # immediately-following try block (the discipline shape
            # rules_locks.py enforces)
            if pending_nslock is not None and isinstance(st, ast.Try):
                h = self._open_hold("<nslock>", pending_nslock)
                pending_nslock = None
                self._walk_stmt(st)
                self._close_hold(h)
                continue
            pending_nslock = None
            acq = self._nslock_acquire_in(st)
            if acq is not None:
                acq_line, acq_var = acq
                self._acquire("<nslock>", acq_line)
                self.sum["resources"].append({
                    "kind": "nslock", "var": acq_var, "line": acq_line,
                    "expr": "<nslock>", "cm": False,
                    "loose": bool(self._loop_depth or self._branch_depth
                                  or self._cleanup_depth),
                })
                pending_nslock = acq_line
            self._walk_stmt(st)

    def _walk_stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs summarized separately
        if isinstance(st, (ast.With, ast.AsyncWith)):
            held: list[dict] = []
            for item in st.items:
                ce = item.context_expr
                lock = None
                if isinstance(ce, (ast.Attribute, ast.Name)):
                    name = _dotted(ce)
                    if name and _is_lockish(name.split(".")[-1]):
                        lock = name
                if lock is not None:
                    held.append(self._open_hold(lock, st.lineno))
                else:
                    # context-manager acquisitions are balanced by
                    # construction — table rows, never findings
                    if isinstance(ce, ast.Call):
                        ref = _dotted(ce.func) or ""
                        kind = acquisition_kind(ref)
                        if kind is None and ref in _FILE_CTORS:
                            kind = "file"
                        if kind is None and ref.split(".")[-1] == "span":
                            kind = "span"
                        if kind is not None:
                            var = None
                            if isinstance(item.optional_vars, ast.Name):
                                var = item.optional_vars.id
                            self.sum["resources"].append({
                                "kind": kind, "var": var,
                                "line": st.lineno, "expr": ref,
                                "cm": True, "loose": False,
                            })
                    self._scan_expr(ce)
            self._walk_block(st.body)
            for h in held:
                self._close_hold(h)
            return
        if isinstance(st, ast.If):
            self._scan_expr(st.test)
            self._branch_depth += 1
            self._walk_block(st.body)
            self._walk_block(st.orelse)
            self._branch_depth -= 1
            return
        if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
            for fieldname, value in ast.iter_fields(st):
                if fieldname in ("body", "orelse"):
                    continue
                if isinstance(value, ast.AST):
                    self._scan_expr(value)
            self._loop_depth += 1
            self._walk_block(st.body)
            self._walk_block(st.orelse)
            self._loop_depth -= 1
            return
        if isinstance(st, ast.Try):
            self._collect_try(st)
            self._walk_block(st.body)
            self._walk_block(st.orelse)
            # handler/finally bodies run while unwinding: a broad
            # swallow nested in one is cleanup, and acquisitions there
            # are conditional
            self._branch_depth += 1
            self._cleanup_depth += 1
            for hdl in st.handlers:
                self._walk_block(hdl.body)
            # a finally block runs on every exit path of its try — a
            # release there (even a conditional `if mtx: mtx.unlock()`)
            # is the guarded-resource idiom and credits every exit of
            # THAT try (never an earlier return above it)
            self._finally_trys.append(st.lineno)
            self._walk_block(st.finalbody)
            self._finally_trys.pop()
            self._cleanup_depth -= 1
            self._branch_depth -= 1
            return
        if isinstance(st, ast.Raise):
            for value in (st.exc, st.cause):
                if value is not None:
                    self._scan_expr(value)
            if st.exc is not None:
                t = st.exc.func if isinstance(st.exc, ast.Call) else st.exc
                d = _dotted(t)
                if d and not d.startswith("?."):
                    self.sum["raises"].append(
                        {"type": d, "line": st.lineno}
                    )
            return
        if isinstance(st, ast.Assign):
            # lifetime escape: a local stored on self (or into any
            # container/subscript slot) outlives this call — the owner
            # releases it, not this function's exits
            if isinstance(st.value, ast.Name) and any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in st.targets
            ):
                self.sum["escapes"].append(st.value.id)
            if isinstance(st.value, ast.Call):
                ref = _dotted(st.value.func)
                if ref and len(st.targets) == 1 \
                        and isinstance(st.targets[0], ast.Name):
                    # light local type inference: v = ClassRef(...)
                    seg = ref.split(".")[-1]
                    if seg[:1].isupper() or seg == "new":
                        self.sum["locals"][st.targets[0].id] = ref
                if ref:
                    kind = acquisition_kind(ref)
                    if kind is None and ref in _FILE_CTORS:
                        kind = "file"  # raw handle assigned outside with
                    var = None
                    if len(st.targets) == 1:
                        t = st.targets[0]
                        if isinstance(t, ast.Name):
                            var = t.id
                        elif isinstance(t, (ast.Tuple, ast.List)) \
                                and t.elts \
                                and isinstance(t.elts[0], ast.Name):
                            var = t.elts[0].id  # fd, path = mkstemp()
                        elif isinstance(t, (ast.Attribute, ast.Subscript)):
                            var = "<stored>"  # acquired straight into
                            # an attribute/container slot: escapes
                    if kind is not None and var is not None:
                        if var == "<stored>":
                            self.sum["resources"].append({
                                "kind": kind, "var": None,
                                "line": st.lineno, "expr": ref,
                                "cm": False, "loose": False,
                                "escaped": True,
                            })
                        else:
                            self.sum["resources"].append({
                                "kind": kind, "var": var,
                                "line": st.lineno, "expr": ref,
                                "cm": False,
                                "loose": bool(
                                    self._loop_depth
                                    or self._branch_depth
                                    or self._cleanup_depth
                                ),
                            })
        # collect calls in this statement's own expressions
        for fieldname, value in ast.iter_fields(st):
            if fieldname in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(value, ast.AST):
                self._scan_expr(value)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.AST):
                        self._scan_expr(v)
        for fieldname in ("body", "orelse", "finalbody"):
            block = getattr(st, fieldname, None)
            if block:
                self._walk_block(block)
        for hdl in getattr(st, "handlers", []) or []:
            self._walk_block(hdl.body)

    def _collect_try(self, st: ast.Try) -> None:
        """Typed catches + broad-swallow handlers for the error-taint
        pass. A swallow = a broad handler (bare / Exception /
        BaseException) containing no raise at all — the error converts
        into a normal return value. Handlers nested inside an outer
        except/finally are cleanup during unwinding and exempt."""
        from .rules_async import _is_broad

        for h in st.handlers:
            if h.type is not None:
                for t in (h.type.elts if isinstance(h.type, ast.Tuple)
                          else [h.type]):
                    d = _dotted(t)
                    if d:
                        self.sum["catches"].append(d.split(".")[-1])
            if _is_broad(h) and not _handler_raises(h) \
                    and not _handler_captures(h):
                self.sum["swallows"].append({
                    "line": h.lineno,
                    "cleanup": bool(self._cleanup_depth),
                })

    @staticmethod
    def _nslock_acquire_in(st: ast.stmt) -> tuple[int, str | None] | None:
        """(line, bound handle name) of an ns-lock acquisition in this
        statement, or None. The name feeds the resources pass: releases
        are `mtx.unlock()`-shaped calls on the same local."""
        roots: list[ast.AST] = []
        if isinstance(st, (ast.Expr, ast.Assign)):
            roots.append(st.value)
        elif isinstance(st, ast.If):
            roots.append(st.test)
        for root in roots:
            for n in ast.walk(root):
                if not isinstance(n, ast.Call):
                    continue
                name = _dotted(n.func) or ""
                if name == "_lock_dyn":
                    var = None
                    if n.args and isinstance(n.args[0], ast.Name):
                        var = n.args[0].id
                    return n.lineno, var
                if name.endswith(".lock") or name.endswith(".rlock"):
                    base = name.rsplit(".", 1)[0]
                    if base.split(".")[-1] in ("mtx", "lk", "lock", "mutex"):
                        var = base if "." not in base else None
                        return n.lineno, var
        return None

    # -- broad try/except collection (cancellation-reachable) -------------

    def _collect_broad_trys(self) -> None:
        from .rules_async import _is_broad, _reraises
        from .core import contains_await

        # own-body traversal: nested defs (callbacks, helpers) get their
        # own summaries — a broad except inside one must not be
        # attributed to this function
        trys: list[ast.Try] = []
        stack: list[ast.AST] = [self.fn]
        while stack:
            n = stack.pop()
            if n is not self.fn and isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(n, ast.Try):
                trys.append(n)
            stack.extend(ast.iter_child_nodes(n))
        for node in trys:
            if contains_await(node.body):
                continue  # the per-file `cancellation` rule owns this case
            # an earlier `except CancelledError: raise` clause drains the
            # cancellation before any broad handler can swallow it
            handled = False
            for h in node.handlers:
                names = []
                if h.type is not None:
                    for t in (
                        h.type.elts if isinstance(h.type, ast.Tuple)
                        else [h.type]
                    ):
                        d = _dotted(t)
                        if d:
                            names.append(d.split(".")[-1])
                if "CancelledError" in names and _reraises(h):
                    handled = True
                    break
                if _is_broad(h):
                    break  # a broad clause above the reraise wins
            if handled:
                continue
            for h in node.handlers:
                broad = _is_broad(h)
                if broad and not _reraises(h):
                    calls = []
                    waits = []
                    for n in ast.walk(ast.Module(body=list(node.body),
                                                 type_ignores=[])):
                        if isinstance(n, ast.Call):
                            e = _dotted(n.func)
                            if e:
                                if e.split(".")[-1] in _WAIT_ATTRS and "." in e:
                                    waits.append(e)
                                calls.append(e)
                    self.sum["broad_trys"].append({
                        "line": h.lineno,
                        "calls": sorted(set(calls)),
                        "waits": sorted(set(waits)),
                    })
                    break


def _exit_paths(fn: ast.AST) -> list[dict]:
    """Non-exception exits of a function with the set of call exprs that
    DEFINITELY executed before each (branch-joins intersect; loop bodies
    don't count — they may run zero times). Exception exits are exempt
    from the coherence contract; returns are not."""
    exits: list[dict] = []

    def calls_in(node: ast.AST) -> set[str]:
        out = set()
        for n in ast.walk(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                e = _dotted(n.func)
                if e:
                    out.add(e)
        return out

    def walk(stmts: list[ast.stmt], seen: set[str]) -> tuple[set[str], bool]:
        s = set(seen)
        for st in stmts:
            if isinstance(st, ast.Return):
                tail = None
                names: list[str] = []
                if isinstance(st.value, ast.Call):
                    tail = _dotted(st.value.func)
                if st.value is not None:
                    s |= calls_in(st.value)
                    # local names returned as VALUES are transferred to
                    # the caller — bare (`return mtx`), in a tuple, or
                    # as a call argument (`return Handle(mutex=mtx)`).
                    # A name that only RECEIVES a method call
                    # (`return fh.read()`) is used, not transferred.
                    recv_only: set[int] = set()
                    for n in ast.walk(st.value):
                        if isinstance(n, ast.Attribute):
                            root = n.value
                            while isinstance(root, ast.Attribute):
                                root = root.value
                            if isinstance(root, ast.Name):
                                recv_only.add(id(root))
                    names = sorted({
                        n.id for n in ast.walk(st.value)
                        if isinstance(n, ast.Name)
                        and id(n) not in recv_only
                    })
                exits.append({"line": st.lineno, "kind": "return",
                              "before": sorted(s), "tail": tail,
                              "names": names})
                return s, False
            if isinstance(st, ast.Raise):
                return s, False
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, ast.If):
                s |= calls_in(st.test)
                s1, f1 = walk(st.body, s)
                s2, f2 = walk(st.orelse, s)
                if f1 and f2:
                    s = s1 & s2
                elif f1:
                    s = s1
                elif f2:
                    s = s2
                else:
                    return s, False
                continue
            if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
                walk(st.body, s)      # exits inside count; calls don't
                walk(st.orelse, s)
                if (
                    isinstance(st, ast.While)
                    and isinstance(st.test, ast.Constant)
                    and st.test.value
                    and not _loop_breaks(st)
                ):
                    # `while True:` with no break never falls through —
                    # its returns are the only exits (retry-loop shape)
                    return s, False
                continue
            if isinstance(st, ast.Try):
                mark = len(exits)
                s_body, f_body = walk(st.body, s)
                joins: list[set[str]] = []
                any_falls = False
                if f_body and st.orelse:
                    s_body, f_body = walk(st.orelse, s_body)
                if f_body:
                    joins.append(s_body)
                    any_falls = True
                for h in st.handlers:
                    s_h, f_h = walk(h.body, s)
                    if f_h:
                        joins.append(s_h)
                        any_falls = True
                post = set.intersection(*joins) if joins else s
                if st.finalbody:
                    # a return inside the try/handlers runs the finally
                    # on the way out: its definite calls belong to those
                    # exits too (`try: return write() finally:
                    # cache.invalidate()` is the canonical safe shape).
                    # Probe walk computes them; its own exits are probe
                    # artifacts and dropped.
                    probe = len(exits)
                    fin_calls, _ = walk(st.finalbody, set())
                    del exits[probe:]
                    for ex in exits[mark:]:
                        ex["before"] = sorted(set(ex["before"]) | fin_calls)
                    post, f_fin = walk(st.finalbody, post)
                    if not f_fin:
                        return post, False
                if not any_falls:
                    return post, False
                s = post
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                for it in st.items:
                    s |= calls_in(it.context_expr)
                s, falls = walk(st.body, s)
                if not falls:
                    return s, False
                continue
            s |= calls_in(st)
            if isinstance(st, (ast.Break, ast.Continue)):
                return s, False
        return s, True

    s, falls = walk(fn.body, set())
    if falls:
        end = max(getattr(fn, "end_lineno", fn.lineno) or fn.lineno, fn.lineno)
        exits.append({"line": end, "kind": "fallthrough",
                      "before": sorted(s), "tail": None, "names": []})
    return exits


def _handler_raises(h: ast.ExceptHandler) -> bool:
    """Does the handler body contain any raise of its own (bare re-raise
    or a typed translation)? Either way the error propagates — only a
    raise-free broad handler converts it into a normal return value."""
    from .core import iter_nodes_outside_nested_functions

    return any(
        isinstance(n, ast.Raise)
        for n in iter_nodes_outside_nested_functions(h.body)
    )


# handler calls that feed the bound exception into a data channel the
# caller consumes: the quorum errs list, a future, a queue. Logging
# calls are deliberately NOT here — a logged-and-dropped error is the
# swallow the pass exists to find.
_CAPTURE_METHODS = frozenset({"append", "add", "put", "set_exception"})


def _handler_captures(h: ast.ExceptHandler) -> bool:
    """Does the handler propagate the bound exception as a VALUE — store
    it (`errs[i] = e`), collect it (`errs.append(e)`, the quorum error
    channel), return it (`return None, e`, the per-drive result pair),
    or complete a future with it (`fut.set_exception(e)`)? That is
    typed propagation through a data channel, not a swallow. Merely
    logging it is not."""
    from .core import iter_nodes_outside_nested_functions

    if not h.name:
        return False
    def is_the_exception(value: ast.AST | None) -> bool:
        # the exception is the stored/returned VALUE itself: bare, or a
        # direct element of a tuple/list
        if isinstance(value, ast.Name):
            return value.id == h.name
        if isinstance(value, (ast.Tuple, ast.List)):
            return any(
                isinstance(el, ast.Name) and el.id == h.name
                for el in value.elts
            )
        return False

    def mentions_exception(value: ast.AST | None) -> bool:
        return value is not None and any(
            isinstance(sub, ast.Name) and sub.id == h.name
            for sub in ast.walk(value)
        )

    for n in iter_nodes_outside_nested_functions(h.body):
        if isinstance(n, ast.Assign):
            # stored into a field/container slot, the error (even
            # stringified: `st["error"] = str(e)`) outlives the handler
            # as observable state; a derived LOCAL (`msg = str(e)`
            # before a log call) is still a swallow
            stored = any(
                isinstance(t, (ast.Subscript, ast.Attribute))
                for t in n.targets
            )
            if is_the_exception(n.value) or (
                stored and mentions_exception(n.value)
            ):
                return True
        elif isinstance(n, ast.Return):
            if is_the_exception(n.value):
                return True
        elif isinstance(n, ast.Call):
            fname = _dotted(n.func) or ""
            if fname.split(".")[-1] in _CAPTURE_METHODS and any(
                isinstance(a, ast.Name) and a.id == h.name
                for a in n.args
            ):
                return True
    return False


def _loop_breaks(loop: ast.AST) -> bool:
    """Does `loop` contain a break at its own level (not in a nested
    loop, which the break would target instead)?"""
    stack: list[ast.AST] = list(loop.body)
    while stack:
        n = stack.pop()
        if isinstance(n, ast.Break):
            return True
        if isinstance(n, (ast.For, ast.AsyncFor, ast.While,
                          ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


_LOCK_CTORS = ("threading.Lock", "threading.RLock", "threading.Condition",
               "Lock", "RLock", "Condition")


def extract_summary(tree: ast.AST, relpath: str) -> dict:
    """Reduce one parsed module to its serializable project summary."""
    module = _module_name(relpath)
    # exits everywhere: the resources pass proves per-exit release
    # discipline in every subsystem, not just erasure/
    want_exits = True
    summary: dict = {
        "module": module,
        "relpath": relpath,
        "imports": {},    # alias -> package-relative or external dotted
        "classes": {},    # name -> {bases, methods, own, attr_types}
        "functions": {},  # qualname -> funcsum
        "locks": {},      # attr-or-name -> canonical lock id
        "globals": {},    # module-level var -> class-ref expr (singletons)
        "knob_reads": [],        # exact MINIO_* literals in this file
        "knob_prefix_reads": [], # literal f-string heads / *_ prefixes
    }
    # MINIO_* literals anywhere in the file are knob reads for the
    # dead-knob pass (conservative: a mention is a read). The registry
    # itself is excluded — a declaration must not count as a read
    # (other analysis files DO read knobs: the sanitizer's own switches).
    if relpath != "analysis/knobs.py":
        exact: set[str] = set()
        prefixes: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                if _KNOB_LIT_RE.match(node.value) and node.value != "MINIO_":
                    exact.add(node.value)
                    if node.value.endswith("_"):
                        prefixes.add(node.value)
            elif isinstance(node, ast.JoinedStr) and node.values:
                head = node.values[0]
                if (
                    isinstance(head, ast.Constant)
                    and isinstance(head.value, str)
                    and _KNOB_LIT_RE.match(head.value)
                    and len(node.values) > 1
                ):
                    prefixes.add(head.value)
        summary["knob_reads"] = sorted(exact)
        summary["knob_prefix_reads"] = sorted(prefixes)

    def resolve_import_target(modpath: str, level: int) -> str:
        if level == 0:
            if modpath == "minio_tpu_torch":
                return ""
            if modpath.startswith("minio_tpu_torch."):
                return modpath[len("minio_tpu_torch."):]
            return "ext:" + modpath
        # relative: level=1 is this module's package, 2 is its parent...
        base = module.split(".")
        if relpath.endswith("__init__.py"):
            base = base + ["_"]  # packages: `from . import x` = same pkg
        if level > len(base):
            return "ext:" + modpath
        prefix = base[: len(base) - level]
        return ".".join(prefix + ([modpath] if modpath else [])).strip(".")

    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                summary["imports"][a.asname or a.name.split(".")[0]] = (
                    resolve_import_target(a.name, 0)
                )
        elif isinstance(node, ast.ImportFrom):
            base = resolve_import_target(node.module or "", node.level)
            for a in node.names:
                if a.name == "*":
                    continue
                tgt = f"{base}.{a.name}" if base else a.name
                summary["imports"][a.asname or a.name] = tgt

    def lock_ctor_id(value: ast.AST) -> str | None:
        if not isinstance(value, ast.Call):
            return None
        name = _dotted(value.func) or ""
        if name in _LOCK_CTORS:
            return "@auto"  # canonical id derived from assignment target
        if name.split(".")[-1] == "make_lock" and value.args and isinstance(
            value.args[0], ast.Constant
        ) and isinstance(value.args[0].value, str):
            return value.args[0].value  # witness name IS the canonical id
        return None

    def extract_function(fn, qualprefix: str, cls: str | None):
        qual = f"{qualprefix}{fn.name}"
        summary["functions"][qual] = _FunctionExtractor(
            fn, qual, cls, want_exits
        ).run()
        # nested defs (one level of recursion handles all depths)
        for sub in _direct_nested_defs(fn):
            extract_function(sub, f"{qual}.<locals>.", cls)

    def _direct_nested_defs(fn):
        out = []
        stack = list(fn.body)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(n)
                continue  # don't descend: recursion handles deeper levels
            if isinstance(n, (ast.ClassDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(n))
        return out

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            extract_function(node, "", None)
        elif isinstance(node, ast.ClassDef):
            cls = node.name
            bases = [b for b in (_dotted(x) for x in node.bases) if b]
            methods = []
            own: set[str] = set()        # attrs this class itself assigns
            attr_types: dict[str, str] = {}  # attr -> ctor class-ref expr
            for sub in node.body:
                # __slots__ declarations define attrs too (slotted stat
                # holders assign in __init__, but the slots are the
                # authoritative owner declaration)
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name) \
                        and sub.targets[0].id == "__slots__" \
                        and isinstance(sub.value, (ast.Tuple, ast.List)):
                    for el in sub.value.elts:
                        if isinstance(el, ast.Constant) and isinstance(
                            el.value, str
                        ):
                            own.add(el.value)
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods.append(sub.name)
                    extract_function(sub, f"{cls}.", cls)
                    # self.X = ... in any method: attr ownership, lock
                    # ctors, and instance-attr types for receiver chains
                    for stmt in ast.walk(sub):
                        targets: list[ast.AST] = []
                        value = None
                        if isinstance(stmt, ast.Assign):
                            targets = list(stmt.targets)
                            value = stmt.value
                        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
                            targets = [stmt.target]
                            value = getattr(stmt, "value", None)
                        for t in targets:
                            if not (
                                isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                            ):
                                continue
                            own.add(t.attr)
                            if value is None or len(targets) != 1:
                                continue
                            lid = lock_ctor_id(value)
                            if lid:
                                canon = (
                                    f"{module}.{cls}.{t.attr}"
                                    if lid == "@auto" else lid
                                )
                                summary["locks"][f"{cls}.{t.attr}"] = canon
                            elif isinstance(value, ast.Call):
                                ref = _dotted(value.func)
                                if ref and ref.split(".")[-1][:1].isupper():
                                    attr_types.setdefault(t.attr, ref)
            summary["classes"][cls] = {
                "bases": bases, "methods": methods,
                "own": sorted(own), "attr_types": attr_types,
            }
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name):
                lid = lock_ctor_id(node.value)
                if lid:
                    canon = f"{module}.{t.id}" if lid == "@auto" else lid
                    summary["locks"][t.id] = canon
                elif isinstance(node.value, ast.Call):
                    # module-level singleton: `_DATA = DataCache()` — the
                    # races pass attributes `_DATA.x` accesses through it
                    ref = _dotted(node.value.func)
                    if ref and ref.split(".")[-1][:1].isupper():
                        summary["globals"][t.id] = ref
    return summary


# -- project index + call resolution ---------------------------------------


class ProjectIndex:
    """Symbol table + call-expression resolver over all file summaries."""

    def __init__(self, summaries: dict[str, dict], paths: dict[str, str]):
        # keyed by relpath; paths maps relpath -> reported path
        self.summaries = summaries
        self.paths = paths
        self.modules: dict[str, dict] = {}        # module -> summary
        self.functions: dict[str, dict] = {}      # "mod::qual" -> funcsum
        self.func_file: dict[str, str] = {}       # "mod::qual" -> relpath
        self.classes: dict[str, dict] = {}        # "mod::Cls" -> classinfo
        self.method_defs: dict[str, list[str]] = {}  # name -> [keys]
        self.lock_ids: dict[str, str] = {}        # "mod|Cls.attr" -> canon
        for relpath, s in sorted(summaries.items()):
            mod = s["module"]
            self.modules[mod] = s
            for qual, fs in s["functions"].items():
                key = f"{mod}::{qual}"
                self.functions[key] = fs
                self.func_file[key] = relpath
                base = qual.split(".<locals>.")[-1].split(".")[-1]
                self.method_defs.setdefault(base, []).append(key)
            for cls, ci in s["classes"].items():
                self.classes[f"{mod}::{cls}"] = ci
            for ref, canon in s["locks"].items():
                self.lock_ids[f"{mod}|{ref}"] = canon

    # ---- symbol resolution ----

    def _module_symbol(self, mod: str, name: str) -> str | None:
        """Resolve `name` inside module `mod` to a functions/classes key."""
        s = self.modules.get(mod)
        if s is None:
            return None
        if name in s["functions"]:
            return f"{mod}::{name}"
        if name in s["classes"]:
            return f"class:{mod}::{name}"
        tgt = s["imports"].get(name)
        if tgt is None:
            return None
        if tgt.startswith("ext:"):
            # absolute import that isn't minio_tpu_torch.*: still resolvable
            # when the named module was analyzed in this run (synthetic
            # module pairs in tests, scripts next to the package)
            tail = tgt[4:]
            if tail in self.modules:
                return f"module:{tail}"
            if "." in tail:
                owner, sym = tail.rsplit(".", 1)
                if owner in self.modules:
                    return self._module_symbol(owner, sym)
            return None
        # imported module, or imported symbol from an in-package module
        if tgt in self.modules:
            return f"module:{tgt}"
        if "." in tgt:
            owner, sym = tgt.rsplit(".", 1)
            if owner in self.modules:
                return self._module_symbol(owner, sym)
        return None

    def _class_method(self, clskey: str, name: str,
                      depth: int = 0) -> str | None:
        if depth > 8 or clskey not in self.classes:
            return None
        mod = clskey.split("::")[0]
        cls = clskey.split("::")[1]
        ci = self.classes[clskey]
        if name in ci["methods"]:
            return f"{mod}::{cls}.{name}"
        for b in ci["bases"]:
            bsym = self._module_symbol(mod, b.split(".")[-1]) \
                if "." not in b else self._resolve_dotted_symbol(mod, b)
            if bsym and bsym.startswith("class:"):
                hit = self._class_method(bsym[6:], name, depth + 1)
                if hit:
                    return hit
        return None

    def _resolve_dotted_symbol(self, mod: str, dotted: str) -> str | None:
        parts = dotted.split(".")
        sym = self._module_symbol(mod, parts[0])
        for p in parts[1:]:
            if sym is None:
                return None
            if sym.startswith("module:"):
                sym = self._module_symbol(sym[7:], p)
            elif sym.startswith("class:"):
                m = self._class_method(sym[6:], p)
                return m
            else:
                return None
        return sym

    def resolve_call(self, relpath: str, caller_qual: str,
                     expr: str) -> list[str]:
        """Call expression -> candidate function keys ("mod::qual")."""
        s = self.summaries.get(relpath)
        if s is None:
            return []
        mod = s["module"]
        fs = s["functions"].get(caller_qual)
        parts = expr.split(".")
        # self.method / cls.method
        if parts[0] in ("self", "cls") and fs and fs.get("class"):
            if len(parts) == 2:
                hit = self._class_method(f"{mod}::{fs['class']}", parts[1])
                return [hit] if hit else self._unique_fallback(parts[-1])
            return self._unique_fallback(parts[-1])
        # local variable with inferred class type: v = Cls(...); v.m()
        if fs and len(parts) == 2 and parts[0] in fs.get("locals", {}):
            ctor = fs["locals"][parts[0]]
            sym = self._resolve_dotted_symbol(mod, ctor)
            if sym and sym.startswith("class:"):
                hit = self._class_method(sym[6:], parts[1])
                if hit:
                    return [hit]
            return self._unique_fallback(parts[-1])
        # module-level typed singleton: `_DATA = DataCache()` in this
        # module (or imported from a sibling) — `_DATA.get()` resolves
        # like a typed local
        if len(parts) == 2:
            ctor = s.get("globals", {}).get(parts[0])
            gmod = mod
            if ctor is None:
                tgt = s["imports"].get(parts[0])
                if tgt and not tgt.startswith("ext:") and "." in tgt:
                    owner, sym_name = tgt.rsplit(".", 1)
                    osum = self.modules.get(owner)
                    if osum is not None:
                        ctor = osum.get("globals", {}).get(sym_name)
                        gmod = owner
            if ctor is not None:
                sym = self._resolve_dotted_symbol(gmod, ctor)
                if sym and sym.startswith("class:"):
                    hit = self._class_method(sym[6:], parts[1])
                    if hit:
                        return [hit]
        # nested function in enclosing scope chain
        if len(parts) == 1:
            scope = caller_qual
            while scope:
                cand = f"{scope}.<locals>.{expr}"
                if f"{mod}::{cand}" in self.functions:
                    return [f"{mod}::{cand}"]
                scope = scope.rsplit(".<locals>.", 1)[0] \
                    if ".<locals>." in scope else ""
            sym = self._module_symbol(mod, expr)
            if sym is None:
                return []
            if sym.startswith("class:"):
                init = self._class_method(sym[6:], "__init__")
                return [init] if init else []
            if sym.startswith("module:"):
                return []
            return [sym]
        # dotted: walk alias/module/class chain
        sym = self._resolve_dotted_symbol(mod, expr)
        if sym and not sym.startswith(("module:", "class:")):
            return [sym]
        if sym and sym.startswith("class:"):
            init = self._class_method(sym[6:], "__init__")
            return [init] if init else []
        # a root that is a known EXTERNAL import (asyncio, numpy, aiohttp)
        # must not heuristic-match in-package names: `asyncio.sleep` is
        # not OUR `sleep`
        root_tgt = s["imports"].get(parts[0])
        if root_tgt is not None and root_tgt.startswith("ext:"):
            return []
        return self._unique_fallback(parts[-1])

    # builtin container/file protocol names: a `.clear()` on some dict
    # must never unique-fallback to the one class that happens to define
    # a `clear` method — these names carry no identity
    _COMMON_METHODS = frozenset({
        "clear", "update", "get", "pop", "popitem", "setdefault", "copy",
        "append", "appendleft", "add", "remove", "discard", "extend",
        "insert", "sort", "reverse", "count", "index", "items", "keys",
        "values", "join", "split", "strip", "close", "flush", "start",
        "stop", "put", "send", "set", "wait", "run",
    })

    def _unique_fallback(self, name: str) -> list[str]:
        """`obj.frob()` with receiver type unknown: if exactly one class
        METHOD in the whole program is named `frob`, link to it — unique
        names carry their identity; common names resolve nowhere rather
        than everywhere. Module-level functions are excluded: a call
        through a receiver cannot be one."""
        if name.startswith("__") or name in self._COMMON_METHODS:
            return []
        cands = [
            k for k in self.method_defs.get(name, [])
            if "." in k.split("::", 1)[1] and ".<locals>." not in k
        ]
        return cands if len(cands) == 1 else []

    def canon_lock(self, relpath: str, caller_qual: str, raw: str) -> str:
        """Map a raw lock expression at a use site to its canonical id."""
        s = self.summaries.get(relpath, {})
        mod = s.get("module", "")
        fs = s.get("functions", {}).get(caller_qual, {})
        if raw == "<nslock>":
            return "nslock"
        parts = raw.split(".")
        if parts[0] in ("self", "cls") and fs.get("class"):
            key = f"{mod}|{fs['class']}.{parts[-1]}"
            if key in self.lock_ids:
                return self.lock_ids[key]
            # inherited lock attr: any class defining it
            hits = sorted(
                v for k, v in self.lock_ids.items()
                if k.split("|")[1].split(".")[-1] == parts[-1]
            )
            if len(set(hits)) == 1:
                return hits[0]
            return f"{mod}.{fs['class']}.{parts[-1]}"
        if len(parts) == 1:
            key = f"{mod}|{raw}"
            if key in self.lock_ids:
                return self.lock_ids[key]
            tgt = s.get("imports", {}).get(raw)
            if tgt and not tgt.startswith("ext:") and "." in tgt:
                owner, sym = tgt.rsplit(".", 1)
                okey = f"{owner}|{sym}"
                if okey in self.lock_ids:
                    return self.lock_ids[okey]
            return f"{mod}.{raw}"
        if len(parts) == 2:
            # module-attr lock through an import: `sibling.a_lock`
            tgt = s.get("imports", {}).get(parts[0])
            if tgt:
                owner = tgt[4:] if tgt.startswith("ext:") else tgt
                if owner in self.modules:
                    okey = f"{owner}|{parts[1]}"
                    if okey in self.lock_ids:
                        return self.lock_ids[okey]
        return f"{mod}.{raw}"


# -- the driver -------------------------------------------------------------


@dataclass
class ProjectResult:
    findings: list[Finding]
    lock_order: list[str] = field(default_factory=list)
    lock_edges: dict[str, list[str]] = field(default_factory=dict)
    guard_table: list[dict] = field(default_factory=list)
    resource_table: list[dict] = field(default_factory=list)
    surface: dict = field(default_factory=dict)
    stats: dict = field(default_factory=dict)


def _sha1(data: bytes) -> str:
    return hashlib.sha1(data).hexdigest()


def _engine_digest() -> str:
    """Hash of the analysis package sources: any rule/engine change
    invalidates the whole cache."""
    here = os.path.dirname(__file__)
    h = hashlib.sha1(ENGINE_VERSION.encode())
    for name in sorted(os.listdir(here)):
        # .json covers vendored rule data (reference_surface.json):
        # editing the parity pins must bust the interproc cache too
        if name.endswith((".py", ".json")):
            with open(os.path.join(here, name), "rb") as fh:
                h.update(_sha1(fh.read()).encode())
    return h.hexdigest()


def _analyze_one(args: tuple[str, str, str]) -> dict:
    """Worker: full per-file analysis + summary extraction. Returns a
    JSON-serializable record (also the cache entry format). The stored
    sha is computed from the bytes actually analyzed — NOT the parent's
    scheduling sha — so a file edited mid-run cannot poison the cache
    with old-hash/new-findings entries."""
    path, relpath, _sched_sha = args
    with open(path, "rb") as fh:
        raw = fh.read()
    source = raw.decode("utf-8")
    ctx = FileContext(path=path, relpath=relpath, source=source)
    rec: dict = {
        "sha": _sha1(raw),
        "path": path,
        "findings": [],
        "used_pragmas": [],
        "pragmas": {str(k): sorted(v) for k, v in ctx.pragmas.items()},
        "targets": {str(k): v for k, v in ctx._targets.items()},
        "summary": None,
    }
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        rec["findings"] = [
            [relpath, e.lineno or 1, "parse", f"syntax error: {e.msg}"]
        ]
        return rec
    findings, used = analyze_tree(tree, ctx, None)
    rec["findings"] = [[relpath, f.line, f.rule, f.message] for f in findings]
    rec["used_pragmas"] = sorted(used)
    rec["summary"] = extract_summary(tree, relpath)
    return rec


class _PragmaView:
    """Pragma lookups over cached records (no re-tokenize)."""

    def __init__(self, rec: dict):
        self.pragmas = {int(k): set(v) for k, v in rec["pragmas"].items()}
        self.targets = {int(k): v for k, v in rec["targets"].items()}

    def suppressed(self, line: int, rule_id: str) -> int | None:
        for pline in self.targets.get(line, ()):
            tags = self.pragmas.get(pline, set())
            if rule_id in tags or "*" in tags:
                return pline
        return None


def default_cache_path() -> str:
    # inside the package, so it never meets the reference package's
    # cache at the repository root (each busts the other's entries)
    pkg = os.path.dirname(os.path.dirname(__file__))
    return os.path.join(pkg, ".miniovet-cache.json")


def analyze_project(
    paths,
    rules=None,
    jobs: int = 1,
    cache_path: str | None = None,
) -> ProjectResult:
    """Run everything: per-file rules, native scans, interprocedural
    passes, pragma accounting. `cache_path` enables the incremental
    cache (miss -> parse + analyze + store; hit -> reuse findings and
    summary)."""
    from . import rules_native
    from . import interproc

    t0 = time.perf_counter()
    wanted = set(rules) if rules is not None else None
    if wanted is not None:
        from .core import ALL_RULES

        unknown = wanted - set(ALL_RULES) - set(INTERPROC_PASSES) \
            - {"pragma", rules_native.RULE_ID}
        if unknown:
            # same invariant analyze_tree enforces: a typo'd rule id
            # must not come back as a clean result
            raise KeyError(
                f"unknown rule id(s): {', '.join(sorted(unknown))}"
            )
    py_files: list[tuple[str, str]] = []   # (path, relpath)
    native_files: list[str] = []
    findings: list[Finding] = []
    for path in iter_python_files(paths):
        if path.endswith(rules_native.NATIVE_EXTS):
            native_files.append(path)
            if wanted is None or rules_native.RULE_ID in wanted:
                findings.extend(rules_native.scan_native_file(path))
        else:
            py_files.append((path, _package_relpath(path)))
    # getenv evidence from native sources for the dead-knob pass (the
    # native plane reads knobs the Python AST walk can't see)
    native_knob_reads: set[str] = set()
    for path in sorted(native_files):
        native_knob_reads |= rules_native.native_knob_reads(path)

    cache: dict = {}
    cache_dirty = False
    ip_stored: dict | None = None
    engine = _engine_digest() if cache_path else ""
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path, "r", encoding="utf-8") as fh:
                on_disk = json.load(fh)
            if on_disk.get("engine") == engine:
                cache = on_disk.get("files", {})
                ip_stored = on_disk.get("interproc")
        except (OSError, ValueError):
            cache = {}
            ip_stored = None

    todo: list[tuple[str, str, str]] = []
    records: dict[str, dict] = {}   # relpath -> record
    relpath_to_path: dict[str, str] = {}
    for i, (path, relpath) in enumerate(py_files):
        if relpath_to_path.get(relpath, path) != path:
            # two out-of-package files sharing a basename (a/util.py,
            # b/util.py): basename keys would silently drop one file's
            # findings — fall back to the full path as the key
            relpath = path.lstrip("./").replace(os.sep, "/")
            py_files[i] = (path, relpath)
        relpath_to_path[relpath] = path
        if not cache_path:
            # no cache: the scheduling sha is never compared, don't pay
            # a second full read of every file just to compute it
            todo.append((path, relpath, ""))
            continue
        with open(path, "rb") as fh:
            sha = _sha1(fh.read())
        hit = cache.get(relpath)
        if hit is not None and hit.get("sha") == sha:
            records[relpath] = hit
        else:
            todo.append((path, relpath, sha))

    parsed = len(todo)
    if todo:
        if jobs > 1 and len(todo) > 4:
            from concurrent.futures import ProcessPoolExecutor

            with ProcessPoolExecutor(max_workers=jobs) as pool:
                for args, rec in zip(todo, pool.map(_analyze_one, todo)):
                    records[args[1]] = rec
        else:
            for args in todo:
                records[args[1]] = _analyze_one(args)
        cache_dirty = True

    # per-file findings (rule-filtered when --select is active)
    used_by_file: dict[str, set[int]] = {}
    for relpath, rec in records.items():
        used_by_file[relpath] = set(rec.get("used_pragmas", ()))
        for f in rec["findings"]:
            if wanted is None or f[2] in wanted or f[2] == "parse":
                findings.append(
                    Finding(relpath_to_path[relpath], f[1], f[2], f[3])
                )

    # interprocedural passes over the summaries. Their facts are
    # whole-program by nature (a guarded-by table, a lock graph), so the
    # cached result is keyed on the digest of EVERY contributing file's
    # content sha: one edited file anywhere recomputes everything —
    # per-file keying would serve stale cross-module facts.
    t1 = time.perf_counter()
    summaries = {
        rp: rec["summary"] for rp, rec in records.items()
        if rec.get("summary") is not None
    }
    index = ProjectIndex(summaries, relpath_to_path)
    pragma_views = {rp: _PragmaView(rec) for rp, rec in records.items()}

    ip_key = ""
    if cache_path:
        h = hashlib.sha1(engine.encode())
        for rp in sorted(records):
            h.update(rp.encode())
            h.update(str(records[rp].get("sha", "")).encode())
        # native sources feed the dead-knob pass: an edited .cpp must
        # bust the cached interproc result too
        for path in sorted(native_files):
            try:
                with open(path, "rb") as fh:
                    h.update(path.encode())
                    h.update(_sha1(fh.read()).encode())
            except OSError:
                pass
        ip_key = h.hexdigest()

    ip_used: dict[str, set[int]] = {}   # pragma lines interproc consumed
    ip_record: dict | None = None

    def _suppressed(relpath: str, line: int, tag: str) -> bool:
        view = pragma_views.get(relpath)
        if view is None:
            return False
        pline = view.suppressed(line, tag)
        if pline is not None:
            used_by_file.setdefault(relpath, set()).add(pline)
            ip_used.setdefault(relpath, set()).add(pline)
            return True
        return False

    interproc_cached = (
        wanted is None
        and ip_stored is not None
        and ip_stored.get("key") == ip_key
    )
    if interproc_cached:
        # warm replay: same engine + same full summary-digest set means
        # identical pass output (pragmas live in the hashed sources too)
        ip = interproc.IPResult(
            lock_order=list(ip_stored.get("lock_order", ())),
            lock_edges={
                k: list(v)
                for k, v in ip_stored.get("lock_edges", {}).items()
            },
            guard_table=list(ip_stored.get("guard_table", ())),
            resource_table=list(ip_stored.get("resource_table", ())),
            surface=dict(ip_stored.get("surface", {})),
        )
        for rp, lines in ip_stored.get("used", {}).items():
            used_by_file.setdefault(rp, set()).update(lines)
        for f in ip_stored.get("findings", ()):
            findings.append(
                Finding(relpath_to_path.get(f[0], f[0]), f[1], f[2], f[3])
            )
    else:
        ip = interproc.run_passes(
            index,
            passes=[p for p in INTERPROC_PASSES
                    if wanted is None or p in wanted],
            suppressed=_suppressed,
            native_knob_reads=native_knob_reads,
        )
        ip_findings: list[list] = []
        for f in ip.findings:
            view = pragma_views.get(f.file)
            pline = view.suppressed(f.line, f.rule) if view else None
            if pline is not None:
                used_by_file.setdefault(f.file, set()).add(pline)
                ip_used.setdefault(f.file, set()).add(pline)
            else:
                ip_findings.append([f.file, f.line, f.rule, f.message])
                findings.append(
                    Finding(
                        relpath_to_path.get(f.file, f.file),
                        f.line, f.rule, f.message,
                    )
                )
        if cache_path and wanted is None:
            ip_record = {
                "key": ip_key,
                "findings": ip_findings,
                "used": {rp: sorted(v) for rp, v in ip_used.items()},
                "lock_order": ip.lock_order,
                "lock_edges": ip.lock_edges,
                "guard_table": ip.guard_table,
                "resource_table": ip.resource_table,
                "surface": ip.surface,
            }
            cache_dirty = True

    # unused pragmas: only decidable on full runs
    if wanted is None:
        for relpath, rec in records.items():
            pragmas = {int(k): set(v) for k, v in rec["pragmas"].items()}
            findings.extend(
                unused_pragma_findings(
                    relpath_to_path[relpath], pragmas,
                    used_by_file.get(relpath, set()),
                )
            )

    if cache_path and cache_dirty:
        # merge into the on-disk view: a subset run (one directory, one
        # file) must not clobber entries for files it didn't visit —
        # but entries whose source is gone (deleted/renamed) are pruned
        # so the cache doesn't grow monotonically
        cache.update(records)
        pkg = os.path.dirname(os.path.dirname(__file__))
        cache = {
            k: v for k, v in cache.items()
            if k in records
            or os.path.exists(v.get("path", os.path.join(pkg, k)))
        }
        out = {"engine": engine, "files": cache}
        # a fresh interproc record replaces the stored one; a run that
        # didn't recompute it (--select subset) preserves what's there —
        # the digest key protects correctness either way
        stored = ip_record if ip_record is not None else ip_stored
        if stored is not None:
            out["interproc"] = stored
        tmp = cache_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(out, fh, separators=(",", ":"))
            os.replace(tmp, cache_path)
        except OSError:
            pass

    t2 = time.perf_counter()
    return ProjectResult(
        findings=sorted(findings),
        lock_order=ip.lock_order,
        lock_edges=ip.lock_edges,
        guard_table=ip.guard_table,
        resource_table=ip.resource_table,
        surface=ip.surface,
        stats={
            "files": len(py_files),
            "parsed": parsed,
            "cached": len(py_files) - parsed,
            "interproc_cached": interproc_cached,
            "perfile_s": t1 - t0,
            "interproc_s": t2 - t1,
            "total_s": t2 - t0,
        },
    )
