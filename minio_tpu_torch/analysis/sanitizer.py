"""Runtime sanitizer — the dynamic half of the miniovet gate.

``MINIO_TPU_SANITIZE=1`` (``server.main()`` installs it at startup;
tests install and uninstall it in fixtures) installs three witnesses that check at runtime what the static passes
prove at analysis time:

- **lock-order witness** — ``threading.Lock/RLock/Condition`` objects
  created inside the package are wrapped so every acquisition is checked
  against the canonical ordering the static ``lock-order`` pass emitted
  into ``minio_tpu_torch/docs/LOCK_ORDER.md``. Acquiring B while holding A is a
  violation iff the static graph shows a path B ⇝ A — that runtime edge
  closes a cycle the static pass proved absent, i.e. a latent deadlock
  the analysis missed (through a callback, a C extension, reflection).
- **event-loop stall watchdog** — a monotonic tick rides the loop; a
  daemon thread that sees the tick age past
  ``MINIO_TPU_SANITIZE_STALL_S`` captures the loop thread's stack. The
  static ``blocking-reachable`` pass proves no *known* blocking
  primitive is reachable; the watchdog catches the ones it cannot name
  (native calls, pathological algorithms).
- **env-mutation tracking** — snapshot/diff/restore helpers for
  ``MINIO_*`` / ``MINIO_TPU_*`` process env; a test harness uses them
  to scope each test module's env mutations to that module and fail
  modules that leak (``MINIO_COMPRESSION_ENABLE`` set at one module's
  import once changed every later module's transforms).

Every violation is appended to an in-process ring (``events()``) and
published as an ``obs`` record with ``type="sanitizer"`` so ``mc admin
trace``-style subscribers see sanitizer hits inline with the request
flow. Witnesses only ever *report* — they never raise into application
code; enforcement lives in the test harness.

Import-light like the rest of the analysis package: stdlib + obs (also
stdlib-only).
"""

from __future__ import annotations

import linecache
import os
import re
import sys
import threading
import time
import traceback
import weakref
from collections import deque

_TRUTHY = ("1", "on", "true", "yes")


def _raw_factory(factory):
    """The allocator under any witness's wrapping factory: another
    sanitizer in the process (the reference package's, in a test run)
    may have replaced ``threading.Lock`` before this module loaded."""
    while hasattr(factory, "__wrapped__"):
        factory = factory.__wrapped__
    return factory


_installed = False
_real_lock = _raw_factory(threading.Lock)
_real_rlock = _raw_factory(threading.RLock)
# the factories install() replaced, which uninstall() puts back
_prev_lock = threading.Lock
_prev_rlock = threading.RLock

# module ring of sanitizer events; tests and admin surfaces read it
_EVENTS: deque = deque(maxlen=256)
_events_mu = _real_lock()
# persistent per-name violation counters (the ring is bounded; metrics
# need monotonic series that survive ring turnover)
_COUNTS: dict = {}

# canonical lock id -> rank, and direct edge map, from the static pass
_ranks: dict[str, int] = {}
_reach: dict[str, frozenset] = {}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a file of the package, and not of a sibling whose name merely starts
# with the package's (minio_tpu_torch_x/)
_PKG_PREFIX = _PKG_DIR + os.sep

_ASSIGN_RE = re.compile(r"(?:self|cls)?\.?([A-Za-z_][A-Za-z0-9_]*)\s*=")


def enabled() -> bool:
    return os.environ.get("MINIO_TPU_SANITIZE", "0").lower() in _TRUTHY


def stall_threshold_s() -> float:
    raw = os.environ.get("MINIO_TPU_SANITIZE_STALL_S", "0.5")
    try:
        v = float(raw)
    except ValueError:
        return 0.5
    return v if v > 0 else 0.5


def events(name: str | None = None) -> list[dict]:
    with _events_mu:
        recs = list(_EVENTS)
    return [r for r in recs if name is None or r["name"] == name]


def clear_events() -> None:
    with _events_mu:
        _EVENTS.clear()


def _report(name: str, **fields) -> None:
    rec = {"time": time.time(), "type": "sanitizer", "name": name}
    rec.update(fields)
    with _events_mu:
        _EVENTS.append(rec)
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
    try:
        from minio_tpu_torch import obs

        obs.publish(dict(rec))
    except Exception:
        pass  # reporting must never take the process down




# -- lock-order witness -----------------------------------------------------


def load_static_order(path: str | None = None) -> bool:
    """Parse minio_tpu_torch/docs/LOCK_ORDER.md (the table the static pass generated)
    into the rank/reachability maps the witness checks against. Returns
    False (witness stays dormant) when the doc is absent."""
    if path is None:
        path = os.path.join(_PKG_DIR, "docs", "LOCK_ORDER.md")
    try:
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return False
    order: list[str] = []
    edges: dict[str, list[str]] = {}
    for line in text.splitlines():
        m = re.match(r"\|\s*\d+\s*\|\s*`([^`]+)`\s*\|(.*)\|", line)
        if not m:
            continue
        lk = m.group(1)
        order.append(lk)
        edges[lk] = re.findall(r"`([^`]+)`", m.group(2))
    configure_order(order, edges)
    return bool(order)


def configure_order(order: list[str], edges: dict[str, list[str]]) -> None:
    """Install a canonical ordering directly (tests use this to drive
    the witness with a synthetic graph)."""
    global _ranks, _reach
    _ranks = {lk: i for i, lk in enumerate(order)}
    # transitive closure: _reach[a] = every lock reachable from a
    reach: dict[str, set] = {}

    def dfs(a: str) -> set:
        if a in reach:
            return reach[a]
        reach[a] = set()  # cycle guard (static graph is acyclic anyway)
        out: set = set()
        for b in edges.get(a, ()):
            out.add(b)
            out |= dfs(b)
        reach[a] = out
        return out

    for a in list(edges):
        dfs(a)
    _reach = {a: frozenset(s) for a, s in reach.items()}


class _HeldState(threading.local):
    def __init__(self) -> None:
        # acquisition cells, acquisition order: each is [canonical_id]
        # while the acquisition is live, emptied when released. Cells —
        # not bare ids — because threading.Lock may legally be released
        # by a DIFFERENT thread (completion-signal pattern): the releaser
        # kills the cell, the acquiring thread's stack purges it lazily.
        self.stack: list[list] = []
        self.reporting = False       # re-entrancy guard

_held = _HeldState()


def _check_acquire(lock_id: str) -> None:
    st = _held
    if st.reporting or not _ranks:
        return
    if st.stack and not all(st.stack):
        st.stack[:] = [c for c in st.stack if c]  # purge dead cells
    if lock_id in _ranks:
        for cell in st.stack:
            if not cell:
                continue  # killed by a cross-thread release mid-scan
            held_id = cell[0]
            if held_id == lock_id:
                continue  # same class: per-instance, rank-equal
            # runtime edge held -> lock_id closes a cycle iff the static
            # graph already demands lock_id ⇝ held
            if held_id in _reach.get(lock_id, ()):
                st.reporting = True
                try:
                    _report(
                        "lock.order",
                        lock=lock_id,
                        held=held_id,
                        thread=threading.current_thread().name,
                        stack="".join(traceback.format_stack(limit=12)),
                    )
                finally:
                    st.reporting = False


class SanitizedLock:
    """Witness wrapper around a real ``threading`` lock. Quacks like the
    wrapped lock (acquire/release/locked/context manager) and keeps a
    per-thread acquisition stack for the order check."""

    __slots__ = ("_inner", "lock_id", "_cells")

    def __init__(self, inner, lock_id: str):
        self._inner = inner
        self.lock_id = lock_id
        self._cells: list[list] = []  # live acquisitions, any thread

    def acquire(self, *a, **kw):
        _check_acquire(self.lock_id)
        got = self._inner.acquire(*a, **kw)
        if got:
            cell = [self.lock_id]
            _held.stack.append(cell)
            self._cells.append(cell)
        return got

    def release(self):
        # kill the most recent live acquisition of THIS instance — even
        # when the releaser is not the acquirer (legal for Lock); the
        # acquiring thread's stack drops the dead cell lazily
        if self._cells:
            try:
                self._cells.pop().clear()
            except IndexError:
                pass  # racing releasers; inner.release() will raise
        st = _held.stack
        if st and not all(st):
            st[:] = [c for c in st if c]
        return self._inner.release()

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # threading._after_fork reinitializes every lock in the child;
        # Event/Condition delegate here — missing it breaks forked
        # children (multiprocessing, our own --jobs worker pool)
        self._cells.clear()
        return self._inner._at_fork_reinit()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def __repr__(self):
        return f"<SanitizedLock {self.lock_id} {self._inner!r}>"


class SanitizedRLock(SanitizedLock):
    """RLock wrapper exposing the reentrant-lock protocol
    ``threading.Condition`` probes for (``_release_save`` etc.) —
    without it Condition falls back to the non-reentrant path and
    ``wait()`` misjudges ownership."""

    __slots__ = ()

    def _release_save(self):
        # full release of a possibly-reentrant hold: kill every live
        # cell (an RLock is single-owner, so they are all this thread's)
        # and remember the count so _acquire_restore rebuilds it exactly
        count = len(self._cells)
        for c in self._cells:
            c.clear()
        self._cells.clear()
        st = _held.stack
        st[:] = [c for c in st if c]
        return (self._inner._release_save(), count)

    def _acquire_restore(self, state):
        inner_state, count = state
        _check_acquire(self.lock_id)
        r = self._inner._acquire_restore(inner_state)
        for _ in range(max(count, 1)):
            cell = [self.lock_id]
            _held.stack.append(cell)
            self._cells.append(cell)
        return r

    def _is_owned(self):
        return self._inner._is_owned()


def _creation_id() -> str | None:
    """Canonical id for a lock being constructed NOW, derived from the
    creating frame: package module + enclosing class + the assignment
    target on the source line — the same shape the static pass canonises
    (``cache.core.SetCache._mu``). None for locks created outside the
    package (leave those untouched)."""
    f = sys._getframe(2)
    while f is not None:
        fname = f.f_code.co_filename
        if fname.startswith(_PKG_PREFIX) and not fname.endswith("sanitizer.py"):
            break
        # threading.py frames (Condition() allocating its RLock) keep
        # walking out to the package-level caller
        if "threading" not in fname and "sanitizer" not in fname:
            return None
        f = f.f_back
    if f is None:
        return None
    rel = os.path.relpath(f.f_code.co_filename, _PKG_DIR)
    mod = rel[:-3].replace(os.sep, ".")
    if mod.endswith("__init__"):
        mod = mod[: -len(".__init__")] if "." in mod else ""
    line = linecache.getline(f.f_code.co_filename, f.f_lineno)
    m = _ASSIGN_RE.match(line.strip())
    attr = m.group(1) if m else f"line{f.f_lineno}"
    slf = f.f_locals.get("self")
    if slf is not None and f.f_code.co_name != "<module>":
        # the static pass canonises by DEFINING class, so find the mro
        # class whose method owns this code object — `SetCache.__init__`
        # running for a TieredSetCache(SetCache) instance must still tag
        # `cache.core.SetCache._mu` or the witness silently skips it
        cls = type(slf).__name__
        for k in type(slf).__mro__:
            fn = vars(k).get(f.f_code.co_name)
            if getattr(fn, "__code__", None) is f.f_code:
                cls = k.__name__
                break
        return f"{mod}.{cls}.{attr}"
    return f"{mod}.{attr}"


def _wrapping_factory(real, cls, other):
    """Factory wrapping the package's locks around ``real``; a lock
    created outside the package comes from ``other``, the factory this
    one replaced (so another sanitizer's witness keeps its own locks)."""
    def make(*a, **kw):
        try:
            lock_id = _creation_id()
        except Exception:
            lock_id = None
        if lock_id is None:
            return other(*a, **kw)
        return cls(real(*a, **kw), lock_id)

    # threading.Condition(lock=None) does `lock = RLock()` — keep the
    # original reachable for anything that needs the raw factory
    make.__wrapped__ = real
    return make


def install() -> bool:
    """Idempotently install the lock witness (wrap lock creation inside
    the package) and load the static ordering. Locks created before
    install are not witnessed — call early (conftest import, server
    main). Returns whether the witness is actively checking."""
    global _installed, _prev_lock, _prev_rlock
    if not _installed:
        _prev_lock, _prev_rlock = threading.Lock, threading.RLock
        threading.Lock = _wrapping_factory(_real_lock, SanitizedLock, _prev_lock)
        threading.RLock = _wrapping_factory(_real_rlock, SanitizedRLock, _prev_rlock)
        _installed = True
    if not _ranks:
        load_static_order()
    return bool(_ranks)


def uninstall() -> None:
    """Put back the factories install() found."""
    global _installed
    if _installed:
        threading.Lock = _prev_lock
        threading.RLock = _prev_rlock
    _installed = False


# -- attribute access witness ----------------------------------------------
#
# The dynamic half of the static `races` pass: the attributes the pass
# proved reachable from more than one execution context
# (minio_tpu_torch/docs/CONCURRENCY.md) are wrapped in a data descriptor that records,
# per touch, the accessing thread and the set of witnessed locks it
# holds (the lock witness's per-thread stack). Eraser-style lockset
# refinement, coarse (per class attribute, not per instance) and
# report-only:
#
# - while only one thread has ever touched the attribute, nothing is
#   checked (exclusive phase — matches the static pass's
#   init-before-spawn reasoning; `__init__` frames are skipped too);
# - once a second thread appears, the candidate lockset is the running
#   intersection of every touch's held locks; a WRITE in the shared
#   phase with the intersection empty is a live lockset violation
#   (`attr.race`);
# - when the static table declared a guard, a shared-phase write that
#   does not hold that specific lock reports `attr.race` with
#   kind="guard-miss" — the runtime disagreeing with the inferred
#   guard is exactly the cross-validation signal the static pass
#   cannot produce alone.

_WATCHED: dict = {}   # "module.Class.attr" -> _WitnessedAttr


def load_concurrency_table(path: str | None = None) -> dict[str, str]:
    """Parse minio_tpu_torch/docs/CONCURRENCY.md into {witness attr id: declared guard}
    (empty string = no guard inferred). Returns {} when absent."""
    if path is None:
        path = os.path.join(_PKG_DIR, "docs", "CONCURRENCY.md")
    try:
        with open(path, "r", encoding="utf-8") as fh:
            text = fh.read()
    except OSError:
        return {}
    out: dict[str, str] = {}
    for line in text.splitlines():
        if not line.startswith("|"):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        # | attr | witness | contexts | guard | r/w | status |
        if len(cells) != 6 or not cells[1].startswith("`"):
            continue
        witness = cells[1].strip("`")
        guard = cells[3].strip("`_()")
        if guard == "none":
            guard = ""
        if witness not in out:
            out[witness] = guard
        elif out[witness] != guard:
            # several access paths share this leaf but disagree on the
            # guard (two holders of one value class, each with its own
            # lock): no single lock is THE guard, so the witness falls
            # back to pure lockset refinement — a declared-guard check
            # here would report false guard-misses
            out[witness] = ""
    return out


class _WitnessedAttr:
    """Data descriptor wrapping one class attribute with the access
    witness. Plain-dict classes store the value under the same key in
    the instance ``__dict__`` (data descriptors shadow it, so reads and
    writes still flow through here and ``vars(obj)`` stays unchanged);
    slotted classes delegate to the original slot descriptor."""

    def __init__(self, name: str, attr_id: str, guard: str, base=None):
        self.name = name
        self.attr_id = attr_id
        self.guard = guard
        self.base = base  # original slot/member descriptor, if any
        self._mu = _real_lock()
        self._first_tid: int | None = None
        self._shared = False
        self._lockset: frozenset | None = None
        self._shared_write = False
        self._reported = False

    # -- storage -----------------------------------------------------------

    def _load(self, obj):
        if self.base is not None:
            return self.base.__get__(obj, type(obj))
        try:
            return obj.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None

    def _store(self, obj, value):
        if self.base is not None:
            self.base.__set__(obj, value)
        else:
            obj.__dict__[self.name] = value

    # -- witness -----------------------------------------------------------

    def _touch(self, rw: str) -> None:
        st = _held
        if st.reporting:
            return
        # constructor writes are ownership transfer, not sharing — the
        # same init-before-spawn reasoning the static pass applies
        if rw == "w":
            f = sys._getframe(2)
            if f is not None and f.f_code.co_name in (
                "__init__", "__new__", "__post_init__",
            ):
                return
        held = frozenset(c[0] for c in st.stack if c)
        tid = threading.get_ident()
        report = None
        with self._mu:
            if self._first_tid is None:
                self._first_tid = tid
            if tid != self._first_tid:
                self._shared = True
            if self._shared:
                if self._lockset is None:
                    self._lockset = held
                else:
                    self._lockset = self._lockset & held
                if rw == "w":
                    self._shared_write = True
                    if self.guard and self.guard not in held \
                            and not self._reported:
                        self._reported = True
                        report = ("guard-miss", held)
                if (
                    report is None
                    and self._shared_write
                    and not self._lockset
                    and not self._reported
                ):
                    self._reported = True
                    report = ("lockset-empty", held)
        if report is not None:
            kind, held_now = report
            st.reporting = True
            try:
                _report(
                    "attr.race",
                    attr=self.attr_id,
                    kind=kind,
                    rw=rw,
                    guard=self.guard,
                    held=sorted(held_now),
                    thread=threading.current_thread().name,
                    stack="".join(traceback.format_stack(limit=10)),
                )
            finally:
                st.reporting = False

    # -- descriptor protocol ------------------------------------------------

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._touch("r")
        return self._load(obj)

    def __set__(self, obj, value):
        self._touch("w")
        self._store(obj, value)

    def __delete__(self, obj):
        self._touch("w")
        if self.base is not None:
            self.base.__delete__(obj)
        else:
            obj.__dict__.pop(self.name, None)

    def __repr__(self):
        return f"<_WitnessedAttr {self.attr_id}>"


def attrs_enabled() -> bool:
    raw = os.environ.get("MINIO_TPU_SANITIZE_ATTRS", "1").lower()
    return raw in _TRUTHY


def watch_class_attr(cls, name: str, attr_id: str, guard: str = "") -> bool:
    """Install the witness descriptor for one class attribute. Slotted
    classes wrap the member descriptor; dict-backed classes shadow the
    instance dict key. Idempotent."""
    current = cls.__dict__.get(name)
    if isinstance(current, _WitnessedAttr):
        return True
    base = None
    if current is not None:
        if hasattr(current, "__get__") and hasattr(current, "__set__"):
            base = current  # slot/member descriptor
        else:
            return False  # class-level constant/method: not instance state
    try:
        setattr(cls, name, _WitnessedAttr(name, attr_id, guard, base=base))
    except (AttributeError, TypeError):
        return False
    _WATCHED[attr_id] = (cls, name, cls.__dict__[name])
    return True


def arm_access_witness(table: dict[str, str] | None = None) -> int:
    """Instrument every already-imported class the concurrency table
    names. Call AFTER the serving modules are imported (server startup,
    test setup) — classes imported later can be armed by calling again.
    Returns how many attributes are actively witnessed."""
    if not attrs_enabled():
        return 0
    if table is None:
        table = load_concurrency_table()
    armed = 0
    for attr_id, guard in sorted(table.items()):
        if attr_id in _WATCHED:
            armed += 1
            continue
        parts = attr_id.split(".")
        if len(parts) < 3:
            continue
        mod_name = "minio_tpu_torch." + ".".join(parts[:-2])
        cls_name, attr = parts[-2], parts[-1]
        mod = sys.modules.get(mod_name)
        if mod is None:
            continue
        cls = getattr(mod, cls_name, None)
        if not isinstance(cls, type):
            continue
        try:
            if watch_class_attr(cls, attr, attr_id, guard):
                armed += 1
        except Exception:
            continue  # witness must never break imports/serving
    return armed


def witnessed_attrs() -> list[str]:
    return sorted(_WATCHED)


def disarm_access_witness() -> None:
    """Remove every installed witness descriptor (tests)."""
    for attr_id, (cls, name, desc) in list(_WATCHED.items()):
        if cls.__dict__.get(name) is desc:
            if desc.base is not None:
                setattr(cls, name, desc.base)
            else:
                try:
                    delattr(cls, name)
                except AttributeError:
                    pass
        _WATCHED.pop(attr_id, None)


def status() -> dict:
    """Aggregate sanitizer state for the admin ``sanitizer/status``
    endpoint and the metrics-v3 ``/api/sanitizer`` group."""
    with _events_mu:
        recent = list(_EVENTS)[-32:]
        counts = dict(_COUNTS)
    return {
        "enabled": enabled(),
        "lockWitnessInstalled": _installed,
        "staticLockRanks": len(_ranks),
        "witnessedAttrs": witnessed_attrs(),
        "leakClasses": leak_classes(),
        "violations": counts,
        "stallEpisodes": sum(w.stalls for w in _watchdogs),
        "recent": [
            {k: v for k, v in r.items() if k != "stack"} for r in recent
        ],
    }


# -- resource leak witness --------------------------------------------------
#
# The dynamic half of the static `resources` pass: the ownership table
# (minio_tpu_torch/docs/RESOURCES.md) proves every acquisition releases/transfers on
# every static exit; the leak witness cross-validates at runtime through
# the one channel static analysis cannot see — garbage collection.
# Acquisition wrappers register a weakref finalizer carrying the
# acquisition stack; release methods mark the token released. A resource
# collected with its token still live was dropped without release (a
# leaked ns-lock handle, an unclosed spool) and reports one
# ``resource.leak`` obs record with kind + acquisition stack.
# Report-only, like every witness; interpreter shutdown is not a leak
# (finalizers are detached from atexit).

_LEAK_TRACKED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_LEAK_CLASSES: dict = {}  # "module.Class" -> (kind, saved originals)


class _LeakToken:
    __slots__ = ("kind", "stack", "released")

    def __init__(self, kind: str, stack: str):
        self.kind = kind
        self.stack = stack
        self.released = False


def leaks_enabled() -> bool:
    raw = os.environ.get("MINIO_TPU_SANITIZE_LEAKS", "1").lower()
    return raw in _TRUTHY


def _finalize_leak(token: _LeakToken) -> None:
    if not token.released:
        _report("resource.leak", kind=token.kind, stack=token.stack)


def track_resource(obj, kind: str) -> None:
    """Register `obj` with the leak witness: if it is garbage-collected
    before ``mark_released(obj)``, a ``resource.leak`` record carrying
    the acquisition stack is reported. No-op for objects that cannot be
    weak-referenced or hashed."""
    try:
        if obj in _LEAK_TRACKED:
            return
        token = _LeakToken(
            kind, "".join(traceback.format_stack(limit=12)[:-2])
        )
        _LEAK_TRACKED[obj] = token
        fin = weakref.finalize(obj, _finalize_leak, token)
        fin.atexit = False  # interpreter shutdown is not a leak
    except TypeError:
        pass


def mark_released(obj) -> None:
    try:
        token = _LEAK_TRACKED.get(obj)
    except TypeError:
        return
    if token is not None:
        token.released = True


def instrument_resource_class(cls, kind: str, release=("close",),
                              holds: str | None = None) -> bool:
    """Acquisition wrapper for one resource class: ``__init__`` registers
    the leak finalizer, each method named in `release` marks the token
    released. `holds` names an attribute whose falsy value after
    construction means no resource is actually held (e.g.
    ``ObjectHandle(mutex=None)`` on metadata-only paths). Idempotent."""
    if _LEAK_CLASSES.get(f"{cls.__module__}.{cls.__qualname__}"):
        return True
    saved: dict = {"__init__": cls.__init__}
    orig_init = cls.__init__

    def __init__(self, *a, **kw):
        orig_init(self, *a, **kw)
        if holds is None or getattr(self, holds, None):
            track_resource(self, kind)

    __init__.__wrapped__ = orig_init
    cls.__init__ = __init__
    for name in release:
        # resolve through the MRO: an INHERITED release method must be
        # wrapped onto this class too, or every properly-released
        # instance would report a false leak (finalizer registered,
        # token never marked). The saved None sentinel means "delete
        # from this class on disarm" (the base keeps its original).
        orig = getattr(cls, name, None)
        if orig is None:
            continue
        saved[name] = cls.__dict__.get(name)

        def _rel(self, *a, _mv_orig=orig, **kw):
            mark_released(self)
            return _mv_orig(self, *a, **kw)

        _rel.__wrapped__ = orig
        setattr(cls, name, _rel)
    _LEAK_CLASSES[f"{cls.__module__}.{cls.__qualname__}"] = (
        kind, cls, saved
    )
    return True


# resource classes the witness arms on a live server, mirroring the
# static ownership table's kinds: (module, class, kind, release methods,
# holds-attr). ObjectHandle is THE case the table exists for — a handle
# collected unreleased stranded a namespace read lock until TTL.
_LEAK_TABLE = (
    ("minio_tpu_torch.erasure.set", "ObjectHandle", "nslock-handle",
     ("close",), "_mutex"),
    ("minio_tpu_torch.server.sftp", "_WriteHandle", "spool",
     ("close",), "spool"),
    ("minio_tpu_torch.native", "DataplanePut", "native-put",
     ("finish", "abort"), None),
)


def arm_leak_witness() -> int:
    """Instrument every already-imported class in the leak table. Call
    after the serving modules are imported (server startup, test setup);
    classes imported later can be armed by calling again. Returns how
    many classes are actively witnessed."""
    if not leaks_enabled():
        return 0
    armed = 0
    for mod_name, cls_name, kind, release, holds in _LEAK_TABLE:
        mod = sys.modules.get(mod_name)
        if mod is None:
            continue
        cls = getattr(mod, cls_name, None)
        if not isinstance(cls, type):
            continue
        try:
            if instrument_resource_class(cls, kind, release, holds):
                armed += 1
        except Exception:
            continue  # witness must never break imports/serving
    return armed


def disarm_leak_witness() -> None:
    """Restore every instrumented class (tests)."""
    for key, (kind, cls, saved) in list(_LEAK_CLASSES.items()):
        for name, orig in saved.items():
            if orig is None:
                # wrapper shadowed an inherited method: remove it
                try:
                    delattr(cls, name)
                except AttributeError:
                    pass
            else:
                setattr(cls, name, orig)
        _LEAK_CLASSES.pop(key, None)


def leak_classes() -> list[str]:
    return sorted(_LEAK_CLASSES)


# -- event-loop stall watchdog ---------------------------------------------


class LoopWatchdog:
    """Monotonic tick scheduled on the loop + a daemon thread that
    notices the tick going stale. A stall past the threshold reports ONE
    ``loop.stall`` event with the loop thread's current stack (the
    offender is usually still on the frame that blocked), then re-arms
    when the loop breathes again."""

    def __init__(self, loop, threshold_s: float | None = None):
        self.loop = loop
        self.threshold = threshold_s or stall_threshold_s()
        self.tick_interval = max(self.threshold / 4.0, 0.05)
        self._last_tick = time.monotonic()
        self._loop_thread_id: int | None = None
        self._stalled = False
        self._stop = threading.Event()
        self.stalls = 0
        self._thread = threading.Thread(
            target=self._watch, name="minio-tpu-sanitize-watchdog",
            daemon=True,
        )

    def start(self) -> "LoopWatchdog":
        self._schedule_tick()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            _watchdogs.remove(self)
        except ValueError:
            pass

    def _schedule_tick(self) -> None:
        def tick():
            self._last_tick = time.monotonic()
            self._loop_thread_id = threading.get_ident()
            self._stalled = False
            if not self._stop.is_set() and not self.loop.is_closed():
                self.loop.call_later(self.tick_interval, tick)

        try:
            self.loop.call_soon_threadsafe(tick)
        except RuntimeError:
            pass  # loop already closed

    def _watch(self) -> None:
        while not self._stop.wait(self.tick_interval):
            if self.loop.is_closed():
                return
            age = time.monotonic() - self._last_tick
            if age < self.threshold or self._stalled:
                continue
            self._stalled = True  # one report per stall episode
            self.stalls += 1
            stack = ""
            tid = self._loop_thread_id
            if tid is not None:
                frame = sys._current_frames().get(tid)
                if frame is not None:
                    stack = "".join(traceback.format_stack(frame, limit=16))
            _report("loop.stall", stall_s=round(age, 3),
                    threshold_s=self.threshold, stack=stack)


_watchdogs: list[LoopWatchdog] = []


def watch_loop(loop, threshold_s: float | None = None) -> LoopWatchdog:
    wd = LoopWatchdog(loop, threshold_s).start()
    _watchdogs.append(wd)
    return wd


# -- env-mutation tracking --------------------------------------------------

_ENV_MISSING = "<unset>"


def _is_tracked(name: str) -> bool:
    return name.startswith("MINIO_")  # covers MINIO_TPU_* too


def env_snapshot() -> dict[str, str]:
    return {k: v for k, v in os.environ.items() if _is_tracked(k)}


def env_diff(snapshot: dict[str, str]) -> dict[str, tuple[str, str]]:
    """{name: (old, new)} for every tracked var that changed since the
    snapshot; absent-on-either-side shows as the ``<unset>`` sentinel."""
    now = env_snapshot()
    out: dict[str, tuple[str, str]] = {}
    for k in sorted(set(snapshot) | set(now)):
        old = snapshot.get(k, _ENV_MISSING)
        new = now.get(k, _ENV_MISSING)
        if old != new:
            out[k] = (old, new)
    return out


def env_restore(snapshot: dict[str, str]) -> None:
    for k in list(os.environ):
        if _is_tracked(k) and k not in snapshot:
            del os.environ[k]
    for k, v in snapshot.items():
        if os.environ.get(k) != v:
            os.environ[k] = v


def report_env_leak(scope: str, diff: dict[str, tuple[str, str]]) -> None:
    _report(
        "env.leak", scope=scope,
        changes={k: list(v) for k, v in diff.items()},
    )
