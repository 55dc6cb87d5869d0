"""Span core: contextvar-propagated request ids + typed trace spans.

Zero-cost-when-idle contract (the reference checks NumSubscribers before
building a record): ``span()`` returns the shared ``NOOP_SPAN`` singleton
— no Span object, no field dict copy, no clock read — unless a publisher
is attached AND it has subscribers or a span ring (``SpanRing``). Code
on the hot path may therefore open spans unconditionally.

The ring is the always-on record: the server's publisher keeps the
newest closed spans in memory, stamped with ``time.monotonic_ns()`` (the
clock a device trace is lined up with), whether or not anyone streams
them. With only a ring a span builds no record dict and publishes
nothing; on exit it writes one fixed-width row.

The request context is a ``contextvars.ContextVar`` so it survives both
``await`` hops and executor hops (``ContextPool``/``bind_context`` copy
the context across thread boundaries; storage-REST carries it in an
``x-minio-reqid`` header / grid payload field between nodes).
"""

from __future__ import annotations

import contextvars
import itertools
import os
import socket
import struct
import threading
import time
from _thread import get_ident as _get_ident
from collections import namedtuple
from contextlib import contextmanager
from time import monotonic_ns as _monotonic_ns

TYPE_S3 = "s3"
TYPE_INTERNAL = "internal"
TYPE_STORAGE = "storage"
TYPE_TPU = "tpu"
TYPE_HEAL = "heal"
TYPE_SCANNER = "scanner"
TYPE_FAULT = "fault"
TYPE_SANITIZER = "sanitizer"
TYPE_PLACEMENT = "placement"
TYPE_REBALANCE = "rebalance"
TYPE_DIAG = "diag"
TRACE_TYPES = frozenset(
    {TYPE_S3, TYPE_INTERNAL, TYPE_STORAGE, TYPE_TPU, TYPE_HEAL,
     TYPE_SCANNER, TYPE_FAULT, TYPE_SANITIZER, TYPE_PLACEMENT,
     TYPE_REBALANCE, TYPE_DIAG}
)

# (request_id, parent_span_id); spans nest by swapping the second slot
_CTX: contextvars.ContextVar[tuple[str, int] | None] = contextvars.ContextVar(
    "minio_tpu_trace_ctx", default=None
)

_span_ids = itertools.count(1)

# how long the current pool task waited for a worker (ns), one-shot:
# ``ContextPool`` sets it when a recording publisher is attached, and the
# first storage span of the task takes it (``take_queue_ns``)
_QUEUED: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "minio_tpu_trace_queued", default=None
)

# the publishing TracePubSub (server/metrics.py) — module-level because
# spans open deep in layers (dispatcher, storage wrappers) that have no
# server reference; one process serves one node
_publisher = None

NODE = socket.gethostname()


def set_publisher(pub) -> None:
    global _publisher
    _publisher = pub


def publisher():
    return _publisher


def active() -> bool:
    """Someone subscribes to the trace stream."""
    p = _publisher
    return p is not None and p.active


def recording() -> bool:
    """Spans are kept: someone subscribes, or the publisher has a ring."""
    p = _publisher
    return p is not None and (p.active or getattr(p, "ring", None) is not None)


def ring():
    """The publisher's span ring, or None (a publisher may have none)."""
    return getattr(_publisher, "ring", None)


def next_span_id() -> int:
    return next(_span_ids)


def new_request_id() -> str:
    """An ``x-amz-request-id`` value: 16 uppercase hex chars (the
    reference's mustGetRequestID is a time-based variant of the same)."""
    return os.urandom(8).hex().upper()


def set_request(request_id: str, span_id: int = 0):
    """Install `request_id` as the current trace context; returns the
    token for ``reset_request``. Used at plane entries (S3 entry,
    storage-REST server side); everything below inherits via contextvar
    propagation. ``span_id`` names the entry's own span as the parent
    of every span below it (0: none)."""
    return _CTX.set((request_id, span_id))


def reset_request(token) -> None:
    _CTX.reset(token)


@contextmanager
def request_context(request_id: str):
    token = _CTX.set((request_id, 0))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_request_id() -> str:
    ctx = _CTX.get()
    return ctx[0] if ctx is not None else ""


def current_context() -> tuple[str, int] | None:
    """(request id, innermost open span id) of the caller, or None."""
    return _CTX.get()


def take_queue_ns() -> int:
    """The wait of the current pool task for its worker (ns), once: a
    later span of the same task took no worker and reads 0."""
    cell = _QUEUED.get()
    if cell is None:
        return 0
    wait, cell[0] = cell[0], 0
    return wait


def bind_context(fn):
    """Wrap `fn` so it runs under a snapshot of the CURRENT context —
    for handing work to executors that don't propagate contextvars
    (``loop.run_in_executor`` does not)."""
    ctx = contextvars.copy_context()
    return lambda *a, **kw: ctx.run(fn, *a, **kw)


def publish(record: dict) -> None:
    """Publish a pre-built record if anyone is listening (cheap guard
    for non-span record sites like the dispatcher's batch records)."""
    p = _publisher
    if p is not None and p.active:
        p.publish(record)


class Span:
    """One timed, typed trace record; context-manager only (see the
    ``span`` miniovet rule). On exit writes one row to the publisher's
    ring, if it has one, and publishes a record, with the error captured
    from a propagating exception, if anyone subscribes; never swallows
    the exception."""

    __slots__ = (
        "trace_type", "name", "fields", "req_id", "span_id", "parent_id",
        "_t0", "_token",
    )

    def __init__(self, trace_type: str, name: str, fields: dict):
        self.trace_type = trace_type
        self.name = name
        self.fields = fields
        ctx = _CTX.get()
        self.req_id = ctx[0] if ctx is not None else ""
        self.parent_id = ctx[1] if ctx is not None else 0
        self.span_id = next(_span_ids)
        self._t0 = 0
        self._token = None

    def __enter__(self) -> "Span":
        self._token = _CTX.set((self.req_id, self.span_id))
        self._t0 = _monotonic_ns()
        return self

    def set(self, **fields) -> None:
        self.fields.update(fields)

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = _monotonic_ns()
        if self._token is not None:
            try:
                _CTX.reset(self._token)
            except ValueError:
                # generator spans may enter and exit under different
                # context COPIES (each executor hop snapshots its own);
                # the copy dies with the task, so a failed reset leaks
                # nothing
                pass
        p = _publisher
        if p is None:
            return False
        ring = getattr(p, "ring", None)
        if ring is not None:
            f = self.fields
            key = (self.trace_type, self.name)
            ring.add(
                _RING_NAMES.get(key) or _ring_name(*key), "", self.req_id,
                self.span_id, self.parent_id, self._t0, t1, f.get("bytes", 0),
                f.get("queue_ns", 0), f.get("status", exc is not None),
            )
        if p.active:
            rec = {
                "time": time.time(),
                "type": self.trace_type,
                "name": self.name,
                "reqId": self.req_id,
                "spanId": self.span_id,
                "parentId": self.parent_id,
                "node": NODE,
                "durationNs": t1 - self._t0,
                "error": "" if exc is None else f"{type(exc).__name__}: {exc}",
            }
            rec.update(self.fields)
            p.publish(rec)
        return False  # propagate exceptions


class _NoopSpan:
    """Shared do-nothing span for the no-subscribers path; identity is
    asserted by the zero-overhead test."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **fields) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def span(trace_type: str, name: str, **fields):
    """A span of `trace_type` (one of TRACE_TYPES) for use in a ``with``
    statement. Returns NOOP_SPAN unless spans are kept (``recording``)."""
    p = _publisher
    if p is None or (getattr(p, "ring", None) is None and not p.active):
        return NOOP_SPAN
    return Span(trace_type, name, fields)


# -- the span ring -----------------------------------------------------------

_RING_NAMES: dict[tuple[str, str], str] = {}


def _ring_name(trace_type: str, name: str) -> str:
    """A span's name in the ring: dotted names as they are, a bare
    operation name under its type (``storage.create_file``)."""
    full = _RING_NAMES[(trace_type, name)] = (
        name if "." in name else f"{trace_type}.{name}"
    )
    return full


_SHIFT = 12  # 4,096 slots a chunk
_MASK = (1 << _SHIFT) - 1
_ROW = struct.Struct("<9q")
_PACK = _ROW.pack_into

RingSpan = namedtuple(
    "RingSpan",
    "name label req_id seq span_id parent_id thread start_ns end_ns bytes "
    "queue_ns status",
)


class SpanRing:
    """Bounded in-memory record of closed spans: the newest ``capacity``
    are kept, and ``overwritten`` counts the older ones written over.

    A slot is a fixed-width row (``_ROW``: the write's sequence number,
    ids, the writer's thread ident, start and end in
    ``time.monotonic_ns()``, bytes, queue_ns, status) beside one tuple of
    shared strings (name, label, request id): about 144 bytes, so a full
    ring of 262,144 spans holds about 38 MB. Storage is taken in chunks
    as spans arrive, so an idle server's ring costs nothing. Writers
    take no lock: each ``next()`` of the sequence (atomic under the GIL)
    owns its slot until the ring wraps past it."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"span ring capacity {capacity} < 1")
        self.capacity = capacity
        self._seq = itertools.count()
        self._mu = threading.Lock()
        self._rows: list[bytearray] = []
        self._strs: list[list] = []

    def _chunk(self, c: int) -> tuple[bytearray, list]:
        with self._mu:
            size = 1 << _SHIFT
            while len(self._rows) <= c:
                self._rows.append(bytearray(size * _ROW.size))
                self._strs.append([None] * size)
        return self._rows[c], self._strs[c]

    def add(self, name: str, label: str, req_id: str, span_id: int,
            parent_id: int, start_ns: int, end_ns: int, nbytes: int = 0,
            queue_ns: int = 0, status: int = 0) -> None:
        seq = next(self._seq)
        i = seq % self.capacity
        c, o = i >> _SHIFT, i & _MASK
        try:
            rows, strs = self._rows[c], self._strs[c]
        except IndexError:
            rows, strs = self._chunk(c)
        try:
            _PACK(rows, o * 72, seq, span_id, parent_id, _get_ident(),
                  start_ns, end_ns, nbytes, queue_ns, status)
        except struct.error:  # a field that is not a whole number: 0
            _PACK(rows, o * 72, seq, span_id, parent_id, _get_ident(),
                  start_ns, end_ns, 0, 0, 0)
        strs[o] = (name, label, req_id)

    def nbytes(self) -> int:
        """Bytes the ring holds now: rows, slots, and the string tuples."""
        with self._mu:
            chunks = list(zip(self._rows, self._strs))
        return sum(len(r) + 8 * len(s) + sum(64 for x in s if x is not None)
                   for r, s in chunks)

    def snapshot(self) -> tuple[list[RingSpan], int]:
        """(the kept spans oldest first, the number overwritten). Spans
        closing while it reads may be left out."""
        with self._mu:
            chunks = list(zip(self._rows, self._strs))
        out = []
        for rows, strs in chunks:
            for o, names in enumerate(strs):
                if names is not None:
                    out.append(RingSpan(*names, *_ROW.unpack_from(rows, o * 72)))
        out.sort(key=lambda sp: sp.seq)
        written = out[-1].seq + 1 if out else 0
        return out, max(0, written - self.capacity)
