"""Pooled stripe arenas + copy-site accounting — the zero-copy data plane.

The ingest→encode→shard-frame boundary used to move every stripe block
through 3-4 full copies (``bytes`` accumulation → numpy staging →
per-dispatch ``np.concatenate`` + pad → ``.tobytes()`` per shard for
framing), and the GET path mirrored it. On a memory-bandwidth-bound host
those copies ARE the throughput ceiling once the coding kernel runs at
memory speed (the XOR-schedule line, arXiv:2108.02692, and the
polynomial-RS evaluation, arXiv:1312.5155, both make the same point for
the kernel itself). This module provides the two primitives the
zero-copy plane is built on:

1. ``BufferPool`` — a process-wide pool of size-classed arenas with
   REFCOUNTED LEASES. ``acquire(nbytes)`` hands out a :class:`Lease`
   whose owner may write the arena; readers that outlive the owner
   (response iterators, cache fills in flight) ``retain()`` it. The
   arena returns to the free list only when the LAST holder releases —
   so a pooled buffer can never be re-leased while any reader lease is
   live: recycling is gated on the refcount reaching zero, and the
   refcount is the only door back into the pool. Violations (release of
   a dead lease / double release) are sanitizer-witnessed under
   ``MINIO_TPU_SANITIZE=1`` (event ``pool.lease-violation``) and counted
   unconditionally.

2. Copy-site accounting — ``count_copy(site, n)`` makes every REMAINING
   copy on the ingest/egress hot paths enumerable as
   ``minio_tpu_ingest_copies_total{site}``. The streaming-PUT zero-copy
   path must report ``site="staging"`` == 0 (gated in the bench ingest
   phase); boundary sites that legitimately copy (RPC serialization,
   cache-fill admission, the legacy A/B path) each carry their own named
   site, so "covered everything" is a measured claim, not an assumption.

``MINIO_TPU_ZEROCOPY=0`` keeps the previous copying paths end to end —
the A/B lever the bench phase and the byte-identity tests measure
against. Ownership rules are documented in docs/ERASURE.md
(buffer-ownership / dispatch contract) and docs/ROBUSTNESS.md (lease
rules).
"""

from __future__ import annotations

import os
import threading

import numpy as np

# size classes are powers of two from 64 KiB up; anything larger than
# the top class allocates unpooled (released back to the allocator, not
# the pool) so one giant request cannot pin the whole budget
_MIN_CLASS = 1 << 16
_MAX_CLASS = 1 << 27  # 128 MiB — one full streaming batch at the default cap

_TRUTHY = ("1", "true", "on", "yes")


def zerocopy_enabled() -> bool:
    """MINIO_TPU_ZEROCOPY gates the pooled-arena zero-copy data plane
    (streaming-PUT ingest arenas, writev shard framing, pooled GET
    gather). "0" keeps the previous copying paths — the A/B lever;
    payloads are byte-identical either way (pinned by tests)."""
    return os.environ.get("MINIO_TPU_ZEROCOPY", "1") != "0"


def _pool_budget_bytes() -> int:
    """MINIO_TPU_POOL_MB bounds idle arenas RETAINED by the pool (live
    leases are never bounded here — backpressure belongs to the request
    planes). Malformed values fall back — a tuning typo must not take
    down the data plane."""
    try:
        return int(os.environ.get("MINIO_TPU_POOL_MB", "256")) << 20
    except ValueError:
        return 256 << 20


# -- copy-site accounting ----------------------------------------------------

_COPY_LOCK = threading.Lock()
# pre-seeded: every named hot-path copy site exists from boot so the
# metrics series (and the bench gate reading them) never miss a label
_COPY_SITES = (
    "staging",          # ingest accumulation staging copy (legacy path)
    "dispatch-concat",  # dispatcher batch assembly into the batch arena
    "dispatch-pad",     # zero-fill of a pad tail (the port pads no batch)
    "frame-tobytes",    # per-shard bytes materialization for framing
    "append-rpc",       # remote-drive append serialization (RPC boundary)
    "gather-join",      # GET block assembly join (legacy path)
    "cache-fill",       # cache admission snapshot (cache owns its copy)
    "tail-block",       # partial final block (numpy codec boundary)
)
_COPIES: dict[str, int] = {s: 0 for s in _COPY_SITES}


def count_copy(site: str, n: int = 1) -> None:
    """Record `n` full-buffer copies at a named hot-path site. Sites are
    the enumerable remainder of the zero-copy refactor: anything not
    counted here moves through views."""
    with _COPY_LOCK:
        _COPIES[site] = _COPIES.get(site, 0) + n


def copies_snapshot() -> dict[str, int]:
    with _COPY_LOCK:
        return dict(_COPIES)


def copies_reset() -> None:
    """Test/bench hook: zero the copy-site counters (the ingest bench
    phase asserts staging==0 over ITS window, not process lifetime)."""
    with _COPY_LOCK:
        for k in list(_COPIES):
            _COPIES[k] = 0


# -- pooled arenas -----------------------------------------------------------


class LeaseViolation(RuntimeError):
    """Release of a lease that is not live (double release / release
    after the arena returned to the pool). Raised only in tests that
    opt in; production paths report + count and carry on."""


class Lease:
    """One refcounted hold on a pooled arena.

    Ownership rule (docs/ROBUSTNESS.md): the acquirer owns the arena and
    is the only writer. Every consumer that may outlive the owner's
    scope — a response iterator serving a memoryview of the arena, a
    deferred shard append — calls ``retain()`` BEFORE the owner's
    ``release()`` can run, and ``release()`` when done. The arena is
    recyclable only at refcount zero, so a live reader lease makes
    re-lease impossible by construction.
    """

    __slots__ = ("_pool", "_arr", "_refs", "_lock", "size")

    def __init__(self, pool: "BufferPool", arr: np.ndarray):
        self._pool = pool
        self._arr: np.ndarray | None = arr
        self._refs = 1
        self._lock = threading.Lock()
        self.size = arr.nbytes

    @property
    def live(self) -> bool:
        with self._lock:
            return self._refs > 0

    @property
    def array(self) -> np.ndarray:
        """The arena as a flat uint8 array (owner-write surface)."""
        arr = self._arr
        if arr is None:
            raise LeaseViolation("arena accessed after final release")
        return arr

    def view(self, nbytes: int, offset: int = 0) -> memoryview:
        """A writable memoryview over [offset, offset+nbytes)."""
        return memoryview(self.array.data)[offset:offset + nbytes]

    def retain(self) -> "Lease":
        with self._lock:
            if self._refs <= 0:
                self._pool._violation("retain-dead")
                return self
            self._refs += 1
        return self

    def release(self) -> None:
        with self._lock:
            if self._refs <= 0:
                self._pool._violation("double-release")
                return
            self._refs -= 1
            done = self._refs == 0
            arr, self._arr = (self._arr, None) if done else (None, self._arr)
        if done and arr is not None:
            self._pool._recycle(arr)


class BufferPool:
    """Size-classed arena pool. Thread-safe; arenas are flat uint8
    numpy arrays (the geometry — ``(blocks, d, shard_len)`` for ingest,
    assembly spans for egress — is a reshape/view, never a copy)."""

    def __init__(self, budget_bytes: int | None = None):
        self._lock = threading.Lock()
        self._free: dict[int, list[np.ndarray]] = {}
        self._budget = budget_bytes
        self.stats = {
            "acquires": 0, "hits": 0, "misses": 0, "unpooled": 0,
            "recycled_bytes": 0, "resident_bytes": 0, "live_leases": 0,
            "violations": 0,
        }

    @staticmethod
    def _class_for(nbytes: int) -> int:
        c = _MIN_CLASS
        while c < nbytes:
            c <<= 1
        return c

    def acquire(self, nbytes: int) -> Lease:
        """Lease an arena of >= nbytes. The arena's bytes are UNDEFINED
        (previous contents); owners overwrite what they use. Oversize
        requests allocate unpooled and are garbage-collected on release."""
        cls = self._class_for(nbytes)
        arr = None
        pooled = cls <= _MAX_CLASS
        with self._lock:
            self.stats["acquires"] += 1
            self.stats["live_leases"] += 1
            if pooled:
                free = self._free.get(cls)
                if free:
                    arr = free.pop()
                    self.stats["hits"] += 1
                    self.stats["resident_bytes"] -= arr.nbytes
                else:
                    self.stats["misses"] += 1
            else:
                self.stats["unpooled"] += 1
        if arr is None:
            arr = np.empty(cls if pooled else nbytes, dtype=np.uint8)
        return Lease(self, arr)

    def _recycle(self, arr: np.ndarray) -> None:
        cls = arr.nbytes
        budget = self._budget if self._budget is not None else _pool_budget_bytes()
        with self._lock:
            self.stats["live_leases"] -= 1
            self.stats["recycled_bytes"] += cls
            if (
                cls <= _MAX_CLASS
                and self._class_for(cls) == cls
                and self.stats["resident_bytes"] + cls <= budget
            ):
                self._free.setdefault(cls, []).append(arr)
                self.stats["resident_bytes"] += cls

    def _violation(self, kind: str) -> None:
        with self._lock:
            self.stats["violations"] += 1
        from ..analysis import sanitizer

        if sanitizer.enabled():
            sanitizer._report("pool.lease-violation", kind=kind)

    def stats_snapshot(self) -> dict:
        with self._lock:
            return dict(self.stats)


_POOL: BufferPool | None = None
_POOL_LOCK = threading.Lock()


def get_pool() -> BufferPool:
    """The process-wide stripe-arena pool (ingest + egress share it; the
    size-class split keeps 1 MiB GET assemblies and 64 MiB ingest
    arenas from evicting each other — different classes, one budget)."""
    global _POOL
    if _POOL is None:
        with _POOL_LOCK:
            if _POOL is None:
                _POOL = BufferPool()
    return _POOL


def pool_stats_snapshot() -> dict:
    """Stats of the process pool (zeros before first use, so the
    metrics series exist from boot)."""
    global _POOL
    if _POOL is None:
        return {
            "acquires": 0, "hits": 0, "misses": 0, "unpooled": 0,
            "recycled_bytes": 0, "resident_bytes": 0, "live_leases": 0,
            "violations": 0,
        }
    return _POOL.stats_snapshot()
