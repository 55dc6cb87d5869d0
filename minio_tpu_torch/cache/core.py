"""Quorum-coherent caching core: FileInfo cache + hot-object data cache.

The GET/HEAD hot path pays two structural costs per request even for an
object read a thousand times a second: a full ``read_version`` fan-out
across all N drives to find the quorum FileInfo, and fresh per-shard
reads of the same bytes. With the coding path on the card (on an H100
80GB HBM3 at its 700 W limit, K1's fused encode + hash of 256 stripe
blocks of 1 MiB takes 0.575 ms, PERF.md section 6), this per-request I/O
orchestration is the wall — the same observation arXiv:2108.02692 makes
for CPU erasure coding. This module removes both costs for hot objects:

- **FileInfo cache** (one per ``ErasureSet``): LRU keyed by
  ``(bucket, object, version_id)`` holding the quorum-picked FileInfo
  plus the per-drive metadata list the read path needs, stamped with the
  quorum identity ``(mod_time, data_dir)``. Concurrent misses on one key
  collapse into a single quorum read (**singleflight**).
- **Hot-object data cache** (process-wide, global byte budget): whole
  objects below ``MINIO_TPU_CACHE_OBJECT_MAX`` admitted after
  ``MINIO_TPU_CACHE_ADMIT_TOUCHES`` distinct reads (inline-data objects
  immediately — their bytes were memory-resident anyway), served with
  etag/bitrot identity preserved (bytes enter the cache only after the
  erasure layer's bitrot verification, and leave stamped with the same
  FileInfo/etag they were read under).

Coherence is write-through: every local mutation funnels through ONE
choke-point API (``SetCache.invalidate_object`` /
``invalidate_bucket``) — the ``cache-discipline`` miniovet rule rejects
any other mutation of cache state from erasure/server code. Cross-node,
the choke point broadcasts over the grid (``cache/coherence.py``) with a
per-sender generation counter; a receiver that observes a sequence gap
bumps its **epoch**, after which every pre-gap entry must revalidate on
next hit — a cheap single-drive modTime check — before being served. A
lost invalidation therefore costs a revalidate, never a stale serve.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future

from .. import obs
from ..storage.errors import StorageError

__all__ = [
    "SetCache",
    "enabled",
    "object_max",
    "data_cache",
    "aggregate_stats",
    "clear_store",
    "store_caches",
]


def enabled() -> bool:
    return os.environ.get("MINIO_TPU_CACHE", "1") != "0"


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def object_max() -> int:
    return _int_env("MINIO_TPU_CACHE_OBJECT_MAX", 2 << 20)


def _mem_budget() -> int:
    return _int_env("MINIO_TPU_CACHE_MEM_MB", 256) << 20


def _fileinfo_entries() -> int:
    return _int_env("MINIO_TPU_CACHE_FILEINFO_ENTRIES", 4096)


def _admit_touches() -> int:
    return max(1, _int_env("MINIO_TPU_CACHE_ADMIT_TOUCHES", 2))


def _revalidate_ttl() -> float:
    try:
        return float(os.environ.get("MINIO_TPU_CACHE_REVALIDATE_S", "1"))
    except ValueError:
        return 1.0


# Global memory accounting shared by every cache tier in the process: the
# byte budget is deployment-wide, not per-set (a 32-set pool must not mean
# 32x the configured memory).
_BYTES_LOCK = threading.Lock()
_BYTES_TOTAL = 0


def _bytes_add(n: int) -> None:
    global _BYTES_TOTAL
    with _BYTES_LOCK:
        _BYTES_TOTAL += n


def _bytes_total() -> int:
    return _BYTES_TOTAL


class TierStats:
    """Counters for one cache tier; snapshot() is lock-free-read safe
    (int reads are atomic under the GIL; metrics tolerate torn windows)."""

    __slots__ = (
        "hits", "misses", "evictions", "invalidations", "revalidations",
        "singleflight_shared", "fills", "rejected",
    )

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.revalidations = 0
        self.singleflight_shared = 0
        self.fills = 0
        self.rejected = 0

    def snapshot(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _FiEntry:
    __slots__ = ("fi", "metas", "epoch", "stamp", "t", "bytes")

    def __init__(self, fi, metas, epoch: int, nbytes: int):
        self.fi = fi
        self.metas = metas
        self.epoch = epoch
        self.stamp = (fi.mod_time, fi.data_dir)
        self.t = time.monotonic()
        self.bytes = nbytes


class _DataEntry:
    __slots__ = ("fi", "data", "epoch", "stamp", "t", "ref")

    def __init__(self, fi, data: bytes, epoch: int, ref):
        self.fi = fi
        self.data = data
        self.epoch = epoch
        self.stamp = (fi.mod_time, fi.data_dir)
        self.t = time.monotonic()
        self.ref = ref  # weakref to the owning ErasureSet (id-reuse guard)


class DataCache:
    """Process-wide hot-object cache. Keys carry the owning set's identity
    (id + weakref guard, like the listing metacache) so two stores in one
    process — in-process site pairs, test rigs — never share bytes."""

    def __init__(self):
        self._mu = threading.Lock()
        self._lru: OrderedDict[tuple, _DataEntry] = OrderedDict()
        # admission ledger: key -> (touches, last-touch time)
        self._touches: dict[tuple, tuple[int, float]] = {}
        self.stats = TierStats()

    def _key(self, es, bucket: str, obj: str, vid: str) -> tuple:
        return (id(es), bucket, obj, vid)

    def get(self, es, bucket: str, obj: str, vid: str) -> _DataEntry | None:
        k = self._key(es, bucket, obj, vid)
        with self._mu:
            ent = self._lru.get(k)
            # per-entry weakref guard: CPython may recycle id(es) for a
            # NEW ErasureSet after the old one is collected — its entries
            # must never serve another store's bytes
            if ent is None or ent.ref() is not es:
                self.stats.misses += 1
                return None
            self._lru.move_to_end(k)
        return ent  # epoch/revalidation judged by the caller (SetCache)

    def admit(self, es, bucket: str, obj: str, vid: str, inline: bool) -> bool:
        """Admission policy: objects earn residency by being re-read
        (two-touch by default) so a one-pass scan cannot flush the hot
        set; inline objects admit immediately."""
        need = 1 if inline else _admit_touches()
        if need <= 1:
            return True
        k = self._key(es, bucket, obj, vid)
        now = time.monotonic()
        with self._mu:
            n, _ = self._touches.get(k, (0, now))
            n += 1
            self._touches[k] = (n, now)
            if len(self._touches) > 4096:  # bounded ledger, oldest first
                for old in sorted(self._touches, key=lambda x: self._touches[x][1])[:1024]:
                    del self._touches[old]
        return n >= need

    def put(self, es, bucket: str, obj: str, vid: str, fi, data: bytes,
            epoch: int) -> None:
        if len(data) > object_max():
            self.stats.rejected += 1
            return
        k = self._key(es, bucket, obj, vid)
        budget = _mem_budget()
        with self._mu:
            old = self._lru.pop(k, None)
            if old is not None:
                _bytes_add(-len(old.data))
            self._lru[k] = _DataEntry(fi, data, epoch, weakref.ref(es))
            _bytes_add(len(data))
            self.stats.fills += 1
            if _bytes_total() > budget:
                # dead sets' entries can no longer be invalidated by
                # anyone — reclaim them before touching live entries
                for dk in [
                    k2 for k2, e in self._lru.items() if e.ref() is None
                ]:
                    _bytes_add(-len(self._lru.pop(dk).data))
                    self.stats.evictions += 1
        if _bytes_total() > budget:
            # the budget is shared with the segment tier, which has an
            # NVMe tier to overflow into — shed its cold segments first
            # (OUTSIDE _mu: demotion does disk I/O), or a warm segment
            # tier would starve this one to zero instead of spilling
            from . import segment as segmod

            segmod.segment_cache().shed_to_budget()
        with self._mu:
            while self._lru and _bytes_total() > budget:
                _, ev = self._lru.popitem(last=False)
                _bytes_add(-len(ev.data))
                self.stats.evictions += 1

    def touch_hit(self) -> None:
        with self._mu:
            self.stats.hits += 1

    def count_miss(self) -> None:
        # counters are bumped from every executor-pool reader thread:
        # += outside _mu is a lost update (miniovet races pass)
        with self._mu:
            self.stats.misses += 1

    def restamp(self, ent: _DataEntry, epoch: int) -> None:
        """Re-certify an entry after revalidation: the epoch/time stamps
        are written under _mu — two concurrent readers revalidating the
        same hot entry would otherwise interleave the pair."""
        with self._mu:
            ent.epoch = epoch
            ent.t = time.monotonic()
            self.stats.revalidations += 1

    def drop(self, k: tuple) -> None:
        """Internal removal (caller: SetCache choke point)."""
        with self._mu:
            ent = self._lru.pop(k, None)
            self._touches.pop(k, None)
            if ent is not None:
                _bytes_add(-len(ent.data))
                self.stats.invalidations += 1

    def drop_where(self, pred) -> int:
        with self._mu:
            victims = [k for k in self._lru if pred(k)]
            for k in victims:
                _bytes_add(-len(self._lru.pop(k).data))
                self._touches.pop(k, None)
            self.stats.invalidations += len(victims)
        return len(victims)

    def entry_count(self) -> int:
        return len(self._lru)

    def byte_count(self) -> int:
        with self._mu:
            return sum(len(e.data) for e in self._lru.values())


_DATA = DataCache()


def data_cache() -> DataCache:
    return _DATA


class SetCache:
    """Per-ErasureSet cache facade: the FileInfo tier lives here; the data
    tier delegates to the process-wide ``DataCache``; listing entries live
    in ``erasure/listing.py`` but invalidate through this choke point."""

    def __init__(self, es):
        self._es = weakref.ref(es)
        self._mu = threading.Lock()
        self._fi: OrderedDict[tuple, _FiEntry] = OrderedDict()
        self._by_obj: dict[tuple, set[tuple]] = {}  # (bucket,obj) -> keys
        self._flight: dict[tuple, Future] = {}
        self._epoch = 0
        # invalidation sequence: guards the miss->load->store window of
        # LOCK-FREE readers (get_object_info/tags hold no namespace lock,
        # so a concurrent overwrite can commit + invalidate while their
        # loader is mid-read; storing that result would poison the cache
        # with pre-overwrite metadata that nothing would ever invalidate
        # again). Every choke-point mutation bumps _inv_seq; per-object
        # marks live in _inv_keys (bounded — pruned marks collapse into
        # _inv_floor, conservatively treating them as "just invalidated").
        self._inv_seq = 0
        self._inv_keys: dict[tuple, int] = {}
        self._inv_floor = 0
        self.fi_stats = TierStats()

    # -- read path ---------------------------------------------------------

    def fileinfo(self, bucket: str, obj: str, vid: str, loader):
        """(fi, metas) for the key — from cache when fresh, else via
        ``loader()`` (the N-drive quorum read) under singleflight. Entries
        from an older epoch revalidate with a cheap metadata probe before
        being served."""
        if not enabled():
            return loader()
        key = (bucket, obj, vid)
        with self._mu:
            seq0 = self._inv_seq
            ent = self._fi.get(key)
            hit = ent is not None and self._fresh_locked(ent)
            if hit:
                self._fi.move_to_end(key)
                self.fi_stats.hits += 1
            stale = None if hit else ent
        if hit:
            # span published OUTSIDE _mu: tracing must not serialize every
            # hit across the set through the cache-wide lock
            span_lookup("fileinfo", bucket, obj, True)
            return ent.fi, ent.metas

        # revalidation AND loading both ride the singleflight: a hot key
        # going TTL-stale at N thousand req/s must cost ONE probe chain,
        # not a thundering herd of them
        def attempt():
            if stale is not None and self._revalidate(key, stale):
                # the singleflight owner runs on some pool thread while
                # the hit path bumps the same counters under _mu — take
                # it here too (miniovet races pass)
                with self._mu:
                    self.fi_stats.hits += 1
                    self.fi_stats.revalidations += 1
                span_lookup("fileinfo", bucket, obj, True)
                return stale.fi, stale.metas, False  # re-stamped in place
            span_lookup("fileinfo", bucket, obj, False)
            with self._mu:
                self.fi_stats.misses += 1
            fi, metas = loader()
            return fi, metas, True

        return self._load_singleflight(key, attempt, seq0)

    def _fresh_locked(self, ent: _FiEntry) -> bool:
        if ent.epoch != self._epoch:
            return False
        from . import coherence

        if coherence.is_distributed():
            ttl = _revalidate_ttl()
            if ttl > 0 and time.monotonic() - ent.t > ttl:
                return False
        return True

    @staticmethod
    def _stamp_live(es, key: tuple, stamp, parity: int) -> bool:
        """Cheap revalidation probe: metadata reads from ``parity + 1``
        reachable drives, ALL of which must still report the cached
        identity (mod_time, data_dir). Any committed overwrite reached
        write quorum (>= n - parity drives), so every (parity+1)-subset
        intersects it — one drive that lagged the write (down during it,
        first in iteration order) can never re-certify a stale entry by
        itself. Still far cheaper than the full N-drive quorum read."""
        bucket, obj, vid = key
        need = min(parity + 1, len(es.disks))
        seen = 0
        for disk in es.disks:
            try:
                m = disk.read_version(bucket, obj, vid, read_data=False)
            except (StorageError, OSError):
                continue  # drive unreachable: try the next voucher
            if (m.mod_time, m.data_dir) != stamp or m.deleted:
                return False  # authoritative: identity moved on
            seen += 1
            if seen >= need:
                return True
        return False  # not enough reachable drives to vouch: drop

    def _revalidate(self, key: tuple, ent: _FiEntry) -> bool:
        es = self._es()
        if es is not None and self._stamp_live(
            es, key, ent.stamp, ent.fi.erasure.parity_blocks
        ):
            with self._mu:
                cur = self._fi.get(key)
                if cur is ent:
                    ent.epoch = self._epoch
                    ent.t = time.monotonic()
            return True
        with self._mu:
            cur = self._fi.pop(key, None)
            if cur is not None:
                _bytes_add(-cur.bytes)
                self._unindex_locked(key)
                self.fi_stats.invalidations += 1
        return False

    def _load_singleflight(self, key: tuple, attempt, seq0: int):
        """``attempt() -> (fi, metas, should_store)``: the owner runs it
        (revalidate-or-quorum-load), followers share the result."""
        with self._mu:
            fut = self._flight.get(key)
            owner = fut is None
            if owner:
                fut = self._flight[key] = Future()
            else:
                self.fi_stats.singleflight_shared += 1
        if not owner:
            return fut.result()
        try:
            fi, metas, should_store = attempt()
            if should_store:
                self._store(key, fi, metas, seq0)
            fut.set_result((fi, metas))
            return fi, metas
        except BaseException as e:
            fut.set_exception(e)
            raise
        finally:
            with self._mu:
                self._flight.pop(key, None)

    def _invalidated_since_locked(self, key: tuple, seq0: int) -> bool:
        return max(
            self._inv_keys.get(key[:2], 0), self._inv_floor
        ) > seq0

    def _mark_invalidated_locked(self, bucket_obj: tuple | None) -> None:
        """Caller holds _mu. None marks EVERYTHING (bucket/prefix/clear/
        epoch-scope mutations) via the floor."""
        self._inv_seq += 1
        if bucket_obj is None:
            self._inv_floor = self._inv_seq
            self._inv_keys.clear()
            return
        self._inv_keys[bucket_obj] = self._inv_seq
        if len(self._inv_keys) > 8192:
            # pruned marks collapse into the floor: conservatively treat
            # every forgotten object as just-invalidated
            self._inv_floor = self._inv_seq
            self._inv_keys.clear()

    def _store(self, key: tuple, fi, metas, seq0: int) -> None:
        if fi.deleted:
            return  # delete markers stay uncached (cheap + churn-prone)
        nbytes = sum(
            len(m.inline_data) for m in metas
            if m is not None and m.inline_data
        )
        with self._mu:
            if self._invalidated_since_locked(key, seq0):
                # a mutation invalidated this object while the loader was
                # mid-read: its result may predate the overwrite — caching
                # it would be a permanent stale serve (lock-free HEAD/tags
                # paths have no namespace lock to exclude writers)
                return
            old = self._fi.pop(key, None)
            if old is not None:
                _bytes_add(-old.bytes)
            self._fi[key] = _FiEntry(fi, metas, self._epoch, nbytes)
            _bytes_add(nbytes)
            self._by_obj.setdefault(key[:2], set()).add(key)
            cap = _fileinfo_entries()
            budget = _mem_budget()
            while len(self._fi) > cap:
                k, ev = self._fi.popitem(last=False)
                _bytes_add(-ev.bytes)
                self._unindex_locked(k)
                self.fi_stats.evictions += 1
            # inline payloads count against the global byte budget; only
            # entries actually CARRYING bytes are worth evicting for it
            while _bytes_total() > budget:
                k = next((k for k, e in self._fi.items() if e.bytes), None)
                if k is None:
                    break
                ev = self._fi.pop(k)
                _bytes_add(-ev.bytes)
                self._unindex_locked(k)
                self.fi_stats.evictions += 1

    def _unindex_locked(self, key: tuple) -> None:
        keys = self._by_obj.get(key[:2])
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_obj[key[:2]]

    # -- data tier ---------------------------------------------------------

    def data_get(self, bucket: str, obj: str, vid: str):
        """(fi, bytes) when the whole object is cached and fresh."""
        if not enabled():
            return None
        es = self._es()
        if es is None:
            return None
        ent = _DATA.get(es, bucket, obj, vid)
        if ent is None:
            return None
        if ent.epoch != self._epoch or (self._needs_ttl_check(ent)):
            if not self._revalidate_data((bucket, obj, vid), ent):
                _DATA.count_miss()
                return None
            _DATA.restamp(ent, self._epoch)
        _DATA.touch_hit()
        return ent.fi, ent.data

    def _needs_ttl_check(self, ent) -> bool:
        from . import coherence

        if not coherence.is_distributed():
            return False
        ttl = _revalidate_ttl()
        return ttl > 0 and time.monotonic() - ent.t > ttl

    def _revalidate_data(self, key: tuple, ent) -> bool:
        es = self._es()
        if es is not None and self._stamp_live(
            es, key, ent.stamp, ent.fi.erasure.parity_blocks
        ):
            return True
        if es is not None:
            _DATA.drop((id(es),) + key)
        return False

    def data_admit(self, bucket: str, obj: str, vid: str, fi) -> int | None:
        """Should a full read of this object fill the data cache? Returns
        an invalidation-sequence token to pass back to ``data_put`` (the
        fill is rejected if the object was invalidated in between — e.g.
        a reader whose namespace lock TTL-expired mid-stream racing an
        overwrite), or None when the object is ineligible."""
        if not enabled():
            return None
        es = self._es()
        if es is None or fi.deleted or fi.size <= 0:
            return None
        if fi.size > object_max():
            return None
        if not fi.parts and fi.inline_data is None:
            return None  # transitioned stub: bytes live in the warm tier
        if not _DATA.admit(es, bucket, obj, vid, fi.inline_data is not None):
            return None
        with self._mu:
            return self._inv_seq

    def data_put(self, bucket: str, obj: str, vid: str, fi, data: bytes,
                 token: int) -> None:
        es = self._es()
        if es is None or not enabled():
            return
        if len(data) != fi.size:
            return  # torn fill: never cache bytes that don't match identity
        # token check and insert under ONE hold of _mu: an invalidation
        # landing between them would mark + drop BEFORE the insert and
        # the stale bytes would stick. Lock order SetCache._mu ->
        # DataCache._mu is safe (the choke points call _DATA outside
        # _mu, never the reverse); a racing invalidation now either
        # rejects the token or blocks on _mu until the entry exists to
        # be dropped.
        with self._mu:
            if self._invalidated_since_locked((bucket, obj, vid), token):
                return  # overwritten since the read began: stale bytes
            _DATA.put(es, bucket, obj, vid, fi, data, self._epoch)

    # -- segment tier (range-granular; cache/segment.py) -------------------

    def segment_open(self, bucket: str, obj: str, vid: str, range_hint):
        """Serve a ranged GET entirely from cached verified stripe-block
        segments: ``range_hint`` is the syntactically-parsed Range header
        (``("abs", start, end_or_None)`` / ``("suffix", n)``), resolved
        here against the cached FileInfo's size with the same semantics
        as the S3 layer's range parser. Returns
        ``(fi, start, length, [(abs_offset, bytes)])`` or None (miss /
        unresolvable range → the caller takes the erasure path)."""
        from . import segment as segmod

        if not segmod.segments_enabled() or range_hint is None:
            return None
        es = self._es()
        if es is None:
            return None
        sc = segmod.segment_cache()
        d = sc.directory(es, bucket, obj, vid)
        if d is None:
            return None
        key = (bucket, obj, vid)
        if d.epoch != self._epoch or self._needs_ttl_check(d):
            if not self._revalidate_segments(key, d):
                return None
            sc.restamp(d, self._epoch, time.monotonic())
        resolved = _resolve_range(range_hint, d.fi.size)
        if resolved is None:
            return None
        start, length = resolved
        rows = sc.read_range(d, start, length)
        if rows is None:
            return None
        span_lookup("segment", bucket, obj, True)
        return d.fi, start, length, rows

    def _revalidate_segments(self, key: tuple, d) -> bool:
        es = self._es()
        if es is not None and self._stamp_live(
            es, key, d.stamp, d.fi.erasure.parity_blocks
        ):
            return True
        if es is not None:
            from . import segment as segmod

            segmod.segment_cache().drop_where(
                lambda k: k == (id(es),) + key
            )
        return False

    def segment_admit(self, bucket: str, obj: str, vid: str, fi) -> int | None:
        """Should this ranged read's decoded stripe blocks fill the
        segment cache? Same token contract as ``data_admit``; only
        objects ABOVE the whole-object tier's size gate are eligible
        (below it the whole-object tier is strictly better).
        Transformed objects (SSE/compression) are excluded: their GET
        path issues multiple reads per response through one pinned
        handle, which the segment tier's range-scoped handle cannot
        honor version-stably."""
        from . import segment as segmod

        if not segmod.segments_enabled():
            return None
        es = self._es()
        if es is None or fi.deleted or fi.size <= 0:
            return None
        if fi.size <= object_max():
            return None
        if not fi.parts or fi.inline_data is not None:
            return None
        if _transformed(fi):
            return None
        if not segmod.segment_cache().admit(
            (id(es), bucket, obj, vid), time.monotonic()
        ):
            return None
        with self._mu:
            return self._inv_seq

    def segment_put(self, bucket: str, obj: str, vid: str, fi, pnum: int,
                    bi: int, data, token: int) -> None:
        """Insert one bitrot-verified decoded stripe block. Token check +
        insert under one _mu hold (same rationale as ``data_put``); disk
        demotion I/O runs after _mu is released."""
        from . import segment as segmod

        es = self._es()
        if es is None or not segmod.segments_enabled():
            return
        sc = segmod.segment_cache()
        with self._mu:
            if self._invalidated_since_locked((bucket, obj, vid), token):
                return
            victims, orphans = sc.put(
                es, bucket, obj, vid, fi, pnum, bi, data,
                self._epoch, time.monotonic(),
            )
        sc.demote(victims, orphans)

    def segment_observe(self, bucket: str, obj: str, vid: str,
                        start: int, length: int, fi) -> None:
        """Feed the sequential-read detector (cache/prefetch.py) with one
        observed request range; called from the ranged-GET read path for
        hits and misses alike. Only segment-ELIGIBLE objects are tracked
        — read-ahead over an object the tier will never admit is pure
        wasted I/O."""
        if fi.deleted or fi.size <= object_max():
            return
        if not fi.parts or fi.inline_data is not None:
            return
        if _transformed(fi):
            return  # never admitted (see segment_admit): don't read ahead
        from . import prefetch

        es = self._es()
        if es is not None:
            prefetch.observe(es, bucket, obj, vid, start, length)

    # -- choke-point mutations (the ONLY write API; see cache-discipline) --

    def invalidate_object(self, bucket: str, obj: str,
                          broadcast: bool = True) -> None:
        """Write-through invalidation for one object: every cached version
        of it (FileInfo + data tiers) drops, the bucket's listing
        metacache entries drop, and — unless this call IS a received
        broadcast — peers are told over the grid."""
        es = self._es()
        with self._mu:
            self._mark_invalidated_locked((bucket, obj))
            for key in list(self._by_obj.get((bucket, obj), ())):
                ev = self._fi.pop(key, None)
                if ev is not None:
                    _bytes_add(-ev.bytes)
                    self.fi_stats.invalidations += 1
            self._by_obj.pop((bucket, obj), None)
        if es is not None:
            _DATA.drop_where(
                lambda k: k[0] == id(es) and k[1] == bucket and k[2] == obj
            )
            from . import segment as segmod

            segmod.segment_cache().drop_where(
                lambda k: k[0] == id(es) and k[1] == bucket and k[2] == obj
            )
        from ..erasure import listing

        listing.invalidate_bucket(bucket)
        if broadcast and es is not None:
            from . import coherence

            coherence.broadcast_invalidate(
                es.pool_index, es.set_index, bucket, obj
            )

    def invalidate_prefix(self, bucket: str, prefix: str,
                          broadcast: bool = True) -> None:
        """Choke point for bulk out-of-band deletes (multipart cleanup,
        recursive prefix removals that bypass delete_object)."""
        es = self._es()
        with self._mu:
            self._mark_invalidated_locked(None)
            for key in [
                k for k in self._fi if k[0] == bucket and k[1].startswith(prefix)
            ]:
                ev = self._fi.pop(key)
                _bytes_add(-ev.bytes)
                self._unindex_locked(key)
                self.fi_stats.invalidations += 1
        if es is not None:
            _DATA.drop_where(
                lambda k: k[0] == id(es) and k[1] == bucket
                and k[2].startswith(prefix)
            )
            from . import segment as segmod

            segmod.segment_cache().drop_where(
                lambda k: k[0] == id(es) and k[1] == bucket
                and k[2].startswith(prefix)
            )
        from ..erasure import listing

        listing.invalidate_bucket(bucket)
        if broadcast and es is not None:
            from . import coherence

            coherence.broadcast_invalidate(
                es.pool_index, es.set_index, bucket, prefix, kind="prefix"
            )

    def invalidate_bucket(self, bucket: str, broadcast: bool = True) -> None:
        es = self._es()
        with self._mu:
            self._mark_invalidated_locked(None)
            for key in [k for k in self._fi if k[0] == bucket]:
                ev = self._fi.pop(key)
                _bytes_add(-ev.bytes)
                self._unindex_locked(key)
                self.fi_stats.invalidations += 1
        if es is not None:
            _DATA.drop_where(lambda k: k[0] == id(es) and k[1] == bucket)
            from . import segment as segmod

            segmod.segment_cache().drop_where(
                lambda k: k[0] == id(es) and k[1] == bucket
            )
        from ..erasure import listing

        listing.invalidate_bucket(bucket)
        if broadcast and es is not None:
            # bucket deletion/recreation must reach peers too, or they
            # keep serving cached objects of a deleted bucket
            from . import coherence

            coherence.broadcast_invalidate(
                es.pool_index, es.set_index, bucket, "", kind="bucket"
            )

    def bump_epoch(self) -> None:
        """Invalidate-by-suspicion: entries survive but must revalidate
        (cheap metadata probe) before their next serve. Used when a
        generation gap says some invalidation broadcast was lost."""
        with self._mu:
            self._epoch += 1
            self._mark_invalidated_locked(None)

    def clear(self) -> int:
        es = self._es()
        with self._mu:
            self._mark_invalidated_locked(None)
            n = len(self._fi)
            for ev in self._fi.values():
                _bytes_add(-ev.bytes)
            self._fi.clear()
            self._by_obj.clear()
        if es is not None:
            n += _DATA.drop_where(lambda k: k[0] == id(es))
            from . import segment as segmod

            n += segmod.segment_cache().drop_where(lambda k: k[0] == id(es))
        return n

    # -- observability -----------------------------------------------------

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "epoch": self._epoch,
                "fileinfoEntries": len(self._fi),
                "fileinfo": self.fi_stats.snapshot(),
            }


def store_caches(store) -> list[SetCache]:
    """Every SetCache reachable from an object-layer store."""
    out = []
    for pool in getattr(store, "pools", [store]):
        for s in getattr(pool, "sets", [pool]):
            c = getattr(s, "cache", None)
            if c is not None:
                out.append(c)
    return out


def aggregate_stats(store) -> dict:
    """Combined cache stats for one store (metrics v3 /api/cache and the
    admin cache/status endpoint)."""
    from ..erasure import listing

    fi = TierStats()
    entries = 0
    epoch = 0
    for c in store_caches(store):
        snap = c.snapshot()
        entries += snap["fileinfoEntries"]
        epoch = max(epoch, snap["epoch"])
        for k, v in snap["fileinfo"].items():
            setattr(fi, k, getattr(fi, k) + v)
    from . import prefetch
    from . import segment as segmod

    return {
        "enabled": enabled(),
        "epoch": epoch,
        "bytesTotal": _bytes_total(),
        "fileinfo": {**fi.snapshot(), "entries": entries},
        "data": {
            **_DATA.stats.snapshot(),
            "entries": _DATA.entry_count(),
            "bytes": _DATA.byte_count(),
        },
        "segments": segmod.segment_cache().snapshot(),
        "prefetch": prefetch.stats(),
        "listing": listing.metacache_stats(),
    }


def clear_store(store) -> int:
    """Admin cache/clear: drop every cached entry for this store."""
    from ..erasure import listing

    n = 0
    for c in store_caches(store):
        n += c.clear()
    n += listing.clear_metacache()
    return n


def _transformed(fi) -> bool:
    """True when the object's stored bytes are SSE/compression
    transformed — those responses read through one version-pinned handle
    in multiple passes, which the segment tier must not serve."""
    try:
        from ..server import transforms

        return transforms.is_transformed(fi.metadata)
    # fail-SAFE default: any failure (import cycle, malformed metadata)
    # steers OFF the segment fast path onto the full erasure read, which
    # serves correctly regardless
    except Exception:  # noqa: BLE001 — can't tell: stay off the fast path
        return True


def _resolve_range(range_hint, size: int) -> tuple[int, int] | None:
    """Resolve a syntactically-parsed Range hint against the object size
    — the same clamping the S3 layer's ``_parse_range`` applies, so a
    segment-cache hit serves byte-identical ranges to the erasure path.
    Returns (start, length) or None when the hint is unserveable (the
    caller falls through to the real path, which raises the proper S3
    error)."""
    if size <= 0:
        return None
    kind = range_hint[0]
    if kind == "suffix":
        n = range_hint[1]
        if n <= 0:
            return None
        start, end = max(size - n, 0), size - 1
    else:
        start = range_hint[1]
        end = range_hint[2] if range_hint[2] is not None else size - 1
        if start < 0 or start >= size or start > end:
            return None
        end = min(end, size - 1)
    return start, end - start + 1


def span_lookup(kind: str, bucket: str, obj: str, hit: bool):
    """One cache record on the request's span tree (zero-alloc NOOP when
    nobody is tracing)."""
    if not obs.active():
        return
    with obs.span(
        obs.TYPE_INTERNAL, f"cache.{kind}", bucket=bucket, object=obj
    ) as sp:
        sp.set(hit=hit)
