"""ErasureSet — one erasure stripe of K drives (L3 object semantics).

Behavioral mirror of the reference's erasureObjects
(MinIO cmd/erasure-object.go): quorum writes with atomic
rename-into-place, greedy degraded reads with bitrot verification and
on-the-fly reconstruction, versioned deletes with delete markers, and
object healing. Compute (RS encode/decode + bitrot digests) rides the
TPU coder (erasure/coder.py).
"""

from __future__ import annotations

import hashlib
import os
import threading
import uuid
from concurrent.futures import ALL_COMPLETED, FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import wait as _fut_wait
from typing import Callable, Iterator

import numpy as np

from .. import obs
from ..fault import registry as fault_registry
from ..ops.bitrot import DEFAULT_BITROT_ALGO
from ..storage import errors
from ..storage.errors import StorageError
from ..storage.datatypes import (
    ChecksumInfo,
    ErasureInfo,
    FileInfo,
    ObjectPartInfo,
    now_ns,
)
from ..storage.format import INLINE_DATA_THRESHOLD
from ..storage.interface import StorageAPI
from ..utils.hashing import hash_order
from . import bitrot_io, bufpool
from .coder import (
    BLOCK_SIZE,
    ErasureCoder,
    default_ec_family,
    family_stats_add,
)
from .quorum import (
    BucketExists,
    BucketNotFound,
    ObjectNotFound,
    QuorumError,
    VersionNotFound,
    count_none,
    find_file_info_in_quorum,
    object_quorum_from_meta,
    reduce_quorum_errs,
)
from .types import BucketInfo, ObjectInfo

TMP_VOLUME = ".minio.sys/tmp"
DIGEST = bitrot_io.DIGEST_SIZE

# namespace-lock deadline adapts to observed acquisition behaviour
# (qos/dyntimeout.py — the reference's globalOperationTimeout dynamic
# timeout): a contended cluster earns a looser deadline instead of
# spurious quorum errors, relaxing back once healthy. The floor equals
# the historical fixed deadline (30 s): healthy near-zero waits must
# never shrink the deadline below what lock HOLD times need — a holder
# legitimately runs seconds of encode+disk I/O (the reference keeps a
# 5-minute floor on its operation timeout for the same reason).
from ..qos.dyntimeout import DynamicTimeout

NS_LOCK_TIMEOUT = DynamicTimeout(30.0, minimum_s=30.0, name="ns-lock")


def _lock_dyn(mtx, write: bool = True) -> bool:
    """Acquire the namespace lock under the adaptive deadline, feeding the
    wait duration (or the timeout) back into the estimator."""
    import time as _time

    t0 = _time.monotonic()
    ok = (mtx.lock if write else mtx.rlock)(NS_LOCK_TIMEOUT.timeout())
    if ok:
        NS_LOCK_TIMEOUT.log_success(_time.monotonic() - t0)
    else:
        NS_LOCK_TIMEOUT.log_failure()
    return ok
# single source for the internal tag metadata key: the S3 layer stores it,
# the ILM scanner filters on it, this layer round-trips it
TAGS_META_KEY = "x-minio-internal-tags"


def _whole_file_hash(m: "FileInfo", part_number: int):
    """This drive's stored (digest, algorithm) for a part, or None when the
    shard uses the streaming format (reference cmd/bitrot-whole.go: legacy
    shards carry one metadata digest instead of interleaved frames). The
    stored algorithm matters: legacy data may be sha256/blake2b hashed."""
    from ..ops.bitrot import algorithm_from_string

    for c in m.erasure.checksums:
        if c.part_number == part_number and c.hash:
            return c.hash, algorithm_from_string(c.algorithm)
    return None


def _native_plane_enabled(device_active: bool = False) -> bool:
    """Native C++ streaming data plane (native/dataplane.cpp): used for the
    PUT/GET hot path whenever every target drive is local. One GIL-releasing
    pass replaces the per-block Python loop (the ~1000x
    kernel-to-server gap lived in this plumbing).

    MINIO_TPU_NATIVE_PLANE: "auto" (default) = take the native pass unless
    a device codec is active for this write (the TPU batching dispatcher is
    the accelerator plane; the native pass is the CPU plane); "1" = always;
    "0" = never.
    """
    mode = os.environ.get("MINIO_TPU_NATIVE_PLANE", "auto")
    if mode == "0":
        return False
    if mode != "1" and device_active:
        return False
    from .. import native

    return native.dataplane_available()

def _body_waits(reader):
    """The streaming PUT's body, each wait for its next chunk an
    ``erasure.put.body-wait`` span (blocked on the body pump's queue)."""
    it = iter(reader)
    while True:
        with obs.span(obs.TYPE_INTERNAL, "erasure.put.body-wait"):
            chunk = next(it, _END)
        if chunk is _END:
            return
        yield chunk


_END = object()


def _repair_windowed_enabled() -> bool:
    """MINIO_TPU_REPAIR_WINDOWED gates the windowed + hedged execution of
    partial-repair plans (degraded GET and heal). "0" keeps the original
    block-serial executor — the A/B baseline the BENCH_r12 wall-clock
    gate measures against; correctness is identical either way."""
    return os.environ.get("MINIO_TPU_REPAIR_WINDOWED", "1") != "0"


# shared shard-read pool: per-block shard reads of ALL in-flight GETs fan
# out here (the reference spawns per-shard goroutines; a bounded pool is
# the python equivalent)
_READ_POOL: ThreadPoolExecutor | None = None
_READ_POOL_LOCK = threading.Lock()


def _read_pool() -> ThreadPoolExecutor:
    global _READ_POOL
    if _READ_POOL is None:
        with _READ_POOL_LOCK:
            if _READ_POOL is None:
                # context-propagating: shard reads publish `storage` spans
                # that must carry the caller's trace request id
                _READ_POOL = obs.ContextPool(
                    max_workers=int(os.environ.get("MINIO_TPU_READ_WORKERS", "32")),
                    thread_name_prefix="shard-read",
                )
    return _READ_POOL


def default_parity_count(drive_count: int) -> int:
    """Default storage-class parity by set width (reference
    internal/config/storageclass defaults)."""
    if drive_count == 1:
        return 0
    if drive_count <= 3:
        return 1
    if drive_count <= 5:
        return 2
    if drive_count <= 7:
        return 3
    return 4


class ErasureSet:
    def __init__(
        self,
        disks: list[StorageAPI],
        default_parity: int | None = None,
        set_index: int = 0,
        pool_index: int = 0,
        ns_lock=None,
    ):
        from ..cluster.locks import NamespaceLock

        if len(disks) < 1:
            raise ValueError("need at least one drive")
        self.disks = list(disks)
        self.n = len(disks)
        self.set_index = set_index
        self.pool_index = pool_index
        self.default_parity = (
            default_parity if default_parity is not None else default_parity_count(self.n)
        )
        self.ns = ns_lock if ns_lock is not None else NamespaceLock()
        self._pool = obs.ContextPool(
            max_workers=max(4, self.n), thread_name_prefix="drive-io"
        )
        self._coders: dict[tuple[int, int, str], ErasureCoder] = {}
        # read-path degradation hook (MRF heal-on-read, reference cmd/mrf.go)
        self.on_degraded = None
        self._bucket_cache: dict[str, float] = {}
        # quorum-coherent caching layer (cache/): FileInfo + hot-object
        # tiers; every mutation below invalidates through its choke point
        from ..cache import SetCache

        self.cache = SetCache(self)

    # -- helpers -----------------------------------------------------------

    def coder(self, d: int, p: int, family: str = "reedsolomon") -> ErasureCoder:
        key = (d, p, family)
        if key not in self._coders:
            self._coders[key] = ErasureCoder(d, p, family=family)
        return self._coders[key]

    def coder_for(self, fi: FileInfo) -> ErasureCoder:
        """Codec for a STORED object: every decode/heal path dispatches
        on the family recorded in its xl.meta, so objects written under
        different MINIO_TPU_EC_FAMILY settings coexist on one set. An
        unknown family string raises the typed UnknownErasureFamily
        (never a misread frame)."""
        family = bitrot_io.check_family(
            fi.erasure.algorithm or bitrot_io.FAMILY_RS
        )
        return self.coder(
            fi.erasure.data_blocks, fi.erasure.parity_blocks, family
        )

    def _hedge_budget_s(self) -> float | None:
        """Straggler budget for hedged shard reads, or None when hedging
        is off. EWMA-derived: a multiple of the MEDIAN per-drive smoothed
        latency (HealthCheckedDisk accounting), floored so a cold/fast
        cluster doesn't hedge on noise. The median keeps one straggling
        drive from inflating its own budget."""
        if os.environ.get("MINIO_TPU_HEDGE", "1") == "0":
            return None
        # malformed tuning falls back to defaults: a chaos-knob typo must
        # not take down the GET path
        try:
            floor = float(os.environ.get("MINIO_TPU_HEDGE_MIN_MS", "50")) / 1e3
        except ValueError:
            floor = 0.05
        try:
            mult = float(os.environ.get("MINIO_TPU_HEDGE_MULT", "4"))
        except ValueError:
            mult = 4.0
        ews = sorted(
            e for e in (
                getattr(d, "ewma_latency", lambda: 0.0)() for d in self.disks
            ) if e > 0.0
        )
        if not ews:
            return floor
        return max(floor, mult * ews[len(ews) // 2])

    def _parallel(self, fn: Callable[[StorageAPI], object]) -> list:
        """Run fn on every drive concurrently; returns [(result|None, err|None)]."""

        def run(disk):
            try:
                return fn(disk), None
            except Exception as e:  # noqa: BLE001 — drive faults become errors
                return None, e

        return list(self._pool.map(run, self.disks))

    # -- buckets -----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        res = self._parallel(lambda d: d.make_vol(bucket))
        errs = [e for _, e in res]
        if all(isinstance(e, errors.VolumeExists) for e in errs if e is not None) and any(
            e is not None for e in errs
        ):
            if count_none(errs) == 0:
                raise BucketExists(bucket)
        reduce_quorum_errs(errs, self.n // 2 + 1, ignored=(errors.VolumeExists,))

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        self._bucket_cache.pop(bucket, None)
        self.cache.invalidate_bucket(bucket)
        res = self._parallel(lambda d: d.delete_vol(bucket, force=force))
        errs = [e for _, e in res]
        for e in errs:
            if isinstance(e, errors.VolumeNotEmpty):
                from .quorum import BucketNotEmpty

                raise BucketNotEmpty(bucket)
        reduce_quorum_errs(errs, self.n // 2 + 1, ignored=(errors.VolumeNotFound,))

    _BUCKET_CACHE_TTL = 30.0

    def bucket_exists(self, bucket: str) -> bool:
        # read-quorum semantics: half the drives answering is enough to
        # know the bucket exists (writes still enforce write quorum).
        # Positive answers cache briefly so the hot PUT path doesn't pay a
        # stat fan-out per request (negatives never cache: another node may
        # have just created the bucket).
        import time as _time

        hit = self._bucket_cache.get(bucket)
        if hit is not None and _time.monotonic() - hit < self._BUCKET_CACHE_TTL:
            return True
        res = self._parallel(lambda d: d.stat_vol(bucket))
        ok = count_none([e for _, e in res]) >= max(self.n // 2, 1)
        if ok:
            self._bucket_cache[bucket] = _time.monotonic()
        return ok

    def list_buckets(self) -> list[BucketInfo]:
        for disk, (vols, err) in zip(self.disks, self._parallel(lambda d: d.list_vols())):
            if err is None:
                return [
                    BucketInfo(v.name, v.created)
                    for v in vols
                    if not v.name.startswith(".minio.sys")
                ]
        return []

    # -- metadata reads ----------------------------------------------------

    def _read_all_fileinfo(
        self, bucket: str, obj: str, version_id: str, read_data: bool = False
    ) -> tuple[list[FileInfo | None], list[Exception | None]]:
        res = self._parallel(
            lambda d: d.read_version(bucket, obj, version_id, read_data=read_data)
        )
        return [r for r, _ in res], [e for _, e in res]

    def _quorum_fileinfo(
        self, bucket: str, obj: str, version_id: str, read_data: bool = False
    ) -> tuple[FileInfo, list[FileInfo | None], int, int]:
        metas, errs = self._read_all_fileinfo(bucket, obj, version_id, read_data)
        read_q, write_q = object_quorum_from_meta(metas, errs, self.n, self.default_parity)
        reduce_quorum_errs(errs, read_q)
        fi = find_file_info_in_quorum(metas, read_q)
        return fi, metas, read_q, write_q

    def _cached_fileinfo(
        self, bucket: str, obj: str, version_id: str
    ) -> tuple[FileInfo, list[FileInfo | None]]:
        """Read-path quorum metadata via the FileInfo cache: hot keys skip
        the N-drive fan-out; concurrent misses singleflight one quorum
        read (read_data=True so GET and HEAD share one entry). Mutation
        paths keep calling ``_quorum_fileinfo`` directly — they read
        under the write lock and must see authoritative state."""

        def load():
            fi, metas, _, _ = self._quorum_fileinfo(
                bucket, obj, version_id, read_data=True
            )
            return fi, metas

        return self.cache.fileinfo(bucket, obj, version_id, load)

    # -- put ---------------------------------------------------------------

    def put_object(
        self,
        bucket: str,
        obj: str,
        data: bytes,
        user_defined: dict[str, str] | None = None,
        version_id: str | None = None,
        versioned: bool = False,
        parity: int | None = None,
        distribution: list[int] | None = None,
        allow_inline: bool = True,
        check_precond=None,
        family: str | None = None,
    ) -> ObjectInfo:
        """distribution/allow_inline overrides serve the multipart plane:
        all parts of an upload must share the final object's shard layout
        and be rename-able files (never inline). check_precond(current
        ObjectInfo | None) runs UNDER the namespace write lock — the
        conditional-write hook (PUT If-Match / If-None-Match, reference
        checkPreconditionsPUT) with no TOCTOU window. ``family`` picks
        the erasure code family (per-storage-class mapping in the S3
        layer); None uses MINIO_TPU_EC_FAMILY."""
        if not self.bucket_exists(bucket) and not bucket.startswith(".minio.sys"):
            raise BucketNotFound(bucket)
        with obs.span(
            obs.TYPE_INTERNAL, "erasure.put_object", bucket=bucket, object=obj
        ):
            mtx = self.ns.new(bucket, obj)
            if not _lock_dyn(mtx, write=True):
                raise QuorumError(f"namespace write lock timeout on {bucket}/{obj}")
            try:
                if check_precond is not None:
                    try:
                        fi, _, _, _ = self._quorum_fileinfo(
                            bucket, obj, "", read_data=False
                        )
                        cur = None if fi.deleted else self._to_object_info(
                            bucket, obj, fi
                        )
                    except (ObjectNotFound, VersionNotFound):
                        cur = None
                    check_precond(cur)  # raises to abort before any write
                # active refresh with loss abort: a partitioned holder must
                # stop writing once the cluster no longer holds its lock
                # (reference internal/dsync/drwmutex.go:340 refreshLock).
                # Only long-running writes need it — a refresher thread per
                # millisecond PUT would be pure overhead against the 120 s
                # TTL.
                long_running = not isinstance(data, (bytes, bytearray, memoryview)) \
                    or len(data) > (8 << 20)
                if long_running:
                    mtx.start_refresher(write=True)
                oi = self._put_object_locked(
                    bucket, obj, data, user_defined, version_id, versioned,
                    parity, distribution, allow_inline, lock=mtx,
                    family=family,
                )
            finally:
                mtx.unlock()
            # write-through invalidation AFTER the lock releases but
            # BEFORE the PUT returns: the cross-node broadcast (seconds
            # on a blackholed peer) must never inflate lock hold time,
            # and a reader overlapping this window may legitimately
            # serve the pre-overwrite version — the PUT hasn't returned.
            # Loaders racing this are rejected by the cache's
            # invalidation-sequence guard.
            self.cache.invalidate_object(bucket, obj)
            return oi

    def _put_object_locked(
        self,
        bucket: str,
        obj: str,
        data: bytes,
        user_defined: dict[str, str] | None,
        version_id: str | None,
        versioned: bool,
        parity: int | None,
        distribution: list[int] | None,
        allow_inline: bool,
        lock=None,
        family: str | None = None,
    ) -> ObjectInfo:
        family = family or default_ec_family()
        if not isinstance(data, (bytes, bytearray, memoryview)):
            return self._put_object_streaming(
                bucket, obj, data, user_defined, version_id, versioned,
                parity, distribution, lock=lock, family=family,
            )
        p = self.default_parity if parity is None else parity
        d = self.n - p
        if (
            len(data) > INLINE_DATA_THRESHOLD
            and family == bitrot_io.FAMILY_RS
            and _native_plane_enabled(self.coder(d, p).device_active)
            and all(dk.local_path(TMP_VOLUME, "x") is not None for dk in self.disks)
        ):
            # large buffered bodies (signed-payload PUTs) also take the
            # native C++ pass; small ones keep the inline fast path.
            # (The native plane speaks the single-frame reedsolomon
            # format only; other families stream through the coder.)
            return self._put_object_streaming(
                bucket, obj, iter([data]), user_defined, version_id, versioned,
                parity, distribution, lock=lock, family=family,
            )
        write_q = d + 1 if d == p else d

        fi = FileInfo(volume=bucket, name=obj)
        fi.version_id = version_id if version_id is not None else (
            str(uuid.uuid4()) if versioned else ""
        )
        fi.mod_time = now_ns()
        fi.size = len(data)
        fi.metadata = dict(user_defined or {})
        etag = hashlib.md5(data).hexdigest()
        fi.metadata.setdefault("etag", etag)
        fi.erasure = ErasureInfo(
            algorithm=family,
            data_blocks=d,
            parity_blocks=p,
            block_size=BLOCK_SIZE,
            distribution=distribution or hash_order(f"{bucket}/{obj}", self.n),
            checksums=[ChecksumInfo(1, DEFAULT_BITROT_ALGO.string)],
        )
        fi.parts = [ObjectPartInfo(1, len(data), len(data), fi.mod_time, etag)]

        encoded = self.coder(d, p, family).encode_part(data)
        if lock is not None and lock.lost:
            raise QuorumError(f"write lock on {bucket}/{obj} lost; aborting")
        inline = allow_inline and len(data) <= INLINE_DATA_THRESHOLD
        if not inline:
            fi.data_dir = str(uuid.uuid4())

        tmp_id = str(uuid.uuid4())

        def write_one(i: int, disk: StorageAPI):
            shard_idx = fi.erasure.distribution[i] - 1
            dfi = FileInfo.from_dict(fi.to_dict())
            dfi.volume, dfi.name = bucket, obj
            dfi.erasure.index = shard_idx + 1
            if inline:
                dfi.inline_data = encoded.shard_files[shard_idx]
                disk.write_metadata(bucket, obj, dfi)
            else:
                stage = f"{tmp_id}/{fi.data_dir}/part.1"
                disk.create_file(TMP_VOLUME, stage, encoded.shard_files[shard_idx])
                disk.rename_data(TMP_VOLUME, tmp_id, dfi, bucket, obj)

        errs: list[Exception | None] = []
        with obs.span(obs.TYPE_INTERNAL, "erasure.put.drives"):
            futs = [
                self._pool.submit(write_one, i, disk)
                for i, disk in enumerate(self.disks)
            ]
            for f in futs:
                try:
                    f.result()
                    errs.append(None)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
        try:
            reduce_quorum_errs(errs, write_q)
        except Exception:
            # quorum failed: undo partial writes so no durable garbage
            # remains (reference deletes the partial object on quorum loss)
            for disk, err in zip(self.disks, errs):
                try:
                    if err is None:
                        disk.delete_version(bucket, obj, fi)
                    disk.delete(TMP_VOLUME, tmp_id, recursive=True)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            raise
        # quorum passed, but a minority drive may have staged its shard
        # and then failed before rename_data swept the staging dir — the
        # staged bytes must not outlive the PUT (the streaming path
        # sweeps the same way after its commit)
        self._sweep_staging(
            tmp_id, (d for d, e in zip(self.disks, errs) if e is not None)
        )
        return self._to_object_info(bucket, obj, fi)

    def _put_object_streaming(
        self,
        bucket: str,
        obj: str,
        reader,
        user_defined: dict[str, str] | None,
        version_id: str | None,
        versioned: bool,
        parity: int | None,
        distribution: list[int] | None,
        lock=None,
        family: str | None = None,
    ) -> ObjectInfo:
        """Bounded-memory PUT: encode batches of stripe blocks as they
        arrive and append shard-file chunks to each drive's staged part
        file — a part is never fully resident (the reference streams
        block-by-block through a ring buffer,
        MinIO cmd/bitrot-streaming.go:108-133). Never inlines.
        """
        family = family or default_ec_family()
        p = self.default_parity if parity is None else parity
        d = self.n - p
        write_q = d + 1 if d == p else d

        fi = FileInfo(volume=bucket, name=obj)
        fi.version_id = version_id if version_id is not None else (
            str(uuid.uuid4()) if versioned else ""
        )
        fi.mod_time = now_ns()
        fi.metadata = dict(user_defined or {})
        fi.erasure = ErasureInfo(
            algorithm=family,
            data_blocks=d,
            parity_blocks=p,
            block_size=BLOCK_SIZE,
            distribution=distribution or hash_order(f"{bucket}/{obj}", self.n),
            checksums=[ChecksumInfo(1, DEFAULT_BITROT_ALGO.string)],
        )
        fi.data_dir = str(uuid.uuid4())
        tmp_id = str(uuid.uuid4())
        stage = f"{tmp_id}/{fi.data_dir}/part.1"
        coder = self.coder(d, p, family)
        md5 = hashlib.md5()
        size = 0
        # a drive that fails once stops receiving appends (its staged file
        # would be torn); quorum judged at the end
        errs: list[Exception | None] = [None] * self.n

        def drive_op(i: int, fn, *args):
            if errs[i] is None:
                try:
                    fn(*args)
                except Exception as e:  # noqa: BLE001
                    errs[i] = e

        def fan_out(calls) -> None:
            """Submit one drive op per drive and join them all: the
            request's view of drive I/O."""
            with obs.span(obs.TYPE_INTERNAL, "erasure.put.drives"):
                for f in [self._pool.submit(drive_op, *c) for c in calls]:
                    f.result()

        reader = _body_waits(reader)
        fan_out((i, disk.create_file, TMP_VOLUME, stage, b"")
                for i, disk in enumerate(self.disks))
        renamed = False  # whether any rename_data may have landed
        stream_cap = int(os.environ.get("MINIO_TPU_STREAM_BATCH_MB", "64")) << 20
        # native C++ single-pass plane when every drive is local + healthy
        # (reedsolomon framing only — sub-packetized families stream
        # through the coder's python/device path)
        native_paths: list[str] | None = None
        if family == bitrot_io.FAMILY_RS and _native_plane_enabled(
            coder.device_active
        ) and all(
            e is None for e in errs
        ):
            native_paths = [""] * self.n
            for i, disk in enumerate(self.disks):
                lp = disk.local_path(TMP_VOLUME, stage)
                if lp is None:
                    native_paths = None
                    break
                native_paths[fi.erasure.distribution[i] - 1] = lp
        try:
            if native_paths is not None:
                etag, size = self._stream_native(
                    native_paths, reader, coder, fi, errs, write_q, lock,
                    bucket, obj,
                )
            else:
                # zero-copy plane: reader chunks accumulate straight into
                # pooled arenas in dispatcher geometry; shard appends are
                # writev vectors of encode-output views. Each batch's
                # arena is released only after md5 + every drive append
                # completed (drive_op futures joined) — a mid-PUT drive
                # failure can therefore never recycle a referenced arena.
                # process-global site counters: the delta is this PUT's
                # copies plus any concurrent traffic — an attribution
                # signal for the obs stream, not an exact per-request bill
                copies0 = bufpool.copies_snapshot() if obs.active() else None
                batch = None
                try:
                    for batch in coder.iter_encode_zc(
                        reader, max_batch_bytes=stream_cap
                    ):
                        if lock is not None and lock.lost:
                            raise QuorumError(
                                f"write lock on {bucket}/{obj} lost mid-stream;"
                                " aborting"
                            )
                        md5.update(batch.raw)
                        size += len(batch.raw)
                        dist = fi.erasure.distribution
                        fan_out(
                            (i, disk.append_file, TMP_VOLUME, stage,
                             batch.shard_vecs[dist[i] - 1])
                            for i, disk in enumerate(self.disks)
                        )
                        batch.release()
                        batch = None
                        if sum(e is None for e in errs) < write_q:
                            raise QuorumError("write quorum lost mid-stream")
                finally:
                    if batch is not None:
                        batch.release()
                etag = md5.hexdigest()
                if copies0 is not None:
                    import time as _time

                    copies1 = bufpool.copies_snapshot()
                    obs.publish({
                        "time": _time.time(),
                        "type": obs.TYPE_TPU,
                        "name": "copy.site",
                        "node": obs.trace.NODE,
                        "bytes": size,
                        "zerocopy": bufpool.zerocopy_enabled(),
                        "sites": {
                            s: copies1[s] - copies0.get(s, 0)
                            for s in copies1
                            if copies1[s] - copies0.get(s, 0)
                        },
                    })

            fi.size = size
            fi.metadata.setdefault("etag", etag)
            fi.parts = [ObjectPartInfo(1, size, size, fi.mod_time, etag)]

            def commit_one(i: int, disk: StorageAPI):
                shard_idx = fi.erasure.distribution[i] - 1
                dfi = FileInfo.from_dict(fi.to_dict())
                dfi.volume, dfi.name = bucket, obj
                dfi.erasure.index = shard_idx + 1
                disk.rename_data(TMP_VOLUME, tmp_id, dfi, bucket, obj)

            if lock is not None and lock.lost:
                raise QuorumError(
                    f"write lock on {bucket}/{obj} lost before commit; aborting"
                )
            renamed = True
            fan_out((i, commit_one, i, disk) for i, disk in enumerate(self.disks))
            reduce_quorum_errs(errs, write_q)
        except Exception:
            for disk, err in zip(self.disks, errs):
                try:
                    # only roll back committed renames: a failure BEFORE the
                    # rename phase must never touch the pre-existing object
                    # (deleting the null version here would destroy the live
                    # object an aborted overwrite never replaced)
                    if renamed and err is None:
                        disk.delete_version(bucket, obj, fi)
                    disk.delete(TMP_VOLUME, tmp_id, recursive=True)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            raise
        self._sweep_staging(tmp_id, self.disks)
        return self._to_object_info(bucket, obj, fi)

    def _stream_native(
        self,
        paths: list[str],
        reader,
        coder: ErasureCoder,
        fi: FileInfo,
        errs: list[Exception | None],
        write_q: int,
        lock,
        bucket: str,
        obj: str,
    ) -> tuple[str, int]:
        """Drive the C++ streaming PUT plane: md5 + stripe split + GF parity
        + bitrot hashing + shard-file framing + writes happen in one
        GIL-releasing native pass per chunk (native/dataplane.cpp; the
        reference's cmd/erasure-encode.go:76-108 pipeline). Returns
        (md5-hex etag, size); drive failures land in errs by disk position.
        """
        from .. import native
        from ..ops.highwayhash import MINIO_KEY

        ctx = native.DataplanePut(
            coder.d, coder.p, coder.block_size, coder._np.parity_matrix,
            MINIO_KEY, paths,
        )
        size = 0
        try:
            for chunk in reader:
                if not chunk:
                    continue
                if lock is not None and lock.lost:
                    raise QuorumError(
                        f"write lock on {bucket}/{obj} lost mid-stream; aborting"
                    )
                ctx.feed(chunk)
                size += len(chunk)
                if ctx.alive() < write_q:
                    raise QuorumError("write quorum lost mid-stream")
            etag, dead = ctx.finish()
        except BaseException:
            ctx.abort()
            raise
        for i in range(self.n):
            if (dead >> (fi.erasure.distribution[i] - 1)) & 1:
                errs[i] = OSError("native shard write failed")
        if sum(e is None for e in errs) < write_q:
            raise QuorumError("write quorum lost")
        if size:
            # the native plane bypasses the coder, so count its stripe
            # blocks here — the per-family encode series must reflect
            # RS traffic served by C++ too
            family_stats_add(
                bitrot_io.FAMILY_RS, "encode_blocks",
                -(-size // coder.block_size),
            )
        return etag, size

    def _sweep_staging(self, tmp_id: str, disks) -> None:
        """Best-effort removal of a staging dir on drives whose
        rename_data never ran or failed (rename sweeps its own dir):
        staged shard bytes must not outlive the operation that wrote
        them — a partially-failed drive would otherwise keep a full
        shard copy under .minio.sys/tmp until manual cleanup."""
        for disk in disks:
            try:
                disk.delete(TMP_VOLUME, tmp_id, recursive=True)
            except (StorageError, OSError):
                pass  # already gone / drive offline: nothing to sweep

    # -- get ---------------------------------------------------------------

    def get_object_info(self, bucket: str, obj: str, version_id: str = "") -> ObjectInfo:
        fi, _ = self._cached_fileinfo(bucket, obj, version_id)
        if fi.deleted:
            if not version_id:
                raise ObjectNotFound(f"{bucket}/{obj}")
            return self._to_object_info(bucket, obj, fi)
        return self._to_object_info(bucket, obj, fi)

    def open_object(
        self, bucket: str, obj: str, version_id: str = "",
        range_hint=None,
    ) -> tuple[ObjectInfo, "ObjectHandle"]:
        """One quorum metadata read under a namespace read lock; the handle
        serves any number of ranged reads without re-reading metadata.
        Hot objects short-circuit both: a data-cache hit serves an
        immutable verified snapshot from memory — no lock, no metadata
        fan-out, no shard I/O (invalidation through the cache choke point
        happens under the writer's lock BEFORE it releases, so any entry
        found here was the live version when the lookup happened).

        ``range_hint`` is the syntactically-parsed Range header of a
        ranged GET (``("abs", start, end|None)`` / ``("suffix", n)``):
        when every stripe-block segment covering the range is cached
        (range-segment tier, objects far above the whole-object size
        gate), the same short-circuit applies."""
        hit = self.cache.data_get(bucket, obj, version_id)
        if hit is not None:
            fi, data = hit
            from ..cache.core import span_lookup

            span_lookup("object", bucket, obj, True)
            return (
                self._to_object_info(bucket, obj, fi),
                CachedObjectHandle(fi, data),
            )
        if range_hint is not None:
            seg = self.cache.segment_open(bucket, obj, version_id, range_hint)
            if seg is not None:
                fi, start, length, rows = seg
                return (
                    self._to_object_info(bucket, obj, fi),
                    SegmentCachedObjectHandle(
                        self, bucket, obj, version_id, fi, start, length,
                        rows,
                    ),
                )
        with obs.span(
            obs.TYPE_INTERNAL, "erasure.open_object", bucket=bucket, object=obj
        ):
            mtx = self.ns.new(bucket, obj)
            if not _lock_dyn(mtx, write=False):
                raise QuorumError(f"namespace read lock timeout on {bucket}/{obj}")
            try:
                fi, metas = self._cached_fileinfo(bucket, obj, version_id)
                if fi.deleted:
                    raise ObjectNotFound(f"{bucket}/{obj}")
                oi = self._to_object_info(bucket, obj, fi)
                # the read lock stays held while the handle streams (the
                # reference holds GetObject's lock until the reader closes)
                # and is refreshed during long streams; the TTL backstops
                # abandoned handles
                return oi, ObjectHandle(
                    self, bucket, obj, fi, metas, mutex=mtx,
                    requested_vid=version_id,
                )
            except BaseException:
                # everything up to handle construction releases on failure;
                # a raise after lock ownership transferred would
                # double-release
                mtx.runlock()
                raise

    def get_object(
        self,
        bucket: str,
        obj: str,
        version_id: str = "",
        offset: int = 0,
        length: int = -1,
    ) -> tuple[ObjectInfo, Iterator[bytes]]:
        oi, h = self.open_object(bucket, obj, version_id)
        return oi, h.read(offset, length)

    def _shard_sources(
        self, fi: FileInfo, metas: list[FileInfo | None]
    ) -> dict[int, tuple[StorageAPI, FileInfo]]:
        """erasure shard index -> (drive, its FileInfo), for consistent metas."""
        out: dict[int, tuple[StorageAPI, FileInfo]] = {}
        for disk, m in zip(self.disks, metas):
            if m is None or not m.is_valid() or m.deleted:
                continue
            if m.mod_time != fi.mod_time or m.data_dir != fi.data_dir:
                continue
            idx = m.erasure.index - 1
            if 0 <= idx < self.n and idx not in out:
                out[idx] = (disk, m)
        return out

    def _read_range(
        self,
        bucket: str,
        obj: str,
        fi: FileInfo,
        metas: list[FileInfo | None],
        offset: int,
        length: int,
        seg_sink=None,
    ) -> Iterator[bytes]:
        """Span shim over ``_read_range_inner``: the stripe verify +
        reconstruct compute is the GET path's kernel stage, traced as one
        ``tpu`` span covering the generator's whole life (entered at first
        chunk, closed on exhaustion or client disconnect)."""
        with obs.span(
            obs.TYPE_TPU, "stripe.read-verify",
            bucket=bucket, object=obj, offset=offset, bytes=length,
            family=fi.erasure.algorithm or "reedsolomon",
        ):
            yield from self._read_range_inner(
                bucket, obj, fi, metas, offset, length, seg_sink
            )

    def _read_range_inner(
        self,
        bucket: str,
        obj: str,
        fi: FileInfo,
        metas: list[FileInfo | None],
        offset: int,
        length: int,
        seg_sink=None,
    ) -> Iterator[bytes]:
        """Windowed parallel striped read: per-shard reads fan out on a
        thread pool (greedy data-first, parity spill on failure), whole
        windows of same-pattern blocks reconstruct in ONE batched matrix
        apply, and the next window's reads start before the current one is
        decoded (readahead). Mirrors the reference's parallelReader +
        readahead (MinIO cmd/erasure-decode.go:32,127-235,
        cmd/erasure-object.go:1429) but trades its per-block goroutine
        choreography for window-batched decode — the TPU-shaped version.
        Spans multiple parts (each part is its own erasure stream).

        ``seg_sink(part#, block#, block_bytes)``: every stripe block the
        read fully materializes (verified + decoded) is offered to the
        range-segment cache — a partial first/last block of a native
        span is offered too and rejected there by length."""
        if length == 0:
            return
        d = fi.erasure.data_blocks
        coder = self.coder_for(fi)  # typed rejection of unknown families
        family = coder.family
        fdig = coder.frame_digests * DIGEST  # digest bytes per block frame group
        sources = self._shard_sources(fi, metas)
        bad: set[int] = set()
        degraded_reported = False

        def report_degraded():
            nonlocal degraded_reported
            if not degraded_reported and self.on_degraded is not None:
                degraded_reported = True
                try:
                    self.on_degraded(bucket, obj)
                # miniovet: ignore[error-taint] -- observer callback
                # isolation: a failing heal-enqueue hook must never fail
                # the GET it was observing
                except Exception:  # noqa: BLE001
                    pass

        if len(sources) < self.n:
            report_degraded()  # some drive lacks this version entirely

        # legacy whole-file shards: raw bytes on disk, one digest in the
        # drive's metadata; read+verify the whole shard once per part.
        # Futures memoize the load so the read pool's concurrent blocks
        # share ONE read+hash instead of racing past a bare dict check.
        from concurrent.futures import Future

        whole_cache: dict[tuple[int, int], Future] = {}
        whole_lock = threading.Lock()

        def read_whole_shard(idx: int, part_num: int, wh, algo) -> bytes:
            k = (idx, part_num)
            with whole_lock:
                fut = whole_cache.get(k)
                owner = fut is None
                if owner:
                    fut = whole_cache[k] = Future()
            if owner:
                try:
                    disk, m = sources[idx]
                    raw = m.inline_data if m.inline_data else disk.read_file(
                        bucket, f"{obj}/{fi.data_dir}/part.{part_num}", 0, -1
                    )
                    fut.set_result(
                        bitrot_io.verify_whole_file(bytes(raw), wh, algo)
                    )
                except Exception as e:  # noqa: BLE001 — typed via the future
                    fut.set_exception(e)
            return fut.result()

        # zero-copy gather: verified shard payloads flow as views of the
        # read buffer (reedsolomon frames; cauchy's interleaved digests
        # make its one assembly copy inherent), and blocks assemble ONCE
        # into a pre-sized buffer served as a memoryview slice
        zc = bufpool.zerocopy_enabled()

        def serve_slice(buf: bytearray, a: int, b: int):
            """Slice an assembled (GC-owned, never recycled) block for
            the response: a view when zero-copy, bytes on the A/B path."""
            return memoryview(buf)[a:b] if zc else bytes(memoryview(buf)[a:b])

        def read_shard_block(part_num: int, idx: int, per: int, f_off: int):
            disk, m = sources[idx]
            wf = _whole_file_hash(m, part_num)
            if wf is not None:
                block_i = f_off // (fdig + coder.shard_size)
                data = read_whole_shard(idx, part_num, *wf)
                blk = data[block_i * coder.shard_size:][:per]
                if len(blk) != per:
                    raise errors.FileCorrupt("short whole-file shard")
                return blk
            if m.inline_data:
                buf = m.inline_data[f_off : f_off + fdig + per]
            else:
                buf = disk.read_file(
                    bucket, f"{obj}/{fi.data_dir}/part.{part_num}", f_off, fdig + per
                )
            return bitrot_io.verify_block(buf, per, family=family, view=zc)

        def read_sub_chunk(
            part_num: int, idx: int, per: int, f_off: int, which: int
        ) -> np.ndarray:
            """Partial-repair read unit: ONE digest||sub-chunk frame of a
            sub-packetized shard block (the other half never moves)."""
            disk, m = sources[idx]
            rel, dlen = bitrot_io.sub_chunk_in_block(per, which)
            off = f_off + rel
            if m.inline_data:
                buf = m.inline_data[off : off + DIGEST + dlen]
            else:
                buf = disk.read_file(
                    bucket, f"{obj}/{fi.data_dir}/part.{part_num}",
                    off, DIGEST + dlen,
                )
            return np.frombuffer(
                bitrot_io.verify_sub_chunk(bytes(buf), dlen), dtype=np.uint8
            )

        # ---- partial-repair plan: sub-packetized family, exactly one ----
        # data shard gone, every helper present — degraded reads fetch
        # the repair fraction instead of d full shards (ops/cauchy.py
        # schedule; any failure inside the plan falls back to the
        # generic full-gather path below, correctness never rides it)
        repair_sched = None
        if family == bitrot_io.FAMILY_CAUCHY and not any(
            c.hash for c in fi.erasure.checksums
        ):
            missing_data = [i for i in range(d) if i not in sources]
            if len(missing_data) == 1:
                sched = coder.repair_schedule(missing_data[0])
                if sched is not None and all(
                    h in sources for h in sched.helpers
                ):
                    repair_sched = sched

        def repair_read_block(
            pnum: int, per: int, f_off: int, lo: int, hi: int
        ):
            """Serve [lo, hi) of one stripe block under the repair plan:
            full frames only for the data shards the range needs, the
            schedule's sub-chunk frames to rebuild the lost one."""
            i_m = repair_sched.missing
            lo_sh, hi_sh = lo // per, (hi - 1) // per
            needed = list(range(lo_sh, min(hi_sh, d - 1) + 1))
            ingress = 0
            full_idx = set(idx for idx in needed if idx != i_m)
            if i_m in needed:
                # every group mate is also a b_helper, so it needs BOTH
                # sub-chunks — one contiguous frame-group read moves the
                # same bytes as two sub-chunk reads with half the
                # round-trips
                full_idx.update(repair_sched.mates)
            full_futs = {
                idx: pool.submit(read_shard_block, pnum, idx, per, f_off)
                for idx in full_idx
            }
            sub_futs = {}
            if i_m in needed:
                for r in repair_sched.b_helpers:
                    if r not in full_futs:
                        sub_futs[(r, 1)] = pool.submit(
                            read_sub_chunk, pnum, r, per, f_off, 1
                        )
                sub_futs[(repair_sched.pb_parity, 1)] = pool.submit(
                    read_sub_chunk, pnum, repair_sched.pb_parity, per, f_off, 1
                )
            try:
                got_full = {
                    idx: np.frombuffer(f.result(), dtype=np.uint8)
                    for idx, f in full_futs.items()
                }
            except BaseException:
                # a failed full read fails the plan (caller falls back to
                # the generic gather): don't leave sub-chunk reads queued
                for f in sub_futs.values():
                    f.cancel()
                raise
            if i_m in needed:
                # same semantics as the generic path's counter: EVERY
                # frame fetched for a block that needs reconstruction —
                # full frames the range needed anyway included — so the
                # per-family comparison stays apples-to-apples
                ingress += len(got_full) * (fdig + per)
                h1, h2 = bitrot_io.sub_lens(per)
                sub2 = {}
                for r in repair_sched.b_helpers:
                    sub2[r] = (
                        got_full[r][h1:] if r in got_full
                        else sub_futs[(r, 1)].result()
                    )
                    ingress += DIGEST + h2 if r not in got_full else 0
                pb = sub_futs[(repair_sched.pb_parity, 1)].result()
                ingress += DIGEST + h2
                # mates were fetched as full frame groups above
                sub1 = {r: got_full[r][:h1] for r in repair_sched.mates}
                got_full[i_m] = coder.repair_data_shard(
                    repair_sched, per, sub2, pb, sub1
                )
                family_stats_add(family, "degraded_ingress_bytes", ingress)
            # single pre-sized assembly (was .tobytes() per shard +
            # b"".join — two full copies of every block)
            out = bytearray(len(needed) * per)
            mv = memoryview(out)
            for j, idx in enumerate(needed):
                mv[j * per : (j + 1) * per] = got_full[idx]
            bufpool.count_copy("gather-join")
            return serve_slice(out, lo - lo_sh * per, hi - lo_sh * per)

        # ---- plan: every stripe block overlapping [offset, offset+length) ----
        plan: list[tuple[int, int, int, int, int]] = []  # (part#, per, f_off, lo, hi)
        pos = 0
        remaining = length
        for part in fi.parts:
            if remaining <= 0:
                break
            if pos + part.size <= offset:
                pos += part.size
                continue
            bpos = pos
            for block_i, (data_len, per) in enumerate(coder.shard_sizes_for(part.size)):
                if remaining <= 0:
                    break
                if bpos + data_len <= offset:
                    bpos += data_len
                    continue
                lo = max(offset - bpos, 0)
                hi = min(lo + remaining, data_len)
                if hi > lo:
                    f_off = bitrot_io.block_offset(
                        coder.shard_size, block_i, family
                    )
                    plan.append((part.number, per, f_off, lo, hi))
                    remaining -= hi - lo
                bpos += data_len
            pos += part.size

        # ---- native fast path: every data shard local, present, on-disk ----
        # One C++ pass per span does pread + bitrot verify + window assembly
        # (native/dataplane.cpp dp_get_span); any failure falls back to the
        # reconstructing windowed path below for the remaining plan.
        # reedsolomon framing only: dp_get_span walks digest||block frames.
        if plan and family == bitrot_io.FAMILY_RS and _native_plane_enabled() and all(
            i in sources and not sources[i][1].inline_data
            and not any(c.hash for c in sources[i][1].erasure.checksums)
            for i in range(d)
        ):
            from .. import native
            from ..ops.highwayhash import MINIO_KEY

            span_budget = int(os.environ.get("MINIO_TPU_READ_SPAN_MB", "16")) << 20
            path_cache: dict[int, list[str] | None] = {}
            k = 0
            ok = True
            while k < len(plan):
                pnum = plan[k][0]
                if pnum not in path_cache:
                    ps: list[str] | None = []
                    for idx in range(d):
                        lp = sources[idx][0].local_path(
                            bucket, f"{obj}/{fi.data_dir}/part.{pnum}"
                        )
                        if lp is None:
                            ps = None
                            break
                        ps.append(lp)
                    path_cache[pnum] = ps
                paths = path_cache[pnum]
                if paths is None:
                    ok = False
                    break
                start = k
                tot = 0
                while k < len(plan) and plan[k][0] == pnum and tot < span_budget:
                    tot += plan[k][4] - plan[k][3]
                    k += 1
                span = plan[start:k]
                arrs = np.asarray(
                    [(s[2], s[1], s[3], s[4]) for s in span], dtype=np.int64
                )
                out = np.empty(tot, dtype=np.uint8)
                rc = native.dp_get_span(
                    paths, d, MINIO_KEY,
                    np.ascontiguousarray(arrs[:, 0]),
                    np.ascontiguousarray(arrs[:, 1]),
                    np.ascontiguousarray(arrs[:, 2]),
                    np.ascontiguousarray(arrs[:, 3]), out,
                )
                if rc != tot:
                    if rc < 0 and rc != native.DP_GET_ENOMEM:
                        # -(block*64 + shard + 1): mark the shard bad
                        bad.add((-rc - 1) % 64)
                        report_degraded()
                    k = start
                    ok = False
                    break
                if seg_sink is not None:
                    # offer whole stripe blocks of this span to the
                    # segment cache (partial head/tail slices are length-
                    # rejected there); bytes are post-verify, same as the
                    # reconstructing path's fills
                    o = 0
                    frame = fdig + coder.shard_size
                    for pnum_s, _per_s, f_off_s, lo_s, hi_s in span:
                        if lo_s == 0:
                            seg_sink(
                                pnum_s, f_off_s // frame,
                                out[o : o + hi_s - lo_s],
                            )
                        o += hi_s - lo_s
                mv = memoryview(out)
                for o in range(0, tot, 1 << 20):
                    yield mv[o : o + (1 << 20)]
            if ok:
                return
            plan = plan[k:]  # resume on the reconstructing path

        pool = _read_pool()
        window = max(1, int(os.environ.get("MINIO_TPU_READ_WINDOW", "8")))
        hedge_budget = self._hedge_budget_s()

        def start_window(win):
            """Submit data-first reads for every block of the window."""
            futs = {}
            for bi, (pnum, per, f_off, _lo, _hi) in enumerate(win):
                for idx in range(d):
                    if idx in sources and idx not in bad:
                        futs[(bi, idx)] = pool.submit(
                            read_shard_block, pnum, idx, per, f_off
                        )
            return futs

        def gather_window(win, futs):
            """Resolve reads until every block has d shards, spilling to
            parity on FAILURE — and, when a straggling drive blows the
            hedge budget, on LATENCY: extra parity reads race the
            straggler and decode around it, whichever reaches d first
            wins (the hedged-read policy; the reference instead pays the
            straggler's full latency before spilling)."""
            got: list[dict[int, bytes]] = [{} for _ in win]
            pending: dict[tuple[int, int], object] = dict(futs)
            rev = {f: k for k, f in pending.items()}
            hedged_idx: set[int] = set()
            hedge_fired = False
            import time as _time

            deadline = (
                _time.monotonic() + hedge_budget
                if hedge_budget is not None else None
            )

            def submit_more(bi: int, racing: bool) -> int:
                """Spill reads for block bi so results (+ inflight unless
                `racing`) can reach d; hedge submissions race stragglers
                instead of counting them."""
                inflight = [k[1] for k in pending if k[0] == bi]
                have = len(got[bi]) + (0 if racing else len(inflight))
                tried = set(got[bi]) | bad | set(inflight)
                cands = [
                    i for i in range(self.n) if i in sources and i not in tried
                ]
                n_sub = 0
                pnum, per, f_off, _lo, _hi = win[bi]
                for idx in cands[: max(d - have, 0)]:
                    f = pool.submit(read_shard_block, pnum, idx, per, f_off)
                    pending[(bi, idx)] = f
                    rev[f] = (bi, idx)
                    if racing:
                        hedged_idx.add(idx)
                    n_sub += 1
                return n_sub

            try:
                while any(len(g) < d for g in got):
                    # keep every deficient block able to reach d (failure
                    # spill)
                    for bi in range(len(win)):
                        if len(got[bi]) >= d:
                            continue
                        inflight = sum(1 for k in pending if k[0] == bi)
                        if len(got[bi]) + inflight < d:
                            if submit_more(bi, False) == 0 and inflight == 0:
                                pnum, _per, f_off, _lo, _hi = win[bi]
                                raise QuorumError(
                                    f"cannot read part {pnum} shard offset "
                                    f"{f_off}: only {len(got[bi])} of {d} "
                                    "shards"
                                )
                    if not pending:
                        continue  # spills just submitted; re-check
                    timeout = None
                    if deadline is not None and not hedge_fired:
                        timeout = max(deadline - _time.monotonic(), 0.0)
                    done, _ = _fut_wait(
                        set(pending.values()), timeout=timeout,
                        return_when=FIRST_COMPLETED,
                    )
                    if not done:
                        # stragglers blew the budget: hedge — race a
                        # parity-decode of the remaining shards against them
                        hedge_fired = True
                        fired = sum(
                            submit_more(bi, True)
                            for bi in range(len(win)) if len(got[bi]) < d
                        )
                        if fired:
                            fault_registry.stats_add("hedge_reads")
                            fault_registry.emit(
                                "hedge.fire", plane="read",
                                bucket=bucket, object=obj,
                                budgetMs=round((hedge_budget or 0.0) * 1e3, 1),
                                reads=fired,
                            )
                        else:
                            deadline = None  # nothing left to hedge with
                        continue
                    for f in done:
                        bi, idx = rev.pop(f)
                        del pending[(bi, idx)]
                        try:
                            got[bi][idx] = f.result()
                        except (errors.FileCorrupt, errors.FileNotFound,
                                errors.DiskNotFound, errors.DiskFull,
                                errors.VolumeNotFound, OSError):
                            # DiskNotFound covers a circuit that opened
                            # BETWEEN the metadata read and this shard read
                            # (latency trip, remote retries exhausted);
                            # VolumeNotFound a bucket that vanished under
                            # a cached-metadata read: the drive is a
                            # failed shard to spill around, not a reason
                            # to fail a GET that still has quorum
                            bad.add(idx)
                            report_degraded()
            finally:
                # success, QuorumError, or anything else: never leave
                # reads (least of all 500ms-straggler hedge bait) hogging
                # the shared pool after this window is decided
                for f in pending.values():
                    f.cancel()
            # window satisfied: settle the hedge bet (win = a hedged
            # shard ended up in some block's decode set)
            if hedged_idx:
                used: set[int] = set()
                for g in got:
                    used.update(sorted(g.keys())[:d])
                fault_registry.stats_add(
                    "hedge_wins" if used & hedged_idx else "hedge_losses"
                )
            return got

        def decode_window(win, got) -> list:
            """Per-block data buffers; same-pattern degraded blocks batch.

            Every block assembles exactly ONCE into a pre-sized buffer
            (shard payload views copy in directly — the old .tobytes()
            per shard + b"".join double copy is gone; the single copy is
            site "gather-join")."""
            out: list = [None] * len(win)
            groups: dict[tuple[tuple[int, ...], int], list[int]] = {}
            for bi in range(len(win)):
                present = tuple(sorted(got[bi].keys())[:d])
                if present == tuple(range(d)):
                    per = win[bi][1]
                    buf = bytearray(d * per)
                    mv = memoryview(buf)
                    for i in range(d):
                        mv[i * per : (i + 1) * per] = got[bi][i]
                    bufpool.count_copy("gather-join")
                    out[bi] = buf
                else:
                    # survivor ingress: every frame fetched for a block
                    # that needs reconstruction (the full-shard cost the
                    # repair plan above avoids)
                    family_stats_add(
                        family, "degraded_ingress_bytes",
                        len(got[bi]) * (fdig + win[bi][1]),
                    )
                    # group by (pattern, shard size): the tail block's per
                    # differs from full blocks and cannot share a stack
                    groups.setdefault((present, win[bi][1]), []).append(bi)
            for (present, per), bis in groups.items():
                missing = tuple(i for i in range(d) if i not in present)
                # build [d, W', per] directly: the contiguous layout the
                # native GF apply consumes, no post-stack transpose
                # copies. The stack is POOLED scratch — recycled the
                # moment reconstruction returns (its outputs are fresh
                # arrays, never views of the stack)
                nb = d * len(bis) * per
                stack_lease = bufpool.get_pool().acquire(nb) if zc else None
                try:
                    if stack_lease is not None:
                        survivors = stack_lease.array[:nb].reshape(
                            d, len(bis), per
                        )
                    else:
                        survivors = np.empty((d, len(bis), per), dtype=np.uint8)
                    for k, i in enumerate(present):
                        for w, bi in enumerate(bis):
                            survivors[k, w] = np.frombuffer(
                                got[bi][i], dtype=np.uint8
                            )
                    rec = coder.reconstruct_data_flat(
                        survivors, present, missing, pool
                    )
                finally:
                    if stack_lease is not None:
                        stack_lease.release()
                mj = {i: j for j, i in enumerate(missing)}
                for w, bi in enumerate(bis):
                    buf = bytearray(d * per)
                    mv = memoryview(buf)
                    for i in range(d):
                        src = rec[mj[i], w] if i in mj else got[bi][i]
                        mv[i * per : (i + 1) * per] = src
                    bufpool.count_copy("gather-join")
                    out[bi] = buf
            return out

        # ---- repair-plan execution: block-serial baseline --------------
        # (MINIO_TPU_REPAIR_WINDOWED=0: one block's sub-chunk reads at a
        # time, any failure abandons the rest of the plan to the generic
        # gather — kept as the A/B lever the windowed executor's
        # wall-clock gate measures against)
        if repair_sched is not None and not _repair_windowed_enabled():
            rest = None
            for k, (pnum, per, f_off, lo, hi) in enumerate(plan):
                try:
                    piece = repair_read_block(pnum, per, f_off, lo, hi)
                except (errors.FileCorrupt, errors.FileNotFound,
                        errors.DiskNotFound, errors.DiskFull,
                        errors.VolumeNotFound, OSError):
                    # a helper failed mid-plan (second fault, bitrot):
                    # the rest of the range takes the generic gather
                    # path, which discovers and spills around failures
                    # itself — partial repair is an optimization, never
                    # a correctness dependency
                    rest = plan[k:]
                    break
                yield piece
            if rest is None:
                return
            plan = rest
            repair_sched = None

        # ---- repair-plan execution: windowed sub-chunk pipeline --------
        # The same shape as the healthy path below: a window's sub-chunk
        # frame reads issue concurrently, the next window's reads start
        # as readahead while the current one decodes, and the hedged-read
        # policy covers the plan — except that for sub-chunk reads the
        # hedged alternative is the generic full-frame gather for that
        # block. A blown budget races it; a mid-read breaker trip
        # (DiskNotFound/DiskFull), bitrot, or second fault degrades to it
        # outright — for that block ONLY. The plan is never abandoned,
        # and every fallback byte re-verifies its frame digest like any
        # generic read, so wrong bytes cannot be served.
        if repair_sched is not None:
            i_m = repair_sched.missing
            SPILL = (errors.FileCorrupt, errors.FileNotFound,
                     errors.DiskNotFound, errors.DiskFull,
                     errors.VolumeNotFound, OSError)

            def repair_frames(per, lo, hi):
                """One block's plan read set: (full-frame shard indices,
                sub-chunk rows, data rows the range needs)."""
                lo_sh, hi_sh = lo // per, (hi - 1) // per
                needed = list(range(lo_sh, min(hi_sh, d - 1) + 1))
                full_idx = set(i for i in needed if i != i_m)
                subs: list[int] = []
                if i_m in needed:
                    # mates need BOTH sub-chunks: one contiguous frame-
                    # group read each (same bytes, half the round-trips)
                    full_idx.update(repair_sched.mates)
                    subs = [r for r in repair_sched.b_helpers
                            if r not in full_idx]
                    subs.append(repair_sched.pb_parity)
                return full_idx, subs, needed

            def start_repair_window(win):
                """Submit every block's plan reads for the window."""
                futs = {}
                for bi, (pnum, per, f_off, lo, hi) in enumerate(win):
                    full_idx, subs, _needed = repair_frames(per, lo, hi)
                    for idx in full_idx:
                        futs[(bi, "full", idx)] = pool.submit(
                            read_shard_block, pnum, idx, per, f_off
                        )
                    for r in subs:
                        futs[(bi, "sub", r)] = pool.submit(
                            read_sub_chunk, pnum, r, per, f_off, 1
                        )
                return futs

            def assemble_repair(entry, full, subs):
                """Plan-complete block -> its [lo, hi) bytes (the compute
                half of repair_read_block; reads already resolved)."""
                pnum, per, f_off, lo, hi = entry
                _full_idx, _subs, needed = repair_frames(per, lo, hi)
                got = {i: np.frombuffer(v, dtype=np.uint8)
                       for i, v in full.items()}
                if i_m in needed:
                    ingress = len(got) * (fdig + per)
                    h1, h2 = bitrot_io.sub_lens(per)
                    sub2 = {}
                    for r in repair_sched.b_helpers:
                        if r in got:
                            sub2[r] = got[r][h1:]
                        else:
                            sub2[r] = subs[r]
                            ingress += DIGEST + h2
                    pb = subs[repair_sched.pb_parity]
                    ingress += DIGEST + h2
                    sub1 = {r: got[r][:h1] for r in repair_sched.mates}
                    got[i_m] = coder.repair_data_shard(
                        repair_sched, per, sub2, pb, sub1
                    )
                    family_stats_add(family, "degraded_ingress_bytes", ingress)
                # single pre-sized assembly (was .tobytes() + b"".join)
                out = bytearray(len(needed) * per)
                mv = memoryview(out)
                for j, i in enumerate(needed):
                    mv[j * per : (j + 1) * per] = got[i]
                bufpool.count_copy("gather-join")
                lo_sh = lo // per
                return serve_slice(out, lo - lo_sh * per, hi - lo_sh * per)

            def gather_repair_window(win, futs):
                """Resolve a window of plan blocks. Each block is its own
                race: the sub-chunk read set vs (once hedged or failed)
                the generic d-shard full gather — whichever completes
                first serves the block. Returns (pieces, full, subs):
                pieces[bi] is fallback-decoded bytes, or None meaning the
                plan reads landed and assembly is deferred (it runs under
                the next window's readahead)."""
                nwin = len(win)
                full = [dict() for _ in range(nwin)]    # bi -> idx: bytes
                subs = [dict() for _ in range(nwin)]    # bi -> row: array
                fb_got = [dict() for _ in range(nwin)]  # fallback frames
                fb_mode = [False] * nwin
                fb_hedge = [False] * nwin
                plan_done = [False] * nwin
                pieces: list[bytes | None] = [None] * nwin
                pending: dict[tuple, object] = dict(futs)
                rev = {f: k for k, f in pending.items()}
                plan_keys: list[set] = [set() for _ in range(nwin)]
                for k in futs:
                    plan_keys[k[0]].add(k)
                hedge_fired = False
                import time as _time

                deadline = (
                    _time.monotonic() + hedge_budget
                    if hedge_budget is not None else None
                )

                def unserved(bi):
                    return pieces[bi] is None and not plan_done[bi]

                def drop_plan_reads(bi):
                    for k in list(plan_keys[bi]):
                        f = pending.pop(k, None)
                        if f is not None:
                            rev.pop(f, None)
                            f.cancel()
                    plan_keys[bi].clear()

                def drop_fb_reads(bi):
                    for k in [k for k in pending
                              if k[0] == bi and k[1] == "fb"]:
                        f = pending.pop(k)
                        rev.pop(f, None)
                        f.cancel()

                def fb_submit(bi) -> int:
                    """Keep fallback block bi able to reach d shards."""
                    pnum, per, f_off, _lo, _hi = win[bi]
                    inflight = [k[2] for k in pending
                                if k[0] == bi and k[1] == "fb"]
                    have = len(fb_got[bi]) + len(inflight)
                    tried = set(fb_got[bi]) | bad | set(inflight)
                    cands = [i for i in range(self.n)
                             if i in sources and i not in tried]
                    n_sub = 0
                    for idx in cands[: max(d - have, 0)]:
                        f = pool.submit(read_shard_block, pnum, idx, per, f_off)
                        pending[(bi, "fb", idx)] = f
                        rev[f] = (bi, "fb", idx)
                        n_sub += 1
                    return n_sub

                def enter_fallback(bi, racing) -> int:
                    """Degrade block bi to the generic gather. ``racing``
                    (hedge) leaves the plan reads inflight to race; a
                    failed plan read drops them instead."""
                    if fb_mode[bi]:
                        return 0
                    fb_mode[bi] = True
                    fb_hedge[bi] = racing
                    if not racing:
                        drop_plan_reads(bi)
                    return fb_submit(bi)

                def finish_plan(bi):
                    """All plan reads landed: settle the race; assembly
                    is deferred to the caller (under readahead)."""
                    plan_done[bi] = True
                    if fb_mode[bi]:
                        if fb_hedge[bi]:
                            fault_registry.stats_add("repair_hedge_losses")
                        drop_fb_reads(bi)

                def finish_fallback(bi):
                    if not unserved(bi) or len(fb_got[bi]) < d:
                        return
                    block = decode_window([win[bi]], [fb_got[bi]])[0]
                    _pnum, _per, _f_off, lo, hi = win[bi]
                    pieces[bi] = serve_slice(block, lo, hi)
                    fault_registry.stats_add("repair_fallback_blocks")
                    if fb_hedge[bi]:
                        fault_registry.stats_add("repair_hedge_wins")
                    drop_plan_reads(bi)

                try:
                    while any(unserved(bi) for bi in range(nwin)):
                        # fallback blocks must stay able to reach d
                        for bi in range(nwin):
                            if not (unserved(bi) and fb_mode[bi]):
                                continue
                            inflight = sum(
                                1 for k in pending
                                if k[0] == bi and k[1] == "fb"
                            )
                            if len(fb_got[bi]) + inflight < d:
                                if (fb_submit(bi) == 0 and inflight == 0
                                        and not plan_keys[bi]):
                                    pnum, _per, f_off, _lo, _hi = win[bi]
                                    raise QuorumError(
                                        f"cannot read part {pnum} shard "
                                        f"offset {f_off}: only "
                                        f"{len(fb_got[bi])} of {d} shards"
                                    )
                        if not pending:
                            continue  # spills just submitted; re-check
                        timeout = None
                        if deadline is not None and not hedge_fired:
                            timeout = max(deadline - _time.monotonic(), 0.0)
                        # plan-only mode needs every read anyway: one
                        # ALL_COMPLETED wait registers each future once.
                        # Once any block races its fallback, settle per
                        # completion (FIRST_COMPLETED) — whichever side
                        # lands first serves without waiting on the loser.
                        racing = hedge_fired or any(fb_mode)
                        done, _ = _fut_wait(
                            set(pending.values()), timeout=timeout,
                            return_when=(
                                FIRST_COMPLETED if racing else ALL_COMPLETED
                            ),
                        )
                        if not done:
                            # plan reads blew the hedge budget: race the
                            # generic full gather for every unserved block
                            hedge_fired = True
                            fired = sum(
                                enter_fallback(bi, True)
                                for bi in range(nwin) if unserved(bi)
                            )
                            if fired:
                                fault_registry.stats_add("repair_hedge_reads")
                                fault_registry.emit(
                                    "hedge.fire", plane="repair",
                                    bucket=bucket, object=obj,
                                    budgetMs=round(
                                        (hedge_budget or 0.0) * 1e3, 1
                                    ),
                                    reads=fired,
                                )
                            else:
                                deadline = None  # nothing left to hedge
                            continue
                        for f in done:
                            key = rev.pop(f, None)
                            if key is None:
                                continue  # read dropped after its race
                            pending.pop(key, None)
                            bi, kind = key[0], key[1]
                            if kind == "fb":
                                try:
                                    fb_got[bi][key[2]] = f.result()
                                except SPILL:
                                    bad.add(key[2])
                                    report_degraded()
                                else:
                                    finish_fallback(bi)
                                continue
                            plan_keys[bi].discard(key)
                            try:
                                if kind == "full":
                                    full[bi][key[2]] = f.result()
                                else:
                                    subs[bi][key[2]] = f.result()
                            except SPILL:
                                # mid-plan breaker trip / bitrot / second
                                # fault: THIS block degrades to the
                                # generic gather; sibling blocks keep
                                # their plan reads
                                if not unserved(bi):
                                    continue
                                if fb_mode[bi]:
                                    # already racing: the plan just lost
                                    # its own race; the gather carries on
                                    drop_plan_reads(bi)
                                else:
                                    enter_fallback(bi, False)
                            else:
                                if unserved(bi) and not plan_keys[bi]:
                                    finish_plan(bi)
                finally:
                    for f in pending.values():
                        f.cancel()
                return pieces, full, subs

            r_windows = [
                plan[i : i + window] for i in range(0, len(plan), window)
            ]
            r_futs = start_repair_window(r_windows[0]) if r_windows else {}
            try:
                for wi, win in enumerate(r_windows):
                    pieces, r_full, r_subs = gather_repair_window(win, r_futs)
                    r_futs = {}
                    if wi + 1 < len(r_windows):
                        r_futs = start_repair_window(r_windows[wi + 1])
                    for bi in range(len(win)):
                        if pieces[bi] is None:
                            # plan-complete blocks decode here, under the
                            # next window's readahead
                            pieces[bi] = assemble_repair(
                                win[bi], r_full[bi], r_subs[bi]
                            )
                        yield pieces[bi]
            finally:
                for f in r_futs.values():
                    f.cancel()
            return

        # ---- pipelined execution: window k+1 reads under window k decode ----
        windows = [plan[i : i + window] for i in range(0, len(plan), window)]
        futs = start_window(windows[0]) if windows else {}
        try:
            for wi, win in enumerate(windows):
                got = gather_window(win, futs)
                futs = {}
                if wi + 1 < len(windows):
                    futs = start_window(windows[wi + 1])  # readahead
                blocks = decode_window(win, got)
                for (pnum, per, f_off, lo, hi), block in zip(win, blocks):
                    if seg_sink is not None:
                        # the decode always materializes the FULL stripe
                        # block (ranged reads only slice at yield time),
                        # so even a partial-range request fills whole
                        # verified segments (the cache copies on admit —
                        # site "cache-fill" — so serving views is safe)
                        seg_sink(
                            pnum, f_off // (fdig + coder.shard_size),
                            block,
                        )
                    yield serve_slice(block, lo, hi)
        finally:
            # abandoned iterator (client hung up) or error: don't let
            # readahead reads+verifies hog the shared pool
            for f in futs.values():
                f.cancel()

    # -- delete ------------------------------------------------------------

    def delete_object(
        self,
        bucket: str,
        obj: str,
        version_id: str = "",
        versioned: bool = False,
    ) -> ObjectInfo:
        """Versioned delete semantics
        (MinIO cmd/erasure-object.go DeleteObject):
        - versioned bucket + no version id -> write a delete marker
        - version id given -> remove exactly that version
        - unversioned -> remove the null version entirely
        """
        with obs.span(
            obs.TYPE_INTERNAL, "erasure.delete_object", bucket=bucket, object=obj
        ):
            mtx = self.ns.new(bucket, obj)
            if not _lock_dyn(mtx, write=True):
                raise QuorumError(f"namespace write lock timeout on {bucket}/{obj}")
            try:
                oi = self._delete_object_locked(bucket, obj, version_id, versioned)
            finally:
                mtx.unlock()
            # invalidate + broadcast outside the lock, before returning
            self.cache.invalidate_object(bucket, obj)
            return oi

    def _delete_object_locked(
        self, bucket: str, obj: str, version_id: str, versioned: bool
    ) -> ObjectInfo:
        write_q = self.n // 2 + 1
        if versioned and not version_id:
            fi = FileInfo(volume=bucket, name=obj)
            fi.version_id = str(uuid.uuid4())
            fi.deleted = True
            fi.mod_time = now_ns()
            fi.erasure.distribution = hash_order(f"{bucket}/{obj}", self.n)
            res = self._parallel(lambda d: d.write_metadata(bucket, obj, fi))
            reduce_quorum_errs([e for _, e in res], write_q)
            oi = self._to_object_info(bucket, obj, fi)
            oi.delete_marker = True
            return oi

        fi = FileInfo(volume=bucket, name=obj, version_id=version_id)
        res = self._parallel(lambda d: d.delete_version(bucket, obj, fi))
        errs = [e for _, e in res]
        reduce_quorum_errs(
            errs, write_q, ignored=(errors.FileNotFound, errors.FileVersionNotFound)
        )
        if all(e is not None for e in errs):
            reduce_quorum_errs(errs, write_q)
        oi = ObjectInfo(bucket=bucket, name=obj, version_id=version_id)
        return oi

    # -- object tags -------------------------------------------------------

    TAGS_META_KEY = TAGS_META_KEY  # module constant, kept as class attr for callers

    def update_object_metadata(
        self, bucket: str, obj: str, version_id: str, mutate
    ) -> None:
        """Quorum read-modify-write of a version's metadata under the
        namespace write lock. `mutate(metadata_dict)` edits in place.
        Serves tagging, retention, and legal holds."""
        mtx = self.ns.new(bucket, obj)
        if not _lock_dyn(mtx, write=True):
            raise QuorumError(f"lock timeout updating {bucket}/{obj}")
        try:
            # read_data=True: the rewrite below persists the FileInfo as-is,
            # so inline payloads must ride along (the metadata-only read
            # masks them to an empty marker, which would wipe the object)
            fi, metas, _, write_q = self._quorum_fileinfo(
                bucket, obj, version_id, read_data=True
            )
            if fi.deleted:
                raise ObjectNotFound(f"{bucket}/{obj}")

            errs = []
            for disk, m in zip(self.disks, metas):
                try:
                    if m is None:
                        raise errors.FileNotFound(obj)
                    mutate(m.metadata)
                    disk.update_metadata(bucket, obj, m)
                    errs.append(None)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
            reduce_quorum_errs(errs, write_q)
        finally:
            mtx.unlock()
        self.cache.invalidate_object(bucket, obj)

    def transition_object(
        self, bucket: str, obj: str, tier: str, remote_key: str,
        version_id: str = "", restub: bool = False,
    ) -> None:
        """Replace a version's local data with a metadata stub pointing at
        warm-tier storage (reference cmd/bucket-lifecycle.go transition
        workers). Size/etag/mod_time are preserved; parts are dropped so
        the scanner/heal planes treat the stub as data-free. restub=True
        re-stubs an already-transitioned object whose restored copy
        expired (data is already in the tier)."""
        mtx = self.ns.new(bucket, obj)
        if not _lock_dyn(mtx, write=True):
            raise QuorumError(f"lock timeout transitioning {bucket}/{obj}")
        try:
            from ..ilm.tier import RESTORE_EXPIRY_META, TRANSITION_KEY_META, TRANSITION_TIER_META

            fi, metas, _, write_q = self._quorum_fileinfo(
                bucket, obj, version_id, read_data=True
            )
            if fi.deleted:
                raise ObjectNotFound(f"{bucket}/{obj}")
            already = bool(fi.metadata.get(TRANSITION_TIER_META))
            if already and not restub:
                # miniovet: ignore[coherence-path] -- nothing written,
                # nothing stale: the object is already transitioned
                return
            if restub and not already:
                # miniovet: ignore[coherence-path] -- nothing written,
                # nothing stale: no restored copy to re-stub
                return
            old_data_dir = fi.data_dir
            nfi = FileInfo.from_dict(fi.to_dict())
            nfi.parts = []
            nfi.data_dir = None
            nfi.inline_data = None
            if restub:
                nfi.metadata.pop(RESTORE_EXPIRY_META, None)
            else:
                nfi.metadata[TRANSITION_TIER_META] = tier
                nfi.metadata[TRANSITION_KEY_META] = remote_key
            errs = []
            for i, disk in enumerate(self.disks):
                try:
                    dfi = FileInfo.from_dict(nfi.to_dict())
                    dfi.volume, dfi.name = bucket, obj
                    dfi.erasure.index = fi.erasure.distribution[i]
                    disk.write_metadata(bucket, obj, dfi)
                    errs.append(None)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
            reduce_quorum_errs(errs, write_q)
            if old_data_dir:
                for disk in self.disks:
                    try:
                        disk.delete(bucket, f"{obj}/{old_data_dir}", recursive=True)
                    except (StorageError, OSError):
                        pass  # already absent / drive offline
        finally:
            mtx.unlock()
        self.cache.invalidate_object(bucket, obj)

    def restore_object(
        self, bucket: str, obj: str, data: bytes, days: int, version_id: str = ""
    ) -> None:
        """Bring a transitioned version's data back locally for `days`
        (reference RestoreObject, cmd/bucket-lifecycle.go restoreObject).
        The object STAYS transitioned; the scanner re-stubs it after the
        restore window."""
        import time as _time

        mtx = self.ns.new(bucket, obj)
        if not _lock_dyn(mtx, write=True):
            raise QuorumError(f"lock timeout restoring {bucket}/{obj}")
        try:
            from ..ilm.tier import RESTORE_EXPIRY_META, TRANSITION_TIER_META

            fi, metas, _, write_q = self._quorum_fileinfo(
                bucket, obj, version_id, read_data=True
            )
            if fi.deleted or not fi.metadata.get(TRANSITION_TIER_META):
                raise ObjectNotFound(f"{bucket}/{obj} is not transitioned")
            # restored shards keep the object's STORED family: its
            # xl.meta algorithm field survives the restore round-trip
            encoded = self.coder_for(fi).encode_part(data)
            nfi = FileInfo.from_dict(fi.to_dict())
            nfi.data_dir = str(uuid.uuid4())
            nfi.parts = [
                ObjectPartInfo(1, len(data), len(data), fi.mod_time,
                               fi.metadata.get("etag", ""))
            ]
            nfi.metadata[RESTORE_EXPIRY_META] = str(
                _time.time() + days * 86400
            )
            tmp_id = str(uuid.uuid4())
            errs = []
            for i, disk in enumerate(self.disks):
                try:
                    shard_idx = fi.erasure.distribution[i] - 1
                    dfi = FileInfo.from_dict(nfi.to_dict())
                    dfi.volume, dfi.name = bucket, obj
                    dfi.erasure.index = shard_idx + 1
                    stage = f"{tmp_id}/{nfi.data_dir}/part.1"
                    disk.create_file(TMP_VOLUME, stage, encoded.shard_files[shard_idx])
                    disk.rename_data(TMP_VOLUME, tmp_id, dfi, bucket, obj)
                    errs.append(None)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
            # drives that staged but never finished rename_data keep a
            # full restored shard under .minio.sys/tmp — sweep them
            # whether or not quorum held (on failure every drive may)
            self._sweep_staging(
                tmp_id,
                (d for d, e in zip(self.disks, errs) if e is not None),
            )
            reduce_quorum_errs(errs, write_q)
        finally:
            mtx.unlock()
        self.cache.invalidate_object(bucket, obj)

    def set_object_tags(
        self, bucket: str, obj: str, tags: dict[str, str], version_id: str = ""
    ) -> None:
        """Store object tags in version metadata (reference PutObjectTags,
        cmd/erasure-object.go)."""
        import urllib.parse as _up

        encoded = _up.urlencode(tags)

        def mutate(md: dict) -> None:
            if encoded:
                md[self.TAGS_META_KEY] = encoded
            else:
                md.pop(self.TAGS_META_KEY, None)

        self.update_object_metadata(bucket, obj, version_id, mutate)

    def get_object_tags(
        self, bucket: str, obj: str, version_id: str = ""
    ) -> dict[str, str]:
        import urllib.parse as _up

        fi, _ = self._cached_fileinfo(bucket, obj, version_id)
        raw = fi.metadata.get(self.TAGS_META_KEY, "")
        # empty tag VALUES are legal ("env=") and must round-trip
        return dict(_up.parse_qsl(raw, keep_blank_values=True))

    # -- versions ----------------------------------------------------------

    def list_object_versions(self, bucket: str, obj: str) -> list[ObjectInfo]:
        res = self._parallel(lambda d: d.read_versions(bucket, obj))
        for vers, err in res:
            if err is None:
                return [self._to_object_info(bucket, obj, fi) for fi in vers]
        return []

    # -- heal --------------------------------------------------------------

    def heal_object(self, bucket: str, obj: str, version_id: str = "") -> dict:
        """Rebuild missing/corrupt shards onto stale drives.

        Mirrors healObject (MinIO cmd/erasure-healing.go:295):
        quorum-pick the authoritative version, classify each drive as ok or
        stale (missing version, bad metadata, or failing bitrot verify),
        reconstruct stale shards from healthy ones, rename into place.
        Holds the namespace write lock: healing must not interleave with a
        concurrent overwrite of the same object.
        """
        with obs.span(
            obs.TYPE_HEAL, "erasure.heal_object", bucket=bucket, object=obj
        ) as hsp:
            mtx = self.ns.new(bucket, obj)
            if not _lock_dyn(mtx, write=True):
                raise QuorumError(f"namespace lock timeout healing {bucket}/{obj}")
            try:
                res = self._heal_object_locked(bucket, obj, version_id, lock=mtx)
                hsp.set(
                    healed=len(res.get("healed", [])),
                    family=res.get("family", ""),
                    ingressBytes=res.get("ingressBytes", 0),
                )
            finally:
                mtx.unlock()
            if res.get("healed"):
                # healed shards change per-drive metadata/frames: cached
                # metas and bytes re-resolve (fault-injected bitrot/
                # torn-write repairs flow through here too)
                self.cache.invalidate_object(bucket, obj)
            # miniovet: ignore[coherence-path] -- the invalidation above
            # is conditional on purpose: a heal that repaired nothing
            # changed nothing, so there is nothing stale to drop
            return res

    def _heal_object_locked(
        self, bucket: str, obj: str, version_id: str, lock=None
    ) -> dict:
        fi, metas, read_q, write_q = self._quorum_fileinfo(
            bucket, obj, version_id, read_data=True
        )
        if lock is not None and fi.size > (8 << 20):
            # healing big objects can outlive the TTL; a healer that lost
            # its lock must not rename stale shards over a concurrent write
            lock.start_refresher(write=True)
        if fi.deleted:
            # replicate the delete marker onto drives that miss it
            healed = []
            for disk, m in zip(self.disks, metas):
                if m is None or m.version_id != fi.version_id:
                    try:
                        disk.write_metadata(bucket, obj, fi)
                        healed.append(disk.endpoint)
                    except (StorageError, OSError):
                        pass  # heal is per-drive best-effort
            return {"healed": healed, "type": "delete-marker"}

        d, p = fi.erasure.data_blocks, fi.erasure.parity_blocks
        coder = self.coder_for(fi)  # stored family; unknown -> typed error
        family = coder.family
        fdig = coder.frame_digests * DIGEST
        sources = self._shard_sources(fi, metas)

        # verify the shards we think are good; drop any that fail bitrot
        good: dict[int, tuple[StorageAPI, FileInfo]] = {}
        for idx, (disk, m) in sources.items():
            try:
                if m.inline_data:
                    self._verify_inline(m, coder)
                else:
                    disk.verify_file(bucket, obj, m)
                good[idx] = (disk, m)
            except (StorageError, OSError, ValueError):
                pass  # corrupt/unreadable shard: heal rebuilds it below
        if len(good) < d:
            raise QuorumError(f"not enough healthy shards to heal: {len(good)}/{d}")

        stale: list[tuple[int, StorageAPI]] = []
        by_disk = {id(disk): idx for idx, (disk, _) in good.items()}
        for i, disk in enumerate(self.disks):
            if id(disk) not in by_disk:
                shard_idx = fi.erasure.distribution[i] - 1
                stale.append((shard_idx, disk))
        if not stale:
            return {"healed": [], "type": "object"}

        # rebuild the full shard files for stale drives, part by part —
        # FULL stripe blocks batch onto the device (one reconstruct matmul
        # + one hash dispatch for many blocks, the HealObject north-star);
        # tails and small objects take the native CPU path
        per_part_rebuilt: dict[int, dict[int, bytearray]] = {}
        survivors_idx = sorted(good.keys())[:d]
        missing_idx = tuple(sorted(idx for idx, _ in stale))

        heal_whole_cache: dict[tuple[int, int], bytes] = {}
        heal_whole_mu = threading.Lock()
        # survivor bytes moved into this heal (the repair-bandwidth
        # number: metrics minio_heal_ingress_bytes_total, heal span).
        # The windowed repair executor fans reads onto the shared pool,
        # so the accumulator takes a lock.
        ingress = 0
        ingress_mu = threading.Lock()

        def ingress_add(n: int) -> None:
            nonlocal ingress
            with ingress_mu:
                ingress += n

        def read_block(part, idx, f_off, per):
            disk, m = good[idx]
            wf = _whole_file_hash(m, part.number)
            if wf is not None:  # legacy whole-file survivor
                k = (idx, part.number)
                # coarse lock: legacy survivors are rare and the whole-
                # file read+verify must happen once, not once per racing
                # windowed block
                with heal_whole_mu:
                    if k not in heal_whole_cache:
                        raw = m.inline_data if m.inline_data else disk.read_file(
                            bucket, f"{obj}/{fi.data_dir}/part.{part.number}",
                            0, -1,
                        )
                        ingress_add(len(raw))
                        heal_whole_cache[k] = bitrot_io.verify_whole_file(
                            bytes(raw), *wf
                        )
                block_i = f_off // (fdig + coder.shard_size)
                blk = heal_whole_cache[k][block_i * coder.shard_size:][:per]
                if len(blk) != per:
                    raise errors.FileCorrupt("short whole-file shard")
                return blk
            if m.inline_data:
                buf = m.inline_data[f_off : f_off + fdig + per]
            else:
                buf = disk.read_file(
                    bucket, f"{obj}/{fi.data_dir}/part.{part.number}",
                    f_off, fdig + per,
                )
            ingress_add(len(buf))
            return bitrot_io.verify_block(buf, per, family=family)

        def read_sub(part, idx, f_off, per, which):
            """Sub-chunk frame read from a survivor (partial repair)."""
            disk, m = good[idx]
            rel, dlen = bitrot_io.sub_chunk_in_block(per, which)
            off = f_off + rel
            if m.inline_data:
                buf = m.inline_data[off : off + DIGEST + dlen]
            else:
                buf = disk.read_file(
                    bucket, f"{obj}/{fi.data_dir}/part.{part.number}",
                    off, DIGEST + dlen,
                )
            ingress_add(len(buf))
            return np.frombuffer(
                bitrot_io.verify_sub_chunk(bytes(buf), dlen), dtype=np.uint8
            )

        # healed shards keep the OBJECT's format: streaming objects get
        # family-framed digest||block records, legacy whole-file objects
        # raw bytes plus a fresh metadata digest (healed in kind)
        whole = any(c.hash for c in fi.erasure.checksums)

        # partial-repair plan: ONE stale data shard of a sub-packetized
        # family rebuilds from the schedule's sub-chunk reads — the
        # direct lever on survivor bytes moved (ROADMAP item 2). Any
        # read failure falls back to the generic full-read rebuild.
        repair_sched = None
        if (
            family == bitrot_io.FAMILY_CAUCHY
            and not whole
            and len(stale) == 1
            and stale[0][0] < d
        ):
            sched = coder.repair_schedule(stale[0][0])
            if sched is not None and all(h in good for h in sched.helpers):
                repair_sched = sched

        def repair_part_windowed(part, geometry) -> bytearray:
            """Windowed + hedged partial repair of one part's lost shard
            (the heal twin of the degraded-GET plan executor): a window
            of blocks' sub-chunk reads issues concurrently on the shard-
            read pool, the next window starts as readahead while the
            current one frames (hash + emit), and a straggling or failed
            helper degrades THAT block to a generic survivor rebuild —
            racing it as the hedge when the EWMA budget blows. Raises
            only when a block can neither repair nor rebuild from the
            verified survivor set (the caller then falls back to the
            generic whole-part path). Returns the lost shard's framed
            bytes for the whole part, in block order."""
            sched = repair_sched
            s_idx = sched.missing
            pool = _read_pool()
            window = max(1, int(os.environ.get("MINIO_TPU_READ_WINDOW", "8")))
            hedge_budget = self._hedge_budget_s()
            SPILL = (StorageError, OSError)

            def start_win(blocks):
                """Submit one window's plan reads: mates as full frame
                groups (they need both sub-chunks), the remaining
                b_helpers + piggyback parity as sub-chunk-2 frames."""
                futs = {}
                for bi, (block_i, per) in enumerate(blocks):
                    f_off = bitrot_io.block_offset(
                        coder.shard_size, block_i, family
                    )
                    for r in sched.mates:
                        futs[(bi, "full", r)] = pool.submit(
                            read_block, part, r, f_off, per
                        )
                    for r in sched.b_helpers:
                        if r not in sched.mates:
                            futs[(bi, "sub", r)] = pool.submit(
                                read_sub, part, r, f_off, per, 1
                            )
                    futs[(bi, "sub", sched.pb_parity)] = pool.submit(
                        read_sub, part, sched.pb_parity, f_off, per, 1
                    )
                return futs

            def assemble(blocks, bi, fullm, subm) -> np.ndarray:
                _block_i, per = blocks[bi]
                h1m, _h2m = bitrot_io.sub_lens(per)
                mate_full = {
                    r: np.frombuffer(fullm[bi][r], dtype=np.uint8)
                    for r in sched.mates
                }
                sub2 = {
                    r: (mate_full[r][h1m:] if r in mate_full else subm[bi][r])
                    for r in sched.b_helpers
                }
                pb = subm[bi][sched.pb_parity]
                sub1 = {r: v[:h1m] for r, v in mate_full.items()}
                return coder.repair_data_shard(sched, per, sub2, pb, sub1)

            def gather_win(blocks, futs):
                """Resolve one window; every block races its plan reads
                against (once hedged or failed) a generic survivor
                rebuild. Returns the rebuilt shard per block."""
                nb = len(blocks)
                fullm = [dict() for _ in range(nb)]
                subm = [dict() for _ in range(nb)]
                fb_got = [dict() for _ in range(nb)]
                fb_bad: set[int] = set()  # shards whose fb read failed
                fb_mode = [False] * nb
                fb_hedge = [False] * nb
                shards: list[np.ndarray | None] = [None] * nb
                plan_keys: list[set] = [set() for _ in range(nb)]
                pending: dict[tuple, object] = dict(futs)
                rev = {f: k for k, f in pending.items()}
                for k in futs:
                    plan_keys[k[0]].add(k)
                last_err: BaseException | None = None
                hedge_fired = False
                import time as _time

                deadline = (
                    _time.monotonic() + hedge_budget
                    if hedge_budget is not None else None
                )

                def drop_plan(bi):
                    for k in list(plan_keys[bi]):
                        f = pending.pop(k, None)
                        if f is not None:
                            rev.pop(f, None)
                            f.cancel()
                    plan_keys[bi].clear()

                def drop_fb(bi):
                    for k in [k for k in pending
                              if k[0] == bi and k[1] == "fb"]:
                        f = pending.pop(k)
                        rev.pop(f, None)
                        f.cancel()

                def fb_submit(bi) -> int:
                    block_i, per = blocks[bi]
                    f_off = bitrot_io.block_offset(
                        coder.shard_size, block_i, family
                    )
                    inflight = [k[2] for k in pending
                                if k[0] == bi and k[1] == "fb"]
                    have = len(fb_got[bi]) + len(inflight)
                    tried = set(fb_got[bi]) | set(inflight) | fb_bad
                    cands = [i for i in sorted(good) if i not in tried]
                    n_sub = 0
                    for idx in cands[: max(d - have, 0)]:
                        f = pool.submit(read_block, part, idx, f_off, per)
                        pending[(bi, "fb", idx)] = f
                        rev[f] = (bi, "fb", idx)
                        n_sub += 1
                    return n_sub

                def enter_fb(bi, racing) -> int:
                    if fb_mode[bi]:
                        return 0
                    fb_mode[bi] = True
                    fb_hedge[bi] = racing
                    if not racing:
                        drop_plan(bi)
                    return fb_submit(bi)

                def finish_plan(bi):
                    shards[bi] = assemble(blocks, bi, fullm, subm)
                    if fb_mode[bi]:
                        if fb_hedge[bi]:
                            fault_registry.stats_add("repair_hedge_losses")
                        drop_fb(bi)

                def finish_fb(bi):
                    if shards[bi] is not None or len(fb_got[bi]) < d:
                        return
                    got = {
                        i: np.frombuffer(v, dtype=np.uint8)
                        for i, v in fb_got[bi].items()
                    }
                    rec = coder.reconstruct_block(got, blocks[bi][1])
                    shards[bi] = rec[s_idx]
                    fault_registry.stats_add("repair_fallback_blocks")
                    if fb_hedge[bi]:
                        fault_registry.stats_add("repair_hedge_wins")
                    drop_plan(bi)

                try:
                    while any(s is None for s in shards):
                        for bi in range(nb):
                            if shards[bi] is not None or not fb_mode[bi]:
                                continue
                            inflight = sum(
                                1 for k in pending
                                if k[0] == bi and k[1] == "fb"
                            )
                            if len(fb_got[bi]) + inflight < d:
                                if (fb_submit(bi) == 0 and inflight == 0
                                        and not plan_keys[bi]):
                                    # neither path can complete: the
                                    # caller rebuilds this part the
                                    # generic way
                                    raise last_err or errors.FileCorrupt(
                                        "repair fallback lost quorum"
                                    )
                        if not pending:
                            continue
                        timeout = None
                        if deadline is not None and not hedge_fired:
                            timeout = max(deadline - _time.monotonic(), 0.0)
                        # plan-only mode needs every read anyway: one
                        # ALL_COMPLETED wait registers each future once.
                        # Once any block races its fallback, settle per
                        # completion (FIRST_COMPLETED) — whichever side
                        # lands first serves without waiting on the loser.
                        racing = hedge_fired or any(fb_mode)
                        done, _ = _fut_wait(
                            set(pending.values()), timeout=timeout,
                            return_when=(
                                FIRST_COMPLETED if racing else ALL_COMPLETED
                            ),
                        )
                        if not done:
                            hedge_fired = True
                            fired = sum(
                                enter_fb(bi, True)
                                for bi in range(nb) if shards[bi] is None
                            )
                            if fired:
                                fault_registry.stats_add("repair_hedge_reads")
                                fault_registry.emit(
                                    "hedge.fire", plane="repair", op="heal",
                                    bucket=bucket, object=obj,
                                    budgetMs=round(
                                        (hedge_budget or 0.0) * 1e3, 1
                                    ),
                                    reads=fired,
                                )
                            else:
                                deadline = None
                            continue
                        for f in done:
                            key = rev.pop(f, None)
                            if key is None:
                                continue
                            pending.pop(key, None)
                            bi, kind = key[0], key[1]
                            if kind == "fb":
                                try:
                                    fb_got[bi][key[2]] = f.result()
                                except SPILL as e:
                                    # a failed fallback shard must never
                                    # be re-picked (a persistently
                                    # corrupt helper would loop forever)
                                    last_err = e
                                    fb_bad.add(key[2])
                                else:
                                    finish_fb(bi)
                                continue
                            plan_keys[bi].discard(key)
                            try:
                                if kind == "full":
                                    fullm[bi][key[2]] = f.result()
                                else:
                                    subm[bi][key[2]] = f.result()
                            except SPILL as e:
                                last_err = e
                                if shards[bi] is not None:
                                    continue
                                if fb_mode[bi]:
                                    drop_plan(bi)  # plan lost its race
                                else:
                                    enter_fb(bi, False)
                            else:
                                if shards[bi] is None and not plan_keys[bi]:
                                    finish_plan(bi)
                finally:
                    for f in pending.values():
                        f.cancel()
                return shards

            out = bytearray()
            blocks_all = [
                (block_i, per)
                for block_i, (_data_len, per) in enumerate(geometry)
            ]
            wins = [
                blocks_all[i : i + window]
                for i in range(0, len(blocks_all), window)
            ]
            futs = start_win(wins[0]) if wins else {}
            try:
                for wi, blocks in enumerate(wins):
                    shards = gather_win(blocks, futs)
                    futs = {}
                    if wi + 1 < len(wins):
                        futs = start_win(wins[wi + 1])  # readahead
                    for blk in shards:
                        # framing (bitrot hash + emit) runs under the
                        # next window's readahead
                        out += bitrot_io.frame_block(blk.tobytes(), family)
            finally:
                for f in futs.values():
                    f.cancel()
            return out

        for part in fi.parts:
            geometry = coder.shard_sizes_for(part.size)
            rebuilt: dict[int, bytearray] = {idx: bytearray() for idx, _ in stale}
            full_n = sum(1 for _, per in geometry if per == coder.shard_size)
            # opt-in: on an H100 80GB HBM3 at its 700 W limit, drive
            # refills through the device heal and through the native AVX2
            # path took equal time within the host's spread, the card's
            # share being a few ms of K1 decode (PERF.md, the durability
            # plane's findings); no speed reason makes the card the default
            import os as _os

            use_device = (
                coder._dev is not None
                and family == bitrot_io.FAMILY_RS
                and full_n >= 4
                and not fi.inline_data
                and not whole  # device path emits streaming frames only
                and _os.environ.get("MINIO_TPU_DEVICE_HEAL", "0") == "1"
            )
            batched_done = 0
            if repair_sched is not None:
                s_idx = repair_sched.missing
                try:
                    if _repair_windowed_enabled():
                        # windowed + hedged executor: straggling/failed
                        # helpers degrade per BLOCK to a generic survivor
                        # rebuild inside repair_part_windowed; only a
                        # block that can do neither lands here
                        rebuilt[s_idx] += repair_part_windowed(
                            part, geometry
                        )
                    else:
                        # block-serial baseline
                        # (MINIO_TPU_REPAIR_WINDOWED=0)
                        for block_i, (data_len, per) in enumerate(geometry):
                            f_off = bitrot_io.block_offset(
                                coder.shard_size, block_i, family
                            )
                            # group mates need BOTH sub-chunks (every
                            # mate is a b_helper): one full frame-group
                            # read each — same bytes as two sub-chunk
                            # reads, half the ops
                            h1m, _h2m = bitrot_io.sub_lens(per)
                            mate_full = {
                                r: np.frombuffer(
                                    read_block(part, r, f_off, per),
                                    dtype=np.uint8,
                                )
                                for r in repair_sched.mates
                            }
                            sub2 = {
                                r: (
                                    mate_full[r][h1m:] if r in mate_full
                                    else read_sub(part, r, f_off, per, 1)
                                )
                                for r in repair_sched.b_helpers
                            }
                            pb = read_sub(
                                part, repair_sched.pb_parity, f_off, per, 1
                            )
                            sub1 = {r: v[:h1m] for r, v in mate_full.items()}
                            blk = coder.repair_data_shard(
                                repair_sched, per, sub2, pb, sub1
                            )
                            rebuilt[s_idx] += bitrot_io.frame_block(
                                blk.tobytes(), family
                            )
                    per_part_rebuilt[part.number] = rebuilt
                    continue
                except (StorageError, OSError):
                    # helper failed mid-repair AND the per-block fallback
                    # lost quorum: rebuild THIS part the generic way (and
                    # stop trying the shortcut — the survivor set just
                    # proved unreliable)
                    repair_sched = None
                    rebuilt = {idx: bytearray() for idx, _ in stale}
            if use_device:
                from ..ops.bitrot_torch import reconstruct_and_hash, to_numpy

                max_blocks = max(1, 3072 // max(len(missing_idx), 1))
                for start in range(0, full_n, max_blocks):
                    count = min(max_blocks, full_n - start)
                    surv = np.empty(
                        (count, d, coder.shard_size), dtype=np.uint8
                    )
                    for bi in range(count):
                        f_off = bitrot_io.block_offset(
                            coder.shard_size, start + bi
                        )
                        for si, idx in enumerate(survivors_idx):
                            surv[bi, si] = np.frombuffer(
                                read_block(part, idx, f_off, coder.shard_size),
                                dtype=np.uint8,
                            )
                    # reconstruct + bitrot-hash in one device dispatch:
                    # rebuilt shards are hashed while still resident
                    recon_d, digs_d = reconstruct_and_hash(
                        coder._dev, surv, tuple(survivors_idx), missing_idx
                    )
                    recon = to_numpy(recon_d)
                    digs = to_numpy(digs_d)
                    for bi in range(count):
                        for mi, idx in enumerate(missing_idx):
                            rebuilt[idx] += digs[bi, mi].tobytes()
                            rebuilt[idx] += recon[bi, mi].tobytes()
                batched_done = full_n
            for block_i, (data_len, per) in enumerate(geometry):
                if block_i < batched_done:
                    continue
                f_off = bitrot_io.block_offset(coder.shard_size, block_i, family)
                got: dict[int, np.ndarray] = {}
                for idx in survivors_idx:
                    got[idx] = np.frombuffer(
                        read_block(part, idx, f_off, per), dtype=np.uint8
                    )
                rec = coder.reconstruct_block(got, per)
                for idx, _ in stale:
                    blk = rec[idx].tobytes()
                    if not whole:
                        rebuilt[idx] += bitrot_io.frame_block(blk, family)
                    else:
                        rebuilt[idx] += blk
            per_part_rebuilt[part.number] = rebuilt
        if lock is not None and lock.lost:
            raise QuorumError(f"heal lock on {bucket}/{obj} lost; aborting commit")
        family_stats_add(family, "heal_ingress_bytes", ingress)
        healed = []
        tmp_id = str(uuid.uuid4())
        for shard_idx, disk in stale:
            dfi = FileInfo.from_dict(fi.to_dict())
            dfi.volume, dfi.name = bucket, obj
            dfi.erasure.index = shard_idx + 1
            if whole:
                # this drive's metadata must carry ITS shard's digests, not
                # the survivor's (checksums are per-drive in this format);
                # keep the object's stored algorithm (legacy may be sha256)
                from ..ops.bitrot import algorithm_from_string

                algo_str = next(
                    (c.algorithm for c in fi.erasure.checksums if c.hash),
                    DEFAULT_BITROT_ALGO.string,
                )
                dfi.erasure.checksums = [
                    ChecksumInfo(p.number, algo_str,
                                 bitrot_io.whole_file_digest(
                                     bytes(per_part_rebuilt[p.number][shard_idx]),
                                     algorithm_from_string(algo_str)))
                    for p in fi.parts
                ]
            try:
                if fi.inline_data is not None or not fi.data_dir:
                    dfi.inline_data = bytes(per_part_rebuilt[fi.parts[0].number][shard_idx])
                    disk.write_metadata(bucket, obj, dfi)
                else:
                    for part in fi.parts:
                        stage = f"{tmp_id}/{fi.data_dir}/part.{part.number}"
                        disk.create_file(
                            TMP_VOLUME, stage, bytes(per_part_rebuilt[part.number][shard_idx])
                        )
                    disk.rename_data(TMP_VOLUME, tmp_id, dfi, bucket, obj)
                healed.append(disk.endpoint)
            except (StorageError, OSError):
                # heal is per-drive best-effort, but staged parts on the
                # failed drive must not outlive the attempt
                self._sweep_staging(tmp_id, [disk])
        return {
            "healed": healed, "type": "object", "family": family,
            "ingressBytes": ingress,
            "partialRepair": repair_sched is not None,
        }

    def _verify_inline(self, m: FileInfo, coder: ErasureCoder) -> None:
        data = m.inline_data or b""
        fdig = coder.frame_digests * DIGEST
        off = 0
        for _, per in coder.shard_sizes_for(m.size):
            bitrot_io.verify_block(
                data[off : off + fdig + per], per, family=coder.family
            )
            off += fdig + per

    # -- misc --------------------------------------------------------------

    def walk_objects(self, bucket: str, prefix: str = ""):
        from . import listing

        yield from listing._merged_keys(self, bucket, prefix)

    def _to_object_info(self, bucket: str, obj: str, fi: FileInfo) -> ObjectInfo:
        return ObjectInfo(
            bucket=bucket,
            name=obj,
            version_id=fi.version_id,
            is_latest=fi.is_latest,
            delete_marker=fi.deleted,
            size=fi.size,
            mod_time=fi.mod_time,
            etag=fi.metadata.get("etag", ""),
            content_type=fi.metadata.get("content-type", "application/octet-stream"),
            user_defined={
                k: v for k, v in fi.metadata.items() if k not in ("etag", "content-type")
            },
            num_versions=fi.num_versions,
        )


class ObjectHandle:
    """Resolved read handle: concrete set + quorum-picked version + per-drive
    metadata, holding the namespace read lock until closed. Constructing
    reads is free; all I/O happens during iteration; the lock is refreshed
    during long streams and released when the last read() iterator finishes
    (or close() is called)."""

    _REFRESH_EVERY = 30.0  # seconds; well under the 120s lock TTL

    def __init__(
        self, es: ErasureSet, bucket: str, obj: str, fi: FileInfo, metas,
        mutex=None, requested_vid: str = "",
    ):
        self.es = es
        self.bucket = bucket
        self.obj = obj
        self.fi = fi
        self.metas = metas
        self._mutex = mutex
        self._vid = requested_vid

    def close(self) -> None:
        mtx, self._mutex = self._mutex, None
        if mtx is not None:
            mtx.runlock()

    def read(
        self, offset: int = 0, length: int = -1, close_when_done: bool = True
    ) -> Iterator[bytes]:
        """Iterator over one byte range. By default the handle (and its
        namespace read lock) closes when this iterator finishes — right
        for the single-read GET path. Callers issuing MULTIPLE reads over
        one handle (e.g. per-part SSE range decode) pass
        close_when_done=False and close() in their own finally, so parts
        2..N still read under the lock."""
        import time as _time

        if length < 0:
            length = self.fi.size - offset
        if offset < 0 or offset + length > self.fi.size:
            self.close()
            raise ValueError("invalid range")

        # full-object reads of eligible hot objects fill the data cache:
        # bytes below already passed per-block bitrot verification, and
        # they enter stamped with THIS read's quorum FileInfo, so the
        # cached copy shares the served copy's etag/bitrot identity.
        # The token rejects the fill if the object was invalidated while
        # streaming (a TTL-expired lock racing an overwrite).
        fill_token = None
        if offset == 0 and length == self.fi.size:
            fill_token = self.es.cache.data_admit(
                self.bucket, self.obj, self._vid, self.fi
            )
        # objects ABOVE the whole-object size gate fill the range-segment
        # tier instead: every stripe block this read fully decodes (and
        # bitrot-verified) is offered per-segment, under the same
        # invalidation-token discipline
        seg_token = None
        if fill_token is None:
            seg_token = self.es.cache.segment_admit(
                self.bucket, self.obj, self._vid, self.fi
            )
        if offset != 0 or length != self.fi.size:
            # feed the sequential-read detector (prefetch plane) with the
            # observed range — misses included, or a run could never form
            self.es.cache.segment_observe(
                self.bucket, self.obj, self._vid, offset, length, self.fi
            )

        seg_sink = None
        if seg_token is not None:
            def seg_sink(pnum: int, bi: int, data) -> None:
                self.es.cache.segment_put(
                    self.bucket, self.obj, self._vid, self.fi, pnum, bi,
                    data, seg_token,
                )

        def gen():
            last_refresh = _time.monotonic()
            collected: list[bytes] | None = [] if fill_token is not None else None
            try:
                for chunk in self.es._read_range(
                    self.bucket, self.obj, self.fi, self.metas, offset,
                    length, seg_sink,
                ):
                    now = _time.monotonic()
                    if self._mutex is not None and now - last_refresh > self._REFRESH_EVERY:
                        self._mutex.refresh()
                        last_refresh = now
                    if collected is not None:
                        # data-cache fill owns its copy (chunks may be
                        # views of per-window assembly buffers)
                        bufpool.count_copy("cache-fill")
                        collected.append(bytes(chunk))
                    yield chunk
                if collected is not None:
                    self.es.cache.data_put(
                        self.bucket, self.obj, self._vid, self.fi,
                        b"".join(collected), fill_token,
                    )
            finally:
                if close_when_done:
                    self.close()

        return gen()


class SegmentCachedObjectHandle:
    """ObjectHandle-compatible view over cached range segments: the
    hinted range is served by slicing immutable verified stripe-block
    snapshots pinned at open time — no namespace lock, no metadata
    fan-out, no shard I/O (same safety argument as CachedObjectHandle:
    invalidation through the choke point removed any overwritten entry
    before the writer returned, and these bytes are pinned). Reads
    OUTSIDE the hinted range (multi-range callers, SSE per-part decode)
    fall back to a real per-read handle so semantics never narrow."""

    def __init__(self, es: ErasureSet, bucket: str, obj: str, vid: str,
                 fi: FileInfo, start: int, length: int, rows):
        self.es = es
        self.bucket = bucket
        self.obj = obj
        self._vid = vid
        self.fi = fi
        self._start = start
        self._length = length
        self._rows = rows  # [(abs_offset, bytes)] covering the range

    def close(self) -> None:
        pass

    def read(
        self, offset: int = 0, length: int = -1, close_when_done: bool = True
    ) -> Iterator[bytes]:
        if length < 0:
            length = self.fi.size - offset
        if offset < 0 or offset + length > self.fi.size:
            raise ValueError("invalid range")
        if offset != 0 or length != self.fi.size:
            self.es.cache.segment_observe(
                self.bucket, self.obj, self._vid, offset, length, self.fi
            )
        if not (
            offset >= self._start
            and offset + length <= self._start + self._length
        ):
            # outside the pinned range: open a real handle for this read
            # (always self-closing — a leaked rlock would outlive us),
            # pinned to THIS handle's version where one exists — a
            # concurrent overwrite must not splice newer bytes into a
            # response whose headers came from self.fi
            vid = self._vid or (self.fi.version_id or "")
            _oi, h = self.es.open_object(self.bucket, self.obj, vid)
            return h.read(offset, length)

        def gen():
            end = offset + length
            for abs_off, data in self._rows:
                if abs_off + len(data) <= offset:
                    continue
                if abs_off >= end:
                    break
                mv = memoryview(data)[
                    max(offset - abs_off, 0) : end - abs_off
                ]
                for o in range(0, len(mv), 1 << 20):
                    yield mv[o : o + (1 << 20)]

        return gen()


class CachedObjectHandle:
    """ObjectHandle-compatible view over a data-cache entry: ranged reads
    slice an immutable in-memory snapshot; there is no namespace lock to
    hold or release (the snapshot cannot be torn by concurrent writers —
    invalidation removed it from the cache before any overwrite
    completed, and this handle pinned the bytes). Serves the hot-GET
    path: no metadata fan-out, no shard I/O, no lock RPCs."""

    def __init__(self, fi: FileInfo, data: bytes):
        self.fi = fi
        self._data = memoryview(data)

    def close(self) -> None:
        pass

    def read(
        self, offset: int = 0, length: int = -1, close_when_done: bool = True
    ) -> Iterator[bytes]:
        if length < 0:
            length = self.fi.size - offset
        if offset < 0 or offset + length > self.fi.size:
            raise ValueError("invalid range")

        def gen():
            mv = self._data[offset:offset + length]
            for o in range(0, len(mv), 1 << 20):
                yield mv[o:o + (1 << 20)]

        return gen()
