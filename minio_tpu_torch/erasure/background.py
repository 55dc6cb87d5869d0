"""Background durability plane: data scanner, MRF heal queue, heal workers.

Mirrors the reference's background subsystems:
- data scanner (MinIO cmd/data-scanner.go): continuous namespace
  crawl with adaptive pacing; verifies objects, queues heals, feeds the
  data-usage cache.
- MRF — most-recent-failures (MinIO cmd/mrf.go): read-path
  degradation immediately requeues the object for heal instead of waiting
  for the next scanner cycle.
- heal workers (MinIO cmd/background-heal-ops.go): a bounded
  worker pool draining the heal queue.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import urllib.parse
from dataclasses import dataclass, field

from .set import TAGS_META_KEY


@dataclass
class DataUsage:
    buckets: dict[str, dict] = field(default_factory=dict)  # name -> {objects, size}
    last_update: float = 0.0
    cycles: int = 0

    def snapshot(self) -> dict:
        return {
            "bucketsCount": len(self.buckets),
            "objectsCount": sum(b["objects"] for b in self.buckets.values()),
            "objectsTotalSize": sum(b["size"] for b in self.buckets.values()),
            "lastUpdate": self.last_update,
            "cycles": self.cycles,
            "bucketsUsage": self.buckets,
        }


class MRFQueue:
    """Most-recent-failures: bounded dedup queue of objects needing heal."""

    def __init__(self, maxsize: int = 10000):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._pending: set[tuple[str, str]] = set()
        self._mu = threading.Lock()

    def add(self, bucket: str, obj: str) -> None:
        key = (bucket, obj)
        with self._mu:
            if key in self._pending:
                return
            self._pending.add(key)
        try:
            self._q.put_nowait(key)
        except queue.Full:
            with self._mu:
                self._pending.discard(key)

    def get(self, timeout: float) -> tuple[str, str] | None:
        try:
            key = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        with self._mu:
            self._pending.discard(key)
        return key

    def __len__(self) -> int:
        return self._q.qsize()


class BackgroundOps:
    """Scanner + heal workers for one object layer (all pools/sets)."""

    def __init__(
        self,
        store,
        scan_interval: float = 60.0,
        object_sleep: float = 0.005,
        heal_workers: int = 2,
        deep_verify: bool = False,
        bucket_meta=None,
        tiers=None,
    ):
        self.store = store
        self.bucket_meta = bucket_meta  # BucketMetadataSys for ILM evaluation
        self.tiers = tiers  # TierRegistry for ILM transitions
        self.scan_interval = scan_interval
        self.object_sleep = object_sleep
        self.deep_verify = deep_verify
        self.mrf = MRFQueue()
        self.usage = DataUsage()
        self.stats = {
            "scans": 0, "objects_scanned": 0, "heals_queued": 0,
            "heals_done": 0, "heals_failed": 0,
        }
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._heal_workers = heal_workers
        # read paths report degradation here
        self.on_degraded = self.mrf.add

    # -- lifecycle ---------------------------------------------------------

    def start(self, scanner: bool = True) -> None:
        """Start the background plane. ``scanner=False`` starts only the
        MRF heal workers — SO_REUSEPORT pool workers past index 0 must
        drain their own heal-on-read queues, but duplicating the
        namespace scanner / ILM applier / fresh-disk monitor N× over the
        SAME shared drives would race transitions and multiply bg I/O
        by the pool size (cluster peers scan their OWN drives; workers
        share them)."""
        if scanner:
            t = threading.Thread(
                target=self._scan_loop, daemon=True, name="scanner"
            )
            t.start()
            self._threads.append(t)
        for i in range(self._heal_workers):
            t = threading.Thread(
                target=self._heal_loop, daemon=True, name=f"heal-{i}"
            )
            t.start()
            self._threads.append(t)
        if scanner:
            t = threading.Thread(
                target=self._disk_monitor_loop, daemon=True, name="fresh-disk"
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()

    # -- fresh-disk heal monitor -------------------------------------------
    # A wiped/replaced local drive is detected by its missing format.json
    # (while set peers still carry the layout) and drain-healed set-wide
    # with a resumable tracker persisted ON the healing drive. Mirrors the
    # reference's dedicated monitor + healing tracker
    # (cmd/background-newdisks-heal-ops.go:415 healFreshDisk, :559
    # monitorLocalDisksAndHeal) instead of waiting for scanner cycles.

    from ..storage.format_erasure import HEALING_TRACKER  # shared with boot heal

    def _iter_sets(self):
        for p in getattr(self.store, "pools", [self.store]):
            for s in getattr(p, "sets", [p]):
                yield s

    def _disk_monitor_loop(self) -> None:
        from ..qos.context import background_context

        interval = float(os.environ.get("MINIO_TPU_DISK_MONITOR_INTERVAL", "10"))
        if interval <= 0:
            return
        with background_context():  # drain-heal blocks ride the bg TPU lane
            while not self._stop.is_set():
                try:
                    self.check_fresh_disks()
                except Exception:  # noqa: BLE001 — monitor must never die
                    pass
                self._stop.wait(interval)

    @staticmethod
    def _drive_root(disk) -> str | None:
        lp = disk.local_path(".minio.sys", "x")
        return os.path.dirname(os.path.dirname(lp)) if lp else None

    def _unmounted_guard(self, es, disk) -> bool:
        """True when healing `disk` must be SKIPPED: its root now sits on
        the OS filesystem while healthy set peers are on real mounts — the
        signature of an unmounted drive, where a drain would fill the OS
        disk and shadow the real data on remount (reference errDriveIsRoot,
        cmd/xl-storage.go root-disk detection). Single-filesystem
        deployments (all drives on one device) heal normally."""
        root = self._drive_root(disk)
        try:
            dev = os.stat(root).st_dev
            os_dev = os.stat("/").st_dev
        except OSError:
            return True  # root path gone entirely: nothing sane to heal into
        if dev != os_dev:
            return False  # on its own mount: safe
        peer_devs = set()
        for other in es.disks:
            if other is disk or other is None:
                continue
            proot = self._drive_root(other)
            if proot is None:
                continue
            try:
                peer_devs.add(os.stat(proot).st_dev)
            except OSError:
                continue
        # all peers also on the OS device -> dev/test layout, heal away
        return bool(peer_devs) and peer_devs != {os_dev}

    def check_fresh_disks(self) -> int:
        """One monitor pass: detect + drain-heal wiped local drives.
        Returns the number of drives healed (also driven by tests/admin)."""
        healed = 0
        for es in self._iter_sets():
            for disk in es.disks:
                if disk is None or disk.local_path(".minio.sys", "x") is None:
                    continue  # remote drives are monitored by their node
                if self._unmounted_guard(es, disk):
                    continue
                try:
                    if self._fresh_disk_state(es, disk):
                        self._drain_heal(es, disk)
                        healed += 1
                        self.stats["fresh_disks_healed"] = (
                            self.stats.get("fresh_disks_healed", 0) + 1
                        )
                except Exception:  # noqa: BLE001 — retry next pass
                    pass
        return healed

    def _fresh_disk_state(self, es, disk) -> bool:
        """True when `disk` needs a set-wide drain heal: wiped (format
        gone while peers keep the layout) or carrying an interrupted
        healing tracker."""
        from ..storage import errors as serr
        from ..storage import format_erasure as fe
        from ..storage.xlstorage import SYS_DIR

        try:
            disk.read_file(SYS_DIR, fe.FORMAT_FILE)
        except (serr.FileNotFound, serr.VolumeNotFound, serr.DiskNotFound):
            # wiped at runtime: peers must still agree on the layout and
            # this drive must still know its identity (disk_id in memory)
            ref = None
            for other in es.disks:
                if other is disk or other is None:
                    continue
                try:
                    ref = fe.FormatErasure.from_json(
                        other.read_file(SYS_DIR, fe.FORMAT_FILE)
                    )
                    break
                except Exception:  # noqa: BLE001
                    continue
            my_uuid = getattr(disk, "disk_id", "")
            if ref is None or not my_uuid:
                return False
            # tracker BEFORE format: a crash in between must leave the
            # drive detectable on the next pass
            disk.create_file(
                SYS_DIR, self.HEALING_TRACKER,
                json.dumps({"started": time.time(), "buckets_done": []}).encode(),
            )
            fmt = fe.FormatErasure(id=ref.id, this=my_uuid, sets=ref.sets)
            disk.create_file(SYS_DIR, fe.FORMAT_FILE, fmt.to_json())
            return True
        # format intact: resume an interrupted drain if a tracker remains
        try:
            disk.read_file(SYS_DIR, self.HEALING_TRACKER)
            return True
        except Exception:  # noqa: BLE001
            return False

    def _drain_heal(self, es, disk) -> None:
        """Set-wide drain onto one healing drive, checkpointed by bucket.

        heal_object is idempotent per object, so replaying the in-progress
        bucket after a crash converges; completed buckets are skipped via
        the tracker (the reference's healingTracker object/byte counters
        serve the same resume purpose)."""
        from ..storage.xlstorage import SYS_DIR

        def load_tracker() -> dict:
            try:
                return json.loads(disk.read_file(SYS_DIR, self.HEALING_TRACKER))
            except Exception:  # noqa: BLE001
                return {"buckets_done": []}

        tracker = load_tracker()
        done = set(tracker.get("buckets_done", []))
        # system metadata first (bucket configs, IAM, tier config live as
        # objects under .minio.sys — the reference heals the meta bucket
        # ahead of user data in healFreshDisk)
        buckets = [".minio.sys"] + sorted(b.name for b in es.list_buckets())
        for bname in buckets:
            if self._stop.is_set():
                return  # tracker stays: next pass resumes
            if bname in done:
                continue
            try:
                disk.make_vol(bname)
            except Exception:  # noqa: BLE001 — may exist
                pass
            for obj in es.walk_objects(bname):
                if self._stop.is_set():
                    return
                try:
                    # heal EVERY version: the latest alone would leave
                    # older versions one shard short on this drive
                    versions = es.list_object_versions(bname, obj)
                    for v in versions or [None]:
                        es.heal_object(
                            bname, obj,
                            getattr(v, "version_id", "") or "",
                        )
                    self.stats["heals_done"] = self.stats.get("heals_done", 0) + 1
                except Exception:  # noqa: BLE001
                    self.stats["heals_failed"] = (
                        self.stats.get("heals_failed", 0) + 1
                    )
            done.add(bname)
            tracker["buckets_done"] = sorted(done)
            disk.create_file(
                SYS_DIR, self.HEALING_TRACKER, json.dumps(tracker).encode()
            )
        disk.delete(SYS_DIR, self.HEALING_TRACKER)

    # -- scanner -----------------------------------------------------------

    def _scan_loop(self) -> None:
        from ..qos.context import background_context

        # QoS: scanner work (ILM transitions re-encode via put, deep
        # verify heals) must never displace foreground stripe blocks in
        # the TPU batch window
        with background_context():
            while not self._stop.is_set():
                try:
                    self.scan_once()
                except Exception:  # noqa: BLE001 — scanner must never die
                    pass
                self._stop.wait(self.scan_interval)

    def scan_once(self) -> DataUsage:
        """One full namespace crawl (traced as one ``scanner`` span —
        the heal/ILM work it triggers nests under it)."""
        from .. import obs

        before = self.stats["objects_scanned"]
        with obs.span(obs.TYPE_SCANNER, "scanner.cycle") as sp:
            usage = self._scan_once_inner()
            sp.set(
                objectsScanned=self.stats["objects_scanned"] - before,
                buckets=len(usage.buckets),
            )
            return usage

    def _scan_once_inner(self) -> DataUsage:
        """One full namespace crawl: usage accounting + heal detection.

        Mirrors scanDataFolder (MinIO cmd/data-scanner.go:307);
        deep_verify additionally runs bitrot verification (the reference
        deep-scans each object every N cycles)."""
        from ..ilm import lifecycle as ilm

        usage: dict[str, dict] = {}
        for b in self.store.list_buckets():
            bucket_usage = {"objects": 0, "size": 0, "versions": 0}
            rules = []
            versioned = False
            if self.bucket_meta is not None:
                bm = self.bucket_meta.get(b.name)
                versioned = bm.versioning
                if bm.lifecycle:
                    try:
                        rules = ilm.parse_lifecycle(bm.lifecycle)
                    except Exception:  # noqa: BLE001 — bad config: skip ILM
                        rules = []
            for raw in self.store.walk_objects(b.name):
                if self._stop.is_set():
                    return self.usage
                self.stats["objects_scanned"] += 1
                try:
                    if rules and self._apply_lifecycle(b.name, raw, rules, versioned):
                        continue  # expired: don't account or heal
                    needs_heal = self._inspect(b.name, raw, bucket_usage)
                    if needs_heal:
                        self.mrf.add(b.name, raw)
                        self.stats["heals_queued"] += 1
                except Exception:  # noqa: BLE001 — damaged object: queue heal
                    self.mrf.add(b.name, raw)
                    self.stats["heals_queued"] += 1
                if self.object_sleep:
                    # miniovet: ignore[blocking] -- adaptive pacing analogue
                    # on the scanner daemon thread
                    time.sleep(self.object_sleep)
            usage[b.name] = bucket_usage
        self.usage.buckets = usage
        self.usage.last_update = time.time()
        self.usage.cycles += 1
        self.stats["scans"] += 1
        if self.tiers is not None:
            from ..ilm import tier as tiermod

            try:  # retry journaled warm-tier sweeps (tier GC backstop)
                tiermod.retry_journal(self.tiers)
            except Exception:  # noqa: BLE001 — next cycle retries
                pass
        return self.usage

    def _inspect(self, bucket: str, obj: str, acc: dict) -> bool:
        """Account usage; return True when the object needs healing."""
        metas, errs, sets = [], [], None
        for cand in self._candidate_sets(obj):
            metas, errs = cand._read_all_fileinfo(bucket, obj, "", False)
            if any(m is not None and m.is_valid() for m in metas):
                sets = cand
                break
        ok = [m for m in metas if m is not None and m.is_valid()]
        if not ok or sets is None:
            return False  # dangling; GC is the scanner's later job
        fi = max(ok, key=lambda m: m.mod_time)
        if fi.deleted:
            return any(e is not None for e in errs)
        acc["objects"] += 1
        acc["size"] += fi.size
        acc["versions"] += fi.num_versions or 1
        if any(e is not None for e in errs):
            return True  # missing on some drive
        if self.deep_verify:
            try:
                res = sets.heal_object(bucket, obj)
                return bool(res.get("healed"))
            except Exception:  # noqa: BLE001
                return True
        return False

    def _apply_lifecycle(
        self, bucket: str, obj: str, rules: list, versioned: bool
    ) -> bool:
        """Evaluate + apply ILM expiry for one object; True when the
        CURRENT version was expired (reference applyLifecycle in
        cmd/data-scanner.go)."""
        from ..ilm import lifecycle as ilm
        from ..storage.pathutil import decode_dir_object

        key = decode_dir_object(obj)
        versions = self.store.list_object_versions(bucket, obj)
        if not versions:
            return False
        expired_current = False
        noncurrent_rank = 0
        for i, oi in enumerate(versions):
            if not oi.is_latest:
                noncurrent_rank += 1
            st = ilm.ObjectState(
                key=key,
                mod_time_ns=oi.mod_time,
                is_latest=oi.is_latest,
                delete_marker=oi.delete_marker,
                num_versions=len(versions),
                successor_mod_time_ns=versions[i - 1].mod_time if i else 0,
                noncurrent_rank=noncurrent_rank,
                # tag-filtered rules (Filter><And><Tag>) need the stored
                # tag set; it rides the version metadata urlencoded
                tags=dict(urllib.parse.parse_qsl(
                    (oi.user_defined or {}).get(TAGS_META_KEY, ""),
                    keep_blank_values=True,
                )),
            )
            act = ilm.eval_action(rules, st)
            try:
                if act == ilm.ACTION_DELETE:
                    self.stats["ilm_expired"] = self.stats.get("ilm_expired", 0) + 1
                    self.store.delete_object(bucket, obj, versioned=versioned)
                    expired_current = not versioned
                    if not versioned:
                        self._sweep_tier(oi)  # data gone: free the warm tier
                elif act in (ilm.ACTION_DELETE_VERSION, ilm.ACTION_DELETE_MARKER):
                    self.stats["ilm_expired"] = self.stats.get("ilm_expired", 0) + 1
                    self.store.delete_object(
                        bucket, obj, version_id=oi.version_id or ""
                    )
                    if act == ilm.ACTION_DELETE_VERSION:
                        self._sweep_tier(oi)
                elif act == ilm.ACTION_TRANSITION and oi.is_latest:
                    tier_name = ilm.transition_tier_for(rules, st)
                    self._transition(bucket, obj, oi, tier_name)
            except Exception:  # noqa: BLE001 — transient; retry next cycle
                pass
        # restored copies past their window re-stub (data stays in the tier).
        # Cheap pre-check on the already-loaded version list: an extra quorum
        # metadata read per object per cycle is only paid when the marker is
        # actually present.
        from ..ilm.tier import RESTORE_EXPIRY_META

        latest = versions[0]
        if getattr(latest, "user_defined", {}).get(RESTORE_EXPIRY_META):
            try:
                self._expire_restores(bucket, obj)
            except Exception:  # noqa: BLE001
                pass
        return expired_current

    def _sweep_tier(self, oi) -> None:
        """Tier GC for an expired transitioned version (reference
        cmd/tier-sweeper.go): the stub is gone, sweep the remote data."""
        if self.tiers is None:
            return
        from ..ilm import tier as tiermod

        ud = getattr(oi, "user_defined", None) or {}
        if tiermod.is_transitioned(ud):
            tiermod.sweep_remote(self.tiers, ud)

    def _transition(self, bucket: str, obj: str, oi, tier_name: str) -> None:
        """Move one object's data to a warm tier and stub it locally
        (reference cmd/bucket-lifecycle.go:430 transition workers)."""
        from ..ilm import tier as tiermod

        if self.tiers is None:
            return
        t = self.tiers.get(tier_name)
        if t is None:
            return
        info = self.store.get_object_info(bucket, obj)
        if tiermod.is_transitioned(info.user_defined):
            return
        # compressed/SSE objects would tier their TRANSFORMED bytes and the
        # read-through could not invert them; keep those local (the
        # reference decrypts and re-encrypts per tier — future work)
        if any(k.startswith("x-minio-internal-sse") for k in info.user_defined) or \
                info.user_defined.get("x-minio-internal-compression"):
            return
        _, it = self.store.get_object(bucket, obj)
        data = b"".join(it)
        remote_key = t.remote_key(bucket, obj)
        r = t.client().put_object(t.bucket, remote_key, data)
        # any 2xx: S3 answers 200, Azure Blob answers 201 Created
        if not 200 <= r.status < 300:
            raise RuntimeError(f"tier upload failed: HTTP {r.status}")
        self.store.transition_object(bucket, obj, tier_name, remote_key)
        self.stats["ilm_transitioned"] = self.stats.get("ilm_transitioned", 0) + 1

    def _expire_restores(self, bucket: str, obj: str) -> None:
        from ..ilm import tier as tiermod

        info = self.store.get_object_info(bucket, obj)
        exp = info.user_defined.get(tiermod.RESTORE_EXPIRY_META)
        if not exp or float(exp) > time.time():
            return
        self.store.transition_object(bucket, obj, "", "", restub=True)
        self.stats["ilm_restore_expired"] = self.stats.get("ilm_restore_expired", 0) + 1

    def _candidate_sets(self, obj: str):
        """The set that would hold obj in EACH pool (multi-pool objects
        live in exactly one pool; probe like ServerPools._pool_holding)."""
        store = self.store
        for p in getattr(store, "pools", [store]):
            yield p.get_hashed_set(obj) if hasattr(p, "get_hashed_set") else p

    # -- heal workers ------------------------------------------------------

    def _heal_loop(self) -> None:
        from ..qos.context import background_context

        with background_context():  # heal blocks ride the bg TPU lane
            while not self._stop.is_set():
                item = self.mrf.get(timeout=1.0)
                if item is None:
                    continue
                bucket, obj = item
                try:
                    self.store.heal_object(bucket, obj)
                    self.stats["heals_done"] += 1
                except Exception:  # noqa: BLE001
                    self.stats["heals_failed"] += 1
