"""Pool decommission and rebalance.

Mirrors MinIO cmd/erasure-server-pool-decom.go and
-rebalance.go: decommission drains every object of a pool into the
remaining pools (walk + re-PUT + delete, checkpointed under .minio.sys so
a restart resumes); rebalance moves objects from over-full pools toward
the pool free-space average. Both run as background threads driven from
the admin API, on the QoS background lane (their re-PUT stripe blocks
ride leftover dispatcher capacity only).

Placement-aware (placement/policy.py): rebalance never drains a key off
the pool a ``pin`` rule binds it to, and moves mis-placed pinned keys TO
their pool. Decommission overrides pins — the pool is going away.

Both movers are a ``topology`` fault-injection boundary (``fail-move`` /
``partition`` / ``latency``, target-matched against ``pool-<idx>``), and
both report progress breadth: moved objects/bytes, failures, started/
updated timestamps, live throughput and a bytes-based ETA — surfaced via
admin status and the metrics-v3 ``/api/topology`` group.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

from .. import fault, obs
from ..storage.errors import StorageError
from .quorum import ErasureError

SYSTEM_BUCKET = ".minio.sys"


def _float_env(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _check_move_fault(pool_idx: int) -> None:
    """The topology fault boundary: one check per object move. fail-move
    raises (the object stays put, the next pass retries); partition
    raises the storage-flavored error an unreachable source pool would;
    latency stalls the mover thread."""
    rule = fault.check("topology", target=f"pool-{pool_idx}", op="move")
    if rule is None:
        return
    fault.sleep_latency(rule)
    if rule.mode == "fail-move":
        raise ErasureError(f"injected topology fault: mover failed "
                           f"(rule {rule.rule_id})")
    if rule.mode == "partition":
        from ..storage.errors import DiskNotFound

        raise DiskNotFound(
            f"injected topology fault: pool-{pool_idx} partitioned "
            f"(rule {rule.rule_id})"
        )


def _exists(pool, bucket: str, raw: str) -> bool:
    from .quorum import ObjectNotFound, VersionNotFound

    try:
        pool.get_object_info(bucket, raw)
        return True
    except (ObjectNotFound, VersionNotFound):
        return False


@dataclass
class DecomStatus:
    pool_index: int
    state: str = "idle"  # idle | draining | complete | failed | canceled
    objects_moved: int = 0
    failed: int = 0
    bytes_moved: int = 0
    last_object: str = ""
    started: float = 0.0
    updated: float = 0.0
    finished: float = 0.0
    error: str = ""

    def to_persist(self) -> dict:
        """Checkpoint form: exactly the dataclass fields (the loader
        round-trips this through ``DecomStatus(**doc)``)."""
        return dict(self.__dict__)

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        # breadth aliases the admin/metrics surface documents
        d["objectsMoved"] = self.objects_moved
        d["bytesMoved"] = self.bytes_moved
        d["failedObjects"] = self.failed
        return d


class PoolManager:
    """Decommission/rebalance controller over ServerPools."""

    def __init__(self, pools):
        self.pools = pools  # ServerPools
        self.decoms: dict[int, DecomStatus] = {}
        self._cancel: set[int] = set()
        self._mu = threading.Lock()
        self._rebalance_state: dict = {"state": "idle"}
        self._rebalance_stop = threading.Event()
        self._active: set[int] = set()  # pools with a live drain thread
        # pool_data_usage_cached state (metrics scrape path): instance-
        # owned so a recycled id() can never serve another manager's view
        self._data_usage_at = 0.0
        self._data_usage: list[dict] = []

    # -- persistence -------------------------------------------------------

    def _ckpt_key(self, idx: int) -> str:
        return f"pool-decom/{idx}.json"

    def _save(self, st: DecomStatus) -> None:
        try:
            self.pools.put_object(
                SYSTEM_BUCKET, self._ckpt_key(st.pool_index),
                json.dumps(st.to_persist()).encode(),
            )
        except (ErasureError, StorageError, OSError):
            pass  # checkpoint is best-effort: a resumed drain re-copies
            # (idempotent); infra code bugs still propagate

    def load_checkpoint(self, idx: int) -> DecomStatus | None:
        from .quorum import ObjectNotFound

        try:
            _, it = self.pools.get_object(SYSTEM_BUCKET, self._ckpt_key(idx))
            doc = json.loads(b"".join(it))
            fields = DecomStatus.__dataclass_fields__
            return DecomStatus(
                **{k: v for k, v in doc.items() if k in fields}
            )
        except ObjectNotFound:
            return None  # no checkpoint yet: fresh start
        except (ValueError, TypeError, KeyError):
            # corrupt checkpoint doc: restarting the copy sweep is safe
            # (copies are idempotent). Quorum/storage errors PROPAGATE —
            # the old broad except silently discarded real progress and
            # restarted the whole decommission whenever the system
            # bucket was briefly unreadable.
            return None

    # -- decommission ------------------------------------------------------

    def start_decommission(self, pool_index: int) -> DecomStatus:
        if len(self.pools.pools) < 2:
            raise ValueError("cannot decommission the only pool")
        if not 0 <= pool_index < len(self.pools.pools):
            raise ValueError("bad pool index")
        prev = self.load_checkpoint(pool_index)
        st = prev if prev and prev.state == "draining" else DecomStatus(pool_index)
        st.state = "draining"
        st.started = st.started or time.time()
        with self._mu:
            if pool_index in self._active:
                # one mover per pool: a drain (possibly cancelling) is
                # still running — return ITS status; discarding the
                # cancel flag here would revive it mid-cancel
                return self.decoms.get(pool_index, st)
            # a prior FINISHED cancel must not instantly kill this restart
            self._cancel.discard(pool_index)
            self._active.add(pool_index)
            self.decoms[pool_index] = st
            # placement stops landing NEW objects here, or the drain
            # would chase live writes forever (stays excluded once
            # complete — the pool is awaiting removal)
            draining = getattr(self.pools, "draining", None)
            if draining is not None:
                draining.add(pool_index)
        threading.Thread(
            target=self._drain, args=(st,), daemon=True,
            name=f"decom-{pool_index}",
        ).start()
        return st

    def cancel_decommission(self, pool_index: int) -> None:
        # written from the admin handler context, read by the _drain
        # thread: set mutation rides the same lock as the decom table
        # (miniovet races pass)
        with self._mu:
            self._cancel.add(pool_index)
            draining = getattr(self.pools, "draining", None)
            if draining is not None:
                draining.discard(pool_index)  # takes new objects again

    def _cancelled(self, pool_index: int) -> bool:
        with self._mu:
            return pool_index in self._cancel

    def status(self, pool_index: int) -> DecomStatus | None:
        return self.decoms.get(pool_index) or self.load_checkpoint(pool_index)

    def decom_snapshot(self) -> dict[int, DecomStatus]:
        """In-memory decommission table only — the metrics scrape path
        must not pay a quorum checkpoint read per pool per scrape."""
        with self._mu:
            return dict(self.decoms)

    def reindex_after_remove(self, removed: int) -> None:
        """A pool was detached (placement.topology.remove_pool): indexes
        shifted, so the removed pool's decommission state — in memory
        AND the persisted checkpoints — must go, and the survivors'
        re-key. Without this, the stale 'complete' record would vouch
        for a LATER pool attached at the same index, letting
        ``pool/remove`` detach it undrained."""
        with self._mu:
            n_old = len(self.pools.pools) + 1  # pool count BEFORE removal
            old = dict(self.decoms)
            self.decoms = {}
            for i, st in old.items():
                if i == removed:
                    continue
                ni = i - 1 if i > removed else i
                st.pool_index = ni
                self.decoms[ni] = st
            self._cancel = {
                i - 1 if i > removed else i
                for i in self._cancel if i != removed
            }
            self._active = {
                i - 1 if i > removed else i
                for i in self._active if i != removed
            }
            survivors = list(self.decoms.values())
        for i in range(n_old):
            try:
                self.pools.delete_object(SYSTEM_BUCKET, self._ckpt_key(i))
            except (ErasureError, StorageError, OSError):
                pass  # no checkpoint for this index
        for st in survivors:
            self._save(st)

    def _drain(self, st: DecomStatus) -> None:
        try:
            with self._bg_ctx():
                self._drain_inner(st)
        finally:
            with self._mu:
                self._active.discard(st.pool_index)

    def _pinned(self, bucket: str, obj: str) -> int | None:
        """Pinned pool index for a key, None when unruled (or this store
        predates the placement engine — embedders, fixtures)."""
        pl = getattr(self.pools, "placement", None)
        return pl.pinned_pool(bucket, obj) if pl is not None else None

    @staticmethod
    def _move_object(src, dst, bucket: str, raw: str) -> int:
        """Move one object between pools under live traffic. Optimistic
        concurrency: after staging the copy in ``dst``, the source is
        re-checked — a writer that overwrote it mid-move wins, and the
        now-stale staged copy is withdrawn (the unguarded
        get→put→delete would have deleted the NEW version and kept the
        old copy: a lost update). Returns bytes moved (0 = withdrawn,
        the next pass sees the fresh version)."""
        from .quorum import ObjectNotFound, VersionNotFound

        oi, it = src.get_object(bucket, raw)
        data = b"".join(it)
        meta = dict(oi.user_defined)
        meta["content-type"] = oi.content_type
        meta["etag"] = oi.etag
        dst.put_object(bucket, raw, data, user_defined=meta)
        try:
            cur = src.get_object_info(bucket, raw)
            if (cur.etag, cur.mod_time) != (oi.etag, oi.mod_time):
                dst.delete_object(bucket, raw)  # raced: withdraw the copy
                return 0
        except (ObjectNotFound, VersionNotFound):
            dst.delete_object(bucket, raw)  # deleted mid-move: honor it
            return 0
        src.delete_object(bucket, raw)
        return len(data)

    @staticmethod
    def _bg_ctx():
        # QoS: decommission re-PUTs whole objects — their stripe blocks
        # ride the TPU dispatcher's background lane (leftover batch
        # capacity only), never displacing foreground traffic
        from ..qos.context import background_context

        return background_context()

    def _drain_inner(self, st: DecomStatus) -> None:
        src = self.pools.pools[st.pool_index]
        others = [
            p for i, p in enumerate(self.pools.pools) if i != st.pool_index
        ]
        def _dst_for(bucket: str, raw: str):
            # destination must not itself be draining (another
            # decommission's cursor may already have passed the keys
            # we'd hand it — they would detach with that pool);
            # re-checked per move since decoms can start concurrently.
            # Decommission overrides pins (the pool is going away) but
            # honors a pin pointing at a surviving, non-draining pool.
            draining = set(getattr(self.pools, "draining", ()) or ())
            pinned = self._pinned(bucket, raw)
            if (
                pinned is not None
                and pinned != st.pool_index
                and pinned < len(self.pools.pools)
                and pinned not in draining
            ):
                return self.pools.pools[pinned]
            live = [
                p for i, p in enumerate(self.pools.pools)
                if i != st.pool_index and i not in draining
            ]
            return live[0] if live else others[0]

        try:
            raced: list[tuple[str, str]] = []
            for b in src.list_buckets():
                for raw in src.walk_objects(b.name):
                    if self._cancelled(st.pool_index):
                        st.state = "canceled"
                        self._save(st)
                        return
                    cursor = f"{b.name}/{raw}"
                    if st.last_object and cursor <= st.last_object:
                        continue
                    try:
                        _check_move_fault(st.pool_index)
                        n = self._move_object(
                            src, _dst_for(b.name, raw), b.name, raw
                        )
                        if n > 0:
                            st.objects_moved += 1
                            st.bytes_moved += n
                        elif _exists(src, b.name, raw):
                            # a writer overwrote it mid-move: the fresh
                            # version still sits in src — retry below
                            raced.append((b.name, raw))
                    except Exception:  # noqa: BLE001
                        st.failed += 1
                    st.last_object = cursor
                    st.updated = time.time()
                    if st.objects_moved % 100 == 0:
                        self._save(st)
            # raced objects got overwritten while being moved; their
            # fresh versions still need draining (bounded retries — a
            # writer hot enough to win 5 straight rounds leaves the
            # drain "failed", never silently incomplete)
            for _ in range(5):
                if not raced:
                    break
                if self._cancelled(st.pool_index):
                    # an intentional cancel mid-retry is "canceled", not
                    # a spurious "failed" with leftover raced entries
                    st.state = "canceled"
                    self._save(st)
                    return
                still: list[tuple[str, str]] = []
                for bn, raw in raced:
                    try:
                        _check_move_fault(st.pool_index)
                        n = self._move_object(src, _dst_for(bn, raw), bn, raw)
                        if n > 0:
                            st.objects_moved += 1
                            st.bytes_moved += n
                        elif _exists(src, bn, raw):
                            still.append((bn, raw))
                    except Exception:  # noqa: BLE001
                        st.failed += 1
                raced = still
                st.updated = time.time()
            st.failed += len(raced)
            st.state = "complete" if st.failed == 0 else "failed"
        except Exception as e:  # noqa: BLE001
            st.state = "failed"
            st.error = str(e)
        st.updated = st.finished = time.time()
        self._save(st)
        from ..placement.policy import emit

        emit(obs.TYPE_REBALANCE, "decom.finish", pool=st.pool_index,
             state=st.state, objectsMoved=st.objects_moved,
             bytesMoved=st.bytes_moved, failedObjects=st.failed)

    # -- rebalance ---------------------------------------------------------

    def pool_usage(self) -> list[dict]:
        out = []
        for i, p in enumerate(self.pools.pools):
            total = free = 0
            for d in p.disks:
                try:
                    di = d.disk_info()
                    total += di.total
                    free += di.free
                except (StorageError, OSError):
                    pass  # offline drive: skip its capacity, keep the rest
            out.append(
                {"pool": i, "total": total, "free": free,
                 "usedPct": 0.0 if not total else round(100 * (1 - free / total), 2)}
            )
        return out

    def pool_data_usage(self) -> list[dict]:
        """Per-pool STORED object bytes/counts (listing walk + quorum
        size reads). Drive fill (``pool_usage``) is the production
        signal, but pools sharing one filesystem — dev boxes, CI — give
        every pool identical statvfs numbers; stored bytes always
        distinguish them, and on dedicated drives the two equalize the
        same way (fill = stored bytes + a constant). ``fillPct`` weights
        stored bytes by each pool's capacity."""
        out = []
        for i, p in enumerate(self.pools.pools):
            nbytes = nobj = 0
            total = 0
            for d in p.disks:
                try:
                    total += d.disk_info().total
                except (StorageError, OSError):
                    pass  # offline drive: skip its capacity
            try:
                for b in p.list_buckets():
                    for raw in p.walk_objects(b.name):
                        try:
                            nbytes += p.get_object_info(b.name, raw).size
                            nobj += 1
                        except (ErasureError, StorageError, OSError):
                            pass  # raced a delete/move: next pass recounts
            except (ErasureError, StorageError, OSError):
                pass  # pool mid-churn: partial view, next pass recounts
            out.append({
                "pool": i, "objects": nobj, "bytes": nbytes,
                "total": total,
                "fillPct": 0.0 if not total
                else round(100.0 * nbytes / total, 6),
            })
        return out

    def pool_data_usage_cached(self, ttl_s: float = 10.0) -> list[dict]:
        """``pool_data_usage`` behind a TTL: the metrics scrape path must
        not pay the O(objects) listing walk per scrape."""
        import time as _time

        now = _time.monotonic()
        with self._mu:
            if self._data_usage and now - self._data_usage_at <= ttl_s:
                return self._data_usage
        data = self.pool_data_usage()
        with self._mu:
            self._data_usage = data
            self._data_usage_at = now
        return data

    def start_rebalance_continuous(self, threshold_pct: float | None = None) -> dict:
        """Run rebalance passes until pool fill spread drops below the
        threshold (reference StartRebalance,
        cmd/erasure-server-pool-rebalance.go:936 — continuous with status,
        not a single pass)."""
        import threading as _threading

        if threshold_pct is None:
            threshold_pct = _float_env("MINIO_TPU_REBALANCE_THRESHOLD_PCT", 5.0)
        if len(self.pools.pools) < 2:
            raise ValueError("rebalance needs multiple pools")
        with self._mu:  # concurrent POSTs must not start two movers
            if self._rebalance_state.get("state") == "running":
                return dict(self._rebalance_state)
            self._rebalance_stop.clear()
            self._rebalance_state = {
                "state": "running", "moved": 0, "passes": 0,
                "moved_bytes": 0, "failed": 0, "skipped_pinned": 0,
                "threshold_pct": threshold_pct,
                "started": time.time(), "updated": time.time(),
                "throughput_mibps": 0.0, "eta_s": None,
            }

        def loop():
            with self._bg_ctx():
                self._rebalance_loop(threshold_pct)

        _threading.Thread(target=loop, daemon=True, name="rebalance").start()
        return dict(self._rebalance_state)

    @staticmethod
    def data_spread_pct(data: list[dict]) -> float:
        """Stored-byte imbalance: (max share − min share) × 100, where a
        pool's share is its fraction of all stored bytes. 0 = perfectly
        even, 100 = everything on one pool."""
        total = sum(u["bytes"] for u in data)
        if total <= 0 or len(data) < 2:
            return 0.0
        shares = [u["bytes"] / total for u in data]
        return 100.0 * (max(shares) - min(shares))

    @staticmethod
    def _excess_bytes(data: list[dict]) -> int:
        """Bytes sitting above the across-pool mean — what a perfect
        rebalance would still move (the ETA numerator)."""
        if not data:
            return 0
        mean = sum(u["bytes"] for u in data) / len(data)
        return int(sum(max(0.0, u["bytes"] - mean) for u in data))

    def _rebalance_progress_locked(self, st: dict, spread: float,
                                   excess: int) -> None:
        st["spread_pct"] = round(spread, 2)
        st["updated"] = time.time()
        elapsed = max(st["updated"] - st["started"], 1e-9)
        st["throughput_mibps"] = round(
            st["moved_bytes"] / (1 << 20) / elapsed, 3
        )
        bps = st["moved_bytes"] / elapsed
        st["eta_s"] = round(excess / bps, 1) if bps > 0 else None

    def _rebalance_loop(self, threshold_pct: float) -> None:
        from ..placement.policy import emit

        pause = _float_env("MINIO_TPU_REBALANCE_PAUSE_S", 0.0)
        batch = int(_float_env("MINIO_TPU_REBALANCE_BATCH", 200))
        stalled = 0  # consecutive passes that moved nothing
        while not self._rebalance_stop.is_set():
            draining = set(getattr(self.pools, "draining", ()) or ())
            full = self.pool_data_usage()  # ONE walk per iteration:
            # start_rebalance reuses it for src/dst selection below
            data = [u for u in full if u["pool"] not in draining]
            spread = self.data_spread_pct(data)
            excess = self._excess_bytes(data)
            with self._mu:
                st = self._rebalance_state
                self._rebalance_progress_locked(st, spread, excess)
                converged = spread <= threshold_pct
                if converged:
                    st["state"] = "done"
                snap = dict(st)
            if converged:
                emit(obs.TYPE_REBALANCE, "rebalance.finish",
                     state="done", **_progress_fields(snap))
                return
            try:
                out = self.start_rebalance(
                    max_objects=max(batch, 1), usage=full
                )
            except Exception as e:  # noqa: BLE001
                with self._mu:
                    st = self._rebalance_state
                    st["state"] = "failed"
                    st["error"] = str(e)
                emit(obs.TYPE_REBALANCE, "rebalance.finish",
                     state="failed", error=str(e))
                return
            with self._mu:
                st = self._rebalance_state
                st["moved"] += out.get("moved", 0)
                st["moved_bytes"] += out.get("moved_bytes", 0)
                st["failed"] += out.get("failed", 0)
                st["skipped_pinned"] += out.get("skipped_pinned", 0)
                st["passes"] += 1
                self._rebalance_progress_locked(st, spread, excess)
                stalled = 0 if out.get("moved", 0) > 0 else stalled + 1
                dry = out.get("moved", 0) == 0 and out.get("failed", 0) == 0
                wedged = stalled >= 3  # failures only, no progress: a
                # persistently unmovable object must not busy-loop the
                # mover forever (failed passes get retried twice)
                if dry:
                    st["state"] = "done"  # nothing movable: converged
                elif wedged:
                    st["state"] = "failed"
                    st["error"] = (
                        f"no progress after {stalled} passes "
                        "(persistent move failures)"
                    )
                snap = dict(st)
            emit(obs.TYPE_REBALANCE, "rebalance.pass",
                 **{**_progress_fields(snap),
                    "from": out.get("from"), "to": out.get("to")})
            if dry or wedged:
                emit(obs.TYPE_REBALANCE, "rebalance.finish",
                     state=snap["state"], **_progress_fields(snap))
                return
            # pace between passes: a pass that moved nothing (all moves
            # failing) must not re-walk the namespace back-to-back
            sleep_for = max(pause, 0.2 if out.get("moved", 0) == 0 else 0.0)
            if sleep_for > 0:
                # miniovet: ignore[blocking] -- dedicated rebalance
                # daemon thread pacing itself between passes
                time.sleep(sleep_for)
        with self._mu:
            self._rebalance_state["state"] = "stopped"

    def stop_rebalance(self) -> dict:
        self._rebalance_stop.set()
        with self._mu:
            return dict(self._rebalance_state)

    def rebalance_status(self) -> dict:
        with self._mu:
            return dict(self._rebalance_state)

    def start_rebalance(self, max_objects: int = 1000,
                        usage: list[dict] | None = None) -> dict:
        """One rebalance pass: move objects off the fullest pool (most
        stored bytes) toward the emptiest until ``max_objects`` are
        bounded. Placement-aware: keys pinned to the source pool stay
        put; keys pinned ELSEWHERE move to their pinned pool rather than
        the emptiest. ``usage`` lets the continuous loop share its
        already-computed walk instead of paying a second one."""
        if len(self.pools.pools) < 2:
            raise ValueError("rebalance needs multiple pools")
        if usage is None or len(usage) != len(self.pools.pools):
            usage = self.pool_data_usage()
        # pools under decommission belong to the drain: rebalance must
        # neither fill them (objects landing behind the drain cursor
        # would be detached with the pool) nor race it as a source
        draining = set(getattr(self.pools, "draining", ()) or ())
        live = [i for i in range(len(usage)) if i not in draining]
        if len(live) < 2:
            return {"moved": 0, "moved_bytes": 0, "failed": 0,
                    "skipped_pinned": 0}
        src_i = max(live, key=lambda i: usage[i]["bytes"])
        dst_i = min(live, key=lambda i: usage[i]["bytes"])
        if src_i == dst_i or usage[src_i]["bytes"] == usage[dst_i]["bytes"]:
            return {"moved": 0, "moved_bytes": 0, "failed": 0,
                    "skipped_pinned": 0}
        src, dst = self.pools.pools[src_i], self.pools.pools[dst_i]
        # never move past the midpoint of the byte gap: an unbounded
        # pass would overshoot and the next pass would slosh data back
        target_bytes = (usage[src_i]["bytes"] - usage[dst_i]["bytes"]) / 2
        moved = moved_bytes = failed = skipped_pinned = 0

        def out() -> dict:
            return {"moved": moved, "moved_bytes": moved_bytes,
                    "failed": failed, "skipped_pinned": skipped_pinned,
                    "from": src_i, "to": dst_i}

        for b in src.list_buckets():
            for raw in src.walk_objects(b.name):
                if moved >= max_objects or moved_bytes >= target_bytes:
                    return out()
                pinned = self._pinned(b.name, raw)
                if pinned == src_i:
                    skipped_pinned += 1
                    continue  # never drain a pinned key off its pool
                to = (
                    self.pools.pools[pinned]
                    if pinned is not None
                    and pinned < len(self.pools.pools)
                    and pinned not in draining
                    else dst
                )
                if to is src:
                    skipped_pinned += 1
                    continue
                try:
                    _check_move_fault(src_i)
                    n = self._move_object(src, to, b.name, raw)
                    if n > 0:
                        moved += 1
                        moved_bytes += n
                except (ErasureError, StorageError, OSError):
                    failed += 1  # stays put; the next pass retries
        return out()


def _progress_fields(st: dict) -> dict:
    return {
        "moved": st.get("moved", 0),
        "movedBytes": st.get("moved_bytes", 0),
        "failedObjects": st.get("failed", 0),
        "passes": st.get("passes", 0),
        "spreadPct": st.get("spread_pct", 0.0),
        "throughputMiBps": st.get("throughput_mibps", 0.0),
        "etaS": st.get("eta_s"),
    }
