"""Drive health tracking with circuit breaking.

Mirrors the reference's per-drive health wrapper
(MinIO cmd/xl-storage-disk-id-check.go): every StorageAPI call
is timed and fault-counted; a drive that keeps failing is taken offline
(calls short-circuit to DiskNotFound) and probed again after a cooldown,
so one dead remote drive can't keep adding its full timeout to every
quorum operation.

Logical errors (missing files/volumes, corrupt shards) are NOT drive
faults — only transport/OS-level failures trip the breaker. A drive that
answers but has become chronically slow trips it too: the per-op EWMA
latency exceeding ``MINIO_TPU_DRIVE_LATENCY_TRIP_S`` opens the circuit
exactly like consecutive errors would (a slow-but-alive drive otherwise
taxes every quorum operation forever). The same EWMA feeds the hedged
shard-read budget in erasure/set.py.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from .. import obs
from ..fault import registry as fault_registry
from . import errors
from .interface import StorageAPI

# EWMA smoothing for per-drive call latency: ~the last dozen calls
# dominate, one outlier doesn't
_EWMA_ALPHA = 0.2
# latency trips need a warm estimator: don't judge the first few calls
_EWMA_MIN_SAMPLES = 8

# errors that indicate the DRIVE is fine and the request was just wrong
_LOGICAL = (
    errors.FileNotFound,
    errors.FileVersionNotFound,
    errors.VolumeNotFound,
    errors.VolumeExists,
    errors.VolumeNotEmpty,
    errors.FileAccessDenied,
    errors.FileCorrupt,
    errors.IsNotRegular,
)

_WRAPPED = (
    "disk_info", "make_vol", "list_vols", "stat_vol", "delete_vol",
    "write_metadata", "update_metadata", "read_version", "read_versions",
    "delete_version", "delete_versions", "rename_data", "create_file",
    "append_file", "read_file", "read_file_stream", "rename_file", "delete",
    "list_dir", "stat_info_file", "verify_file",
)


class HealthCheckedDisk(StorageAPI):
    """Circuit-breaking, latency-tracking proxy around any StorageAPI."""

    def __init__(self, inner: StorageAPI, fail_threshold: int | None = None,
                 cooldown: float | None = None,
                 latency_trip_s: float | None = None):
        self._inner = inner
        # breaker tuning rides MINIO_TPU_* knobs (analysis/knobs.py);
        # explicit constructor args (tests, embedders) still win
        # malformed tuning falls back to defaults: a breaker-knob typo
        # must not refuse to boot the object layer
        if fail_threshold is None:
            try:
                fail_threshold = int(
                    os.environ.get("MINIO_TPU_DRIVE_FAIL_THRESHOLD", "4")
                )
            except ValueError:
                fail_threshold = 4
        self._threshold = fail_threshold
        if cooldown is None:
            try:
                cooldown = float(
                    os.environ.get("MINIO_TPU_DRIVE_COOLDOWN_S", "15")
                )
            except ValueError:
                cooldown = 15.0
        self._cooldown = cooldown
        # EWMA latency above this opens the circuit (0 disables)
        if latency_trip_s is None:
            try:
                latency_trip_s = float(
                    os.environ.get("MINIO_TPU_DRIVE_LATENCY_TRIP_S", "10")
                )
            except ValueError:
                latency_trip_s = 10.0
        self._latency_trip_s = latency_trip_s
        self._mu = threading.Lock()
        self._consecutive_faults = 0
        self._open_until = 0.0  # circuit-open deadline
        self._probe_inflight = False
        self._latencies: collections.deque = collections.deque(maxlen=64)
        self.total_faults = 0
        self.timeout_faults = 0  # subset of total_faults: TimeoutError
        self.latency_trips = 0
        self._ewma = 0.0
        self._ewma_n = 0
        # per-op latency accounting (metrics-v3 /system/drive/latency):
        # op name -> [calls, total seconds]
        self._op_stats: dict[str, list] = {}

    # passthrough identity
    @property
    def endpoint(self) -> str:  # type: ignore[override]
        return self._inner.endpoint

    @property
    def disk_id(self) -> str:  # type: ignore[override]
        return getattr(self._inner, "disk_id", "")

    @disk_id.setter
    def disk_id(self, v: str) -> None:
        self._inner.disk_id = v

    @property
    def online(self) -> bool:
        with self._mu:
            return time.monotonic() >= self._open_until

    def health(self) -> dict:
        with self._mu:
            lat = list(self._latencies)
            ewma = self._ewma
        return {
            "endpoint": self.endpoint,
            "online": self.online,
            "totalFaults": self.total_faults,
            "timeoutErrors": self.timeout_faults,
            "latencyTrips": self.latency_trips,
            "avgLatencyMs": round(sum(lat) / len(lat) * 1e3, 3) if lat else 0.0,
            "ewmaLatencyMs": round(ewma * 1e3, 3),
        }

    def ewma_latency(self) -> float:
        """Smoothed per-call latency in seconds (0.0 until warm) — the
        input to the hedged-read budget in erasure/set.py."""
        with self._mu:
            return self._ewma if self._ewma_n >= _EWMA_MIN_SAMPLES else 0.0

    def _enter(self) -> bool:
        """False -> circuit open, fail fast. After the cooldown exactly ONE
        probe call is admitted (half-open); everyone else keeps failing
        fast until the probe verdict lands."""
        with self._mu:
            now = time.monotonic()
            if self._open_until == 0.0:
                return True
            if now < self._open_until:
                return False
            if self._probe_inflight:
                return False  # someone is already probing
            self._probe_inflight = True
            return True

    def _ok(self, dt: float, op: str | None = None,
            ewma: bool = True) -> None:
        tripped = False
        with self._mu:
            self._consecutive_faults = 0
            # ONLY a half-open probe success closes an open circuit: a
            # call that was already in flight when the circuit opened
            # (e.g. the latency trip below, fired by a sibling read of
            # the same window) must not re-close it on completion — that
            # would neuter the breaker under exactly the concurrent load
            # it exists for
            if self._probe_inflight:
                self._open_until = 0.0
            self._probe_inflight = False
            if ewma:
                self._latencies.append(dt)
                self._ewma_locked(dt)
            if op is not None:
                self._account_locked(op, dt)
            # latency breaker: a drive that ANSWERS but has become
            # chronically slow goes offline like an erroring one; the
            # EWMA resets so the post-cooldown probe is judged fresh.
            # Skipped while the circuit is already open: late in-flight
            # completions must not stack trips / extend the cooldown
            if (
                self._latency_trip_s > 0
                and self._open_until == 0.0
                and self._ewma_n >= _EWMA_MIN_SAMPLES
                and self._ewma > self._latency_trip_s
            ):
                tripped_ewma = self._ewma
                self._open_until = time.monotonic() + self._cooldown
                self._ewma = 0.0
                self._ewma_n = 0
                self.latency_trips += 1
                tripped = True
        if tripped:
            fault_registry.stats_add("latency_trips")
            fault_registry.emit(
                "breaker.latency-trip", drive=self.endpoint,
                ewmaMs=round(tripped_ewma * 1e3, 3),
            )

    def _fault(self, op: str | None = None, dt: float = 0.0,
               timeout: bool = False) -> None:
        with self._mu:
            self._consecutive_faults += 1
            self.total_faults += 1
            if timeout:
                self.timeout_faults += 1
            if dt > 0.0:
                self._ewma_locked(dt)
            if self._probe_inflight:
                # failed probe: re-open immediately, no threshold grace
                self._probe_inflight = False
                self._open_until = time.monotonic() + self._cooldown
                self._consecutive_faults = 0
            elif self._consecutive_faults >= self._threshold:
                self._open_until = time.monotonic() + self._cooldown
                self._consecutive_faults = 0
            if op is not None:
                self._account_locked(op, dt)

    def _ewma_locked(self, dt: float) -> None:
        if self._ewma_n == 0:
            self._ewma = dt
        else:
            self._ewma = _EWMA_ALPHA * dt + (1.0 - _EWMA_ALPHA) * self._ewma
        self._ewma_n += 1

    def _account_locked(self, name: str, dt: float) -> None:
        st = self._op_stats.get(name)
        if st is None:
            st = self._op_stats[name] = [0, 0.0]
        st[0] += 1
        st[1] += dt

    def op_stats_snapshot(self) -> dict[str, tuple[int, float]]:
        with self._mu:
            return {op: (st[0], st[1]) for op, st in self._op_stats.items()}

    def _call(self, name: str, *a, **kw):
        if not self._enter():
            raise errors.DiskNotFound(f"{self.endpoint} (circuit open)")
        # every storage op is a `storage` trace span (the reference traces
        # at its xlStorageDiskIDCheck wrapper too); the shared no-op
        # singleton unless spans are kept (a subscriber or the server's
        # span ring), with how long the op's pool task waited for a
        # worker. Op-latency accounting rides the breaker's existing
        # critical section — this is the per-shard hot path, one lock
        # acquisition per call.
        with obs.span(obs.TYPE_STORAGE, name, drive=self.endpoint,
                      queue_ns=obs.take_queue_ns()):
            t0 = time.monotonic()
            try:
                out = getattr(self._inner, name)(*a, **kw)
            except _LOGICAL:
                self._ok(time.monotonic() - t0, op=name)  # drive answered
                raise
            except TimeoutError:
                # socket.timeout/asyncio aliases land here too (3.11+):
                # classified separately for the drive timeout counter
                self._fault(op=name, dt=time.monotonic() - t0, timeout=True)
                raise
            except Exception:
                self._fault(op=name, dt=time.monotonic() - t0)
                raise
            self._ok(time.monotonic() - t0, op=name)
            return out

    def local_path(self, volume: str, path: str) -> str | None:
        # pure path math — no I/O, so no circuit involvement
        return self._inner.local_path(volume, path)

    def walk_dir(self, volume, base=""):
        # generator: account the iteration, not just construction. The
        # walk's wall time measures NAMESPACE SIZE (one call enumerates
        # every key under the prefix — tens of seconds at 10^5+ keys is
        # healthy), not device health, so it stays out of the latency
        # EWMA: one big metacache build must not trip the breaker on a
        # perfectly good drive. Faults still count like any other op.
        if not self._enter():
            raise errors.DiskNotFound(f"{self.endpoint} (circuit open)")
        t0 = time.monotonic()
        try:
            yield from self._inner.walk_dir(volume, base)
        except _LOGICAL:
            self._ok(time.monotonic() - t0, op="walk_dir", ewma=False)
            raise
        except Exception:
            self._fault()
            raise
        self._ok(time.monotonic() - t0, op="walk_dir", ewma=False)


def _make_method(name):
    def method(self, *a, **kw):
        return self._call(name, *a, **kw)

    method.__name__ = name
    return method


for _name in _WRAPPED:
    setattr(HealthCheckedDisk, _name, _make_method(_name))

# the proxies above satisfy the StorageAPI contract, but ABC computed
# abstractness before they were attached
HealthCheckedDisk.__abstractmethods__ = frozenset()
