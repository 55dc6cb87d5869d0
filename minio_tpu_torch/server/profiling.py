"""Cluster profiling — the `mc admin profile` analogue.

The reference's ProfileHandler (MinIO cmd/admin-handlers.go:1024)
starts CPU/heap/goroutine profiles on EVERY node for a duration and
returns the bundle. The Python equivalents here:

* cpu — a statistical sampler over `sys._current_frames()` (all threads,
  ~100 Hz), emitted as collapsed stacks (flamegraph format). Unlike
  cProfile this sees every thread and adds near-zero overhead to the
  request path.
* mem — tracemalloc top allocation sites over the window.
* threads — one goroutine-dump-style stack listing per thread.

The admin handler runs the local profile and fans out to every cluster
peer in parallel, exactly like the reference's notification-system
fan-out.

On top of the on-demand profilers sits the CONTINUOUS profiler: an
always-on (knob-gated, MINIO_TPU_PROFILE_CONTINUOUS) ~19 Hz sampler
that classifies every thread's stack by owning subsystem and publishes
the counts as the metrics-v3 wall-time-attribution series under
``/api/diag`` — a scrape answers "where does this process actually
spend its time" without anyone having run a profile. 19 Hz (a prime-ish
rate, same idea as Linux perf's default 99 Hz) avoids phase-locking
with 10/20/100 Hz periodic work; at ~50 ms per sample over a handful of
threads the overhead is far below one percent. Counts are mutated and
snapshotted under one lock (the dispatcher-stats snapshot idiom) — the
runtime sanitizer sees no unguarded shared state.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from collections import Counter


def sample_cpu(duration: float, hz: float = 100.0) -> str:
    """Collapsed-stack samples of all threads for `duration` seconds."""
    stacks: Counter[str] = Counter()
    me = threading.get_ident()
    deadline = time.monotonic() + duration
    interval = 1.0 / hz
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            parts = []
            f = frame
            while f is not None:
                code = f.f_code
                parts.append(f"{code.co_filename.rsplit('/', 1)[-1]}:{code.co_name}")
                f = f.f_back
            if parts:
                stacks[";".join(reversed(parts))] += 1
        # miniovet: ignore[blocking] -- sampler pacing; the admin profile
        # endpoint runs this whole function in a long-poll executor thread
        time.sleep(interval)
    return "\n".join(f"{s} {n}" for s, n in stacks.most_common()) + "\n"


def sample_mem(duration: float, top: int = 50) -> str:
    """Top allocation sites accumulated over the window (tracemalloc)."""
    import tracemalloc

    started_here = not tracemalloc.is_tracing()
    if started_here:
        tracemalloc.start(10)
    try:
        # miniovet: ignore[blocking] -- tracemalloc accumulation window;
        # runs in a long-poll executor thread like sample_stacks
        time.sleep(duration)
        snap = tracemalloc.take_snapshot()
        lines = []
        for st in snap.statistics("lineno")[:top]:
            lines.append(f"{st.size}B {st.count}x {st.traceback}")
        return "\n".join(lines) + "\n"
    finally:
        if started_here:
            tracemalloc.stop()


def dump_threads() -> str:
    """All-thread stack dump (the goroutine-profile analogue)."""
    out = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


PROFILERS = {
    "cpu": lambda dur: sample_cpu(dur),
    "mem": lambda dur: sample_mem(dur),
    "threads": lambda dur: dump_threads(),
}


def run_local(profiler_type: str, duration: float) -> str:
    fn = PROFILERS.get(profiler_type)
    if fn is None:
        raise ValueError(f"unknown profiler {profiler_type!r}")
    return fn(min(duration, 120.0))


def run_cluster(server, profiler_type: str, duration: float) -> dict:
    """Local profile + parallel fan-out to every peer's admin endpoint
    (peers authenticate us the same way any admin client would)."""
    from concurrent.futures import ThreadPoolExecutor

    results: dict[str, dict] = {}
    peers = getattr(server, "peers", []) or []

    def remote(peer: str) -> tuple[str, dict]:
        from ..client import S3Client

        host, _, port = peer.rpartition(":")
        cli = S3Client(
            f"{host}:{port}",
            access_key=server.iam.root_user,
            secret_key=server.iam.root_password,
        )
        r = cli.request(
            "POST",
            "/minio/admin/v3/profile",
            query={
                "profilerType": profiler_type,
                "duration": str(duration),
                "local": "true",  # stop the fan-out from recursing
            },
            timeout=duration + 30,  # a profile sends nothing until done
        )
        if r.status != 200:
            return peer, {"error": f"HTTP {r.status}"}
        import json

        return peer, json.loads(r.body)["nodes"]["local"]

    with ThreadPoolExecutor(max_workers=max(1, len(peers)) + 1) as pool:
        futs = {pool.submit(remote, p): p for p in peers}
        local = pool.submit(run_local, profiler_type, duration)
        for fut, peer in futs.items():
            try:
                name, data = fut.result(timeout=duration + 30)
                results[name] = data
            except Exception as e:  # noqa: BLE001 — a dead peer is a row
                results[peer] = {"error": str(e)}
        results["local"] = {profiler_type: local.result()}
    return {"nodes": results}


# -- continuous wall-time attribution ---------------------------------------

CONTINUOUS_KNOB = "MINIO_TPU_PROFILE_CONTINUOUS"
CONTINUOUS_HZ_KNOB = "MINIO_TPU_PROFILE_CONTINUOUS_HZ"

# first path fragment matched walking a stack innermost-out wins; order
# matters (dispatcher before the generic erasure bucket, listing before
# erasure — listing.py lives inside erasure/)
_SUBSYSTEM_PATTERNS = (
    ("minio_tpu_torch/parallel/", "dispatcher"),
    ("minio_tpu_torch/erasure/listing", "listing"),
    ("minio_tpu_torch/erasure/", "erasure"),
    ("minio_tpu_torch/storage/", "erasure"),
    ("minio_tpu_torch/cache/", "cache"),
    ("minio_tpu_torch/cluster/", "grid"),
    ("minio_tpu_torch/server/admin", "admin"),
    ("minio_tpu_torch/server/", "server"),
    ("minio_tpu_torch/diag/", "diag"),
)

# innermost frames that mean the thread is PARKED, not working — samples
# there get state="waiting" so attribution separates owning-subsystem
# wall time from actual execution
_WAIT_FUNCS = frozenset(
    {"wait", "get", "select", "poll", "accept", "recv", "recv_into",
     "read", "sleep", "acquire", "epoll", "_recv_loop"}
)


def classify_stack(frame) -> tuple[str, str]:
    """(subsystem, state) for one thread's innermost frame."""
    state = "running"
    fn = frame.f_code.co_filename
    if frame.f_code.co_name in _WAIT_FUNCS and "minio_tpu" not in fn:
        state = "waiting"
    f = frame
    while f is not None:
        path = f.f_code.co_filename
        for pat, subsystem in _SUBSYSTEM_PATTERNS:
            if pat in path:
                return subsystem, state
        f = f.f_back
    return "other", state


class ContinuousProfiler:
    """The always-on sampler thread. ``snapshot()`` is the ONLY reader
    and the sampler loop the only writer, both under ``_mu`` — the
    dispatcher-stats snapshot idiom, no unguarded shared Counter."""

    def __init__(self, hz: float = 19.0):
        self.hz = max(1.0, min(hz, 250.0))
        self._mu = threading.Lock()
        self._counts: Counter[tuple[str, str]] = Counter()
        self._samples = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ContinuousProfiler":
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="cont-profiler"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "samples": self._samples,
                "counts": dict(self._counts),
                "hz": self.hz,
            }

    def _loop(self) -> None:
        me = threading.get_ident()
        interval = 1.0 / self.hz
        # Event.wait doubles as the pacing sleep and the stop signal;
        # the dedicated daemon sampler thread never serves requests
        while not self._stop.wait(interval):
            tick: Counter[tuple[str, str]] = Counter()
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                tick[classify_stack(frame)] += 1
            with self._mu:
                self._counts.update(tick)
                self._samples += 1


def start_continuous_from_env() -> ContinuousProfiler | None:
    """The knob-gated boot hook (server/app.py main): returns a started
    profiler, or None when MINIO_TPU_PROFILE_CONTINUOUS=0."""
    if os.environ.get(CONTINUOUS_KNOB, "1") == "0":
        return None
    try:
        hz = float(os.environ.get(CONTINUOUS_HZ_KNOB, "19") or 19.0)
    except ValueError:
        hz = 19.0
    return ContinuousProfiler(hz).start()
