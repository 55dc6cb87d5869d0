"""Many-core data plane: the SO_REUSEPORT worker pool.

The asyncio serving plane is single-core by construction (one event loop,
one GIL), so everything PERF.md measured so far ran on ONE core. This
module scales the accept/parse plane across processes the way nginx and
the reference's active-active deployments do: a parent **supervisor**
spawns ``MINIO_TPU_WORKERS`` child processes (0 = auto from nproc), each
running the FULL handler stack over the same drive roots and sharing one
listen port via ``SO_REUSEPORT`` — the kernel load-balances accepted
connections across workers.

A worker is just another peer:

- **Mutation serialization** rides the existing ns-lock/dsync layer:
  every worker's locker set is [its own ``LocalLocker``] + [a
  ``_RemoteLocker`` per sibling worker], so the write quorum
  (n/2+1 of all workers) serializes cross-worker writers exactly like
  cross-node writers.
- **Cache coherence** rides the existing ``cache/coherence.py``
  choke-point broadcast: sibling workers are configured as grid peers,
  so a PUT on worker A synchronously invalidates B's and C's caches
  before the client sees 200.
- **Admin fan-out** (fault inject/clear, cache clear, trace streaming,
  profiling) reaches every worker because siblings land in
  ``server.peers`` — the same list real cluster peers ride.

Each worker therefore needs an **addressable** endpoint of its own
(SO_REUSEPORT makes the shared port land on an arbitrary worker): worker
``i`` binds a loopback *control* listener on ``port_base + i`` serving
the same app (grid, locks, storage REST, admin, metrics).

Supervision: the parent is a dumb process herder — no sockets, no store.
It forwards SIGTERM/SIGINT to the children, restarts a worker that dies
unexpectedly (throttled: a worker crashing repeatedly right after boot
takes the whole pool down rather than flapping forever), and exits when
the children are gone.

Distributed deployments keep ``MINIO_TPU_WORKERS=1`` for now: remote
peers address this node by its advertised endpoint only, and a lock RPC
landing on an arbitrary worker's table would break cross-node dsync.
The supervisor refuses the combination loudly instead of corrupting
quietly.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

# Children get these; their presence marks a process as a pool worker.
ENV_INDEX = "MINIO_TPU_WORKER_INDEX"
ENV_COUNT = "MINIO_TPU_WORKER_COUNT"
ENV_PORT_BASE = "MINIO_TPU_WORKER_PORT_BASE"

MAX_WORKERS = 64
# a worker dying this soon after spawn counts against the crash budget
CRASH_WINDOW_S = 5.0
CRASH_BUDGET = 3
# after forwarding a stop signal, workers get this long to drain before
# the supervisor escalates to SIGKILL — a wedged worker must not make
# the pool unkillable
STOP_GRACE_S = 20.0


def resolve_worker_count() -> int:
    """Requested pool size from ``MINIO_TPU_WORKERS``: 1 (default) serves
    single-process, 0 auto-sizes to the machine's cores, malformed or
    negative values refuse loudly (a typo silently serving single-core
    would defeat the whole point)."""
    raw = os.environ.get("MINIO_TPU_WORKERS", "1").strip()
    try:
        n = int(raw)
    except ValueError:
        raise SystemExit(
            f"MINIO_TPU_WORKERS={raw!r}: want a worker count "
            "(0 = auto from nproc)"
        ) from None
    if n < 0:
        raise SystemExit(f"MINIO_TPU_WORKERS={n}: want >= 0 (0 = auto)")
    if n == 0:
        n = os.cpu_count() or 1
    return min(n, MAX_WORKERS)


def worker_identity() -> tuple[int, int, int] | None:
    """(index, count, port_base) when this process is a pool worker
    (spawned by the supervisor), else None."""
    raw = os.environ.get(ENV_INDEX)
    if raw is None:
        return None
    try:
        idx = int(raw)
        count = int(os.environ.get(ENV_COUNT, "1"))
        base = int(os.environ.get(ENV_PORT_BASE, "0"))
    except ValueError:
        raise SystemExit(
            "malformed worker identity env (supervisor bug): "
            f"{ENV_INDEX}={raw!r}"
        ) from None
    if not (0 <= idx < count) or base <= 0:
        raise SystemExit(
            f"inconsistent worker identity: index={idx} count={count} "
            f"port_base={base}"
        )
    return idx, count, base


def control_port(port_base: int, index: int) -> int:
    return port_base + index


def sibling_peers(index: int, count: int, port_base: int) -> list[str]:
    """Loopback control endpoints of every OTHER worker in the pool."""
    return [
        f"127.0.0.1:{control_port(port_base, j)}"
        for j in range(count)
        if j != index
    ]


def resolve_port_base(my_port: int) -> int:
    """Control-port range start: ``MINIO_TPU_WORKER_PORT_BASE`` or the
    S3 port + 1000 (kept deterministic so every worker derives the same
    peer list without coordination)."""
    raw = os.environ.get(ENV_PORT_BASE, "").strip()
    if raw:
        try:
            base = int(raw)
        except ValueError:
            raise SystemExit(
                f"{ENV_PORT_BASE}={raw!r}: want a TCP port number"
            ) from None
    else:
        base = my_port + 1000
    if not (0 < base < 65536 - MAX_WORKERS):
        # the derived default can overflow too (--address :64600);
        # refuse loudly here rather than letting every worker crash at
        # control-listener bind until the supervisor gives up
        src = f"{ENV_PORT_BASE}={base}" if raw else (
            f"control-port base {base} (S3 port + 1000)"
        )
        raise SystemExit(
            f"{src}: out of port range; set {ENV_PORT_BASE} explicitly"
        )
    return base


def supervise(argv: list[str], workers: int, my_port: int,
              distributed: bool) -> int:
    """Run the pool: spawn `workers` children re-executing this server
    with worker identity env, restart crashers, forward signals. Returns
    the exit code for the supervisor process."""
    if distributed:
        raise SystemExit(
            f"MINIO_TPU_WORKERS={workers} with remote cluster peers is "
            "not supported yet: remote nodes address this node by one "
            "endpoint, and lock RPCs landing on an arbitrary worker "
            "would break cross-node dsync. Run 1 worker per node in "
            "distributed mode."
        )
    port_base = resolve_port_base(my_port)
    base_env = dict(os.environ)
    base_env[ENV_COUNT] = str(workers)
    base_env[ENV_PORT_BASE] = str(port_base)

    def spawn(i: int) -> subprocess.Popen:
        env = dict(base_env)
        env[ENV_INDEX] = str(i)
        return subprocess.Popen(
            [sys.executable, "-m", "minio_tpu_torch.server", *argv], env=env
        )

    procs: dict[int, subprocess.Popen] = {i: spawn(i) for i in range(workers)}
    spawned_at: dict[int, float] = {i: time.monotonic() for i in procs}
    crashes: dict[int, int] = {i: 0 for i in procs}
    stopping = {"flag": False, "since": 0.0}

    def forward(signum, _frame):
        if not stopping["flag"]:
            stopping["since"] = time.monotonic()
        stopping["flag"] = True
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.send_signal(signum)
                except OSError:
                    pass

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, forward)
    print(
        f"worker pool: {workers} workers on shared port {my_port} "
        f"(SO_REUSEPORT), control ports {port_base}..."
        f"{port_base + workers - 1}",
        flush=True,
    )

    rc = 0
    while procs:
        # miniovet: ignore[blocking] -- supervisor main thread; there is
        # no event loop in this process
        time.sleep(0.2)
        if (
            stopping["flag"]
            and time.monotonic() - stopping["since"] > STOP_GRACE_S
        ):
            for p in procs.values():
                if p.poll() is None:
                    try:
                        p.kill()
                    except OSError:
                        pass
        for i, p in list(procs.items()):
            code = p.poll()
            if code is None:
                continue
            if stopping["flag"]:
                del procs[i]
                continue
            # unexpected death: restart, unless it keeps dying young
            young = time.monotonic() - spawned_at[i] < CRASH_WINDOW_S
            crashes[i] = crashes[i] + 1 if young else 1
            if crashes[i] >= CRASH_BUDGET:
                print(
                    f"worker {i} exited {code} x{crashes[i]} within "
                    f"{CRASH_WINDOW_S:.0f}s of spawn; stopping the pool",
                    flush=True,
                )
                rc = 1
                forward(signal.SIGTERM, None)
                del procs[i]
                continue
            print(f"worker {i} exited {code}; restarting", flush=True)
            procs[i] = spawn(i)
            spawned_at[i] = time.monotonic()
    return rc
