"""Server processes on one host: ``python -m minio_tpu_torch.server``
nodes started on free ports, awaited until they serve, and stopped, as a
deployment's smoke and the cluster tests drive them.

    port = free_port_block(3)          # a pool: its port, then 2 control ports
    proc = spawn(port, drives, env, "node.log")
    wait_online([S3Client(f"127.0.0.1:{port}")], [proc])
    ...
    stop_all([proc])

Each node runs in a session of its own, so a worker pool's children go
with its supervisor, and writes its output to a log file, never to a pipe
that nobody drains.
"""

from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import sys
import time

# the directory that holds the package: the nodes import it from there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_ports(n: int) -> list[int]:
    """``n`` free ports from bind(0), held together so that they differ."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def free_port_block(n: int, lo: int = 20000, hi: int = 29000) -> int:
    """The first of ``n`` consecutive free ports, below the kernel's
    ephemeral range (/proc/sys/net/ipv4/ip_local_port_range starts at
    32768): a worker pool's control ports are its base + the worker index,
    and ports handed out by bind(0) can be taken again by other clients'
    connections between the probe and the worker's bind, which then
    crash-loops on EADDRINUSE."""
    for _ in range(256):
        base = random.randrange(lo, hi - n)
        socks = []
        try:
            for i in range(n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} free ports in [{lo}, {hi})")


def spawn(port: int, args: list, env: dict, log, module: str = "minio_tpu_torch.server",
          cwd: str = ROOT) -> subprocess.Popen:
    """One node listening on 127.0.0.1:``port`` with ``args`` (its drives
    or endpoint list, and options), its output appended to ``log``."""
    with open(log, "ab") as fh:
        return subprocess.Popen(
            [sys.executable, "-m", module, "--address", f"127.0.0.1:{port}", *map(str, args)],
            env=env, stdout=fh, stderr=subprocess.STDOUT, cwd=cwd, start_new_session=True)


def wait_online(clients, procs=(), timeout: float = 90.0) -> None:
    """Until every client's node answers ``GET /`` with 200, which it does
    once its object layer is online (a pool's workers are one client
    each). Raises RuntimeError naming the index in ``procs`` of a process
    that exited first, or TimeoutError naming the indexes in ``clients``
    still waited for."""
    deadline = time.monotonic() + timeout
    pending = list(range(len(clients)))
    while pending:
        for i, p in enumerate(procs):
            if p.poll() is not None:
                raise RuntimeError(f"process {i} exited with {p.returncode} before it came online")
        still = []
        for i in pending:
            try:
                if clients[i].request("GET", "/", timeout=5).status != 200:
                    still.append(i)
            except Exception:  # noqa: BLE001 — still starting
                still.append(i)
        pending = still
        if pending and time.monotonic() > deadline:
            raise TimeoutError(f"clients {pending} not online after {timeout} s")
        if pending:
            time.sleep(0.25)


def stop_all(procs, timeout: float = 10.0) -> None:
    """SIGKILL each process's session (a pool's workers with it, also
    where the supervisor is gone) and reap."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except OSError:
            pass  # the whole group is gone already
    for p in procs:
        try:
            p.wait(timeout)
        except subprocess.TimeoutExpired:
            pass


def tail(log, n: int = 4000) -> str:
    """The last ``n`` bytes of a node's log."""
    try:
        with open(log, "rb") as fh:
            return fh.read()[-n:].decode(errors="replace")
    except OSError:
        return ""
