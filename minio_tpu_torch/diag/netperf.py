"""Mesh netperf: peer×peer throughput/latency over the grid plane
(reference cmd/perf-net.go netperf).

Each node measures its OWN row of the matrix — RTT pings and echo
bursts against every peer (cluster nodes AND loopback SO_REUSEPORT
worker siblings, which ride ``server.peers`` like every other fan-out
plane) over the same muxed grid websockets production traffic uses, so
the numbers measure the real transport, not a synthetic socket. The
``speedtest/net`` admin op assembles the full matrix by replaying the
op on every peer with ``local=true``.

A ``diag/slow-peer`` fault rule stalls this node's bursts toward the
targeted peer inside the timing window — the chaos test asserts the
matrix localizes the slow peer by name. (Grid transport faults from the
``network`` boundary ALSO surface here, by construction: netperf rides
the faulted plane.)
"""

from __future__ import annotations

import os
import threading
import time

from .. import fault, obs

HANDLER = "diag.netperf"
BURST_SIZE_KNOB = "MINIO_TPU_DIAG_NETPERF_SIZE_KB"

# wired by server/app.py main() next to cache-coherence configure; the
# single-process default (no peers, loopback self row only) needs none
_mu = threading.Lock()
_peers: list[str] = []
_token = ""
_self_addr = ""


def configure(peers: list[str], token: str, self_addr: str = "") -> None:
    """Tell the netperf plane who to measure. ``self_addr`` is this
    node's own serving address — measured as the ``loopback`` row, the
    grid-stack floor every other row is read against."""
    global _peers, _token, _self_addr
    with _mu:
        _peers = list(peers)
        _token = token
        _self_addr = self_addr


def register_grid(grid) -> None:
    """Receive side: echo the burst back. Runs inline — the handler is
    pure in-memory and queueing it behind disk-bound executor work would
    measure the executor, not the network."""
    grid.register_single(HANDLER, _echo, inline=True)


def _echo(payload: bytes) -> bytes:
    return payload


def _one_peer(peer: str, token: str, size: int, count: int,
              pings: int) -> dict:
    """RTT pings + echo bursts against one peer over the shared grid
    connection. The slow-peer stall applies inside both timing windows."""
    from ..cluster.grid import shared_client

    host, _, port = peer.rpartition(":")
    out: dict = {}
    rule = fault.check("diag", peer, "netperf", modes=("slow-peer",))
    try:
        cli = shared_client(host, int(port), token, "storage")
        rtt: list[float] = []
        for _ in range(pings):
            t0 = time.perf_counter()
            if rule is not None:
                fault.sleep_latency(rule)
            cli.call(HANDLER, b"x", timeout=10.0)
            rtt.append(time.perf_counter() - t0)
        burst = os.urandom(size)
        t0 = time.perf_counter()
        for _ in range(count):
            if rule is not None:
                fault.sleep_latency(rule)
            cli.call(HANDLER, burst, timeout=30.0)
        dt = time.perf_counter() - t0
        rtt.sort()
        out = {
            # each call round-trips the burst: size bytes up + size down
            "throughputMiBps": round(
                2 * size * count / 2**20 / max(dt, 1e-9), 1
            ),
            "rttP50Ms": round(rtt[len(rtt) // 2] * 1e3, 3),
            "rttP99Ms": round(
                rtt[min(len(rtt) - 1, int(len(rtt) * 0.99))] * 1e3, 3
            ),
        }
    except Exception as e:  # noqa: BLE001 — a dead peer is a row
        out = {"error": str(e)}
    return out


def run_netperf(server, size: int = 0, count: int = 4,
                pings: int = 8) -> dict:
    """This node's matrix row: every configured peer plus the loopback
    self-measurement (grid stack floor). ``size`` 0 takes the knob
    default (MINIO_TPU_DIAG_NETPERF_SIZE_KB, 1 MiB)."""
    from . import record

    if size <= 0:
        size = max(1, int(os.environ.get(BURST_SIZE_KNOB, "1024"))) * 1024
    with _mu:
        peers, token, self_addr = list(_peers), _token, _self_addr
    rows: dict[str, dict] = {}
    with obs.span(obs.TYPE_DIAG, "netperf", peers=len(peers)):
        if self_addr:
            rows["loopback"] = _one_peer(self_addr, token, size, count, pings)
        for peer in peers:
            rows[peer] = _one_peer(peer, token, size, count, pings)
    result = {"burstSize": size, "count": count, "pings": pings,
              "peers": rows}
    record("net", result)
    return result
