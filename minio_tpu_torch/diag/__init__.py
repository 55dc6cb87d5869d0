"""diag — the self-measurement plane.

The `mc admin speedtest` / drive perf / netperf / healthinfo analogue
(reference cmd/admin-handlers.go + cmd/perf-*.go): the cluster measures
ITSELF through its own planes — object speedtest through the real
erasure path on the QoS background lane, drive speedtest straight at the
storage plane, netperf over the muxed grid websockets — so every BENCH
number can carry a hardware fingerprint of the machine that produced it.

Four admin ops drive it (``speedtest``, ``speedtest/drive``,
``speedtest/net``, ``healthinfo``/``inspect-data``), each with the same
cluster/worker fan-out convention the fault/cache/trace/profile planes
use: the coordinator replays the op on every peer with ``local=true``
and merges per-node rows.

The last completed result of each kind is kept here (mutated and read
under one lock, dispatcher-stats snapshot idiom) and feeds three
consumers: the ``/api/diag`` and ``/system/selftest`` metrics groups,
the healthinfo bundle, and the scenario engine's BENCH fingerprint
stamping. Every run opens a ``diag`` obs span, and the ``diag`` fault
boundary (slow-drive / slow-peer) injects stalls INSIDE the timed
sections — the chaos proof is that the published matrix localizes the
injected fault by name.
"""

from __future__ import annotations

import threading
import time

# last completed run per kind ("object" | "drive" | "net") plus run/error
# counters — one lock guards every mutation AND every read; consumers get
# shallow copies, never the live dicts (sanitizer-clean by construction)
_mu = threading.Lock()
_last: dict[str, dict] = {}
_runs: dict[str, int] = {}
_errors = 0


def record(kind: str, result: dict) -> None:
    """Publish a completed run as the kind's last result."""
    with _mu:
        _last[kind] = result
        _runs[kind] = _runs.get(kind, 0) + 1


def record_error() -> None:
    global _errors
    with _mu:
        _errors += 1


def last_results() -> dict[str, dict]:
    """Snapshot of the last completed result per kind."""
    with _mu:
        return {k: dict(v) for k, v in _last.items()}


def stats() -> dict:
    with _mu:
        return {"runs": dict(_runs), "errors": _errors}


def reset() -> None:
    """Test hook: forget every recorded run."""
    global _errors
    with _mu:
        _last.clear()
        _runs.clear()
        _errors = 0


def fanout_collect(server, path: str, query: dict,
                   timeout: float = 120.0) -> dict[str, dict]:
    """Replay an admin POST on every peer with ``local=true`` and parse
    the JSON rows back (the profile fan-out convention — `_admin_fanout`
    only collects statuses, the measurement planes need bodies). Peers
    run in parallel; a dead peer is an ``{"error": ...}`` row, never a
    failed matrix."""
    import json
    from concurrent.futures import ThreadPoolExecutor

    peers = getattr(server, "peers", None) or []
    if not peers:
        return {}

    def one(peer: str) -> tuple[str, dict]:
        host, _, port = peer.rpartition(":")
        try:
            from ..client import S3Client

            cli = S3Client(
                f"{host}:{port}",
                access_key=server.iam.root_user,
                secret_key=server.iam.root_password,
            )
            r = cli.request(
                "POST", f"/minio/admin/v3/{path}",
                query={**query, "local": "true"}, timeout=timeout,
            )
            if r.status != 200:
                return peer, {"error": f"HTTP {r.status}"}
            return peer, json.loads(r.body)["nodes"]["local"]
        except Exception as e:  # noqa: BLE001 — a dead peer is a row
            return peer, {"error": str(e)}

    with ThreadPoolExecutor(max_workers=min(len(peers), 16)) as pool:
        return dict(pool.map(one, peers))


def run_cluster(server, kind: str, path: str, query: dict,
                local_fn, timeout: float = 120.0) -> dict:
    """Coordinator form of a measurement op: this node's own run plus
    every peer's, keyed like the profile bundle
    (``{"nodes": {"local": row, peer: row, ...}}``)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:
        fanned = pool.submit(fanout_collect, server, path, query, timeout)
        local = local_fn()
        nodes = fanned.result()
    nodes["local"] = local
    return {"kind": kind, "time": time.time(), "nodes": nodes}


# re-exports last: the submodules read the result store above at import
from .speedtest import drive_speedtest, object_speedtest  # noqa: E402,F401
from .netperf import run_netperf  # noqa: E402,F401
from .healthinfo import build_healthinfo, inspect_data  # noqa: E402,F401
