"""Cross-node bootstrap configuration verification.

Mirrors MinIO cmd/bootstrap-peer-server.go: before a
distributed cluster settles, every node checks that its peers were
launched with the SAME configuration — endpoint layout, and the MINIO_*
environment (values hashed; credential/debug variables skipped). A node
started with a different drive list or a divergent env (e.g. one node
missing MINIO_KMS_KES_ENDPOINT) would corrupt placement or split the
cluster's behavior; surfacing the exact difference at startup beats
debugging it later.

Served as an internode-token-authed route next to the storage RPC;
checked (with retries, peers may still be booting) during bootstrap.
"""

from __future__ import annotations

import hashlib
import json

from ..server import web

BOOTSTRAP_ROUTE = "/minio/bootstrap/v1/verify"

# configured per-node by design: never part of the consistency check
_SKIP_ENVS = {
    "MINIO_ROOT_USER",
    "MINIO_OPTS",
    "MINIO_SERVER_DEBUG",
    "MINIO_PROMETHEUS_AUTH_TYPE",
}
# secret-bearing names never leave the node, even hashed (a truncated
# hash of a low-entropy token is an offline-brute-forceable oracle)
_SECRET_MARKERS = ("TOKEN", "PASSWORD", "PASSWD", "SECRET", "KEY")


def _comparable_env(name: str) -> bool:
    if not name.startswith("MINIO_") or name in _SKIP_ENVS:
        return False
    return not any(m in name for m in _SECRET_MARKERS)


def system_config(endpoint_specs: list[str], salt: str = "") -> dict:
    """This node's comparable launch configuration. Values are hashed and
    salted with the internode token so the bootstrap route reveals
    nothing even to a token holder replaying hashes offline."""
    import os

    env_hashes = {
        k: hashlib.sha256((salt + v).encode()).hexdigest()[:16]
        for k, v in os.environ.items()
        if _comparable_env(k)
    }
    return {
        "n_endpoints": len(endpoint_specs),
        "endpoints": list(endpoint_specs),
        "env": env_hashes,
    }


def diff_configs(mine: dict, theirs: dict) -> str | None:
    """First difference between two nodes' configs, None when identical
    (the reference's ServerSystemConfig.Diff)."""
    if mine["n_endpoints"] != theirs.get("n_endpoints"):
        return (
            f"expected {mine['n_endpoints']} endpoints, "
            f"peer has {theirs.get('n_endpoints')}"
        )
    if mine["endpoints"] != theirs.get("endpoints"):
        return (
            f"endpoint layout differs: {mine['endpoints']} vs "
            f"{theirs.get('endpoints')}"
        )
    mine_env, theirs_env = mine["env"], theirs.get("env", {})
    missing = sorted(set(mine_env) - set(theirs_env))
    extra = sorted(set(theirs_env) - set(mine_env))
    mismatch = sorted(
        k for k in set(mine_env) & set(theirs_env) if mine_env[k] != theirs_env[k]
    )
    if missing or extra or mismatch:
        parts = []
        if missing:
            parts.append(f"missing on peer: {missing}")
        if extra:
            parts.append(f"extra on peer: {extra}")
        if mismatch:
            parts.append(f"differing values: {mismatch}")
        return "MINIO_* environment mismatch — " + "; ".join(parts)
    return None


class BootstrapRESTServer:
    def __init__(self, cfg: dict, token: str):
        self.cfg = cfg
        self.token = token

    def register(self, app: web.Application) -> None:
        app.router.add_route("GET", BOOTSTRAP_ROUTE, self.handle)

    async def handle(self, request: web.Request) -> web.Response:
        if request.headers.get("x-minio-token") != self.token:
            return web.Response(status=403)
        return web.Response(
            body=json.dumps(self.cfg).encode(), content_type="application/json"
        )


def verify_peers(
    my_cfg: dict, peers: list[str], token: str, retries: int = 30,
    retry_delay: float = 1.0,
) -> list[str]:
    """Ask every peer for its config and diff against ours. Returns a list
    of human-readable mismatch strings (empty = consistent). Unreachable
    peers after retries are reported too — bootstrap proceeds (the node
    may be down legitimately) but the operator sees it."""
    import http.client

    def check_one(peer: str) -> str:
        host, _, port = peer.rpartition(":")
        last = "unreachable"
        # peer-probe retry pacing via the shared backoff helper
        # (fault/retry.py); fixed-interval (mult=1): peers legitimately
        # take a while to come up, exponential growth would just delay
        # the mismatch report
        from ..fault.retry import Backoff

        boff = Backoff(base_s=retry_delay, cap_s=retry_delay, mult=1.0,
                       jitter=0.0)
        for attempt in range(retries):
            try:
                from ..crypto import tlsconf

                conn = tlsconf.http_connection(host, int(port), timeout=5)
                conn.request(
                    "GET", BOOTSTRAP_ROUTE, headers={"x-minio-token": token}
                )
                r = conn.getresponse()
                body = r.read()
                conn.close()
                if r.status == 403:
                    return "internode token mismatch (different root credentials?)"
                if r.status != 200:
                    last = f"HTTP {r.status}"
                else:
                    d = diff_configs(my_cfg, json.loads(body))
                    return d if d else ""
            except (OSError, ValueError) as e:
                last = f"unreachable: {e}"
            if attempt < retries - 1:
                boff.sleep()
        return last

    # peers check in parallel: one down node must not stall bootstrap by
    # the full retry window per peer
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(peers))) as pool:
        results = list(pool.map(check_one, peers))
    return [f"peer {p}: {r}" for p, r in zip(peers, results) if r]
