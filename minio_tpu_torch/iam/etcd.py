"""etcd-backed IAM store: shared identities across deployments.

Mirrors the reference's etcd IAM backend (MinIO cmd/
iam-etcd-store.go + internal/config/etcd): when MINIO_ETCD_ENDPOINTS is
set, IAM documents (users, groups, policies, mappings) live in etcd
instead of the object store, so several independent clusters can share
one identity plane. Speaks etcd's v3 JSON gateway (`/v3/kv/range|put|
deleterange`, base64-encoded keys/values) dependency-free — the same
protocol surface the etcd client uses over gRPC, exposed by every etcd
since 3.0 via grpc-gateway.
"""

from __future__ import annotations

import base64
import http.client
import json
import urllib.parse

from ..erasure.quorum import ObjectNotFound

KEY_PREFIX = "minio_tpu/iam/"


class EtcdError(Exception):
    pass


class EtcdKV:
    """Minimal etcd v3 JSON-gateway client (put/get/delete/list) with
    endpoint failover: each call tries the configured endpoints in order
    (last-known-good first), like the real client's balancer."""

    def __init__(self, endpoints: str | list[str], timeout: float = 10.0):
        if isinstance(endpoints, str):
            endpoints = [e.strip() for e in endpoints.split(",") if e.strip()]
        self.endpoints: list[tuple[str, int, bool]] = []
        for ep in endpoints:
            tls = ep.startswith("https://")
            if "://" in ep:
                ep = ep.split("://", 1)[1]
            host, _, port = ep.partition(":")
            self.endpoints.append((host, int(port) if port else 2379, tls))
        if not self.endpoints:
            raise ValueError("no etcd endpoints")
        self.timeout = timeout
        import threading

        self._mu = threading.Lock()  # guards endpoint-order mutation

    @staticmethod
    def _b64(data: bytes) -> str:
        return base64.b64encode(data).decode()

    def _call_one(self, ep: tuple[str, int, bool], path: str, payload: dict) -> dict:
        host, port, tls = ep
        cls = http.client.HTTPSConnection if tls else http.client.HTTPConnection
        conn = cls(host, port, timeout=self.timeout)
        try:
            conn.request("POST", path, body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise EtcdError(f"etcd {path}: HTTP {resp.status} {data[:200]!r}")
            return json.loads(data)
        except (OSError, ValueError) as e:
            raise EtcdError(f"etcd {host}:{port}{path}: {e}") from None
        finally:
            conn.close()

    def _call(self, path: str, payload: dict) -> dict:
        last: EtcdError | None = None
        with self._mu:
            snapshot = list(self.endpoints)  # iterate a stable copy
        for i, ep in enumerate(snapshot):
            try:
                out = self._call_one(ep, path, payload)
                if i:  # promote the healthy endpoint for subsequent calls
                    with self._mu:
                        if ep in self.endpoints:
                            self.endpoints.remove(ep)
                            self.endpoints.insert(0, ep)
                return out
            except EtcdError as e:
                last = e
        raise last if last is not None else EtcdError("no endpoints")

    def put(self, key: str, value: bytes) -> None:
        self._call("/v3/kv/put", {
            "key": self._b64(key.encode()), "value": self._b64(value)})

    def get(self, key: str) -> bytes | None:
        out = self._call("/v3/kv/range", {"key": self._b64(key.encode())})
        kvs = out.get("kvs") or []
        if not kvs:
            return None
        return base64.b64decode(kvs[0].get("value", ""))

    def delete(self, key: str) -> None:
        self._call("/v3/kv/deleterange", {"key": self._b64(key.encode())})

    @staticmethod
    def _range_end(prefix: bytes) -> bytes:
        """etcd prefix-range successor (prefix with last byte +1)."""
        return prefix[:-1] + bytes([prefix[-1] + 1])

    def list(self, prefix: str) -> dict[str, bytes]:
        """All keys under prefix."""
        p = prefix.encode()
        out = self._call("/v3/kv/range", {
            "key": self._b64(p), "range_end": self._b64(self._range_end(p))})
        result = {}
        for kv in out.get("kvs") or []:
            k = base64.b64decode(kv.get("key", "")).decode()
            result[k] = base64.b64decode(kv.get("value", ""))
        return result

    def watch_prefix(self, prefix: str, on_event, stop) -> None:
        """Server-streaming watch on a key prefix over the JSON gateway
        (POST /v3/watch, newline-delimited {"result": {...}} frames —
        grpc-gateway's rendering of the Watch RPC). Calls `on_event()`
        for every frame carrying events; reconnects until `stop` is set.

        The reference pairs its periodic IAM refresh with an etcd watch
        the same way (cmd/iam-etcd-store.go watch + cmd/iam.go:246).

        Robustness: a revision cursor rides each redial (start_revision =
        last seen + 1) so events landing in the reconnect gap are replayed,
        not lost; endpoints rotate on failure like _call's balancer."""
        p = prefix.encode()
        revision = 0  # last revision seen; 0 = start from "now"
        ep_idx = 0
        while not stop.is_set():
            req: dict = {
                "key": self._b64(p),
                "range_end": self._b64(self._range_end(p)),
            }
            if revision:
                req["start_revision"] = str(revision + 1)
            payload = json.dumps({"create_request": req}).encode()
            with self._mu:
                ep = self.endpoints[ep_idx % len(self.endpoints)]
            host, port, tls = ep
            cls = (http.client.HTTPSConnection if tls
                   else http.client.HTTPConnection)
            conn = cls(host, port, timeout=30)
            ok = False
            try:
                conn.request("POST", "/v3/watch", body=payload,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                if resp.status != 200:
                    raise EtcdError(f"watch: HTTP {resp.status}")
                while not stop.is_set():
                    line = resp.readline()
                    if not line:
                        break  # stream closed: reconnect
                    ok = True
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        frame = json.loads(line)
                    except ValueError:
                        continue  # partial/keepalive frame
                    result = frame.get("result") or {}
                    rev = (result.get("header") or {}).get("revision")
                    if rev:
                        try:
                            revision = max(revision, int(rev))
                        except ValueError:
                            pass
                    if result.get("events"):
                        on_event()
            except (OSError, EtcdError, http.client.HTTPException):
                pass  # gateway restart / timeout: back off and redial
            finally:
                conn.close()
            if not ok:
                ep_idx += 1  # rotate endpoints when a dial yields nothing
            stop.wait(1.0)


class EtcdIAMStore:
    """Duck-types the slice of the object-layer API IAMSys persists
    through (put_object / get_object on the system bucket), routing the
    documents to etcd. IAMSys stays completely unaware of the backend."""

    def __init__(self, kv: EtcdKV):
        self.kv = kv

    @staticmethod
    def _key(obj: str) -> str:
        return KEY_PREFIX + obj

    def put_object(self, bucket: str, obj: str, data: bytes, *a, **kw):
        self.kv.put(self._key(obj), bytes(data))

    def get_object(self, bucket: str, obj: str, *a, **kw):
        val = self.kv.get(self._key(obj))
        if val is None:
            raise ObjectNotFound(f"{bucket}/{obj}")
        return None, iter([val])

    def delete_object(self, bucket: str, obj: str, *a, **kw):
        self.kv.delete(self._key(obj))

    def watch_changes(self, on_change, stop) -> None:
        """Blocking watch over the IAM key prefix; IAMSys runs this in its
        watcher thread so another cluster's writes trigger an immediate
        cache reload instead of waiting out the refresh interval."""
        self.kv.watch_prefix(KEY_PREFIX, on_change, stop)
