"""MinKMS external KMS client — the third reference backend
(reference internal/kms/kms.go:291 kmsConn behind MINIO_KMS_SERVER,
selected in internal/kms/config.go:125).

Differences from KES that this client reproduces:
- **multiple endpoints** (MINIO_KMS_SERVER is a comma-separated list)
  with client-side failover: requests rotate away from a dead endpoint
  and remember the last healthy one;
- an **enclave** (MINIO_KMS_ENCLAVE) namespacing every key;
- a **default SSE key** (MINIO_KMS_SSE_KEY) used when no key id is
  given (reference kmsConn.defaultKey);
- bearer **API-key auth** (MINIO_KMS_API_KEY).

The reference talks to MinKMS through the minio/kms-go SDK (not
vendored here), so the wire format below is this project's own REST
mapping with the same operation set (Version/Status/ListKeys/CreateKey/
GenerateKey/Decrypt + encrypt for keyring sealing); errors carry a JSON
body {"code", "apiCode", "message"} that maps onto the typed
CryptoError hierarchy exactly like internal/kms/errors.go.
"""

from __future__ import annotations

import base64
import http.client
import json
import os

from .sse import (
    CryptoError,
    KeyExistsError,
    KeyNotFoundError,
    KMSBackendError,
    KMSMetrics,
    KMSPermissionError,
    counted_kms_op,
    raise_for_kms_status,
)

_API_CODE_ERRORS = {
    "kms:KeyAlreadyExists": KeyExistsError,
    "kms:KeyNotFound": KeyNotFoundError,
    "kms:NotAuthorized": KMSPermissionError,
}


class MinKMS(KMSMetrics):
    def __init__(
        self,
        endpoints: str | list[str],
        default_key: str,
        enclave: str = "default",
        api_key: str = "",
        ca_path: str = "",
        timeout: float = 10.0,
    ):
        import urllib.parse

        if isinstance(endpoints, str):
            endpoints = [e.strip() for e in endpoints.split(",") if e.strip()]
        if not endpoints:
            raise CryptoError("MinKMS needs at least one endpoint")
        self._targets: list[tuple[bool, str, int]] = []
        for ep in endpoints:
            u = urllib.parse.urlsplit(ep if "//" in ep else f"https://{ep}")
            tls = u.scheme != "http"
            self._targets.append(
                (tls, u.hostname or "", u.port or (7373 if tls else 80))
            )
        self._healthy = 0  # index of the last endpoint that answered
        self.key_id = default_key
        self.enclave = enclave or "default"
        self.api_key = api_key
        self.timeout = timeout
        self._ctx = None
        if any(t[0] for t in self._targets):
            import ssl

            self._ctx = (
                ssl.create_default_context(cafile=ca_path)
                if ca_path
                else ssl.create_default_context()
            )

    # -- transport ---------------------------------------------------------

    def _one_request(self, target, method: str, path: str, body):
        tls, host, port = target
        if tls:
            conn = http.client.HTTPSConnection(
                host, port, timeout=self.timeout, context=self._ctx
            )
        else:
            conn = http.client.HTTPConnection(host, port, timeout=self.timeout)
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        try:
            conn.request(
                method, path,
                body=json.dumps(body).encode() if body is not None else None,
                headers=headers,
            )
            r = conn.getresponse()
            data = r.read()
        finally:
            conn.close()
        if r.status not in (200, 201):
            try:
                err = json.loads(data)
            except ValueError:
                err = {}
            msg = err.get("message") or (
                f"MinKMS {method} {path}: HTTP {r.status}"
            )
            cls = _API_CODE_ERRORS.get(err.get("apiCode", ""))
            if cls is not None:
                raise cls(msg)
            raise_for_kms_status(r.status, msg)
        try:
            return json.loads(data) if data else {}
        except ValueError:
            raise KMSBackendError(
                f"MinKMS {method} {path}: malformed response body"
            ) from None

    def _request(self, method: str, path: str, body: dict | None = None):
        """Try the last-healthy endpoint first, then fail over in order —
        the reference's kms.Client load-balances/fails over across
        MINIO_KMS_SERVER endpoints the same way."""
        n = len(self._targets)
        last: Exception | None = None
        for step in range(n):
            idx = (self._healthy + step) % n
            try:
                out = self._one_request(self._targets[idx], method, path, body)
            except (OSError, http.client.HTTPException) as e:
                # transport-level failure (refused, timeout, not-HTTP
                # garbage): this endpoint is sick — try the next one. A
                # CryptoError is a real KMS answer and never fails over.
                last = e
                continue
            self._healthy = idx
            return out
        raise KMSBackendError(
            f"all MinKMS endpoints unreachable: {last}", status=502
        ) from None

    def _key_path(self, op: str, name: str) -> str:
        # percent-encode both path segments: a key name with reserved
        # characters ('/', '?', '#', spaces) must reach the server as ONE
        # segment and earn a typed error, not silently address a
        # different path
        import urllib.parse

        return (
            f"/v1/key/{op}/{urllib.parse.quote(self.enclave, safe='')}"
            f"/{urllib.parse.quote(name, safe='')}"
        )

    # -- KMS interface (mirrors crypto/sse.py KMS) -------------------------

    @counted_kms_op
    def create_key(self, name: str | None = None,
                   material: bytes | None = None) -> None:
        target = name or self.key_id
        if material is not None:
            self._request(
                "POST", self._key_path("import", target),
                {"bytes": base64.b64encode(material).decode()},
            )
            return
        self._request("POST", self._key_path("create", target))

    @counted_kms_op
    def list_keys(self, pattern: str = "*") -> list:
        # MinKMS lists by prefix (reference kmsConn.ListKeys req.Prefix);
        # translate the glob the API plane accepts into a prefix
        import urllib.parse

        prefix = pattern.split("*", 1)[0].split("?", 1)[0]
        out = self._request(
            "GET",
            f"/v1/key/list/{urllib.parse.quote(self.enclave, safe='')}"
            f"?prefix={urllib.parse.quote(prefix, safe='')}",
        )
        items = out.get("items", out) if isinstance(out, dict) else out
        import fnmatch

        names = sorted(
            str(e.get("name", "")) for e in items if isinstance(e, dict)
        )
        return [n for n in names if fnmatch.fnmatch(n, pattern or "*")]

    @counted_kms_op
    def key_status(self, name: str) -> dict:
        out = self._request("GET", self._key_path("describe", name))
        return {"key-id": name, **out}

    @counted_kms_op
    def delete_key(self, name: str) -> None:
        self._request("DELETE", self._key_path("delete", name))

    @counted_kms_op
    def generate_key(self, context: str, key_name: str | None = None) -> tuple[bytes, bytes]:
        """-> (plaintext 32B DEK, sealed blob) under the named/default key
        (reference kmsConn.GenerateKey: AssociatedData = the context)."""
        out = self._request(
            "POST", self._key_path("generate", key_name or self.key_id),
            {
                "associated_data": base64.b64encode(context.encode()).decode(),
                "length": 32,
            },
        )
        try:
            return (
                base64.b64decode(out["plaintext"]),
                base64.b64decode(out["ciphertext"]),
            )
        except (KeyError, ValueError):
            raise CryptoError("malformed MinKMS generate response") from None

    @counted_kms_op
    def seal(self, key: bytes, context: str, key_name: str | None = None) -> bytes:
        out = self._request(
            "POST", self._key_path("encrypt", key_name or self.key_id),
            {
                "plaintext": base64.b64encode(key).decode(),
                "associated_data": base64.b64encode(context.encode()).decode(),
            },
        )
        try:
            return base64.b64decode(out["ciphertext"])
        except (KeyError, ValueError):
            raise CryptoError("malformed MinKMS encrypt response") from None

    @counted_kms_op
    def unseal(self, sealed: bytes, context: str, key_name: str | None = None) -> bytes:
        out = self._request(
            "POST", self._key_path("decrypt", key_name or self.key_id),
            {
                "ciphertext": base64.b64encode(sealed).decode(),
                "associated_data": base64.b64encode(context.encode()).decode(),
            },
        )
        try:
            return base64.b64decode(out["plaintext"])
        except (KeyError, ValueError):
            raise CryptoError("malformed MinKMS decrypt response") from None

    def status(self) -> dict:
        """Per-endpoint online/offline, the reference kmsConn.Status
        shape (every endpoint probed, not just the healthy one)."""
        online: list[str] = []
        offline: list[str] = []
        for target in self._targets:
            tls, host, port = target
            label = f"{host}:{port}"
            try:
                self._one_request(target, "GET", "/version", None)
                online.append(label)
            except (OSError, http.client.HTTPException, CryptoError):
                # HTTPException: the endpoint answered non-HTTP garbage
                # (BadStatusLine et al.) — offline, not an untyped 500
                offline.append(label)
        return {
            "name": "MinKMS",
            "enclave": self.enclave,
            "defaultKey": self.key_id,
            "endpoints": {
                **{e: "online" for e in online},
                **{e: "offline" for e in offline},
            },
            "status": "online" if online else "offline",
        }


def from_env(timeout: float = 10.0) -> MinKMS:
    """Build from the reference's env surface (internal/kms/config.go:46):
    MINIO_KMS_SERVER (comma list, required), MINIO_KMS_SSE_KEY (default
    key, required), MINIO_KMS_ENCLAVE, MINIO_KMS_API_KEY."""
    endpoints = os.environ.get("MINIO_KMS_SERVER", "")
    default_key = os.environ.get("MINIO_KMS_SSE_KEY", "")
    if not default_key:
        raise CryptoError(
            "MinKMS configured (MINIO_KMS_SERVER) but no default key "
            "(MINIO_KMS_SSE_KEY)"
        )
    return MinKMS(
        endpoints,
        default_key,
        enclave=os.environ.get("MINIO_KMS_ENCLAVE", "default"),
        api_key=os.environ.get("MINIO_KMS_API_KEY", ""),
        ca_path=os.environ.get("MINIO_KMS_CAPATH", ""),
        timeout=timeout,
    )
