"""KES external KMS client (reference internal/kms/conn.go:79 — the
kesConn backend behind MINIO_KMS_KES_*).

Speaks the KES REST API over http(s) with a stdlib client: key create,
generate (DEK = plaintext+ciphertext pair), decrypt, and status. Auth is
mTLS client certificates (the standard KES deployment) or a bearer API
key; both come from the kms_kes config subsystem / environment. The
object returned implements the same surface as the builtin KMS
(crypto/sse.py): generate_key / seal / unseal / status, so the SSE
pipeline is backend-agnostic.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import ssl

from .sse import (
    CryptoError,
    KMSBackendError,
    KMSMetrics,
    counted_kms_op,
    raise_for_kms_status,
)


class KESKMS(KMSMetrics):
    def __init__(
        self,
        endpoint: str,
        key_name: str,
        api_key: str = "",
        cert_file: str = "",
        key_file: str = "",
        ca_path: str = "",
        timeout: float = 10.0,
    ):
        import urllib.parse

        u = urllib.parse.urlsplit(
            endpoint if "//" in endpoint else f"https://{endpoint}"
        )
        self.host = u.hostname or ""
        self.tls = u.scheme != "http"
        self.port = u.port or (7373 if self.tls else 80)
        self.key_id = key_name
        self.api_key = api_key
        self.timeout = timeout
        self._ctx: ssl.SSLContext | None = None
        if self.tls:
            self._ctx = (
                ssl.create_default_context(cafile=ca_path)
                if ca_path
                else ssl.create_default_context()
            )
            if cert_file and key_file:
                self._ctx.load_cert_chain(cert_file, key_file)

    # -- transport ---------------------------------------------------------

    def _request(self, method: str, path: str, body: dict | None = None) -> dict:
        if self.tls:
            conn = http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout, context=self._ctx
            )
        else:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
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
            if r.status not in (200, 201):
                # typed mapping on the upstream status — never on message
                # text (reference internal/kms/errors.go Code field)
                raise_for_kms_status(
                    r.status,
                    f"KES {method} {path}: HTTP {r.status} {data[:200]!r}",
                )
            return json.loads(data) if data else {}
        except (OSError, ValueError) as e:
            raise KMSBackendError(f"KES unreachable: {e}", status=502) from None
        finally:
            conn.close()

    # -- KMS interface (mirrors crypto/sse.py KMS) -------------------------

    @counted_kms_op
    def create_key(self, name: str | None = None,
                   material: bytes | None = None) -> None:
        target = name or self.key_id
        if material is not None:
            self._request(
                "POST", f"/v1/key/import/{target}",
                {"bytes": base64.b64encode(material).decode()},
            )
            return
        self._request("POST", f"/v1/key/create/{target}")

    @counted_kms_op
    def list_keys(self, pattern: str = "*") -> list:
        out = self._request("GET", f"/v1/key/list/{pattern or '*'}")
        # KES answers a list of {name, ...} descriptors
        if isinstance(out, list):
            return sorted(
                str(e.get("name", "")) for e in out if isinstance(e, dict)
            )
        return sorted(out.get("keys", []))

    @counted_kms_op
    def key_status(self, name: str) -> dict:
        out = self._request("GET", f"/v1/key/describe/{name}")
        return {"key-id": name, **out}

    @counted_kms_op
    def delete_key(self, name: str) -> None:
        self._request("DELETE", f"/v1/key/delete/{name}")

    @counted_kms_op
    def generate_key(self, context: str, key_name: str | None = None) -> tuple[bytes, bytes]:
        """-> (plaintext 32B DEK, sealed blob to store in metadata)."""
        ctx = base64.b64encode(context.encode()).decode()
        out = self._request(
            "POST", f"/v1/key/generate/{key_name or self.key_id}",
            {"context": ctx},
        )
        try:
            return (
                base64.b64decode(out["plaintext"]),
                base64.b64decode(out["ciphertext"]),
            )
        except (KeyError, ValueError):
            raise CryptoError("malformed KES generate response") from None

    @counted_kms_op
    def seal(self, key: bytes, context: str, key_name: str | None = None) -> bytes:
        out = self._request(
            "POST",
            f"/v1/key/encrypt/{key_name or self.key_id}",
            {
                "plaintext": base64.b64encode(key).decode(),
                "context": base64.b64encode(context.encode()).decode(),
            },
        )
        try:
            return base64.b64decode(out["ciphertext"])
        except (KeyError, ValueError):
            raise CryptoError("malformed KES encrypt response") from None

    @counted_kms_op
    def unseal(self, sealed: bytes, context: str, key_name: str | None = None) -> bytes:
        out = self._request(
            "POST",
            f"/v1/key/decrypt/{key_name or self.key_id}",
            {
                "ciphertext": base64.b64encode(sealed).decode(),
                "context": base64.b64encode(context.encode()).decode(),
            },
        )
        try:
            return base64.b64decode(out["plaintext"])
        except (KeyError, ValueError):
            raise CryptoError("malformed KES decrypt response") from None

    def status(self) -> dict:
        st = self._request("GET", "/v1/status")
        return {"name": "KES", "endpoint": f"{self.host}:{self.port}", **st}


def from_env_or_config(cfg=None, store=None):
    """KMS factory (reference internal/kms/config.go:104): MinKMS, KES
    (env wins, then the kms_kes subsystem), or the builtin KMS. Unlike
    the reference's silent precedence, configuring MORE than one backend
    raises CryptoError — an operator who set both almost certainly
    believes the ignored one is active."""
    from .sse import KMS

    def setting(env: str, cfg_key: str) -> str:
        # per-field merge: env wins, the kms_kes subsystem fills the rest
        v = os.environ.get(env, "")
        if not v and cfg is not None:
            v = cfg.get("kms_kes", cfg_key)
        return v

    present = []
    if os.environ.get("MINIO_KMS_SERVER", ""):
        present.append("MinKMS (MINIO_KMS_SERVER)")
    # KES counts whether configured by env OR the kms_kes config
    # subsystem — an endpoint from either source makes it live
    if setting("MINIO_KMS_KES_ENDPOINT", "endpoint"):
        present.append("KES (MINIO_KMS_KES_ENDPOINT / kms_kes endpoint)")
    if os.environ.get("MINIO_KMS_SECRET_KEY", ""):
        present.append("static key (MINIO_KMS_SECRET_KEY)")
    if len(present) > 1:
        # mirrors the reference kms.IsPresent() contract: more than one
        # KMS backend configured is an operator error that must fail
        # loudly at boot — silently picking one by precedence could
        # encrypt under a key the operator never intended (e.g. a
        # migration that leaves the old static key exported)
        raise CryptoError(
            "ambiguous KMS configuration: " + " and ".join(present)
            + " are both set — configure exactly one backend"
        )
    if os.environ.get("MINIO_KMS_SERVER", ""):
        from .minkms import from_env

        return from_env()

    endpoint = setting("MINIO_KMS_KES_ENDPOINT", "endpoint")
    key_name = setting("MINIO_KMS_KES_KEY_NAME", "key_name")
    if endpoint and not key_name:
        # half-configured external KMS must fail loudly: silently
        # encrypting under the local key would defeat the operator's
        # intent without any visible error
        raise CryptoError(
            "KES endpoint configured but no key name "
            "(MINIO_KMS_KES_KEY_NAME / kms_kes key_name)"
        )
    if endpoint:
        return KESKMS(
            endpoint,
            key_name,
            api_key=setting("MINIO_KMS_KES_API_KEY", "api_key"),
            cert_file=setting("MINIO_KMS_KES_CERT_FILE", "cert_file"),
            key_file=setting("MINIO_KMS_KES_KEY_FILE", "key_file"),
            ca_path=setting("MINIO_KMS_KES_CAPATH", "capath"),
        )
    return KMS(store=store)
