"""Minimal synchronous S3 client with SigV4 signing.

Plays the role minio-go plays for the reference: a client SDK used by
tests, benchmarks, and the replication/batch subsystems to talk to any
S3-compatible endpoint (ours or the reference's).
"""

from __future__ import annotations

import http.client
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass

from .server.signature import UNSIGNED_PAYLOAD, sign_request


@dataclass
class S3Response:
    status: int
    headers: dict[str, str]
    body: bytes

    def xml(self) -> ET.Element:
        return ET.fromstring(self.body)

    @property
    def ok(self) -> bool:
        return 200 <= self.status < 300


class S3Client:
    def __init__(
        self,
        endpoint: str,
        access_key: str = "minioadmin",
        secret_key: str = "minioadmin",
        region: str = "us-east-1",
        ca_file: str | None = None,
        client_cert: tuple[str, str] | None = None,
    ):
        u = urllib.parse.urlsplit(endpoint if "//" in endpoint else f"http://{endpoint}")
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 9000
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.secure = u.scheme == "https"
        self.scheme = "https" if self.secure else "http"
        self._ssl_ctx = None
        if self.secure:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            if ca_file:
                ctx.load_verify_locations(cafile=ca_file)
            else:
                ctx.load_default_certs()
            if client_cert:
                ctx.load_cert_chain(client_cert[0], client_cert[1])
            self._ssl_ctx = ctx

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        if self.secure:
            return http.client.HTTPSConnection(
                self.host, self.port, timeout=timeout, context=self._ssl_ctx
            )
        return http.client.HTTPConnection(self.host, self.port, timeout=timeout)

    def request(
        self,
        method: str,
        path: str,
        query: dict[str, str] | None = None,
        body: bytes = b"",
        headers: dict[str, str] | None = None,
        unsigned_payload: bool = False,
        timeout: float = 60.0,
    ) -> S3Response:
        qs = urllib.parse.urlencode(query or {})
        enc_path = urllib.parse.quote(path, safe="/~-._")
        url = f"{self.scheme}://{self.host}:{self.port}{enc_path}" + (
            f"?{qs}" if qs else ""
        )
        hdrs_lower = {k.lower(): v for k, v in (headers or {}).items()}
        # an explicit content-sha256 (e.g. STREAMING-UNSIGNED-PAYLOAD-TRAILER)
        # is the payload hash to sign with, not something to clobber
        payload = hdrs_lower.get("x-amz-content-sha256") or (
            UNSIGNED_PAYLOAD if unsigned_payload else body
        )
        signed = sign_request(
            method, url, headers or {}, payload, self.access_key, self.secret_key, self.region
        )
        conn = self._connect(timeout)
        try:
            conn.request(method, enc_path + (f"?{qs}" if qs else ""), body=body, headers=signed)
            resp = conn.getresponse()
            data = resp.read()
            return S3Response(resp.status, {k.lower(): v for k, v in resp.getheaders()}, data)
        finally:
            conn.close()

    def presign(
        self, method: str, bucket: str, key: str, expires: int = 604800
    ) -> str:
        from .server.signature import presign_url

        path = urllib.parse.quote(f"/{bucket}/{key}", safe="/~-._")
        return presign_url(
            method,
            f"{self.scheme}://{self.host}:{self.port}{path}",
            self.access_key,
            self.secret_key,
            self.region,
            expires,
        )

    # -- admin plane (madmin wire) -------------------------------------------

    def admin(
        self,
        method: str,
        op: str,
        query: dict | None = None,
        body: bytes | dict | None = None,
        encrypt_body: bool = False,
    ) -> S3Response:
        """Admin call speaking the madmin wire: optionally encrypt the
        request body and transparently decrypt encrypted responses (both
        keyed by this client's secret, as `mc admin` does)."""
        import json as _json

        from .server import madmin

        if isinstance(body, dict):
            body = _json.dumps(body).encode()
        body = body or b""
        if body and encrypt_body:
            body = madmin.encrypt(self.secret_key, body)
        r = self.request(method, f"/minio/admin/v3/{op}", query=query, body=body)
        if r.body and madmin.looks_encrypted(r.body):
            try:
                return S3Response(
                    r.status, r.headers, madmin.decrypt(self.secret_key, r.body)
                )
            except madmin.MadminCryptError:
                pass
        return r

    # -- convenience wrappers ------------------------------------------------

    def make_bucket(self, bucket: str) -> S3Response:
        return self.request("PUT", f"/{bucket}")

    def delete_bucket(self, bucket: str) -> S3Response:
        return self.request("DELETE", f"/{bucket}")

    def bucket_exists(self, bucket: str) -> bool:
        return self.request("HEAD", f"/{bucket}").status == 200

    def list_buckets(self) -> list[str]:
        r = self.request("GET", "/")
        out = []
        for el in r.xml().iter():
            if el.tag.endswith("}Bucket") or el.tag == "Bucket":
                for sub in el:
                    if sub.tag.endswith("Name") and sub.text:
                        out.append(sub.text)
        return out

    def put_object(
        self, bucket: str, key: str, data: bytes, headers: dict | None = None
    ) -> S3Response:
        return self.request("PUT", f"/{bucket}/{key}", body=data, headers=headers)

    def get_object(
        self, bucket: str, key: str, query: dict | None = None, headers: dict | None = None
    ) -> S3Response:
        return self.request("GET", f"/{bucket}/{key}", query=query, headers=headers)

    def head_object(self, bucket: str, key: str, query: dict | None = None) -> S3Response:
        return self.request("HEAD", f"/{bucket}/{key}", query=query)

    def delete_object(self, bucket: str, key: str, version_id: str = "") -> S3Response:
        q = {"versionId": version_id} if version_id else None
        return self.request("DELETE", f"/{bucket}/{key}", query=q)

    def list_objects_v2(
        self, bucket: str, prefix: str = "", delimiter: str = "", max_keys: int = 1000,
        token: str = "",
    ) -> S3Response:
        q = {"list-type": "2", "prefix": prefix, "max-keys": str(max_keys)}
        if delimiter:
            q["delimiter"] = delimiter
        if token:
            q["continuation-token"] = token
        return self.request("GET", f"/{bucket}", query=q)
