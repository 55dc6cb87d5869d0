"""Azure Blob and GCS warm-tier backends, dependency-free.

Mirrors the reference's warm backends (MinIO cmd/warm-backend-
azure.go, warm-backend-gcs.go) without their SDKs: Azure Blob speaks the
Blob service REST API with SharedKey request signing; GCS speaks the JSON
API with an OAuth2 service-account JWT grant (RS256 via cryptography).
Both expose the same three-method surface the tier machinery drives
(put_object/get_object/delete_object returning S3Response), so
`Tier.client()` can hand back any backend interchangeably.

The endpoint is always explicit (no hardcoded cloud hosts): production
points at the real services, tests at loopback fakes that verify the
auth material byte-for-byte.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import json
import threading
import time
import urllib.parse
from email.utils import formatdate

from ..client import S3Response

AZURE_API_VERSION = "2021-08-06"
GCS_SCOPE = "https://www.googleapis.com/auth/devstorage.read_write"


def _split_endpoint(endpoint: str) -> tuple[str, int, bool]:
    ep = endpoint
    tls = ep.startswith("https://")
    if "://" in ep:
        ep = ep.split("://", 1)[1]
    host, _, port = ep.partition(":")
    return host, int(port) if port else (443 if tls else 80), tls


def _http(host: str, port: int, tls: bool, timeout: float = 30.0):
    cls = http.client.HTTPSConnection if tls else http.client.HTTPConnection
    return cls(host, port, timeout=timeout)


class AzureWarmClient:
    """Azure Blob over raw REST with SharedKey signing.

    `account` is the storage account name, `key` its base64 access key;
    `container` maps to the tier bucket. Signing follows the published
    SharedKey canonicalization: the 12 standard headers, then lowercase
    sorted x-ms-* headers, then /account/path plus sorted query params.
    """

    def __init__(self, endpoint: str, account: str, key: str):
        self.host, self.port, self.tls = _split_endpoint(endpoint)
        self.account = account
        self.key = base64.b64decode(key)

    def _sign(self, verb: str, path: str, headers: dict[str, str],
              query: dict[str, str], content_length: int) -> str:
        std = {k.lower(): v for k, v in headers.items()}
        canon_headers = "".join(
            f"{k}:{std[k]}\n" for k in sorted(std) if k.startswith("x-ms-")
        )
        canon_resource = f"/{self.account}{path}"
        for qk in sorted(query):
            canon_resource += f"\n{qk.lower()}:{query[qk]}"
        string_to_sign = "\n".join([
            verb,
            std.get("content-encoding", ""),
            std.get("content-language", ""),
            str(content_length) if content_length else "",
            std.get("content-md5", ""),
            std.get("content-type", ""),
            "",  # Date: empty because x-ms-date is set
            std.get("if-modified-since", ""),
            std.get("if-match", ""),
            std.get("if-none-match", ""),
            std.get("if-unmodified-since", ""),
            std.get("range", ""),
        ]) + "\n" + canon_headers + canon_resource
        sig = base64.b64encode(
            hmac.new(self.key, string_to_sign.encode(), hashlib.sha256).digest()
        ).decode()
        return f"SharedKey {self.account}:{sig}"

    def _request(self, verb: str, container: str, key: str,
                 body: bytes = b"", query: dict[str, str] | None = None,
                 extra: dict[str, str] | None = None) -> S3Response:
        query = query or {}
        path = "/" + urllib.parse.quote(f"{container}/{key}")
        headers = {
            "x-ms-date": formatdate(usegmt=True),
            "x-ms-version": AZURE_API_VERSION,
        }
        if extra:
            headers.update(extra)
        if verb == "PUT":
            headers.setdefault("x-ms-blob-type", "BlockBlob")
            headers.setdefault("Content-Type", "application/octet-stream")
        headers["Authorization"] = self._sign(verb, path, headers, query, len(body))
        qs = urllib.parse.urlencode(query)
        conn = _http(self.host, self.port, self.tls)
        try:
            conn.request(verb, path + (f"?{qs}" if qs else ""), body=body,
                         headers=headers)
            resp = conn.getresponse()
            return S3Response(resp.status, dict(resp.getheaders()), resp.read())
        finally:
            conn.close()

    # -- the tier surface --------------------------------------------------

    def put_object(self, container: str, key: str, data: bytes,
                   headers: dict | None = None) -> S3Response:
        return self._request("PUT", container, key, body=data, extra=headers)

    def get_object(self, container: str, key: str, query: dict | None = None,
                   headers: dict | None = None) -> S3Response:
        # Range passes through as the standard header (signed)
        return self._request("GET", container, key, query=query or {},
                             extra=headers)

    def delete_object(self, container: str, key: str,
                      version_id: str = "") -> S3Response:
        r = self._request("DELETE", container, key)
        if r.status == 202:  # Azure answers Accepted; callers expect S3 codes
            return S3Response(204, r.headers, r.body)
        return r


class GCSWarmClient:
    """GCS JSON API over raw REST with a service-account JWT grant.

    `credentials` is the service-account JSON (dict or string) with
    client_email / private_key / token_uri. An RS256-signed JWT is
    exchanged at token_uri for a bearer token, cached until expiry.
    """

    def __init__(self, endpoint: str, credentials: dict | str):
        self.host, self.port, self.tls = _split_endpoint(endpoint)
        creds = json.loads(credentials) if isinstance(credentials, str) else credentials
        self.client_email = creds["client_email"]
        self.private_key_pem = creds["private_key"].encode()
        self.token_uri = creds["token_uri"]
        self._token = ""
        self._token_exp = 0.0
        self._mu = threading.Lock()

    @staticmethod
    def _b64url(data: bytes) -> bytes:
        return base64.urlsafe_b64encode(data).rstrip(b"=")

    def _fresh_token(self) -> str:
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import padding

        now = int(time.time())
        header = self._b64url(json.dumps({"alg": "RS256", "typ": "JWT"}).encode())
        claims = self._b64url(json.dumps({
            "iss": self.client_email, "scope": GCS_SCOPE,
            "aud": self.token_uri, "iat": now, "exp": now + 3600,
        }).encode())
        signing_input = header + b"." + claims
        pkey = serialization.load_pem_private_key(self.private_key_pem, password=None)
        sig = pkey.sign(signing_input, padding.PKCS1v15(), hashes.SHA256())
        assertion = (signing_input + b"." + self._b64url(sig)).decode()
        body = urllib.parse.urlencode({
            "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
            "assertion": assertion,
        }).encode()
        u = urllib.parse.urlparse(self.token_uri)
        conn = _http(u.hostname, u.port or (443 if u.scheme == "https" else 80),
                     u.scheme == "https")
        try:
            conn.request("POST", u.path or "/", body=body, headers={
                "Content-Type": "application/x-www-form-urlencoded"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            if resp.status != 200 or "access_token" not in data:
                raise OSError(f"gcs token exchange failed: HTTP {resp.status}")
        finally:
            conn.close()
        self._token_exp = now + int(data.get("expires_in", 3600)) - 60
        return data["access_token"]

    def _bearer(self) -> str:
        with self._mu:
            if time.time() >= self._token_exp:
                self._token = self._fresh_token()
            return self._token

    def _request(self, verb: str, path: str, body: bytes = b"",
                 query: dict[str, str] | None = None,
                 extra: dict[str, str] | None = None) -> S3Response:
        headers = {"Authorization": f"Bearer {self._bearer()}"}
        if extra:
            headers.update(extra)
        if body:
            headers.setdefault("Content-Type", "application/octet-stream")
        qs = urllib.parse.urlencode(query or {})
        conn = _http(self.host, self.port, self.tls)
        try:
            conn.request(verb, path + (f"?{qs}" if qs else ""), body=body,
                         headers=headers)
            resp = conn.getresponse()
            return S3Response(resp.status, dict(resp.getheaders()), resp.read())
        finally:
            conn.close()

    @staticmethod
    def _obj_path(bucket: str, key: str) -> str:
        return (f"/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
                f"/o/{urllib.parse.quote(key, safe='')}")

    # -- the tier surface --------------------------------------------------

    def put_object(self, bucket: str, key: str, data: bytes,
                   headers: dict | None = None) -> S3Response:
        path = f"/upload/storage/v1/b/{urllib.parse.quote(bucket, safe='')}/o"
        return self._request("POST", path, body=data,
                             query={"uploadType": "media", "name": key},
                             extra=headers)

    def get_object(self, bucket: str, key: str, query: dict | None = None,
                   headers: dict | None = None) -> S3Response:
        q = {"alt": "media"}
        q.update(query or {})
        return self._request("GET", self._obj_path(bucket, key), query=q,
                             extra=headers)

    def delete_object(self, bucket: str, key: str,
                      version_id: str = "") -> S3Response:
        return self._request("DELETE", self._obj_path(bucket, key))
