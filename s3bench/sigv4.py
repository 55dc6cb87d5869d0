"""A frozen AWS Signature V4 client for S3, over plain HTTP/1.1.

The load generators send every request through this module, so the
traffic stays the same whatever a later change does to the program's own
client. Each request opens its own connection, as a client without
keep-alive does, and every payload is signed (its SHA-256 is part of the
signature).
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import urllib.parse
from datetime import datetime, timezone

ALGORITHM = "AWS4-HMAC-SHA256"
REGION = "us-east-1"
ACCESS_KEY = "minioadmin"
SECRET_KEY = "minioadmin"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _uri_encode(s: str) -> str:
    return urllib.parse.quote(s, safe="-_.~")


def signed_headers(method: str, host: str, path: str, query: dict | None,
                   payload_sha256: str, headers: dict | None = None,
                   access_key: str = ACCESS_KEY, secret_key: str = SECRET_KEY,
                   region: str = REGION, amz_date: str | None = None) -> dict:
    """The request's headers with x-amz-date, x-amz-content-sha256 and
    Authorization added."""
    if amz_date is None:
        amz_date = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    day = amz_date[:8]
    out = {k.lower(): str(v) for k, v in (headers or {}).items()}
    out["host"] = host
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_sha256
    names = sorted(out)
    canon_query = "&".join(f"{_uri_encode(k)}={_uri_encode(v)}"
                           for k, v in sorted((query or {}).items()))
    canon = "\n".join([
        method,
        urllib.parse.quote(path, safe="/-_.~"),
        canon_query,
        "".join(f"{h}:{' '.join(out[h].split())}\n" for h in names),
        ";".join(names),
        payload_sha256,
    ])
    scope = f"{day}/{region}/s3/aws4_request"
    to_sign = "\n".join([ALGORITHM, amz_date, scope,
                         hashlib.sha256(canon.encode()).hexdigest()])
    key = _hmac(_hmac(_hmac(_hmac(("AWS4" + secret_key).encode(), day), region), "s3"),
                "aws4_request")
    sig = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
    out["authorization"] = (f"{ALGORITHM} Credential={access_key}/{scope}, "
                            f"SignedHeaders={';'.join(names)}, Signature={sig}")
    return out


class Request:
    """A signed request, ready to send; signing costs the SHA-256 of the
    body, so a generator prepares requests ahead of their due time."""

    __slots__ = ("method", "path", "query", "body", "headers")

    def __init__(self, host: str, method: str, path: str, body: bytes = b"",
                 query: dict | None = None, headers: dict | None = None):
        self.method, self.path, self.query, self.body = method, path, query, body
        self.headers = signed_headers(method, host, path, query,
                                      hashlib.sha256(body).hexdigest(), headers)


def send(port: int, req: Request, timeout: float = 120.0,
         host: str = "127.0.0.1") -> tuple[int, dict, bytes]:
    """Send one request on a fresh connection: (status, headers, body)."""
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        target = urllib.parse.quote(req.path, safe="/-_.~")
        if req.query:
            target += "?" + urllib.parse.urlencode(req.query)
        conn.request(req.method, target, body=req.body, headers=req.headers)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, data
    finally:
        conn.close()
