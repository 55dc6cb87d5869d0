"""AWS Signature Version 4 verification (header + presigned query auth).

Implements the SigV4 algorithm the reference verifies in
MinIO cmd/signature-v4.go: canonical request -> string-to-sign ->
derived signing key -> HMAC-SHA256 signature comparison, including the S3
URI-encoding rules and UNSIGNED-PAYLOAD handling. Also provides sign_request
for clients/tests (the reference relies on minio-go for that side).
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone

from . import s3err

SIGN_V4_ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
STREAMING_PAYLOAD_TRAILER = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD-TRAILER"
STREAMING_UNSIGNED_TRAILER = "STREAMING-UNSIGNED-PAYLOAD-TRAILER"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
MAX_SKEW = timedelta(minutes=15)


def uri_encode(s: str, encode_slash: bool = True) -> str:
    """AWS canonical URI encoding (unreserved chars per SigV4 spec)."""
    safe = "-_.~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str = "s3") -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_query(params: list[tuple[str, str]], skip: set[str] = frozenset()) -> str:
    enc = [
        (uri_encode(k), uri_encode(v))
        for k, v in params
        if k not in skip
    ]
    enc.sort()
    return "&".join(f"{k}={v}" for k, v in enc)


def canonical_request(
    method: str,
    raw_path: str,
    query: list[tuple[str, str]],
    headers: dict[str, str],
    signed_headers: list[str],
    payload_hash: str,
    skip_query: set[str] = frozenset(),
) -> str:
    canon_headers = "".join(
        f"{h}:{' '.join(headers.get(h, '').split())}\n" for h in signed_headers
    )
    return "\n".join(
        [
            method,
            raw_path or "/",
            canonical_query(query, skip_query),
            canon_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )


def string_to_sign(amz_date: str, scope: str, canon_req: str) -> str:
    return "\n".join(
        [SIGN_V4_ALGORITHM, amz_date, scope, hashlib.sha256(canon_req.encode()).hexdigest()]
    )


@dataclass
class ParsedAuth:
    access_key: str
    scope_date: str
    region: str
    service: str
    signed_headers: list[str]
    signature: str

    @property
    def scope(self) -> str:
        return f"{self.scope_date}/{self.region}/{self.service}/aws4_request"


def parse_auth_header(value: str) -> ParsedAuth:
    """Parse 'AWS4-HMAC-SHA256 Credential=..., SignedHeaders=..., Signature=...'."""
    if not value.startswith(SIGN_V4_ALGORITHM):
        raise s3err.SignatureDoesNotMatch
    rest = value[len(SIGN_V4_ALGORITHM) :].strip()
    fields: dict[str, str] = {}
    for part in rest.split(","):
        part = part.strip()
        if "=" not in part:
            raise s3err.MissingFields
        k, v = part.split("=", 1)
        fields[k] = v
    try:
        cred = fields["Credential"].split("/")
        if len(cred) < 5 or cred[-1] != "aws4_request":
            raise s3err.AuthorizationHeaderMalformed
        # access keys may contain '/': scope is always the last 4 fields
        access_key = "/".join(cred[:-4])
        return ParsedAuth(
            access_key=access_key,
            scope_date=cred[-4],
            region=cred[-3],
            service=cred[-2],
            signed_headers=fields["SignedHeaders"].split(";"),
            signature=fields["Signature"],
        )
    except KeyError:
        raise s3err.MissingFields from None


class SigV4Verifier:
    """Verifies SigV4 requests against a credential lookup."""

    def __init__(self, lookup_secret, region: str = "us-east-1"):
        self.lookup_secret = lookup_secret  # access_key -> secret | None
        self.region = region

    def _check_date(self, amz_date: str) -> None:
        try:
            t = datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(tzinfo=timezone.utc)
        except ValueError:
            raise s3err.AccessDenied from None
        if abs(datetime.now(timezone.utc) - t) > MAX_SKEW:
            raise s3err.RequestTimeTooSkewed

    def verify_header_auth(
        self,
        method: str,
        raw_path: str,
        query: list[tuple[str, str]],
        headers: dict[str, str],
        payload_hash: str,
    ) -> str:
        """Verify Authorization-header SigV4; returns the access key."""
        auth = parse_auth_header(headers.get("authorization", ""))
        secret = self.lookup_secret(auth.access_key)
        if secret is None:
            raise s3err.InvalidAccessKeyId
        amz_date = headers.get("x-amz-date") or headers.get("date", "")
        self._check_date(amz_date)
        if not amz_date.startswith(auth.scope_date):
            raise s3err.SignatureDoesNotMatch
        canon = canonical_request(
            method, raw_path, query, headers, auth.signed_headers, payload_hash
        )
        sts = string_to_sign(amz_date, auth.scope, canon)
        key = signing_key(secret, auth.scope_date, auth.region, auth.service)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, auth.signature):
            raise s3err.SignatureDoesNotMatch
        return auth.access_key

    def verify_presigned(
        self,
        method: str,
        raw_path: str,
        query: list[tuple[str, str]],
        headers: dict[str, str],
    ) -> str:
        """Verify X-Amz-* query-string presigned auth; returns access key."""
        q = dict(query)
        try:
            if q.get("X-Amz-Algorithm") != SIGN_V4_ALGORITHM:
                raise s3err.SignatureDoesNotMatch
            cred = q["X-Amz-Credential"].split("/")
            amz_date = q["X-Amz-Date"]
            expires = int(q.get("X-Amz-Expires", "604800"))
            signed_headers = q["X-Amz-SignedHeaders"].split(";")
            signature = q["X-Amz-Signature"]
        except KeyError:
            raise s3err.MissingFields from None
        except ValueError:
            raise s3err.InvalidArgument from None
        if len(cred) < 5 or cred[-1] != "aws4_request":
            raise s3err.AuthorizationHeaderMalformed
        if not 1 <= expires <= 604800:
            # reference enforces 1s..7d (cmd/signature-v4-parser.go)
            raise s3err.AuthorizationQueryParametersError
        access_key = "/".join(cred[:-4])
        scope_date, region, service = cred[-4], cred[-3], cred[-2]
        secret = self.lookup_secret(access_key)
        if secret is None:
            raise s3err.InvalidAccessKeyId
        try:
            t = datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(tzinfo=timezone.utc)
        except ValueError:
            raise s3err.AccessDenied from None
        if datetime.now(timezone.utc) > t + timedelta(seconds=expires):
            raise s3err.ExpiredPresignRequest
        payload_hash = q.get("X-Amz-Content-Sha256", UNSIGNED_PAYLOAD)
        scope = f"{scope_date}/{region}/{service}/aws4_request"
        canon = canonical_request(
            method,
            raw_path,
            query,
            headers,
            signed_headers,
            payload_hash,
            skip_query={"X-Amz-Signature"},
        )
        sts = string_to_sign(amz_date, scope, canon)
        key = signing_key(secret, scope_date, region, service)
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, signature):
            raise s3err.SignatureDoesNotMatch
        return access_key


def presign_url(
    method: str,
    url: str,
    access_key: str,
    secret_key: str,
    region: str = "us-east-1",
    expires: int = 604800,
    service: str = "s3",
) -> str:
    """Client-side: produce a presigned (query-auth) URL for ``url``."""
    u = urllib.parse.urlsplit(url)
    amz_date = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    scope_date = amz_date[:8]
    scope = f"{scope_date}/{region}/{service}/aws4_request"
    q = urllib.parse.parse_qsl(u.query, keep_blank_values=True)
    q += [
        ("X-Amz-Algorithm", SIGN_V4_ALGORITHM),
        ("X-Amz-Credential", f"{access_key}/{scope}"),
        ("X-Amz-Date", amz_date),
        ("X-Amz-Expires", str(expires)),
        ("X-Amz-SignedHeaders", "host"),
    ]
    canon = canonical_request(
        method, u.path or "/", q, {"host": u.netloc}, ["host"], UNSIGNED_PAYLOAD
    )
    sts = string_to_sign(amz_date, scope, canon)
    key = signing_key(secret_key, scope_date, region, service)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    q.append(("X-Amz-Signature", sig))
    return urllib.parse.urlunsplit(
        (u.scheme, u.netloc, u.path, urllib.parse.urlencode(q), "")
    )


def sign_request(
    method: str,
    url: str,
    headers: dict[str, str],
    payload: bytes | str,
    access_key: str,
    secret_key: str,
    region: str = "us-east-1",
    amz_date: str | None = None,
) -> dict[str, str]:
    """Client-side signer (for tests/SDK): returns headers incl. Authorization."""
    parsed = urllib.parse.urlsplit(url)
    if amz_date is None:
        amz_date = datetime.now(timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    scope_date = amz_date[:8]
    out = {k.lower(): v for k, v in headers.items()}
    out["host"] = parsed.netloc
    out["x-amz-date"] = amz_date
    if isinstance(payload, str):
        payload_hash = payload  # pre-computed / UNSIGNED-PAYLOAD
    else:
        payload_hash = hashlib.sha256(payload).hexdigest()
    out["x-amz-content-sha256"] = payload_hash
    signed_headers = sorted(out.keys())
    query = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    raw_path = urllib.parse.quote(urllib.parse.unquote(parsed.path), safe="/-_.~")
    canon = canonical_request(method, raw_path, query, out, signed_headers, payload_hash)
    scope = f"{scope_date}/{region}/s3/aws4_request"
    sts = string_to_sign(amz_date, scope, canon)
    key = signing_key(secret_key, scope_date, region)
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    out["authorization"] = (
        f"{SIGN_V4_ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed_headers)}, Signature={sig}"
    )
    return out


# -- Signature V2 (deprecated AWS auth, reference cmd/signature-v2.go) -------

SIGN_V2_ALGORITHM = "AWS"

# sub-resources included in the V2 canonicalized resource, pre-sorted
V2_RESOURCE_LIST = [
    "acl", "cors", "delete", "encryption", "legal-hold", "lifecycle",
    "location", "logging", "notification", "partNumber", "policy",
    "requestPayment", "response-cache-control", "response-content-disposition",
    "response-content-encoding", "response-content-language",
    "response-content-type", "response-expires", "retention", "select",
    "select-type", "tagging", "torrent", "uploadId", "uploads", "versionId",
    "versioning", "versions", "website",
]


def _canonicalized_amz_headers_v2(headers: dict[str, str]) -> str:
    amz: dict[str, list[str]] = {}
    for k, v in headers.items():
        lk = k.lower()
        if lk.startswith("x-amz-"):
            amz.setdefault(lk, []).append(v.strip())
    return "\n".join(f"{k}:{','.join(vs)}" for k, vs in sorted(amz.items()))


def _canonicalized_resource_v2(encoded_resource: str, encoded_query: str) -> str:
    keyval: dict[str, str] = {}
    for q in encoded_query.split("&"):
        if not q:
            continue
        k, _, v = q.partition("=")
        keyval[k] = v
    parts = []
    for key in V2_RESOURCE_LIST:
        if key in keyval:
            parts.append(f"{key}={keyval[key]}" if keyval[key] else key)
    return encoded_resource + (f"?{'&'.join(parts)}" if parts else "")


def string_to_sign_v2(
    method: str,
    encoded_resource: str,
    encoded_query: str,
    headers: dict[str, str],
    expires: str = "",
) -> str:
    """V2 StringToSign (expires set -> presigned form, Date replaced)."""
    canonical_headers = _canonicalized_amz_headers_v2(headers)
    if canonical_headers:
        canonical_headers += "\n"
    date = expires or headers.get("date", "")
    return (
        "\n".join(
            [
                method,
                headers.get("content-md5", ""),
                headers.get("content-type", ""),
                date,
                canonical_headers,
            ]
        )
        + _canonicalized_resource_v2(encoded_resource, encoded_query)
    )


def _v2_signature(secret: str, sts: str) -> str:
    import base64

    return base64.b64encode(
        hmac.new(secret.encode(), sts.encode("utf-8"), hashlib.sha1).digest()
    ).decode()


def _unescape_query_v2(raw_query: str) -> str:
    """Decode each &-separated element (reference unescapeQueries: split
    FIRST, then QueryUnescape each element) — V2 canonicalization works
    on decoded values."""
    return "&".join(
        urllib.parse.unquote_plus(q) for q in raw_query.split("&") if q
    )


def sign_request_v2(
    method: str,
    url: str,
    headers: dict[str, str],
    access_key: str,
    secret_key: str,
) -> dict[str, str]:
    """Client-side V2 signer (tests / legacy SDK compatibility)."""
    from email.utils import formatdate

    parsed = urllib.parse.urlsplit(url)
    out = {k.lower(): v for k, v in headers.items()}
    out.setdefault("date", formatdate(usegmt=True))
    out["host"] = parsed.netloc
    sts = string_to_sign_v2(
        method, parsed.path, _unescape_query_v2(parsed.query), out
    )
    out["authorization"] = (
        f"{SIGN_V2_ALGORITHM} {access_key}:{_v2_signature(secret_key, sts)}"
    )
    return out


def presign_url_v2(
    method: str, url: str, access_key: str, secret_key: str, expires_in: int
) -> str:
    import time as _time

    parsed = urllib.parse.urlsplit(url)
    expires = str(int(_time.time()) + expires_in)
    sts = string_to_sign_v2(
        method, parsed.path, _unescape_query_v2(parsed.query), {}, expires
    )
    q = {
        "AWSAccessKeyId": access_key,
        "Expires": expires,
        "Signature": _v2_signature(secret_key, sts),
    }
    sep = "&" if parsed.query else "?"
    return f"{url}{sep}{urllib.parse.urlencode(q)}"


class SigV2Verifier:
    """Server-side V2 verification (header + presigned query forms)."""

    def __init__(self, lookup_secret):
        self.lookup_secret = lookup_secret

    def verify_header(
        self, method: str, raw_path: str, raw_query: str, headers: dict[str, str]
    ) -> str:
        auth = headers.get("authorization", "")
        if not auth.startswith(f"{SIGN_V2_ALGORITHM} "):
            raise s3err.AccessDenied
        try:
            access_key, got = auth[len(SIGN_V2_ALGORITHM) + 1 :].split(":", 1)
        except ValueError:
            raise s3err.InvalidArgument from None
        secret = self.lookup_secret(access_key)
        if secret is None:
            raise s3err.InvalidAccessKeyId
        if not headers.get("date") and not headers.get("x-amz-date"):
            raise s3err.MissingFields
        sts = string_to_sign_v2(
            method, raw_path, _unescape_query_v2(raw_query), headers
        )
        if not hmac.compare_digest(_v2_signature(secret, sts), got):
            raise s3err.SignatureDoesNotMatch
        return access_key

    def verify_presigned(
        self, method: str, raw_path: str, raw_query: str,
        headers: dict[str, str] | None = None,
    ) -> str:
        """Presigned V2: the string-to-sign includes the request headers
        (the reference's preSignatureV2 passes r.Header) with Expires in
        the Date slot; auth params are filtered out of the query."""
        import time as _time

        access_key = signature = expires = ""
        filtered = []
        for q in raw_query.split("&"):
            if not q:
                continue
            uq = urllib.parse.unquote_plus(q)
            k, has_eq, v = uq.partition("=")
            if k == "AWSAccessKeyId":
                access_key = v
            elif k == "Signature":
                signature = v
            elif k == "Expires":
                expires = v
            else:
                filtered.append(uq if has_eq or not k else k)
        if not access_key or not signature or not expires:
            raise s3err.MissingFields
        secret = self.lookup_secret(access_key)
        if secret is None:
            raise s3err.InvalidAccessKeyId
        try:
            if int(expires) < _time.time():
                raise s3err.ExpiredPresignRequest
        except ValueError:
            raise s3err.InvalidArgument from None
        sts = string_to_sign_v2(
            method, raw_path, "&".join(filtered), headers or {}, expires
        )
        if not hmac.compare_digest(_v2_signature(secret, sts), signature):
            raise s3err.SignatureDoesNotMatch
        return access_key
