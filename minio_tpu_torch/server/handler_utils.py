"""Shared request-handling helpers: route->policy-action mapping,
aws-chunked decoding, form parsing, checksum verification, time formats.

Split out of app.py so the handler mixin modules (object_handlers,
bucket_handlers, multipart_handlers, postpolicy) and the router share one
definition without circular imports.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from datetime import datetime, timezone
from email.utils import format_datetime

from . import s3err

BUCKET_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9.\-]{1,61}[a-z0-9]$")

# bucket subresource -> (GET action, PUT action)
_SUBRESOURCE_ACTIONS = {
    "policy": ("s3:GetBucketPolicy", "s3:PutBucketPolicy"),
    "lifecycle": ("s3:GetLifecycleConfiguration", "s3:PutLifecycleConfiguration"),
    "tagging": ("s3:GetBucketTagging", "s3:PutBucketTagging"),
    "notification": ("s3:GetBucketNotification", "s3:PutBucketNotification"),
    "encryption": ("s3:GetEncryptionConfiguration", "s3:PutEncryptionConfiguration"),
    "object-lock": (
        "s3:GetBucketObjectLockConfiguration",
        "s3:PutBucketObjectLockConfiguration",
    ),
    "cors": ("s3:GetBucketCORS", "s3:PutBucketCORS"),
    "replication": ("s3:GetReplicationConfiguration", "s3:PutReplicationConfiguration"),
    "versioning": ("s3:GetBucketVersioning", "s3:PutBucketVersioning"),
    "acl": ("s3:GetBucketAcl", "s3:PutBucketAcl"),
    "policyStatus": ("s3:GetBucketPolicyStatus", "s3:PutBucketPolicy"),
    "requestPayment": ("s3:GetBucketRequestPayment", "s3:PutBucketRequestPayment"),
    "logging": ("s3:GetBucketLogging", "s3:PutBucketLogging"),
    "ownershipControls": (
        "s3:GetBucketOwnershipControls", "s3:PutBucketOwnershipControls",
    ),
}


class _ConsumerDone(Exception):
    """Streaming-put pump: the erasure consumer finished before EOF."""


def _restored_locally(oi) -> bool:
    """A transitioned object whose restore window is still open has its
    data back on local drives and serves the normal path."""
    import time as _time

    from ..ilm import tier as tiermod

    exp = oi.user_defined.get(tiermod.RESTORE_EXPIRY_META)
    try:
        return bool(exp) and float(exp) > _time.time()
    except (TypeError, ValueError):
        return False


def _route_action(m: str, bucket: str, key: str, q, headers) -> tuple[str, str, str]:
    """(action, bucket, key) for authorization — the request->policy-action
    mapping the reference does per-handler via checkRequestAuthType."""
    if key:
        if "retention" in q:
            return (
                "s3:GetObjectRetention" if m in ("GET", "HEAD")
                else "s3:PutObjectRetention"
            ), bucket, key
        if "legal-hold" in q:
            return (
                "s3:GetObjectLegalHold" if m in ("GET", "HEAD")
                else "s3:PutObjectLegalHold"
            ), bucket, key
        if "tagging" in q:
            return {
                "GET": "s3:GetObjectTagging",
                "PUT": "s3:PutObjectTagging",
                "DELETE": "s3:DeleteObjectTagging",
            }.get(m, "s3:*"), bucket, key
        if "acl" in q:
            return (
                "s3:GetObjectAcl" if m in ("GET", "HEAD") else "s3:PutObjectAcl"
            ), bucket, key
        if m in ("GET", "HEAD"):
            if "uploadId" in q:
                return "s3:ListMultipartUploadParts", bucket, key
            if "attributes" in q:
                return "s3:GetObjectAttributes", bucket, key
            if "versionId" in q:
                return "s3:GetObjectVersion", bucket, key
            return "s3:GetObject", bucket, key
        if m == "PUT":
            return "s3:PutObject", bucket, key
        if m == "DELETE":
            if "uploadId" in q:
                return "s3:AbortMultipartUpload", bucket, key
            if "versionId" in q:
                return "s3:DeleteObjectVersion", bucket, key
            return "s3:DeleteObject", bucket, key
        if m == "POST":
            if "select" in q:
                return "s3:GetObject", bucket, key  # Select is a READ
            if "restore" in q:
                return "s3:RestoreObject", bucket, key
            return "s3:PutObject", bucket, key
        return "s3:*", bucket, key
    # bucket level
    for sub, (get_a, put_a) in _SUBRESOURCE_ACTIONS.items():
        if sub in q:
            if m in ("GET", "HEAD"):
                return get_a, bucket, ""
            return put_a, bucket, ""
    if m == "PUT":
        return "s3:CreateBucket", bucket, ""
    if m == "DELETE":
        return "s3:DeleteBucket", bucket, ""
    if m == "POST":
        return "", bucket, ""  # multi-delete authorizes PER KEY in its handler
    if "versions" in q:
        return "s3:ListBucketVersions", bucket, ""
    if "location" in q:
        return "s3:GetBucketLocation", bucket, ""
    if "uploads" in q:
        return "s3:ListBucketMultipartUploads", bucket, ""
    return "s3:ListBucket", bucket, ""


def _route_conditions(q) -> dict[str, str]:
    return {"s3:prefix": q.get("prefix", ""), "s3:delimiter": q.get("delimiter", "")}


def classify_qos_class(bucket: str, key: str, headers=None) -> str | None:
    """Request -> admission-control class (qos/admission.py), or None for
    planes that must never throttle: health probes (throttled liveness
    checks would flap the orchestrator), metrics scrapes, the embedded
    console, and internode RPC (grid/lock/storage). Only those known
    planes are exempt — an unrecognized key under /minio/* classifies as
    ordinary s3 traffic, so the reserved bucket name can never become an
    unthrottled data lane.

    Classification runs PRE-auth (the reference's maxClients throttle
    does too), so it must never trust client-controlled signals: routing
    e.g. the replication-marker header into its own class would let any
    unauthenticated sender pick its admission pool. Request headers are
    accepted for future use but ignored today; the background class is
    fed by server-side planes (heal/scan/decommission), not by wire
    classification."""
    from ..qos.admission import CLASS_ADMIN, CLASS_S3

    if bucket == "minio":
        if key.startswith("admin/") or key.startswith("kms/"):
            return CLASS_ADMIN
        if (
            key == "console"
            or key.startswith(("console/", "health/", "metrics/v3",
                               "grid/", "lock/", "storage/"))
            or key in ("v2/metrics/cluster", "v2/metrics/node")
        ):
            return None
        # anything else under /minio/* is ordinary S3 traffic ("minio" is
        # a reserved bucket name, but pre-existing data must not ride an
        # unthrottled lane)
        return CLASS_S3
    return CLASS_S3


def _parse_form_data(body: bytes, boundary: bytes) -> tuple[dict[str, str], bytes]:
    """Minimal multipart/form-data parser for POST-policy uploads.

    Returns (fields, file_bytes); the file part's filename lands in
    fields['__filename'].
    """
    fields: dict[str, str] = {}
    file_data = b""
    delim = b"--" + boundary
    chunks = body.split(delim)
    for part in chunks[1:]:  # [0] is the preamble
        if part.startswith(b"--"):
            break  # closing boundary
        # strip EXACTLY the framing CRLFs — file payloads may legitimately
        # begin/end with newline bytes that must survive
        if part.startswith(b"\r\n"):
            part = part[2:]
        if part.endswith(b"\r\n"):
            part = part[:-2]
        head, _, content = part.partition(b"\r\n\r\n")
        disp = ""
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-disposition"):
                disp = line.decode("utf-8", "replace")
        name = ""
        filename = None
        for tok in disp.split(";"):
            tok = tok.strip()
            if tok.startswith("name="):
                name = tok[5:].strip('"')
            elif tok.startswith("filename="):
                filename = tok[9:].strip('"')
        if not name:
            continue
        if name == "file":
            file_data = content
            if filename:
                fields["__filename"] = filename.rsplit("/", 1)[-1]
        else:
            fields[name] = content.decode("utf-8", "replace")
    return fields, file_data


def _verify_checksum_headers(headers, body: bytes) -> dict[str, str]:
    """AWS flexible-checksums: verify x-amz-checksum-* when present and
    return internal metadata recording them (reference internal/hash/
    checksum.go readers). All five algorithms (CRC32, CRC32C, SHA1,
    SHA256, CRC64NVME) are verified, none stored blind."""
    from ..utils import checksum as cks

    out: dict[str, str] = {}
    for algo in cks.ALGOS:
        v = headers.get(f"{cks.HEADER}{algo}")
        if not v:
            continue
        if cks.compute(algo, body) != v:
            raise s3err.InvalidDigest
        out[f"{cks.META_PREFIX}{algo}"] = v
    return out


class _AwsChunkedDecoder:
    """Incremental aws-chunked decoder for STREAMING-UNSIGNED-PAYLOAD-TRAILER
    bodies (reference cmd/streaming-v4-unsigned.go): yields payload bytes,
    captures the trailing checksum headers."""

    def __init__(self):
        self._buf = bytearray()
        self._state = "size"  # size | data | crlf | trailer
        self._remaining = 0
        self.trailers: dict[str, str] = {}

    def feed(self, chunk: bytes) -> bytes:
        self._buf += chunk
        out = bytearray()
        while True:
            if self._state == "size":
                nl = self._buf.find(b"\r\n")
                if nl < 0:
                    break
                line = bytes(self._buf[:nl])
                del self._buf[: nl + 2]
                size_hex = line.split(b";", 1)[0].strip()
                try:
                    self._remaining = int(size_hex, 16)
                except ValueError:
                    raise s3err.IncompleteBody from None
                self._state = "data" if self._remaining else "trailer"
            elif self._state == "data":
                take = min(self._remaining, len(self._buf))
                if take:
                    out += self._buf[:take]
                    del self._buf[:take]
                    self._remaining -= take
                if self._remaining:
                    break
                self._state = "crlf"
            elif self._state == "crlf":
                if len(self._buf) < 2:
                    break
                del self._buf[:2]
                self._state = "size"
            else:  # trailer: lines until blank
                nl = self._buf.find(b"\r\n")
                if nl < 0:
                    break
                line = bytes(self._buf[:nl])
                del self._buf[: nl + 2]
                if not line:
                    continue  # final blank line
                if b":" in line:
                    k, v = line.split(b":", 1)
                    self.trailers[k.decode().strip().lower()] = v.decode().strip()
        return bytes(out)


def _bucket_sse_algo(encryption_xml: str | None) -> str | None:
    """SSEAlgorithm from a bucket's default-encryption config XML."""
    if not encryption_xml:
        return None
    try:
        root = ET.fromstring(encryption_xml)
        for el in root.iter():
            if el.tag.endswith("SSEAlgorithm"):
                return el.text or None
    except ET.ParseError:
        return None
    return None


def _iso8601(ns: int) -> str:
    return datetime.fromtimestamp(ns / 1e9, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%f"
    )[:-3] + "Z"


def _http_date(ns: int) -> str:
    return format_datetime(
        datetime.fromtimestamp(ns / 1e9, tz=timezone.utc), usegmt=True
    )
