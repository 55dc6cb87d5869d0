"""aws-chunked payload decoding (SigV4 streaming uploads).

Mirrors MinIO cmd/streaming-signature-v4.go (signed chunks) and
streaming-v4-unsigned.go (unsigned trailer chunks): bodies arrive as
    <hex-size>[;chunk-signature=<sig>]\r\n<bytes>\r\n ... 0[;...]\r\n[trailers]
Signed mode verifies the per-chunk signature chain seeded by the request
signature.
"""

from __future__ import annotations

import hashlib
import hmac

from . import s3err
from .signature import SIGN_V4_ALGORITHM, signing_key

EMPTY_SHA = hashlib.sha256(b"").hexdigest()


def decode_signed_chunked(
    body: bytes,
    seed_signature: str,
    amz_date: str,
    scope: str,
    secret_key: str,
    trailer_mode: bool = False,
) -> bytes:
    """Decode + verify STREAMING-AWS4-HMAC-SHA256-PAYLOAD bodies.

    Chunk signature chain: each chunk's string-to-sign commits to the
    previous signature and the chunk hash; the seed is the request
    signature (reference: buildChunkStringToSign).
    """
    scope_date, region, service, _ = scope.split("/")
    key = signing_key(secret_key, scope_date, region, service)
    prev = seed_signature
    out = bytearray()
    pos = 0
    while True:
        nl = body.find(b"\r\n", pos)
        if nl < 0:
            raise s3err.IncompleteBody
        header = body[pos:nl].decode("latin1")
        parts = header.split(";")
        try:
            size = int(parts[0].strip(), 16)
        except ValueError:
            raise s3err.IncompleteBody from None
        sig = ""
        for p in parts[1:]:
            if p.startswith("chunk-signature="):
                sig = p[len("chunk-signature=") :].strip()
        pos = nl + 2
        chunk = body[pos : pos + size]
        if len(chunk) != size:
            raise s3err.IncompleteBody
        if trailer_mode and size == 0 and not sig:
            # trailer mode: the final 0-chunk carries no chunk-signature;
            # integrity of the trailers rides x-amz-trailer-signature
            # (content already chain-verified chunk by chunk)
            return bytes(out)
        sts = "\n".join(
            [
                f"{SIGN_V4_ALGORITHM}-PAYLOAD",
                amz_date,
                scope,
                prev,
                EMPTY_SHA,
                hashlib.sha256(chunk).hexdigest(),
            ]
        )
        want = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise s3err.SignatureDoesNotMatch
        prev = want
        if size == 0:
            return bytes(out)
        out += chunk
        pos += size + 2
