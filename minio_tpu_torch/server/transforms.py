"""Object data transforms: transparent compression + server-side encryption.

Order mirrors the reference: compress first, then encrypt
(MinIO cmd/object-api-utils.go compression +
cmd/encryption-v1.go). Both record internal metadata so reads invert the
pipeline; logical ("actual") size is preserved for listings/HEAD.

Compression framing: sequence of [u32 plain_len][u32 comp_len][zlib bytes]
blocks over 1 MiB plaintext blocks (the reference uses S2 snappy framing;
zlib is this build's codec — the capability, not the wire format, is the
parity target).
"""

from __future__ import annotations

import os
import struct
import zlib

from ..crypto import sse as ssemod

META_COMPRESSION = "x-minio-internal-compression"
COMP_BLOCK = 1 << 20

# extensions/content-types never worth compressing
# (reference internal/config/compress defaults)
INCOMPRESSIBLE_EXT = {
    ".gz", ".bz2", ".zst", ".xz", ".zip", ".7z", ".rar",
    ".jpg", ".jpeg", ".png", ".gif", ".webp", ".mp4", ".mkv", ".mov",
    ".mp3", ".aac", ".ogg", ".parquet",
}


def compression_enabled() -> bool:
    return os.environ.get("MINIO_COMPRESSION_ENABLE", "off") in ("on", "true", "1")


def should_compress(key: str, content_type: str, size: int) -> bool:
    if not compression_enabled() or size < 4096:
        return False
    ext = os.path.splitext(key)[1].lower()
    if ext in INCOMPRESSIBLE_EXT:
        return False
    if content_type.startswith(("image/", "video/", "audio/")):
        return False
    return True


def compress(data: bytes) -> bytes:
    out = bytearray()
    for off in range(0, len(data), COMP_BLOCK):
        block = data[off : off + COMP_BLOCK]
        cb = zlib.compress(block, 1)
        out += struct.pack("<II", len(block), len(cb))
        out += cb
    return bytes(out)


def decompress(data: bytes) -> bytes:
    out = bytearray()
    off = 0
    n = len(data)
    while off < n:
        if off + 8 > n:
            raise ValueError("truncated compression frame header")
        plain_len, comp_len = struct.unpack_from("<II", data, off)
        off += 8
        block = zlib.decompress(data[off : off + comp_len])
        if len(block) != plain_len:
            raise ValueError("compression frame length mismatch")
        out += block
        off += comp_len
    return bytes(out)


class TransformResult:
    __slots__ = ("data", "metadata", "response_headers")

    def __init__(self, data: bytes, metadata: dict, response_headers: dict):
        self.data = data
        self.metadata = metadata
        self.response_headers = response_headers


def encode_for_store(
    body: bytes,
    key: str,
    content_type: str,
    headers,
    bucket_encryption_algo: str | None,
    kms: ssemod.KMS,
    bucket: str,
) -> TransformResult:
    """Apply compress-then-encrypt per request headers / bucket defaults."""
    meta: dict[str, str] = {}
    resp: dict[str, str] = {}
    data = body

    if should_compress(key, content_type, len(body)):
        compressed = compress(data)
        if len(compressed) < len(data):  # keep only when it actually helps
            meta[META_COMPRESSION] = "zlib/v1"
            meta[ssemod.META_ACTUAL_SIZE] = str(len(data))
            data = compressed

    ssec_key = ssemod.parse_ssec_headers(headers)
    sse_algo = headers.get("x-amz-server-side-encryption", "")
    if not ssec_key and not sse_algo and bucket_encryption_algo:
        sse_algo = bucket_encryption_algo  # bucket default encryption
    if ssec_key or sse_algo:
        import secrets as _secrets

        context = f"{bucket}/{key}"
        if ssec_key:
            oek, base_iv, sealed, m2, r2 = _ssec_setup(ssec_key, context)
            meta.update(m2)
            resp.update(r2)
        else:
            base_iv = _secrets.token_bytes(ssemod.NONCE_SIZE)
            oek, sealed, m2, r2 = _sse_s3_kms_setup(sse_algo, headers, kms, context)
            meta.update(m2)
            resp.update(r2)
            meta[ssemod.META_SEALED_KEY] = sealed.hex()
            meta[ssemod.META_IV] = base_iv.hex()
        meta.setdefault(ssemod.META_ACTUAL_SIZE, str(len(body)))
        data = ssemod.encrypt_stream(data, oek, base_iv)
    return TransformResult(data, meta, resp)


META_PART_SIZES = ssemod.META_PART_SIZES


def is_transformed(user_defined: dict) -> bool:
    return ssemod.META_ALGO in user_defined or META_COMPRESSION in user_defined


def part_iv(base_iv: bytes, part_number: int) -> bytes:
    """Per-part base IV: parts encrypt as independent packet streams under
    one OEK, so each needs a distinct IV (nonce reuse across parts would
    be catastrophic) bound to its part number (no part swapping)."""
    import hashlib as _hashlib

    return _hashlib.sha256(
        base_iv + part_number.to_bytes(4, "big")
    ).digest()[: ssemod.NONCE_SIZE]


def _ssec_setup(
    ssec_key: bytes, context: str
) -> tuple[bytes, bytes, bytes, dict, dict]:
    """Shared SSE-C key sealing: fresh OEK sealed under the customer key.
    Single source of truth for single PUTs and multipart initiation.
    Returns (oek, base_iv, sealed, metadata, response headers)."""
    import base64 as _b64
    import hashlib as _hashlib
    import secrets as _secrets

    base_iv = _secrets.token_bytes(ssemod.NONCE_SIZE)
    oek = _secrets.token_bytes(32)
    sealed = ssemod._aesgcm(ssec_key).encrypt(base_iv, oek, context.encode())
    key_md5 = _b64.b64encode(_hashlib.md5(ssec_key).digest()).decode()
    meta = {
        ssemod.META_ALGO: "SSE-C",
        ssemod.META_SSEC_KEY_MD5: key_md5,
        ssemod.META_SEALED_KEY: sealed.hex(),
        ssemod.META_IV: base_iv.hex(),
    }
    resp = {
        "x-amz-server-side-encryption-customer-algorithm": "AES256",
        "x-amz-server-side-encryption-customer-key-MD5": key_md5,
    }
    return oek, base_iv, sealed, meta, resp


def _sse_s3_kms_setup(
    sse_algo: str, headers, kms: ssemod.KMS, context: str
) -> tuple[bytes, bytes, dict, dict]:
    """Shared SSE-S3/SSE-KMS key generation + metadata/response headers —
    single source of truth for single PUTs and multipart initiation."""
    meta: dict[str, str] = {}
    resp: dict[str, str] = {}
    if sse_algo == "aws:kms":
        key_id = headers.get(
            "x-amz-server-side-encryption-aws-kms-key-id", kms.key_id
        )
        # seal under the REQUESTED named key, so deleting that key cuts
        # off exactly the objects encrypted with it (reference
        # cmd/encryption-v1.go newEncryptMetadata keyID plumbing)
        oek, sealed = kms.generate_key(context, key_id)
        meta[ssemod.META_ALGO] = "SSE-KMS"
        meta[ssemod.META_KMS_KEY_ID] = key_id
        resp["x-amz-server-side-encryption"] = "aws:kms"
        resp["x-amz-server-side-encryption-aws-kms-key-id"] = key_id
    else:
        oek, sealed = kms.generate_key(context)
        meta[ssemod.META_ALGO] = "SSE-S3"
        resp["x-amz-server-side-encryption"] = "AES256"
    return oek, sealed, meta, resp


def multipart_sse_init(
    headers, bucket_encryption_algo: str | None, kms: ssemod.KMS,
    bucket: str, key: str,
) -> tuple[dict, dict] | None:
    """SSE setup at CreateMultipartUpload (reference encrypts multipart
    per part under one object key, cmd/encryption-v1.go +
    cmd/erasure-multipart.go:575). Returns (upload metadata, response
    headers) or None when no encryption applies.

    SSE-C: the customer key seals a fresh OEK at initiation; every
    UploadPart must re-present the same key (AWS semantics) — the key
    itself is never stored, only its MD5 for mismatch detection."""
    import secrets as _secrets

    ssec_key = ssemod.parse_ssec_headers(headers)
    if ssec_key:
        _oek, _iv, _sealed, meta, resp = _ssec_setup(
            ssec_key, f"{bucket}/{key}"
        )
        del _oek  # re-unsealed per part from the presented key
        return meta, resp
    sse_algo = headers.get("x-amz-server-side-encryption", "")
    if not sse_algo and bucket_encryption_algo:
        sse_algo = bucket_encryption_algo
    if not sse_algo:
        return None
    base_iv = _secrets.token_bytes(ssemod.NONCE_SIZE)
    oek, sealed, meta, resp = _sse_s3_kms_setup(
        sse_algo, headers, kms, f"{bucket}/{key}"
    )
    del oek  # re-unsealed per part
    meta[ssemod.META_SEALED_KEY] = sealed.hex()
    meta[ssemod.META_IV] = base_iv.hex()
    return meta, resp


def encrypt_part(
    data: bytes, upload_meta: dict, part_number: int, kms: ssemod.KMS,
    bucket: str, key: str, headers=None,
) -> bytes:
    oek = _unseal_oek(upload_meta, headers or {}, bucket, key, kms)
    base_iv = bytes.fromhex(upload_meta[ssemod.META_IV])
    return ssemod.encrypt_stream(data, oek, part_iv(base_iv, part_number))


def encrypt_part_iter(
    chunks, upload_meta: dict, part_number: int, kms: ssemod.KMS,
    bucket: str, key: str, plain_count: list, headers=None,
):
    """Streaming variant: yields sealed packets; plain_count[0] gets the
    plaintext size when the source is exhausted (5 GiB parts must not
    buffer in RAM)."""
    oek = _unseal_oek(upload_meta, headers or {}, bucket, key, kms)
    base_iv = bytes.fromhex(upload_meta[ssemod.META_IV])
    return ssemod.encrypt_packets_iter(
        chunks, oek, part_iv(base_iv, part_number), plain_count
    )


def _part_layout(user_defined: dict) -> list[tuple[int, int, int, int]]:
    """[(part#, plain_size, plain_off, stored_off)] per completed part."""
    import json as _json

    entries = _json.loads(user_defined[META_PART_SIZES])
    out = []
    plain_off = stored_off = 0
    for num, psize in entries:
        out.append((int(num), int(psize), plain_off, stored_off))
        plain_off += int(psize)
        stored_off += ssemod.stored_size(int(psize))
    return out


def decode_range_multipart(
    read_fn, user_defined: dict, headers, bucket: str, key: str,
    kms: ssemod.KMS, start: int, length: int,
) -> bytes:
    """Ranged decrypt of an SSE multipart object: each part is its own
    packet stream; a range maps to the overlapping parts' packet runs."""
    oek = _unseal_oek(user_defined, headers, bucket, key, kms)
    base_iv = bytes.fromhex(user_defined[ssemod.META_IV])
    out = bytearray()
    end = start + length
    for num, psize, plain_off, stored_off in _part_layout(user_defined):
        if plain_off + psize <= start:
            continue
        if plain_off >= end:
            break
        lo = max(start - plain_off, 0)
        hi = min(end - plain_off, psize)
        s_off, s_len, skip = ssemod.stored_range(lo, hi - lo)
        s_len = min(s_len, ssemod.stored_size(psize) - s_off)
        stored = read_fn(stored_off + s_off, s_len)
        plain = ssemod.decrypt_packets(
            stored, oek, part_iv(base_iv, num),
            s_off // ssemod.STORED_PACKET,
        )
        out += plain[skip : skip + (hi - lo)]
    return bytes(out)


def logical_size(user_defined: dict, stored: int) -> int:
    v = user_defined.get(ssemod.META_ACTUAL_SIZE)
    return int(v) if v is not None else stored


def _unseal_oek(user_defined: dict, headers, bucket: str, key: str, kms: ssemod.KMS) -> bytes:
    algo = user_defined[ssemod.META_ALGO]
    sealed = bytes.fromhex(user_defined[ssemod.META_SEALED_KEY])
    base_iv = bytes.fromhex(user_defined[ssemod.META_IV])
    context = f"{bucket}/{key}"
    if algo == "SSE-C":
        ssec_key = ssemod.parse_ssec_headers(headers)
        if ssec_key is None:
            raise ssemod.CryptoError("object is SSE-C encrypted: key required")
        import base64 as _b64
        import hashlib as _hashlib

        if (
            _b64.b64encode(_hashlib.md5(ssec_key).digest()).decode()
            != user_defined.get(ssemod.META_SSEC_KEY_MD5)
        ):
            raise ssemod.CryptoError("SSE-C key does not match object key")
        try:
            return ssemod._aesgcm(ssec_key).decrypt(base_iv, sealed, context.encode())
        except Exception:
            raise ssemod.CryptoError("SSE-C unseal failed") from None
    kid = user_defined.get(ssemod.META_KMS_KEY_ID) or None
    try:
        return kms.unseal(sealed, context, kid)
    except ssemod.CryptoError:
        if not kid or kid == kms.key_id:
            raise
        # legacy objects (pre-keyring) recorded the requested key id in
        # metadata but sealed the OEK under the default master key — fall
        # back so an upgrade never bricks existing SSE-KMS data
        return kms.unseal(sealed, context)


def decode_full(
    stored: bytes, user_defined: dict, headers, bucket: str, key: str, kms: ssemod.KMS
) -> bytes:
    """Invert the full pipeline (decrypt then decompress)."""
    data = stored
    if META_PART_SIZES in user_defined:
        layout = _part_layout(user_defined)
        total = sum(p[1] for p in layout)

        def rf(off, ln):
            return stored[off : off + ln]

        return decode_range_multipart(
            rf, user_defined, headers, bucket, key, kms, 0, total
        )
    if ssemod.META_ALGO in user_defined:
        oek = _unseal_oek(user_defined, headers, bucket, key, kms)
        base_iv = bytes.fromhex(user_defined[ssemod.META_IV])
        data = ssemod.decrypt_stream(data, oek, base_iv)
    if user_defined.get(META_COMPRESSION) == "zlib/v1":
        data = decompress(data)
    return data


def decode_range(
    read_fn,
    stored_size: int,
    user_defined: dict,
    headers,
    bucket: str,
    key: str,
    kms: ssemod.KMS,
    start: int,
    length: int,
) -> bytes:
    """Ranged read through the transform pipeline.

    SSE-only objects map ranges to packet runs (O(range)); compressed
    objects decode fully (framing has no random access in v1)."""
    if user_defined.get(META_COMPRESSION) == "zlib/v1":
        full = decode_full(read_fn(0, stored_size), user_defined, headers, bucket, key, kms)
        return full[start : start + length]
    if META_PART_SIZES in user_defined:
        return decode_range_multipart(
            read_fn, user_defined, headers, bucket, key, kms, start, length
        )
    if ssemod.META_ALGO in user_defined:
        oek = _unseal_oek(user_defined, headers, bucket, key, kms)
        base_iv = bytes.fromhex(user_defined[ssemod.META_IV])
        s_off, s_len, skip = ssemod.stored_range(start, length)
        s_len = min(s_len, stored_size - s_off)
        stored = read_fn(s_off, s_len)
        plain = ssemod.decrypt_packets(
            stored, oek, base_iv, s_off // ssemod.STORED_PACKET
        )
        return plain[skip : skip + length]
    return read_fn(start, length)
