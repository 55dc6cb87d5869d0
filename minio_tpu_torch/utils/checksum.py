"""AWS flexible checksums: CRC32, CRC32C, SHA1, SHA256, CRC64NVME.

Incremental hashers with base64 digests, plus the multipart composite
("checksum of checksums" + "-N") construction. Mirrors the reference's
internal/hash/checksum.go:1-752 algorithm set; CRC32C/CRC64NVME are
table-driven (no external dependency).
"""

from __future__ import annotations

import base64
import hashlib
import zlib

ALGOS = ("crc32", "crc32c", "sha1", "sha256", "crc64nvme")
# algos with a multipart composite ("-N") form; CRC64NVME is defined by
# AWS as full-object-only and never takes the composite shape
COMPOSITE_ALGOS = ("crc32", "crc32c", "sha1", "sha256")
HEADER = "x-amz-checksum-"
META_PREFIX = "x-minio-internal-checksum-"
PART_CHECKSUMS_META = "x-minio-internal-part-checksums"

_CRC32C_TABLE: list[int] = []
_CRC64NVME_TABLE: list[int] = []


def _crc32c_init() -> None:
    if _CRC32C_TABLE:
        return
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (poly if c & 1 else 0)
        _CRC32C_TABLE.append(c)


def crc32c(data: bytes, crc: int = 0) -> int:
    from .. import native

    if native.available() and len(data) > 64:
        return native.crc32c(data, crc)  # SSE4.2 hardware CRC
    _crc32c_init()
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = _CRC32C_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _crc64nvme_init() -> None:
    if _CRC64NVME_TABLE:
        return
    poly = 0x9A6C9329AC4BC9B5  # reflected CRC-64/NVME polynomial
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (poly if c & 1 else 0)
        _CRC64NVME_TABLE.append(c)


def crc64nvme(data: bytes, crc: int = 0) -> int:
    from .. import native

    if native.available() and len(data) > 64:
        return native.crc64nvme(data, crc)
    _crc64nvme_init()
    c = crc ^ 0xFFFFFFFFFFFFFFFF
    for b in data:
        c = _CRC64NVME_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFFFFFFFFFF


class Hasher:
    """Incremental checksum with a base64 digest, keyed by algo name."""

    def __init__(self, algo: str):
        algo = algo.lower()
        if algo not in ALGOS:
            raise ValueError(f"unknown checksum algorithm {algo}")
        self.algo = algo
        self._crc = 0
        self._h = hashlib.sha1() if algo == "sha1" else (
            hashlib.sha256() if algo == "sha256" else None
        )

    def update(self, data: bytes) -> None:
        if self._h is not None:
            self._h.update(data)
        elif self.algo == "crc32":
            self._crc = zlib.crc32(data, self._crc)
        elif self.algo == "crc32c":
            self._crc = crc32c(data, self._crc)
        else:
            self._crc = crc64nvme(data, self._crc)

    def raw(self) -> bytes:
        if self._h is not None:
            return self._h.digest()
        n = 8 if self.algo == "crc64nvme" else 4
        return self._crc.to_bytes(n, "big")

    def b64(self) -> str:
        return base64.b64encode(self.raw()).decode()


def compute(algo: str, data: bytes) -> str:
    h = Hasher(algo)
    h.update(data)
    return h.b64()


def composite(algo: str, part_b64s: list[str]) -> str:
    """Multipart composite checksum: algo over the concatenated raw part
    digests, suffixed -N (AWS semantics; reference checksum.go)."""
    raw = b"".join(base64.b64decode(p) for p in part_b64s)
    return f"{compute(algo, raw)}-{len(part_b64s)}"
