"""madmin wire encryption — the encrypted admin-plane framing `mc admin`
speaks.

The reference's admin handlers wrap sensitive request/response bodies
with madmin-go/v3 EncryptData/DecryptData (used throughout
MinIO cmd/admin-handlers-users.go:630,812,998 and
admin-handlers-config-kv.go:278), whose documented ciphertext layout is

    salt | AEAD id | nonce | sio stream
     32      1        8       ...

* key = Argon2id(password, salt, time=1, memory=64 MiB, threads=4) -> 32B,
  password being the requester's own secret key.
* AEAD id 0x00 = AES-256-GCM, 0x01 = ChaCha20-Poly1305 (the Go client
  picks by CPU support; we accept both and emit AES-256-GCM).
* The stream is secure-io/sio-go (v0.3.1) framing: seq 0 seals the
  user associated data (nil here) into a bare tag, and every fragment's
  AAD is marker || that tag — 0x00 for intermediate fragments, 0x80
  for the final one. Plaintext splits into 16 KiB fragments sealed with
  nonce = nonce8 || LE32(seq), seq starting at 1. Empty plaintext still
  seals one final fragment, so truncation and reordering are always
  detectable.

sio-go's source is not available in this environment; the framing above
is reconstructed from its published design and must hold for real
`mc admin` interop — the layout is fully documented here so a mismatch
is a one-line fix.
"""

from __future__ import annotations

import os
import struct

try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM, ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.argon2 import Argon2id

    _HAVE_CRYPTO = True
except ImportError:  # gated dep: encrypted madmin framing unavailable;
    # the plain-JSON admin plane (our own SDK) still works
    _HAVE_CRYPTO = False

    class InvalidTag(Exception):  # type: ignore[no-redef]
        pass

AES_GCM_ID = 0x00
C20P1305_ID = 0x01
SALT_LEN = 32
NONCE_LEN = 8  # AEAD nonce (12) minus the 4-byte fragment counter
FRAGMENT = 1 << 14  # sio-go BufSize
TAG_LEN = 16
HEADER_LEN = SALT_LEN + 1 + NONCE_LEN


class MadminCryptError(Exception):
    pass


def _derive_key(password: str, salt: bytes) -> bytes:
    if not _HAVE_CRYPTO:
        raise MadminCryptError(
            "madmin encrypted framing needs the 'cryptography' package, "
            "which is not installed"
        )
    return Argon2id(
        salt=salt, length=32, iterations=1, lanes=4, memory_cost=64 * 1024
    ).derive(password.encode())


def _aead(aead_id: int, key: bytes):
    if not _HAVE_CRYPTO:
        raise MadminCryptError(
            "madmin encrypted framing needs the 'cryptography' package, "
            "which is not installed"
        )
    if aead_id == AES_GCM_ID:
        return AESGCM(key)
    if aead_id == C20P1305_ID:
        return ChaCha20Poly1305(key)
    raise MadminCryptError(f"unknown AEAD id {aead_id}")


def _aad_tag(aead, nonce: bytes) -> bytes:
    """sio-go reserves seq 0: the user associated data (nil for madmin)
    is sealed into a bare tag that becomes part of every fragment's AAD."""
    return aead.encrypt(nonce + struct.pack("<I", 0), b"", None)


def encrypt(password: str, data: bytes) -> bytes:
    salt = os.urandom(SALT_LEN)
    nonce = os.urandom(NONCE_LEN)
    aead = _aead(AES_GCM_ID, _derive_key(password, salt))
    tag = _aad_tag(aead, nonce)
    out = bytearray()
    out += salt
    out.append(AES_GCM_ID)
    out += nonce
    n_frags = max(1, -(-len(data) // FRAGMENT))
    for i in range(n_frags):
        frag = data[i * FRAGMENT : (i + 1) * FRAGMENT]
        final = i == n_frags - 1
        out += aead.encrypt(
            nonce + struct.pack("<I", i + 1),
            bytes(frag),
            bytes([0x80 if final else 0x00]) + tag,
        )
    return bytes(out)


def decrypt(password: str, blob: bytes) -> bytes:
    if len(blob) < HEADER_LEN + TAG_LEN:
        raise MadminCryptError("ciphertext too short")
    salt = blob[:SALT_LEN]
    aead_id = blob[SALT_LEN]
    nonce = blob[SALT_LEN + 1 : HEADER_LEN]
    aead = _aead(aead_id, _derive_key(password, salt))
    tag = _aad_tag(aead, nonce)
    body = blob[HEADER_LEN:]
    out = bytearray()
    step = FRAGMENT + TAG_LEN
    n_frags = max(1, -(-len(body) // step))
    for i in range(n_frags):
        frag = body[i * step : (i + 1) * step]
        final = i == n_frags - 1
        try:
            out += aead.decrypt(
                nonce + struct.pack("<I", i + 1), bytes(frag),
                bytes([0x80 if final else 0x00]) + tag,
            )
        except InvalidTag:
            # position determines finality unambiguously: an exactly
            # fragment-aligned stream makes its last FULL fragment final,
            # and an encoder that sealed n full intermediates appends a
            # 16-byte empty final fragment (ceil puts it in its own seq)
            raise MadminCryptError("decryption failed") from None
    return bytes(out)


def looks_encrypted(blob: bytes) -> bool:
    """Cheap structural test: long enough for the madmin header and the
    AEAD id byte is one of the two defined values. JSON admin bodies
    (b'{' = 0x7b at offset 32 only if...) can collide only if byte 32 is
    0x00/0x01, which printable JSON never is."""
    return len(blob) >= HEADER_LEN + TAG_LEN and blob[SALT_LEN] in (
        AES_GCM_ID,
        C20P1305_ID,
    )


def maybe_decrypt(password: str, body: bytes) -> bytes:
    """Request-side leniency: madmin clients encrypt; our own SDK/tests
    send plain JSON. Try the wire format first, fall back to plaintext."""
    if looks_encrypted(body):
        try:
            return decrypt(password, body)
        except MadminCryptError:
            pass
    return body
