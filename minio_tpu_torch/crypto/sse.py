"""Server-side encryption: authenticated packet streams + key sealing.

Mirrors the reference's SSE design (MinIO cmd/encryption-v1.go +
internal/crypto, which uses minio/sio DARE): object data is encrypted as a
sequence of fixed-size packets, each sealed with AES-256-GCM using a
per-object key (OEK) and a nonce binding the packet index (so packets
can't be reordered); the OEK is sealed with either the KMS master key
(SSE-S3/SSE-KMS) or the client-supplied key (SSE-C) and stored in object
metadata. Packet framing preserves O(1) range mapping: logical offset ->
packet index -> stored offset.

Wire format per packet: nonce(12) || ciphertext(plain_len + 16 tag).
"""

from __future__ import annotations

import base64
import functools
import hashlib
import json
import os
import secrets
import threading
import time

PACKET_SIZE = 64 * 1024  # plaintext bytes per sealed packet
NONCE_SIZE = 12
TAG_SIZE = 16
STORED_PACKET = NONCE_SIZE + PACKET_SIZE + TAG_SIZE

# metadata keys (internal, stripped from client responses)
META_ALGO = "x-minio-internal-sse"  # "SSE-S3" | "SSE-C" | "SSE-KMS"
META_SEALED_KEY = "x-minio-internal-sse-sealed-key"
META_IV = "x-minio-internal-sse-iv"
META_ACTUAL_SIZE = "x-minio-internal-actual-size"
META_SSEC_KEY_MD5 = "x-minio-internal-ssec-key-md5"
META_KMS_KEY_ID = "x-minio-internal-kms-key-id"
META_PART_SIZES = "x-minio-internal-sse-part-sizes"  # [[part#, plain_size]..]


class CryptoError(Exception):
    """Base KMS/SSE error. `status` is the HTTP code the API plane must
    answer with and `api_code` the client-visible error id — typed, so
    handlers never string-match messages (reference internal/kms/errors.go
    carries Code+APICode on every KMS error the same way)."""

    status = 400
    api_code = "kms:Error"


class KeyExistsError(CryptoError):
    status = 409
    api_code = "kms:KeyAlreadyExists"


class KeyNotFoundError(CryptoError):
    status = 404
    api_code = "kms:KeyNotFound"


class KMSPermissionError(CryptoError):
    status = 403
    api_code = "kms:NotAuthorized"


class KMSBackendError(CryptoError):
    """KMS-side failure (unreachable, lock/corruption, upstream 5xx) —
    NOT client error; defaults to 500 unless the upstream supplied a
    specific code."""

    status = 500
    api_code = "kms:BackendFailed"

    def __init__(self, msg: str, status: int | None = None):
        super().__init__(msg)
        if status is not None and 400 <= status < 600:
            self.status = status


def _aesgcm(key: bytes):
    """AESGCM constructor behind the gated `cryptography` dependency: a
    deployment without it serves unencrypted traffic normally and answers
    SSE requests with a typed error instead of an import-time crash."""
    # imported at first use, so that importing the server pulls in no
    # optional package
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError:
        raise KMSBackendError(
            "server-side encryption needs the 'cryptography' package, "
            "which is not installed"
        ) from None
    return AESGCM(key)


def raise_for_kms_status(status: int, msg: str) -> None:
    """Map an upstream KMS HTTP status onto the typed hierarchy — shared
    by every remote backend so the mapping can't drift between them."""
    if status == 404:
        raise KeyNotFoundError(msg)
    if status == 409:
        raise KeyExistsError(msg)
    if status == 403:
        raise KMSPermissionError(msg)
    raise KMSBackendError(msg, status=status)


# request-latency histogram bucket upper bounds, seconds (reference
# internal/kms/kms.go defaultLatencyBuckets 10ms..10s + the +Inf
# overflow bucket, so hung requests are never dropped from the histogram)
KMS_LATENCY_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, float("inf"),
)


_METRICS_INIT_LOCK = threading.Lock()


class KMSMetrics:
    """Real request counters shared by every KMS backend (reference
    internal/kms/kms.go:264 updateMetrics: reqOK/reqErr/reqFail + latency
    histogram). Lazily initialized so backends need no __init__ hook."""

    def _kms_metric_state(self):
        lock = self.__dict__.get("_metric_lock")
        if lock is None:
            with _METRICS_INIT_LOCK:
                lock = self.__dict__.get("_metric_lock")
                if lock is None:
                    self._metric_requests = 0
                    self._metric_errors = 0
                    self._metric_fails = 0
                    self._metric_latency = [0] * len(KMS_LATENCY_BUCKETS)
                    # set last: the unlocked fast path must never see the
                    # lock before the counters exist
                    self._metric_lock = lock = threading.Lock()
        return lock

    def _note_kms_op(self, err: Exception | None, latency: float) -> None:
        with self._kms_metric_state():
            self._metric_requests += 1
            for i, ub in enumerate(KMS_LATENCY_BUCKETS):
                if latency < ub:
                    self._metric_latency[i] += 1
                    break
            if err is None:
                return
            # 5xx = the KMS failed; anything else = the request was bad
            # (the reference's reqFail vs reqErr split)
            if getattr(err, "status", 500) >= 500:
                self._metric_fails += 1
            else:
                self._metric_errors += 1

    def kms_metrics(self) -> dict:
        with self._kms_metric_state():
            reqs = self._metric_requests
            errs = self._metric_errors
            fails = self._metric_fails
            latency = {
                f"{ub}": n
                for ub, n in zip(KMS_LATENCY_BUCKETS, self._metric_latency)
            }
        return {
            "requestOK": reqs - errs - fails,
            "requestErr": errs,
            "requestFail": fails,
            "requestActive": 0,
            "latency": latency,
        }


def counted_kms_op(fn):
    """Wrap a KMS operation so every top-level call lands in the backend's
    counters; nested ops (create_key -> seal) count once, like the
    reference counting per KMS front-door call."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        local = self.__dict__.setdefault("_kms_op_local", threading.local())
        if getattr(local, "active", False):
            return fn(self, *args, **kwargs)
        local.active = True
        t0 = time.monotonic()
        try:
            out = fn(self, *args, **kwargs)
        except Exception as e:
            self._note_kms_op(e, time.monotonic() - t0)
            raise
        finally:
            local.active = False
        self._note_kms_op(None, time.monotonic() - t0)
        return out

    return wrapped


def _ns_mutex(store, bucket: str, obj: str):
    """The store's distributed namespace mutex for (bucket, obj), or None.

    Walks the object-layer composition (pools -> sets -> set) to the
    NamespaceLock the erasure set holds; in multi-node deployments that
    lock spans the cluster's lockers.
    """
    layer = store
    pools = getattr(layer, "pools", None)
    if pools:
        layer = pools[0]
    sets = getattr(layer, "sets", None)
    if sets:
        layer = sets[0]
    ns = getattr(layer, "ns", None)
    return ns.new(bucket, obj) if ns is not None else None


class KMS(KMSMetrics):
    """Builtin single-master-key KMS (reference: MINIO_KMS_SECRET_KEY,
    internal/kms/secret-key.go). Key spec: 'name:base64(32 bytes)'."""

    def __init__(self, key_spec: str | None = None, store=None):
        self._store = store
        # name -> (sealed-hex fingerprint, unsealed 32-byte material)
        self._keys: dict[str, tuple[str, bytes]] = {}
        spec = key_spec or os.environ.get("MINIO_KMS_SECRET_KEY", "")
        if spec:
            # a configured-but-malformed spec must fail loudly: silently
            # falling through would encrypt data under a key the operator
            # did not configure
            if ":" not in spec:
                raise CryptoError(
                    "malformed MINIO_KMS_SECRET_KEY (want 'name:base64(32B)')"
                )
            name, b64 = spec.split(":", 1)
            try:
                key = base64.b64decode(b64, validate=True)
            except Exception:
                raise CryptoError(
                    "MINIO_KMS_SECRET_KEY key material is not valid base64"
                ) from None
            if len(key) != 32:
                raise CryptoError("KMS master key must be 32 bytes")
            self.key_id, self._master = name, key
        elif store is not None:
            # auto-generated master key persisted in the backend — NOT
            # derived from credentials, so rotating root credentials can
            # never brick encrypted objects (the reference's single-node
            # KMS persists generated key material the same way)
            self.key_id = "minio-tpu-auto-key"
            self._master = self._load_or_create(store)
        else:
            # last-resort ephemeral key (tests / keyless library use) —
            # random, never a well-known constant
            self.key_id = "minio-tpu-ephemeral-key"
            self._master = secrets.token_bytes(32)

    @staticmethod
    def _load_or_create(store) -> bytes:
        """Load the persisted master key, generating it exactly once.

        Creation is guarded by the store's distributed namespace lock and
        re-read after acquisition: on concurrent first boot of multiple
        nodes, only one generated key may ever persist — a lost race here
        would leave objects sealed under a vanished key permanently
        undecryptable.
        """
        from ..erasure.quorum import ObjectNotFound

        path = "config/kms/master-key"

        def read() -> bytes | None:
            """Persisted key, or None iff absent. A PRESENT-but-corrupt key
            must abort boot: regenerating over it would permanently brick
            every object sealed under the original."""
            try:
                _, it = store.get_object(".minio.sys", path)
            except ObjectNotFound:
                return None
            try:
                key = base64.b64decode(b"".join(it), validate=True)
            except Exception:
                raise CryptoError(
                    "persisted KMS master key is corrupt (invalid base64); "
                    "refusing to regenerate over it"
                ) from None
            if len(key) != 32:
                raise CryptoError(
                    "persisted KMS master key is corrupt (not 32 bytes); "
                    "refusing to regenerate over it"
                )
            return key

        key = read()
        if key is not None:
            return key
        # distinct sentinel resource: put_object takes the object's own
        # namespace lock internally, so locking `path` here would deadlock
        mtx = _ns_mutex(store, ".minio.sys", path + ".init")
        if mtx is not None and not mtx.lock(timeout=30.0):
            raise CryptoError("could not lock KMS master key for creation")
        try:
            key = read()  # re-check under the lock: another node may have won
            if key is not None:
                return key
            key = secrets.token_bytes(32)
            store.put_object(".minio.sys", path, base64.b64encode(key))
            return key
        finally:
            if mtx is not None:
                mtx.unlock()

    # -- named keyring ------------------------------------------------------
    # The reference's KMS API manages named master keys (key/create,
    # key/list, key/status — cmd/kms-handlers.go); the builtin backend
    # persists each named key sealed under the default master key, so the
    # master stays the single root of trust (MinKMS seals its key store
    # under a KEK the same way, internal/kms/conn.go).

    _KEYRING_PATH = "config/kms/keyring.json"

    _RING_TTL = 5.0  # seconds; keeps cross-node delete_key convergent

    def _keyring(self, fresh: bool = False) -> dict[str, str]:
        """Persisted name -> hex(sealed material) map.

        Cached with a short TTL: the data path calls this per seal/unseal,
        but a key deleted via ANOTHER node must stop working here within
        the TTL, not live forever in a process-local cache."""
        store = getattr(self, "_store", None)
        if store is None:
            return {}
        import time as _time

        now = _time.monotonic()
        cached = getattr(self, "_ring_cache", None)
        if not fresh and cached is not None and now < cached[1]:
            return cached[0]
        from ..erasure.quorum import ObjectNotFound

        try:
            _, it = store.get_object(".minio.sys", self._KEYRING_PATH)
            ring = json.loads(b"".join(it).decode())
        except ObjectNotFound:
            ring = {}
        except ValueError:
            raise KMSBackendError(
                "persisted KMS keyring is corrupt; refusing to overwrite"
            ) from None
        self._ring_cache = (ring, now + self._RING_TTL)
        return ring

    def _save_keyring(self, ring: dict[str, str]) -> None:
        self._store.put_object(
            ".minio.sys", self._KEYRING_PATH, json.dumps(ring).encode()
        )

    def _named_material(self, name: str) -> bytes:
        """Material for key `name`; the default key id maps to the master.

        The keyring (TTL-cached) is the source of truth on every call —
        the unsealed-material cache is keyed by the sealed blob, so a
        deleted key expires with the ring and a re-created key of the
        same name never serves stale material."""
        if not name or name == self.key_id:
            return self._master
        sealed_hex = self._keyring().get(name)
        if sealed_hex is None:
            raise KeyNotFoundError(f"key does not exist: {name}")
        cached = self._keys.get(name)
        if cached is not None and cached[0] == sealed_hex:
            return cached[1]
        key = self.unseal(bytes.fromhex(sealed_hex), f"kms-key/{name}")
        self._keys[name] = (sealed_hex, key)
        return key

    @counted_kms_op
    def create_key(self, name: str, material: bytes | None = None) -> None:
        """Create (or import, when material is given) a named key."""
        if not name or "/" in name or len(name) > 80:
            raise CryptoError(f"invalid key name: {name!r}")
        if getattr(self, "_store", None) is None:
            raise CryptoError("named keys need a persistent backend")
        if material is not None and len(material) != 32:
            raise CryptoError("imported key material must be 32 bytes")
        mtx = _ns_mutex(self._store, ".minio.sys", self._KEYRING_PATH + ".w")
        if mtx is not None and not mtx.lock(timeout=30.0):
            raise KMSBackendError("could not lock KMS keyring")
        try:
            ring = self._keyring(fresh=True)
            if name == self.key_id or name in ring:
                raise KeyExistsError(f"key already exists: {name}")
            key = material if material is not None else secrets.token_bytes(32)
            ring[name] = self.seal(key, f"kms-key/{name}").hex()
            self._save_keyring(ring)
            self._ring_cache = None
            self._keys[name] = (ring[name], key)
        finally:
            if mtx is not None:
                mtx.unlock()

    def _key_exists(self, name: str) -> bool:
        return name == self.key_id or name in self._keyring()

    @counted_kms_op
    def list_keys(self, pattern: str = "*") -> list[str]:
        import fnmatch

        names = {self.key_id, *self._keyring()}
        pattern = pattern or "*"
        return sorted(n for n in names if fnmatch.fnmatch(n, pattern))

    @counted_kms_op
    def key_status(self, name: str) -> dict:
        if not self._key_exists(name):
            raise KeyNotFoundError(f"key does not exist: {name}")
        return {"key-id": name, "encryption": "AES-256-GCM", "status": "ok"}

    @counted_kms_op
    def delete_key(self, name: str) -> None:
        if name == self.key_id:
            raise CryptoError("cannot delete the default master key")
        mtx = _ns_mutex(self._store, ".minio.sys", self._KEYRING_PATH + ".w")
        if mtx is not None and not mtx.lock(timeout=30.0):
            raise KMSBackendError("could not lock KMS keyring")
        try:
            ring = self._keyring(fresh=True)
            if name not in ring:
                raise KeyNotFoundError(f"key does not exist: {name}")
            del ring[name]
            self._save_keyring(ring)
            self._ring_cache = None
            self._keys.pop(name, None)
        finally:
            if mtx is not None:
                mtx.unlock()

    # -- data-key operations -------------------------------------------------

    @counted_kms_op
    def generate_key(self, context: str, key_name: str | None = None) -> tuple[bytes, bytes]:
        """(plaintext_key, sealed_key) bound to a context string."""
        plain = secrets.token_bytes(32)
        return plain, self.seal(plain, context, key_name)

    @counted_kms_op
    def seal(self, key: bytes, context: str, key_name: str | None = None) -> bytes:
        master = (
            self._named_material(key_name) if key_name else self._master
        )
        nonce = secrets.token_bytes(NONCE_SIZE)
        ct = _aesgcm(master).encrypt(nonce, key, context.encode())
        return nonce + ct

    @counted_kms_op
    def unseal(self, sealed: bytes, context: str, key_name: str | None = None) -> bytes:
        master = (
            self._named_material(key_name) if key_name else self._master
        )
        try:
            return _aesgcm(master).decrypt(
                sealed[:NONCE_SIZE], sealed[NONCE_SIZE:], context.encode()
            )
        except Exception:
            raise CryptoError("KMS unseal failed (wrong key or context)") from None

    def status(self) -> dict:
        return {"keyId": self.key_id, "status": "online", "backend": "builtin"}


def _packet_nonce(base_iv: bytes, index: int) -> bytes:
    """Nonce = base IV with the packet index mixed into the tail — packets
    cannot be swapped or replayed at other positions."""
    out = bytearray(base_iv)
    idx = index.to_bytes(4, "big")
    for i in range(4):
        out[NONCE_SIZE - 4 + i] ^= idx[i]
    return bytes(out)


def encrypt_packets_iter(chunks, key: bytes, base_iv: bytes, plain_count: list):
    """Incrementally seal a chunk iterator into the packet stream; appends
    the total plaintext size into plain_count[0] when exhausted (streamed
    SSE parts must never buffer the whole part)."""
    aes = _aesgcm(key)
    buf = bytearray()
    idx = 0
    total = 0
    for ch in chunks:
        total += len(ch)
        buf += ch
        while len(buf) >= PACKET_SIZE:
            nonce = _packet_nonce(base_iv, idx)
            yield nonce + aes.encrypt(nonce, bytes(buf[:PACKET_SIZE]), None)
            del buf[:PACKET_SIZE]
            idx += 1
    if buf:
        nonce = _packet_nonce(base_iv, idx)
        yield nonce + aes.encrypt(nonce, bytes(buf), None)
    plain_count[0] = total


def encrypt_stream(data: bytes, key: bytes, base_iv: bytes) -> bytes:
    """Seal data into the packet stream."""
    aes = _aesgcm(key)
    out = bytearray()
    for pi, off in enumerate(range(0, len(data), PACKET_SIZE)):
        chunk = data[off : off + PACKET_SIZE]
        nonce = _packet_nonce(base_iv, pi)
        out += nonce
        out += aes.encrypt(nonce, chunk, None)
    return bytes(out)


def decrypt_stream(stored: bytes, key: bytes, base_iv: bytes) -> bytes:
    aes = _aesgcm(key)
    out = bytearray()
    pi = 0
    off = 0
    n = len(stored)
    while off < n:
        nonce = stored[off : off + NONCE_SIZE]
        expect = _packet_nonce(base_iv, pi)
        if nonce != expect:
            raise CryptoError(f"packet {pi}: nonce mismatch (tampering?)")
        end = min(off + STORED_PACKET, n)
        ct = stored[off + NONCE_SIZE : end]
        try:
            out += aes.decrypt(nonce, ct, None)
        except Exception:
            raise CryptoError(f"packet {pi}: authentication failed") from None
        off = end
        pi += 1
    return bytes(out)


def stored_size(plain_size: int) -> int:
    if plain_size == 0:
        return 0
    packets = -(-plain_size // PACKET_SIZE)
    return plain_size + packets * (NONCE_SIZE + TAG_SIZE)


def stored_range(start: int, length: int) -> tuple[int, int, int]:
    """Map a plaintext range -> (stored_offset, stored_length, skip).

    Returns the stored byte range covering whole packets plus the number of
    plaintext bytes to skip in the first decrypted packet."""
    first = start // PACKET_SIZE
    last = (start + length - 1) // PACKET_SIZE
    skip = start - first * PACKET_SIZE
    s_off = first * STORED_PACKET
    s_len = (last - first + 1) * STORED_PACKET  # may overrun; caller clamps
    return s_off, s_len, skip


def decrypt_packets(
    stored: bytes, key: bytes, base_iv: bytes, first_packet: int
) -> bytes:
    """Decrypt a run of packets starting at `first_packet`."""
    aes = _aesgcm(key)
    out = bytearray()
    off = 0
    pi = first_packet
    n = len(stored)
    while off < n:
        nonce = stored[off : off + NONCE_SIZE]
        if nonce != _packet_nonce(base_iv, pi):
            raise CryptoError(f"packet {pi}: nonce mismatch")
        end = min(off + STORED_PACKET, n)
        try:
            out += aes.decrypt(nonce, stored[off + NONCE_SIZE : end], None)
        except Exception:
            raise CryptoError(f"packet {pi}: authentication failed") from None
        off = end
        pi += 1
    return bytes(out)


# -- request-level helpers ---------------------------------------------------

def parse_ssec_headers(headers, copy_source: bool = False) -> bytes | None:
    """Extract + validate the SSE-C customer key from request headers."""
    prefix = (
        "x-amz-copy-source-server-side-encryption-customer-"
        if copy_source
        else "x-amz-server-side-encryption-customer-"
    )
    algo = headers.get(prefix + "algorithm")
    if not algo:
        return None
    if algo != "AES256":
        raise CryptoError("SSE-C algorithm must be AES256")
    try:
        key = base64.b64decode(headers.get(prefix + "key", ""))
        md5 = headers.get(prefix + "key-md5", "")
    except Exception:
        raise CryptoError("bad SSE-C key encoding") from None
    if len(key) != 32:
        raise CryptoError("SSE-C key must be 32 bytes")
    if base64.b64encode(hashlib.md5(key).digest()).decode() != md5:
        raise CryptoError("SSE-C key MD5 mismatch")
    return key
