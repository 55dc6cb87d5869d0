"""BucketMetadataSys — per-bucket config persisted in the object store.

Mirrors the reference's BucketMetadataSys (MinIO cmd/
bucket-metadata-sys.go): bucket metadata (creation time, versioning config,
policy, tags, ...) lives as objects under the system volume and is cached
in memory; every node recovers it from the backend at boot.
"""

from __future__ import annotations

import json
import threading

from ..erasure.quorum import ObjectNotFound

SYSTEM_BUCKET = ".minio.sys"
CONFIG_PREFIX = "buckets"


class BucketMetadata:
    def __init__(self, name: str, created_ns: int = 0):
        self.name = name
        self.created_ns = created_ns
        self.versioning = False
        self.versioning_suspended = False
        self.policy: dict | None = None
        self.tags: dict[str, str] = {}
        self.quota: int = 0
        self.lifecycle: str | None = None  # raw XML, served back as stored
        self.notification: str | None = None
        self.encryption: str | None = None
        self.object_lock: str | None = None
        self.cors: str | None = None
        self.replication: str | None = None
        self.ownership: str | None = None  # OwnershipControls XML

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @staticmethod
    def from_json(name: str, buf: bytes) -> "BucketMetadata":
        bm = BucketMetadata(name)
        try:
            bm.__dict__.update(json.loads(buf))
        except (ValueError, TypeError):
            pass
        bm.name = name
        return bm


class BucketMetadataSys:
    def __init__(self, store):
        self.store = store  # object layer (ErasureSet / pools)
        self._cache: dict[str, BucketMetadata] = {}
        self._lock = threading.Lock()
        # post-persist hook (site replication); set to None while applying
        # a remote change to avoid echo loops
        self.on_change = None

    def peek(self, bucket: str):
        """Cache-only lookup (no storage IO): for callers on the event
        loop that must never block, e.g. CORS response decoration."""
        with self._lock:
            return self._cache.get(bucket)

    def _key(self, bucket: str) -> str:
        return f"{CONFIG_PREFIX}/{bucket}/.metadata.json"

    def get(self, bucket: str) -> BucketMetadata:
        with self._lock:
            bm = self._cache.get(bucket)
        if bm is not None:
            return bm
        try:
            _, it = self.store.get_object(SYSTEM_BUCKET, self._key(bucket))
            bm = BucketMetadata.from_json(bucket, b"".join(it))
        except ObjectNotFound:
            bm = BucketMetadata(bucket)  # never configured: defaults
        # any OTHER failure (quorum loss, IO) must propagate — silently
        # defaulting would run a versioned bucket unversioned
        with self._lock:
            self._cache[bucket] = bm
        return bm

    def set(self, bucket: str, bm: BucketMetadata, notify: bool = True) -> None:
        """notify=False for internally-applied changes (site replication
        applying a peer's update) — toggling the shared hook instead would
        race across threads and could permanently drop it."""
        self.store.put_object(SYSTEM_BUCKET, self._key(bucket), bm.to_json())
        with self._lock:
            self._cache[bucket] = bm
        if notify and self.on_change is not None:
            try:
                self.on_change(bucket, bm)
            except Exception:  # noqa: BLE001 — sync is best-effort async
                pass

    def drop(self, bucket: str) -> None:
        with self._lock:
            self._cache.pop(bucket, None)
        try:
            self.store.delete_object(SYSTEM_BUCKET, self._key(bucket))
        except Exception:  # noqa: BLE001
            pass
        # a deleted (or soon recreated) bucket must not leave listing
        # caches behind — in memory or persisted
        from ..erasure import listing as _listing

        _listing.invalidate_bucket(bucket)
        try:
            for raw in self.store.walk_objects(
                SYSTEM_BUCKET, f"{CONFIG_PREFIX}/{bucket}/.metacache/"
            ):
                try:
                    self.store.delete_object(SYSTEM_BUCKET, raw)
                except Exception:  # noqa: BLE001
                    pass
        except Exception:  # noqa: BLE001
            pass
