"""ErasureSets — many independent erasure sets inside one pool.

Mirrors MinIO cmd/erasure-sets.go: objects hash to exactly one
set via SipHash-2-4 keyed by the deployment id (sipHashMod, :660); sets
never coordinate on the data path. Bucket operations broadcast to all
sets; listing merges all drives' walks (the facade exposes the same
object-layer duck type as a single ErasureSet, so listing/multipart/server
code runs unchanged on top).
"""

from __future__ import annotations

from typing import Iterator

from ..storage.datatypes import FileInfo
from ..storage.interface import StorageAPI
from ..utils.hashing import sip_hash_mod
from .quorum import BucketExists
from .set import ErasureSet
from .types import BucketInfo, ObjectInfo


class ErasureSets:
    def __init__(
        self,
        sets_disks: list[list[StorageAPI]],
        deployment_id: str,
        default_parity: int | None = None,
        pool_index: int = 0,
        ns_lock=None,
    ):
        self.deployment_id = deployment_id
        self._dep_id_bytes = _dep_bytes(deployment_id)
        self.sets = [
            ErasureSet(
                disks, default_parity, set_index=i, pool_index=pool_index,
                ns_lock=ns_lock,
            )
            for i, disks in enumerate(sets_disks)
        ]
        self.pool_index = pool_index

    # facade properties used by listing & friends
    @property
    def disks(self) -> list[StorageAPI]:
        return [d for s in self.sets for d in s.disks]

    @property
    def n(self) -> int:
        return self.sets[0].n

    @property
    def default_parity(self) -> int:
        return self.sets[0].default_parity

    def get_hashed_set(self, key: str) -> ErasureSet:
        if len(self.sets) == 1:
            return self.sets[0]
        idx = sip_hash_mod(key, len(self.sets), self._dep_id_bytes)
        return self.sets[idx]

    # -- buckets (broadcast) ----------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        errs = []
        for s in self.sets:
            try:
                s.make_bucket(bucket)
            except BucketExists as e:
                errs.append(e)
        if errs and len(errs) == len(self.sets):
            raise errs[0]

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        for s in self.sets:
            # miniovet: ignore[coherence-path] -- delegates per set inside
            # the loop (self.sets is never empty); ErasureSet.delete_bucket
            # invalidates its own cache in its locked region
            s.delete_bucket(bucket, force=force)

    def bucket_exists(self, bucket: str) -> bool:
        return all(s.bucket_exists(bucket) for s in self.sets)

    def list_buckets(self) -> list[BucketInfo]:
        return self.sets[0].list_buckets()

    # -- objects (hash-routed) --------------------------------------------

    def put_object(self, bucket: str, obj: str, data: bytes, *a, **kw) -> ObjectInfo:
        return self.get_hashed_set(obj).put_object(bucket, obj, data, *a, **kw)

    def get_object(self, bucket: str, obj: str, *a, **kw):
        return self.get_hashed_set(obj).get_object(bucket, obj, *a, **kw)

    def open_object(self, bucket: str, obj: str, version_id: str = "",
                    range_hint=None):
        return self.get_hashed_set(obj).open_object(
            bucket, obj, version_id, range_hint
        )

    def get_object_info(self, bucket: str, obj: str, version_id: str = "") -> ObjectInfo:
        return self.get_hashed_set(obj).get_object_info(bucket, obj, version_id)

    def delete_object(
        self, bucket: str, obj: str, version_id: str = "", *a, **kw
    ) -> ObjectInfo:
        return self.get_hashed_set(obj).delete_object(bucket, obj, version_id, *a, **kw)

    def list_object_versions(self, bucket: str, obj: str) -> list[ObjectInfo]:
        return self.get_hashed_set(obj).list_object_versions(bucket, obj)

    def heal_object(self, bucket: str, obj: str, version_id: str = "") -> dict:
        return self.get_hashed_set(obj).heal_object(bucket, obj, version_id)

    def walk_objects(self, bucket: str, prefix: str = "") -> Iterator[str]:
        from . import listing

        for raw in listing._merged_keys(self, bucket, prefix):
            yield raw

    def set_object_tags(self, bucket, obj, tags, version_id=""):
        return self.get_hashed_set(obj).set_object_tags(bucket, obj, tags, version_id)

    def transition_object(self, bucket, obj, tier, remote_key, version_id="", restub=False):
        return self.get_hashed_set(obj).transition_object(
            bucket, obj, tier, remote_key, version_id, restub
        )

    def restore_object(self, bucket, obj, data, days, version_id=""):
        return self.get_hashed_set(obj).restore_object(
            bucket, obj, data, days, version_id
        )

    def update_object_metadata(self, bucket, obj, version_id, mutate):
        return self.get_hashed_set(obj).update_object_metadata(
            bucket, obj, version_id, mutate
        )

    def get_object_tags(self, bucket, obj, version_id=""):
        return self.get_hashed_set(obj).get_object_tags(bucket, obj, version_id)


def _dep_bytes(deployment_id: str) -> bytes:
    import uuid as _uuid

    try:
        return _uuid.UUID(deployment_id).bytes
    except ValueError:
        return (deployment_id.encode() + b"\0" * 16)[:16]
