"""ServerPools — the top-level ObjectLayer over one or more pools.

Mirrors MinIO cmd/erasure-server-pool.go: new objects land in
the pool with the most free space; reads/deletes fan out to find the pool
that holds the object; buckets exist on every pool. Each pool is an
ErasureSets. This is the object the S3 server programs against.
"""

from __future__ import annotations

from typing import Iterator

from ..storage.datatypes import FileInfo
from ..storage.errors import StorageError
from ..storage.interface import StorageAPI
from .quorum import ErasureError, ObjectNotFound, VersionNotFound
from .sets import ErasureSets
from .types import BucketInfo, ObjectInfo


class ServerPools:
    def __init__(self, pools: list[ErasureSets]):
        from ..placement import PlacementPolicy

        if not pools:
            raise ValueError("need at least one pool")
        self.pools = pools
        # pool indexes currently decommissioning (set by PoolManager):
        # NEW objects never land there, or the drain would chase live
        # writes forever. Indexes are re-stamped by topology.remove_pool.
        self.draining: set[int] = set()
        # placement policy engine (placement/policy.py): consulted for
        # every NEW object's pool; rules persist through this store
        self.placement = PlacementPolicy(self)

    # facade plumbing for listing/multipart
    @property
    def disks(self) -> list[StorageAPI]:
        return [d for p in self.pools for d in p.disks]

    @property
    def n(self) -> int:
        return self.pools[0].n

    @property
    def default_parity(self) -> int:
        return self.pools[0].default_parity

    # -- placement ---------------------------------------------------------

    def _pool_with_most_free(self) -> ErasureSets:
        if len(self.pools) == 1:
            return self.pools[0]
        draining = self.draining if len(self.draining) < len(self.pools) else set()
        best, best_free = self.pools[0], -1
        for i, p in enumerate(self.pools):
            if i in draining:
                continue  # a decommissioning pool takes no new objects
            free = 0
            for d in p.disks:
                try:
                    free += d.disk_info().free
                except (StorageError, OSError):
                    pass  # offline drive contributes no free space
            if free > best_free:
                best, best_free = p, free
        return best

    def _placement_pool(self, bucket: str, obj: str) -> ErasureSets:
        """Pool for a NEW object: the placement engine's decision
        (pin/spread rules, weight-by-free-space default), falling back to
        the legacy most-free heuristic when placement is off or the key
        is in the system namespace (whose writes include the engine's own
        rule persistence — they must never re-enter it)."""
        from ..placement import placement_enabled

        if len(self.pools) == 1:
            return self.pools[0]
        if bucket.startswith(".minio.sys"):
            # system namespace anchors on pool 0: IAM docs, placement
            # rules, and decommission checkpoints must never land on a
            # pool that can be decommissioned and detached (remove_pool
            # refuses pool 0); also breaks the recursion the placement
            # engine's own rule persistence would otherwise cause
            return self.pools[0]
        if not placement_enabled():
            return self._pool_with_most_free()
        idx = self.placement.pool_index_for(bucket, obj)
        if 0 <= idx < len(self.pools):
            return self.pools[idx]
        return self._pool_with_most_free()

    def _pool_holding(self, bucket: str, obj: str, version_id: str = "") -> ErasureSets:
        """Pool that already has the object (parallel lookup in the
        reference, getPoolInfoExistingWithOpts); raises ObjectNotFound."""
        last: Exception = ObjectNotFound(f"{bucket}/{obj}")
        for p in self.pools:
            try:
                p.get_object_info(bucket, obj, version_id)
                return p
            except (ObjectNotFound, VersionNotFound) as e:
                last = e
        raise last

    # -- buckets -----------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        for p in self.pools:
            p.make_bucket(bucket)

    def delete_bucket(self, bucket: str, force: bool = False) -> None:
        for p in self.pools:
            # miniovet: ignore[coherence-path] -- delegates per pool inside
            # the loop (self.pools is never empty); every ErasureSet
            # underneath invalidates its own cache in its locked region
            p.delete_bucket(bucket, force=force)

    def bucket_exists(self, bucket: str) -> bool:
        return any(p.bucket_exists(bucket) for p in self.pools)

    def list_buckets(self) -> list[BucketInfo]:
        return self.pools[0].list_buckets()

    # -- objects -----------------------------------------------------------

    def put_object(self, bucket: str, obj: str, data: bytes, *a, **kw) -> ObjectInfo:
        # overwrite in place if some pool already holds the object; new
        # objects land where the placement engine says
        if len(self.pools) > 1:
            try:
                pool = self._pool_holding(bucket, obj)
            except (ObjectNotFound, VersionNotFound):
                pool = self._placement_pool(bucket, obj)
        else:
            pool = self.pools[0]
        return pool.put_object(bucket, obj, data, *a, **kw)

    def get_object(self, bucket: str, obj: str, version_id: str = "", *a, **kw):
        return self._pool_holding(bucket, obj, version_id).get_object(
            bucket, obj, version_id, *a, **kw
        )

    def open_object(self, bucket: str, obj: str, version_id: str = "",
                    range_hint=None):
        # the returned handle is bound to the concrete set that holds the
        # object — later reads never re-resolve pools
        return self._pool_holding(bucket, obj, version_id).open_object(
            bucket, obj, version_id, range_hint
        )

    def get_object_info(self, bucket: str, obj: str, version_id: str = "") -> ObjectInfo:
        return self._pool_holding(bucket, obj, version_id).get_object_info(
            bucket, obj, version_id
        )

    def delete_object(
        self, bucket: str, obj: str, version_id: str = "", versioned: bool = False, **kw
    ) -> ObjectInfo:
        try:
            pool = self._pool_holding(bucket, obj, version_id)
        except (ObjectNotFound, VersionNotFound):
            if versioned:
                # delete marker still gets written somewhere deterministic
                pool = self.pools[0]
            else:
                raise
        return pool.delete_object(bucket, obj, version_id, versioned=versioned, **kw)

    def list_object_versions(self, bucket: str, obj: str) -> list[ObjectInfo]:
        out: list[ObjectInfo] = []
        for p in self.pools:
            try:
                out.extend(p.list_object_versions(bucket, obj))
            except (ErasureError, StorageError, OSError):
                pass  # pool doesn't hold the object (or is offline)
        out.sort(key=lambda o: o.mod_time, reverse=True)
        return out

    def heal_object(self, bucket: str, obj: str, version_id: str = "") -> dict:
        return self._pool_holding(bucket, obj, version_id).heal_object(
            bucket, obj, version_id
        )

    def walk_objects(self, bucket: str, prefix: str = "") -> Iterator[str]:
        for p in self.pools:
            yield from p.walk_objects(bucket, prefix)

    def set_object_tags(self, bucket, obj, tags, version_id=""):
        return self._pool_holding(bucket, obj, version_id).set_object_tags(
            bucket, obj, tags, version_id
        )

    def transition_object(self, bucket, obj, tier, remote_key, version_id="", restub=False):
        return self._pool_holding(bucket, obj, version_id).transition_object(
            bucket, obj, tier, remote_key, version_id, restub
        )

    def restore_object(self, bucket, obj, data, days, version_id=""):
        return self._pool_holding(bucket, obj, version_id).restore_object(
            bucket, obj, data, days, version_id
        )

    def update_object_metadata(self, bucket, obj, version_id, mutate):
        return self._pool_holding(bucket, obj, version_id).update_object_metadata(
            bucket, obj, version_id, mutate
        )

    def get_object_tags(self, bucket, obj, version_id=""):
        return self._pool_holding(bucket, obj, version_id).get_object_tags(
            bucket, obj, version_id
        )
