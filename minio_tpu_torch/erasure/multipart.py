"""Multipart uploads: each part an independent erasure stream, stitched by
metadata only at completion.

Mirrors MinIO cmd/erasure-multipart.go: uploads live under the
system volume (getUploadIDDir, :47); PutObjectPart erasure-codes each part
(:575); CompleteMultipartUpload moves part shard files into the final
object's data dir and writes one xl.meta whose parts[] stitches them
(:1096) — part data is never re-encoded or rewritten.
"""

from __future__ import annotations

import hashlib
import uuid
from dataclasses import dataclass

from ..storage import errors
from ..storage.datatypes import FileInfo, ObjectPartInfo, now_ns
from ..utils.hashing import hash_order
from .quorum import (
    ObjectNotFound,
    QuorumError,
    VersionNotFound,
    reduce_quorum_errs,
)
from .set import ErasureSet, _lock_dyn
from .types import ObjectInfo

MP_VOLUME = ".minio.sys/multipart"
POOL_SEP = "~"  # upload ids are "<pool_idx>~<uuid>" so every part/complete
# call resolves to the pool (and thus set) that started the upload


class UploadNotFound(Exception):
    pass


class InvalidPart(Exception):
    pass


class InvalidPartOrder(Exception):
    pass


@dataclass
class PartRecord:
    number: int
    etag: str
    size: int
    mod_time: int


class MultipartManager:
    def __init__(self, es: ErasureSet, part_transform=None):
        self.es = es
        self.part_transform = part_transform

    def _upload_key(self, bucket: str, obj: str, upload_id: str) -> str:
        return f"{bucket}/{obj}/uploads/{upload_id}"

    def _part_key(self, bucket: str, obj: str, upload_id: str, n: int) -> str:
        return f"{self._upload_key(bucket, obj, upload_id)}/part-meta/{n:05d}"

    # -- lifecycle -----------------------------------------------------------

    def new_upload(
        self,
        bucket: str,
        obj: str,
        user_defined: dict[str, str] | None = None,
        parity: int | None = None,
        family: str | None = None,
    ) -> str:
        if not self.es.bucket_exists(bucket):
            from .quorum import BucketNotFound

            raise BucketNotFound(bucket)
        upload_id = str(uuid.uuid4())
        meta = dict(user_defined or {})
        meta["__distribution"] = ",".join(
            str(x) for x in hash_order(f"{bucket}/{obj}", self.es.n)
        )
        if parity is not None:
            meta["__parity"] = str(parity)
        # the upload's code family pins at initiation (like parity and
        # distribution): every part must share the final object's shard
        # format, even if MINIO_TPU_EC_FAMILY changes mid-upload
        from .coder import default_ec_family

        meta["__family"] = family or default_ec_family()
        self.es.put_object(
            MP_VOLUME,
            self._upload_key(bucket, obj, upload_id),
            b"",
            user_defined=meta,
        )
        return upload_id

    def _upload_meta(self, bucket: str, obj: str, upload_id: str) -> ObjectInfo:
        try:
            return self.es.get_object_info(
                MP_VOLUME, self._upload_key(bucket, obj, upload_id)
            )
        except ObjectNotFound:
            raise UploadNotFound(upload_id) from None

    def put_part(
        self, bucket: str, obj: str, upload_id: str, part_number: int, data: bytes,
        extra_meta: dict[str, str] | None = None,
        transform_ctx=None,
    ) -> str:
        if not 1 <= part_number <= 10000:
            raise InvalidPart(f"part number {part_number}")
        up = self._upload_meta(bucket, obj, upload_id)
        dist = [int(x) for x in up.user_defined["__distribution"].split(",")]
        parity = int(up.user_defined.get("__parity", self.es.default_parity))
        # absent __family (upload initiated before the family field
        # existed) can ONLY mean its earlier parts were framed
        # reedsolomon — falling back to the CURRENT default here would
        # mix shard formats inside one object if the knob flipped
        # mid-upload across a restart
        family = up.user_defined.get("__family") or "reedsolomon"
        part_meta: dict[str, str] | None = dict(extra_meta) if extra_meta else None
        plain_after = None  # streamed transforms know the size only at EOF
        if self.part_transform is not None:
            transformed = self.part_transform(
                bucket, obj, up.user_defined, part_number, data, transform_ctx
            )
            if transformed is not None:
                data, plain = transformed
                if callable(plain):
                    plain_after = plain
                else:
                    part_meta = {**(part_meta or {}), "__plain_size": str(plain)}
        pkey = self._part_key(bucket, obj, upload_id, part_number)
        oi = self.es.put_object(
            MP_VOLUME,
            pkey,
            data,  # bytes or a chunk iterator (streamed parts)
            user_defined=part_meta,
            parity=parity,
            distribution=dist,
            allow_inline=False,
            family=family,
        )
        if plain_after is not None:
            size = str(plain_after())
            self.es.update_object_metadata(
                MP_VOLUME, pkey, "",
                lambda md: md.__setitem__("__plain_size", size),
            )
        return oi.etag

    def update_part_metadata(
        self, bucket: str, obj: str, upload_id: str, part_number: int,
        extra: dict[str, str],
    ) -> None:
        """Post-upload part metadata merge (streamed trailer checksums)."""
        pkey = self._part_key(bucket, obj, upload_id, part_number)
        self.es.update_object_metadata(
            MP_VOLUME, pkey, "", lambda md: md.update(extra)
        )

    def list_parts(
        self, bucket: str, obj: str, upload_id: str, max_parts: int = 1000,
        part_marker: int = 0,
    ) -> tuple[list[PartRecord], bool]:
        """Parts after part_marker, plus whether more remain (the S3
        IsTruncated contract, reference cmd/erasure-multipart.go
        ListObjectParts)."""
        self._upload_meta(bucket, obj, upload_id)
        if max_parts <= 0:
            # mirror the reference: maxParts==0 is an empty, NON-truncated
            # page (a truncated page with no next marker cannot progress)
            return [], False
        from . import listing

        # marker walk: part names are zero-padded so the lexicographic
        # listing order IS part-number order; fetch one extra to learn
        # whether the page is truncated
        base = f"{self._upload_key(bucket, obj, upload_id)}/part-meta/"
        res = listing.list_objects(
            self.es,
            MP_VOLUME,
            prefix=base,
            marker=f"{base}{part_marker:05d}" if part_marker else "",
            max_keys=max_parts + 1,
        )
        out = [
            PartRecord(
                int(o.name.rsplit("/", 1)[-1]), o.etag, o.size, o.mod_time
            )
            for o in res.objects
        ]
        return out[:max_parts], len(out) > max_parts

    def list_uploads(self, bucket: str, prefix: str = "") -> list[tuple[str, str]]:
        """[(object_key, upload_id)] of in-progress uploads."""
        from . import listing

        res = listing.list_objects(
            self.es, MP_VOLUME, prefix=f"{bucket}/{prefix}", max_keys=10000
        )
        out = []
        for o in res.objects:
            parts = o.name.split("/uploads/")
            if len(parts) == 2 and "/" not in parts[1]:
                out.append((parts[0][len(bucket) + 1 :], parts[1]))
        return out

    def abort(self, bucket: str, obj: str, upload_id: str) -> None:
        self._upload_meta(bucket, obj, upload_id)
        self._cleanup(bucket, obj, upload_id)

    def _cleanup(self, bucket: str, obj: str, upload_id: str) -> None:
        prefix = self._upload_key(bucket, obj, upload_id)
        for disk in self.es.disks:
            try:
                disk.delete(MP_VOLUME, prefix, recursive=True)
            except Exception:  # noqa: BLE001
                pass
        # recursive delete bypassed delete_object: drop every cached
        # upload/part record under the prefix through the choke point
        self.es.cache.invalidate_prefix(MP_VOLUME, prefix)

    # -- completion ------------------------------------------------------------

    def complete(
        self,
        bucket: str,
        obj: str,
        upload_id: str,
        parts: list[tuple[int, str]],
        versioned: bool = False,
        part_checksums: dict[int, dict[str, str]] | None = None,
        check_precond=None,
    ) -> ObjectInfo:
        """Stitch uploaded parts into the final object (metadata only).

        part_checksums: client-supplied per-part x-amz-checksum values from
        the CompleteMultipartUpload XML — verified against the stored part
        checksums, then folded into the composite object checksum
        (reference internal/hash/checksum.go composite semantics)."""
        from ..utils import checksum as cks

        up = self._upload_meta(bucket, obj, upload_id)
        dist = [int(x) for x in up.user_defined["__distribution"].split(",")]
        parity = int(up.user_defined.get("__parity", self.es.default_parity))
        if not parts:
            raise InvalidPart("no parts listed")
        if parts != sorted(parts, key=lambda t: t[0]) or len(
            {n for n, _ in parts}
        ) != len(parts):
            raise InvalidPartOrder("parts must be ascending and unique")

        # resolve each listed part's stored metadata (quorum)
        part_fis: list[FileInfo] = []
        md5_concat = b""
        total = 0
        for n, etag in parts:
            try:
                pfi, _, _, _ = self.es._quorum_fileinfo(
                    MP_VOLUME, self._part_key(bucket, obj, upload_id, n), "", False
                )
            except Exception:
                raise InvalidPart(f"part {n} not found") from None
            stored_etag = pfi.metadata.get("etag", "")
            if etag.strip('"') != stored_etag:
                raise InvalidPart(f"part {n} etag mismatch")
            for algo, want in (part_checksums or {}).get(n, {}).items():
                stored = pfi.metadata.get(f"{cks.META_PREFIX}{algo}")
                # AWS rejects a checksum member the part wasn't uploaded
                # with — silence here would defeat client-side validation
                if stored is None or stored != want:
                    raise InvalidPart(f"part {n} {algo} checksum mismatch")
            part_fis.append(pfi)
            md5_concat += bytes.fromhex(stored_etag)
            total += pfi.size

        # composite checksums over algorithms stored on EVERY part
        # (CRC64NVME is full-object-only per AWS — no "-N" composite form
        # exists for it, so it stays per-part metadata only)
        composite_meta: dict[str, str] = {}
        part_cks_record: dict[str, dict[str, str]] = {}
        for algo in cks.COMPOSITE_ALGOS:
            vals = [
                pfi.metadata.get(f"{cks.META_PREFIX}{algo}") for pfi in part_fis
            ]
            if all(v is not None for v in vals):
                composite_meta[f"{cks.META_PREFIX}{algo}"] = cks.composite(
                    algo, vals  # type: ignore[arg-type]
                )
                for (n, _), v in zip(parts, vals):
                    part_cks_record.setdefault(str(n), {})[algo] = v  # type: ignore[arg-type]

        final_etag = hashlib.md5(md5_concat).hexdigest() + f"-{len(parts)}"
        fi = FileInfo(volume=bucket, name=obj)
        fi.version_id = str(uuid.uuid4()) if versioned else ""
        fi.mod_time = now_ns()
        fi.size = total
        fi.data_dir = str(uuid.uuid4())
        fi.metadata = {
            k: v for k, v in up.user_defined.items() if not k.startswith("__")
        }
        fi.metadata["etag"] = final_etag
        fi.metadata.update(composite_meta)
        if part_cks_record:
            import json as _cks_json

            fi.metadata[cks.PART_CHECKSUMS_META] = _cks_json.dumps(part_cks_record)
        from ..crypto import sse as ssemod

        if ssemod.META_ALGO in fi.metadata:
            # per-part plaintext sizes: the decode path maps ranges to the
            # overlapping parts' packet streams
            import json as _json

            sizes = [
                [n, int(pfi.metadata.get("__plain_size", pfi.size))]
                for (n, _), pfi in zip(parts, part_fis)
            ]
            fi.metadata[ssemod.META_PART_SIZES] = _json.dumps(sizes)
            fi.metadata[ssemod.META_ACTUAL_SIZE] = str(sum(s for _, s in sizes))
        fi.erasure = part_fis[0].erasure
        fi.erasure.distribution = dist
        fi.erasure.parity_blocks = parity
        fi.erasure.data_blocks = self.es.n - parity
        fi.parts = [
            ObjectPartInfo(n, pfi.size, pfi.size, pfi.mod_time, pfi.metadata.get("etag", ""))
            for (n, _), pfi in zip(parts, part_fis)
        ]

        # the final commit must exclude concurrent put/delete of the same
        # object (same namespace write lock put_object takes)
        mtx = self.es.ns.new(bucket, obj)
        # same adaptive deadline as put_object: under contention both
        # planes loosen together (and both feed the estimator)
        if not _lock_dyn(mtx, write=True):
            # server-side contention is retryable, not a client error
            raise QuorumError(f"namespace lock timeout completing {bucket}/{obj}")
        if check_precond is not None:
            # conditional completes (If-None-Match/If-Match on
            # CompleteMultipartUpload) evaluate under the same lock as the
            # commit — identical discipline to put_object's hook
            try:
                try:
                    cfi, _, _, _ = self.es._quorum_fileinfo(
                        bucket, obj, "", read_data=False
                    )
                    cur = None if cfi.deleted else self.es._to_object_info(
                        bucket, obj, cfi
                    )
                except (ObjectNotFound, VersionNotFound,
                        errors.FileNotFound, errors.FileVersionNotFound):
                    cur = None  # genuinely absent: precondition sees None
                    # (quorum/storage failures PROPAGATE — a conditional
                    # complete must not treat an unreadable object as
                    # absent and overwrite it)
                check_precond(cur)
            except BaseException:
                mtx.unlock()
                raise

        def commit(i: int, disk) -> None:
            shard_idx = dist[i] - 1
            # move each part's shard file into the final object layout
            for (n, _), pfi in zip(parts, part_fis):
                if mtx.lost:
                    # zombie-holder guard: a committer whose lock was lost
                    # must not rename stale shards over a concurrent write
                    raise QuorumError(
                        f"lock on {bucket}/{obj} lost mid-commit; aborting"
                    )
                src = (
                    f"{self._part_key(bucket, obj, upload_id, n)}/"
                    f"{pfi.data_dir}/part.1"
                )
                disk.rename_file(
                    MP_VOLUME, src, bucket, f"{obj}/{fi.data_dir}/part.{n}"
                )
            dfi = FileInfo.from_dict(fi.to_dict())
            dfi.volume, dfi.name = bucket, obj
            dfi.erasure.index = shard_idx + 1
            disk.write_metadata(bucket, obj, dfi)

        try:
            mtx.start_refresher(write=True)  # 10k-part commits can run long
            futs = [
                self.es._pool.submit(commit, i, disk)
                for i, disk in enumerate(self.es.disks)
            ]
            errs: list[Exception | None] = []
            for f in futs:
                try:
                    f.result()
                    errs.append(None)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
            d = self.es.n - parity
            write_q = d + 1 if d == parity else d
            reduce_quorum_errs(errs, write_q)
        finally:
            mtx.unlock()
        # the commit replaced the live version: write-through invalidation
        # outside the lock (the cross-node broadcast must not inflate
        # lock hold), before the complete response returns
        self.es.cache.invalidate_object(bucket, obj)
        self._cleanup(bucket, obj, upload_id)
        oi = self.es._to_object_info(bucket, obj, fi)
        oi.parts = len(parts)
        return oi


class MultipartRouter:
    """Routes multipart calls through pools -> hashed set.

    The reference routes by getHashedSet(object)
    (MinIO cmd/erasure-sets.go NewMultipartUpload); across pools
    the pool index rides inside the upload id so an upload stays pinned to
    the pool that started it (the reference tracks this server-side).
    """

    def __init__(self, store, part_transform=None):
        self.store = store  # ServerPools or anything with .pools/.get_hashed_set
        # optional hook(bucket, obj, upload_meta, part#, data, ctx) ->
        # (stored_bytes, plain_size) | None — the server wires SSE here;
        # ctx carries per-request state (SSE-C customer key headers)
        self.part_transform = part_transform

    def _pools(self):
        return getattr(self.store, "pools", [self.store])

    def _mgr(self, obj: str, pool_idx: int) -> MultipartManager:
        pools = self._pools()
        if not 0 <= pool_idx < len(pools):
            raise UploadNotFound(f"bad pool index {pool_idx}")
        pool = pools[pool_idx]
        # plain ErasureSet stores have no set routing
        es = pool.get_hashed_set(obj) if hasattr(pool, "get_hashed_set") else pool
        return MultipartManager(es, part_transform=self.part_transform)

    @staticmethod
    def _split(upload_id: str) -> tuple[int, str]:
        if POOL_SEP in upload_id:
            head, raw = upload_id.split(POOL_SEP, 1)
            try:
                return int(head), raw
            except ValueError:
                pass
        return 0, upload_id

    def new_upload(
        self, bucket, obj, user_defined=None, parity=None, family=None
    ) -> str:
        pools = self._pools()
        pool_idx = 0
        if len(pools) > 1:
            # a multipart overwrite must land in the pool already holding
            # the object, like put_object does — otherwise reads keep
            # serving the stale copy from the earlier pool
            try:
                pool_idx = pools.index(self.store._pool_holding(bucket, obj))
            except (ObjectNotFound, ValueError):
                # new object (or holder not in this router's pool list):
                # the placement engine decides (pin/spread rules,
                # weight-by-free-space default)
                pool_idx = pools.index(
                    self.store._placement_pool(bucket, obj)
                )
        raw = self._mgr(obj, pool_idx).new_upload(
            bucket, obj, user_defined, parity, family
        )
        return f"{pool_idx}{POOL_SEP}{raw}"

    def put_part(self, bucket, obj, upload_id, part_number, data,
                 extra_meta=None, transform_ctx=None) -> str:
        pidx, raw = self._split(upload_id)
        return self._mgr(obj, pidx).put_part(
            bucket, obj, raw, part_number, data, extra_meta, transform_ctx
        )

    def update_part_metadata(self, bucket, obj, upload_id, part_number, extra):
        pidx, raw = self._split(upload_id)
        return self._mgr(obj, pidx).update_part_metadata(
            bucket, obj, raw, part_number, extra
        )

    def list_parts(self, bucket, obj, upload_id, max_parts=1000, part_marker=0):
        pidx, raw = self._split(upload_id)
        return self._mgr(obj, pidx).list_parts(bucket, obj, raw, max_parts, part_marker)

    def abort(self, bucket, obj, upload_id) -> None:
        pidx, raw = self._split(upload_id)
        self._mgr(obj, pidx).abort(bucket, obj, raw)

    def complete(self, bucket, obj, upload_id, parts, versioned=False,
                 part_checksums=None, check_precond=None):
        pidx, raw = self._split(upload_id)
        return self._mgr(obj, pidx).complete(
            bucket, obj, raw, parts, versioned, part_checksums, check_precond
        )

    def list_uploads(self, bucket, prefix="") -> list[tuple[str, str]]:
        out = []
        for pidx, pool in enumerate(self._pools()):
            sets = getattr(pool, "sets", [pool])
            for s in sets:
                for key, raw in MultipartManager(s).list_uploads(bucket, prefix):
                    out.append((key, f"{pidx}{POOL_SEP}{raw}"))
        return sorted(set(out))
