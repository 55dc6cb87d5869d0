"""Object-level S3 handlers: put/get/head/delete/copy, ranges and
preconditions, tiering restore, retention/legal-hold/tagging, Select,
object lambda, multi-delete.

Split from app.py (the reference's cmd/object-handlers.go)."""

from __future__ import annotations

import asyncio
import hashlib
import os
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import parsedate_to_datetime
from xml.sax.saxutils import escape

from . import web

from ..erasure import listing, quorum
from ..erasure.types import ObjectInfo
from . import s3err, signature
from .handler_utils import (
    _restored_locally,
    _verify_checksum_headers,
    _bucket_sse_algo,
    _iso8601,
    _http_date,
)


class ObjectHandlersMixin:
    def _parity_for_storage_class(self, request) -> int | None:
        """Per-request EC parity from x-amz-storage-class (reference
        cmd/erasure-object.go:1299 + internal/config/storageclass):
        STANDARD uses MINIO_STORAGE_CLASS_STANDARD when set,
        REDUCED_REDUNDANCY uses MINIO_STORAGE_CLASS_RRS (default EC:2).
        Unknown classes (e.g. tier names) keep the set default."""
        sc = request.headers.get("x-amz-storage-class", "")
        if not sc or sc == "STANDARD":
            spec = os.environ.get("MINIO_STORAGE_CLASS_STANDARD", "")
        elif sc == "REDUCED_REDUNDANCY":
            spec = os.environ.get("MINIO_STORAGE_CLASS_RRS", "EC:2")
        else:
            return None
        if not spec.startswith("EC:"):
            return None
        try:
            p = int(spec[3:])
        except ValueError:
            return None
        n = getattr(self.store, "n", 0)
        if n < 2:
            return None
        return max(1, min(p, n // 2))

    def _family_for_storage_class(self, request) -> str | None:
        """Per-request erasure code family from x-amz-storage-class:
        MINIO_TPU_EC_FAMILY_STANDARD / MINIO_TPU_EC_FAMILY_RRS override
        the node-wide MINIO_TPU_EC_FAMILY for their class; the family is
        recorded in xl.meta so reads/heals of existing objects never
        depend on these knobs. None defers to the erasure layer default
        (which reads MINIO_TPU_EC_FAMILY itself)."""
        from ..erasure.bitrot_io import FAMILIES

        sc = request.headers.get("x-amz-storage-class", "")
        if not sc or sc == "STANDARD":
            fam = os.environ.get("MINIO_TPU_EC_FAMILY_STANDARD", "")
        elif sc == "REDUCED_REDUNDANCY":
            fam = os.environ.get("MINIO_TPU_EC_FAMILY_RRS", "")
        else:
            fam = ""
        return fam if fam in FAMILIES else None

    def put_standard_object(self, bucket, key, data, user_defined=None):
        """An object PUT from a protocol gateway (FTP, SFTP) at the
        STANDARD storage class: the parity and family an S3 PUT without
        an x-amz-storage-class header gets. MinIO's object layer applies
        the class to every frontend's writes (cmd/erasure-object.go
        putObject); the JAX package's gateways write at the set's default
        parity, so MINIO_STORAGE_CLASS_STANDARD=EC:8 on 16 drives gave
        their objects EC:4."""
        import types

        standard = types.SimpleNamespace(headers={})
        return self.store.put_object(
            bucket, key, data, user_defined,
            parity=self._parity_for_storage_class(standard),
            family=self._family_for_storage_class(standard),
        )

    async def _proxy_get_remote(self, request, bucket, key, vid=""):
        """Serve a not-yet-replicated object from a replication target.

        Returns None when no target has it (or proxying is disabled /
        this request already IS a proxy — loop breaker). Streams the
        remote body chunk by chunk — a lagging multi-GB object must not
        be buffered whole per request."""
        if request.headers.get("x-minio-source-proxy-request") == "true":
            return None
        if os.environ.get("MINIO_TPU_REPLICATION_PROXY", "on") == "off":
            return None
        if not self.buckets.get(bucket).versioning:
            # the reference requires versioning for replication; without it
            # a hard delete leaves no local trace and proxying would
            # resurrect deleted objects
            return None
        targets = self.repl_targets.list(bucket)
        if not targets:
            return None
        # only proxy when the object has NO local trace: a local delete
        # marker (or any version) means the 404 is authoritative — proxying
        # would resurrect deleted objects from a lagging peer
        try:
            if await self._run(self.store.list_object_versions, bucket, key):
                return None
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — degraded listing: don't proxy
            return None
        hdrs = {"x-minio-source-proxy-request": "true"}
        rng = request.headers.get("Range")
        if rng:
            hdrs["Range"] = rng

        import http.client as _hc

        from .signature import sign_request

        def open_remote():
            """(status, resp-headers, http response) from the first target
            that has the object, None otherwise."""
            q = f"?versionId={urllib.parse.quote(vid)}" if vid else ""
            for t in targets:
                try:
                    path = "/" + t.target_bucket + "/" + urllib.parse.quote(key, safe="/~-._") + q
                    url = f"http://{t.endpoint.split('//')[-1]}{path}"
                    signed = sign_request(
                        "GET", url, dict(hdrs), "UNSIGNED-PAYLOAD",
                        t.access_key, t.secret_key, self.region,
                    )
                    host = t.endpoint.split("//")[-1]
                    conn = _hc.HTTPConnection(host, timeout=30)
                    conn.request("GET", path, headers=signed)
                    resp = conn.getresponse()
                    if resp.status in (200, 206):
                        return resp
                    resp.read()
                    conn.close()
                except Exception:  # noqa: BLE001 — peer down: try the next
                    continue
            return None

        resp = await self._run(open_remote)
        if resp is None:
            return None
        out_headers = {
            k.lower(): v for k, v in resp.getheaders()
            if k.lower() in ("etag", "last-modified", "content-type",
                             "content-range", "content-length",
                             "x-amz-version-id")
            or k.lower().startswith("x-amz-meta-")
        }
        sresp = web.StreamResponse(status=resp.status, headers=out_headers)
        await sresp.prepare(request)
        loop = asyncio.get_running_loop()
        request["_tx"] = 0
        try:
            while True:
                chunk = await loop.run_in_executor(
                    self._io_pool, resp.read, 1 << 20
                )
                if not chunk:
                    break
                await sresp.write(chunk)
                request["_tx"] += len(chunk)
        finally:
            resp.close()
        await sresp.write_eof()
        return sresp

    async def _get_from_tier(self, request, bucket, key, oi) -> web.StreamResponse:
        """Read-through GET of a transitioned object: bytes come from the
        warm tier (reference streams transitioned objects from the tier
        the same way, cmd/bucket-lifecycle.go getTransitionedObjectReader).
        """
        from ..ilm import tier as tiermod

        tname = oi.user_defined.get(tiermod.TRANSITION_TIER_META, "")
        rkey = oi.user_defined.get(tiermod.TRANSITION_KEY_META, "")
        t = self.tiers.get(tname)
        if t is None:
            raise s3err.InternalError
        self._check_preconditions(request, oi)
        hdrs = {}
        rng = self._parse_range(request, oi.size) if oi.size else None
        if rng:
            hdrs["Range"] = f"bytes={rng[0]}-{rng[1]}"

        def fetch():
            r = t.client().get_object(t.bucket, rkey, headers=hdrs)
            if r.status not in (200, 206):
                raise RuntimeError(f"tier read failed: HTTP {r.status}")
            return r.body

        body = await self._run(fetch)
        headers = self._obj_headers(oi)
        headers["x-amz-storage-class"] = tname
        if rng:
            start, end = rng
            if len(body) == oi.size:
                # tier ignored the Range header: slice locally rather than
                # serving the whole object mislabeled as a range
                body = body[start:end + 1]
            headers["Content-Range"] = f"bytes {start}-{end}/{oi.size}"
            return web.Response(status=206, body=body, headers=headers)
        return web.Response(status=200, body=body, headers=headers)

    async def restore_object(self, request, bucket: str, key: str, body: bytes) -> web.Response:
        """POST /bucket/key?restore — bring a transitioned object's data
        back locally for N days (reference RestoreObjectHandler)."""
        from ..ilm import tier as tiermod

        key = listing.encode_dir_object(key)
        days = 1
        if body:
            try:
                root = ET.fromstring(body)
                for el in root.iter():
                    if el.tag.split("}")[-1] == "Days" and el.text:
                        days = max(1, int(el.text))
            except ET.ParseError:
                raise s3err.MalformedXML from None
        oi = await self._run(self.store.get_object_info, bucket, key)
        if not tiermod.is_transitioned(oi.user_defined):
            raise s3err.InvalidObjectState
        if _restored_locally(oi):
            return web.Response(status=200)  # already restored
        tname = oi.user_defined.get(tiermod.TRANSITION_TIER_META, "")
        rkey = oi.user_defined.get(tiermod.TRANSITION_KEY_META, "")
        t = self.tiers.get(tname)
        if t is None:
            raise s3err.InternalError

        def pull_and_restore():
            from ..qos.context import background_context

            # QoS: a restore re-encodes the whole object from the warm
            # tier (202 Accepted semantics) — its stripe blocks ride the
            # TPU dispatcher's background lane, not the foreground window
            with background_context():
                r = t.client().get_object(t.bucket, rkey)
                if r.status != 200:
                    raise RuntimeError(f"tier read failed: HTTP {r.status}")
                self.store.restore_object(bucket, key, r.body, days)

        await self._run(pull_and_restore)
        return web.Response(status=202)

    def _obj_headers(self, oi: ObjectInfo) -> dict[str, str]:
        from ..crypto import sse as ssemod

        h = {
            "ETag": f'"{oi.etag}"',
            "Last-Modified": _http_date(oi.mod_time),
            "Accept-Ranges": "bytes",
            "Content-Type": oi.content_type or "application/octet-stream",
        }
        if oi.version_id:
            h["x-amz-version-id"] = oi.version_id
        for k, v in oi.user_defined.items():
            if k.startswith("x-amz-meta-") or k in ("cache-control", "content-disposition", "content-encoding", "content-language", "expires"):
                h[k] = v
        from ..utils import checksum as _cks

        for calgo in _cks.ALGOS:
            v = oi.user_defined.get(f"{_cks.META_PREFIX}{calgo}")
            if v:
                h[f"x-amz-checksum-{calgo}"] = v
        raw_tags = oi.user_defined.get(self.TAGS_META)
        if raw_tags:
            h["x-amz-tagging-count"] = str(
                len(urllib.parse.parse_qsl(raw_tags, keep_blank_values=True))
            )
        from ..ilm import tier as tiermod

        tname = oi.user_defined.get(tiermod.TRANSITION_TIER_META)
        if tname:
            h["x-amz-storage-class"] = tname
            if _restored_locally(oi):
                exp = float(oi.user_defined[tiermod.RESTORE_EXPIRY_META])
                h["x-amz-restore"] = (
                    'ongoing-request="false", expiry-date="'
                    + _http_date(int(exp * 1e9)) + '"'
                )
        algo = oi.user_defined.get(ssemod.META_ALGO)
        if algo == "SSE-S3":
            h["x-amz-server-side-encryption"] = "AES256"
        elif algo == "SSE-KMS":
            h["x-amz-server-side-encryption"] = "aws:kms"
            h["x-amz-server-side-encryption-aws-kms-key-id"] = oi.user_defined.get(
                ssemod.META_KMS_KEY_ID, ""
            )
        elif algo == "SSE-C":
            h["x-amz-server-side-encryption-customer-algorithm"] = "AES256"
            h["x-amz-server-side-encryption-customer-key-MD5"] = oi.user_defined.get(
                ssemod.META_SSEC_KEY_MD5, ""
            )
        return h

    @staticmethod
    def _eval_preconditions(headers, oi: ObjectInfo, prefix: str, none_match_err) -> None:
        """Shared If-Match/If-None-Match/If-(Un)Modified-Since evaluation.
        Header precedence follows RFC 7232 (and AWS's documented copy
        combinations): an If-Match that evaluates TRUE suppresses
        If-Unmodified-Since, and a present If-None-Match suppresses
        If-Modified-Since. GET/HEAD use the bare names with 304 on the
        None-Match side; CopyObject/UploadPartCopy use the
        x-amz-copy-source-if-* set where every failure is 412
        (cmd/object-handlers.go checkCopyObjectPreconditions)."""
        etag = f'"{oi.etag}"'
        im = headers.get(f"{prefix}If-Match")
        if im:
            if im.strip() not in (etag, "*", oi.etag):
                raise s3err.PreconditionFailed
        else:
            ius = headers.get(f"{prefix}If-Unmodified-Since")
            if ius:
                try:
                    t = parsedate_to_datetime(ius)
                    if oi.mod_time / 1e9 > t.timestamp():
                        raise s3err.PreconditionFailed
                except (ValueError, TypeError):
                    pass
        inm = headers.get(f"{prefix}If-None-Match")
        if inm:
            if inm.strip() in (etag, "*", oi.etag):
                raise none_match_err
        else:
            ims = headers.get(f"{prefix}If-Modified-Since")
            if ims:
                try:
                    t = parsedate_to_datetime(ims)
                    if oi.mod_time / 1e9 <= t.timestamp():
                        raise none_match_err
                except (ValueError, TypeError):
                    pass

    def _check_preconditions(self, request, oi: ObjectInfo) -> None:
        self._eval_preconditions(request.headers, oi, "", s3err.NotModified)

    @staticmethod
    def _incoming_size(request, body: bytes | None) -> int:
        """Logical size of an incoming write for quota purposes: buffered
        body length, else the decoded payload length for aws-chunked
        streams (the wire Content-Length includes chunk framing), else
        Content-Length."""
        if body is not None:
            return len(body)
        dec = request.headers.get("x-amz-decoded-content-length")
        if dec:
            try:
                return int(dec)
            except ValueError:
                pass
        try:
            return int(request.headers.get("Content-Length", "0") or 0)
        except ValueError:
            return 0

    def _enforce_quota(self, bucket: str, size: int) -> None:
        """Hard bucket quota on the write path (reference
        cmd/bucket-quota.go:103-139 enforceBucketQuotaHard): the incoming
        size plus the scanner-accounted bucket usage must stay under the
        configured quota. Usage freshness matches the reference: the data
        scanner's last crawl."""
        if size < 0:
            return
        q = int(self.buckets.get(bucket).quota or 0)
        if q <= 0:
            return
        if size >= q:
            raise s3err.AdminBucketQuotaExceeded
        bg = getattr(self, "background", None)
        usage = bg.usage.buckets.get(bucket) if bg is not None else None
        if usage and usage.get("size", 0) > 0 and usage["size"] + size >= q:
            raise s3err.AdminBucketQuotaExceeded

    @staticmethod
    def _put_precond(request):
        """Conditional writes (reference checkPreconditionsPUT,
        cmd/object-handlers.go:2017): If-None-Match: * fails when the key
        exists; If-Match: <etag> fails unless the CURRENT etag matches.
        Runs under the namespace write lock inside the erasure layer."""
        inm = request.headers.get("If-None-Match", "").strip()
        im = request.headers.get("If-Match", "").strip()
        if not inm and not im:
            return None

        def check(cur) -> None:
            if inm and cur is not None and (
                inm == "*" or inm in (f'"{cur.etag}"', cur.etag)
            ):
                raise s3err.PreconditionFailed
            if im:
                if cur is None or im not in ("*", f'"{cur.etag}"', cur.etag):
                    raise s3err.PreconditionFailed

        return check

    async def put_object(
        self, request, bucket: str, key: str, body: bytes | None
    ) -> web.Response:
        key = listing.encode_dir_object(key)
        bm = self.buckets.get(bucket)
        precond = self._put_precond(request)
        self._enforce_quota(bucket, self._incoming_size(request, body))
        # overwriting an unversioned transitioned object orphans its warm-
        # tier data unless swept (reference enforces this via objSweeper)
        sweep_ud = None if bm.versioning else await self._run(
            self._tier_sweep_snapshot, bucket, key, ""
        )
        from . import transforms

        ct = request.headers.get("Content-Type")
        if body is None and (
            _bucket_sse_algo(bm.encryption) or transforms.compression_enabled()
        ):
            # a transform needs the whole payload: fall back to buffering
            # (the body is still unread on the socket)
            body = await request.read() if request.body_exists else b""
            if request.headers.get("x-amz-content-sha256") == \
                    signature.STREAMING_UNSIGNED_TRAILER:
                # the wire body is aws-chunked: decode + verify trailers
                # before transforming, or the framing would be stored
                body = self._decode_trailer_body(request, body)
        md5_hdr = request.headers.get("Content-MD5")
        if md5_hdr:
            import base64

            if base64.b64encode(hashlib.md5(body).digest()).decode() != md5_hdr:
                raise s3err.BadDigest
        checksum_meta = _verify_checksum_headers(request.headers, body or b"")
        # trailers verified during buffered aws-chunked decode persist too
        checksum_meta.update(request.get("trailer_checksum_meta") or {})
        user_defined = {}
        if ct:
            user_defined["content-type"] = ct
        for k, v in request.headers.items():
            lk = k.lower()
            if lk.startswith("x-amz-meta-") or lk in (
                "cache-control", "content-disposition", "content-encoding",
                "content-language", "expires", "x-amz-storage-class",
            ):
                user_defined[lk] = v
        if request.headers.get("x-amz-tagging"):
            # tag set supplied at PUT time (reference PutObjectHandler
            # parses x-amz-tagging into the version's tag metadata)
            user_defined[self.TAGS_META] = self._tagging_header_meta(
                request.headers["x-amz-tagging"]
            )
        if body is None:
            # streaming path: body flows HTTP -> erasure encode -> drives
            user_defined.update(checksum_meta)
            sc_parity = self._parity_for_storage_class(request)
            sc_family = self._family_for_storage_class(request)
            oi = await self._run_streaming_put(
                request,
                lambda rd: self.store.put_object(
                    bucket, key, rd, user_defined, None, bm.versioning,
                    parity=sc_parity, check_precond=precond,
                    family=sc_family,
                ),
            )
            headers = {"ETag": f'"{oi.etag}"'}
            tr = request.get("trailer_checksum_meta")
            if tr:
                # verified trailer checksum: persist + echo (reference
                # internal/hash checksum trailers)
                await self._run(
                    self.store.update_object_metadata, bucket, key,
                    oi.version_id, lambda md: md.update(tr),
                )
                for mk, mv in tr.items():
                    headers[mk.replace("x-minio-internal-", "x-amz-")] = mv
            if oi.version_id:
                headers["x-amz-version-id"] = oi.version_id
            from ..events import notify as ev

            self.notifier.notify(
                ev.OBJECT_CREATED_PUT, bucket, listing.decode_dir_object(key),
                oi.size, oi.etag, oi.version_id, request.get("access_key", ""),
            )
            self._queue_repl(request, bucket, key, oi.version_id, "put")
            await self._tier_sweep(sweep_ud)
            return web.Response(status=200, headers=headers)
        # transparent compression + server-side encryption
        req_headers = {k.lower(): v for k, v in request.headers.items()}
        try:
            tr = transforms.encode_for_store(
                body, key, ct or "", req_headers,
                _bucket_sse_algo(bm.encryption), self.kms, bucket,
            )
        except Exception as e:
            from ..crypto.sse import CryptoError

            if isinstance(e, CryptoError):
                raise s3err.InvalidArgument from None
            raise
        if tr.metadata:
            user_defined.update(tr.metadata)
            body = tr.data
        user_defined.update(checksum_meta)
        oi = await self._run(
            lambda: self.store.put_object(
                bucket, key, body, user_defined, None, bm.versioning,
                parity=self._parity_for_storage_class(request),
                check_precond=precond,
                family=self._family_for_storage_class(request),
            )
        )
        headers = {"ETag": f'"{oi.etag}"'}
        headers.update(tr.response_headers)
        for k, v in checksum_meta.items():
            headers[k.replace("x-minio-internal-", "x-amz-")] = v
        if oi.version_id:
            headers["x-amz-version-id"] = oi.version_id
        from ..events import notify as ev

        self.notifier.notify(
            ev.OBJECT_CREATED_PUT, bucket, listing.decode_dir_object(key),
            oi.size, oi.etag, oi.version_id, request.get("access_key", ""),
        )
        self._queue_repl(request, bucket, key, oi.version_id, "put")
        await self._tier_sweep(sweep_ud)
        return web.Response(status=200, headers=headers)

    def _tier_sweep_snapshot(self, bucket: str, key: str, vid: str) -> dict | None:
        """Pre-delete/overwrite snapshot of a transitioned version's tier
        pointers (reference cmd/tier-sweeper.go newObjSweeper +
        SetTransitionState): returns the metadata needed to sweep the
        warm tier after the local version goes away, or None.

        vid == "" means the NULL version (what an unversioned/suspended
        write or delete actually replaces) — NOT the latest: on a
        versioning-suspended bucket the latest may be a surviving named
        version whose warm data must not be swept."""
        from ..ilm import tier as tiermod

        if not self.tiers.list():
            return None  # no tiers configured: nothing to sweep, zero cost
        try:
            if vid:
                oi = self.store.get_object_info(bucket, key, vid)
            else:
                oi = next(
                    (v for v in self.store.list_object_versions(bucket, key)
                     if not v.version_id),
                    None,
                )
                if oi is None:
                    return None  # no null version to replace
        except Exception:  # noqa: BLE001 — no prior version
            return None
        if getattr(oi, "delete_marker", False) or not tiermod.is_transitioned(
            oi.user_defined
        ):
            return None
        return dict(oi.user_defined)

    async def _tier_sweep(self, sweep_ud: dict | None) -> None:
        """Fire-and-forget: the remote delete (5s timeouts when the tier is
        down) must not hold up the S3 response; failures land in the
        persisted journal the scanner retries (the reference routes all
        sweeps through its async tier journal for the same reason)."""
        if sweep_ud:
            from ..ilm import tier as tiermod

            asyncio.get_running_loop().run_in_executor(
                self._io_pool, tiermod.sweep_remote, self.tiers, sweep_ud
            )

    def _parse_copy_source(self, request, access_key: str) -> tuple[str, str, str]:
        """Parse x-amz-copy-source and AUTHORIZE the read on it — the
        destination PutObject grant must not leak other buckets (or IAM
        records under .minio.sys) through the copy path."""
        src = urllib.parse.unquote(request.headers["x-amz-copy-source"])
        if src.startswith("/"):
            src = src[1:]
        src_vid = ""
        if "?versionId=" in src:
            src, src_vid = src.split("?versionId=", 1)
        if "/" not in src:
            raise s3err.InvalidArgument
        src_bucket, src_key = src.split("/", 1)
        if src_bucket.startswith(".minio.sys") or not src_key:
            raise s3err.AccessDenied
        src_key = listing.encode_dir_object(src_key)
        action = "s3:GetObjectVersion" if src_vid else "s3:GetObject"
        self._authorize(access_key, action, src_bucket, src_key)
        return src_bucket, src_key, src_vid

    def _check_copy_preconditions(self, request, oi: ObjectInfo) -> None:
        self._eval_preconditions(
            request.headers, oi, "x-amz-copy-source-", s3err.PreconditionFailed
        )

    async def copy_object(self, request, bucket: str, key: str) -> web.Response:
        from ..crypto.sse import CryptoError
        from . import transforms

        src_bucket, src_key, src_vid = self._parse_copy_source(
            request, request.get("access_key", "")
        )
        oi, handle = await self._run(
            self.store.open_object, src_bucket, src_key, src_vid
        )
        from .transforms import logical_size as _logical

        try:
            # pre-read failures (412, quota) must release the source
            # namespace read lock immediately, not wait out the lock TTL
            self._check_copy_preconditions(request, oi)
            self._enforce_quota(bucket, _logical(oi.user_defined, oi.size))
            data = await self._run(lambda: b"".join(handle.read(0, -1)))
        finally:
            handle.close()
        req_headers = {k.lower(): v for k, v in request.headers.items()}
        # decode the SOURCE pipeline: sealed keys are bound to the source
        # bucket/key context and must never be copied verbatim
        if transforms.is_transformed(oi.user_defined):
            src_headers = dict(req_headers)
            # SSE-C sources present their key under the copy-source header set
            from ..crypto import sse as ssemod

            for h in ("algorithm", "key", "key-md5"):
                v = req_headers.get(
                    f"x-amz-copy-source-server-side-encryption-customer-{h}"
                )
                if v:
                    src_headers[
                        f"x-amz-server-side-encryption-customer-{h}"
                    ] = v
            try:
                data = await self._run(
                    transforms.decode_full, data, oi.user_defined, src_headers,
                    src_bucket, src_key, self.kms,
                )
            except CryptoError:
                raise s3err.AccessDenied from None
        directive = request.headers.get("x-amz-metadata-directive", "COPY")
        # copying an object onto itself without changing anything is an
        # error (reference cmd/object-handlers.go isTargetSameAsSource):
        # REPLACE directives, new SSE attributes, or a storage-class change
        # make it a legal metadata update
        if (
            src_bucket == bucket
            and src_key == listing.encode_dir_object(key)
            and not src_vid
            and directive != "REPLACE"
            and request.headers.get("x-amz-tagging-directive", "COPY") != "REPLACE"
            and not request.headers.get("x-amz-server-side-encryption")
            and not request.headers.get(
                "x-amz-server-side-encryption-customer-algorithm"
            )
            and not request.headers.get("x-amz-storage-class")
        ):
            raise s3err.InvalidCopyDest
        user_defined = {
            k: v for k, v in oi.user_defined.items()
            if not k.startswith("x-minio-internal-")
        }
        user_defined["content-type"] = oi.content_type
        if directive == "REPLACE":
            user_defined = {
                k.lower(): v
                for k, v in request.headers.items()
                if k.lower().startswith("x-amz-meta-")
            }
            if request.headers.get("Content-Type"):
                user_defined["content-type"] = request.headers["Content-Type"]
        # tag set travels by its OWN directive, independent of metadata
        # (reference: x-amz-tagging-directive on CopyObject)
        if request.headers.get("x-amz-tagging-directive", "COPY") == "REPLACE":
            user_defined.pop(self.TAGS_META, None)
            if request.headers.get("x-amz-tagging"):
                user_defined[self.TAGS_META] = self._tagging_header_meta(
                    request.headers["x-amz-tagging"]
                )
        elif oi.user_defined.get(self.TAGS_META):
            user_defined[self.TAGS_META] = oi.user_defined[self.TAGS_META]
        bm = self.buckets.get(bucket)
        # re-encode for the destination (its SSE headers / bucket default)
        try:
            tr = transforms.encode_for_store(
                data, key, user_defined.get("content-type", ""), req_headers,
                _bucket_sse_algo(bm.encryption), self.kms, bucket,
            )
        except CryptoError:
            raise s3err.InvalidArgument from None
        if tr.metadata:
            user_defined.update(tr.metadata)
            data = tr.data
        new_oi = await self._run(
            self.store.put_object,
            bucket,
            listing.encode_dir_object(key),
            data,
            user_defined,
            None,
            bm.versioning,
        )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f'<CopyObjectResult><ETag>"{new_oi.etag}"</ETag>'
            f"<LastModified>{_iso8601(new_oi.mod_time)}</LastModified></CopyObjectResult>"
        )
        headers = {}
        if new_oi.version_id:
            headers["x-amz-version-id"] = new_oi.version_id
        from ..events import notify as ev

        self.notifier.notify(
            ev.OBJECT_CREATED_COPY, bucket, listing.decode_dir_object(key),
            new_oi.size, new_oi.etag, new_oi.version_id,
        )
        self._queue_repl(request, 
            bucket, listing.encode_dir_object(key), new_oi.version_id, "put"
        )
        return web.Response(body=xml.encode(), content_type="application/xml", headers=headers)

    @staticmethod
    def _range_hint(request):
        """Syntactic parse of the Range header — no object size needed,
        so it can run BEFORE any metadata read: the cache's range-segment
        tier resolves it against the cached FileInfo and a full-coverage
        hit skips open_object's lock + fan-out entirely. Anything
        unusual (multi-range, malformed) -> None, the real path decides."""
        rng = request.headers.get("Range")
        if not rng or not rng.startswith("bytes="):
            return None
        spec = rng[len("bytes=") :]
        if "," in spec:
            return None
        start_s, _, end_s = spec.partition("-")
        try:
            if start_s == "":
                return ("suffix", int(end_s))
            return ("abs", int(start_s), int(end_s) if end_s else None)
        except ValueError:
            return None

    def _parse_range(self, request, size: int) -> tuple[int, int] | None:
        rng = request.headers.get("Range")
        if not rng or not rng.startswith("bytes="):
            return None
        request["_range_object_size"] = size  # for the 416 Content-Range
        spec = rng[len("bytes=") :]
        if "," in spec:
            raise s3err.NotImplemented_
        start_s, _, end_s = spec.partition("-")
        try:
            if start_s == "":
                n = int(end_s)
                if n == 0:
                    raise s3err.InvalidRange
                start = max(size - n, 0)
                end = size - 1
            else:
                start = int(start_s)
                end = int(end_s) if end_s else size - 1
        except ValueError:
            return None  # malformed range is ignored per RFC
        if start >= size or start > end:
            raise s3err.InvalidRange
        return start, min(end, size - 1)

    async def get_object(self, request, bucket: str, key: str) -> web.StreamResponse:
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        if vid == "null":
            vid = ""
        try:
            oi, handle = await self._run(
                self.store.open_object, bucket, key, vid,
                self._range_hint(request),
            )
        except (quorum.ObjectNotFound, quorum.VersionNotFound):
            # not (yet) here: replication lag in an active-active pair —
            # proxy the read to a remote target rather than 404ing
            # (reference cmd/bucket-replication.go:2334 proxyGetToReplicationTarget)
            resp = await self._proxy_get_remote(request, bucket, key, vid)
            if resp is not None:
                return resp
            raise
        from ..ilm import tier as tiermod
        from . import transforms

        if tiermod.is_transitioned(oi.user_defined) and not _restored_locally(oi):
            handle.close()
            return await self._get_from_tier(request, bucket, key, oi)
        if transforms.is_transformed(oi.user_defined):
            return await self._get_transformed(request, bucket, key, oi, handle)
        try:
            self._check_preconditions(request, oi)
            rng = self._parse_range(request, oi.size) if oi.size else None
            headers = self._obj_headers(oi)
            if rng:
                start, end = rng
                it = handle.read(start, end - start + 1)
                headers["Content-Range"] = f"bytes {start}-{end}/{oi.size}"
                resp = web.StreamResponse(status=206, headers=headers)
                resp.content_length = end - start + 1
            else:
                it = handle.read()
                resp = web.StreamResponse(status=200, headers=headers)
                resp.content_length = oi.size
        except BaseException:
            handle.close()  # preconditions/range failures must not leak the rlock
            raise
        await resp.prepare(request)
        loop = asyncio.get_running_loop()
        sentinel = object()
        nxt = lambda: next(it, sentinel)  # noqa: E731
        # bytes metered at write time: a client that disconnects mid-stream
        # must be traced/audited with what actually left, not content_length
        request["_tx"] = 0
        try:
            while True:
                chunk = await loop.run_in_executor(self._io_pool, nxt)
                if chunk is sentinel:
                    break
                await resp.write(chunk)
                request["_tx"] += len(chunk)
        finally:
            handle.close()  # release the namespace read lock promptly
        await resp.write_eof()
        return resp

    async def get_object_attributes(self, request, bucket, key) -> web.Response:
        """GetObjectAttributes (reference cmd/object-handlers.go:988):
        ETag/Checksum/ObjectParts/StorageClass/ObjectSize, filtered by the
        x-amz-object-attributes header."""
        import json as _json

        from ..utils import checksum as _cks

        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        if vid == "null":
            vid = ""
        want = {
            a.strip() for a in
            request.headers.get("x-amz-object-attributes", "").split(",") if a.strip()
        }
        if not want:
            raise s3err.InvalidArgument
        try:
            oi = await self._run(self.store.get_object_info, bucket, key, vid)
        except (quorum.ObjectNotFound, quorum.VersionNotFound):
            raise s3err.NoSuchKey from None
        if oi.delete_marker:
            raise s3err.NoSuchKey
        self._check_preconditions(request, oi)
        from . import transforms
        from ..ilm import tier as tiermod

        parts_xml = ""
        if "ObjectParts" in want:
            stored = oi.user_defined.get(_cks.PART_CHECKSUMS_META)
            per_part = _json.loads(stored) if stored else {}
            if "-" in oi.etag:  # multipart object
                try:
                    max_parts = int(
                        request.rel_url.query.get("max-parts", "1000") or 1000
                    )
                    marker = int(
                        request.rel_url.query.get("part-number-marker", "0") or 0
                    )
                except ValueError:
                    raise s3err.InvalidArgument from None
                nparts = int(oi.etag.rsplit("-", 1)[-1])
                body_parts = []
                emitted = 0
                for pn in range(1, nparts + 1):
                    if pn <= marker:
                        continue
                    if emitted >= max_parts:
                        break
                    cx = "".join(
                        f"<Checksum{a.upper()}>{escape(v)}</Checksum{a.upper()}>"
                        for a, v in per_part.get(str(pn), {}).items()
                    )
                    body_parts.append(f"<Part><PartNumber>{pn}</PartNumber>{cx}</Part>")
                    emitted += 1
                parts_xml = (
                    f"<ObjectParts><TotalPartsCount>{nparts}</TotalPartsCount>"
                    f"<PartNumberMarker>{marker}</PartNumberMarker>"
                    f"<MaxParts>{max_parts}</MaxParts>"
                    f"<IsTruncated>{'true' if marker + emitted < nparts else 'false'}"
                    f"</IsTruncated>" + "".join(body_parts) + "</ObjectParts>"
                )
        cks_xml = ""
        if "Checksum" in want:
            fields = []
            for algo in _cks.ALGOS:
                v = oi.user_defined.get(f"{_cks.META_PREFIX}{algo}")
                if v:
                    tag = "Checksum" + algo.upper()
                    fields.append(f"<{tag}>{escape(v)}</{tag}>")
            if fields:
                cks_xml = "<Checksum>" + "".join(fields) + "</Checksum>"
        etag_xml = f"<ETag>{escape(oi.etag)}</ETag>" if "ETag" in want else ""
        size_xml = (
            f"<ObjectSize>{transforms.logical_size(oi.user_defined, oi.size)}"
            "</ObjectSize>" if "ObjectSize" in want else ""
        )
        sc = oi.user_defined.get(tiermod.TRANSITION_TIER_META) or \
            oi.user_defined.get("x-amz-storage-class", "STANDARD")
        sc_xml = (
            f"<StorageClass>{escape(sc)}</StorageClass>"
            if "StorageClass" in want else ""
        )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<GetObjectAttributesResponse xmlns='
            '"http://s3.amazonaws.com/doc/2006-03-01/">'
            + etag_xml + cks_xml + parts_xml + sc_xml + size_xml
            + "</GetObjectAttributesResponse>"
        )
        headers = {"Last-Modified": _http_date(oi.mod_time)}
        if oi.version_id:
            headers["x-amz-version-id"] = oi.version_id
        return web.Response(
            body=xml.encode(), content_type="application/xml", headers=headers
        )

    async def _get_transformed(self, request, bucket, key, oi, handle) -> web.Response:
        """GET for compressed/encrypted objects: decode through the
        transform pipeline (ranges map to packets for SSE-only)."""
        from ..crypto.sse import CryptoError
        from . import transforms

        try:
            self._check_preconditions(request, oi)
            logical = transforms.logical_size(oi.user_defined, oi.size)
            rng = self._parse_range(request, logical) if logical else None
            req_headers = {k.lower(): v for k, v in request.headers.items()}

            def read_fn(off, ln):
                # multiple per-part range reads over ONE handle: the outer
                # finally owns the close, each read must keep the lock
                return b"".join(handle.read(off, ln, close_when_done=False))

            def decode():
                if rng:
                    start, end = rng
                    return transforms.decode_range(
                        read_fn, oi.size, oi.user_defined, req_headers,
                        bucket, key, self.kms, start, end - start + 1,
                    )
                return transforms.decode_full(
                    read_fn(0, oi.size), oi.user_defined, req_headers,
                    bucket, key, self.kms,
                )

            try:
                data = await self._run(decode)
            except CryptoError:
                raise s3err.AccessDenied from None
            headers = self._obj_headers(oi)
            if rng:
                start, end = rng
                headers["Content-Range"] = f"bytes {start}-{end}/{logical}"
                return web.Response(status=206, headers=headers, body=data)
            return web.Response(status=200, headers=headers, body=data)
        finally:
            handle.close()

    async def head_object(self, request, bucket: str, key: str) -> web.Response:
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        if vid == "null":
            vid = ""
        oi = await self._run(self.store.get_object_info, bucket, key, vid)
        if oi.delete_marker:
            return web.Response(status=405, headers={"x-amz-delete-marker": "true"})
        self._check_preconditions(request, oi)
        from . import transforms

        headers = self._obj_headers(oi)
        headers["Content-Length"] = str(transforms.logical_size(oi.user_defined, oi.size))
        return web.Response(status=200, headers=headers)

    async def delete_object(self, request, bucket: str, key: str) -> web.Response:
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        if vid == "null":
            vid = ""
        bm = self.buckets.get(bucket)
        headers = {}
        await self._run(
            self._check_object_lock, bucket, key, vid,
            # the IAM resource must use the CLIENT's key form, matching the
            # raw key the multi-delete path passes
            self._bypass_governance(
                request, bucket, listing.decode_dir_object(key)
            ),
        )
        # deleting a version (or the sole unversioned copy) of a
        # transitioned object must sweep its warm-tier data (tier GC)
        sweep_ud = None
        if vid or not bm.versioning:
            sweep_ud = await self._run(self._tier_sweep_snapshot, bucket, key, vid)
        try:
            oi = await self._run(
                self.store.delete_object, bucket, key, vid, bm.versioning
            )
            if not oi.delete_marker:
                await self._tier_sweep(sweep_ud)
            if oi.delete_marker:
                headers["x-amz-delete-marker"] = "true"
            if oi.version_id:
                headers["x-amz-version-id"] = oi.version_id
            from ..events import notify as ev

            self.notifier.notify(
                ev.OBJECT_REMOVED_MARKER if oi.delete_marker else ev.OBJECT_REMOVED_DELETE,
                bucket, listing.decode_dir_object(key),
                version_id=oi.version_id, user=request.get("access_key", ""),
            )
            if not vid:
                # only logical deletes replicate; removing a SPECIFIC old
                # version must never delete the replica's live object
                self._queue_repl(request, bucket, key, "", "delete")
        except (quorum.ObjectNotFound, quorum.VersionNotFound):
            pass  # S3 deletes are idempotent
        return web.Response(status=204, headers=headers)

    async def delete_multiple(self, request, bucket: str, body: bytes) -> web.Response:
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise s3err.MalformedXML from None
        quiet = False
        targets = []
        for el in root:
            tag = el.tag.split("}")[-1]
            if tag == "Quiet":
                quiet = (el.text or "").lower() == "true"
            elif tag == "Object":
                k, v = "", ""
                for sub in el:
                    stag = sub.tag.split("}")[-1]
                    if stag == "Key":
                        k = sub.text or ""
                    elif stag == "VersionId":
                        v = sub.text or ""
                targets.append((k, v))
        bm = self.buckets.get(bucket)
        ak = request.get("access_key", "")
        results = []
        for k, v in targets[:1000]:
            # per-object authorization: a Deny on a key prefix must hold
            # through multi-delete exactly as through single DELETE
            try:
                self._authorize(
                    ak,
                    "s3:DeleteObjectVersion" if v else "s3:DeleteObject",
                    bucket,
                    k,
                )
            except s3err.APIError:
                results.append((k, v, s3err.AccessDenied, None))
                continue
            try:
                # retention/legal hold protects versions through
                # multi-delete exactly as through single DELETE
                # (including the governance-bypass header)
                await self._run(
                    self._check_object_lock, bucket,
                    listing.encode_dir_object(k), "" if v == "null" else v,
                    self._bypass_governance(request, bucket, k),
                )
                vv = "" if v == "null" else v
                sweep_ud = None
                if vv or not bm.versioning:  # this delete removes data
                    sweep_ud = await self._run(
                        self._tier_sweep_snapshot, bucket,
                        listing.encode_dir_object(k), vv,
                    )
                oi = await self._run(
                    self.store.delete_object,
                    bucket,
                    listing.encode_dir_object(k),
                    vv,
                    bm.versioning,
                )
                if not oi.delete_marker:
                    await self._tier_sweep(sweep_ud)
                results.append((k, v, None, oi))
            except (quorum.ObjectNotFound, quorum.VersionNotFound):
                results.append((k, v, None, None))
            except s3err.APIError as e:
                results.append((k, v, e, None))  # e.g. retention AccessDenied
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                results.append((k, v, s3err.InternalError, None))
        parts = []
        for k, v, err, oi in results:
            if err is None:
                if not quiet:
                    e = f"<Deleted><Key>{escape(k)}</Key>"
                    if v:
                        e += f"<VersionId>{escape(v)}</VersionId>"
                    if oi is not None and oi.delete_marker and oi.version_id:
                        e += f"<DeleteMarker>true</DeleteMarker><DeleteMarkerVersionId>{oi.version_id}</DeleteMarkerVersionId>"
                    parts.append(e + "</Deleted>")
            else:
                parts.append(
                    f"<Error><Key>{escape(k)}</Key><Code>{err.code}</Code>"
                    f"<Message>{escape(err.description)}</Message></Error>"
                )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<DeleteResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"{''.join(parts)}</DeleteResult>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    # -- multipart -------------------------------------------------------------
    async def get_object_lambda(self, request, bucket, key) -> web.Response:
        """Object lambda: transform a GET through a user webhook
        (reference cmd/object-lambda-handlers.go). Targets come from
        MINIO_LAMBDA_WEBHOOK_ENABLE_<ID>/..._ENDPOINT_<ID>."""
        import base64
        import urllib.request as _ur

        arn = request.rel_url.query.get("lambdaArn", "")
        ident = arn.rsplit(":", 2)[-2] if arn.count(":") >= 2 else arn
        endpoint = os.environ.get(f"MINIO_LAMBDA_WEBHOOK_ENDPOINT_{ident.upper()}", "")
        enabled = os.environ.get(
            f"MINIO_LAMBDA_WEBHOOK_ENABLE_{ident.upper()}", ""
        ) in ("on", "true", "1")
        if not endpoint or not enabled:
            raise s3err.InvalidArgument
        key_enc = listing.encode_dir_object(key)
        oi, it = await self._run(self.store.get_object, bucket, key_enc)
        payload = {
            "getObjectContext": {
                "inputS3Url": f"/{bucket}/{key}",
                "bucket": bucket,
                "key": key,
                "content": base64.b64encode(b"".join(it)).decode(),
            },
            "userRequest": {"headers": dict(request.headers)},
        }
        import json as _json

        def call():
            req = _ur.Request(
                endpoint, data=_json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            return _ur.urlopen(req, timeout=30).read()

        try:
            out = await self._run(call)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — lambda endpoint down/unreachable
            raise s3err.InternalError from None
        try:
            body = base64.b64decode(_json.loads(out)["content"])
        except (ValueError, KeyError):
            body = out  # raw transformed bytes are accepted too
        return web.Response(body=body, content_type=oi.content_type)
    def _require_lock_bucket(self, bucket: str) -> None:
        if not self.buckets.get(bucket).object_lock:
            raise s3err.InvalidArgument  # lock config required on bucket

    @staticmethod
    def _parse_retain_until(until: str):
        """Aware datetime or raises MalformedXML (naive/garbage dates must
        never be stored: they'd poison every later delete)."""
        import datetime as _dt

        try:
            t = _dt.datetime.fromisoformat(until.replace("Z", "+00:00"))
        except ValueError:
            raise s3err.MalformedXML from None
        if t.tzinfo is None:
            raise s3err.MalformedXML
        return t

    async def put_object_retention(self, request, bucket, key, body) -> web.Response:
        import datetime as _dt

        self._require_lock_bucket(bucket)
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        try:
            root = ET.fromstring(body)
            mode = until = ""
            for el in root.iter():
                if el.tag.endswith("Mode"):
                    mode = el.text or ""
                elif el.tag.endswith("RetainUntilDate"):
                    until = (el.text or "").strip()
            if mode not in ("GOVERNANCE", "COMPLIANCE") or not until:
                raise s3err.MalformedXML
        except ET.ParseError:
            raise s3err.MalformedXML from None
        new_until = self._parse_retain_until(until)
        # COMPLIANCE retention can never be shortened or weakened
        oi = await self._run(self.store.get_object_info, bucket, key, vid)
        existing = oi.user_defined.get(self.RETENTION_META, "")
        if existing:
            old_mode, old_until_s = existing.split("|", 1)
            try:
                old_until = self._parse_retain_until(old_until_s)
            except s3err.APIError:
                old_until = None
            if (
                old_mode == "COMPLIANCE"
                and old_until is not None
                and _dt.datetime.now(_dt.timezone.utc) < old_until
                and (mode != "COMPLIANCE" or new_until < old_until)
            ):
                raise s3err.AccessDenied
        val = "{}|{}".format(
            mode,
            new_until.astimezone(_dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ"),
        )
        await self._run(
            self.store.update_object_metadata, bucket, key, vid,
            lambda md: md.__setitem__(self.RETENTION_META, val),
        )
        return web.Response(status=200)

    async def get_object_retention(self, request, bucket, key) -> web.Response:
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        oi = await self._run(self.store.get_object_info, bucket, key, vid)
        raw = oi.user_defined.get(self.RETENTION_META, "")
        if not raw:
            raise s3err.ObjectLockConfigurationNotFoundError
        mode, until = raw.split("|", 1)
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f"<Retention><Mode>{escape(mode)}</Mode>"
            f"<RetainUntilDate>{escape(until)}</RetainUntilDate></Retention>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def put_legal_hold(self, request, bucket, key, body) -> web.Response:
        self._require_lock_bucket(bucket)
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        try:
            root = ET.fromstring(body)
            status = ""
            for el in root.iter():
                if el.tag.endswith("Status"):
                    status = (el.text or "").strip()
        except ET.ParseError:
            raise s3err.MalformedXML from None
        if status not in ("ON", "OFF"):
            # malformed input must never silently CLEAR an active hold
            raise s3err.MalformedXML
        await self._run(
            self.store.update_object_metadata, bucket, key, vid,
            lambda md: md.__setitem__(self.LEGALHOLD_META, status),
        )
        return web.Response(status=200)

    async def get_legal_hold(self, request, bucket, key) -> web.Response:
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        oi = await self._run(self.store.get_object_info, bucket, key, vid)
        status = oi.user_defined.get(self.LEGALHOLD_META, "OFF")
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f"<LegalHold><Status>{status}</Status></LegalHold>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    def _check_object_lock(self, bucket: str, key: str, vid: str,
                           bypass_governance: bool = False) -> None:
        """Block data-destroying deletes while retention/legal hold is
        active (reference: enforceRetentionForDeletion). GOVERNANCE
        retention may be bypassed by a caller holding
        s3:BypassGovernanceRetention who sent the bypass header;
        COMPLIANCE and legal hold can never be bypassed."""
        if not vid:
            # on a VERSIONED bucket this only adds a marker; on an
            # unversioned one it destroys the latest version — guard it
            if self.buckets.get(bucket).versioning:
                return
        try:
            oi = self.store.get_object_info(bucket, key, vid)
        except Exception:  # noqa: BLE001 — missing version: nothing to guard
            return
        if oi.user_defined.get(self.LEGALHOLD_META) == "ON":
            raise s3err.AccessDenied
        raw = oi.user_defined.get(self.RETENTION_META, "")
        if raw:
            import datetime as _dt

            mode, until = raw.split("|", 1)
            if mode == "GOVERNANCE" and bypass_governance:
                return
            try:
                t = _dt.datetime.fromisoformat(until.replace("Z", "+00:00"))
            except ValueError:
                raise s3err.AccessDenied from None
            if t.tzinfo is None or _dt.datetime.now(_dt.timezone.utc) < t:
                raise s3err.AccessDenied

    def _bypass_governance(self, request, bucket: str, key: str) -> bool:
        """True iff the caller asked to bypass GOVERNANCE retention and
        holds s3:BypassGovernanceRetention (reference
        cmd/object-handlers.go x-amz-bypass-governance-retention)."""
        if request.headers.get(
            "x-amz-bypass-governance-retention", ""
        ).lower() != "true":
            return False
        ak = request.get("access_key", "")
        if not ak:
            return False
        return self.iam.is_allowed(
            ak, "s3:BypassGovernanceRetention", f"{bucket}/{key}"
        )

    # -- object tagging --------------------------------------------------------

    from ..erasure.set import TAGS_META_KEY as TAGS_META

    @staticmethod
    def _validate_tags(pairs) -> dict[str, str]:
        """Enforce the S3 tag-set rules on (key, value) pairs (reference
        pkg tags.ParseObjectTags): <=10 tags, unique keys, key 1-128
        chars, value <=256 chars."""
        if len(pairs) > 10:
            raise s3err.InvalidTag
        tags: dict[str, str] = {}
        for k, v in pairs:
            if not k or len(k) > 128 or len(v) > 256 or k in tags:
                raise s3err.InvalidTag
            tags[k] = v
        return tags

    @classmethod
    def _tagging_header_meta(cls, header_value: str) -> str:
        """x-amz-tagging header (urlencoded) -> validated stored form."""
        pairs = urllib.parse.parse_qsl(header_value, keep_blank_values=True)
        return urllib.parse.urlencode(cls._validate_tags(pairs))

    async def put_object_tagging(self, request, bucket, key, body) -> web.Response:
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise s3err.MalformedXML from None
        pairs = []
        for el in root.iter():
            if el.tag.endswith("Tag"):
                k = v = ""
                for sub in el:
                    if sub.tag.endswith("Key"):
                        k = sub.text or ""
                    elif sub.tag.endswith("Value"):
                        v = sub.text or ""
                pairs.append((k, v))
        tags = self._validate_tags(pairs)
        await self._run(self.store.set_object_tags, bucket, key, tags, vid)
        return web.Response(status=200)

    async def get_object_tagging(self, request, bucket, key) -> web.Response:
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        tags = await self._run(self.store.get_object_tags, bucket, key, vid)
        items = "".join(
            f"<Tag><Key>{escape(k)}</Key><Value>{escape(v)}</Value></Tag>"
            for k, v in tags.items()
        )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f"<Tagging><TagSet>{items}</TagSet></Tagging>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def delete_object_tagging(self, request, bucket, key) -> web.Response:
        key = listing.encode_dir_object(key)
        vid = request.rel_url.query.get("versionId", "")
        await self._run(self.store.set_object_tags, bucket, key, {}, vid)
        return web.Response(status=204)

    async def select_object_content(self, request, bucket, key, body) -> web.Response:
        """SelectObjectContent: SQL over CSV/JSON objects
        (reference cmd/object-handlers.go:105 + internal/s3select)."""
        from ..s3select import engine
        from . import transforms

        key = listing.encode_dir_object(key)
        oi, handle = await self._run(self.store.open_object, bucket, key, "")
        try:
            req_headers = {k.lower(): v for k, v in request.headers.items()}

            def load() -> bytes:
                raw = b"".join(handle.read())
                if transforms.is_transformed(oi.user_defined):
                    return transforms.decode_full(
                        raw, oi.user_defined, req_headers, bucket, key, self.kms
                    )
                return raw

            data = await self._run(load)
        finally:
            handle.close()
        try:
            stream = await self._run(engine.run_select, body, data)
        except engine.SelectError:
            raise s3err.InvalidArgument from None
        return web.Response(
            body=stream, content_type="application/octet-stream"
        )
