"""Multipart-upload handlers: initiate, upload part, part copy,
complete, abort, list parts, list uploads.

Split from app.py (the reference's cmd/object-multipart-handlers.go)."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

from . import web

from ..erasure import listing
from . import s3err
from .handler_utils import (
    _verify_checksum_headers,
    _bucket_sse_algo,
    _iso8601,
)


class MultipartHandlersMixin:
    async def new_multipart(self, request, bucket, key) -> web.Response:
        from ..crypto.sse import CryptoError
        from . import transforms

        bm = self.buckets.get(bucket)
        key = listing.encode_dir_object(key)
        user_defined = {}
        if request.headers.get("Content-Type"):
            user_defined["content-type"] = request.headers["Content-Type"]
        for k, v in request.headers.items():
            if k.lower().startswith("x-amz-meta-"):
                user_defined[k.lower()] = v
        if request.headers.get("x-amz-tagging"):
            user_defined[self.TAGS_META] = self._tagging_header_meta(
                request.headers["x-amz-tagging"]
            )
        sse_resp: dict[str, str] = {}
        try:
            req_headers = {k.lower(): v for k, v in request.headers.items()}
            sse = transforms.multipart_sse_init(
                req_headers, _bucket_sse_algo(bm.encryption), self.kms,
                bucket, key,
            )
        except CryptoError:
            raise s3err.InvalidArgument from None
        if sse is not None:
            sse_meta, sse_resp = sse
            user_defined.update(sse_meta)
        upload_id = await self._run(
            self.mp.new_upload, bucket, key, user_defined,
            self._parity_for_storage_class(request),
            self._family_for_storage_class(request),
        )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<InitiateMultipartUploadResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId></InitiateMultipartUploadResult>"
        )
        return web.Response(
            body=xml.encode(), content_type="application/xml", headers=sse_resp
        )

    async def put_object_part(self, request, bucket, key, body) -> web.Response:
        from ..erasure import multipart as mp_mod

        key = listing.encode_dir_object(key)
        q = request.rel_url.query
        try:
            part_number = int(q["partNumber"])
        except (KeyError, ValueError):
            raise s3err.InvalidArgument from None
        upload_id = q.get("uploadId", "")
        self._enforce_quota(bucket, self._incoming_size(request, body))
        # SSE-C uploads re-present the customer key on every part; thread
        # the request headers through as the part-transform context
        part_ctx = {k.lower(): v for k, v in request.headers.items()}
        from ..crypto.sse import CryptoError

        try:
            if body is None:
                # streaming part upload (multipart is how huge objects
                # arrive: each part flows straight into its erasure stream)
                etag = await self._run_streaming_put(
                    request,
                    lambda rd: self.mp.put_part(
                        bucket, key, upload_id, part_number, rd,
                        transform_ctx=part_ctx,
                    ),
                )
                tr = request.get("trailer_checksum_meta")
                if tr:
                    await self._run(
                        self.mp.update_part_metadata, bucket, key,
                        upload_id, part_number, tr,
                    )
            else:
                checksum_meta = _verify_checksum_headers(request.headers, body)
                checksum_meta.update(request.get("trailer_checksum_meta") or {})
                etag = await self._run(
                    self.mp.put_part, bucket, key, upload_id, part_number, body,
                    checksum_meta or None, part_ctx,
                )
        except mp_mod.UploadNotFound:
            raise s3err.NoSuchUpload from None
        except mp_mod.InvalidPart:
            raise s3err.InvalidPart from None
        except CryptoError:
            # missing/mismatched SSE-C key on an encrypted upload
            raise s3err.InvalidArgument from None
        headers = {"ETag": f'"{etag}"'}
        for hk in request.headers:
            if hk.lower().startswith("x-amz-checksum-"):
                headers[hk] = request.headers[hk]
        # trailer-mode uploads carry the checksum in the trailer, not a
        # header: echo the VERIFIED value so SDK response validation sees it
        from ..utils import checksum as _cks

        for mk, mv in (request.get("trailer_checksum_meta") or {}).items():
            algo = mk[len(_cks.META_PREFIX):]
            headers.setdefault(f"x-amz-checksum-{algo}", mv)
        return web.Response(status=200, headers=headers)

    async def upload_part_copy(self, request, bucket, key) -> web.Response:
        from ..erasure import multipart as mp_mod

        key = listing.encode_dir_object(key)
        q = request.rel_url.query
        try:
            part_number = int(q["partNumber"])
        except (KeyError, ValueError):
            raise s3err.InvalidArgument from None
        upload_id = q.get("uploadId", "")
        src_bucket, src_key, src_vid = self._parse_copy_source(
            request, request.get("access_key", "")
        )
        oi, handle = await self._run(
            self.store.open_object, src_bucket, src_key, src_vid
        )
        from . import transforms

        try:
            # any pre-read failure (412, quota) must release the source
            # namespace read lock, not wait out the 120s TTL
            self._check_copy_preconditions(request, oi)
            self._enforce_quota(
                bucket, transforms.logical_size(oi.user_defined, oi.size)
            )
            # transformed (SSE/compressed) sources must decode to logical
            # bytes: ranges apply to plaintext, and the destination part
            # re-transforms for its own upload
            logical = transforms.logical_size(oi.user_defined, oi.size)
            offset, length = 0, logical
            crange = request.headers.get("x-amz-copy-source-range", "")
            if crange.startswith("bytes="):
                try:
                    a, _, b = crange[len("bytes=") :].partition("-")
                    offset = int(a)
                    length = int(b) - offset + 1
                except ValueError:
                    raise s3err.InvalidArgument from None
                if offset < 0 or length <= 0 or offset + length > logical:
                    raise s3err.InvalidRange
            if transforms.is_transformed(oi.user_defined):
                req_headers = {k.lower(): v for k, v in request.headers.items()}
                # SSE-C sources present their key under the copy-source
                # header set; remap so the source decode sees it (and not
                # the DESTINATION upload's key riding the same request)
                src_headers = dict(req_headers)
                for _h in ("algorithm", "key", "key-md5"):
                    _v = req_headers.get(
                        "x-amz-copy-source-server-side-encryption-customer-"
                        + _h
                    )
                    src_headers.pop(
                        "x-amz-server-side-encryption-customer-" + _h, None
                    )
                    if _v:
                        src_headers[
                            "x-amz-server-side-encryption-customer-" + _h
                        ] = _v
                req_headers = src_headers

                def read_fn(off, ln):
                    return b"".join(handle.read(off, ln, close_when_done=False))

                from ..crypto.sse import CryptoError as _CryptoError

                try:
                    data = await self._run(
                        transforms.decode_range, read_fn, oi.size,
                        oi.user_defined, req_headers, src_bucket, src_key,
                        self.kms, offset, length,
                    )
                except _CryptoError:
                    # missing/wrong copy-source SSE-C key
                    raise s3err.InvalidArgument from None
            else:
                data = await self._run(
                    lambda: b"".join(handle.read(offset, length))
                )
        finally:
            handle.close()
        from ..crypto.sse import CryptoError

        try:
            # destination SSE-C headers (x-amz-server-side-encryption-
            # customer-*) ride the same request; thread them through so a
            # part copy into an SSE-C upload can seal under the upload key
            etag = await self._run(
                self.mp.put_part, bucket, key, upload_id, part_number, data,
                None, {k.lower(): v for k, v in request.headers.items()},
            )
        except mp_mod.UploadNotFound:
            raise s3err.NoSuchUpload from None
        except CryptoError:
            raise s3err.InvalidArgument from None
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f'<CopyPartResult><ETag>"{etag}"</ETag>'
            f"<LastModified>{_iso8601(oi.mod_time)}</LastModified></CopyPartResult>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def complete_multipart(self, request, bucket, key, body) -> web.Response:
        from ..erasure import multipart as mp_mod

        key = listing.encode_dir_object(key)
        upload_id = request.rel_url.query.get("uploadId", "")
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise s3err.MalformedXML from None
        parts = []
        part_checksums: dict[int, dict[str, str]] = {}
        for el in root:
            if el.tag.split("}")[-1] == "Part":
                n, etag = 0, ""
                cks_vals: dict[str, str] = {}
                for sub in el:
                    t = sub.tag.split("}")[-1]
                    if t == "PartNumber":
                        n = int(sub.text or "0")
                    elif t == "ETag":
                        etag = (sub.text or "").strip()
                    elif t.startswith("Checksum"):
                        cks_vals[t[len("Checksum"):].lower()] = (sub.text or "").strip()
                parts.append((n, etag))
                if cks_vals:
                    part_checksums[n] = cks_vals
        bm = self.buckets.get(bucket)
        try:
            oi = await self._run(
                self.mp.complete, bucket, key, upload_id, parts, bm.versioning,
                part_checksums or None, self._put_precond(request),
            )
        except mp_mod.UploadNotFound:
            raise s3err.NoSuchUpload from None
        except mp_mod.InvalidPartOrder:
            raise s3err.InvalidPartOrder from None
        except mp_mod.InvalidPart:
            raise s3err.InvalidPart from None
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<CompleteMultipartUploadResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<Location>/{escape(bucket)}/{escape(key)}</Location>"
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f'<ETag>"{oi.etag}"</ETag></CompleteMultipartUploadResult>'
        )
        headers = {}
        if oi.version_id:
            headers["x-amz-version-id"] = oi.version_id
        from ..events import notify as ev

        self.notifier.notify(
            ev.OBJECT_CREATED_MULTIPART, bucket, listing.decode_dir_object(key),
            oi.size, oi.etag, oi.version_id, request.get("access_key", ""),
        )
        self._queue_repl(request, bucket, key, oi.version_id, "put")
        return web.Response(body=xml.encode(), content_type="application/xml", headers=headers)

    async def abort_multipart(self, request, bucket, key) -> web.Response:
        from ..erasure import multipart as mp_mod

        key = listing.encode_dir_object(key)
        upload_id = request.rel_url.query.get("uploadId", "")
        try:
            await self._run(self.mp.abort, bucket, key, upload_id)
        except mp_mod.UploadNotFound:
            raise s3err.NoSuchUpload from None
        return web.Response(status=204)

    async def list_parts(self, request, bucket, key) -> web.Response:
        from ..erasure import multipart as mp_mod

        key = listing.encode_dir_object(key)
        q = request.rel_url.query
        upload_id = q.get("uploadId", "")
        try:
            max_parts = int(q.get("max-parts", "1000"))
            marker = int(q.get("part-number-marker", "0"))
        except ValueError:
            raise s3err.InvalidArgument from None
        if max_parts < 0 or marker < 0:
            raise s3err.InvalidArgument
        max_parts = min(max_parts, 1000)
        try:
            parts, truncated = await self._run(
                self.mp.list_parts, bucket, key, upload_id, max_parts, marker
            )
        except mp_mod.UploadNotFound:
            raise s3err.NoSuchUpload from None
        items = "".join(
            f"<Part><PartNumber>{p.number}</PartNumber>"
            f'<ETag>"{p.etag}"</ETag><Size>{p.size}</Size>'
            f"<LastModified>{_iso8601(p.mod_time)}</LastModified></Part>"
            for p in parts
        )
        next_marker = (
            f"<NextPartNumberMarker>{parts[-1].number}</NextPartNumberMarker>"
            if truncated and parts
            else ""
        )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<ListPartsResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<Bucket>{escape(bucket)}</Bucket><Key>{escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId><MaxParts>{max_parts}</MaxParts>"
            f"<PartNumberMarker>{marker}</PartNumberMarker>{next_marker}"
            f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
            f"{items}</ListPartsResult>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")
    async def list_multipart_uploads(self, request, bucket) -> web.Response:
        q = request.rel_url.query
        prefix = q.get("prefix", "")
        key_marker = q.get("key-marker", "")
        uid_marker = q.get("upload-id-marker", "")
        try:
            max_uploads = min(max(int(q.get("max-uploads", "1000")), 0), 1000)
        except ValueError:
            raise s3err.InvalidArgument from None
        if max_uploads == 0:
            # an empty page with no next marker cannot progress: report it
            # as NON-truncated (same discipline as ListParts max-parts=0)
            return web.Response(
                body=(
                    '<?xml version="1.0" encoding="UTF-8"?>'
                    '<ListMultipartUploadsResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                    f"<Bucket>{escape(bucket)}</Bucket><Prefix>{escape(prefix)}</Prefix>"
                    "<MaxUploads>0</MaxUploads>"
                    "<IsTruncated>false</IsTruncated></ListMultipartUploadsResult>"
                ).encode(),
                content_type="application/xml",
            )
        uploads = sorted(await self._run(self.mp.list_uploads, bucket, prefix))
        if key_marker:
            # marker semantics (cmd/erasure-multipart.go ListMultipartUploads):
            # strictly after (key_marker, uid_marker)
            uploads = [
                (k, u) for k, u in uploads
                if k > key_marker or (k == key_marker and uid_marker and u > uid_marker)
            ]
        page = uploads[:max_uploads]
        truncated = len(uploads) > len(page)
        items = "".join(
            f"<Upload><Key>{escape(k)}</Key><UploadId>{uid}</UploadId></Upload>"
            for k, uid in page
        )
        next_markers = (
            f"<NextKeyMarker>{escape(page[-1][0])}</NextKeyMarker>"
            f"<NextUploadIdMarker>{page[-1][1]}</NextUploadIdMarker>"
            if truncated and page
            else ""
        )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<ListMultipartUploadsResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<Bucket>{escape(bucket)}</Bucket><Prefix>{escape(prefix)}</Prefix>"
            f"<KeyMarker>{escape(key_marker)}</KeyMarker>"
            f"<MaxUploads>{max_uploads}</MaxUploads>{next_markers}"
            f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
            f"{items}</ListMultipartUploadsResult>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")
