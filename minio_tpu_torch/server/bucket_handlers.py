"""Bucket-level S3 handlers: create/delete/head, versioning, location,
sub-resource get/put/delete, ACL, listing (V1/V2/versions), events.

Split from app.py (the reference's cmd/bucket-handlers.go,
bucket-policy-handlers.go, bucket-listobjects-handlers.go)."""

from __future__ import annotations

import hashlib
import urllib.parse
import xml.etree.ElementTree as ET
from xml.sax.saxutils import escape

from . import web

from ..erasure import listing
from . import s3err
from .handler_utils import (
    BUCKET_NAME_RE,
    _iso8601,
)


class BucketHandlersMixin:
    async def list_buckets(self, request) -> web.Response:
        buckets = await self._run(self.store.list_buckets)
        items = "".join(
            f"<Bucket><Name>{escape(b.name)}</Name>"
            f"<CreationDate>{_iso8601(b.created)}</CreationDate></Bucket>"
            for b in buckets
        )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<ListAllMyBucketsResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            "<Owner><ID>minio-tpu</ID><DisplayName>minio-tpu</DisplayName></Owner>"
            f"<Buckets>{items}</Buckets></ListAllMyBucketsResult>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    # -- bucket --------------------------------------------------------------

    async def put_bucket(self, request, bucket: str) -> web.Response:
        if not BUCKET_NAME_RE.match(bucket) or ".." in bucket:
            raise s3err.InvalidBucketName
        if bucket == "minio":
            # reserved (reference isReservedOrInvalidBucket): /minio/* is
            # the control plane, and a user bucket by that name would ride
            # its QoS-exempt routing
            raise s3err.InvalidBucketName
        await self._run(self.store.make_bucket, bucket)
        lock_enabled = request.headers.get("x-amz-bucket-object-lock-enabled", "") == "true"
        if lock_enabled:
            bm = self.buckets.get(bucket)
            bm.versioning = True
            bm.object_lock = "<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled></ObjectLockConfiguration>"
            await self._run(self.buckets.set, bucket, bm)
        if self.site.enabled:
            await self._run(self.site.sync_bucket_create, bucket)
        return web.Response(status=200, headers={"Location": f"/{bucket}"})

    async def head_bucket(self, request, bucket: str) -> web.Response:
        if not await self._run(self.store.bucket_exists, bucket):
            return web.Response(status=404)
        return web.Response(status=200)

    async def delete_bucket(self, request, bucket: str) -> web.Response:
        force = request.headers.get("x-minio-force-delete", "") == "true"
        # refuse non-empty buckets (cheap check: any object at all)
        res = await self._run(
            listing.list_objects, self.store, bucket, "", "", "", 1, True
        )
        if (res.objects or res.prefixes) and not force:
            raise s3err.BucketNotEmpty
        await self._run(self.store.delete_bucket, bucket, force or bool(res.objects))
        self.buckets.drop(bucket)
        if self.site.enabled:
            await self._run(self.site.sync_bucket_delete, bucket)
        return web.Response(status=204)

    async def get_bucket_location(self, request, bucket: str) -> web.Response:
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f'<LocationConstraint xmlns="http://s3.amazonaws.com/doc/2006-03-01/">{self.region}</LocationConstraint>'
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def get_bucket_versioning(self, request, bucket: str) -> web.Response:
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        bm = self.buckets.get(bucket)
        inner = ""
        if bm.versioning:
            inner = "<Status>Enabled</Status>"
        elif bm.versioning_suspended:
            inner = "<Status>Suspended</Status>"
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            f'<VersioningConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">{inner}</VersioningConfiguration>'
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def put_bucket_versioning(self, request, bucket: str, body: bytes) -> web.Response:
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        try:
            root = ET.fromstring(body)
            status = ""
            for el in root.iter():
                if el.tag.endswith("Status"):
                    status = el.text or ""
        except ET.ParseError:
            raise s3err.MalformedXML from None
        bm = self.buckets.get(bucket)
        if bm.object_lock and status != "Enabled":
            # AWS: versioning cannot be suspended on object-lock buckets
            # (retention would otherwise guard nothing)
            raise s3err.InvalidBucketState
        bm.versioning = status == "Enabled"
        bm.versioning_suspended = status == "Suspended"
        await self._run(self.buckets.set, bucket, bm)
        return web.Response(status=200)

    async def get_bucket_simple(self, request, bucket, attr, missing_err) -> web.Response:
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        bm = self.buckets.get(bucket)
        val = getattr(bm, attr)
        if not val:
            if missing_err is None:
                val = '<?xml version="1.0" encoding="UTF-8"?><NotificationConfiguration/>'
            else:
                raise missing_err
        if isinstance(val, dict):
            import json

            return web.Response(body=json.dumps(val).encode(), content_type="application/json")
        return web.Response(body=val.encode() if isinstance(val, str) else val,
                            content_type="application/xml")

    async def listen_events(self, request, bucket: str) -> web.StreamResponse:
        """Real-time event firehose (reference
        cmd/listen-notification-handlers.go)."""
        import asyncio as _asyncio
        import json as _json
        import queue as _queue

        q = request.rel_url.query
        events = [e for e in q.get("events", "").split(",") if e]
        ent = self.notifier.subscribe(
            bucket, q.get("prefix", ""), q.get("suffix", ""), events
        )
        resp = web.StreamResponse(headers={"Content-Type": "application/json"})
        await resp.prepare(request)
        loop = _asyncio.get_running_loop()
        try:
            while True:
                try:
                    rec = await loop.run_in_executor(
                        self._longpoll_pool, ent[0].get, True, 1.0
                    )
                except _queue.Empty:
                    await resp.write(b" \n")  # keep-alive, like the reference
                    continue
                await resp.write(
                    _json.dumps({"Records": [rec]}).encode() + b"\n"
                )
        except (ConnectionResetError, _asyncio.CancelledError):
            pass
        finally:
            self.notifier.unsubscribe(ent)
        return resp

    async def put_bucket_simple(self, request, bucket, attr, body: bytes) -> web.Response:
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        bm = self.buckets.get(bucket)
        if attr == "notification":
            try:
                self.notifier.validate_config(body.decode())
            except ValueError:
                raise s3err.InvalidArgument from None
            except ET.ParseError:
                raise s3err.MalformedXML from None
        if attr == "lifecycle":
            from ..ilm.lifecycle import validate_lifecycle

            try:
                validate_lifecycle(body.decode())
            except (ValueError, ET.ParseError):
                raise s3err.MalformedXML from None
        if attr == "cors":
            from . import cors as corsmod

            try:
                corsmod.parse_bucket_cors(body.decode())
            except (ValueError, ET.ParseError):
                raise s3err.MalformedXML from None
        if attr == "policy":
            import json

            from ..iam.policy import Policy

            try:
                doc = json.loads(body)
                pol = Policy.from_dict(doc)
            except ValueError:
                raise s3err.MalformedXML from None
            except (AttributeError, TypeError):
                # valid JSON but not policy-shaped (e.g. a list or scalar)
                raise s3err.MalformedPolicy from None
            # resource policies must name a Resource per statement — an
            # omitted Resource would otherwise match every object
            # (reference validates this at PutBucketPolicy time)
            if not pol.statements or any(not s.resources for s in pol.statements):
                raise s3err.MalformedPolicy
            setattr(bm, attr, doc)
        else:
            setattr(bm, attr, body.decode())
        await self._run(self.buckets.set, bucket, bm)
        return web.Response(status=200 if attr != "policy" else 204)

    # -- ACL / misc compat surface (reference cmd/acl-handlers.go,
    # bucket-handlers.go requestPayment/logging/policyStatus) ----------------

    def _owner_id(self) -> str:
        # deterministic canonical owner id for this deployment (the
        # reference serves a fixed owner id + "minio" display name)
        return hashlib.sha256(self.root_user.encode()).hexdigest()

    def _owner_xml(self) -> str:
        return (
            f"<Owner><ID>{self._owner_id()}</ID>"
            f"<DisplayName>minio</DisplayName></Owner>"
        )

    async def get_acl(self, request, bucket: str, key: str) -> web.Response:
        """Canned-ACL world: everything is owner FULL_CONTROL (reference
        GetBucketACLHandler / GetObjectACLHandler)."""
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        if key:
            # missing objects must 404, same as a GET
            await self._run(
                self.store.get_object_info, bucket,
                listing.encode_dir_object(key),
                request.rel_url.query.get("versionId", ""),
            )
        owner = self._owner_xml()
        oid = self._owner_id()
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<AccessControlPolicy xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"{owner}<AccessControlList><Grant>"
            '<Grantee xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
            'xsi:type="CanonicalUser">'
            f"<ID>{oid}</ID><DisplayName>minio</DisplayName></Grantee>"
            "<Permission>FULL_CONTROL</Permission></Grant></AccessControlList>"
            "</AccessControlPolicy>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def put_acl(self, request, bucket: str, key: str, body: bytes) -> web.Response:
        """Only the private canned ACL (or an equivalent single
        FULL_CONTROL grant document) is accepted; anything else is
        NotImplemented — bucket policies are the access-control system
        (reference PutBucketACLHandler/PutObjectACLHandler)."""
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        if key:
            # a missing object must 404, matching the GET side
            await self._run(
                self.store.get_object_info, bucket,
                listing.encode_dir_object(key),
                request.rel_url.query.get("versionId", ""),
            )
        canned = request.headers.get("x-amz-acl", "")
        if canned:
            if canned != "private":
                raise s3err.NotImplemented_
            return web.Response(status=200)
        try:
            root = ET.fromstring(body)
        except ET.ParseError:
            raise s3err.MalformedXML from None
        grants = [el for el in root.iter() if el.tag.split("}")[-1] == "Grant"]
        if len(grants) != 1:
            raise s3err.NotImplemented_
        perm = next(
            (el.text for el in grants[0] if el.tag.split("}")[-1] == "Permission"),
            "",
        )
        if perm != "FULL_CONTROL":
            raise s3err.NotImplemented_
        return web.Response(status=200)

    async def get_policy_status(self, request, bucket: str) -> web.Response:
        """Whether anonymous requests are allowed by the bucket policy
        (reference GetBucketPolicyStatusHandler)."""
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        bm = self.buckets.get(bucket)
        public = False
        for st in (bm.policy or {}).get("Statement", []):
            principal = st.get("Principal", "")
            aws = principal.get("AWS", "") if isinstance(principal, dict) else principal
            if isinstance(aws, list):
                aws = "*" if "*" in aws else ""
            if st.get("Effect") == "Allow" and aws == "*":
                public = True
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<PolicyStatus xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<IsPublic>{'true' if public else 'false'}</IsPublic></PolicyStatus>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def get_request_payment(self, request, bucket: str) -> web.Response:
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<RequestPaymentConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            "<Payer>BucketOwner</Payer></RequestPaymentConfiguration>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def put_request_payment(self, request, bucket: str, body: bytes) -> web.Response:
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        if b"Requester" in body:
            raise s3err.NotImplemented_  # only BucketOwner payment exists
        return web.Response(status=200)

    async def get_bucket_logging(self, request, bucket: str) -> web.Response:
        if not await self._run(self.store.bucket_exists, bucket):
            raise s3err.NoSuchBucket
        # access logging rides the audit/notification planes; the S3 call
        # reports it disabled, like the reference
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<BucketLoggingStatus xmlns="http://s3.amazonaws.com/doc/2006-03-01/" />'
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def delete_bucket_simple(self, request, bucket, sub) -> web.Response:
        attr = {"tagging": "tags", "ownershipControls": "ownership"}.get(sub, sub)
        bm = self.buckets.get(bucket)
        setattr(bm, attr, None if attr != "tags" else {})
        await self._run(self.buckets.set, bucket, bm)
        return web.Response(status=204)

    # -- listing ---------------------------------------------------------------

    async def list_objects(self, request, bucket: str) -> web.Response:
        q = request.rel_url.query
        v2 = q.get("list-type") == "2"
        url_encode = q.get("encoding-type") == "url"
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        try:
            max_keys = int(q.get("max-keys", "1000"))
        except ValueError:
            raise s3err.InvalidMaxKeys from None
        if v2:
            marker = q.get("continuation-token", "") or q.get("start-after", "")
        else:
            marker = q.get("marker", "")
        res = await self._run(
            listing.list_objects, self.store, bucket, prefix, marker, delimiter, max_keys
        )
        def enc(s: str) -> str:
            # encoding-type=url: keys percent-encoded so control chars in
            # names survive XML (reference s3EncodeName)
            return urllib.parse.quote(s, safe="/") if url_encode else escape(s)

        contents = "".join(
            f"<Contents><Key>{enc(o.name)}</Key>"
            f"<LastModified>{_iso8601(o.mod_time)}</LastModified>"
            f'<ETag>"{o.etag}"</ETag><Size>{o.size}</Size>'
            f"<StorageClass>STANDARD</StorageClass></Contents>"
            for o in res.objects
        )
        prefixes = "".join(
            f"<CommonPrefixes><Prefix>{enc(p)}</Prefix></CommonPrefixes>"
            for p in res.prefixes
        )
        common = (
            f"<Name>{escape(bucket)}</Name><Prefix>{enc(prefix)}</Prefix>"
            f"<MaxKeys>{max_keys}</MaxKeys>"
            f"<Delimiter>{escape(delimiter)}</Delimiter>"
            + ("<EncodingType>url</EncodingType>" if url_encode else "")
            + f"<IsTruncated>{'true' if res.is_truncated else 'false'}</IsTruncated>"
        )
        if v2:
            extra = f"<KeyCount>{len(res.objects) + len(res.prefixes)}</KeyCount>"
            if res.is_truncated:
                extra += f"<NextContinuationToken>{enc(res.next_marker)}</NextContinuationToken>"
            xml = (
                '<?xml version="1.0" encoding="UTF-8"?>'
                '<ListBucketResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                f"{common}{extra}{contents}{prefixes}</ListBucketResult>"
            )
        else:
            extra = ""
            if res.is_truncated:
                extra = f"<NextMarker>{enc(res.next_marker)}</NextMarker>"
            xml = (
                '<?xml version="1.0" encoding="UTF-8"?>'
                '<ListBucketResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                f"{common}{extra}{contents}{prefixes}</ListBucketResult>"
            )
        return web.Response(body=xml.encode(), content_type="application/xml")

    async def list_object_versions(self, request, bucket: str) -> web.Response:
        q = request.rel_url.query
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", "1000"))
        marker = q.get("key-marker", "")
        vmarker = q.get("version-id-marker", "")
        res = await self._run(
            listing.list_objects,
            self.store,
            bucket,
            prefix,
            marker,
            delimiter,
            max_keys,
            True,
            vmarker,
        )
        body = []
        for o in res.objects:
            vid = o.version_id or "null"
            tag = "DeleteMarker" if o.delete_marker else "Version"
            entry = (
                f"<{tag}><Key>{escape(o.name)}</Key><VersionId>{vid}</VersionId>"
                f"<IsLatest>{'true' if o.is_latest else 'false'}</IsLatest>"
                f"<LastModified>{_iso8601(o.mod_time)}</LastModified>"
            )
            if not o.delete_marker:
                entry += f'<ETag>"{o.etag}"</ETag><Size>{o.size}</Size><StorageClass>STANDARD</StorageClass>'
            entry += f"</{tag}>"
            body.append(entry)
        prefixes = "".join(
            f"<CommonPrefixes><Prefix>{escape(p)}</Prefix></CommonPrefixes>"
            for p in res.prefixes
        )
        xml = (
            '<?xml version="1.0" encoding="UTF-8"?>'
            '<ListVersionsResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<Name>{escape(bucket)}</Name><Prefix>{escape(prefix)}</Prefix>"
            f"<MaxKeys>{max_keys}</MaxKeys>"
            f"<IsTruncated>{'true' if res.is_truncated else 'false'}</IsTruncated>"
            f"{''.join(body)}{prefixes}</ListVersionsResult>"
        )
        return web.Response(body=xml.encode(), content_type="application/xml")

    # -- objects ---------------------------------------------------------------
