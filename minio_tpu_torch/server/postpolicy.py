"""POST-policy form uploads: policy-document validation + signed
browser upload forms (the reference's cmd/postpolicyform.go +
PostPolicyBucketHandler)."""

from __future__ import annotations

import hashlib
from xml.sax.saxutils import escape

from . import web

from ..erasure import listing
from . import s3err, signature
from .handler_utils import (
    _parse_form_data,
    _bucket_sse_algo,
)


class PostPolicyMixin:
    async def post_policy_upload(self, request, bucket: str, body: bytes) -> web.Response:
        """POST object (browser form upload) with V4 POST-policy signature
        (reference cmd/post-policy.go)."""
        import base64
        import hmac as _hmac
        import json as _json

        ctype = request.headers.get("Content-Type", "")
        if "boundary=" not in ctype:
            raise s3err.MalformedXML
        boundary = (
            ctype.split("boundary=", 1)[1].split(";", 1)[0].strip().strip('"').encode()
        )
        fields, file_data = _parse_form_data(body, boundary)
        key = fields.get("key", "")
        if not key:
            raise s3err.InvalidArgument
        if "${filename}" in key:
            key = key.replace("${filename}", fields.get("__filename", "upload"))

        policy_b64 = fields.get("policy", "")
        ak = ""
        if policy_b64:
            cred = fields.get("x-amz-credential", "")
            sig = fields.get("x-amz-signature", "")
            parts = cred.split("/")
            if len(parts) < 5 or parts[-1] != "aws4_request":
                raise s3err.AccessDenied
            ak = "/".join(parts[:-4])
            secret = self.iam.lookup_secret(ak)
            if secret is None:
                raise s3err.InvalidAccessKeyId
            skey = signature.signing_key(secret, parts[-4], parts[-3], parts[-2])
            want = _hmac.new(skey, policy_b64.encode(), hashlib.sha256).hexdigest()
            if not _hmac.compare_digest(want, sig):
                raise s3err.SignatureDoesNotMatch
            try:
                pol = _json.loads(base64.b64decode(policy_b64))
            except ValueError:
                raise s3err.AccessDenied from None
            import datetime as _dt

            exp = pol.get("expiration", "")
            if exp:
                try:
                    t = _dt.datetime.fromisoformat(exp.replace("Z", "+00:00"))
                except ValueError:
                    raise s3err.AccessDenied from None
                if _dt.datetime.now(_dt.timezone.utc) > t:
                    raise s3err.AccessDenied
            for cond in pol.get("conditions", []):
                if isinstance(cond, dict):
                    for ck, cv in cond.items():
                        if ck == "bucket" and cv != bucket:
                            raise s3err.AccessDenied
                        if ck == "key" and cv != key:
                            raise s3err.AccessDenied
                elif isinstance(cond, list) and len(cond) == 3:
                    op, name, val = cond
                    if str(op) == "content-length-range":
                        try:
                            lo, hi = int(name), int(val)
                        except (TypeError, ValueError):
                            raise s3err.AccessDenied from None
                        if not lo <= len(file_data) <= hi:
                            raise s3err.EntityTooLarge
                        continue
                    name = str(name).lstrip("$")
                    have = {"bucket": bucket, "key": key}.get(name, fields.get(name, ""))
                    if op == "eq" and have != val:
                        raise s3err.AccessDenied
                    if op == "starts-with" and not str(have).startswith(str(val)):
                        raise s3err.AccessDenied
        self._authorize(ak, "s3:PutObject", bucket, key)
        user_defined = {
            k: v for k, v in fields.items() if k.startswith("x-amz-meta-")
        }
        ct = fields.get("Content-Type") or fields.get("content-type") or ""
        if ct:
            user_defined["content-type"] = ct
        bm = self.buckets.get(bucket)
        # same pipeline as PUT: bucket-default SSE/compression apply here too
        from ..crypto.sse import CryptoError
        from . import transforms

        try:
            tr = transforms.encode_for_store(
                file_data, key, ct, {}, _bucket_sse_algo(bm.encryption),
                self.kms, bucket,
            )
        except CryptoError:
            raise s3err.InvalidArgument from None
        if tr.metadata:
            user_defined.update(tr.metadata)
            file_data = tr.data
        oi = await self._run(
            self.store.put_object, bucket, listing.encode_dir_object(key),
            file_data, user_defined, None, bm.versioning,
        )
        from ..events import notify as ev

        self.notifier.notify(
            "s3:ObjectCreated:Post", bucket, key, oi.size, oi.etag,
            oi.version_id, ak,
        )
        self._queue_repl(request, 
            bucket, listing.encode_dir_object(key), oi.version_id, "put"
        )
        try:
            status = int(fields.get("success_action_status", "204"))
        except ValueError:
            status = 204
        if status not in (200, 201, 204):
            status = 204
        headers = {"ETag": f'"{oi.etag}"'}
        if status == 201:
            xml = (
                '<?xml version="1.0" encoding="UTF-8"?>'
                f"<PostResponse><Bucket>{escape(bucket)}</Bucket>"
                f"<Key>{escape(key)}</Key><ETag>&quot;{oi.etag}&quot;</ETag>"
                "</PostResponse>"
            )
            return web.Response(
                status=201, body=xml.encode(), content_type="application/xml",
                headers=headers,
            )
        return web.Response(status=status, headers=headers)

    # -- object lock: retention + legal hold ----------------------------------

    RETENTION_META = "x-minio-internal-retention"  # "<mode>|<iso-until>"
    LEGALHOLD_META = "x-minio-internal-legalhold"
