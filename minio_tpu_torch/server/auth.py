"""Request authentication + authorization: SigV4/SigV2 dispatch,
session tokens, streaming-payload auth, IAM policy checks.

Split from app.py (the reference's cmd/auth-handler.go)."""

from __future__ import annotations

import asyncio
import hashlib
import os
import urllib.parse

from . import web

from . import s3err, signature, streaming
from .handler_utils import (
    _ConsumerDone,
    _AwsChunkedDecoder,
)


class RequestAuthMixin:
    async def _authenticate(
        self, request: web.Request, stream_body: bool = False
    ) -> tuple[str, bytes | None]:
        """Verify request auth; returns (access_key, payload bytes).

        stream_body=True leaves the body unread (returned as None) for the
        streaming PUT path — only valid for auth modes that don't hash the
        payload (presigned / UNSIGNED-PAYLOAD), which _streamable_put
        guarantees."""
        headers = {k.lower(): v for k, v in request.headers.items()}
        raw_path = request.rel_url.raw_path
        query = urllib.parse.parse_qsl(
            request.rel_url.raw_query_string, keep_blank_values=True
        )
        if stream_body:
            body = None
        else:
            body = await request.read() if request.body_exists else b""

        qdict = dict(query)
        if "X-Amz-Signature" in qdict:
            ak = self.verifier.verify_presigned(request.method, raw_path, query, headers)
            self._check_session_token(ak, headers, qdict)
            return ak, body
        if (
            "Signature" in qdict
            and "AWSAccessKeyId" in qdict
            and "Expires" in qdict
        ):
            # legacy presigned V2 (reference cmd/signature-v2.go)
            from .signature import SigV2Verifier

            ak = SigV2Verifier(self.iam.lookup_secret).verify_presigned(
                request.method, raw_path, request.rel_url.raw_query_string,
                headers,
            )
            self._check_session_token(ak, headers, qdict)
            return ak, body
        if "authorization" not in headers:
            # anonymous: only bucket policies can authorize it downstream
            return "", body
        if headers["authorization"].startswith("AWS "):
            # legacy header V2: HMAC-SHA1 over the V2 string-to-sign
            from .signature import SigV2Verifier

            ak = SigV2Verifier(self.iam.lookup_secret).verify_header(
                request.method, raw_path, request.rel_url.raw_query_string, headers
            )
            self._check_session_token(ak, headers, {})
            return ak, body

        content_sha = headers.get("x-amz-content-sha256", signature.UNSIGNED_PAYLOAD)
        ak = self.verifier.verify_header_auth(
            request.method, raw_path, query, headers, content_sha
        )
        if content_sha == signature.STREAMING_UNSIGNED_TRAILER:
            if body is not None:  # streamed bodies decode inline in the pump
                body = self._decode_trailer_body(request, body)
        elif content_sha in (
            signature.STREAMING_PAYLOAD,
            signature.STREAMING_PAYLOAD_TRAILER,
        ):
            auth = signature.parse_auth_header(headers["authorization"])
            body = streaming.decode_signed_chunked(
                body,
                auth.signature,
                headers.get("x-amz-date", ""),
                auth.scope,
                self.iam.lookup_secret(ak) or "",
                trailer_mode=content_sha == signature.STREAMING_PAYLOAD_TRAILER,
            )
        elif content_sha not in (signature.UNSIGNED_PAYLOAD,):
            if hashlib.sha256(body).hexdigest() != content_sha:
                raise s3err.XAmzContentSHA256Mismatch
        self._check_session_token(ak, headers, {})
        return ak, body

    @staticmethod
    def _declared_trailer_algo(request) -> str:
        """The x-amz-trailer checksum algorithm, '' if none declared.

        Shared by the buffered and streaming decode paths so the contract
        can't diverge: a declared trailer we can't verify must not be
        accepted silently (integrity was requested) -> InvalidArgument.
        """
        from ..utils import checksum as cks

        t = request.headers.get("x-amz-trailer", "").strip().lower()
        if not t:
            return ""
        if t.startswith(cks.HEADER) and t[len(cks.HEADER):] in cks.ALGOS:
            return t[len(cks.HEADER):]
        raise s3err.InvalidArgument

    def _decode_trailer_body(self, request, body: bytes) -> bytes:
        """Decode a buffered aws-chunked STREAMING-UNSIGNED-PAYLOAD-TRAILER
        body; verify the declared x-amz-checksum trailer against the
        decoded payload and record it for storage — the same integrity
        contract as the streamed path (undeclared extra trailers are
        ignored there too)."""
        from ..utils import checksum as cks

        algo = self._declared_trailer_algo(request)
        dec = _AwsChunkedDecoder()
        data = dec.feed(body)
        expect = request.headers.get("x-amz-decoded-content-length")
        try:
            if expect is not None and len(data) != int(expect):
                raise s3err.IncompleteBody
        except ValueError:
            raise s3err.InvalidArgument from None
        if algo:
            want = dec.trailers.get(f"{cks.HEADER}{algo}")
            if want is None or cks.compute(algo, data) != want:
                raise s3err.InvalidDigest
            request["trailer_checksum_meta"] = {
                f"{cks.META_PREFIX}{algo}": want
            }
        return data

    def _streamable_put(self, request: web.Request) -> bool:
        """True for object PUTs whose body can flow straight into the
        erasure plane without buffering: auth never hashes the payload
        (presigned or UNSIGNED-PAYLOAD), no Content-MD5/checksum headers
        to verify over the whole body, no copy source, and the body is big
        enough for streaming to matter. Transform applicability (SSE,
        compression) is re-checked in the handler, which falls back to the
        buffered path since the body is still unread."""
        if request.method != "PUT":
            return False
        bucket = request.match_info.get("bucket", "")
        key = request.match_info.get("key", "")
        if not bucket or not key or bucket == "minio" or bucket.startswith(".minio.sys"):
            return False
        q = request.rel_url.query
        for sub in ("retention", "legal-hold", "tagging", "acl"):
            if sub in q:
                return False
        headers = {k.lower() for k in request.headers}
        if "x-amz-copy-source" in headers or "content-md5" in headers:
            return False
        sha = request.headers.get("x-amz-content-sha256", signature.UNSIGNED_PAYLOAD)
        trailer_mode = sha == signature.STREAMING_UNSIGNED_TRAILER
        if any(
            h.startswith((
                # full-body checksum headers need the buffered verify path;
                # TRAILER checksums stream (decoded + verified on the fly)
                "x-amz-checksum-",
                # request-level SSE needs the transform pipeline (whole body)
                "x-amz-server-side-encryption",
            ))
            for h in headers
        ):
            return False
        if ("x-amz-trailer" in headers or "x-amz-sdk-checksum-algorithm" in headers) \
                and not trailer_mode:
            return False
        presigned = "X-Amz-Signature" in q
        if not presigned and sha != signature.UNSIGNED_PAYLOAD and not trailer_mode:
            return False
        try:
            cl = int(
                request.headers.get("x-amz-decoded-content-length")
                or request.headers.get("Content-Length", "0")
            )
        except ValueError:
            return False
        return cl >= int(os.environ.get("MINIO_TPU_STREAM_MIN_BYTES", str(8 << 20)))

    async def _run_streaming_put(self, request: web.Request, consume):
        """Run consume(chunk_iterator) in the io pool while pumping the
        request body into it through a bounded queue (~8 MiB of chunks):
        the async HTTP read and the sync erasure encode/write overlap, and
        a part is never fully resident. A short body (client hung up) or
        pump failure raises into the consumer so the put aborts cleanly.
        """
        import queue as _queue

        chunk_sz = int(os.environ.get("MINIO_TPU_PUT_CHUNK_MB", "4")) << 20
        q: _queue.Queue = _queue.Queue(maxsize=max(2, (8 << 20) // chunk_sz))

        def gen():
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item

        self.streaming_puts += 1
        task = asyncio.ensure_future(self._run(consume, gen()))
        loop = asyncio.get_running_loop()

        def put_item(item):
            while True:
                if task.done():
                    raise _ConsumerDone
                try:
                    q.put(item, timeout=0.25)
                    return
                except _queue.Full:
                    continue

        def inject_error(e: Exception):
            """Guaranteed delivery: drain the queue until the sentinel fits
            so the consumer can never block forever on q.get() (which would
            wedge the namespace write lock and leak the io-pool thread)."""
            while True:
                try:
                    q.put_nowait(e)
                    return
                except _queue.Full:
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        pass

        # aws-chunked bodies with trailing checksums decode + verify inline
        # (reference cmd/streaming-v4-unsigned.go + internal/hash trailers)
        decoder = None
        hasher = None
        trailer_algo = ""
        if request.headers.get("x-amz-content-sha256") == \
                signature.STREAMING_UNSIGNED_TRAILER:
            from ..utils import checksum as cks

            decoder = _AwsChunkedDecoder()
            trailer_algo = self._declared_trailer_algo(request)
            if trailer_algo:
                hasher = cks.Hasher(trailer_algo)

        expect = int(
            request.headers.get("x-amz-decoded-content-length")
            or request.headers.get("Content-Length", "0")
        )
        got = 0
        try:
            while True:
                chunk = await request.content.read(chunk_sz)
                if not chunk:
                    err: Exception | None = None
                    if got != expect:
                        err = s3err.IncompleteBody
                    elif decoder is not None and hasher is not None:
                        from ..utils import checksum as cks

                        want = decoder.trailers.get(f"{cks.HEADER}{trailer_algo}")
                        if want is None or want != hasher.b64():
                            err = s3err.InvalidDigest
                        else:
                            request["trailer_checksum_meta"] = {
                                f"{cks.META_PREFIX}{trailer_algo}": want
                            }
                    await loop.run_in_executor(self._pump_pool, put_item, err)
                    break
                if decoder is not None:
                    chunk = decoder.feed(chunk)
                    if hasher is not None and chunk:
                        hasher.update(chunk)
                    if not chunk:
                        continue
                got += len(chunk)
                try:
                    # fast path: skip the executor hop when there's room
                    q.put_nowait(chunk)
                except _queue.Full:
                    await loop.run_in_executor(self._pump_pool, put_item, chunk)
        except _ConsumerDone:
            pass  # consumer already finished/failed; its result surfaces below
        except BaseException as e:
            inject_error(e if isinstance(e, Exception) else RuntimeError(str(e)))
            raise
        return await task

    def _check_session_token(self, access_key: str, headers, query) -> None:
        """Temp (STS) credentials must present a valid session token whose
        claims match the signing key (reference: checkClaimsFromToken)."""
        u = self.iam.users.get(access_key)
        if u is None or not u.is_temp:
            return
        token = headers.get("x-amz-security-token", "") or query.get(
            "X-Amz-Security-Token", ""
        )
        claims = self.iam.verify_token(token) if token else None
        if not claims or claims.get("accessKey") != access_key:
            raise s3err.AccessDenied

    # -- dispatch ------------------------------------------------------------

    def _authorize(
        self, access_key: str, action: str, bucket: str, key: str = "",
        conditions: dict[str, str] | None = None,
    ) -> None:
        if not action:
            return  # handler performs its own per-key authorization
        resource = f"{bucket}/{key}" if key else bucket
        bucket_policy = None
        if bucket:
            raw = self.buckets.get(bucket).policy
            if raw:
                from ..iam.policy import Policy

                bucket_policy = Policy.from_dict(raw)
        if not self.iam.is_allowed(
            access_key, action, resource, conditions, bucket_policy
        ):
            raise s3err.AccessDenied
