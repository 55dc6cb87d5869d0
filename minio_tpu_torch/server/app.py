"""The S3 API server: routing + handlers over the object layer.

Path-style S3 API (the reference's registerAPIRouter,
MinIO cmd/api-router.go:255) on the stdlib HTTP front in `web.py`, which
offers the slice of aiohttp.web the handlers use. Handlers validate auth
(SigV4 header/presigned, streaming payloads), then call the erasure object
layer in worker threads; responses are S3-wire XML/headers.
"""

from __future__ import annotations

import asyncio
import hashlib
import os

from . import web

from ..erasure import quorum
from ..storage.xlstorage import XLStorage
from . import s3err, signature
from .buckets import BucketMetadataSys

from .auth import RequestAuthMixin
from .bucket_handlers import BucketHandlersMixin
from .handler_utils import (
    BUCKET_NAME_RE,
    _SUBRESOURCE_ACTIONS,
    _route_action,
    _route_conditions,
)
from .multipart_handlers import MultipartHandlersMixin
from .object_handlers import ObjectHandlersMixin
from .postpolicy import PostPolicyMixin


class S3Server(
    RequestAuthMixin,
    BucketHandlersMixin,
    ObjectHandlersMixin,
    MultipartHandlersMixin,
    PostPolicyMixin,
):
    def __init__(self, store=None, region: str = "us-east-1"):
        import time as _time

        from ..crypto.sse import KMS
        from .metrics import Metrics, TracePubSub, span_ring

        from concurrent.futures import ThreadPoolExecutor as _TPE

        from ..obs import ContextPool as _CtxTPE

        self.kms = KMS()
        self.store = None
        self.streaming_puts = 0  # observability: bodies that never buffered
        # dedicated pool for streaming-body pumps: put_item can block on a
        # full queue, and parking it in the default executor would starve
        # the storage-REST plane that shares it
        self._pump_pool = _CtxTPE(
            max_workers=8, thread_name_prefix="body-pump"
        )
        # store I/O runs on an ample dedicated pool: the default executor
        # on small machines has ~cpus+4 workers, and writers blocking on
        # namespace locks inside it can starve the reader that HOLDS the
        # lock out of a thread to finish its stream (deadlock-by-pool).
        # Context-propagating: the trace request id must survive the
        # event-loop -> worker hop (run_in_executor drops contextvars)
        io_threads = int(os.environ.get("MINIO_TPU_IO_THREADS", "64"))
        self._io_pool = _CtxTPE(max_workers=io_threads, thread_name_prefix="s3io")
        # long-poll waits (trace/listen subscribers) get their own pool so
        # they can never starve the I/O pool
        self._longpoll_pool = _TPE(max_workers=64, thread_name_prefix="longpoll")
        # admission waits get a small dedicated pool: a class at its cap
        # must not occupy long-poll or I/O threads, and since begin_wait
        # starts the deadline clock on the event loop, tasks that outwait
        # their deadline in this pool's queue reject instantly on start
        self._admit_pool = _TPE(max_workers=16, thread_name_prefix="qos-admit")
        self.region = region
        self.started_at = _time.time()
        self.metrics = Metrics()
        self.trace = TracePubSub(ring=span_ring())
        # worker-pool identity (server/worker.py): single-process serving
        # is worker 0 of 1 with no siblings; main() overwrites these when
        # the process is part of an SO_REUSEPORT pool. worker_peers are
        # loopback control endpoints of the SIBLING workers — they ride
        # `peers` for admin/trace fan-out but stay separately addressable
        # for metrics aggregation (a scrape must merge workers, not
        # cluster nodes, which scrape themselves).
        self.worker_index = 0
        self.worker_count = 1
        self.worker_peers: list[str] = []
        # deep-tracing spans (obs/) publish through this server's pubsub;
        # module-level registration because spans open in layers with no
        # server reference (dispatcher, storage wrappers) — one process
        # serves one node
        from .. import obs

        obs.set_publisher(self.trace)
        from ..qos import QoS

        # QoS plane: admission control (per-class inflight caps -> 503
        # SlowDown on overflow) + last-minute per-API latency ring
        self.qos = QoS()
        self.background = None
        # continuous wall-time profiler (server/profiling.py): main()
        # starts it knob-gated; in-process test servers leave it off
        self.cprofiler = None
        self.root_user = os.environ.get("MINIO_ROOT_USER", "minioadmin")
        self.root_pass = os.environ.get("MINIO_ROOT_PASSWORD", "minioadmin")
        self.app = web.Application(client_max_size=1 << 30)
        # CORS decoration rides the prepare signal: it must run before
        # headers hit the wire, which for streamed GETs happens INSIDE the
        # handler — a post-dispatch wrapper would be too late
        self.app.on_response_prepare.append(self._ttfb_on_prepare)
        self.app.on_response_prepare.append(self._cors_on_prepare)
        self.app.router.add_route("*", "/", self._entry)
        self.app.router.add_route("*", "/{bucket}", self._entry)
        self.app.router.add_route("*", "/{bucket}/{key:.*}", self._entry)
        if store is not None:
            self.set_store(store)

    def set_store(self, store) -> None:
        """Attach the object layer once bootstrap completes; until then S3
        requests answer 503 (the reference gates on newObjectLayer the
        same way)."""
        from ..erasure.multipart import MultipartRouter
        from ..iam.sys import IAMSys

        self.buckets = BucketMetadataSys(store)
        self.mp = MultipartRouter(store, part_transform=self._mp_part_transform)
        # IAM documents move to etcd when configured, so independent
        # deployments share one identity plane (reference
        # cmd/iam-etcd-store.go; same env variable)
        etcd_eps = os.environ.get("MINIO_ETCD_ENDPOINTS", "")
        if etcd_eps:
            from ..iam.etcd import EtcdIAMStore, EtcdKV

            iam_store = EtcdIAMStore(EtcdKV(etcd_eps))
        else:
            iam_store = store
        self.iam = IAMSys(iam_store, self.root_user, self.root_pass)
        # a real load error must abort boot: running with silently-empty IAM
        # would wipe stored identities on the next persist (first boot is
        # fine — missing documents load as empty)
        self.iam.load()
        # periodic refresh + etcd watch: IAM writes from peer nodes and
        # etcd-sharing clusters converge without restart (cmd/iam.go:246)
        _refresh_raw = os.environ.get("MINIO_TPU_IAM_REFRESH", "120")
        try:
            _refresh = float(_refresh_raw)
        except ValueError:
            raise SystemExit(
                f"MINIO_TPU_IAM_REFRESH={_refresh_raw!r}: want seconds "
                "as a number (0 disables the periodic refresh)"
            ) from None
        self.iam.start_refresh(_refresh)
        self.verifier = signature.SigV4Verifier(self.iam.lookup_secret, self.region)
        from ..batch.jobs import BatchJobPool
        from ..crypto.sse import KMS
        from ..erasure.decommission import PoolManager
        from ..events.notify import EventNotifier
        from ..replication.replicate import ReplicationPool, TargetRegistry
        from .audit import AuditLog
        from .config_kv import ConfigKV

        self.notifier = EventNotifier(self.buckets)
        self.audit = AuditLog()
        self.config = ConfigKV(store)
        from ..crypto.kes import from_env_or_config

        # KES external KMS when configured; builtin persisted key otherwise
        self.kms = from_env_or_config(cfg=self.config, store=store)
        self.repl_targets = TargetRegistry(store)
        from ..ilm.tier import TierRegistry

        self.tiers = TierRegistry(store)

        def _repl_decode(oi, data, bucket, key):
            from ..crypto import sse as ssemod
            from . import transforms

            if not transforms.is_transformed(oi.user_defined):
                return data
            if oi.user_defined.get(ssemod.META_ALGO) == "SSE-C":
                # the server has no customer key; cannot replicate SSE-C
                raise RuntimeError("SSE-C objects cannot be auto-replicated")
            return transforms.decode_full(
                data, oi.user_defined, {}, bucket, key, self.kms
            )

        self.replication = ReplicationPool(
            store, self.buckets, self.repl_targets, decode=_repl_decode
        )
        from ..replication.site import SiteReplicationSys

        self.site = SiteReplicationSys(self)
        # miniovet: ignore[races] -- set_store runs exactly once at
        # bootstrap, before the server accepts traffic; the callback
        # wiring cannot be re-entered concurrently
        self.buckets.on_change = (
            lambda bucket, bm: self.site.sync_bucket_meta(bucket, bm)
        )
        self.iam.on_mutation = self.site.sync_iam
        self.batch = BatchJobPool(store, self.buckets, self.replication, kms=self.kms)
        self.pool_mgr = (
            PoolManager(store) if hasattr(store, "pools") else None
        )
        self.store = store
        # cache coherence: received grid invalidations apply to THIS
        # store's per-set caches (cache/coherence.py)
        from ..cache import coherence as cache_coherence

        cache_coherence.attach(store)
        self.site.load()  # resume a persisted site group across restarts
        # background durability plane: scanner + MRF heal workers
        from ..erasure.background import BackgroundOps

        interval = float(os.environ.get("MINIO_TPU_SCAN_INTERVAL", "300"))
        self.background = BackgroundOps(
            store, scan_interval=interval, bucket_meta=self.buckets,
            tiers=self.tiers,
        )
        for p in getattr(store, "pools", [store]):
            for s in getattr(p, "sets", [p]):
                s.on_degraded = self.background.mrf.add
        if interval > 0:
            # pool workers past index 0 run heal (their own MRF queue)
            # but not the scanner/ILM/fresh-disk plane: those walk the
            # SHARED drives and would duplicate bg work N× per node
            self.background.start(scanner=self.worker_index == 0)

    # -- plumbing ------------------------------------------------------------

    def _mp_part_transform(self, bucket, obj, up_meta, part_number, data,
                           ctx=None):
        """SSE hook for multipart parts: encrypt each part as its own
        packet stream under the upload's OEK. None = no transform.
        Returns (stored, plain_size | size_getter): streamed parts encrypt
        packet-by-packet and report their plaintext size after the fact.
        `ctx` carries the part request's headers — SSE-C uploads re-present
        the customer key on every part (cmd/erasure-multipart.go:575)."""
        from ..crypto import sse as ssemod
        from . import transforms

        if ssemod.META_ALGO not in up_meta:
            return None
        # SSE-C validation (key present + MD5 match vs the upload's) happens
        # inside _unseal_oek, which both encrypt paths invoke eagerly — a
        # missing/mismatched customer key raises before any data is stored
        headers = ctx or {}
        if isinstance(data, (bytes, bytearray)):
            enc = transforms.encrypt_part(
                bytes(data), up_meta, part_number, self.kms, bucket, obj,
                headers,
            )
            return enc, len(data)
        count = [0]
        gen = transforms.encrypt_part_iter(
            data, up_meta, part_number, self.kms, bucket, obj, count, headers
        )
        return gen, (lambda: count[0])

    def close(self) -> None:
        """Stop background workers (IAM refresh/watch, scanner) — for
        embedders and tests that start/stop servers within one process;
        without this, watcher threads keep dialing dead backends."""
        iam = getattr(self, "iam", None)
        if iam is not None:
            iam.stop_refresh()
        if self.background is not None:
            try:
                self.background.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def _queue_repl(self, request, bucket, key, version_id, op) -> None:
        """Queue a bucket-replication task unless this write IS a replica
        (the marker header breaks active-active site-replication loops).
        Only cluster owners (site peers authenticate with admin creds) may
        set the marker — an ordinary writer must not be able to opt its
        writes out of replication."""
        from ..replication.replicate import REPLICA_MARKER

        if (
            request.headers.get(REPLICA_MARKER) == "true"
            and self.iam.is_owner(request.get("access_key", ""))
        ):
            return
        self.replication.queue_mutation(bucket, key, version_id, op)

    async def _run(self, fn, *args, **kw):
        return await asyncio.get_running_loop().run_in_executor(
            self._io_pool, lambda: fn(*args, **kw)
        )

    def _prometheus_bearer_ok(self, request) -> bool:
        """Validate a madmin-style prometheus JWT: HS512 signed with the
        subject's secret key, standard base64url framing."""
        import hmac as _hmac
        import json as _json
        import time as _time

        from ..iam.oidc import _b64url as _unb64  # shared padded decoder

        auth = request.headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            return False

        try:
            h, c, s = auth[7:].split(".")
            claims = _json.loads(_unb64(c))
            ak = claims.get("sub", "")
            secret = self.iam.lookup_secret(ak)
            if not secret:
                return False
            want = _hmac.new(
                secret.encode(), f"{h}.{c}".encode(), hashlib.sha512
            ).digest()
            if not _hmac.compare_digest(_unb64(s), want):
                return False
            exp = claims.get("exp")
            if exp is not None and _time.time() > float(exp):
                return False
        except Exception:  # noqa: BLE001 — any malformed token is a no
            return False
        return self.iam.is_allowed(ak, "admin:Prometheus", "")

    def _err_response(self, request, err: s3err.APIError) -> web.Response:
        # rejection split the status-code classifier in Metrics.observe
        # can't see: malformed auth headers vs clock skew (both 4xx)
        if err.code == "RequestTimeTooSkewed":
            self.metrics.rejected_timestamp += 1
        elif err.code == "AuthorizationHeaderMalformed":
            self.metrics.rejected_header += 1
        headers = {}
        size = request.get("_range_object_size")
        if err.http_status == 416 and size is not None:
            # RFC 7233: unsatisfiable ranges advertise the actual length
            # (the reference sets this on InvalidRange responses too)
            headers["Content-Range"] = f"bytes */{size}"
        return web.Response(
            status=err.http_status,
            body=err.to_xml(
                resource=request.path,
                request_id=request.get("_reqid", ""),
            ),
            content_type="application/xml",
            headers=headers,
        )

    def _apply_vhost_style(self, request: web.Request) -> None:
        """Virtual-host-style addressing (reference MINIO_DOMAIN,
        cmd/generic-handlers.go setBucketForwardingMiddleware): for
        `bucket.domain` hosts the bucket rides the Host header and the
        whole path is the key. SigV4 verification keeps the original
        path — that is what vhost clients sign."""
        domains = os.environ.get("MINIO_DOMAIN", "")
        if not domains:
            return
        host = request.headers.get("Host", "").rsplit(":", 1)[0].lower()
        # longest suffix first: with domains example.test + s3.example.test
        # configured, host b.s3.example.test must parse bucket "b", not
        # the dotted label "b.s3"
        ordered = sorted(
            (d.strip().lower() for d in domains.split(",") if d.strip()),
            key=len, reverse=True,
        )
        for dom in ordered:
            if not host.endswith("." + dom):
                continue
            vb = host[: -len(dom) - 1]
            if not BUCKET_NAME_RE.match(vb):
                return  # not a bucket label (e.g. console.domain)
            # the key is the WHOLE request path (not re-joined match_info
            # segments: that would drop a trailing slash, losing folder
            # markers like "photos/")
            request.match_info["key"] = request.path.lstrip("/")
            request.match_info["bucket"] = vb
            return

    async def _admit(self, qos_class: str) -> bool:
        """Admission control for one request: lock-only fast path on the
        event loop; contended classes reserve a waiter slot (bounded —
        queue-full rejects here, before any thread is consumed) and park
        the blocking deadline wait on the dedicated admission pool.
        Cancellation-safe: a client that disconnects mid-wait hands any
        slot the worker still grants straight back, so caps never leak."""
        from .. import obs

        adm = self.qos.admission
        if adm.try_acquire(qos_class):
            return True
        # contended: the parked wait is an `internal` span — attributes a
        # slow p99 to admission queueing vs. actual work
        with obs.span(
            obs.TYPE_INTERNAL, "qos.admission-wait", **{"class": qos_class}
        ) as sp:
            deadline = adm.begin_wait(qos_class)
            if deadline is None:
                sp.set(rejected="queue_full")
                return False  # wait queue full: SlowDown immediately
            # submit + wrap (not run_in_executor): on cancellation the asyncio
            # wrapper is marked cancelled even while the worker keeps running,
            # so the reclaim callback must ride the CONCURRENT future, whose
            # terminal state says what finish_wait actually did
            cf = self._admit_pool.submit(adm.finish_wait, qos_class, deadline)
            try:
                granted = await asyncio.wrap_future(cf)
                sp.set(granted=granted)
                return granted
            except asyncio.CancelledError:
                def _reclaim(f):
                    try:
                        if f.cancelled():
                            # finish_wait never ran: undo the reservation
                            adm.abort_wait(qos_class)
                        elif f.exception() is None and f.result():
                            adm.release(qos_class)  # granted to a dead request
                    except Exception:  # noqa: BLE001 — teardown best-effort
                        pass

                cf.add_done_callback(_reclaim)
                raise

    async def _entry(self, request: web.Request) -> web.StreamResponse:
        import time as _time

        from .. import obs
        from .handler_utils import classify_qos_class
        from .metrics import classify_api, trace_record

        self._apply_vhost_style(request)
        t0 = _time.perf_counter()
        request["_t0"] = t0  # TTFB measured at response prepare time
        # per-request trace context: the generated x-amz-request-id rides a
        # contextvar through every layer below (and the response header —
        # set at prepare time so streamed bodies get it too)
        req_id = obs.new_request_id()
        request["_reqid"] = req_id
        # the request's own span in the ring (`s3.request`): every span
        # below names it as parent
        ring = self.trace.ring
        sid = obs.next_span_id() if ring is not None else 0
        t0_ns = _time.monotonic_ns()
        obs_token = obs.set_request(req_id, sid)
        resp: web.StreamResponse | None = None
        qos_class: str | None = None
        self.metrics.inflight += 1  # single-threaded event loop: no race
        try:
            origin = request.headers.get("Origin", "")
            if origin and request.method == "OPTIONS" and request.headers.get(
                "Access-Control-Request-Method"
            ):
                resp = await self._cors_preflight(request, origin)
                return resp
            cls = classify_qos_class(
                request.match_info.get("bucket", ""),
                request.match_info.get("key", ""),
                request.headers,
            )
            if cls is not None:
                if not await self._admit(cls):
                    # over the class cap past the bounded wait deadline:
                    # S3 SlowDown (503), never unbounded queueing
                    resp = self._err_response(request, s3err.SlowDown)
                    resp.headers["Retry-After"] = "1"
                    return resp
                qos_class = cls  # acquired: release in finally
            resp = await self._entry_inner(request)
            return resp
        except asyncio.CancelledError:
            # client went away: count it (metrics-v3 canceled_total) and
            # propagate so the HTTP front abandons the request
            self.metrics.canceled += 1
            raise
        finally:
            obs.trace.reset_request(obs_token)
            if qos_class is not None:
                self.qos.admission.release(qos_class)
            self.metrics.inflight -= 1
            dur = _time.perf_counter() - t0
            status = resp.status if resp is not None else 500
            api = classify_api(
                request.method,
                request.match_info.get("bucket", ""),
                request.match_info.get("key", ""),
                request.rel_url.query,
            )
            rx = int(request.headers.get("Content-Length") or 0)
            # bytes counted at write time win: streamed responses (tier
            # read-through, transformed GETs, proxies) have no (or a lying)
            # content_length, and would otherwise meter as 0 bytes sent.
            # `is not None`, NOT truthiness: StreamResponse is a Mapping,
            # so a response with empty per-request storage is falsy — the
            # old `if resp` zeroed tx for nearly every response
            tx = request.get("_tx")
            if tx is None and resp is not None:
                tx = getattr(resp, "content_length", None) or 0
            tx = tx or 0
            self.metrics.observe(
                api, status, dur, rx, tx,
                bucket=request.match_info.get("bucket", ""),
                ttfb=request.get("_ttfb"),
            )
            self.qos.last_minute.add(api, dur, ttfb=request.get("_ttfb"))
            if ring is not None:
                ring.add("s3.request", api, req_id, sid, 0, t0_ns,
                         _time.monotonic_ns(), rx + tx, 0, status)
            if self.trace.active:
                rec = trace_record(request, status, dur, rx, tx,
                                   req_id=req_id, api=api)
                if sid:
                    # the spans below name it as their parent
                    rec["spanId"] = sid
                self.trace.publish(rec)
            audit = getattr(self, "audit", None)
            if audit is not None and audit.enabled:
                from .audit import audit_record

                audit.emit(
                    audit_record(request, status, dur,
                                 request.get("access_key", ""),
                                 rx=rx, tx=tx)
                )

    @staticmethod
    def _is_user_bucket(bucket: str) -> bool:
        return bool(bucket) and bucket != "minio" and not bucket.startswith(".minio.sys")

    def _cors_rules_for(self, raw: str):
        """Parsed bucket CORS rules, memoized by the raw document — the
        response path must not pay an XML parse per request."""
        from . import cors as corsmod

        cache = getattr(self, "_cors_rule_cache", None)
        if cache is None:
            cache = self._cors_rule_cache = {}
        rules = cache.get(raw)
        if rules is None:
            if len(cache) > 256:
                cache.clear()
            try:
                rules = cache[raw] = corsmod.parse_bucket_cors(raw)
            except ValueError:
                rules = cache[raw] = []
        return rules or None

    def _cors_headers(
        self, bucket: str, origin: str, method: str, req_headers: list[str],
        allow_load: bool = False,
    ) -> dict[str, str] | None:
        """Evaluate bucket CORS rules (when configured) or the global
        api.cors_allow_origin config (reference cmd/api-router.go:651).
        allow_load=False restricts to the metadata CACHE (event-loop
        callers); allow_load=True (executor callers) falls through to a
        bucket_exists-gated metadata load, so attacker-chosen names never
        reach get() (which would cache a default entry per name)."""
        rules = None
        if self._is_user_bucket(bucket):
            bm = self.buckets.peek(bucket)
            if bm is None and allow_load and self.store is not None:
                try:
                    if self.store.bucket_exists(bucket):
                        bm = self.buckets.get(bucket)
                except Exception:  # noqa: BLE001 — degraded metadata reads
                    bm = None     # fall back to global rules
            raw = bm.cors if bm is not None else None
            if raw:
                rules = self._cors_rules_for(raw)
        from . import cors as corsmod

        global_origins = [
            o.strip()
            for o in (self.config.get("api", "cors_allow_origin") or "*").split(",")
            if o.strip()
        ] if self.config is not None else ["*"]
        return corsmod.evaluate(origin, method, req_headers, rules, global_origins)

    async def _ttfb_on_prepare(self, request: web.Request, response) -> None:
        """Metrics TTFB capture: first byte leaves at response-prepare time
        for both buffered and streamed bodies. The generated request id
        rides the same hook so EVERY response carries it (S3 clients
        correlate errors by x-amz-request-id)."""
        import time as _time

        t0 = request.get("_t0")
        if t0 is not None and "_ttfb" not in request:
            request["_ttfb"] = _time.perf_counter() - t0
        req_id = request.get("_reqid")
        if req_id:
            response.headers.setdefault("x-amz-request-id", req_id)

    async def _cors_on_prepare(self, request: web.Request, response) -> None:
        origin = request.headers.get("Origin", "")
        if not origin or request.method == "OPTIONS":
            return
        bucket = request.match_info.get("bucket", "") if request.match_info else ""
        if self._is_user_bucket(bucket) and self.buckets.peek(bucket) is None:
            # uncached bucket (e.g. first GET after restart): its CORS
            # rules are authoritative, so load them off-loop rather than
            # silently falling back to the permissive global default
            hdrs = await self._run(
                self._cors_headers, bucket, origin, request.method, [], True
            )
        else:
            hdrs = self._cors_headers(bucket, origin, request.method, [])
        if hdrs:
            for k, v in hdrs.items():
                response.headers.setdefault(k, v)

    async def _cors_preflight(self, request: web.Request, origin: str) -> web.Response:
        """OPTIONS preflight: unauthenticated by design (browsers send no
        credentials); only reveals whether an origin/method is allowed."""
        method = request.headers.get("Access-Control-Request-Method", "")
        req_headers = [
            h.strip()
            for h in request.headers.get("Access-Control-Request-Headers", "").split(",")
            if h.strip()
        ]
        hdrs = await self._run(
            self._cors_headers, request.match_info.get("bucket", ""), origin,
            method, req_headers, True,
        )
        if hdrs is None:
            return web.Response(status=403, body=b"CORSResponse: origin not allowed")
        return web.Response(status=200, headers=hdrs)

    async def _entry_inner(self, request: web.Request) -> web.StreamResponse:
        # unauthenticated planes: health + metrics
        bucket = request.match_info.get("bucket", "")
        key = request.match_info.get("key", "")
        if bucket == "minio":
            if request.method == "GET" and key == "console/api/users":
                # console backend API (the reference console ships its own
                # REST layer too): same authz as madmin ListUsers, but plain
                # JSON — the browser cannot speak the argon2id-encrypted
                # madmin framing. No secrets travel: status/policies/groups.
                try:
                    ak, _ = await self._authenticate(request)
                except s3err.APIError as e:
                    return self._err_response(request, e)
                if not ak or not self.iam.is_allowed(ak, "admin:ListUsers", ""):
                    return self._err_response(request, s3err.AccessDenied)
                users = await self._run(self.iam.list_users)
                return web.json_response({
                    k: {"status": u.status, "policyName": ",".join(u.policies),
                        "memberOf": u.groups}
                    for k, u in users.items()
                })
            if request.method in ("GET", "HEAD") and (
                key == "console" or key.startswith("console/")
            ):
                # embedded browser console (reference embeds minio/console,
                # cmd/common-main.go:46); static page, data calls signed
                # in-browser
                from .console import handle_console

                return handle_console(request)
            if key.startswith("health/"):
                # disk probes may hit remote drives: stay off the event loop
                return await self._run(self._health, request, key)
            if key in ("v2/metrics/cluster", "v2/metrics/node") or key.startswith(
                "metrics/v3"
            ):
                if self.store is None:
                    return web.Response(status=503)
                if os.environ.get("MINIO_PROMETHEUS_AUTH_TYPE", "jwt") != "public":
                    # scrapers authenticate with the bearer JWT that
                    # `mc admin prometheus generate` mints (HS512 over the
                    # caller's secret key); SigV4 remains accepted for
                    # our own SDK (reference cmd/metrics-router.go)
                    if not self._prometheus_bearer_ok(request):
                        try:
                            ak, _ = await self._authenticate(request)
                        except s3err.APIError as e:
                            return self._err_response(request, e)
                        if not ak or not self.iam.is_allowed(
                            ak, "admin:Prometheus", ""
                        ):
                            return self._err_response(request, s3err.AccessDenied)
                if key.startswith("metrics/v3"):
                    from .metrics import render_v3, render_v3_pool

                    sub = key[len("metrics/v3"):]
                    # worker pool: a scrape landing on this worker merges
                    # every sibling's series (worker-labelled) unless the
                    # caller opted out with local=on (the fan-out itself
                    # uses local=on, so recursion stops after one hop)
                    local_only = request.rel_url.query.get(
                        "local", ""
                    ).lower() in ("on", "true", "1")
                    render = (
                        render_v3 if local_only or not self.worker_peers
                        else render_v3_pool
                    )
                    text = await self._run(render, self, sub)
                    if text is None:
                        return web.Response(status=404, body=b"unknown metrics path")
                else:
                    text = await self._run(self.metrics.render, self)
                return web.Response(body=text.encode(), content_type="text/plain")
        try:
            if self.store is None:
                return web.Response(
                    status=503, headers={"Retry-After": "1"},
                    body=b"server initializing",
                )
            return await self._dispatch(request)
        except s3err.APIError as e:
            return self._err_response(request, e)
        except quorum.BucketNotFound:
            return self._err_response(request, s3err.NoSuchBucket)
        except quorum.BucketExists:
            return self._err_response(request, s3err.BucketAlreadyOwnedByYou)
        except quorum.BucketNotEmpty:
            return self._err_response(request, s3err.BucketNotEmpty)
        except (quorum.ObjectNotFound,):
            return self._err_response(request, s3err.NoSuchKey)
        except quorum.VersionNotFound:
            return self._err_response(request, s3err.NoSuchVersion)
        except quorum.QuorumError:
            return self._err_response(request, s3err.InternalError)
        except asyncio.CancelledError:
            # client disconnect: propagate so the HTTP front abandons the request
            # instead of logging a 500 for work nobody is waiting on
            raise
        except Exception:  # noqa: BLE001
            import traceback

            traceback.print_exc()
            return self._err_response(request, s3err.InternalError)
    async def _dispatch(self, request: web.Request) -> web.StreamResponse:
        ak, body = await self._authenticate(
            request, stream_body=self._streamable_put(request)
        )
        request["access_key"] = ak
        bucket = request.match_info.get("bucket", "")
        # match_info is already percent-decoded; decoding again
        # would corrupt keys that legitimately contain %-sequences
        key = request.match_info.get("key", "")
        q = request.rel_url.query
        m = request.method

        # admin + STS + KMS planes
        if bucket == "minio" and key.startswith("kms/"):
            from .kms_handlers import handle_kms

            return await handle_kms(
                self, request, ak, key[len("kms/"):], body
            )
        if bucket == "minio" and key.startswith("admin/"):
            from .admin import handle_admin

            if not ak:
                raise s3err.AccessDenied
            sub = key[len("admin/") :]
            sub = sub.split("/", 1)[1] if "/" in sub else ""  # strip version
            return await handle_admin(self, request, ak, sub, body)
        if not bucket and m == "POST":
            from .sts import handle_sts

            return await handle_sts(self, request, ak, body)

        if not bucket:
            if m == "GET":
                self._authorize(ak, "s3:ListAllMyBuckets", "")
                return await self.list_buckets(request)
            raise s3err.MethodNotAllowed
        if bucket.startswith(".minio.sys"):
            raise s3err.AccessDenied

        if self.buckets.peek(bucket) is None:
            # the first look at a bucket's metadata reads the store: off the
            # event loop, which in a cluster must stay free to answer peers'
            # storage and lock calls (nodes all blocked here at once, each
            # reading from the others, would wait out the grid's timeouts)
            await self._run(self.buckets.get, bucket)
        self._authorize(ak, *_route_action(m, bucket, key, q, request.headers),
                        conditions=_route_conditions(q))

        if not key:
            if m == "PUT":
                if "versioning" in q:
                    return await self.put_bucket_versioning(request, bucket, body)
                if "policy" in q:
                    return await self.put_bucket_simple(request, bucket, "policy", body)
                if "lifecycle" in q:
                    return await self.put_bucket_simple(request, bucket, "lifecycle", body)
                if "tagging" in q:
                    return await self.put_bucket_simple(request, bucket, "tags", body)
                if "notification" in q:
                    return await self.put_bucket_simple(request, bucket, "notification", body)
                if "encryption" in q:
                    return await self.put_bucket_simple(request, bucket, "encryption", body)
                if "object-lock" in q:
                    return await self.put_bucket_simple(request, bucket, "object_lock", body)
                if "cors" in q:
                    return await self.put_bucket_simple(request, bucket, "cors", body)
                if "replication" in q:
                    return await self.put_bucket_simple(request, bucket, "replication", body)
                if "acl" in q:
                    return await self.put_acl(request, bucket, "", body)
                if "requestPayment" in q:
                    return await self.put_request_payment(request, bucket, body)
                if "ownershipControls" in q:
                    return await self.put_bucket_simple(
                        request, bucket, "ownership", body
                    )
                if "logging" in q or "website" in q or "accelerate" in q:
                    raise s3err.NotImplemented_
                if any(s in q for s in _SUBRESOURCE_ACTIONS):
                    # unhandled method on a known subresource must NOT fall
                    # through to bucket creation (it was authorized for the
                    # SUBRESOURCE action, not s3:CreateBucket)
                    raise s3err.MethodNotAllowed
                return await self.put_bucket(request, bucket)
            if m == "DELETE":
                for sub in ("policy", "lifecycle", "tagging", "notification",
                            "encryption", "cors", "replication",
                            "ownershipControls"):
                    if sub in q:
                        return await self.delete_bucket_simple(request, bucket, sub)
                if any(s in q for s in _SUBRESOURCE_ACTIONS) or any(
                    s in q for s in ("website", "logging", "accelerate")
                ):
                    # e.g. DELETE ?acl or ?versioning was authorized for the
                    # subresource action only — falling through would delete
                    # the BUCKET without s3:DeleteBucket
                    raise s3err.MethodNotAllowed
                return await self.delete_bucket(request, bucket)
            if m == "HEAD":
                return await self.head_bucket(request, bucket)
            if m == "GET":
                if "events" in q:  # MinIO listen-notification extension
                    return await self.listen_events(request, bucket)
                if "location" in q:
                    return await self.get_bucket_location(request, bucket)
                if "versioning" in q:
                    return await self.get_bucket_versioning(request, bucket)
                if "versions" in q:
                    return await self.list_object_versions(request, bucket)
                for sub, attr, missing in (
                    ("policy", "policy", s3err.NoSuchBucketPolicy),
                    ("lifecycle", "lifecycle", s3err.NoSuchLifecycleConfiguration),
                    ("tagging", "tags", s3err.NoSuchTagSet),
                    ("notification", "notification", None),
                    ("encryption", "encryption", s3err.ServerSideEncryptionConfigurationNotFoundError),
                    ("object-lock", "object_lock", s3err.ObjectLockConfigurationNotFoundError),
                    ("cors", "cors", s3err.NoSuchCORSConfiguration),
                    ("replication", "replication", s3err.ReplicationConfigurationNotFoundError),
                ):
                    if sub in q:
                        return await self.get_bucket_simple(request, bucket, attr, missing)
                if "acl" in q:
                    return await self.get_acl(request, bucket, "")
                if "policyStatus" in q:
                    return await self.get_policy_status(request, bucket)
                if "requestPayment" in q:
                    return await self.get_request_payment(request, bucket)
                if "logging" in q:
                    return await self.get_bucket_logging(request, bucket)
                if "ownershipControls" in q:
                    return await self.get_bucket_simple(
                        request, bucket, "ownership",
                        s3err.OwnershipControlsNotFoundError,
                    )
                if "website" in q:
                    if not await self._run(self.store.bucket_exists, bucket):
                        raise s3err.NoSuchBucket
                    raise s3err.NoSuchWebsiteConfiguration
                if "uploads" in q:
                    return await self.list_multipart_uploads(request, bucket)
                return await self.list_objects(request, bucket)
            if m == "POST":
                if "delete" in q:
                    return await self.delete_multiple(request, bucket, body)
                ctype = request.headers.get("Content-Type", "")
                if ctype.startswith("multipart/form-data"):
                    return await self.post_policy_upload(request, bucket, body)
            raise s3err.MethodNotAllowed

        # object-level. Subresource blocks terminate: an unhandled method
        # was authorized for the SUBRESOURCE action and must not fall
        # through to object read/delete (e.g. DELETE ?retention holding
        # only s3:PutObjectRetention must not delete the object).
        if "retention" in q:
            if m == "PUT":
                return await self.put_object_retention(request, bucket, key, body)
            if m == "GET":
                return await self.get_object_retention(request, bucket, key)
            raise s3err.MethodNotAllowed
        if "legal-hold" in q:
            if m == "PUT":
                return await self.put_legal_hold(request, bucket, key, body)
            if m == "GET":
                return await self.get_legal_hold(request, bucket, key)
            raise s3err.MethodNotAllowed
        if "tagging" in q:
            if m == "PUT":
                return await self.put_object_tagging(request, bucket, key, body)
            if m == "GET":
                return await self.get_object_tagging(request, bucket, key)
            if m == "DELETE":
                return await self.delete_object_tagging(request, bucket, key)
            raise s3err.MethodNotAllowed
        if "acl" in q:
            if m == "PUT":
                return await self.put_acl(request, bucket, key, body)
            if m == "GET":
                return await self.get_acl(request, bucket, key)
            raise s3err.MethodNotAllowed
        if m == "PUT":
            if "partNumber" in q and "uploadId" in q:
                if "x-amz-copy-source" in request.headers:
                    return await self.upload_part_copy(request, bucket, key)
                return await self.put_object_part(request, bucket, key, body)
            if "x-amz-copy-source" in request.headers:
                return await self.copy_object(request, bucket, key)
            return await self.put_object(request, bucket, key, body)
        if m == "GET":
            if "uploadId" in q:
                return await self.list_parts(request, bucket, key)
            if "attributes" in q:
                return await self.get_object_attributes(request, bucket, key)
            if "lambdaArn" in q:
                return await self.get_object_lambda(request, bucket, key)
            return await self.get_object(request, bucket, key)
        if m == "HEAD":
            return await self.head_object(request, bucket, key)
        if m == "DELETE":
            if "uploadId" in q:
                return await self.abort_multipart(request, bucket, key)
            return await self.delete_object(request, bucket, key)
        if m == "POST":
            if "uploads" in q:
                return await self.new_multipart(request, bucket, key)
            if "uploadId" in q:
                return await self.complete_multipart(request, bucket, key, body)
            if "restore" in q:
                return await self.restore_object(request, bucket, key, body)
            if "select" in q and q.get("select-type") == "2":
                return await self.select_object_content(request, bucket, key, body)
        raise s3err.MethodNotAllowed

    # -- service -------------------------------------------------------------
    def _health(self, request, key: str) -> web.Response:
        """Liveness/readiness/cluster health
        (reference cmd/healthcheck-handler.go)."""
        if key == "health/live":
            return web.Response(status=200)
        if key in ("health/ready", "health/cluster"):
            if self.store is None:
                return web.Response(status=503)
            if key == "health/cluster":
                online = 0
                for d in self.store.disks:
                    try:
                        d.disk_info()
                        online += 1
                    except Exception:  # noqa: BLE001
                        pass
                quorum = len(self.store.disks) // 2 + 1
                if online < quorum:
                    return web.Response(
                        status=503, headers={"X-Minio-Write-Quorum": str(quorum)}
                    )
            return web.Response(status=200)
        return web.Response(status=404)
    # -- admin helpers ---------------------------------------------------------

    def server_info(self) -> dict:
        from .admin import server_info_payload

        return server_info_payload(self)

    def storage_info(self) -> dict:
        from .admin import storage_info_payload

        return storage_info_payload(self)

    def heal_sweep(self, bucket: str = "", prefix: str = "") -> dict:
        """Synchronous heal sweep over bucket/prefix (admin heal trigger;
        the background scanner drives the same per-object heal)."""
        healed, scanned, failed = [], 0, 0
        buckets = [bucket] if bucket else [b.name for b in self.store.list_buckets()]
        for b in buckets:
            for raw in self.store.walk_objects(b, prefix):
                scanned += 1
                try:
                    res = self.store.heal_object(b, raw)
                    for ep in res.get("healed", []):
                        healed.append(f"{b}/{raw}@{ep}")
                except Exception:  # noqa: BLE001
                    failed += 1
        return {"scanned": scanned, "healed": healed, "failed": failed}


def make_object_layer(
    drive_specs: list[str],
    set_size: int = 0,
    my_port: int = 0,
    internode_token_value: str = "",
    local_drive_registry: dict[int, XLStorage] | None = None,
    ns_lock=None,
    allow_mint: bool | None = None,
):
    """Build the full L3 topology from drive specs (ellipses expanded):
    endpoints -> local XLStorage / remote StorageRESTClient -> format.json
    bootstrap -> ErasureSets per pool -> ServerPools.

    Each spec is one pool (reference: each `minio server` arg group is a
    pool); 'path{0...15}' and 'http://host{1...2}:9000/d{1...4}' patterns
    expand to drives. All nodes pass identical specs; global drive indexes
    address remote drives (filled into local_drive_registry for the node's
    own storage RPC server).
    """
    from ..cluster.endpoint import parse_endpoint
    from ..cluster.storage_rest import StorageRESTClient
    from ..erasure.pools import ServerPools
    from ..erasure.sets import ErasureSets
    from ..storage.format_erasure import init_or_load_formats
    from ..storage.offline import OfflineDisk
    from ..utils import ellipses

    # args with ellipses each form a pool; bare dirs combine into one pool
    # (reference: each ellipses arg group is a serverPool)
    pool_specs: list[list[str]] = []
    bare: list[str] = []
    for spec in drive_specs:
        if ellipses.has_ellipses(spec):
            pool_specs.append(ellipses.expand(spec))
        else:
            bare.append(spec)
    if bare:
        pool_specs.insert(0, bare)

    # bootstrap-leader rule: only the node owning the very first endpoint
    # may mint a fresh cluster layout; in an SO_REUSEPORT worker pool the
    # caller narrows this further (only worker 0 mints — two workers
    # racing init_or_load_formats over the same empty drives would both
    # try to write format.json)
    if allow_mint is None:
        leader = parse_endpoint(pool_specs[0][0], my_port).is_local
        allow_mint = leader if local_drive_registry is not None else True

    pools = []
    global_idx = 0
    for pool_idx, paths in enumerate(pool_specs):
        disks = []
        any_local = False
        from ..fault.storage import FaultInjectedDisk
        from ..storage.health import HealthCheckedDisk

        for p in paths:
            ep = parse_endpoint(p, my_port)
            if ep.is_local:
                d = XLStorage(ep.path, endpoint=p)
                if local_drive_registry is not None:
                    # the RPC server serves the RAW drive; health wrapping
                    # happens on the calling side
                    local_drive_registry[global_idx] = d
                any_local = True
            else:
                d = StorageRESTClient(
                    ep.host, ep.port, global_idx, internode_token_value, endpoint=p
                )
            # circuit breaker: a dead drive fails fast instead of adding
            # its timeout to every quorum operation. The fault-injection
            # wrapper sits UNDER it so admin-injected chaos (fault/) hits
            # the same breaker/latency accounting real faults do; it costs
            # one flag read per op while no rules are armed.
            disks.append(HealthCheckedDisk(FaultInjectedDisk(d)))
            global_idx += 1
        if not any_local and local_drive_registry is not None:
            raise ValueError(f"pool {pool_idx}: no local drives for this node")
        size = ellipses.choose_set_size(len(disks), set_size)
        dep_id, grouped = init_or_load_formats(disks, size, allow_mint=allow_mint)
        grouped = [
            [d if d is not None else OfflineDisk() for d in row] for row in grouped
        ]
        pools.append(
            ErasureSets(grouped, dep_id, pool_index=pool_idx, ns_lock=ns_lock)
        )
    return ServerPools(pools)


def make_server(
    drive_paths: list[str], region: str = "us-east-1", set_size: int = 0
) -> S3Server:
    return S3Server(make_object_layer(drive_paths, set_size), region)


def main(argv: list[str] | None = None) -> None:
    import argparse

    from ..analysis import sanitizer

    if sanitizer.enabled():
        # before any object-layer construction so instance locks created
        # from here on are witnessed against the generated LOCK_ORDER.md
        sanitizer.install()

    from ..cluster.endpoint import parse_endpoints, remote_nodes
    from ..cluster.locks import LocalLocker, LockRESTServer, NamespaceLock, _RemoteLocker
    from ..cluster.storage_rest import StorageRESTServer, internode_token
    from ..utils import ellipses

    ap = argparse.ArgumentParser(description="minio_tpu_torch S3 server")
    ap.add_argument(
        "drives", nargs="+",
        help="drive dirs, ellipses patterns, or http://host:port/path "
        "endpoints; each ellipses arg is one pool",
    )
    ap.add_argument("--address", default="0.0.0.0:9000")
    ap.add_argument("--set-size", type=int, default=0, help="drives per erasure set")
    ap.add_argument("--ftp", type=int, default=0, help="FTP gateway port (0=off)")
    ap.add_argument("--sftp", type=int, default=0, help="SFTP gateway port (0=off)")
    ap.add_argument(
        "--certs-dir",
        default=os.environ.get("MINIO_TPU_CERTS_DIR", ""),
        help="directory with public.crt/private.key (+ CAs/); enables TLS "
        "for the listener and all internode planes when the pair exists",
    )
    args = ap.parse_args(argv)
    host, _, port = args.address.rpartition(":")
    my_port = int(port)

    # -- SO_REUSEPORT worker pool (server/worker.py) ----------------------
    # The supervisor path never builds a server: it herds N re-executed
    # children, each of which lands here again WITH a worker identity.
    from . import worker as workermod

    wid = workermod.worker_identity()
    if wid is None:
        n_workers = workermod.resolve_worker_count()
        if n_workers > 1:
            import sys

            probe_eps = parse_endpoints(
                [p for spec in args.drives for p in ellipses.expand(spec)],
                my_port,
            )
            raise SystemExit(
                workermod.supervise(
                    list(argv) if argv is not None else sys.argv[1:],
                    n_workers, my_port,
                    distributed=bool(remote_nodes(probe_eps)),
                )
            )
        worker_index, worker_count, worker_port_base = 0, 1, 0
    else:
        worker_index, worker_count, worker_port_base = wid
    worker_siblings = (
        workermod.sibling_peers(worker_index, worker_count, worker_port_base)
        if worker_count > 1
        else []
    )
    # the node's device, resolved in a serving process only (the pool's
    # supervisor above never touches CUDA): the card unless
    # MINIO_TPU_TORCH_DEVICE or MINIO_TPU_BACKEND asks for another rung. A
    # host without a card refuses to start here, before any bootstrap retry.
    from ..erasure import coder as codermod

    if not codermod._use_device():
        node_device = "host (MINIO_TPU_BACKEND=numpy)"
    else:
        from .. import device as devmod

        try:
            node_device = str(devmod.resolve())
        except RuntimeError as e:
            raise SystemExit(str(e)) from None
    print(f"device: {node_device}", flush=True)

    # TLS: certs-dir with a keypair turns on https + wss everywhere, with
    # in-place hot reload (reference cmd/common-main.go:942 getTLSConfig)
    from ..crypto import tlsconf

    cert_mgr = None
    if args.certs_dir:
        have_cert = os.path.isfile(os.path.join(args.certs_dir, tlsconf.CERT_FILE))
        have_key = os.path.isfile(os.path.join(args.certs_dir, tlsconf.KEY_FILE))
        if have_cert and have_key:
            cert_mgr = tlsconf.GLOBAL.enable(args.certs_dir)
        elif have_cert or have_key:
            # half a keypair is a misconfiguration, not a plain-HTTP
            # deployment; refuse rather than silently serving cleartext
            raise SystemExit(
                f"certs-dir {args.certs_dir}: need BOTH {tlsconf.CERT_FILE} "
                f"and {tlsconf.KEY_FILE} (found only one)"
            )
        else:
            print(
                f"certs-dir {args.certs_dir}: no {tlsconf.CERT_FILE}/"
                f"{tlsconf.KEY_FILE}; serving plain HTTP", flush=True,
            )

    root_user = os.environ.get("MINIO_ROOT_USER", "minioadmin")
    root_pass = os.environ.get("MINIO_ROOT_PASSWORD", "minioadmin")
    token = internode_token(root_user, root_pass)

    all_eps = parse_endpoints(
        [p for spec in args.drives for p in ellipses.expand(spec)], my_port
    )
    peers = remote_nodes(all_eps)
    distributed = bool(peers)

    registry: dict[int, XLStorage] = {}
    local_locker = LocalLocker()
    # sibling workers are lock peers: a write lock needs a quorum of ALL
    # workers' tables (n/2+1), so two workers mutating the same object
    # serialize exactly like two cluster nodes would (dsync semantics,
    # jittered-retry tie-break and all)
    lockers = [local_locker] + [
        _RemoteLocker(n.split(":")[0], int(n.split(":")[1]), token)
        for n in (*worker_siblings, *peers)
    ]
    ns_lock = NamespaceLock(lockers)

    srv = S3Server(None)
    # cluster peers + sibling workers, for admin/trace/profile fan-out
    # (a worker is just another peer for those planes)
    srv.peers = worker_siblings + peers
    srv.worker_index = worker_index
    srv.worker_count = worker_count
    srv.worker_peers = worker_siblings
    srv.worker_port_base = worker_port_base
    # continuous wall-time attribution (knob-gated, ~19 Hz): scraped as
    # the /api/diag attribution series; None when MINIO_TPU_PROFILE_CONTINUOUS=0
    from . import profiling as _profiling

    srv.cprofiler = _profiling.start_continuous_from_env()
    from ..cluster.grid import GridServer

    storage_srv = StorageRESTServer(registry, token)
    lock_srv = LockRESTServer(local_locker, token)
    storage_srv.register(srv.app)
    lock_srv.register(srv.app)
    # muxed internode RPC: small storage ops + lock ops share one
    # websocket per (peer, plane); HTTP routes above stay as fallback
    grid = GridServer(token)
    storage_srv.register_grid(grid)
    lock_srv.register_grid(grid)
    # cache-invalidation broadcasts ride the same muxed storage plane
    from ..cache import coherence as cache_coherence

    cache_coherence.register_grid(grid)
    # sibling workers receive the same synchronous invalidation
    # broadcasts cluster peers do: a PUT on worker A drops the object
    # from B's and C's caches before the client sees its 200 (loopback
    # siblings get a tighter deadline — a crashed worker must not cost
    # every mutation the cross-node timeout while it restarts)
    cache_coherence.configure(
        worker_siblings + peers, token, worker_peers=worker_siblings
    )
    # netperf echoes ride the same muxed storage plane; the loopback row
    # (this node calling itself over the grid) is the stack floor every
    # peer row is read against
    from ..diag import netperf as diag_netperf

    diag_netperf.register_grid(grid)
    diag_netperf.configure(
        worker_siblings + peers, token, self_addr=f"127.0.0.1:{my_port}"
    )
    grid.register(srv.app)
    from ..cluster import bootstrap as bootmod

    my_syscfg = bootmod.system_config(sorted(str(e) for e in all_eps), salt=token)
    bootmod.BootstrapRESTServer(my_syscfg, token).register(srv.app)

    async def bootstrap():
        import asyncio

        loop = asyncio.get_running_loop()

        def build():
            # in a worker pool only worker 0 may mint a fresh format.json
            # (the others retry below until the layout exists on disk)
            return make_object_layer(
                args.drives, args.set_size, my_port, token, registry, ns_lock,
                allow_mint=None if worker_count == 1 else worker_index == 0,
            )

        if peers:
            # cross-node config consistency check (reference
            # cmd/bootstrap-peer-server.go verifyServerSystemConfig):
            # catches divergent drive lists / MINIO_* env before serving
            problems = await loop.run_in_executor(
                None, bootmod.verify_peers, my_syscfg, peers, token
            )
            for p in problems:
                print(f"bootstrap config check: {p}", flush=True)

        last = None
        for _ in range(180):
            try:
                store = await loop.run_in_executor(None, build)
                # set_store does storage IO (IAM/bucket-config loads, incl.
                # remote RPC) — keep it off the event loop, which must stay
                # responsive for peers' storage/lock RPCs
                await loop.run_in_executor(None, srv.set_store, store)
                print(
                    f"object layer online: {len(store.pools)} pool(s), "
                    f"{len(store.disks)} drives, distributed={distributed}",
                    flush=True,
                )
                return
            except asyncio.CancelledError:
                raise  # server shutdown mid-bootstrap
            except Exception as e:  # noqa: BLE001 — peers may still be booting
                last = e
                await asyncio.sleep(1)
        print(f"bootstrap failed: {last}", flush=True)
        os._exit(1)  # a task-level SystemExit would leave run_app serving 503s

    async def on_start(app):
        # background task: peers bootstrap against each other's storage
        # RPC, so the listener must come up FIRST (on_startup blocks it)
        import asyncio

        async def boot_then_gateways():
            await bootstrap()
            # gateway ports don't SO_REUSEPORT: in a pool only worker 0
            # binds them (a second binder would EADDRINUSE-crash, and
            # the supervisor's crash budget would take the whole pool
            # down over a gateway flag)
            if worker_index > 0 and (args.ftp or args.sftp):
                print(
                    f"worker {worker_index}: FTP/SFTP gateways served by "
                    "worker 0 only", flush=True,
                )
                return
            if args.ftp:
                from .ftp import FTPGateway

                await FTPGateway(srv).serve(host or "0.0.0.0", args.ftp)
                print(f"FTP gateway on port {args.ftp}", flush=True)
            if args.sftp:
                from .sftp import SFTPGateway, load_authorized_keys

                SFTPGateway(
                    srv,
                    authorized_keys=load_authorized_keys(
                        os.environ.get("MINIO_SFTP_AUTHORIZED_KEYS")
                    ),
                ).listen(host or "0.0.0.0", args.sftp)
                print(f"SFTP gateway on port {args.sftp}", flush=True)

        app["bootstrap"] = asyncio.create_task(boot_then_gateways())

        if sanitizer.enabled():
            # stall watchdog on the serving loop: blocking work that the
            # static blocking-reachable pass could not name shows up as
            # obs `type=sanitizer` loop.stall records with the stack
            app["sanitize_watchdog"] = sanitizer.watch_loop(
                asyncio.get_running_loop()
            )
            # access witness: every serving module is imported by now,
            # so the cross-context attributes CONCURRENCY.md names
            # (static races pass) get their touch-recording descriptors
            armed = sanitizer.arm_access_witness()
            if armed:
                print(
                    f"sanitizer: access witness armed on {armed} "
                    "attributes", flush=True,
                )
            # leak witness: resource classes from the static ownership
            # table (RESOURCES.md) get weakref finalizers — a
            # handle collected unreleased reports `resource.leak`
            leak_armed = sanitizer.arm_leak_witness()
            if leak_armed:
                print(
                    f"sanitizer: leak witness armed on {leak_armed} "
                    "resource classes", flush=True,
                )

    async def on_stop(app):
        wd = app.get("sanitize_watchdog")
        if wd is not None:
            wd.stop()

    srv.app.on_startup.append(on_start)
    srv.app.on_cleanup.append(on_stop)
    # explicit runner: read_bufsize lifts the front's 64 KiB StreamReader
    # watermark, which otherwise pause/resumes the transport 16x per MiB on
    # large streaming PUTs
    import asyncio as _asyncio
    import signal as _signal

    async def _serve():
        runner = web.AppRunner(
            srv.app, read_bufsize=int(
                os.environ.get("MINIO_TPU_HTTP_READBUF", str(4 << 20))
            ),
        )
        await runner.setup()
        site = web.TCPSite(
            runner, host or "0.0.0.0", my_port,
            ssl_context=cert_mgr.ctx if cert_mgr else None,
            # worker pool: every worker binds the SAME port; the kernel
            # load-balances accepted connections across them
            reuse_port=True if worker_count > 1 else None,
        )
        await site.start()
        if worker_count > 1:
            # per-worker loopback control listener: SO_REUSEPORT makes
            # the shared port land on an ARBITRARY worker, so siblings
            # (coherence broadcasts, lock RPCs, admin/metrics fan-out)
            # address each worker here. Same app, same auth.
            ctrl = web.TCPSite(
                runner, "127.0.0.1",
                workermod.control_port(worker_port_base, worker_index),
                ssl_context=cert_mgr.ctx if cert_mgr else None,
            )
            await ctrl.start()
            print(
                f"worker {worker_index}/{worker_count} serving "
                f"{args.address} (shared), control port "
                f"{workermod.control_port(worker_port_base, worker_index)}",
                flush=True,
            )
        cert_watcher = None
        if cert_mgr is not None:
            print(f"serving https on {args.address}", flush=True)

            async def _watch_certs():
                while True:
                    await _asyncio.sleep(2.0)
                    if cert_mgr.maybe_reload(min_interval=0.0):
                        # internode dialers must re-anchor trust too when
                        # the deployment pins the shared public.crt
                        tlsconf.GLOBAL.refresh_client_context()
                        print("TLS certificate reloaded", flush=True)

            # keep a strong reference: asyncio tasks are weakly held and
            # an unreferenced watcher would be GC-collected mid-flight
            cert_watcher = _asyncio.get_running_loop().create_task(
                _watch_certs()
            )
        stop = _asyncio.Event()
        loop = _asyncio.get_running_loop()
        for sig in (_signal.SIGINT, _signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:  # non-unix
                pass
        await stop.wait()
        if cert_watcher is not None:
            cert_watcher.cancel()
        # teardown order matters: stop the background planes FIRST (the
        # scanner/heal threads broadcast invalidations, which would
        # re-dial the grid right after we close it), THEN close our
        # OUTGOING grid connections — the sibling/peer server holds a
        # parked websocket handler per connection and its graceful drain
        # waits for ours to close (two pool workers stopping together
        # would otherwise stall each other's cleanup for the full
        # shutdown timeout; the supervisor's SIGKILL grace is the
        # backstop for a mid-sweep straggler that re-dials anyway)
        srv.close()  # stop IAM refresh/watch + scanner threads
        from ..cluster import grid as gridmod

        gridmod.close_shared_clients()
        await runner.cleanup()  # close listeners, drain in-flight requests

    try:
        _asyncio.run(_serve())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
