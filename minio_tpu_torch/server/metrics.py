"""Prometheus metrics + request tracing pubsub.

Mirrors the reference's observability plane: metrics v2/v3 endpoints
(MinIO cmd/metrics-v2.go, metrics-v3*.go) exposing request,
storage, heal, and usage series in Prometheus text format; and the
zero-cost-when-idle trace pubsub behind `mc admin trace`
(MinIO cmd/http-tracer.go + internal/pubsub).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict


MAX_BUCKET_SERIES = 1000  # bound per-bucket label cardinality


# TTFB distribution buckets, matching the reference's
# minio_api_requests_ttfb_seconds_distribution edges (cmd/metrics-v3-api.go)
TTFB_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def ttfb_distribution_rows(hist: dict[str, list[int]]):
    """Cumulative (api, le, count) rows — single source for the v2 and v3
    expositions so the bucket edges and le formatting cannot diverge."""
    for api, h in sorted(hist.items()):
        cum = 0
        for i, edge in enumerate(TTFB_BUCKETS):
            cum += h[i]
            yield api, str(edge), cum
        yield api, "+Inf", cum + h[-1]


class Metrics:
    def __init__(self):
        self._mu = threading.Lock()
        self.requests_total: dict[str, int] = defaultdict(int)  # by api
        self.errors_total: dict[str, int] = defaultdict(int)  # by api
        self.errors_4xx: int = 0
        self.errors_5xx: int = 0
        self.rejected_auth: int = 0  # 401/403: failed authentication/authz
        self.rejected_invalid: int = 0  # 400: malformed requests
        self.rejected_header: int = 0  # malformed Authorization header
        self.rejected_timestamp: int = 0  # x-amz-date outside the skew window
        self.canceled: int = 0  # client went away mid-request
        self.rx_bytes = 0
        self.tx_bytes = 0
        self.request_seconds: dict[str, float] = defaultdict(float)
        # TTFB kept separate from full-request duration: a streamed 10s
        # GET with 20ms TTFB must not skew the TTFB sum
        self.ttfb_seconds: dict[str, float] = defaultdict(float)
        self.ttfb_hist: dict[str, list[int]] = {}  # api -> bucket counts+[+Inf]
        self.inflight = 0
        # per-bucket: bucket -> api -> [requests, errors, rx, tx]
        self.bucket_api: dict[str, dict[str, list]] = {}

    def observe(
        self, api: str, status: int, dur: float, rx: int, tx: int,
        bucket: str = "", ttfb: float | None = None,
    ) -> None:
        with self._mu:
            self.requests_total[api] += 1
            self.request_seconds[api] += dur
            self.rx_bytes += rx
            self.tx_bytes += tx
            h = self.ttfb_hist.get(api)
            if h is None:
                h = self.ttfb_hist[api] = [0] * (len(TTFB_BUCKETS) + 1)
            t = dur if ttfb is None else ttfb
            self.ttfb_seconds[api] += t
            for i, edge in enumerate(TTFB_BUCKETS):
                if t <= edge:
                    h[i] += 1
                    break
            else:
                h[-1] += 1
            err = status >= 400
            if status in (401, 403):
                self.rejected_auth += 1
            elif status == 400:
                self.rejected_invalid += 1
            if status >= 500:
                self.errors_5xx += 1
                self.errors_total[api] += 1
            elif err:
                self.errors_total[api] += 1
                self.errors_4xx += 1
            # series creation rules: never for the /minio/* pseudo-bucket
            # or system paths, and never for a FAILED request on an
            # untracked name — otherwise an unauthenticated scanner
            # walking random paths would mint junk series up to the cap
            # and real buckets could never register
            if (
                bucket
                and bucket != "minio"
                and not bucket.startswith(".minio.sys")
                and (bucket in self.bucket_api or not err)
                and (
                    bucket in self.bucket_api
                    or len(self.bucket_api) < MAX_BUCKET_SERIES
                )
            ):
                rec = self.bucket_api.setdefault(bucket, {}).setdefault(
                    api, [0, 0, 0, 0]
                )
                rec[0] += 1
                rec[1] += 1 if err else 0
                rec[2] += rx
                rec[3] += tx

    def render(self, server) -> str:
        """Prometheus text exposition for the cluster endpoint."""
        lines = [
            "# HELP minio_s3_requests_total Total S3 requests by API.",
            "# TYPE minio_s3_requests_total counter",
        ]
        with self._mu:
            for api, n in sorted(self.requests_total.items()):
                lines.append(f'minio_s3_requests_total{{api="{api}"}} {n}')
            lines += [
                "# TYPE minio_s3_requests_errors_total counter",
            ]
            for api, n in sorted(self.errors_total.items()):
                lines.append(f'minio_s3_requests_errors_total{{api="{api}"}} {n}')
            lines += [
                "# TYPE minio_s3_requests_4xx_errors_total counter",
                f"minio_s3_requests_4xx_errors_total {self.errors_4xx}",
                "# TYPE minio_s3_requests_5xx_errors_total counter",
                f"minio_s3_requests_5xx_errors_total {self.errors_5xx}",
                "# TYPE minio_s3_traffic_received_bytes counter",
                f"minio_s3_traffic_received_bytes {self.rx_bytes}",
                "# TYPE minio_s3_traffic_sent_bytes counter",
                f"minio_s3_traffic_sent_bytes {self.tx_bytes}",
                "# TYPE minio_s3_requests_rejected_auth_total counter",
                f"minio_s3_requests_rejected_auth_total {self.rejected_auth}",
                "# TYPE minio_s3_requests_rejected_invalid_total counter",
                f"minio_s3_requests_rejected_invalid_total {self.rejected_invalid}",
                "# TYPE minio_s3_requests_inflight_total gauge",
                f"minio_s3_requests_inflight_total {self.inflight}",
                "# TYPE minio_s3_request_seconds_total counter",
            ]
            for api, s in sorted(self.request_seconds.items()):
                lines.append(f'minio_s3_request_seconds_total{{api="{api}"}} {s:.6f}')
            lines.append("# TYPE minio_s3_ttfb_seconds_distribution counter")
            for api, le, cum in ttfb_distribution_rows(self.ttfb_hist):
                lines.append(
                    f'minio_s3_ttfb_seconds_distribution{{api="{api}",le="{le}"}} {cum}'
                )
        # storage series
        store = server.store
        if store is not None:
            online, offline, total_b, free_b = 0, 0, 0, 0
            for d in store.disks:
                try:
                    di = d.disk_info()
                    online += 1
                    total_b += di.total
                    free_b += di.free
                except Exception:  # noqa: BLE001
                    offline += 1
            lines += [
                "# TYPE minio_cluster_drive_online_total gauge",
                f"minio_cluster_drive_online_total {online}",
                "# TYPE minio_cluster_drive_offline_total gauge",
                f"minio_cluster_drive_offline_total {offline}",
                "# TYPE minio_cluster_capacity_raw_total_bytes gauge",
                f"minio_cluster_capacity_raw_total_bytes {total_b}",
                "# TYPE minio_cluster_capacity_raw_free_bytes gauge",
                f"minio_cluster_capacity_raw_free_bytes {free_b}",
            ]
        bg = getattr(server, "background", None)
        if bg is not None:
            lines += [
                "# TYPE minio_heal_objects_healed_total counter",
                f"minio_heal_objects_healed_total {bg.stats['heals_done']}",
                "# TYPE minio_heal_objects_queued_total counter",
                f"minio_heal_objects_queued_total {bg.stats['heals_queued']}",
                "# TYPE minio_heal_objects_errors_total counter",
                f"minio_heal_objects_errors_total {bg.stats['heals_failed']}",
                "# TYPE minio_scanner_objects_scanned_total counter",
                f"minio_scanner_objects_scanned_total {bg.stats['objects_scanned']}",
                "# TYPE minio_bucket_usage_total_bytes gauge",
            ]
            for b, u in sorted(bg.usage.buckets.items()):
                eb = _esc_label(b)
                lines.append(f'minio_bucket_usage_total_bytes{{bucket="{eb}"}} {u["size"]}')
                lines.append(
                    f'minio_bucket_usage_object_total{{bucket="{eb}"}} {u["objects"]}'
                )
        lines += [
            "# TYPE minio_node_uptime_seconds gauge",
            f"minio_node_uptime_seconds {time.time() - server.started_at:.0f}",
        ]
        return "\n".join(lines) + "\n"


class TraceSub:
    """One trace subscriber: bounded queue + optional server-side filter
    + drop accounting (a slow consumer loses records, visibly)."""

    __slots__ = ("q", "filter", "dropped", "label")

    def __init__(self, maxsize: int, filter=None, label: str = ""):
        import queue

        self.q = queue.Queue(maxsize=maxsize)
        self.filter = filter
        self.dropped = 0
        self.label = label


class TracePubSub:
    """Fan-out of request trace records; zero-cost with no subscribers
    (the reference checks NumSubscribers before building the record).
    Subscriber filters run at publish time so filtered-out records never
    consume queue space; per-subscriber drops are counted, not silent.

    ``ring``: an optional ``obs.SpanRing`` that keeps the newest closed
    spans in memory whether or not anyone subscribes (the server's is
    ``span_ring()``); a bare pubsub has none."""

    def __init__(self, ring=None):
        self._mu = threading.Lock()
        self._subs: list[TraceSub] = []
        self.dropped_total = 0
        self.ring = ring

    @property
    def active(self) -> bool:
        return bool(self._subs)

    def subscribe(self, filter=None, label: str = "") -> TraceSub:
        maxsize = int(os.environ.get("MINIO_TPU_TRACE_BUFFER", "1000") or 1000)
        sub = TraceSub(maxsize, filter=filter, label=label)
        with self._mu:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: TraceSub) -> None:
        with self._mu:
            if sub in self._subs:
                self._subs.remove(sub)

    def publish(self, record: dict) -> None:
        with self._mu:
            subs = list(self._subs)
        for sub in subs:
            if sub.filter is not None and not sub.filter.match(record):
                continue
            try:
                sub.q.put_nowait(record)
            except Exception:  # noqa: BLE001 — slow subscriber drops records
                # publish() runs on whatever thread produced the record
                # (handlers, dispatcher, watchdog): the drop counters are
                # load/add/store interleaves without the lock (miniovet
                # races pass)
                with self._mu:
                    sub.dropped += 1
                    self.dropped_total += 1

    def subscriber_stats(self) -> list[dict]:
        with self._mu:
            return [
                {"label": s.label or f"sub-{i}", "dropped": s.dropped,
                 "queued": s.q.qsize()}
                for i, s in enumerate(self._subs)
            ]


def span_ring():
    """The server's span ring: ``MINIO_TPU_TRACE_RING`` spans (default
    262,144); 0 turns it off (None)."""
    from ..obs import SpanRing

    try:
        cap = int(os.environ.get("MINIO_TPU_TRACE_RING", "262144") or 0)
    except ValueError:
        cap = 262144
    return SpanRing(cap) if cap > 0 else None


def trace_record(
    request, status: int, dur: float, rx: int, tx: int,
    req_id: str = "", api: str = "",
) -> dict:
    from .. import obs

    return {
        "time": time.time(),
        "type": "s3",
        "name": api or request.method,
        "reqId": req_id,
        "node": obs.trace.NODE,
        "method": request.method,
        "path": request.path,
        "query": request.rel_url.raw_query_string,
        "statusCode": status,
        "error": "" if status < 400 else f"HTTP {status}",
        "durationNs": int(dur * 1e9),
        "rx": rx,
        "tx": tx,
        "remote": request.remote or "",
    }


def classify_api(method: str, bucket: str, key: str, query) -> str:
    """Request -> metrics API label (coarse version of the reference's
    api names in cmd/metrics-v2.go)."""
    if not bucket:
        return "ListBuckets" if method == "GET" else "STS"
    if not key:
        if method == "GET":
            if "versions" in query:
                return "ListObjectVersions"
            return "ListObjectsV2" if query.get("list-type") == "2" else "ListObjectsV1"
        return {
            "PUT": "PutBucket", "DELETE": "DeleteBucket", "HEAD": "HeadBucket",
            "POST": "DeleteMultipleObjects",
        }.get(method, method)
    if "uploadId" in query or "uploads" in query:
        return "Multipart"
    return {
        "GET": "GetObject", "PUT": "PutObject", "HEAD": "HeadObject",
        "DELETE": "DeleteObject", "POST": "PostObject",
    }.get(method, method)


def dump_json(obj) -> bytes:
    return json.dumps(obj).encode()


# -- metrics v3: grouped registry with path filtering ------------------------
#
# Mirrors MinIO cmd/metrics-v3.go: each collector path under
# /minio/metrics/v3 returns one group; /bucket/* paths take a bucket name
# suffix. GET /minio/metrics/v3 (no path) concatenates every non-bucket
# group, /minio/metrics/v3/cluster/... serves one subtree, etc.


def _esc_label(v) -> str:
    """Prometheus text-format label-value escaping (backslash, double
    quote, newline). Bucket/drive/rule labels carry user-chosen names —
    a bucket called `a"b` must not produce an unparseable line."""
    s = str(v)
    if "\\" in s or '"' in s or "\n" in s:
        s = s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return s


def _fmt(lines: list[str], name: str, mtype: str, values, help_: str = "") -> None:
    if help_:
        lines.append(f"# HELP {name} {help_}")
    lines.append(f"# TYPE {name} {mtype}")
    for labels, v in values:
        if labels:
            lab = ",".join(
                f'{k}="{_esc_label(v2)}"' for k, v2 in labels.items()
            )
            lines.append(f"{name}{{{lab}}} {v}")
        else:
            lines.append(f"{name} {v}")


def _g_api_requests(server) -> list[str]:
    m = server.metrics
    out: list[str] = []
    with m._mu:
        _fmt(out, "minio_api_requests_total", "counter",
             [({"name": a}, n) for a, n in sorted(m.requests_total.items())],
             "Total requests by API")
        _fmt(out, "minio_api_requests_errors_total", "counter",
             [({"name": a}, n) for a, n in sorted(m.errors_total.items())])
        _fmt(out, "minio_api_requests_4xx_errors_total", "counter", [({}, m.errors_4xx)])
        _fmt(out, "minio_api_requests_5xx_errors_total", "counter", [({}, m.errors_5xx)])
        _fmt(out, "minio_api_requests_incoming_bytes_total", "counter", [({}, m.rx_bytes)])
        _fmt(out, "minio_api_requests_outgoing_bytes_total", "counter", [({}, m.tx_bytes)])
        _fmt(out, "minio_api_requests_ttfb_seconds_total", "counter",
             [({"name": a}, f"{s:.6f}") for a, s in sorted(m.ttfb_seconds.items())])
        _fmt(out, "minio_api_requests_duration_seconds_total", "counter",
             [({"name": a}, f"{s:.6f}") for a, s in sorted(m.request_seconds.items())])
        _fmt(out, "minio_api_requests_inflight_total", "gauge", [({}, m.inflight)])
        _fmt(out, "minio_api_requests_rejected_auth_total", "counter",
             [({}, m.rejected_auth)])
        _fmt(out, "minio_api_requests_rejected_invalid_total", "counter",
             [({}, m.rejected_invalid)])
        _fmt(out, "minio_api_requests_rejected_header_total", "counter",
             [({}, m.rejected_header)],
             "Requests rejected for a malformed Authorization header")
        _fmt(out, "minio_api_requests_rejected_timestamp_total", "counter",
             [({}, m.rejected_timestamp)],
             "Requests rejected for a skewed x-amz-date")
        _fmt(out, "minio_api_requests_canceled_total", "counter",
             [({}, m.canceled)],
             "Requests abandoned by the client before the response")
        _fmt(out, "minio_api_requests_ttfb_seconds_distribution", "counter",
             [({"name": a, "le": le}, cum)
              for a, le, cum in ttfb_distribution_rows(m.ttfb_hist)])
    # QoS admission waits live outside the metrics mutex (qos/admission
    # keeps its own): the reference's waiting_total is the deadline queue
    qos = getattr(server, "qos", None)
    waiting = 0
    if qos is not None:
        waiting = sum(
            s["waiting"] for s in qos.admission.snapshot().values()
        )
    _fmt(out, "minio_api_requests_waiting_total", "gauge", [({}, waiting)],
         "Requests parked on QoS admission across classes")
    return out


def _g_bucket_api(server, bucket: str) -> list[str]:
    m = server.metrics
    out: list[str] = []
    with m._mu:
        apis = m.bucket_api.get(bucket, {})
        _fmt(out, "minio_bucket_api_traffic_received_bytes", "counter",
             [({"bucket": bucket, "name": a}, r[2]) for a, r in sorted(apis.items())])
        _fmt(out, "minio_bucket_api_traffic_sent_bytes", "counter",
             [({"bucket": bucket, "name": a}, r[3]) for a, r in sorted(apis.items())])
        _fmt(out, "minio_bucket_api_requests_total", "counter",
             [({"bucket": bucket, "name": a}, r[0]) for a, r in sorted(apis.items())])
        _fmt(out, "minio_bucket_api_requests_errors_total", "counter",
             [({"bucket": bucket, "name": a}, r[1]) for a, r in sorted(apis.items())])
    return out


def _g_bucket_replication(server, bucket: str) -> list[str]:
    out: list[str] = []
    repl = getattr(server, "replication", None)
    st = (
        dict(repl.bucket_stats.get(bucket, {})) if repl is not None else {}
    )
    _fmt(out, "minio_bucket_replication_total", "counter",
         [({"bucket": bucket}, st.get("replicated", 0))])
    _fmt(out, "minio_bucket_replication_failed_total", "counter",
         [({"bucket": bucket}, st.get("failed", 0))])
    _fmt(out, "minio_bucket_replication_deletes_total", "counter",
         [({"bucket": bucket}, st.get("deletes", 0))])
    return out


_DRIVE_PROBE_TTL = 5.0


def _probe_drives(server) -> dict:
    """One disk_info() sweep shared by every group in a render window —
    in distributed mode each probe of a remote drive is a storage-REST
    RPC, so per-group probing would triple the scrape cost."""
    m = server.metrics
    now = time.monotonic()
    cached = getattr(m, "_drive_probe", None)
    if cached is not None and now - cached[0] < _DRIVE_PROBE_TTL:
        return cached[1]
    per_drive = []
    by_id: dict[int, bool] = {}
    for d in server.store.disks:
        path = getattr(d, "path", getattr(d, "endpoint", "?"))
        try:
            di = d.disk_info()
            per_drive.append({
                "drive": str(path), "total": di.total, "free": di.free,
                "used": di.used or max(di.total - di.free, 0),
                "used_inodes": di.used_inodes,
                "free_inodes": di.free_inodes,
                "healing": 1 if di.healing else 0, "online": 1,
            })
            by_id[id(d)] = True
        except Exception:  # noqa: BLE001
            per_drive.append({
                "drive": str(path), "total": 0, "free": 0, "used": 0,
                "used_inodes": 0, "free_inodes": 0, "healing": 0,
                "online": 0,
            })
            by_id[id(d)] = False
    res = {
        "per_drive": per_drive,
        "online": sum(r["online"] for r in per_drive),
        "offline": sum(1 for r in per_drive if not r["online"]),
        "healing": sum(r["healing"] for r in per_drive),
        "total_bytes": sum(r["total"] for r in per_drive),
        "free_bytes": sum(r["free"] for r in per_drive),
        "by_id": by_id,
    }
    m._drive_probe = (now, res)
    return res


def _g_system_drive(server) -> list[str]:
    from ..storage.health import HealthCheckedDisk

    out: list[str] = []
    pr = _probe_drives(server)
    per_drive = pr["per_drive"]
    _fmt(out, "minio_system_drive_total_bytes", "gauge",
         [({"drive": r["drive"]}, r["total"]) for r in per_drive])
    _fmt(out, "minio_system_drive_used_bytes", "gauge",
         [({"drive": r["drive"]}, r["used"]) for r in per_drive])
    _fmt(out, "minio_system_drive_free_bytes", "gauge",
         [({"drive": r["drive"]}, r["free"]) for r in per_drive])
    _fmt(out, "minio_system_drive_used_inodes", "gauge",
         [({"drive": r["drive"]}, r["used_inodes"]) for r in per_drive])
    _fmt(out, "minio_system_drive_free_inodes", "gauge",
         [({"drive": r["drive"]}, r["free_inodes"]) for r in per_drive])
    _fmt(out, "minio_system_drive_total_inodes", "gauge",
         [({"drive": r["drive"]},
           r["used_inodes"] + r["free_inodes"]) for r in per_drive])
    _fmt(out, "minio_system_drive_online", "gauge",
         [({"drive": r["drive"]}, r["online"]) for r in per_drive])
    _fmt(out, "minio_system_drive_health", "gauge",
         [({"drive": r["drive"]}, r["online"]) for r in per_drive],
         "1 when the drive answers storage calls (breaker closed)")
    _fmt(out, "minio_system_drive_count", "gauge",
         [({"state": "online"}, pr["online"]), ({"state": "offline"}, pr["offline"])])
    _fmt(out, "minio_system_drive_online_count", "gauge", [({}, pr["online"])])
    _fmt(out, "minio_system_drive_offline_count", "gauge", [({}, pr["offline"])])
    _fmt(out, "minio_system_drive_healing_count", "gauge", [({}, pr["healing"])])
    _fmt(out, "minio_system_drive_raw_total_bytes", "gauge", [({}, pr["total_bytes"])])
    _fmt(out, "minio_system_drive_raw_free_bytes", "gauge", [({}, pr["free_bytes"])])
    # breaker-classified error counters (HealthCheckedDisk): timeouts vs
    # any availability fault — the reference's drive error split
    t_rows, a_rows = [], []
    for d in server.store.disks:
        if not isinstance(d, HealthCheckedDisk):
            continue
        ep = str(getattr(d, "endpoint", "?"))
        t_rows.append(({"drive": ep}, d.timeout_faults))
        a_rows.append(({"drive": ep}, d.total_faults))
    _fmt(out, "minio_system_drive_timeout_errors_total", "counter", t_rows,
         "Storage calls that failed with a timeout, per drive")
    _fmt(out, "minio_system_drive_availability_errors_total", "counter",
         a_rows, "Storage calls that failed for any transport reason")
    return out


def _proc_stat() -> dict:
    out = {}
    try:
        with open("/proc/self/stat") as f:
            raw = f.read()
        # comm may contain spaces: fields restart after the last ')'
        parts = raw[raw.rindex(")") + 2 :].split()
        tck = float(os.sysconf("SC_CLK_TCK") or 100)
        page = os.sysconf("SC_PAGE_SIZE") or 4096
        # parts[0] is field 3 (state); utime is field 14 -> index 11
        out["utime_s"] = int(parts[11]) / tck
        out["stime_s"] = int(parts[12]) / tck
        out["threads"] = int(parts[17])
        out["vsize"] = int(parts[20])
        out["rss_bytes"] = int(parts[21]) * page
    except (OSError, IndexError, ValueError):
        pass
    try:
        out["fds"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    try:
        import resource

        out["fd_limit"] = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    except (ImportError, OSError, ValueError):
        pass
    try:
        with open("/proc/self/io") as f:
            for line in f:
                k, _, v = line.partition(":")
                if k in ("rchar", "wchar"):
                    out[k] = int(v)
    except (OSError, ValueError):
        pass
    return out


def _g_system_process(server) -> list[str]:
    st = _proc_stat()
    out: list[str] = []
    _fmt(out, "minio_system_process_uptime_seconds", "gauge",
         [({}, f"{time.time() - server.started_at:.0f}")])
    _fmt(out, "minio_system_process_cpu_total_seconds", "counter",
         [({}, f"{st.get('utime_s', 0) + st.get('stime_s', 0):.2f}")])
    _fmt(out, "minio_system_process_resident_memory_bytes", "gauge",
         [({}, st.get("rss_bytes", 0))])
    _fmt(out, "minio_system_process_virtual_memory_bytes", "gauge",
         [({}, st.get("vsize", 0))])
    _fmt(out, "minio_system_process_file_descriptor_open_total", "gauge",
         [({}, st.get("fds", 0))])
    _fmt(out, "minio_system_process_file_descriptor_limit_total", "gauge",
         [({}, st.get("fd_limit", 0))])
    _fmt(out, "minio_system_process_io_rchar_bytes", "counter",
         [({}, st.get("rchar", 0))])
    _fmt(out, "minio_system_process_io_wchar_bytes", "counter",
         [({}, st.get("wchar", 0))])
    _fmt(out, "minio_system_process_threads_total", "gauge",
         [({}, st.get("threads", 0))])
    return out


def _g_system_memory(server) -> list[str]:
    out: list[str] = []
    info = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                info[k] = int(rest.split()[0]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    _fmt(out, "minio_system_memory_total_bytes", "gauge", [({}, info.get("MemTotal", 0))])
    _fmt(out, "minio_system_memory_available_bytes", "gauge",
         [({}, info.get("MemAvailable", 0))])
    _fmt(out, "minio_system_memory_free_bytes", "gauge", [({}, info.get("MemFree", 0))])
    _fmt(out, "minio_system_memory_buffers_bytes", "gauge", [({}, info.get("Buffers", 0))])
    _fmt(out, "minio_system_memory_cache_bytes", "gauge", [({}, info.get("Cached", 0))])
    _fmt(out, "minio_system_memory_shared_bytes", "gauge",
         [({}, info.get("Shmem", 0))])
    total = info.get("MemTotal", 0)
    used = max(total - info.get("MemAvailable", 0), 0)
    _fmt(out, "minio_system_memory_used_bytes", "gauge", [({}, used)])
    _fmt(out, "minio_system_memory_used_perc", "gauge",
         [({}, f"{100.0 * used / total:.2f}" if total else 0)])
    return out


def _g_system_cpu(server) -> list[str]:
    out: list[str] = []
    try:
        load1, load5, load15 = os.getloadavg()
    except OSError:
        load1 = load5 = load15 = 0.0
    _fmt(out, "minio_system_cpu_load_perc_avg", "gauge", [
        ({"interval": "1m"}, f"{load1:.2f}"),
        ({"interval": "5m"}, f"{load5:.2f}"),
        ({"interval": "15m"}, f"{load15:.2f}"),
    ])
    _fmt(out, "minio_system_cpu_load", "gauge", [({}, f"{load1:.2f}")])
    # host CPU time split since boot (/proc/stat first line, jiffies)
    jif: dict[str, int] = {}
    try:
        with open("/proc/stat") as f:
            first = f.readline().split()
        names = ("user", "nice", "system", "idle", "iowait", "irq",
                 "softirq", "steal")
        jif = dict(zip(names, (int(x) for x in first[1:])))
    except (OSError, ValueError, IndexError):
        pass
    tck = float(os.sysconf("SC_CLK_TCK") or 100)

    def j(field: str) -> str:
        return f"{jif.get(field, 0) / tck:.2f}"

    _fmt(out, "minio_system_cpu_user", "counter", [({}, j("user"))])
    _fmt(out, "minio_system_cpu_system", "counter", [({}, j("system"))])
    _fmt(out, "minio_system_cpu_idle", "counter", [({}, j("idle"))])
    _fmt(out, "minio_system_cpu_iowait", "counter", [({}, j("iowait"))])
    _fmt(out, "minio_system_cpu_nice", "counter", [({}, j("nice"))])
    _fmt(out, "minio_system_cpu_steal", "counter", [({}, j("steal"))])
    _fmt(out, "minio_system_cpu_count", "gauge", [({}, os.cpu_count() or 1)])
    return out


def _g_debug_python(server) -> list[str]:
    import gc

    out: list[str] = []
    counts = gc.get_count()
    _fmt(out, "minio_debug_python_gc_objects", "gauge",
         [({"generation": str(i)}, c) for i, c in enumerate(counts)])
    _fmt(out, "minio_debug_python_threads", "gauge",
         [({}, threading.active_count())])
    return out


def _g_cluster_health(server) -> list[str]:
    out: list[str] = []
    pr = _probe_drives(server)
    _fmt(out, "minio_cluster_health_drives_online_count", "gauge", [({}, pr["online"])])
    _fmt(out, "minio_cluster_health_drives_offline_count", "gauge", [({}, pr["offline"])])
    _fmt(out, "minio_cluster_health_drives_count", "gauge",
         [({}, pr["online"] + pr["offline"])])
    # node view: one "node" per distinct drive host (local paths collapse
    # to the local node); a node is online while ANY of its drives is
    nodes: dict[str, int] = {}
    for r in pr["per_drive"]:
        p = r["drive"]
        host = p.split("://", 1)[1].split("/", 1)[0] if "://" in p else "local"
        nodes[host] = max(nodes.get(host, 0), r["online"])
    n_on = sum(nodes.values())
    _fmt(out, "minio_cluster_health_nodes_online_count", "gauge", [({}, n_on)])
    _fmt(out, "minio_cluster_health_nodes_offline_count", "gauge",
         [({}, len(nodes) - n_on)])
    # usable capacity = raw scaled by the erasure data fraction (parity
    # shards store no user bytes)
    n_tot = d_tot = 0
    for pool in server.store.pools:
        for es in pool.sets:
            n_tot += es.n
            d_tot += es.n - es.default_parity
    frac = d_tot / n_tot if n_tot else 1.0
    _fmt(out, "minio_cluster_health_capacity_raw_total_bytes", "gauge",
         [({}, pr["total_bytes"])])
    _fmt(out, "minio_cluster_health_capacity_raw_free_bytes", "gauge",
         [({}, pr["free_bytes"])])
    _fmt(out, "minio_cluster_health_capacity_usable_total_bytes", "gauge",
         [({}, int(pr["total_bytes"] * frac))])
    _fmt(out, "minio_cluster_health_capacity_usable_free_bytes", "gauge",
         [({}, int(pr["free_bytes"] * frac))])
    _fmt(out, "minio_cluster_health_status", "gauge",
         [({}, 1 if pr["offline"] == 0 else 0)], "1 when every drive is online")
    return out


def _g_cluster_usage(server) -> list[str]:
    out: list[str] = []
    bg = getattr(server, "background", None)
    buckets = bg.usage.buckets if bg is not None else {}
    total_b = sum(u.get("size", 0) for u in buckets.values())
    total_o = sum(u.get("objects", 0) for u in buckets.values())
    _fmt(out, "minio_cluster_usage_total_bytes", "gauge", [({}, total_b)])
    _fmt(out, "minio_cluster_usage_object_total", "gauge", [({}, total_o)])
    _fmt(out, "minio_cluster_usage_buckets_total", "gauge", [({}, len(buckets))])
    return out


def _g_cluster_usage_buckets(server) -> list[str]:
    out: list[str] = []
    bg = getattr(server, "background", None)
    buckets = bg.usage.buckets if bg is not None else {}
    _fmt(out, "minio_cluster_bucket_total_bytes", "gauge",
         [({"bucket": b}, u.get("size", 0)) for b, u in sorted(buckets.items())])
    _fmt(out, "minio_cluster_bucket_object_total", "gauge",
         [({"bucket": b}, u.get("objects", 0)) for b, u in sorted(buckets.items())])
    return out


def _g_cluster_erasure_set(server) -> list[str]:
    out: list[str] = []
    rows = []
    by_id = _probe_drives(server)["by_id"]
    for pi, pool in enumerate(server.store.pools):
        for si, es in enumerate(pool.sets):
            ok = sum(1 for d in es.disks if by_id.get(id(d), False))
            rows.append((pi, si, es.n, ok, es.n - es.default_parity))
    _fmt(out, "minio_cluster_erasure_set_online_drives_count", "gauge",
         [({"pool": str(p), "set": str(s)}, ok) for p, s, _, ok, _ in rows])
    # writeQuorum = data, +1 when data == parity (cmd/erasure-object.go)
    wq = {(p, s): (d + 1 if n == 2 * d else d) for p, s, n, _, d in rows}
    _fmt(out, "minio_cluster_erasure_set_overall_write_quorum", "gauge",
         [({"pool": str(p), "set": str(s)}, wq[(p, s)])
          for p, s, _, _, _ in rows])
    _fmt(out, "minio_cluster_erasure_set_read_quorum", "gauge",
         [({"pool": str(p), "set": str(s)}, d) for p, s, _, _, d in rows])
    _fmt(out, "minio_cluster_erasure_set_write_quorum", "gauge",
         [({"pool": str(p), "set": str(s)}, wq[(p, s)])
          for p, s, _, _, _ in rows])
    # tolerance: drives this set can still lose before losing quorum
    _fmt(out, "minio_cluster_erasure_set_read_tolerance", "gauge",
         [({"pool": str(p), "set": str(s)}, max(ok - d, 0))
          for p, s, _, ok, d in rows])
    _fmt(out, "minio_cluster_erasure_set_write_tolerance", "gauge",
         [({"pool": str(p), "set": str(s)}, max(ok - wq[(p, s)], 0))
          for p, s, _, ok, _ in rows])
    _fmt(out, "minio_cluster_erasure_set_read_health", "gauge",
         [({"pool": str(p), "set": str(s)}, 1 if ok >= d else 0)
          for p, s, _, ok, d in rows])
    _fmt(out, "minio_cluster_erasure_set_write_health", "gauge",
         [({"pool": str(p), "set": str(s)}, 1 if ok >= wq[(p, s)] else 0)
          for p, s, _, ok, _ in rows])
    _fmt(out, "minio_cluster_erasure_set_healing_drives_count", "gauge",
         [({"pool": str(p), "set": str(s)}, 0) for p, s, _, _, _ in rows])
    return out


def _g_cluster_iam(server) -> list[str]:
    out: list[str] = []
    iam = server.iam
    temp = sum(1 for u in iam.users.values() if u.is_temp)
    svc = sum(1 for u in iam.users.values() if u.parent and not u.is_temp)
    _fmt(out, "minio_cluster_iam_users_total", "gauge",
         [({}, len(iam.users) - temp - svc)])
    _fmt(out, "minio_cluster_iam_groups_total", "gauge", [({}, len(iam.groups))])
    _fmt(out, "minio_cluster_iam_policies_total", "gauge", [({}, len(iam.policies))])
    _fmt(out, "minio_cluster_iam_sts_accounts_total", "gauge", [({}, temp)])
    _fmt(out, "minio_cluster_iam_svc_accounts_total", "gauge", [({}, svc)])
    return out


def _g_cluster_config(server) -> list[str]:
    out: list[str] = []
    cfg = getattr(server, "config", None)
    n = 0
    if cfg is not None:
        from .config_kv import DEFAULTS

        n = len(DEFAULTS)
    _fmt(out, "minio_cluster_config_subsystems_total", "gauge", [({}, n)])
    return out


def _bg_stat(server, key: str) -> int:
    bg = getattr(server, "background", None)
    return bg.stats.get(key, 0) if bg is not None else 0


def _g_system_network(server) -> list[str]:
    """Internode (grid + storage REST) transport counters — the analogue
    of the reference's minio_system_network_internode_* group."""
    from ..cluster import grid as gridmod

    out: list[str] = []
    st = dict(gridmod.STATS)
    _fmt(out, "minio_system_network_internode_dials_total", "counter",
         [({}, st["dials"])], "Grid connections dialed")
    _fmt(out, "minio_system_network_internode_dial_errors_total", "counter",
         [({}, st["dial_errors"])])
    _fmt(out, "minio_system_network_internode_disconnects_total", "counter",
         [({}, st["disconnects"])])
    _fmt(out, "minio_system_network_internode_sent_bytes_total", "counter",
         [({}, st["tx_bytes"])])
    _fmt(out, "minio_system_network_internode_recv_bytes_total", "counter",
         [({}, st["rx_bytes"])])
    _fmt(out, "minio_system_network_internode_calls_total", "counter",
         [({}, st["calls"])])
    _fmt(out, "minio_system_network_internode_streams_total", "counter",
         [({}, st["streams"])])
    return out


def _g_ilm(server) -> list[str]:
    out: list[str] = []
    _fmt(out, "minio_ilm_expired_objects_total", "counter",
         [({}, _bg_stat(server, "ilm_expired"))])
    _fmt(out, "minio_ilm_transitioned_objects_total", "counter",
         [({}, _bg_stat(server, "ilm_transitioned"))])
    _fmt(out, "minio_ilm_restores_expired_total", "counter",
         [({}, _bg_stat(server, "ilm_restore_expired"))])
    # orphaned warm-tier sweeps awaiting retry (reference tier journal);
    # cached count — scrapes must not pay a store read each
    try:
        from ..ilm import tier as tiermod

        entries = tiermod.journal_size(server.store)
    except Exception:  # noqa: BLE001 — scrape must not fail on store errors
        entries = 0
    _fmt(out, "minio_ilm_tier_journal_entries", "gauge", [({}, entries)])
    return out


def _g_scanner(server) -> list[str]:
    out: list[str] = []
    _fmt(out, "minio_scanner_objects_scanned_total", "counter",
         [({}, _bg_stat(server, "objects_scanned"))])
    _fmt(out, "minio_scanner_cycles_total", "counter", [({}, _bg_stat(server, "scans"))])
    _fmt(out, "minio_scanner_heals_queued_total", "counter",
         [({}, _bg_stat(server, "heals_queued"))])
    _fmt(out, "minio_scanner_heals_done_total", "counter",
         [({}, _bg_stat(server, "heals_done"))])
    _fmt(out, "minio_scanner_heals_failed_total", "counter",
         [({}, _bg_stat(server, "heals_failed"))])
    return out


def _g_replication(server) -> list[str]:
    out: list[str] = []
    repl = getattr(server, "replication", None)
    st = dict(repl.stats) if repl is not None else {}
    _fmt(out, "minio_replication_total", "counter", [({}, st.get("replicated", 0))])
    _fmt(out, "minio_replication_deletes_total", "counter", [({}, st.get("deletes", 0))])
    _fmt(out, "minio_replication_failed_total", "counter", [({}, st.get("failed", 0))])
    _fmt(out, "minio_replication_queued_total", "counter", [({}, st.get("queued", 0))])
    return out


def _g_notification(server) -> list[str]:
    out: list[str] = []
    noti = getattr(server, "notifier", None)
    st = dict(noti.stats) if noti is not None else {}
    _fmt(out, "minio_notify_events_sent_total", "counter", [({}, st.get("sent", 0))])
    _fmt(out, "minio_notify_events_failed_total", "counter", [({}, st.get("failed", 0))])
    _fmt(out, "minio_notify_events_skipped_total", "counter", [({}, st.get("dropped", 0))])
    return out


def _g_audit(server) -> list[str]:
    out: list[str] = []
    audit = getattr(server, "audit", None)
    st = dict(audit.stats) if audit is not None else {}
    _fmt(out, "minio_audit_total_messages", "counter", [({}, st.get("sent", 0))])
    _fmt(out, "minio_audit_failed_messages", "counter", [({}, st.get("failed", 0))])
    return out


def _g_api_qos(server) -> list[str]:
    """QoS plane: admission-control state per class, last-minute per-API
    latency (qos/lastminute.py ring), dynamic-timeout deadlines, and the
    TPU dispatcher's priority-lane counters. The dispatcher series are
    the wire-visible proof of the batching policy: fg/bg block totals,
    forced (anti-starvation) promotions, and the invariant witness
    ``fg_deferred_behind_bg`` (always 0 when foreground never waits
    behind background batch slots)."""
    out: list[str] = []
    qos = getattr(server, "qos", None)
    if qos is None:
        return out
    snap = qos.admission.snapshot()
    _fmt(out, "minio_api_qos_inflight", "gauge",
         [({"class": c}, s["inflight"]) for c, s in sorted(snap.items())],
         "In-flight requests per admission class")
    _fmt(out, "minio_api_qos_waiting", "gauge",
         [({"class": c}, s["waiting"]) for c, s in sorted(snap.items())])
    _fmt(out, "minio_api_qos_max_inflight", "gauge",
         [({"class": c}, s["maxInflight"]) for c, s in sorted(snap.items())])
    _fmt(out, "minio_api_qos_admitted_total", "counter",
         [({"class": c}, s["admitted"]) for c, s in sorted(snap.items())])
    _fmt(out, "minio_api_qos_rejected_total", "counter",
         [({"class": c, "reason": r}, s[k])
          for c, s in sorted(snap.items())
          for r, k in (("queue_full", "rejectedFull"),
                       ("deadline", "rejectedTimeout"))])
    lm = qos.last_minute.totals()
    _fmt(out, "minio_api_qos_last_minute_requests", "gauge",
         [({"name": a}, v["count"]) for a, v in lm.items()])
    _fmt(out, "minio_api_qos_last_minute_avg_seconds", "gauge",
         [({"name": a}, f"{v['avg_seconds']:.6f}") for a, v in lm.items()])
    _fmt(out, "minio_api_qos_last_minute_max_seconds", "gauge",
         [({"name": a}, f"{v['max_seconds']:.6f}") for a, v in lm.items()])
    _fmt(out, "minio_api_qos_last_minute_ttfb_avg_seconds", "gauge",
         [({"name": a}, f"{v['ttfb_avg_seconds']:.6f}") for a, v in lm.items()])
    from ..qos import dyntimeout

    _fmt(out, "minio_tpu_dynamic_timeout_seconds", "gauge",
         [({"name": n}, f"{v:.3f}")
          for n, v in sorted(dyntimeout.snapshot().items())])
    from ..parallel import dispatcher as dmod

    ds = dmod.aggregate_stats()
    _fmt(out, "minio_tpu_dispatch_blocks_total", "counter",
         [({"class": "foreground"}, ds.get("fg_blocks", 0)),
          ({"class": "background"}, ds.get("bg_blocks", 0))],
         "Stripe blocks dispatched per priority lane")
    _fmt(out, "minio_tpu_dispatch_bg_forced_blocks_total", "counter",
         [({}, ds.get("bg_forced", 0))])
    _fmt(out, "minio_tpu_dispatch_bg_batch_max_blocks", "gauge",
         [({}, ds.get("bg_batch_max", 0))])
    _fmt(out, "minio_tpu_dispatch_fg_deferred_behind_bg_total", "counter",
         [({}, ds.get("fg_deferred_behind_bg", 0))])
    return out


def _hist_rows(edges, hist, label_key="le"):
    """Cumulative (le, count) rows for a fixed-edge histogram list
    (len(edges)+1 buckets, last is the +Inf overflow)."""
    h = list(hist) + [0] * (len(edges) + 1 - len(hist))
    cum = 0
    rows = []
    for i, edge in enumerate(edges):
        cum += h[i]
        rows.append(({label_key: str(edge)}, cum))
    rows.append(({label_key: "+Inf"}, cum + h[len(edges)]))
    return rows


def _g_api_tpu(server) -> list[str]:
    """TPU dispatcher plane: batch occupancy, queue-wait and device-time
    histograms, host-vs-device time split, and the QoS lane counters —
    the series that let the BENCH trajectory separate dispatcher
    efficiency (host orchestration, batching) from raw kernel throughput
    (device execute time)."""
    from ..parallel import dispatcher as dmod

    out: list[str] = []
    ds = dmod.aggregate_stats()
    dispatches = ds.get("dispatches", 0)
    _fmt(out, "minio_tpu_dispatch_total", "counter", [({}, dispatches)],
         "Fused encode dispatches")
    _fmt(out, "minio_tpu_dispatch_blocks_total", "counter",
         [({"class": "foreground"}, ds.get("fg_blocks", 0)),
          ({"class": "background"}, ds.get("bg_blocks", 0))])
    _fmt(out, "minio_tpu_batch_occupancy_avg_pct", "gauge",
         [({}, f"{ds.get('occupancy_pct_sum', 0.0) / max(dispatches, 1):.2f}")],
         "Mean filled fraction of the padded dispatch bucket")
    _fmt(out, "minio_tpu_batch_max_blocks", "gauge", [({}, ds.get("max_batch", 0))])
    _fmt(out, "minio_tpu_host_seconds_total", "counter",
         [({}, f"{ds.get('host_s', 0.0):.6f}")],
         "Host-side batch assembly + fan-out time")
    _fmt(out, "minio_tpu_device_seconds_total", "counter",
         [({}, f"{ds.get('device_s', 0.0):.6f}")],
         "Device execute time (incl. transfers) per dispatch")
    _fmt(out, "minio_tpu_queue_wait_seconds_total", "counter",
         [({}, f"{ds.get('queue_wait_s', 0.0):.6f}")])
    _fmt(out, "minio_tpu_queue_wait_seconds_distribution", "counter",
         _hist_rows(dmod.QUEUE_WAIT_BUCKETS, ds.get("queue_wait_hist", [])),
         "Per-item wait from submit to dispatch start")
    _fmt(out, "minio_tpu_device_time_seconds_distribution", "counter",
         _hist_rows(dmod.DEVICE_TIME_BUCKETS, ds.get("device_time_hist", [])),
         "Per-dispatch device execute time")
    _fmt(out, "minio_tpu_fused_dispatches_total", "counter",
         [({}, ds.get("fused", 0))])
    # the hand kernels' launches in this process, as each wrapper counts
    # them (calls on CPU tensors run the plain versions and do not count)
    from ..ops import bitrot_cuda, fused_cuda, rs_cuda

    _fmt(out, "minio_tpu_kernel_launches_total", "counter",
         [({"kernel": "fused_encode_hash"}, fused_cuda.encode_launches),
          ({"kernel": "fused_decode_hash"}, fused_cuda.decode_launches),
          ({"kernel": "hh_chain"}, bitrot_cuda.launches),
          ({"kernel": "gf_apply"}, rs_cuda.launches)],
         "CUDA kernel launches by the port's wrappers")
    # the same launches by shape: each wrapper's shape key as a JSON list
    # (the items copied at once: the dispatcher's thread adds to them)
    shapes = [("fused_encode_hash" if k[0] == "encode" else "fused_decode_hash", k, n)
              for k, n in list(fused_cuda.launch_shapes.items())]
    shapes += [("hh_chain", k, n) for k, n in list(bitrot_cuda.launch_shapes.items())]
    shapes += [("gf_apply", k, n) for k, n in list(rs_cuda.launch_shapes.items())]
    _fmt(out, "minio_tpu_kernel_launch_shapes_total", "counter",
         [({"kernel": name, "shape": json.dumps(k, separators=(",", ":"))}, n)
          for name, k, n in sorted(shapes, key=repr)],
         "CUDA kernel launches by kernel and shape key")
    _fmt(out, "minio_tpu_fused_failures_total", "counter",
         [({}, ds.get("fused_failures", 0))])
    _fmt(out, "minio_tpu_dispatch_bg_forced_blocks_total", "counter",
         [({}, ds.get("bg_forced", 0))])
    _fmt(out, "minio_tpu_dispatch_fg_deferred_behind_bg_total", "counter",
         [({}, ds.get("fg_deferred_behind_bg", 0))])
    # per-code-family plane (erasure/coder.py): encode/decode volume per
    # family plus the repair-bandwidth counters — heal ingress is THE
    # number the cauchy family exists to shrink (BENCH_r09 gate)
    from ..erasure.coder import family_stats_snapshot

    fs = family_stats_snapshot()
    fams = sorted(fs)
    _fmt(out, "minio_tpu_encode_blocks_total", "counter",
         [({"family": f}, fs[f].get("encode_blocks", 0)) for f in fams],
         "Stripe blocks erasure-encoded per code family")
    _fmt(out, "minio_tpu_decode_blocks_total", "counter",
         [({"family": f}, fs[f].get("decode_blocks", 0)) for f in fams],
         "Stripe blocks reconstructed per code family")
    _fmt(out, "minio_heal_ingress_bytes_total", "counter",
         [({"family": f}, fs[f].get("heal_ingress_bytes", 0)) for f in fams],
         "Survivor bytes read into heal reconstructions per family")
    _fmt(out, "minio_tpu_degraded_ingress_bytes_total", "counter",
         [({"family": f}, fs[f].get("degraded_ingress_bytes", 0))
          for f in fams],
         "Survivor bytes fetched for degraded-GET reconstruction")
    _fmt(out, "minio_tpu_repair_partial_blocks_total", "counter",
         [({"family": f}, fs[f].get("repair_partial_blocks", 0))
          for f in fams],
         "Stripe blocks rebuilt via sub-chunk partial repair")
    from ..erasure.coder import decode_matrix_cache_snapshot

    dc = decode_matrix_cache_snapshot()
    _fmt(out, "minio_tpu_decode_matrix_cache_total", "counter",
         [({"family": f, "result": r}, dc["families"][f][k])
          for f in sorted(dc["families"])
          for r, k in (("hit", "hits"), ("miss", "misses"))],
         "Decode-matrix LRU lookups per family (per-failure-pattern "
         "inverses; ops/decode_cache)")
    _fmt(out, "minio_tpu_decode_matrix_cache_entries", "gauge",
         [({}, dc["entries"])],
         "Decode matrices resident in the LRU")
    # zero-copy data plane (erasure/bufpool.py): counted hot-path copies
    # per named site plus stripe-arena pool behaviour — the A/B surface
    # for the MINIO_TPU_ZEROCOPY lever (BENCH_r13 gates staging==0 on
    # aligned streaming PUTs against these exact series)
    from ..erasure import bufpool

    cs = bufpool.copies_snapshot()
    _fmt(out, "minio_tpu_ingest_copies_total", "counter",
         [({"site": s}, cs[s]) for s in sorted(cs)],
         "Full-buffer copies at named data-plane sites (zero at "
         "'staging' under the zero-copy plane on aligned streaming PUTs)")
    ps = bufpool.pool_stats_snapshot()
    _fmt(out, "minio_tpu_pool_acquires_total", "counter",
         [({"result": "hit"}, ps.get("hits", 0)),
          ({"result": "miss"}, ps.get("misses", 0)),
          ({"result": "unpooled"}, ps.get("unpooled", 0))],
         "Stripe-arena pool acquisitions by outcome (unpooled = size "
         "outside the pooled classes, plain allocation)")
    _fmt(out, "minio_tpu_pool_recycled_bytes_total", "counter",
         [({}, ps.get("recycled_bytes", 0))])
    _fmt(out, "minio_tpu_pool_resident_bytes", "gauge",
         [({}, ps.get("resident_bytes", 0))],
         "Recycled arena bytes resident in the pool free lists")
    _fmt(out, "minio_tpu_pool_live_leases", "gauge",
         [({}, ps.get("live_leases", 0))])
    _fmt(out, "minio_tpu_pool_lease_violations_total", "counter",
         [({}, ps.get("violations", 0))],
         "Lease-discipline violations (double-release / retain-dead); "
         "always 0 in a healthy process, sanitizer-witnessed otherwise")
    _fmt(out, "minio_tpu_dispatch_pad_blocks_total", "counter",
         [({}, ds.get("pad_blocks", 0))],
         "Zero-filled pad blocks appended to round batches up to buckets")
    _fmt(out, "minio_tpu_dispatch_arena_direct_total", "counter",
         [({}, ds.get("arena_direct", 0))],
         "Dispatches fed straight from a caller arena (exact bucket fit, "
         "no assembly copy)")
    _fmt(out, "minio_tpu_dispatch_bucket_blocks_distribution", "counter",
         _hist_rows(dmod.BUCKET_BLOCK_BUCKETS, ds.get("bucket_hist", [])),
         "Padded bucket size (blocks) per dispatch")
    return out


def _g_api_trace(server) -> list[str]:
    """Trace pubsub health: subscriber count and per-subscriber dropped
    records (publish never blocks; a slow consumer loses records and
    these series make that visible)."""
    out: list[str] = []
    tr = getattr(server, "trace", None)
    if tr is None:
        return out
    subs = tr.subscriber_stats()
    _fmt(out, "minio_trace_subscribers", "gauge", [({}, len(subs))])
    _fmt(out, "minio_trace_dropped_records_total", "counter",
         [({}, tr.dropped_total)],
         "Records dropped across all subscribers (queue full)")
    _fmt(out, "minio_trace_subscriber_dropped_records", "gauge",
         [({"subscriber": s["label"]}, s["dropped"]) for s in subs])
    _fmt(out, "minio_trace_subscriber_queued_records", "gauge",
         [({"subscriber": s["label"]}, s["queued"]) for s in subs])
    return out


def _g_api_fault(server) -> list[str]:
    """Robustness plane: armed fault-injection rules and their hits, the
    hedged-read win/loss counters (erasure/set.py GET window path), the
    latency-breaker trip count, and the TPU backend degradation ladder
    (2=fused, 1=XLA, 0=numpy) with its demote/promote transitions."""
    from .. import fault
    from ..parallel import dispatcher as dmod
    from ..storage.health import HealthCheckedDisk

    out: list[str] = []
    st = fault.status()
    c = st["counters"]
    _fmt(out, "minio_fault_rules_active", "gauge", [({}, len(st["rules"]))],
         "Armed fault-injection rules on this node")
    _fmt(out, "minio_fault_injected_total", "counter",
         [({"boundary": b}, c.get(b, 0))
          for b in ("storage", "network", "tpu", "topology", "diag")],
         "Injected fault hits per boundary")
    _fmt(out, "minio_fault_hedge_reads_total", "counter",
         [({}, c.get("hedge_reads", 0))],
         "GET windows that fired hedged parity reads past the budget")
    _fmt(out, "minio_fault_hedge_wins_total", "counter",
         [({}, c.get("hedge_wins", 0))],
         "Hedged windows where the parity decode beat the straggler")
    _fmt(out, "minio_fault_hedge_losses_total", "counter",
         [({}, c.get("hedge_losses", 0))])
    _fmt(out, "minio_fault_repair_hedge_reads_total", "counter",
         [({}, c.get("repair_hedge_reads", 0))],
         "Repair-plan windows whose sub-chunk reads blew the hedge "
         "budget and fired the generic full-frame gather as the hedge")
    _fmt(out, "minio_fault_repair_hedge_wins_total", "counter",
         [({}, c.get("repair_hedge_wins", 0))],
         "Hedged repair blocks where the full gather beat the plan")
    _fmt(out, "minio_fault_repair_hedge_losses_total", "counter",
         [({}, c.get("repair_hedge_losses", 0))])
    _fmt(out, "minio_fault_repair_fallback_blocks_total", "counter",
         [({}, c.get("repair_fallback_blocks", 0))],
         "Repair-plan blocks served by the generic full gather "
         "(hedge wins + mid-plan read failures); the plan itself "
         "is never abandoned")
    trips = 0
    for d in getattr(server.store, "disks", []):
        if isinstance(d, HealthCheckedDisk):
            trips += d.latency_trips
    _fmt(out, "minio_fault_drive_latency_trips_total", "counter",
         [({}, trips)],
         "Circuit-breaker opens caused by chronic drive latency")
    ds = dmod.aggregate_stats()
    _fmt(out, "minio_tpu_backend_level", "gauge",
         [({}, ds.get("backend_level", dmod.LEVEL_FUSED))],
         "Encode backend rung: 2=healthy, 1=fused faulted out (XLA), "
         "0=device gone (numpy)")
    _fmt(out, "minio_tpu_backend_demotions_total", "counter",
         [({}, ds.get("demotions", 0))])
    _fmt(out, "minio_tpu_backend_promotions_total", "counter",
         [({}, ds.get("promotions", 0))])
    _fmt(out, "minio_tpu_backend_device_faults_total", "counter",
         [({}, ds.get("device_faults", 0))])
    _fmt(out, "minio_tpu_backend_probe_batches_total", "counter",
         [({}, ds.get("probes", 0))])
    _fmt(out, "minio_tpu_backend_numpy_blocks_total", "counter",
         [({}, ds.get("numpy_blocks", 0))],
         "Stripe blocks served by the degraded numpy rung")
    return out


def _g_api_cache(server) -> list[str]:
    """Caching layer (cache/): per-tier hit/miss/eviction counters, the
    global byte budget's fill, singleflight collapse counts, and the
    write-through invalidation/revalidation activity — the series that
    prove (or disprove) the hot-GET path is actually being served from
    memory."""
    from .. import cache
    from ..cache import coherence as cache_coherence
    from ..storage import xlstorage

    out: list[str] = []
    if server.store is None:
        return out
    st = cache.aggregate_stats(server.store)
    tiers = ("fileinfo", "data", "segments", "listing")

    def rows(key: str):
        return [({"tier": t}, st[t].get(key, 0)) for t in tiers]

    _fmt(out, "minio_cache_enabled", "gauge", [({}, int(st["enabled"]))])
    _fmt(out, "minio_cache_hits_total", "counter", rows("hits"),
         "Cache hits per tier")
    _fmt(out, "minio_cache_misses_total", "counter", rows("misses"))
    _fmt(out, "minio_cache_evictions_total", "counter",
         [({"tier": t}, st[t].get("evictions", 0))
          for t in ("fileinfo", "data", "segments")])
    _fmt(out, "minio_cache_invalidations_total", "counter", rows("invalidations"))
    _fmt(out, "minio_cache_revalidations_total", "counter",
         [({"tier": t}, st[t].get("revalidations", 0))
          for t in ("fileinfo", "data", "segments")])
    _fmt(out, "minio_cache_entries", "gauge", rows("entries"))
    _fmt(out, "minio_cache_bytes", "gauge",
         [({"tier": "data"}, st["data"].get("bytes", 0)),
          ({"tier": "segments"}, st["segments"].get("mem_bytes", 0)),
          ({"tier": "total"}, st["bytesTotal"])],
         "Cached bytes vs the MINIO_TPU_CACHE_MEM_MB budget")
    _fmt(out, "minio_cache_singleflight_shared_total", "counter",
         [({}, st["fileinfo"].get("singleflight_shared", 0))],
         "Concurrent metadata misses that shared one quorum read")
    _fmt(out, "minio_cache_data_fills_total", "counter",
         [({"tier": "data"}, st["data"].get("fills", 0)),
          ({"tier": "segments"}, st["segments"].get("fills", 0))])
    # range-segment tier: per-request range outcomes + the disk/NVMe
    # second tier's movement and integrity counters
    sg = st["segments"]
    _fmt(out, "minio_cache_segment_range_requests_total", "counter",
         [({"result": "hit"}, sg.get("range_hits", 0)),
          ({"result": "miss"}, sg.get("range_misses", 0))],
         "Ranged GETs fully served from cached segments vs fallen "
         "through to the erasure path")
    _fmt(out, "minio_cache_segment_disk_entries", "gauge",
         [({}, sg.get("disk_entries", 0))])
    _fmt(out, "minio_cache_segment_disk_bytes", "gauge",
         [({"kind": "used"}, sg.get("disk_bytes", 0)),
          ({"kind": "budget"}, sg.get("disk_budget", 0))],
         "Disk/NVMe segment tier fill vs MINIO_TPU_CACHE_DISK_MB")
    _fmt(out, "minio_cache_segment_disk_moves_total", "counter",
         [({"dir": "demote"}, sg.get("demotions", 0)),
          ({"dir": "promote"}, sg.get("promotions", 0)),
          ({"dir": "evict"}, sg.get("disk_evictions", 0))])
    _fmt(out, "minio_cache_segment_quarantined_total", "counter",
         [({}, sg.get("quarantined", 0))],
         "Disk-tier entries dropped on failed integrity verification "
         "(torn write / bitrot / read error); reads fell back to the "
         "erasure path")
    pf = st["prefetch"]
    _fmt(out, "minio_cache_prefetch_runs_total", "counter",
         [({"event": "detected"}, pf.get("runs_detected", 0)),
          ({"event": "scheduled"}, pf.get("scheduled", 0)),
          ({"event": "completed"}, pf.get("completed", 0)),
          ({"event": "error"}, pf.get("errors", 0))],
         "Sequential read-ahead activity (cache/prefetch.py)")
    _fmt(out, "minio_cache_prefetch_bytes_total", "counter",
         [({}, pf.get("bytes_read", 0))])
    _fmt(out, "minio_cache_epoch", "gauge", [({}, st["epoch"])],
         "Coherence epoch (bumped on detected lost invalidations)")
    co = cache_coherence.stats()
    _fmt(out, "minio_cache_coherence_broadcasts_total", "counter",
         [({"result": "sent"}, co["sent"]),
          ({"result": "error"}, co["send_errors"])])
    _fmt(out, "minio_cache_coherence_received_total", "counter",
         [({}, co["received"])])
    _fmt(out, "minio_cache_coherence_gen_gaps_total", "counter",
         [({}, co["gen_gaps"])],
         "Generation-sequence gaps observed (lost invalidations healed "
         "via epoch revalidation)")
    # sharded listing metacache: the metadata-plane scale counters —
    # pages-per-walk proves O(1) drive-walks per continuation page, the
    # persisted tier's adopt/fault-in activity proves restart survival
    mc = st["listing"]
    _fmt(out, "minio_cache_metacache_requests_total", "counter",
         [({"result": "hit"}, mc.get("hits", 0)),
          ({"result": "miss"}, mc.get("misses", 0))],
         "Listing metacache lookups (hit = page served without a walk)")
    _fmt(out, "minio_cache_metacache_stores_total", "counter",
         [({}, mc.get("stores", 0))])
    _fmt(out, "minio_cache_metacache_evictions_total", "counter",
         [({}, mc.get("evictions", 0))],
         "Entries dropped by TTL expiry, capacity, or failed fault-in")
    _fmt(out, "minio_cache_metacache_invalidations_total", "counter",
         [({}, mc.get("invalidations", 0))],
         "Entries dropped through the mutation choke point")
    _fmt(out, "minio_cache_metacache_walks_total", "counter",
         [({}, mc.get("walks", 0))],
         "Full merged drive walks started (listing pages that could "
         "not be served from the sharded cache)")
    _fmt(out, "minio_cache_metacache_entries", "gauge",
         [({}, mc.get("entries", 0))])
    _fmt(out, "minio_cache_metacache_shards", "gauge",
         [({}, mc.get("shards", 0))],
         "Loaded key-range shards across in-memory listing entries")
    _fmt(out, "minio_cache_metacache_persisted_total", "counter",
         [({}, mc.get("persisted", 0))],
         "Shard + index docs written under .minio.sys")
    _fmt(out, "minio_cache_metacache_persist_adopts_total", "counter",
         [({}, mc.get("persist_adopts", 0))],
         "Persisted indexes adopted (restarted node or cluster peer)")
    _fmt(out, "minio_cache_metacache_shard_loads_total", "counter",
         [({}, mc.get("shard_loads", 0))],
         "Individual shard docs faulted in on demand")
    # shard-file fan-out: the inline small-object fast path's proof
    # counters — inline PUT/GET/HEAD must leave the user plane flat
    fo = xlstorage.fanout_stats()
    _fmt(out, "minio_storage_shard_io_total", "counter",
         [({"op": "read", "plane": "user"}, fo["shard_reads_user"]),
          ({"op": "read", "plane": "sys"}, fo["shard_reads_sys"]),
          ({"op": "write", "plane": "user"}, fo["shard_writes_user"]),
          ({"op": "write", "plane": "sys"}, fo["shard_writes_sys"]),
          ({"op": "commit", "plane": "user"}, fo["shard_commits_user"]),
          ({"op": "commit", "plane": "sys"}, fo["shard_commits_sys"])],
         "Shard-file opens/commits by plane (user buckets vs "
         ".minio.sys); metadata-only ops never move these")
    return out


def _g_api_sanitizer(server) -> list[str]:
    """Runtime sanitizer (analysis/sanitizer.py): violation counters by
    kind, the attributes under the access witness, and loop-stall
    episodes — chaos/load runs scrape this group to assert a run
    completed with zero race witnesses."""
    from ..analysis import sanitizer

    out: list[str] = []
    st = sanitizer.status()
    _fmt(out, "minio_sanitizer_enabled", "gauge",
         [({}, int(st["enabled"]))],
         "1 when MINIO_TPU_SANITIZE is active in this process")
    _fmt(out, "minio_sanitizer_violations_total", "counter",
         [({"kind": k}, v) for k, v in sorted(st["violations"].items())],
         "Sanitizer violations by kind (lock.order, attr.race, "
         "loop.stall, env.leak, resource.leak)")
    _fmt(out, "minio_sanitizer_witnessed_attributes", "gauge",
         [({}, len(st["witnessedAttrs"]))],
         "Cross-context attributes under the runtime access witness")
    _fmt(out, "minio_sanitizer_static_lock_ranks", "gauge",
         [({}, st["staticLockRanks"])],
         "Lock ids loaded from the static docs/LOCK_ORDER.md ordering")
    _fmt(out, "minio_sanitizer_loop_stall_episodes_total", "counter",
         [({}, st["stallEpisodes"])],
         "Event-loop stall episodes the watchdog reported")
    return out


def _g_api_topology(server) -> list[str]:
    """Elastic-topology plane (placement/): per-pool capacity/objects and
    the usage skew rebalance works down, rebalance/decommission progress
    (moved bytes/objects, throughput, ETA), and the placement engine's
    rule-hit/decision counters — the series the topology harness phase
    gates on."""
    out: list[str] = []
    store = server.store
    pools = getattr(store, "pools", None)
    if not pools:
        return out
    pm = getattr(server, "pool_mgr", None)
    usage = pm.pool_usage() if pm is not None else []
    _fmt(out, "minio_topology_pools", "gauge", [({}, len(pools))],
         "Attached server pools")
    _fmt(out, "minio_topology_pool_bytes", "gauge",
         [({"pool": str(u["pool"]), "kind": k},
           u["total"] if k == "total" else u["total"] - u["free"])
          for u in usage for k in ("total", "used")],
         "Per-pool drive capacity and fill")
    _fmt(out, "minio_topology_pool_used_pct", "gauge",
         [({"pool": str(u["pool"])}, u["usedPct"]) for u in usage])
    if usage:
        skew = max(u["usedPct"] for u in usage) - min(
            u["usedPct"] for u in usage
        )
        _fmt(out, "minio_topology_usage_skew_pct", "gauge",
             [({}, round(skew, 2))],
             "Max-min pool fill spread (continuous rebalance converges "
             "below MINIO_TPU_REBALANCE_THRESHOLD_PCT)")
    if pm is not None:
        # the O(objects) listing walk rides the manager's TTL cache
        data = pm.pool_data_usage_cached()
        _fmt(out, "minio_topology_pool_objects", "gauge",
             [({"pool": str(u["pool"])}, u["objects"]) for u in data],
             "Stored objects per pool (listing walk, cached between "
             "scrapes)")
        _fmt(out, "minio_topology_pool_data_bytes", "gauge",
             [({"pool": str(u["pool"])}, u["bytes"]) for u in data],
             "Stored object bytes per pool — the signal rebalance "
             "equalizes")
        _fmt(out, "minio_topology_data_skew_pct", "gauge",
             [({}, round(pm.data_spread_pct(data), 3))],
             "Max-min stored-byte share spread across pools")
        rb = pm.rebalance_status()
        states = ("idle", "running", "done", "stopped", "failed")
        _fmt(out, "minio_rebalance_state", "gauge",
             [({"state": s}, int(rb.get("state", "idle") == s))
              for s in states])
        _fmt(out, "minio_rebalance_moved_objects_total", "counter",
             [({}, rb.get("moved", 0))])
        _fmt(out, "minio_rebalance_moved_bytes_total", "counter",
             [({}, rb.get("moved_bytes", 0))],
             "Bytes the rebalance mover re-PUT into destination pools")
        _fmt(out, "minio_rebalance_failed_objects_total", "counter",
             [({}, rb.get("failed", 0))])
        _fmt(out, "minio_rebalance_skipped_pinned_total", "counter",
             [({}, rb.get("skipped_pinned", 0))],
             "Moves refused because a placement pin binds the key to "
             "its current pool")
        _fmt(out, "minio_rebalance_throughput_mibps", "gauge",
             [({}, rb.get("throughput_mibps", 0.0))],
             "Mover throughput over the current/last rebalance run")
        eta = rb.get("eta_s")
        _fmt(out, "minio_rebalance_eta_seconds", "gauge",
             [({}, eta if eta is not None else -1)],
             "Estimated seconds to fill-spread convergence (-1 unknown)")
        # in-memory table only: per-scrape checkpoint reads (a quorum
        # get_object per pool ending in ObjectNotFound) are scrape-path
        # poison; a restarted node re-surfaces persisted state the
        # moment its decommission resumes
        decoms = pm.decom_snapshot()
        rows_state, rows_obj, rows_bytes, rows_failed = [], [], [], []
        for i, st in sorted(decoms.items()):
            lbl = {"pool": str(i)}
            rows_state.append(({**lbl, "state": st.state}, 1))
            rows_obj.append((lbl, st.objects_moved))
            rows_bytes.append((lbl, st.bytes_moved))
            rows_failed.append((lbl, st.failed))
        _fmt(out, "minio_decommission_state", "gauge", rows_state)
        _fmt(out, "minio_decommission_moved_objects_total", "counter",
             rows_obj)
        _fmt(out, "minio_decommission_moved_bytes_total", "counter",
             rows_bytes)
        _fmt(out, "minio_decommission_failed_objects_total", "counter",
             rows_failed)
    pl = getattr(store, "placement", None)
    if pl is not None:
        st = pl.status()
        _fmt(out, "minio_placement_enabled", "gauge",
             [({}, int(st["enabled"]))])
        _fmt(out, "minio_placement_rules", "gauge",
             [({}, len(st["rules"]))])
        _fmt(out, "minio_placement_rule_hits_total", "counter",
             [({"rule": r["bucket"] + "/" + r["prefix"],
                "mode": r["mode"]}, r["hits"])
              for r in st["rules"]],
             "PUT placements decided by each rule")
        _fmt(out, "minio_placement_decisions_total", "counter",
             [({"kind": k}, v)
              for k, v in sorted(st["decisions"].items())],
             "Pool decisions by kind (pin/spread rule vs "
             "weight-by-free-space default)")
    return out


def _g_system_drive_latency(server) -> list[str]:
    """Per-drive, per-op latency (HealthCheckedDisk accounting): lets a
    slow p99 GET be attributed to one laggy disk instead of the whole
    quorum."""
    from ..storage.health import HealthCheckedDisk

    out: list[str] = []
    counts, totals = [], []
    for d in server.store.disks:
        if not isinstance(d, HealthCheckedDisk):
            continue
        ep = str(getattr(d, "endpoint", "?"))
        for op, (n, total_s) in sorted(d.op_stats_snapshot().items()):
            counts.append(({"drive": ep, "api": op}, n))
            totals.append(({"drive": ep, "api": op}, f"{total_s:.6f}"))
    _fmt(out, "minio_system_drive_api_calls_total", "counter", counts,
         "Storage API calls per drive and op")
    _fmt(out, "minio_system_drive_api_seconds_total", "counter", totals)
    return out


def _g_api_diag(server) -> list[str]:
    """Self-measurement plane (diag/): run counters, the last
    speedtest/netperf results as gauges (the per-drive and per-peer
    matrices a chaos-injected slow drive or slow peer must stand out
    in), and the continuous profiler's wall-time attribution — where the
    process actually spends its time, by subsystem, without anyone
    having run a profile."""
    from .. import diag

    out: list[str] = []
    st = diag.stats()
    last = diag.last_results()
    _fmt(out, "minio_diag_runs_total", "counter",
         [({"kind": k}, n) for k, n in sorted(st["runs"].items())],
         "Completed self-measurement runs by kind (object/drive/net)")
    _fmt(out, "minio_diag_errors_total", "counter", [({}, st["errors"])])

    obj = last.get("object", {})
    knee = obj.get("knee", {})
    _fmt(out, "minio_diag_speedtest_put_mibps", "gauge",
         [({}, knee["putMiBps"])] if knee else [],
         "Knee-point PUT throughput of the last object speedtest")
    _fmt(out, "minio_diag_speedtest_get_mibps", "gauge",
         [({}, knee["getMiBps"])] if knee else [])
    _fmt(out, "minio_diag_speedtest_knee_concurrency", "gauge",
         [({}, knee["concurrency"])] if knee else [],
         "Concurrency at which the autotune ramp stopped paying")

    drv = last.get("drive", {})
    rows = [d for d in drv.get("drives", ()) if "error" not in d]
    _fmt(out, "minio_diag_drive_write_mibps", "gauge",
         [({"drive": d["endpoint"]}, d["writeMiBps"]) for d in rows],
         "Sequential write MiB/s per drive, last drive speedtest")
    _fmt(out, "minio_diag_drive_read_mibps", "gauge",
         [({"drive": d["endpoint"]}, d["readMiBps"]) for d in rows])
    _fmt(out, "minio_diag_drive_rand_read_p99_ms", "gauge",
         [({"drive": d["endpoint"]}, d["randRead"]["p99Ms"]) for d in rows],
         "Random 4KiB read p99 per drive, last drive speedtest")

    net = last.get("net", {})
    prow = [(p, r) for p, r in sorted(net.get("peers", {}).items())
            if "error" not in r]
    _fmt(out, "minio_diag_net_mibps", "gauge",
         [({"peer": p}, r["throughputMiBps"]) for p, r in prow],
         "Grid echo throughput per peer, last netperf")
    _fmt(out, "minio_diag_net_rtt_p99_ms", "gauge",
         [({"peer": p}, r["rttP99Ms"]) for p, r in prow])

    cp = getattr(server, "cprofiler", None)
    snap = cp.snapshot() if cp is not None else {"samples": 0, "counts": {}}
    _fmt(out, "minio_diag_profile_enabled", "gauge",
         [({}, int(cp is not None))],
         "1 when the continuous ~19Hz profiler is sampling")
    _fmt(out, "minio_diag_profile_samples_total", "counter",
         [({}, snap["samples"])])
    _fmt(out, "minio_diag_profile_thread_samples_total", "counter",
         [({"subsystem": sub, "state": state}, n)
          for (sub, state), n in sorted(snap["counts"].items())],
         "Wall-time attribution: sampled thread stacks by owning "
         "subsystem and running/waiting state")
    return out


def _g_system_selftest(server) -> list[str]:
    """Hardware fingerprint from the last self-measurement runs — the
    series the scenario engine scrapes to stamp every BENCH json, so a
    CPU-shadowed number is self-describing."""
    from .. import diag

    out: list[str] = []
    last = diag.last_results()
    _fmt(out, "minio_system_selftest_cpu_cores", "gauge",
         [({}, os.cpu_count() or 1)],
         "Cores visible to this process")
    _fmt(out, "minio_system_selftest_workers", "gauge",
         [({}, getattr(server, "worker_count", 1))])

    drv = [d for d in last.get("drive", {}).get("drives", ())
           if "error" not in d]
    _fmt(out, "minio_system_selftest_drive_write_mibps", "gauge",
         [({}, max(d["writeMiBps"] for d in drv))] if drv else [],
         "Best sequential drive write MiB/s, last drive speedtest")
    _fmt(out, "minio_system_selftest_drive_read_mibps", "gauge",
         [({}, max(d["readMiBps"] for d in drv))] if drv else [])

    net = [r for r in last.get("net", {}).get("peers", {}).values()
           if "error" not in r]
    _fmt(out, "minio_system_selftest_loopback_mibps", "gauge",
         [({}, max(r["throughputMiBps"] for r in net))] if net else [],
         "Best grid echo throughput (loopback/peer), last netperf")
    _fmt(out, "minio_system_selftest_complete", "gauge",
         [({}, int(bool(drv) and bool(net)))],
         "1 when drive + net selftests have both completed")
    return out


# collector path -> renderer; bucket paths live in V3_BUCKET_GROUPS
V3_GROUPS = {
    "/api/requests": _g_api_requests,
    "/api/qos": _g_api_qos,
    "/api/tpu": _g_api_tpu,
    "/api/trace": _g_api_trace,
    "/api/fault": _g_api_fault,
    "/api/cache": _g_api_cache,
    "/api/sanitizer": _g_api_sanitizer,
    "/api/topology": _g_api_topology,
    "/api/diag": _g_api_diag,
    "/system/drive/latency": _g_system_drive_latency,
    "/system/selftest": _g_system_selftest,
    "/system/network/internode": _g_system_network,
    "/system/drive": _g_system_drive,
    "/system/memory": _g_system_memory,
    "/system/cpu": _g_system_cpu,
    "/system/process": _g_system_process,
    "/debug/python": _g_debug_python,
    "/cluster/health": _g_cluster_health,
    "/cluster/usage/objects": _g_cluster_usage,
    "/cluster/usage/buckets": _g_cluster_usage_buckets,
    "/cluster/erasure-set": _g_cluster_erasure_set,
    "/cluster/iam": _g_cluster_iam,
    "/cluster/config": _g_cluster_config,
    "/ilm": _g_ilm,
    "/scanner": _g_scanner,
    "/replication": _g_replication,
    "/notification": _g_notification,
    "/audit": _g_audit,
}
V3_BUCKET_GROUPS = {
    "/bucket/api": _g_bucket_api,
    "/bucket/replication": _g_bucket_replication,
}


def _worker_relabel(text: str, worker: int, keep_comments: bool) -> list[str]:
    """Stamp every series line with a ``worker="i"`` label. Peer lines
    drop their # HELP/TYPE comments (the serving worker's copy already
    carries them — duplicated TYPE lines are invalid exposition)."""
    out: list[str] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            if keep_comments:
                out.append(line)
            continue
        i = line.rfind("} ")
        if i >= 0:
            out.append(f'{line[:i]},worker="{worker}"{line[i:]}')
        else:
            name, _, rest = line.partition(" ")
            out.append(f'{name}{{worker="{worker}"}} {rest}')
    return out


def render_v3_pool(server, path: str) -> str | None:
    """Pool-aware exposition: the serving worker's groups plus every
    sibling worker's, each series stamped ``worker="i"`` — a scrape of
    the shared SO_REUSEPORT port lands on ONE worker, and without the
    fan-out it would report that worker's QoS/cache/TPU view as if it
    were the node's. Counters aggregate with sum by (series) without the
    worker label; siblings render with ``local=on`` so the fan-out never
    recurses. A dead sibling is a 0 in ``minio_worker_up``, not a scrape
    failure."""
    own = render_v3(server, path)
    if own is None or not server.worker_peers:
        return own
    from concurrent.futures import ThreadPoolExecutor

    sub = "/" + path.strip("/") if path.strip("/") else ""
    base = getattr(server, "worker_port_base", 0)

    def one(peer: str) -> tuple[int, str | None]:
        host, _, p = peer.rpartition(":")
        idx = int(p) - base if base else -1
        try:
            from ..client import S3Client

            r = S3Client(
                peer, access_key=server.root_user,
                secret_key=server.root_pass,
            ).request(
                "GET", f"/minio/metrics/v3{sub}", query={"local": "on"},
                timeout=10,
            )
            if r.status != 200:
                return idx, None
            return idx, r.body.decode()
        except Exception:  # noqa: BLE001 — a dead worker is a 0 gauge
            return idx, None

    with ThreadPoolExecutor(max_workers=min(len(server.worker_peers), 16)) as pool:
        results = list(pool.map(one, server.worker_peers))
    lines = _worker_relabel(own, server.worker_index, keep_comments=True)
    up = [(server.worker_index, 1)]
    for idx, text in results:
        up.append((idx, 1 if text is not None else 0))
        if text is not None:
            lines.extend(_worker_relabel(text, idx, keep_comments=False))
    _fmt(lines, "minio_workers_total", "gauge",
         [({}, len(server.worker_peers) + 1)],
         "SO_REUSEPORT pool size on this node")
    _fmt(lines, "minio_worker_up", "gauge",
         [({"worker": str(i)}, v) for i, v in sorted(up)],
         "1 when the worker answered the pool metrics fan-out")
    return "\n".join(lines) + "\n"


def render_v3(server, path: str) -> str | None:
    """Render the v3 group(s) under `path` ('' = all non-bucket groups).
    Returns None for an unknown path (-> 404)."""
    path = "/" + path.strip("/") if path.strip("/") else ""
    for bpath, fn in V3_BUCKET_GROUPS.items():
        if path.startswith(bpath + "/"):
            bucket = path[len(bpath) + 1 :]
            return "\n".join(fn(server, bucket)) + "\n"
    out: list[str] = []
    matched = False
    for gpath, fn in V3_GROUPS.items():
        if not path or gpath == path or gpath.startswith(path + "/"):
            matched = True
            try:
                out.extend(fn(server))
            except Exception:  # noqa: BLE001 — one broken group must not
                pass  # take down the whole exposition
    if not matched:
        return None
    return "\n".join(out) + "\n"
