"""Central registry of every MINIO_* config knob the code reads.

The ``knob`` rule fails the gate on any env read not declared here, and
``minio_tpu_torch/docs/CONFIG.md`` is generated from this file (``python -m
minio_tpu_torch.analysis --gen-config-docs``) — so the docs can never drift
from what the code actually reads.

Prefix knobs (names ending in ``_``) are families instantiated per
target id, e.g. ``MINIO_NOTIFY_WEBHOOK_ENABLE_PRIMARY``.

This module must stay import-light (stdlib only): the analyzer and the
docs generator both run without jax/numpy installed.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    name: str
    default: str | None      # canonical inline default ("" = empty, None = no default)
    description: str
    subsystem: str
    prefix: bool = False     # name is a family prefix (per-target-id suffix)


def _k(name: str, default: str | None, subsystem: str, description: str) -> Knob:
    return Knob(name, default, description, subsystem, prefix=name.endswith("_"))


_ALL: list[Knob] = [
    # -- cluster ----------------------------------------------------------
    _k("MINIO_TPU_GRID", "1", "cluster",
       "Use the persistent internode grid (muxed websocket-style "
       "connections) instead of per-call HTTP; 0 falls back."),
    _k("MINIO_TPU_LOCK_REFRESH_S", "10", "cluster",
       "Interval between distributed-lock refreshes; a holder that "
       "misses refreshes loses the lock at TTL expiry."),
    # -- caching layer (cache/) ------------------------------------------
    _k("MINIO_TPU_CACHE", "1", "cache",
       "Master switch for the quorum-coherent caching layer (FileInfo, "
       "hot-object data, and listing tiers); 0 disables every tier."),
    _k("MINIO_TPU_CACHE_ADMIT_TOUCHES", "2", "cache",
       "Reads of an object within the admission window before its bytes "
       "earn data-cache residency (1 = admit on first read; inline-data "
       "objects always admit immediately)."),
    _k("MINIO_TPU_CACHE_FILEINFO_ENTRIES", "4096", "cache",
       "Per-erasure-set LRU capacity of the FileInfo metadata cache."),
    _k("MINIO_TPU_CACHE_MEM_MB", "256", "cache",
       "Process-wide byte budget (MiB) shared by the hot-object data "
       "cache and cached inline payloads; oldest entries evict past it."),
    _k("MINIO_TPU_CACHE_OBJECT_MAX", "2097152", "cache",
       "Largest object (bytes) the hot-object data cache will hold."),
    _k("MINIO_TPU_CACHE_REVALIDATE_S", "1", "cache",
       "Distributed deployments re-check cached entries older than this "
       "(single-drive modTime probe) before serving them; bounds the "
       "staleness window of a lost cross-node invalidation. 0 trusts "
       "invalidations alone; single-node deployments never revalidate."),
    _k("MINIO_TPU_CACHE_SEGMENTS", "1", "cache",
       "Range-segment data cache for objects above "
       "MINIO_TPU_CACHE_OBJECT_MAX: ranged GETs cache and serve "
       "stripe-block (1 MiB) aligned segments, skipping open_object "
       "entirely on full coverage; 0 disables the tier (and prefetch)."),
    _k("MINIO_TPU_CACHE_DISK_MB", "0", "cache",
       "Disk/NVMe second-tier byte budget (MiB) for the range-segment "
       "cache, per worker process: memory-budget evictions demote the "
       "coldest segments to digest-stamped files (HighwayHash-256 when "
       "the native plane is built, sha256 otherwise); a disk hit "
       "promotes back to memory after re-verification. 0 disables the "
       "tier."),
    _k("MINIO_TPU_CACHE_DISK_DIR", "", "cache",
       "Root directory for the disk/NVMe segment tier (each worker "
       "process keeps its own subdirectory, removed at exit); empty "
       "uses <tmpdir>/minio-tpu-segcache."),
    _k("MINIO_TPU_CACHE_PREFETCH_SEGMENTS", "4", "cache",
       "Sequential read-ahead depth: after a detected run of contiguous "
       "ranged reads, this many stripe blocks past the observed end are "
       "read through the erasure path on the QoS background lane and "
       "cached. 0 disables prefetch."),
    _k("MINIO_TPU_CACHE_PREFETCH_MIN_RUN", "2", "cache",
       "Consecutive forward-contiguous ranged reads of one object "
       "before read-ahead engages (floor 2 — a single ranged read is "
       "not yet a sequential pattern)."),
    # -- diag / self-measurement ------------------------------------------
    _k("MINIO_TPU_DIAG_MAX_CONCURRENCY", "32", "diag",
       "Ceiling for the object-speedtest autotune ramp (concurrency "
       "doubles until throughput stops improving or this cap)."),
    _k("MINIO_TPU_DIAG_NETPERF_SIZE_KB", "1024", "diag",
       "Default netperf echo-burst payload size in KiB when the admin "
       "op does not pass an explicit size."),
    _k("MINIO_TPU_PROFILE_CONTINUOUS", "1", "diag",
       "Always-on wall-time attribution sampler (~19 Hz, publishes the "
       "/api/diag attribution series); 0 disables."),
    _k("MINIO_TPU_PROFILE_CONTINUOUS_HZ", "19", "diag",
       "Continuous profiler sample rate in Hz (clamped to [1, 250]); "
       "prime-ish default avoids phase-locking with periodic work."),
    # -- erasure / object layer ------------------------------------------
    _k("MINIO_TPU_BACKEND", "torch", "erasure",
       "Erasure codec backend: `torch` (the device route: the hand CUDA "
       "kernels on the card, their plain torch versions where "
       "MINIO_TPU_TORCH_DEVICE=cpu) or `numpy` (pure-CPU reference "
       "path); any value but `numpy` takes the device route."),
    _k("MINIO_TPU_DECODE_MIN_SHARDS", "64", "erasure",
       "Minimum missing-shard batch before reconstruct runs on the "
       "device; smaller heal batches decode on CPU."),
    _k("MINIO_TPU_DEVICE_HEAL", "0", "erasure",
       "Route heal-plane reconstruct+hash through the fused device "
       "kernel (1) instead of the CPU path (0)."),
    _k("MINIO_TPU_EC_FAMILY", "reedsolomon", "erasure",
       "Default erasure code family for NEW writes: `reedsolomon` "
       "(Vandermonde RS, native/mega-kernel planes) or `cauchy` (Cauchy "
       "MDS with piggybacked sub-chunks — single-shard repair reads "
       "~40% fewer survivor bytes at EC 8+8). Recorded per object in "
       "xl.meta; reads/heals always dispatch on the stored family, so "
       "flipping this never breaks existing objects. Malformed values "
       "fall back to reedsolomon."),
    _k("MINIO_TPU_EC_FAMILY_STANDARD", "", "erasure",
       "Code-family override for x-amz-storage-class STANDARD (and "
       "requests with no storage class); empty defers to "
       "MINIO_TPU_EC_FAMILY."),
    _k("MINIO_TPU_EC_FAMILY_RRS", "", "erasure",
       "Code-family override for x-amz-storage-class "
       "REDUCED_REDUNDANCY; empty defers to MINIO_TPU_EC_FAMILY."),
    _k("MINIO_TPU_EC_REPAIR", "1", "erasure",
       "Partial-repair reads for sub-packetized families: heal and "
       "degraded GETs of a single lost data shard fetch only the "
       "repair schedule's sub-chunk frames instead of full survivor "
       "shards. 0 forces full-shard reads (correctness never depends "
       "on this — it is purely the repair-bandwidth optimization)."),
    _k("MINIO_TPU_REPAIR_WINDOWED", "1", "erasure",
       "Windowed + hedged execution of partial-repair plans (degraded "
       "GET and heal): a window of blocks' sub-chunk reads issues "
       "concurrently with next-window readahead, and straggling or "
       "failed helpers degrade per BLOCK to the generic gather. 0 "
       "falls back to the block-serial baseline (the A/B lever the "
       "repair-degraded-storm wall-clock gate measures against)."),
    _k("MINIO_TPU_DECODE_MATRIX_CACHE", "256", "erasure",
       "Entries in the decode-matrix LRU shared by the code families "
       "(ops/decode_cache.py): GF inverses keyed by (family, d, p, "
       "failure pattern), hit/miss series on /api/tpu. 0 disables the "
       "cache so A/B runs can price it."),
    _k("MINIO_TPU_DISK_MONITOR_INTERVAL", "10", "erasure",
       "Seconds between background disk health probes (offline-disk "
       "detection and auto-heal triggering)."),
    _k("MINIO_TPU_METACACHE_MAX_KEYS", "200000", "erasure",
       "Cap on cached listing entries per metacache bucket scan."),
    _k("MINIO_TPU_METACACHE_PERSIST", "1", "erasure",
       "Persist metacache shard/index docs under .minio.sys so a "
       "restarted node or a cluster peer adopts a TTL-fresh listing "
       "(faulting in only the shards its pages touch) instead of "
       "re-walking every drive. 0 keeps the metacache memory-only."),
    _k("MINIO_TPU_METACACHE_SHARD_KEYS", "8192", "erasure",
       "Keys per metacache key-range shard. A continuation token "
       "bisects into its shard, so page-resume work is O(log shards + "
       "page) regardless of total keyspace; smaller shards mean finer "
       "lazy loads from the persisted tier, more docs."),
    _k("MINIO_TPU_METACACHE_TTL", "15", "erasure",
       "Seconds a bucket-listing metacache stays valid before a "
       "rescan."),
    _k("MINIO_TPU_NATIVE_PLANE", "auto", "erasure",
       "Native (C) data-plane helpers: `auto` probes, `on` requires, "
       "`off` disables."),
    _k("MINIO_TPU_NATIVE_THREADS", "1", "erasure",
       "Native PUT per-stripe-block worker threads (parity+hash+write "
       "parallelize per block; md5 stays pipelined on the feeding "
       "thread). 0 = auto from hardware concurrency; malformed or "
       "negative values fall back to 1 (serial); clamped to 16."),
    _k("MINIO_TPU_READ_SPAN_MB", "16", "erasure",
       "Bytes of contiguous shard data one GET read span covers before "
       "the next span is scheduled."),
    _k("MINIO_TPU_READ_WINDOW", "8", "erasure",
       "Read-ahead window (spans) for streaming GETs."),
    _k("MINIO_TPU_READ_WORKERS", "32", "erasure",
       "Worker threads per erasure set for parallel shard reads."),
    _k("MINIO_TPU_POOL_MB", "256", "erasure",
       "Stripe-arena buffer-pool budget (MiB) shared by ingest and GET "
       "gather; arenas beyond the budget are freed, not recycled."),
    _k("MINIO_TPU_STREAM_BATCH_MB", "64", "erasure",
       "Stripe bytes accumulated before a streaming PUT flushes a "
       "batched device encode."),
    _k("MINIO_TPU_ZEROCOPY", "1", "erasure",
       "Zero-copy data plane: pooled ingest arenas feeding the "
       "dispatcher, view-based GET gather. `0` restores the legacy "
       "copying path (A/B lever for the BENCH_r13 ingest phase)."),
    # -- events / notifications ------------------------------------------
    _k("MINIO_NOTIFY_ELASTICSEARCH_ENABLE_", None, "events",
       "Enable the Elasticsearch notify target with this id "
       "(`on`/`true`/`1`)."),
    _k("MINIO_NOTIFY_ELASTICSEARCH_INDEX_", "minio-events", "events",
       "Elasticsearch index receiving bucket events."),
    _k("MINIO_NOTIFY_ELASTICSEARCH_URL_", "", "events",
       "Elasticsearch base URL for the target."),
    _k("MINIO_NOTIFY_FILE_ENABLE_", None, "events",
       "Enable the append-to-file notify target with this id."),
    _k("MINIO_NOTIFY_FILE_PATH_", "", "events",
       "File path the file notify target appends JSON events to."),
    _k("MINIO_NOTIFY_KAFKA_BROKERS_", "", "events",
       "Comma-separated Kafka brokers (first is used) for the target."),
    _k("MINIO_NOTIFY_KAFKA_ENABLE_", None, "events",
       "Enable the Kafka notify target with this id."),
    _k("MINIO_NOTIFY_KAFKA_TOPIC_", "minio-events", "events",
       "Kafka topic receiving bucket events."),
    _k("MINIO_NOTIFY_MQTT_BROKER_", "", "events",
       "MQTT broker URL for the target."),
    _k("MINIO_NOTIFY_MQTT_ENABLE_", None, "events",
       "Enable the MQTT notify target with this id."),
    _k("MINIO_NOTIFY_MQTT_TOPIC_", "minio-events", "events",
       "MQTT topic bucket events publish to."),
    _k("MINIO_NOTIFY_MYSQL_DSN_STRING_", "", "events",
       "MySQL DSN (user:pass@tcp(host:port)/db) for the target."),
    _k("MINIO_NOTIFY_MYSQL_ENABLE_", None, "events",
       "Enable the MySQL notify target with this id."),
    _k("MINIO_NOTIFY_MYSQL_TABLE_", "minio_events", "events",
       "MySQL table bucket events insert into."),
    _k("MINIO_NOTIFY_NATS_ADDRESS_", "", "events",
       "NATS server address (host:port) for the target."),
    _k("MINIO_NOTIFY_NATS_ENABLE_", None, "events",
       "Enable the NATS notify target with this id."),
    _k("MINIO_NOTIFY_NATS_SUBJECT_", "minio-events", "events",
       "NATS subject bucket events publish to."),
    _k("MINIO_NOTIFY_NSQ_ENABLE_", None, "events",
       "Enable the NSQ notify target with this id."),
    _k("MINIO_NOTIFY_NSQ_NSQD_ADDRESS_", "", "events",
       "nsqd address (host:port) for the target."),
    _k("MINIO_NOTIFY_NSQ_TOPIC_", "minio-events", "events",
       "NSQ topic bucket events publish to."),
    _k("MINIO_NOTIFY_POSTGRES_CONNECTION_STRING_", "", "events",
       "Postgres connection string for the target."),
    _k("MINIO_NOTIFY_POSTGRES_ENABLE_", None, "events",
       "Enable the Postgres notify target with this id."),
    _k("MINIO_NOTIFY_POSTGRES_TABLE_", "minio_events", "events",
       "Postgres table bucket events insert into."),
    _k("MINIO_NOTIFY_REDIS_ADDRESS_", "", "events",
       "Redis address (host:port) for the target."),
    _k("MINIO_NOTIFY_REDIS_ENABLE_", None, "events",
       "Enable the Redis notify target with this id."),
    _k("MINIO_NOTIFY_REDIS_KEY_", "minio-events", "events",
       "Redis key (list) bucket events push to."),
    _k("MINIO_NOTIFY_WEBHOOK_AUTH_TOKEN_", "", "events",
       "Bearer token sent with webhook notify posts."),
    _k("MINIO_NOTIFY_WEBHOOK_ENABLE_", None, "events",
       "Enable the HTTP webhook notify target with this id."),
    _k("MINIO_NOTIFY_WEBHOOK_ENDPOINT_", "", "events",
       "HTTP endpoint webhook notify posts events to."),
    _k("MINIO_LAMBDA_WEBHOOK_ENABLE_", "", "events",
       "Enable the object-lambda transform endpoint with this id."),
    _k("MINIO_LAMBDA_WEBHOOK_ENDPOINT_", "", "events",
       "HTTP endpoint object-lambda GETs are transformed through."),
    # -- fault / robustness ------------------------------------------------
    _k("MINIO_TPU_RETRY_ATTEMPTS", "3", "fault",
       "Attempts for idempotent internode RPCs through the unified "
       "retry policy (fault/retry.py); non-idempotent ops never retry."),
    _k("MINIO_TPU_RETRY_BASE_MS", "25", "fault",
       "Base delay of the jittered exponential retry backoff."),
    _k("MINIO_TPU_RETRY_CAP_MS", "1000", "fault",
       "Ceiling on a single retry backoff sleep."),
    _k("MINIO_TPU_HEDGE", "1", "fault",
       "Hedged shard reads on the GET window path: when a drive blows "
       "the latency budget, parity reads race the straggler and the GET "
       "decodes around it. The same budget covers the repair plane "
       "(degraded GET / heal partial-repair plans), where the hedge is "
       "the generic full gather racing the sub-chunk plan per block; "
       "0 disables both."),
    _k("MINIO_TPU_HEDGE_MIN_MS", "50", "fault",
       "Floor of the hedged-read straggler budget (a cold or fast "
       "cluster must not hedge on noise)."),
    _k("MINIO_TPU_HEDGE_MULT", "4", "fault",
       "Hedged-read budget as a multiple of the median per-drive EWMA "
       "latency (HealthCheckedDisk accounting)."),
    _k("MINIO_TPU_BACKEND_DEMOTE_FAULTS", "3", "fault",
       "Consecutive TPU device faults before the dispatcher demotes the "
       "encode backend to the pure-numpy rung."),
    _k("MINIO_TPU_BACKEND_PROBE_AFTER", "16", "fault",
       "Dispatches between synthetic probe batches while degraded; a "
       "successful probe re-promotes the device backend."),
    # -- iam / identity ---------------------------------------------------
    _k("MINIO_ETCD_ENDPOINTS", "", "iam",
       "Comma-separated etcd endpoints; when set, IAM documents live in "
       "etcd so peer deployments share one identity plane."),
    _k("MINIO_IDENTITY_OPENID_CLAIM_NAME", "policy", "iam",
       "JWT claim carrying the policy name for OpenID STS logins."),
    _k("MINIO_IDENTITY_OPENID_CLIENT_ID", "", "iam",
       "OAuth client id checked against the token audience."),
    _k("MINIO_IDENTITY_OPENID_CONFIG_URL", "", "iam",
       "OpenID discovery document URL (…/.well-known/openid-configuration)."),
    _k("MINIO_IDENTITY_OPENID_JWKS_URL", "", "iam",
       "JWKS URL for OpenID token signature validation (overrides "
       "discovery)."),
    _k("MINIO_IDENTITY_TLS_ENABLE", None, "iam",
       "Enable STS AssumeRoleWithCertificate over mutual TLS "
       "(`on`/`true`/`1`)."),
    _k("MINIO_ROOT_PASSWORD", "minioadmin", "iam",
       "Root (admin) secret key."),
    _k("MINIO_ROOT_USER", "minioadmin", "iam",
       "Root (admin) access key."),
    # -- kms / crypto -----------------------------------------------------
    _k("MINIO_KMS_API_KEY", "", "kms",
       "MinKMS API key used to authenticate this server."),
    _k("MINIO_KMS_CAPATH", "", "kms",
       "CA bundle path for verifying the MinKMS server certificate."),
    _k("MINIO_KMS_ENCLAVE", "default", "kms",
       "MinKMS enclave (key namespace) this deployment uses."),
    _k("MINIO_KMS_KES_API_KEY", None, "kms",
       "KES API key (enclave identity) for the KES backend."),
    _k("MINIO_KMS_KES_CAPATH", None, "kms",
       "CA bundle path for verifying the KES server certificate."),
    _k("MINIO_KMS_KES_CERT_FILE", None, "kms",
       "Client TLS certificate for mTLS with KES."),
    _k("MINIO_KMS_KES_ENDPOINT", None, "kms",
       "KES server endpoint; selects the KES backend when set."),
    _k("MINIO_KMS_KES_KEY_FILE", None, "kms",
       "Client TLS private key for mTLS with KES."),
    _k("MINIO_KMS_KES_KEY_NAME", None, "kms",
       "Default KES master key name for SSE-KMS."),
    _k("MINIO_KMS_SECRET_KEY", "", "kms",
       "Static local master key (name:base64key); the single-node KMS "
       "backend."),
    _k("MINIO_KMS_SERVER", "", "kms",
       "MinKMS server endpoint; selects the MinKMS backend when set."),
    _k("MINIO_KMS_SSE_KEY", "", "kms",
       "Default MinKMS key name for SSE-KMS when the request names "
       "none."),
    # -- analysis / sanitizer ---------------------------------------------
    _k("MINIO_TPU_SANITIZE", "0", "analysis",
       "Runtime sanitizer mode (analysis/sanitizer.py): wraps in-package "
       "lock creation with a lock-order witness checked against the "
       "static minio_tpu_torch/docs/LOCK_ORDER.md ordering, arms the event-loop stall "
       "watchdog, and enables per-test-module env-mutation isolation. "
       "The tier-1 conftest turns it on by default; violations surface "
       "as obs `type=sanitizer` records, never as raised exceptions."),
    _k("MINIO_TPU_SANITIZE_STALL_S", "0.5", "analysis",
       "Event-loop stall watchdog threshold in seconds: the loop "
       "missing its monotonic tick for longer than this records one "
       "`loop.stall` sanitizer event with the loop thread's stack."),
    _k("MINIO_TPU_SANITIZE_LEAKS", "1", "analysis",
       "Resource leak witness under MINIO_TPU_SANITIZE=1: acquisition "
       "wrappers on the resource classes in minio_tpu_torch/docs/RESOURCES.md register "
       "weakref finalizers, and a resource garbage-collected without "
       "its release method having run (a dropped ObjectHandle stranding "
       "a namespace read lock, an unclosed spool file) reports a "
       "`resource.leak` sanitizer event with the acquisition stack. "
       "0 disables just this witness."),
    _k("MINIO_TPU_SANITIZE_ATTRS", "1", "analysis",
       "Attribute access witness under MINIO_TPU_SANITIZE=1: the "
       "cross-context attributes the static `races` pass emitted into "
       "minio_tpu_torch/docs/CONCURRENCY.md are descriptor-wrapped so every touch "
       "records the accessing thread + held-lock witness; a live "
       "lockset inconsistency reports an `attr.race` sanitizer event. "
       "0 disables just this witness."),
    # -- placement / topology (placement/) --------------------------------
    _k("MINIO_TPU_PLACEMENT", "1", "placement",
       "Placement-aware pool routing: per-bucket/per-prefix rules (pin "
       "to a pool, spread across pools) persisted under .minio.sys, "
       "with a weight-by-free-space default for unruled keys. 0 falls "
       "back to the bare most-free-pool heuristic and ignores rules."),
    _k("MINIO_TPU_PLACEMENT_REFRESH_S", "5", "placement",
       "Seconds a process trusts its in-memory copy of the persisted "
       "placement rules and its cached per-pool free-space snapshot "
       "before re-reading; admin placement mutations refresh peers "
       "immediately via fan-out."),
    _k("MINIO_TPU_REBALANCE_THRESHOLD_PCT", "5", "placement",
       "Continuous rebalance converges when the max-min pool fill "
       "spread (percent of capacity used) drops below this."),
    _k("MINIO_TPU_REBALANCE_BATCH", "200", "placement",
       "Objects one rebalance pass moves before re-measuring pool "
       "usage (smaller = tighter convergence checks, more passes)."),
    _k("MINIO_TPU_REBALANCE_PAUSE_S", "0", "placement",
       "Pause between continuous-rebalance passes; gives foreground "
       "traffic breathing room beyond the QoS background lane's own "
       "throttling."),
    # -- qos --------------------------------------------------------------
    _k("MINIO_TPU_API_ADMIN_REQUESTS_MAX", None, "qos",
       "Admin-API inflight cap (helper default 64)."),
    _k("MINIO_TPU_API_BG_REQUESTS_MAX", None, "qos",
       "Background-plane inflight cap (helper default 64)."),
    _k("MINIO_TPU_API_REQUESTS_DEADLINE", "10", "qos",
       "Seconds an admission waiter may queue before answering 503 "
       "SlowDown."),
    _k("MINIO_TPU_API_REQUESTS_MAX", None, "qos",
       "S3-API inflight cap; 0/unset auto-sizes to max(256, 32*cpus), "
       "-1 is unlimited."),
    _k("MINIO_TPU_QOS_BG_FRACTION", "0.5", "qos",
       "Max fraction of one TPU dispatch batch background blocks may "
       "occupy."),
    _k("MINIO_TPU_QOS_BG_MAX_AGE_MS", "50", "qos",
       "Age at which a queued background block promotes to the "
       "foreground lane (starvation protection)."),
    # -- server / s3 api --------------------------------------------------
    _k("MINIO_AUDIT_KAFKA_BROKERS", "", "server",
       "Comma-separated Kafka brokers for audit records (first is "
       "used)."),
    _k("MINIO_AUDIT_KAFKA_ENABLE", "", "server",
       "Enable audit-to-Kafka (`on`/`true`/`1`)."),
    _k("MINIO_AUDIT_KAFKA_TOPIC", "minio-audit", "server",
       "Kafka topic receiving audit records."),
    _k("MINIO_AUDIT_WEBHOOK_AUTH_TOKEN_", "", "server",
       "Bearer token sent with audit webhook posts."),
    _k("MINIO_AUDIT_WEBHOOK_ENABLE_", None, "server",
       "Enable the audit webhook target with this id."),
    _k("MINIO_AUDIT_WEBHOOK_ENDPOINT_", "", "server",
       "HTTP endpoint audit records post to."),
    _k("MINIO_COMPRESSION_ENABLE", "off", "server",
       "Transparent object compression (`on` enables; incompressible "
       "types are skipped)."),
    _k("MINIO_DOMAIN", "", "server",
       "Virtual-host-style S3 domain(s), comma-separated; empty serves "
       "path-style only."),
    _k("MINIO_PROMETHEUS_AUTH_TYPE", "jwt", "server",
       "Metrics endpoint auth: `jwt` (admin-signed bearer) or `public`."),
    _k("MINIO_SFTP_AUTHORIZED_KEYS", None, "server",
       "Path to an authorized_keys file for SFTP public-key logins."),
    _k("MINIO_STORAGE_CLASS_RRS", "EC:2", "server",
       "Parity for REDUCED_REDUNDANCY objects (`EC:n`)."),
    _k("MINIO_STORAGE_CLASS_STANDARD", "", "server",
       "Parity for STANDARD objects (`EC:n`); empty uses the pool "
       "default."),
    _k("MINIO_TPU_CERTS_DIR", "", "server",
       "Directory with public.crt/private.key enabling the TLS "
       "listener."),
    _k("MINIO_TPU_HTTP_READBUF", None, "server",
       "aiohttp per-connection read buffer bytes (throughput knob for "
       "streaming PUTs)."),
    _k("MINIO_TPU_IAM_REFRESH", "120", "server",
       "Seconds between IAM document refreshes (0 disables)."),
    _k("MINIO_TPU_IO_THREADS", "64", "server",
       "Dedicated store-I/O executor threads; undersizing can deadlock "
       "writers behind lock holders."),
    _k("MINIO_TPU_PUT_CHUNK_MB", "4", "server",
       "Chunk size the streaming-PUT body pump hands to the erasure "
       "layer."),
    _k("MINIO_TPU_REPLICATION_PROXY", "on", "server",
       "Proxy GETs for not-yet-replicated objects to the replication "
       "source (`off` disables)."),
    _k("MINIO_TPU_SCAN_INTERVAL", "300", "server",
       "Seconds between background data-scanner sweeps."),
    _k("MINIO_TPU_STREAM_MIN_BYTES", None, "server",
       "Content-Length floor below which a PUT buffers instead of "
       "streaming."),
    _k("MINIO_TPU_TRACE_BUFFER", "1000", "server",
       "Per-subscriber trace stream queue depth; a consumer slower than "
       "the record rate drops (counted) records beyond it."),
    _k("MINIO_TPU_TRACE_RING", "262144", "server",
       "Closed spans the server keeps in memory without a trace "
       "subscriber (the newest; older ones are overwritten and "
       "counted), stamped on the monotonic clock; 0 turns the ring "
       "off."),
    _k("MINIO_TPU_WORKERS", "1", "server",
       "SO_REUSEPORT worker pool size: N forks N serving processes "
       "sharing the listen port over the same drives (coherent via "
       "ns-lock quorum + cache invalidation broadcasts); 0 = auto from "
       "nproc. Single-node deployments only for now."),
    _k("MINIO_TPU_WORKER_COUNT", "1", "server",
       "Set by the worker-pool supervisor on each child: total workers "
       "in the pool (divides the node-wide QoS admission budgets)."),
    _k("MINIO_TPU_WORKER_INDEX", None, "server",
       "Set by the worker-pool supervisor on each child: this worker's "
       "index; its presence marks a process as a pool worker."),
    _k("MINIO_TPU_WORKER_PORT_BASE", "", "server",
       "First loopback control port of the worker pool (worker i "
       "listens on base+i for sibling/admin RPC); empty = S3 port + "
       "1000."),
    # -- storage ----------------------------------------------------------
    _k("MINIO_TPU_DRIVE_FAIL_THRESHOLD", "4", "storage",
       "Consecutive drive faults before the per-drive circuit breaker "
       "(HealthCheckedDisk) takes the drive offline."),
    _k("MINIO_TPU_DRIVE_COOLDOWN_S", "15", "storage",
       "Seconds an offline drive's circuit stays open before one probe "
       "call is admitted (half-open)."),
    _k("MINIO_TPU_DRIVE_LATENCY_TRIP_S", "10", "storage",
       "Per-drive EWMA call latency that trips the circuit breaker: a "
       "chronically slow drive goes offline like an erroring one; 0 "
       "disables."),
    _k("MINIO_TPU_FSYNC", "0", "storage",
       "fsync shard files on write (1) instead of trusting the page "
       "cache (0)."),
    _k("MINIO_TPU_ODIRECT", "off", "storage",
       "O_DIRECT for large sequential shard I/O (`on`/`off`)."),
    # -- tpu / ops --------------------------------------------------------
    _k("MINIO_TPU_BATCH_WINDOW_MS", "2", "tpu",
       "Straggler window a stripe block may wait for batch-mates before "
       "the fused encode dispatches."),
    _k("MINIO_TPU_FUSED_CM", "1", "tpu",
       "Chunk-major fused encode/decode+hash mega-kernel (0 forces the "
       "row-major XLA path)."),
    _k("MINIO_TPU_NO_NATIVE", None, "tpu",
       "Set to disable loading the native helper extension entirely."),
    _k("MINIO_TPU_TORCH_DEVICE", "cuda", "tpu",
       "Torch device of the codecs and kernels: `cuda` (the card; a host "
       "without one refuses to start) or `cpu` (the kernels' plain "
       "versions)."),
]

KNOBS: dict[str, Knob] = {k.name: k for k in _ALL if not k.prefix}
PREFIX_KNOBS: dict[str, Knob] = {k.name: k for k in _ALL if k.prefix}


def generate_config_md() -> str:
    """minio_tpu_torch/docs/CONFIG.md content: one table per subsystem."""
    by_sub: dict[str, list[Knob]] = {}
    for k in _ALL:
        by_sub.setdefault(k.subsystem, []).append(k)
    out = [
        "# Configuration knobs",
        "",
        "Generated from `minio_tpu_torch/analysis/knobs.py` by",
        "`python -m minio_tpu_torch.analysis --gen-config-docs` — do not edit by",
        "hand. The `knob` rule of `miniovet` fails the build when the code",
        "reads a `MINIO_*` variable not declared there, so this file lists",
        "every knob the code actually reads.",
        "",
        "Names ending in `_` are families: the suffix is a target id,",
        "e.g. `MINIO_NOTIFY_WEBHOOK_ENABLE_PRIMARY`.",
        "",
    ]
    for sub in sorted(by_sub):
        out.append(f"## {sub}")
        out.append("")
        out.append("| Knob | Default | Description |")
        out.append("|---|---|---|")
        for k in sorted(by_sub[sub], key=lambda k: k.name):
            if k.default is None:
                default = "_(none)_"
            elif k.default == "":
                default = "_(empty)_"
            else:
                default = f"`{k.default}`"
            name = f"`{k.name}<ID>`" if k.prefix else f"`{k.name}`"
            out.append(f"| {name} | {default} | {k.description} |")
        out.append("")
    return "\n".join(out)
