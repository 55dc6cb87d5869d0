"""Async bucket replication.

Mirrors the reference's continuous replication plane
(MinIO cmd/bucket-replication.go): a bucket's replication config
routes object writes/deletes to ARN-addressed remote targets; a worker
pool drains an in-memory queue with retries (the MRF analogue,
queueMRFSave :482); resync replays the whole namespace. Remote targets are
S3 endpoints driven by our own client (the reference uses minio-go).
"""

from __future__ import annotations

import json
import queue
import threading
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from ..client import S3Client

TARGETS_KEY = "config/replication-targets.json"
SYSTEM_BUCKET = ".minio.sys"


@dataclass
class ReplicationRule:
    rule_id: str = ""
    status: str = "Enabled"
    priority: int = 0
    prefix: str = ""
    destination_arn: str = ""
    delete_replication: bool = True

    def matches(self, key: str) -> bool:
        return self.status == "Enabled" and key.startswith(self.prefix)


def parse_replication_config(xml_text: str) -> list[ReplicationRule]:
    if not xml_text:
        return []
    root = ET.fromstring(xml_text)
    rules = []
    for rel in root:
        if not rel.tag.endswith("Rule"):
            continue
        r = ReplicationRule()
        for el in rel:  # direct children only: nested Status (e.g. inside
            t = el.tag.split("}")[-1]  # DeleteMarkerReplication) must not
            if t == "ID":  # override the rule's own status
                r.rule_id = el.text or ""
            elif t == "Status":
                r.status = el.text or "Enabled"
            elif t == "Priority" and el.text:
                r.priority = int(el.text)
            elif t in ("Prefix", "Filter"):
                for sub in el.iter():
                    if sub.tag.split("}")[-1] == "Prefix" and sub.text:
                        r.prefix = sub.text
                if t == "Prefix" and el.text:
                    r.prefix = el.text
            elif t == "Destination":
                for sub in el.iter():
                    if sub.tag.split("}")[-1] == "Bucket" and sub.text:
                        r.destination_arn = sub.text
        rules.append(r)
    return sorted(rules, key=lambda r: -r.priority)


@dataclass
class RemoteTarget:
    arn: str
    source_bucket: str
    endpoint: str
    access_key: str
    secret_key: str
    target_bucket: str

    def client(self) -> S3Client:
        return S3Client(self.endpoint, self.access_key, self.secret_key)

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class TargetRegistry:
    """Remote replication targets persisted in the backend
    (reference cmd/bucket-targets.go)."""

    def __init__(self, store):
        self.store = store
        self._targets: dict[str, RemoteTarget] = {}
        self._loaded = False
        self._mu = threading.Lock()

    def _load(self) -> None:
        from ..erasure.quorum import ObjectNotFound

        if self._loaded:
            return
        with self._mu:
            if self._loaded:
                return
            try:
                _, it = self.store.get_object(SYSTEM_BUCKET, TARGETS_KEY)
                data = json.loads(b"".join(it))
                self._targets = {
                    arn: RemoteTarget(**d) for arn, d in data.items()
                }
            except ObjectNotFound:
                self._targets = {}
            self._loaded = True

    def set(self, t: RemoteTarget) -> None:
        self._load()
        with self._mu:
            self._targets[t.arn] = t
            self.store.put_object(
                SYSTEM_BUCKET, TARGETS_KEY,
                json.dumps({a: x.to_dict() for a, x in self._targets.items()}).encode(),
            )

    def remove(self, arn: str) -> None:
        self._load()
        with self._mu:
            self._targets.pop(arn, None)
            self.store.put_object(
                SYSTEM_BUCKET, TARGETS_KEY,
                json.dumps({a: x.to_dict() for a, x in self._targets.items()}).encode(),
            )

    def get(self, arn: str) -> RemoteTarget | None:
        self._load()
        return self._targets.get(arn)

    def list(self, bucket: str = "") -> list[RemoteTarget]:
        self._load()
        return [
            t for t in self._targets.values()
            if not bucket or t.source_bucket == bucket
        ]


REPLICA_MARKER = "x-minio-source-replication-request"


@dataclass
class _Task:
    bucket: str
    key: str
    version_id: str
    op: str  # "put" | "delete"
    arn: str = ""  # destination (multi-target buckets fan out one task per rule)
    attempts: int = 0


class ReplicationPool:
    """Worker pool replicating object mutations to remote targets.

    `decode` (optional) inverts server-side transforms (compression/SSE) so
    replicas receive logical object bytes, mirroring the reference's
    replication which decrypts/re-encrypts per site."""

    def __init__(
        self, store, bucket_meta, targets: TargetRegistry, workers: int = 2,
        decode=None,
    ):
        self.store = store
        self.buckets = bucket_meta
        self.targets = targets
        self.decode = decode
        # one queue per worker with key-affinity: mutations of the SAME
        # object stay ordered (v1 must never land after v2 on the replica)
        self._qs: list[queue.Queue[_Task]] = [
            queue.Queue(maxsize=10000) for _ in range(workers)
        ]
        self._rules_cache: dict[str, tuple[str, list[ReplicationRule]]] = {}
        self.stats = {"replicated": 0, "deletes": 0, "failed": 0, "queued": 0}
        # per-bucket counters for the v3 /bucket/replication metrics group
        self.bucket_stats: dict[str, dict[str, int]] = {}
        self._threads = [
            threading.Thread(target=self._loop, args=(q_,), daemon=True,
                             name=f"repl-{i}")
            for i, q_ in enumerate(self._qs)
        ]
        for t in self._threads:
            t.start()

    def _queue_for(self, bucket: str, key: str) -> "queue.Queue[_Task]":
        return self._qs[hash((bucket, key)) % len(self._qs)]

    def rules_for(self, bucket: str) -> list[ReplicationRule]:
        xml_text = self.buckets.get(bucket).replication or ""
        cached = self._rules_cache.get(bucket)
        if cached and cached[0] == xml_text:
            return cached[1]
        try:
            rules = parse_replication_config(xml_text)
        except ET.ParseError:
            rules = []
        self._rules_cache[bucket] = (xml_text, rules)
        return rules

    def queue_mutation(self, bucket: str, key: str, version_id: str, op: str) -> None:
        """Called from the write path after a successful put/delete.

        Fans out one task per matching rule destination — a bucket in a
        multi-site group replicates every mutation to every peer."""
        seen: set[str] = set()
        for rule in self.rules_for(bucket):
            if rule.matches(key) and rule.destination_arn not in seen:
                seen.add(rule.destination_arn)
                try:
                    self._queue_for(bucket, key).put_nowait(
                        _Task(bucket, key, version_id, op, rule.destination_arn)
                    )
                    self.stats["queued"] += 1
                    self._bstat(bucket, "queued")
                except queue.Full:
                    self.stats["failed"] += 1
                    self._bstat(bucket, "failed")

    def resync(self, bucket: str) -> int:
        """Replay the whole bucket to its targets (reference resync)."""
        n = 0
        for raw in self.store.walk_objects(bucket):
            self.queue_mutation(bucket, raw, "", "put")
            n += 1
        return n

    def drain(self, timeout: float = 30.0) -> None:
        import time

        deadline = time.monotonic() + timeout
        while any(not q_.empty() for q_ in self._qs) and time.monotonic() < deadline:
            # miniovet: ignore[blocking] -- drain() is a blocking helper
            # for tests/shutdown; worker threads do the actual replication
            time.sleep(0.05)


    def _bstat(self, bucket: str, key: str) -> None:
        rec = self.bucket_stats.setdefault(
            bucket, {"replicated": 0, "deletes": 0, "failed": 0, "queued": 0}
        )
        rec[key] += 1

    # -- worker ------------------------------------------------------------

    def _loop(self, q_: "queue.Queue[_Task]") -> None:
        while True:
            task = q_.get()
            try:
                self._replicate(task)
            except Exception as e:  # noqa: BLE001 — retry then count as failed
                task.attempts += 1
                self.stats["last_error"] = f"{type(e).__name__}: {e}"
                if task.attempts < 3:
                    threading.Timer(
                        2 ** task.attempts, lambda: q_.put(task)
                    ).start()
                else:
                    self.stats["failed"] += 1
                    self._bstat(task.bucket, "failed")

    def _replicate(self, task: _Task) -> None:
        arn = task.arn
        if not arn:
            rules = self.rules_for(task.bucket)
            rule = next((r for r in rules if r.matches(task.key)), None)
            if rule is None:
                return
            arn = rule.destination_arn
        target = self.targets.get(arn)
        if target is None:
            raise RuntimeError(f"no target for {arn}")
        cli = target.client()
        # the marker tells the replica's server not to re-replicate (the
        # loop breaker for active-active site groups; reference marks
        # replicas with x-amz-replication-status=REPLICA the same way)
        marker = {REPLICA_MARKER: "true"}
        if task.op == "delete":
            r = cli.request(
                "DELETE", f"/{target.target_bucket}/{task.key}", headers=marker
            )
            if r.status not in (200, 204, 404):
                raise RuntimeError(f"remote delete failed: HTTP {r.status}")
            self.stats["deletes"] += 1
            self._bstat(task.bucket, "deletes")
            return
        oi, it = self.store.get_object(task.bucket, task.key, task.version_id)
        data = b"".join(it)
        if self.decode is not None:
            # invert compression/SSE so the replica stores logical bytes
            data = self.decode(oi, data, task.bucket, task.key)
        headers = {"content-type": oi.content_type, **marker}
        for k, v in oi.user_defined.items():
            if k.startswith("x-amz-meta-"):
                headers[k] = v
        r = cli.put_object(target.target_bucket, task.key, data, headers=headers)
        if r.status != 200:
            raise RuntimeError(f"remote put failed: HTTP {r.status}")
        self.stats["replicated"] += 1
        self._bstat(task.bucket, "replicated")
