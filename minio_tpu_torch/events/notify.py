"""Event notification system.

Mirrors the reference's event plane (MinIO cmd/event-notification.go
+ internal/event): bucket notification configs route object events by event
name + prefix/suffix filters to ARN-addressed targets; deliveries retry from
a persistent per-target queue; the listen API is a real-time pubsub firehose
of the same records (cmd/listen-notification-handlers.go).

Targets here: webhook (HTTP POST, the universal sink) and a file target for
local pipelines; the target registry mirrors the reference's env-driven
config (MINIO_NOTIFY_WEBHOOK_ENABLE_<id>/..._ENDPOINT_<id>).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import urllib.request
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

# S3 event names (subset the object layer emits)
OBJECT_CREATED_PUT = "s3:ObjectCreated:Put"
OBJECT_CREATED_COPY = "s3:ObjectCreated:Copy"
OBJECT_CREATED_MULTIPART = "s3:ObjectCreated:CompleteMultipartUpload"
OBJECT_REMOVED_DELETE = "s3:ObjectRemoved:Delete"
OBJECT_REMOVED_MARKER = "s3:ObjectRemoved:DeleteMarkerCreated"
OBJECT_ACCESSED_GET = "s3:ObjectAccessed:Get"
OBJECT_ACCESSED_HEAD = "s3:ObjectAccessed:Head"


def event_matches(pattern: str, event: str) -> bool:
    """'s3:ObjectCreated:*' style matching."""
    if pattern.endswith("*"):
        return event.startswith(pattern[:-1])
    return pattern == event


@dataclass
class NotificationRule:
    arn: str
    events: list[str]
    prefix: str = ""
    suffix: str = ""

    def matches(self, event_name: str, key: str) -> bool:
        if not any(event_matches(p, event_name) for p in self.events):
            return False
        if self.prefix and not key.startswith(self.prefix):
            return False
        if self.suffix and not key.endswith(self.suffix):
            return False
        return True


def parse_notification_config(xml_text: str) -> list[NotificationRule]:
    """Parse NotificationConfiguration XML (Queue/Topic/CloudFunction)."""
    rules: list[NotificationRule] = []
    if not xml_text or "<NotificationConfiguration" not in xml_text:
        return rules
    root = ET.fromstring(xml_text)
    for conf in root:
        tag = conf.tag.split("}")[-1]
        if tag not in (
            "QueueConfiguration", "TopicConfiguration", "CloudFunctionConfiguration"
        ):
            continue
        arn, events, prefix, suffix = "", [], "", ""
        for el in conf.iter():
            t = el.tag.split("}")[-1]
            if t in ("Queue", "Topic", "CloudFunction") and el.text:
                arn = el.text
            elif t == "Event" and el.text:
                events.append(el.text)
            elif t == "FilterRule":
                name = value = ""
                for sub in el:
                    st = sub.tag.split("}")[-1]
                    if st == "Name":
                        name = (sub.text or "").lower()
                    elif st == "Value":
                        value = sub.text or ""
                if name == "prefix":
                    prefix = value
                elif name == "suffix":
                    suffix = value
        if arn and events:
            rules.append(NotificationRule(arn, events, prefix, suffix))
    return rules


def new_event(
    event_name: str, bucket: str, key: str, size: int, etag: str,
    version_id: str = "", request_id: str = "", user: str = "",
) -> dict:
    """S3 event record JSON (the schema notification consumers parse)."""
    now = time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime())
    return {
        "eventVersion": "2.1",
        "eventSource": "minio-tpu:s3",
        "awsRegion": "",
        "eventTime": now,
        "eventName": event_name,
        "userIdentity": {"principalId": user},
        "requestParameters": {},
        "responseElements": {"x-amz-request-id": request_id},
        "s3": {
            "s3SchemaVersion": "1.0",
            "configurationId": "Config",
            "bucket": {
                "name": bucket,
                "ownerIdentity": {"principalId": user},
                "arn": f"arn:aws:s3:::{bucket}",
            },
            "object": {
                "key": key,
                "size": size,
                "eTag": etag,
                "versionId": version_id,
                "sequencer": format(time.time_ns(), "016x"),
            },
        },
    }


class Target:
    arn: str = ""

    def send(self, record: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class WebhookTarget(Target):
    def __init__(self, ident: str, endpoint: str, auth_token: str = ""):
        self.arn = f"arn:minio:sqs::{ident}:webhook"
        self.endpoint = endpoint
        self.auth_token = auth_token

    def send(self, record: dict) -> None:
        body = json.dumps({"EventName": record["eventName"], "Key":
                           f"{record['s3']['bucket']['name']}/{record['s3']['object']['key']}",
                           "Records": [record]}).encode()
        req = urllib.request.Request(
            self.endpoint, data=body,
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.auth_token}"} if self.auth_token else {})},
        )
        urllib.request.urlopen(req, timeout=5).read()


class FileTarget(Target):
    """Append events to a local JSONL file (log/audit pipelines)."""

    def __init__(self, ident: str, path: str):
        self.arn = f"arn:minio:sqs::{ident}:file"
        self.path = path
        self._mu = threading.Lock()

    def send(self, record: dict) -> None:
        with self._mu, open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


def targets_from_env() -> dict[str, Target]:
    """MINIO_NOTIFY_WEBHOOK_ENABLE_<ID>=on + ..._ENDPOINT_<ID>=url, and
    MINIO_NOTIFY_FILE_ENABLE_<ID>=on + ..._PATH_<ID>=path."""
    out: dict[str, Target] = {}
    for k, v in os.environ.items():
        if k.startswith("MINIO_NOTIFY_WEBHOOK_ENABLE_") and v in ("on", "true", "1"):
            ident = k.rsplit("_", 1)[-1].lower()
            ep = os.environ.get(f"MINIO_NOTIFY_WEBHOOK_ENDPOINT_{ident.upper()}", "")
            if ep:
                t = WebhookTarget(
                    ident, ep,
                    os.environ.get(f"MINIO_NOTIFY_WEBHOOK_AUTH_TOKEN_{ident.upper()}", ""),
                )
                out[t.arn] = t
        if k.startswith("MINIO_NOTIFY_FILE_ENABLE_") and v in ("on", "true", "1"):
            ident = k.rsplit("_", 1)[-1].lower()
            path = os.environ.get(f"MINIO_NOTIFY_FILE_PATH_{ident.upper()}", "")
            if path:
                t = FileTarget(ident, path)
                out[t.arn] = t
    from .targets import socket_targets_from_env

    out.update(socket_targets_from_env(os.environ))
    return out


@dataclass
class _Pending:
    record: dict
    arn: str
    attempts: int = 0


class EventNotifier:
    """Routes events to matching targets with retrying delivery workers
    + the real-time listen pubsub."""

    def __init__(self, bucket_metadata_sys, targets: dict[str, Target] | None = None):
        self.buckets = bucket_metadata_sys
        self.targets = targets if targets is not None else targets_from_env()
        self._rules_cache: dict[str, tuple[str, list[NotificationRule]]] = {}
        self._q: queue.Queue[_Pending] = queue.Queue(maxsize=10000)
        self._listeners: list = []
        self._mu = threading.Lock()
        self.stats = {"sent": 0, "failed": 0, "dropped": 0}
        self._worker = threading.Thread(target=self._deliver_loop, daemon=True)
        self._worker.start()

    # -- config ------------------------------------------------------------

    def rules_for(self, bucket: str) -> list[NotificationRule]:
        xml_text = self.buckets.get(bucket).notification or ""
        cached = self._rules_cache.get(bucket)
        if cached and cached[0] == xml_text:
            return cached[1]
        rules = parse_notification_config(xml_text)
        self._rules_cache[bucket] = (xml_text, rules)
        return rules

    def validate_config(self, xml_text: str) -> None:
        """Raise ValueError for unparseable configs or unknown target ARNs."""
        rules = parse_notification_config(xml_text)
        for r in rules:
            if r.arn not in self.targets:
                raise ValueError(f"unknown notification target ARN {r.arn}")

    # -- emit --------------------------------------------------------------

    def notify(self, event_name: str, bucket: str, key: str, size: int = 0,
               etag: str = "", version_id: str = "", user: str = "") -> None:
        record = None
        for rule in self.rules_for(bucket):
            if rule.matches(event_name, key):
                if record is None:
                    record = new_event(
                        event_name, bucket, key, size, etag, version_id, user=user
                    )
                try:
                    self._q.put_nowait(_Pending(record, rule.arn))
                except queue.Full:
                    self._stat("dropped")
        # listen API subscribers see every event regardless of config
        with self._mu:
            subs = list(self._listeners)
        if subs:
            if record is None:
                record = new_event(
                    event_name, bucket, key, size, etag, version_id, user=user
                )
            for q_, fltr in subs:
                fb, fprefix, fsuffix, fevents = fltr
                if fb and fb != bucket:
                    continue
                if fprefix and not key.startswith(fprefix):
                    continue
                if fsuffix and not key.endswith(fsuffix):
                    continue
                if fevents and not any(event_matches(p, event_name) for p in fevents):
                    continue
                try:
                    q_.put_nowait(record)
                except queue.Full:
                    pass

    # -- delivery ----------------------------------------------------------

    def _stat(self, key: str) -> None:
        # delivery counters are bumped from the S3 handler context AND
        # the delivery worker thread; dict += is a load/add/store
        # interleave under the GIL, so both sides take the lock
        # (miniovet races pass)
        with self._mu:
            self.stats[key] += 1

    def _deliver_loop(self) -> None:
        while True:
            p = self._q.get()
            target = self.targets.get(p.arn)
            if target is None:
                self._stat("dropped")
                continue
            try:
                target.send(p.record)
                self._stat("sent")
            except Exception:  # noqa: BLE001 — retry with backoff
                p.attempts += 1
                if p.attempts < 5:
                    threading.Timer(
                        min(2 ** p.attempts, 30), lambda: self._q.put(p)
                    ).start()
                else:
                    self._stat("failed")

    # -- listen API --------------------------------------------------------

    def subscribe(self, bucket: str = "", prefix: str = "", suffix: str = "",
                  events: list[str] | None = None):
        q_: queue.Queue = queue.Queue(maxsize=1000)
        ent = (q_, (bucket, prefix, suffix, events or []))
        with self._mu:
            self._listeners.append(ent)
        return ent

    def unsubscribe(self, ent) -> None:
        with self._mu:
            if ent in self._listeners:
                self._listeners.remove(ent)
