"""Audit + server logging targets.

Mirrors the reference's logger target system (internal/logger/targets.go):
structured request audit records stream to env-configured HTTP webhooks
(MINIO_AUDIT_WEBHOOK_ENABLE_<ID>/..._ENDPOINT_<ID>) with a bounded retry
queue; console logging stays on stderr.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import urllib.request


class AuditLog:
    def __init__(self):
        self.endpoints: list[tuple[str, str]] = []  # (endpoint, token)
        for k, v in os.environ.items():
            if k.startswith("MINIO_AUDIT_WEBHOOK_ENABLE_") and v in ("on", "true", "1"):
                ident = k.rsplit("_", 1)[-1].upper()
                ep = os.environ.get(f"MINIO_AUDIT_WEBHOOK_ENDPOINT_{ident}", "")
                tok = os.environ.get(f"MINIO_AUDIT_WEBHOOK_AUTH_TOKEN_{ident}", "")
                if ep:
                    self.endpoints.append((ep, tok))
        # audit-to-Kafka (reference internal/logger/target/kafka): same
        # raw Produce client the event sinks use
        self.kafka = None
        if os.environ.get("MINIO_AUDIT_KAFKA_ENABLE", "") in ("on", "true", "1"):
            brokers = os.environ.get("MINIO_AUDIT_KAFKA_BROKERS", "")
            topic = os.environ.get("MINIO_AUDIT_KAFKA_TOPIC", "minio-audit")
            if brokers:
                from ..events.kafka import KafkaTarget

                self.kafka = KafkaTarget("audit", brokers.split(",")[0].strip(), topic)
        self._q: queue.Queue = queue.Queue(maxsize=5000)
        self.stats = {"sent": 0, "failed": 0, "dropped": 0}
        if self.enabled:
            threading.Thread(target=self._loop, daemon=True, name="audit").start()

    @property
    def enabled(self) -> bool:
        return bool(self.endpoints) or self.kafka is not None

    def emit(self, record: dict) -> None:
        if not self.enabled:
            return
        try:
            self._q.put_nowait(record)
        except queue.Full:
            self.stats["dropped"] += 1

    def _loop(self) -> None:
        while True:
            rec = self._q.get()
            body = json.dumps(rec).encode()
            for ep, tok in self.endpoints:
                try:
                    req = urllib.request.Request(
                        ep, data=body,
                        headers={"Content-Type": "application/json",
                                 **({"Authorization": f"Bearer {tok}"} if tok else {})},
                    )
                    urllib.request.urlopen(req, timeout=5).read()
                    self.stats["sent"] += 1
                except Exception:  # noqa: BLE001
                    self.stats["failed"] += 1
            if self.kafka is not None:
                try:
                    self.kafka.send_raw(body)
                    self.stats["sent"] += 1
                except Exception:  # noqa: BLE001
                    self.stats["failed"] += 1


def audit_record(
    request, status: int, dur: float, access_key: str,
    rx: int = 0, tx: int = 0,
) -> dict:
    """madmin-style audit entry (reference internal/logger/audit.go).
    Carries the generated x-amz-request-id so audit rows join against
    trace streams and client-side error reports, and the bytes counted
    at write time (streamed responses would otherwise audit as 0)."""
    import time

    return {
        "version": "1",
        "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "requestID": request.get("_reqid", ""),
        "api": {
            "name": request.method,
            "bucket": request.match_info.get("bucket", ""),
            "object": request.match_info.get("key", ""),
            "status": "OK" if status < 400 else "Error",
            "statusCode": status,
            "rx": rx,
            "tx": tx,
            "timeToResponseNs": int(dur * 1e9),
        },
        "remoteHost": request.remote or "",
        "requestPath": request.path,
        "requestQuery": request.rel_url.raw_query_string,
        "accessKey": access_key,
    }
