"""Warm-tier backends for ILM transitions.

Mirrors the reference's tier config + warm backends
(MinIO cmd/tier.go, cmd/warm-backend-minio.go,
cmd/warm-backend-s3.go): a named remote S3-compatible endpoint where
transitioned object data lives. The tier registry persists in the
backend; transitioned objects carry the tier name + remote key in their
metadata and are read through (or restored) on demand.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from dataclasses import dataclass

from ..client import S3Client

SYSTEM_BUCKET = ".minio.sys"
TIERS_KEY = "config/tiers.json"

# object metadata markers (internal; stripped from client responses)
TRANSITION_TIER_META = "x-minio-internal-transition-tier"
TRANSITION_KEY_META = "x-minio-internal-transitioned-key"
RESTORE_EXPIRY_META = "x-minio-internal-restore-expiry"


@dataclass
class Tier:
    name: str
    endpoint: str
    access_key: str
    secret_key: str
    bucket: str
    prefix: str = ""
    # "minio"/"s3" share the S3 wire protocol; "azure" = Blob REST with
    # SharedKey (access_key=account, secret_key=account key); "gcs" = JSON
    # API with a service-account JWT (secret_key=the SA JSON) — the same
    # four families as the reference's warm backends (cmd/warm-backend-*.go)
    tier_type: str = "minio"

    def client(self):
        # cached per Tier: the GCS backend holds an OAuth token that must
        # survive across operations (one JWT exchange per hour, not per op)
        c = getattr(self, "_client", None)
        if c is not None:
            return c
        if self.tier_type == "azure":
            from .warm_backends import AzureWarmClient

            c = AzureWarmClient(self.endpoint, self.access_key, self.secret_key)
        elif self.tier_type == "gcs":
            from .warm_backends import GCSWarmClient

            c = GCSWarmClient(self.endpoint, self.secret_key)
        else:
            c = S3Client(self.endpoint, self.access_key, self.secret_key)
        self._client = c
        return c

    def remote_key(self, bucket: str, obj: str) -> str:
        """Unique per transition epoch: a later re-transition of a changed
        object must not collide with stale tier data."""
        return f"{self.prefix}{bucket}/{obj}/{uuid.uuid4()}"

    def to_dict(self) -> dict:
        # private state (the cached client) must not persist to tiers.json
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}


def is_transitioned(user_defined: dict) -> bool:
    return bool(user_defined.get(TRANSITION_TIER_META))


class TierRegistry:
    """Named warm tiers persisted in the backend (reference cmd/tier.go)."""

    def __init__(self, store):
        self.store = store
        self._tiers: dict[str, Tier] = {}
        self._loaded = False
        self._mu = threading.Lock()

    def _load(self) -> None:
        if self._loaded:
            return
        with self._mu:
            if self._loaded:
                return
            from ..erasure.quorum import BucketNotFound, ObjectNotFound

            try:
                _, it = self.store.get_object(SYSTEM_BUCKET, TIERS_KEY)
                self._tiers = {
                    name: Tier(**d) for name, d in json.loads(b"".join(it)).items()
                }
            except (ObjectNotFound, BucketNotFound):
                self._tiers = {}
            self._loaded = True

    def _persist(self) -> None:
        self.store.put_object(
            SYSTEM_BUCKET, TIERS_KEY,
            json.dumps({n: t.to_dict() for n, t in self._tiers.items()}).encode(),
        )

    def set(self, t: Tier) -> None:
        self._load()
        with self._mu:
            self._tiers[t.name] = t
            self._persist()

    def remove(self, name: str) -> None:
        self._load()
        with self._mu:
            self._tiers.pop(name, None)
            self._persist()

    def get(self, name: str) -> Tier | None:
        self._load()
        return self._tiers.get(name)

    def list(self) -> list[Tier]:
        self._load()
        return list(self._tiers.values())


# ---- tier garbage collection (reference cmd/tier-sweeper.go + the tier
# journal): when a transitioned version's local stub is deleted or
# overwritten, its warm-tier data must be swept or it is orphaned forever.

JOURNAL_KEY = "config/tier-journal.json"
_journal_mu = threading.Lock()
# cached entry count so metrics scrapes don't pay a store read per scrape;
# local mutations refresh it immediately, and a TTL re-reads the shared
# journal so OTHER nodes' additions surface too (the journal object is
# cluster-shared, the cache is per-process)
_journal_count: int | None = None
_journal_count_ts = 0.0
JOURNAL_CACHE_TTL = 60.0


def _journal_load(store) -> list[dict]:
    from ..erasure.quorum import BucketNotFound, ObjectNotFound

    try:
        _, it = store.get_object(SYSTEM_BUCKET, JOURNAL_KEY)
        return json.loads(b"".join(it))
    except (ObjectNotFound, BucketNotFound, ValueError):
        return []


def _journal_save(store, entries: list[dict]) -> None:
    store.put_object(SYSTEM_BUCKET, JOURNAL_KEY, json.dumps(entries).encode())


def journal_add(store, tier_name: str, remote_key: str) -> None:
    """Persist a failed sweep for retry (the reference's tierJournal)."""
    global _journal_count, _journal_count_ts
    with _journal_mu:
        entries = _journal_load(store)
        entries.append({"tier": tier_name, "key": remote_key})
        _journal_save(store, entries)
        _journal_count = len(entries)
        _journal_count_ts = time.monotonic()


def journal_size(store) -> int:
    """Entry count for metrics: cached with a TTL — local mutations
    refresh it instantly, and the periodic re-read picks up entries other
    nodes journaled into the shared object."""
    global _journal_count, _journal_count_ts
    with _journal_mu:
        now = time.monotonic()
        if _journal_count is None or now - _journal_count_ts > JOURNAL_CACHE_TTL:
            _journal_count = len(_journal_load(store))
            _journal_count_ts = now
        return _journal_count


def retry_journal(tiers: "TierRegistry") -> int:
    """Retry journaled sweeps (scanner-driven). Returns entries remaining.

    The journal lock is NOT held across the remote deletes — a down tier
    endpoint means minutes of cumulative timeouts, and journal_add sits on
    the client write path."""
    with _journal_mu:
        entries = _journal_load(tiers.store)
    if not entries:
        return 0
    resolved = []  # entries to drop: swept, or tier deconfigured
    for e in entries:
        t = tiers.get(e.get("tier", ""))
        if t is None:
            resolved.append(e)  # tier gone: nothing to sweep anymore
            continue
        try:
            r = t.client().delete_object(t.bucket, e["key"])
            if r.status not in (200, 204, 404):
                raise OSError(f"tier delete status {r.status}")
            resolved.append(e)
        except Exception:  # noqa: BLE001 — keep for the next cycle
            pass
    global _journal_count, _journal_count_ts
    with _journal_mu:
        # re-read: new failures may have been journaled while we swept
        current = _journal_load(tiers.store)
        left = [e for e in current if e not in resolved]
        _journal_save(tiers.store, left)
        _journal_count = len(left)
        _journal_count_ts = time.monotonic()
        return len(left)


def sweep_remote(tiers: "TierRegistry", user_defined: dict | None) -> None:
    """Delete a removed version's data from its warm tier. Best-effort
    direct delete; failures land in the persisted journal and are retried
    by the scanner (reference deletes via the tier journal exclusively —
    we inline the common case and journal only failures)."""
    ud = user_defined or {}
    name = ud.get(TRANSITION_TIER_META, "")
    rkey = ud.get(TRANSITION_KEY_META, "")
    if not name or not rkey:
        return
    t = tiers.get(name)
    if t is None:
        return
    try:
        r = t.client().delete_object(t.bucket, rkey)
        if r.status not in (200, 204, 404):
            raise OSError(f"tier delete status {r.status}")
    except Exception:  # noqa: BLE001 — journal for scanner retry
        try:
            journal_add(tiers.store, name, rkey)
        except Exception:  # noqa: BLE001 — journaling is best-effort too
            pass
