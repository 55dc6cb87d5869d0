"""Placement policy engine: which pool does a new object land in?

Rules are small documents persisted at
``.minio.sys/placement/rules.json`` (through the object layer itself, so
they ride erasure coding, the cache choke points, and — in worker pools
and clusters — the shared drives every process reads). Each rule names a
bucket (exact) and a key prefix, and either **pins** matching objects to
one pool or **spreads** them deterministically across a pool list; the
longest bucket+prefix match wins. Unruled keys fall to the
**weight-by-free-space** default: the key hashes to a point on the
cumulative free-space distribution, so new writes land proportionally to
where the capacity is (the bare most-free heuristic chased one pool
until usage crossed over; weighting converges without herding).

Consulted on the PUT path (``ServerPools.put_object``, multipart
``new_upload``) and by the rebalance/decommission mover
(``erasure/decommission.py``): rebalance never drains a pinned key off
its pinned pool, and moves mis-placed pinned keys TO their pool.

Rule reads are lock-free against a snapshot list; mutations re-persist
the whole document and bump the in-memory copy. Other processes re-read
after ``MINIO_TPU_PLACEMENT_REFRESH_S`` (admin fan-out refreshes
immediately). Writes into ``.minio.sys`` itself never consult the engine
(the persistence write would recurse).
"""

from __future__ import annotations

import json
import os
import threading
import time

from .. import obs
from ..storage.errors import StorageError
from ..utils.hashing import sip_hash_mod

SYSTEM_BUCKET = ".minio.sys"
RULES_KEY = "placement/rules.json"

_MODES = ("pin", "spread")


def emit(trace_type: str, name: str, **fields) -> None:
    """Publish a placement/rebalance obs record (admin mutations, pool
    attach/detach, rebalance pass progress). One module-attribute read
    when nobody is tracing."""
    if not obs.active():
        return
    rec = {
        "time": time.time(),
        "type": trace_type,
        "name": name,
        "reqId": obs.current_request_id(),
        "node": obs.trace.NODE,
        "error": "",
    }
    rec.update(fields)
    obs.publish(rec)


def placement_enabled() -> bool:
    return os.environ.get("MINIO_TPU_PLACEMENT", "1") != "0"


def _refresh_s() -> float:
    try:
        return max(0.0, float(os.environ.get(
            "MINIO_TPU_PLACEMENT_REFRESH_S", "5") or 5))
    except ValueError:
        return 5.0


class PlacementRule:
    """One placement rule. ``pools`` are pool indexes into
    ``ServerPools.pools``; ``pin`` uses the first one that exists,
    ``spread`` hashes the key across all that exist."""

    __slots__ = ("bucket", "prefix", "mode", "pools", "hits")

    def __init__(self, bucket: str, prefix: str, mode: str,
                 pools: list[int]):
        if not bucket or bucket.startswith(SYSTEM_BUCKET):
            raise ValueError(f"bad placement bucket {bucket!r}")
        if mode not in _MODES:
            raise ValueError(f"placement mode must be one of {_MODES}")
        if not pools or not all(
            isinstance(p, int) and p >= 0 for p in pools
        ):
            raise ValueError("placement pools must be non-negative indexes")
        if mode == "pin" and len(pools) != 1:
            raise ValueError("pin takes exactly one pool")
        self.bucket = bucket
        self.prefix = prefix
        self.mode = mode
        self.pools = list(pools)
        self.hits = 0

    @property
    def key(self) -> str:
        return f"{self.bucket}/{self.prefix}"

    def matches(self, bucket: str, obj: str) -> bool:
        return bucket == self.bucket and obj.startswith(self.prefix)

    def to_dict(self) -> dict:
        return {"bucket": self.bucket, "prefix": self.prefix,
                "mode": self.mode, "pools": list(self.pools),
                "hits": self.hits}

    @classmethod
    def from_dict(cls, d: dict) -> "PlacementRule":
        return cls(
            bucket=str(d.get("bucket", "")),
            prefix=str(d.get("prefix", "")),
            mode=str(d.get("mode", "")),
            pools=[int(p) for p in d.get("pools", [])],
        )


class PlacementPolicy:
    """The engine one ServerPools owns. Holds the rule snapshot, the
    cached per-pool free-space view, and the decision counters the
    ``/api/topology`` metrics group exports."""

    def __init__(self, store):
        import weakref

        self._store = weakref.ref(store)  # owner holds us; no cycle
        self._mu = threading.Lock()
        self._rules: list[PlacementRule] = []
        self._loaded_at = 0.0     # 0 = never loaded (load on first use)
        self._free_snapshot: list[int] = []
        self._free_at = 0.0
        self.decisions = {"pin": 0, "spread": 0, "free": 0}

    # -- persistence -------------------------------------------------------

    def _load_locked(self) -> None:
        store = self._store()
        if store is None:
            return
        from ..erasure.quorum import ErasureError

        try:
            _, it = store.get_object(SYSTEM_BUCKET, RULES_KEY)
            docs = json.loads(b"".join(it))
        except (ErasureError, StorageError, OSError, ValueError):
            # absent (fresh deployment), unreadable, or corrupt: an empty
            # rule set is the safe reading — the default path still places
            docs = []
        old = {r.key: r.hits for r in self._rules}
        rules = []
        for d in docs if isinstance(docs, list) else []:
            try:
                rules.append(PlacementRule.from_dict(d))
            except ValueError:
                continue  # one bad rule must not drop the rest
        # longest bucket+prefix first: the most specific rule wins
        rules.sort(key=lambda r: (len(r.bucket) + len(r.prefix)), reverse=True)
        for r in rules:  # hit counters survive reloads within a process
            r.hits = old.get(r.key, 0)
        self._rules = rules
        self._loaded_at = time.monotonic()

    def _persist_locked(self) -> None:
        store = self._store()
        if store is None:
            return
        doc = json.dumps(
            [{k: v for k, v in r.to_dict().items() if k != "hits"}
             for r in self._rules]
        ).encode()
        store.put_object(SYSTEM_BUCKET, RULES_KEY, doc)
        self._loaded_at = time.monotonic()

    def _fresh_rules(self) -> list[PlacementRule]:
        now = time.monotonic()
        with self._mu:
            if not self._loaded_at or now - self._loaded_at > _refresh_s():
                self._load_locked()
            return self._rules  # snapshot list: replaced, never mutated

    def reload(self) -> int:
        """Drop the cached copy and re-read (admin fan-out target)."""
        with self._mu:
            self._load_locked()
            return len(self._rules)

    # -- rule CRUD (admin plane) ------------------------------------------

    def set_rule(self, d: dict) -> dict:
        rule = PlacementRule.from_dict(d)
        store = self._store()
        n_pools = len(store.pools) if store is not None else 0
        if any(p >= n_pools for p in rule.pools):
            raise ValueError(
                f"rule names pool(s) {rule.pools} but only "
                f"{n_pools} pool(s) exist"
            )
        with self._mu:
            self._load_locked()
            self._rules = [r for r in self._rules if r.key != rule.key]
            self._rules.append(rule)
            self._rules.sort(
                key=lambda r: (len(r.bucket) + len(r.prefix)), reverse=True
            )
            self._persist_locked()
        emit(obs.TYPE_PLACEMENT, "placement.set", rule=rule.key,
             mode=rule.mode, pools=list(rule.pools))
        return rule.to_dict()

    def delete_rule(self, bucket: str, prefix: str) -> bool:
        key = f"{bucket}/{prefix}"
        with self._mu:
            self._load_locked()
            before = len(self._rules)
            self._rules = [r for r in self._rules if r.key != key]
            removed = len(self._rules) != before
            if removed:
                self._persist_locked()
        if removed:
            emit(obs.TYPE_PLACEMENT, "placement.delete", rule=key)
        return removed

    def rules(self) -> list[dict]:
        return [r.to_dict() for r in self._fresh_rules()]

    def reindex_after_remove(self, removed: int) -> None:
        """A pool was detached: rules address pools by INDEX, so every
        surviving rule's indexes shift down past the removed one, and
        references to the removed pool itself drop (a rule left with no
        pools drops entirely — silently mis-pinning to a different
        physical pool would be worse than falling back to the weighted
        default)."""
        with self._mu:
            self._load_locked()
            out = []
            for r in self._rules:
                pools = [
                    p - 1 if p > removed else p
                    for p in r.pools if p != removed
                ]
                if not pools or (r.mode == "pin" and len(pools) != 1):
                    continue
                nr = PlacementRule(r.bucket, r.prefix, r.mode, pools)
                nr.hits = r.hits
                out.append(nr)
            self._rules = out
            self._persist_locked()

    def status(self) -> dict:
        with self._mu:
            return {
                "enabled": placement_enabled(),
                "rules": [r.to_dict() for r in self._rules],
                "decisions": dict(self.decisions),
            }

    # -- decisions ---------------------------------------------------------

    def match(self, bucket: str, obj: str) -> PlacementRule | None:
        if bucket.startswith(SYSTEM_BUCKET) or not placement_enabled():
            return None
        for r in self._fresh_rules():
            if r.matches(bucket, obj):
                return r
        return None

    def pinned_pool(self, bucket: str, obj: str) -> int | None:
        """The pool index a pin rule binds this key to, or None. The
        rebalance mover asks this for every candidate move."""
        r = self.match(bucket, obj)
        if r is not None and r.mode == "pin":
            store = self._store()
            if store is not None and r.pools[0] < len(store.pools):
                return r.pools[0]
        return None

    def _count(self, kind: str, rule: PlacementRule | None = None) -> None:
        with self._mu:
            self.decisions[kind] = self.decisions.get(kind, 0) + 1
            if rule is not None:
                rule.hits += 1

    def _free_per_pool(self) -> list[int]:
        """Cached free-bytes-per-pool snapshot (one disk_info fan-out per
        refresh window, not per PUT)."""
        store = self._store()
        if store is None:
            return []
        now = time.monotonic()
        with self._mu:
            if self._free_snapshot and now - self._free_at <= _refresh_s():
                if len(self._free_snapshot) == len(store.pools):
                    return self._free_snapshot
        snap = []
        for p in store.pools:
            free = 0
            for d in p.disks:
                try:
                    free += d.disk_info().free
                except (StorageError, OSError):
                    pass  # offline drive contributes no free space
            snap.append(free)
        with self._mu:
            self._free_snapshot = snap
            self._free_at = now
        return snap

    def pool_index_for(self, bucket: str, obj: str) -> int:
        """Pool index a NEW object should land in (the overwrite-in-place
        check happens in the caller, before this). Decommissioning pools
        (``store.draining``) take no new objects — a rule naming only
        draining pools falls through to the weighted default."""
        store = self._store()
        if store is None or len(store.pools) < 2:
            return 0
        draining = getattr(store, "draining", set())
        if len(draining) >= len(store.pools):
            draining = set()  # everything draining: placement can't help
        rule = self.match(bucket, obj)
        if rule is not None:
            live = [
                p for p in rule.pools
                if p < len(store.pools) and p not in draining
            ]
            if live:
                if rule.mode == "pin":
                    self._count("pin", rule)
                    return live[0]
                idx = live[sip_hash_mod(
                    f"{bucket}/{obj}", len(live), _SPREAD_KEY
                )]
                self._count("spread", rule)
                return idx
        free = self._free_per_pool()
        free = [
            0 if i in draining else f for i, f in enumerate(free)
        ]
        total = sum(free)
        if total <= 0:
            self._count("free")
            return 0
        # deterministic weighted choice: the key hashes to a point on the
        # cumulative free-space distribution
        point = sip_hash_mod(f"{bucket}/{obj}", 1 << 20, _SPREAD_KEY) / (1 << 20)
        acc = 0.0
        for i, f in enumerate(free):
            acc += f / total
            if point < acc:
                self._count("free")
                return i
        self._count("free")
        # float-rounding fallthrough: last pool with any weight
        return max(i for i, f in enumerate(free) if f > 0)


# spread/weighting hash key: fixed, NOT per-deployment — every worker and
# node must route one key identically, and the deployment id is per-pool
# (expansion mints a new one), so it cannot serve as the shared key
_SPREAD_KEY = b"minio-tpu-placement\0\0\0\0\0"[:16]
