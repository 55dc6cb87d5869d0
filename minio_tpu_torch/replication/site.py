"""Site replication: active-active sync of buckets, bucket metadata, and
IAM across independent clusters (reference cmd/site-replication.go:200,
SiteReplicationSys.Init at :232).

Design (smaller surface than the reference's 6.3k LoC, same semantics):

- A site group is a list of peers {name, endpoint, credentials}; every
  site stores the full list plus which entry is itself. The admin `add`
  call lands on one site, which identifies itself by deployment id,
  pushes a `join` to every other site, then runs the initial sync.
- Bucket creates/deletes, bucket metadata (policy, tags, lifecycle,
  versioning, ...) and the IAM snapshot (users, service accounts,
  groups, policies) propagate asynchronously through a retry queue to
  every peer's internal `site-replication/apply` admin endpoint. Peers
  apply without re-propagating (the origin already fans out to all).
- Objects ride the EXISTING bucket-replication plane: joining a site
  group wires every bucket with a remote target + rule per peer; the
  replica marker header breaks active-active loops.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field

from ..client import S3Client

SYSTEM_BUCKET = ".minio.sys"
CONFIG_KEY = "config/site-replication.json"


@dataclass
class SitePeer:
    name: str
    endpoint: str
    access_key: str
    secret_key: str
    deployment_id: str = ""

    def client(self) -> S3Client:
        return S3Client(self.endpoint, self.access_key, self.secret_key)

    def to_dict(self) -> dict:
        return dict(self.__dict__)


@dataclass
class _SyncItem:
    kind: str
    payload: dict
    attempts: int = 0
    pending: list[str] = field(default_factory=list)  # peer names left


class SiteReplicationSys:
    """Per-server site replication controller (owned by the S3 server)."""

    def __init__(self, server):
        self.server = server
        self.name = ""
        self.peers: list[SitePeer] = []  # includes self
        self._q: "queue.Queue[_SyncItem]" = queue.Queue(maxsize=10000)
        self.stats = {"synced": 0, "failed": 0, "queued": 0}
        self._loaded = False
        self._worker_started = False
        self._iam_pending = False
        self._mu = threading.Lock()

    # -- config ------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        self.load()
        return bool(self.name and len(self.peers) > 1)

    def others(self) -> list[SitePeer]:
        return [p for p in self.peers if p.name != self.name]

    def load(self) -> None:
        if self._loaded:
            return
        with self._mu:
            if self._loaded:
                return
            from ..erasure.quorum import BucketNotFound, ObjectNotFound

            try:
                _, it = self.server.store.get_object(SYSTEM_BUCKET, CONFIG_KEY)
                doc = json.loads(b"".join(it))
                self.name = doc.get("name", "")
                self.peers = [SitePeer(**p) for p in doc.get("peers", [])]
            except (ObjectNotFound, BucketNotFound):
                pass
            self._loaded = True
        if self.enabled:
            self._ensure_worker()

    def save(self) -> None:
        self.server.store.put_object(
            SYSTEM_BUCKET, CONFIG_KEY,
            json.dumps(
                {"name": self.name, "peers": [p.to_dict() for p in self.peers]}
            ).encode(),
        )

    def deployment_id(self) -> str:
        store = self.server.store
        pools = getattr(store, "pools", None)
        if pools:
            store = pools[0]
        dep = getattr(store, "deployment_id", "") or ""
        if dep:
            return dep
        # store layouts without a format.json deployment id (bare sets)
        # persist one so sites can identify themselves in a group
        from ..erasure.quorum import BucketNotFound, ObjectNotFound

        try:
            _, it = self.server.store.get_object(
                SYSTEM_BUCKET, "config/deployment-id"
            )
            return b"".join(it).decode()
        except (ObjectNotFound, BucketNotFound):
            import uuid

            dep = str(uuid.uuid4())
            self.server.store.put_object(
                SYSTEM_BUCKET, "config/deployment-id", dep.encode()
            )
            return dep

    # -- group formation ---------------------------------------------------

    def add_sites(self, sites: list[dict]) -> dict:
        """Coordinator: form the group, notify the other sites, seed them."""
        peers = []
        my_dep = self.deployment_id()
        my_name = ""
        for s in sites:
            peer = SitePeer(
                name=s["name"], endpoint=s["endpoint"],
                access_key=s["accessKey"], secret_key=s["secretKey"],
            )
            info = self._peer_info(peer)
            peer.deployment_id = info.get("deploymentID", "")
            if peer.deployment_id and peer.deployment_id == my_dep:
                my_name = peer.name
            peers.append(peer)
        if not my_name:
            raise ValueError("none of the given sites is this cluster")
        if len({p.name for p in peers}) != len(peers):
            raise ValueError("duplicate site names")
        # join every OTHER site first; only a fully-joined group is saved
        # locally (a half-formed group would retry-sync to absent peers
        # forever with no admin-visible breakage)
        doc = {"peers": [p.to_dict() for p in peers]}
        joined: list[SitePeer] = []
        try:
            for p in peers:
                if p.name == my_name:
                    continue
                r = p.client().request(
                    "POST", "/minio/admin/v3/site-replication/join",
                    body=json.dumps({**doc, "you": p.name}).encode(),
                )
                if r.status != 200:
                    raise RuntimeError(
                        f"site {p.name} join failed: HTTP {r.status} {r.body[:200]}"
                    )
                joined.append(p)
        except Exception:
            for p in joined:  # best-effort disband of partial joiners
                try:
                    p.client().request(
                        "POST", "/minio/admin/v3/site-replication/join",
                        body=json.dumps({"peers": [], "you": ""}).encode(),
                    )
                except Exception:  # noqa: BLE001
                    pass
            raise
        # group membership commits under _mu: `load` (lazy, any handler
        # thread) and `join` write the same pair (miniovet races pass)
        with self._mu:
            self.name, self.peers = my_name, peers
        self.save()
        self._ensure_worker()
        self.initial_sync()
        return {"success": True, "name": my_name,
                "sites": [p.name for p in peers]}

    def join(self, doc: dict) -> None:
        """Peer side of group formation (empty peers = disband)."""
        if not isinstance(doc, dict) or "peers" not in doc or "you" not in doc:
            raise ValueError("malformed join document")
        peers = [
            SitePeer(
                name=p["name"], endpoint=p["endpoint"],
                access_key=p["access_key"], secret_key=p["secret_key"],
                deployment_id=p.get("deployment_id", ""),
            )
            for p in doc["peers"]
        ]
        with self._mu:
            self.name = doc["you"]
            self.peers = peers
        self.save()
        if not peers:
            return  # disbanded
        self._ensure_worker()
        # wire existing buckets for object replication toward the others
        for bucket in self._local_buckets():
            self.wire_bucket(bucket)

    def _peer_info(self, peer: SitePeer) -> dict:
        r = peer.client().request("GET", "/minio/admin/v3/site-replication/info")
        if r.status != 200:
            raise RuntimeError(
                f"cannot reach site {peer.name} at {peer.endpoint}: HTTP {r.status}"
            )
        return json.loads(r.body)

    def info(self) -> dict:
        self.load()
        return {
            "enabled": self.enabled,
            "name": self.name,
            "deploymentID": self.deployment_id(),
            "sites": [
                {"name": p.name, "endpoint": p.endpoint,
                 "deploymentID": p.deployment_id}
                for p in self.peers
            ],
            "stats": dict(self.stats),
        }

    # -- outbound sync -----------------------------------------------------

    def _enqueue(self, kind: str, payload: dict) -> None:
        if not self.enabled:
            return
        if kind == "iam":
            # coalesce under the lock: frequent IAM persists (e.g. STS
            # mints) need only the latest snapshot on the wire
            with self._mu:
                if self._iam_pending:
                    return
                self._iam_pending = True
        try:
            self._q.put_nowait(
                _SyncItem(kind, payload, pending=[p.name for p in self.others()])
            )
            self._stat("queued")
        except queue.Full:
            if kind == "iam":
                with self._mu:
                    self._iam_pending = False
            self._stat("failed")

    def sync_bucket_create(self, bucket: str) -> None:
        self._enqueue("bucket-create", {"bucket": bucket})
        self.wire_bucket(bucket)

    def sync_bucket_delete(self, bucket: str) -> None:
        self._enqueue("bucket-delete", {"bucket": bucket})

    def sync_bucket_meta(self, bucket: str, bm) -> None:
        self._enqueue(
            "bucket-meta", {"bucket": bucket, "meta": _exportable_meta(bm)}
        )

    def sync_iam(self) -> None:
        self._enqueue("iam", self._iam_snapshot())

    def _iam_snapshot(self) -> dict:
        iam = self.server.iam
        with iam._lock:
            users = {
                k: u.to_dict() for k, u in iam.users.items() if not u.is_temp
            }
            from ..iam.policy import CANNED_POLICIES

            policies = {
                k: p.to_dict() for k, p in iam.policies.items()
                if k not in CANNED_POLICIES
            }
            return {
                "users": users,
                "groups": json.loads(json.dumps(iam.groups)),
                "policies": policies,
                "ldap_policy_map": dict(iam.ldap_policy_map),
            }

    def _stat(self, key: str) -> None:
        # sync counters are bumped from handler contexts and the
        # site-repl worker thread; dict += is not atomic under the GIL
        # (miniovet races pass)
        with self._mu:
            self.stats[key] += 1

    def _ensure_worker(self) -> None:
        with self._mu:
            if self._worker_started:
                return
            self._worker_started = True
            threading.Thread(
                target=self._loop, daemon=True, name="site-repl"
            ).start()

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item.kind == "iam":
                with self._mu:
                    self._iam_pending = False
                item.payload = self._iam_snapshot()  # freshest state wins
            remaining = []
            for pname in item.pending:
                peer = next((p for p in self.others() if p.name == pname), None)
                if peer is None:
                    continue
                try:
                    r = peer.client().request(
                        "POST", "/minio/admin/v3/site-replication/apply",
                        body=json.dumps(
                            {"kind": item.kind, "payload": item.payload,
                             "origin": self.name}
                        ).encode(),
                    )
                    if r.status != 200:
                        raise RuntimeError(f"HTTP {r.status}")
                    self._stat("synced")
                except Exception:  # noqa: BLE001 — peer down: retry below
                    remaining.append(pname)
            if remaining:
                item.pending = remaining
                item.attempts += 1
                if item.attempts < 8:
                    threading.Timer(
                        min(2 ** item.attempts, 60),
                        lambda it=item: self._q.put(it),
                    ).start()
                else:
                    self._stat("failed")

    # -- inbound apply -----------------------------------------------------

    def apply(self, kind: str, payload: dict) -> None:
        """Apply a change from a peer WITHOUT re-propagating."""
        if kind == "bucket-create":
            b = payload["bucket"]
            try:
                self.server.store.make_bucket(b)
            except Exception:  # noqa: BLE001 — already exists
                pass
            self.wire_bucket(b)
        elif kind == "bucket-delete":
            b = payload["bucket"]
            try:
                if self.server.store.bucket_exists(b):
                    # may race the still-draining object-replication deletes:
                    # raising makes the origin retry with backoff
                    self.server.store.delete_bucket(b)
                self.server.buckets.drop(b)  # stale metadata must not
                # resurrect on recreate (e.g. an old public-read policy)
            except Exception:
                raise
        elif kind == "bucket-meta":
            self._apply_bucket_meta(payload["bucket"], payload["meta"])
        elif kind == "iam":
            self._apply_iam(payload)
        else:
            raise ValueError(f"unknown site sync kind {kind}")

    def _apply_bucket_meta(self, bucket: str, meta: dict) -> None:
        buckets = self.server.buckets
        bm = buckets.get(bucket)
        for k, v in meta.items():
            if k in _SYNCED_META:  # never let a peer touch local-only fields
                setattr(bm, k, v)
        buckets.set(bucket, bm, notify=False)

    def _apply_iam(self, snap: dict) -> None:
        from ..iam.policy import Policy
        from ..iam.sys import UserIdentity

        iam = self.server.iam
        with iam._lock:
            iam.applying_remote = True
            try:
                keep_temp = {
                    k: u for k, u in iam.users.items() if u.is_temp
                }
                iam.users = {
                    k: UserIdentity.from_dict(v)
                    for k, v in snap.get("users", {}).items()
                }
                iam.users.update(keep_temp)
                iam.groups = dict(snap.get("groups", {}))
                from ..iam.policy import CANNED_POLICIES

                iam.policies = dict(CANNED_POLICIES)
                for k, v in snap.get("policies", {}).items():
                    iam.policies[k] = Policy.from_dict(v)
                iam.ldap_policy_map = dict(snap.get("ldap_policy_map", {}))
                iam._persist_users()
                iam._persist_groups()
                iam._persist_policies()
                iam._save("ldap_policy_map", iam.ldap_policy_map)
            finally:
                iam.applying_remote = False

    # -- object-plane wiring ----------------------------------------------

    def wire_bucket(self, bucket: str) -> None:
        """Point this bucket's replication at every peer (same bucket name);
        the rules live in LOCAL bucket metadata and are never synced."""
        if not self.enabled or bucket.startswith(".minio.sys"):
            return
        from .replicate import RemoteTarget, parse_replication_config

        rules = []
        for p in self.others():
            arn = f"arn:minio:replication::site-{p.name}:{bucket}"
            self.server.repl_targets.set(RemoteTarget(
                arn=arn, source_bucket=bucket, endpoint=p.endpoint,
                access_key=p.access_key, secret_key=p.secret_key,
                target_bucket=bucket,
            ))
            rules.append(
                f"<Rule><ID>site-{p.name}</ID><Status>Enabled</Status>"
                f"<Priority>1</Priority><Destination><Bucket>{arn}</Bucket>"
                f"</Destination></Rule>"
            )
        bm = self.server.buckets.get(bucket)
        # preserve user-configured rules (non site-*); only our own rules
        # are replaced
        try:
            existing = parse_replication_config(bm.replication or "")
        except Exception:  # noqa: BLE001
            existing = []
        for r in existing:
            if r.rule_id.startswith("site-"):
                continue
            rules.append(
                f"<Rule><ID>{r.rule_id}</ID><Status>{r.status}</Status>"
                f"<Priority>{r.priority}</Priority>"
                + (f"<Prefix>{r.prefix}</Prefix>" if r.prefix else "")
                + f"<Destination><Bucket>{r.destination_arn}</Bucket>"
                f"</Destination></Rule>"
            )
        bm.replication = (
            "<ReplicationConfiguration>" + "".join(rules)
            + "</ReplicationConfiguration>"
        )
        self.server.buckets.set(bucket, bm, notify=False)

    def _local_buckets(self) -> list[str]:
        try:
            out = []
            for b in self.server.store.list_buckets():
                name = getattr(b, "name", b)
                if not str(name).startswith(".minio.sys"):
                    out.append(str(name))
            return out
        except Exception:  # noqa: BLE001
            return []

    def initial_sync(self) -> None:
        """Seed the freshly joined peers: buckets, their metadata, IAM, and
        a full object resync per bucket."""
        for bucket in self._local_buckets():
            self._enqueue("bucket-create", {"bucket": bucket})
            self._enqueue(
                "bucket-meta",
                {"bucket": bucket, "meta": _exportable_meta(self.server.buckets.get(bucket))},
            )
            self.wire_bucket(bucket)
        self.sync_iam()
        # objects: replay through the bucket-replication plane once the
        # create has had a moment to land on the peers
        def later():
            # miniovet: ignore[blocking] -- settle delay before resync
            # replay; later() runs on its own daemon thread
            time.sleep(1.0)
            for bucket in self._local_buckets():
                try:
                    self.server.replication.resync(bucket)
                except Exception:  # noqa: BLE001
                    pass

        threading.Thread(target=later, daemon=True).start()


# bucket metadata fields that sync across sites; `replication` stays local
# (each site's rules point at ITS peers)
_SYNCED_META = (
    "policy", "tags", "lifecycle", "notification", "encryption",
    "versioning", "object_lock", "cors", "quota",
)


def _exportable_meta(bm) -> dict:
    # ALL synced fields ship, including cleared ones — deleting a bucket
    # policy on one site must un-set it on the others
    return {f: getattr(bm, f, None) for f in _SYNCED_META}
