"""Distributed namespace locks (dsync).

Mirrors MinIO internal/dsync/drwmutex.go + cmd/local-locker.go:
read/write locks on object names, acquired by broadcasting to all nodes'
lockers and succeeding when a quorum grants (write: n/2+1, read: n/2);
losers release whatever they got and retry. Each node serves its own
in-memory lock table over HTTP (the reference runs a dedicated lock grid
so locks never queue behind data traffic).
"""

from __future__ import annotations

import http.client
import os
import threading
import time
import uuid as uuidlib

from ..utils import msgpack_lite as msgpack
from ..server import web

LOCK_PREFIX = "/minio/lock/v1"

from concurrent.futures import ThreadPoolExecutor  # noqa: E402

_LOCK_POOL = ThreadPoolExecutor(max_workers=16, thread_name_prefix="dsync")


def _safe_result(fut) -> bool:
    try:
        return bool(fut.result(timeout=10))
    except Exception:  # noqa: BLE001 — unreachable locker == not granted
        return False


LOCK_TTL = 120.0  # seconds; a crashed holder's locks expire lazily
# (the reference refreshes held locks and expires stale ones —
# internal/dsync/drwmutex.go:340 refreshLock / cmd/local-locker.go expiry)


class LocalLocker:
    """In-memory lock table for one node (reference cmd/local-locker.go).

    Entries carry expiry timestamps so a SIGKILLed holder can't wedge a
    resource forever: expired writers/readers are purged on next access.
    """

    def __init__(self):
        self._mu = threading.Lock()
        # resource -> {"writer": uid|None, "wexp": t, "readers": {uid: (count, exp)}}
        self._locks: dict[str, dict] = {}

    def _purge(self, e: dict) -> None:
        now = time.monotonic()
        if e["writer"] and e["wexp"] < now:
            e["writer"] = None
        e["readers"] = {
            u: (c, exp) for u, (c, exp) in e["readers"].items() if exp >= now
        }

    def lock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._locks.setdefault(
                resource, {"writer": None, "wexp": 0.0, "readers": {},
                           "wwait": 0.0}
            )
            self._purge(e)
            if e["writer"] or e["readers"]:
                # writer priority: park a waiting-writer marker so a
                # continuous stream of readers can't starve this writer
                e["wwait"] = time.monotonic() + 2.0
                return False
            e["writer"] = uid
            e["wexp"] = time.monotonic() + LOCK_TTL
            e["wwait"] = 0.0
            return True

    def unlock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._locks.get(resource)
            if not e or e["writer"] != uid:
                return False
            del self._locks[resource]
            return True

    def rlock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._locks.setdefault(
                resource, {"writer": None, "wexp": 0.0, "readers": {},
                           "wwait": 0.0}
            )
            self._purge(e)
            if e["writer"]:
                return False
            if e.get("wwait", 0.0) > time.monotonic() and uid not in e["readers"]:
                return False  # yield to the waiting writer
            c, _ = e["readers"].get(uid, (0, 0.0))
            e["readers"][uid] = (c + 1, time.monotonic() + LOCK_TTL)
            return True

    def runlock(self, resource: str, uid: str) -> bool:
        with self._mu:
            e = self._locks.get(resource)
            if not e or uid not in e["readers"]:
                return False
            c, exp = e["readers"][uid]
            if c <= 1:
                del e["readers"][uid]
            else:
                e["readers"][uid] = (c - 1, exp)
            if not e["readers"] and not e["writer"]:
                del self._locks[resource]
            return True

    def refresh(self, resource: str, uid: str) -> bool:
        """Re-arm the TTL of a held lock (the reference's refreshLock loop
        keeps long-held dsync locks alive the same way)."""
        with self._mu:
            e = self._locks.get(resource)
            if not e:
                return False
            ok = False
            if e["writer"] == uid:
                e["wexp"] = time.monotonic() + LOCK_TTL
                ok = True
            if uid in e["readers"]:
                c, _ = e["readers"][uid]
                e["readers"][uid] = (c, time.monotonic() + LOCK_TTL)
                ok = True
            return ok

    def force_unlock(self, resource: str) -> bool:
        with self._mu:
            return self._locks.pop(resource, None) is not None

    def stats(self) -> dict:
        with self._mu:
            return {
                r: {"writer": bool(e["writer"]), "readers": len(e["readers"])}
                for r, e in self._locks.items()
            }


class LockRESTServer:
    def __init__(self, locker: LocalLocker, token: str):
        self.locker = locker
        self.token = token

    def register(self, app: web.Application) -> None:
        app.router.add_route("POST", LOCK_PREFIX + "/{op}", self.handle)

    async def handle(self, request: web.Request) -> web.Response:
        if request.headers.get("x-minio-token") != self.token:
            return web.Response(status=403)
        op = request.match_info["op"]
        args = msgpack.unpackb(await request.read(), raw=False)
        if op == "stats":
            ok = self.locker.stats()
        elif op == "force_unlock":
            ok = self.locker.force_unlock(args["resource"])
        elif op in ("lock", "unlock", "rlock", "runlock", "refresh"):
            ok = getattr(self.locker, op)(args["resource"], args.get("uid", ""))
        else:
            return web.Response(status=404)
        return web.Response(body=msgpack.packb(ok))

    def register_grid(self, grid) -> None:
        """Lock RPCs over the muxed grid. Clients connect on a dedicated
        "lock" plane websocket, reproducing the reference's separate lock
        grid (cmd/grid.go:76): lock traffic never queues behind a burst of
        storage metadata RPCs sharing a connection."""

        def call(payload: bytes) -> bytes:
            op, resource, uid = msgpack.unpackb(payload, raw=False)
            if op == "stats":
                return msgpack.packb(self.locker.stats())
            if op == "force_unlock":
                return msgpack.packb(self.locker.force_unlock(resource))
            if op in ("lock", "unlock", "rlock", "runlock", "refresh"):
                return msgpack.packb(getattr(self.locker, op)(resource, uid))
            raise ValueError(f"unknown lock op {op}")

        # inline: pure in-memory table ops must not queue behind the
        # executor's disk-bound storage work — that would re-couple the
        # planes server-side
        grid.register_single("lock.call", call, inline=True)


class _RemoteLocker:
    def __init__(self, host: str, port: int, token: str):
        self.host, self.port, self.token = host, port, token
        self._local = threading.local()
        from .grid import GridGate

        self._gate = GridGate(host, port, token, "lock")

    def _call(self, op: str, resource: str, uid: str) -> bool:
        # a lock RPC that dies mid-flight may still have been granted; the
        # TTL expiry (LOCK_TTL) reclaims such orphans on both transports
        g = self._gate.client()
        if g is not None:
            try:
                return bool(
                    msgpack.unpackb(
                        g.call(
                            "lock.call",
                            msgpack.packb([op, resource, uid]),
                            timeout=5.0,
                        ),
                        raw=False,
                    )
                )
            except Exception:  # noqa: BLE001 — not granted; try HTTP once
                self._gate.failed()
        return self._call_http(op, resource, uid)

    def _call_http(self, op: str, resource: str, uid: str) -> bool:
        conn = getattr(self._local, "conn", None)
        try:
            if conn is None:
                from ..crypto import tlsconf

                conn = tlsconf.http_connection(self.host, self.port, timeout=5)
                self._local.conn = conn
            conn.request(
                "POST", f"{LOCK_PREFIX}/{op}",
                body=msgpack.packb({"resource": resource, "uid": uid}),
                headers={"x-minio-token": self.token},
            )
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                return False
            return bool(msgpack.unpackb(data, raw=False))
        except (http.client.HTTPException, OSError):
            self._local.conn = None
            return False

    def lock(self, r, u):
        return self._call("lock", r, u)

    def unlock(self, r, u):
        return self._call("unlock", r, u)

    def rlock(self, r, u):
        return self._call("rlock", r, u)

    def runlock(self, r, u):
        return self._call("runlock", r, u)

    def refresh(self, r, u):
        return self._call("refresh", r, u)


LOCK_REFRESH_INTERVAL = float(os.environ.get("MINIO_TPU_LOCK_REFRESH_S", "10"))


class DRWMutex:
    """Distributed RW mutex over a set of lockers with quorum
    (reference internal/dsync/drwmutex.go:113)."""

    def __init__(self, lockers: list, resource: str):
        self.lockers = lockers
        self.resource = resource
        self.uid = str(uuidlib.uuid4())
        self._lost = threading.Event()
        self._stop_refresh: threading.Event | None = None

    def _quorum(self, write: bool) -> int:
        n = len(self.lockers)
        q = n // 2 + 1 if write else n // 2
        return max(q, 1)

    def _acquire(self, write: bool, timeout: float) -> bool:
        op_lock = "lock" if write else "rlock"
        op_unlock = "unlock" if write else "runlock"
        deadline = time.monotonic() + timeout
        quorum = self._quorum(write)
        # dsync retry jitter via the shared backoff helper
        # (fault/retry.py): the spread breaks the lockstep livelock of
        # two symmetric contenders (the reference randomizes dsync
        # retry timing the same way)
        from ..fault.retry import Backoff

        boff = Backoff(base_s=0.002, cap_s=0.25, jitter=0.5)
        while True:
            # broadcast concurrently: one slow/blackholed peer must not add
            # its full timeout to every round (the reference fans out too)
            if len(self.lockers) > 1:
                futs = [
                    _LOCK_POOL.submit(getattr(lk, op_lock), self.resource, self.uid)
                    for lk in self.lockers
                ]
                granted = [
                    lk for lk, f in zip(self.lockers, futs) if _safe_result(f)
                ]
            else:
                granted = [
                    lk for lk in self.lockers
                    if getattr(lk, op_lock)(self.resource, self.uid)
                ]
            if len(granted) >= quorum:
                return True
            for lk in granted:
                getattr(lk, op_unlock)(self.resource, self.uid)
            if time.monotonic() > deadline:
                return False
            boff.sleep()

    def lock(self, timeout: float = 10.0) -> bool:
        return self._acquire(True, timeout)

    def rlock(self, timeout: float = 10.0) -> bool:
        return self._acquire(False, timeout)

    def unlock(self) -> None:
        self.stop_refresher()
        for lk in self.lockers:
            lk.unlock(self.resource, self.uid)

    def runlock(self) -> None:
        self.stop_refresher()
        for lk in self.lockers:
            lk.runlock(self.resource, self.uid)

    def refresh(self) -> None:
        """Keep a long-held lock alive past the TTL."""
        for lk in self.lockers:
            try:
                lk.refresh(self.resource, self.uid)
            except Exception:  # noqa: BLE001
                pass

    # -- active refresh (reference internal/dsync/drwmutex.go:340) ---------

    @property
    def lost(self) -> bool:
        """True once the refresher observed refresh-quorum loss: the lock
        is no longer held cluster-wide and the guarded operation must
        abort rather than keep writing as a zombie holder."""
        return self._lost.is_set()

    def start_refresher(
        self,
        write: bool = True,
        interval: float | None = None,
        on_lost=None,
    ) -> None:
        """Refresh the held lock every `interval` seconds in a background
        thread; if a refresh round grants below quorum, set `lost`, call
        on_lost once, and stop. unlock()/runlock() stop the refresher."""
        if self._stop_refresh is not None:
            return  # already running
        stop = threading.Event()
        self._stop_refresh = stop
        quorum = self._quorum(write)
        if interval is None:  # env read per call so tests can shrink it
            interval = float(
                os.environ.get("MINIO_TPU_LOCK_REFRESH_S", str(LOCK_REFRESH_INTERVAL))
            )
        iv = interval

        def loop():
            while not stop.wait(iv):
                futs = [
                    _LOCK_POOL.submit(lk.refresh, self.resource, self.uid)
                    for lk in self.lockers
                ]
                granted = sum(1 for f in futs if _safe_result(f))
                if stop.is_set():
                    return  # unlocked during the round: not a loss
                if granted < quorum:
                    self._lost.set()
                    if on_lost is not None:
                        try:
                            on_lost()
                        except Exception:  # noqa: BLE001
                            pass
                    return

        threading.Thread(
            target=loop, daemon=True, name=f"lock-refresh-{self.resource[:40]}"
        ).start()

    def stop_refresher(self) -> None:
        if self._stop_refresh is not None:
            self._stop_refresh.set()
            self._stop_refresh = None


class NamespaceLock:
    """Per-object lock facade used by the object layer
    (reference cmd/namespace-lock.go)."""

    def __init__(self, lockers: list | None = None):
        self.lockers = lockers or [LocalLocker()]

    def new(self, bucket: str, obj: str) -> DRWMutex:
        return DRWMutex(self.lockers, f"{bucket}/{obj}")


class LockTimeout(Exception):
    pass
