"""Storage RPC: every drive served over HTTP, consumed via StorageAPI.

Mirrors the reference's storage REST pair
(MinIO cmd/storage-rest-server.go, storage-rest-client.go): small
metadata ops as msgpack request/response, bulk shard data as raw HTTP
bodies. Internode auth is an HMAC token derived from the root credentials
(the reference signs internode requests the same way). The reference
splits small RPCs onto a muxed websocket grid — here both planes ride
HTTP/1.1 keep-alive connections, one pool per peer.
"""

from __future__ import annotations

import hashlib
import hmac
import http.client
import threading
import urllib.parse
from typing import BinaryIO, Iterator

from ..utils import msgpack_lite as msgpack
from ..server import web

from .. import obs
from ..fault import registry as fault_registry
from ..fault import retry as retry_mod
from ..storage import errors
from ..storage.datatypes import DiskInfo, FileInfo, VolInfo
from ..storage.interface import StorageAPI
from ..storage.xlstorage import XLStorage

STORAGE_PREFIX = "/minio/storage/v1"

_ERR_TYPES = {
    "DiskNotFound": errors.DiskNotFound,
    "VolumeNotFound": errors.VolumeNotFound,
    "VolumeExists": errors.VolumeExists,
    "VolumeNotEmpty": errors.VolumeNotEmpty,
    "FileNotFound": errors.FileNotFound,
    "FileVersionNotFound": errors.FileVersionNotFound,
    "FileAccessDenied": errors.FileAccessDenied,
    "FileCorrupt": errors.FileCorrupt,
    "IsNotRegular": errors.IsNotRegular,
    "DiskFull": errors.DiskFull,
}


def internode_token(root_user: str, root_password: str) -> str:
    return hmac.new(
        f"{root_user}:{root_password}".encode(), b"minio-tpu-internode", hashlib.sha256
    ).hexdigest()


def _pack_err(e: Exception) -> web.Response:
    return web.Response(
        status=460,  # app-level error channel; type travels in headers
        headers={"x-storage-err": type(e).__name__},
        body=str(e).encode(),
    )


class StorageRESTServer:
    """Serves a node's local drives; attach to the node's app (``server/web.py``).

    `drives` maps GLOBAL endpoint index -> local XLStorage (all nodes share
    the same argument list, so global indexes address drives cluster-wide).
    The dict may be filled after registration (bootstrap order)."""

    def __init__(self, drives: dict[int, XLStorage] | list[XLStorage], token: str):
        self.drives = (
            drives if isinstance(drives, dict) else {i: d for i, d in enumerate(drives)}
        )
        self.token = token

    def register(self, app: web.Application) -> None:
        app.router.add_route(
            "POST", STORAGE_PREFIX + "/{drive:\\d+}/{op}", self.handle
        )

    def register_grid(self, grid) -> None:
        """Expose the same ops over the muxed grid: small RPCs as
        `storage.call` single requests, walkdir as a credit-controlled
        stream (the reference moved exactly this class of traffic onto
        internal/grid; bulk shard bodies stay on HTTP)."""

        def call(payload: bytes) -> bytes:
            parts = msgpack.unpackb(payload, raw=False)
            drive_idx, op, body = parts[0], parts[1], parts[2]
            # 4th element (optional, newer callers): trace request id —
            # the span context crosses the grid hop with the payload
            req_id = parts[3] if len(parts) > 3 else ""
            drive = self.drives.get(drive_idx)
            if drive is None:
                raise errors.DiskNotFound("bad drive index")
            if req_id:
                with obs.request_context(req_id):
                    return self._call(drive, op, body)
            return self._call(drive, op, body)

        async def walkdir(payload: bytes, stream) -> None:
            import asyncio

            drive_idx, volume, base, after = msgpack.unpackb(payload, raw=False)
            drive = self.drives.get(drive_idx)
            if drive is None:
                raise errors.DiskNotFound("bad drive index")
            it = drive.walk_dir(volume, base)
            loop = asyncio.get_running_loop()

            def next_batch() -> list[str]:
                out: list[str] = []
                for key in it:
                    if after and key <= after:
                        continue
                    out.append(key)
                    if len(out) >= 512:
                        break
                return out

            while True:
                batch = await loop.run_in_executor(None, next_batch)
                if not batch:
                    return
                await stream.send(msgpack.packb(batch))

        grid.register_single("storage.call", call)
        grid.register_stream("storage.walkdir", walkdir)

    async def handle(self, request: web.Request) -> web.Response:
        if request.headers.get("x-minio-token") != self.token:
            return web.Response(status=403)
        try:
            drive = self.drives[int(request.match_info["drive"])]
        except (KeyError, ValueError):
            return _pack_err(errors.DiskNotFound("bad drive index"))
        op = request.match_info["op"]
        body = await request.read()
        import asyncio

        # the caller's trace request id rides an internode header so the
        # serving node's spans join the same tree
        req_id = request.headers.get("x-minio-reqid", "")

        def run():
            if req_id:
                with obs.request_context(req_id):
                    return self._call(drive, op, body)
            return self._call(drive, op, body)

        loop = asyncio.get_running_loop()
        try:
            result = await loop.run_in_executor(None, run)
            return web.Response(body=result)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — typed errors cross the wire
            return _pack_err(e)

    def _call(self, drive: XLStorage, op: str, body: bytes) -> bytes:
        # serving-node storage span: the registry serves RAW drives (the
        # calling side owns the HealthCheckedDisk wrapper), so this is
        # where remote ops become visible on the node that executes them
        with obs.span(
            obs.TYPE_STORAGE, f"rpc.{op}",
            drive=getattr(drive, "endpoint", ""),
        ):
            return self._call_inner(drive, op, body)

    def _call_inner(self, drive: XLStorage, op: str, body: bytes) -> bytes:
        args = msgpack.unpackb(body, raw=False) if body else {}

        if op == "diskinfo":
            di = drive.disk_info()
            return msgpack.packb(di.__dict__)
        if op == "makevol":
            drive.make_vol(args["volume"])
            return b""
        if op == "listvols":
            return msgpack.packb([[v.name, v.created] for v in drive.list_vols()])
        if op == "statvol":
            v = drive.stat_vol(args["volume"])
            return msgpack.packb([v.name, v.created])
        if op == "deletevol":
            drive.delete_vol(args["volume"], args.get("force", False))
            return b""
        if op == "writemetadata":
            drive.write_metadata(
                args["volume"], args["path"], FileInfo.from_dict(args["fi"])
            )
            return b""
        if op == "updatemetadata":
            drive.update_metadata(
                args["volume"], args["path"], FileInfo.from_dict(args["fi"])
            )
            return b""
        if op == "readversion":
            fi = drive.read_version(
                args["volume"], args["path"], args.get("version_id", ""),
                args.get("read_data", False),
            )
            return msgpack.packb(_fi_wire(fi))
        if op == "readversions":
            out = [_fi_wire(fi) for fi in drive.read_versions(args["volume"], args["path"])]
            return msgpack.packb(out)
        if op == "deleteversion":
            drive.delete_version(
                args["volume"], args["path"], FileInfo.from_dict(args["fi"])
            )
            return b""
        if op == "renamedata":
            drive.rename_data(
                args["src_volume"], args["src_path"], FileInfo.from_dict(args["fi"]),
                args["dst_volume"], args["dst_path"],
            )
            return b""
        if op == "createfile":
            drive.create_file(args["volume"], args["path"], args["data"])
            return b""
        if op == "appendfile":
            drive.append_file(args["volume"], args["path"], args["data"])
            return b""
        if op == "readfile":
            return drive.read_file(
                args["volume"], args["path"], args.get("offset", 0), args.get("length", -1)
            )
        if op == "renamefile":
            drive.rename_file(
                args["src_volume"], args["src_path"], args["dst_volume"], args["dst_path"]
            )
            return b""
        if op == "delete":
            drive.delete(args["volume"], args["path"], args.get("recursive", False))
            return b""
        if op == "listdir":
            return msgpack.packb(
                drive.list_dir(args["volume"], args["path"], args.get("count", -1))
            )
        if op == "walkdir":
            # paged: never materialize a whole namespace in one response
            limit = args.get("limit", 10000)
            after = args.get("after", "")
            out = []
            for key in drive.walk_dir(args["volume"], args.get("base", "")):
                if after and key <= after:
                    continue
                out.append(key)
                if len(out) >= limit:
                    break
            return msgpack.packb(out)
        if op == "statinfofile":
            return msgpack.packb(drive.stat_info_file(args["volume"], args["path"]))
        if op == "verifyfile":
            drive.verify_file(args["volume"], args["path"], FileInfo.from_dict(args["fi"]))
            return b""
        raise errors.StorageError(f"unknown storage op {op}")


def _fi_wire(fi: FileInfo) -> dict:
    # to_dict/from_dict carry everything except the read-side annotations
    d = fi.to_dict()
    d["_latest"] = fi.is_latest
    d["_nv"] = fi.num_versions
    d["_smt"] = fi.successor_mod_time
    return d


def _fi_unwire(d: dict) -> FileInfo:
    fi = FileInfo.from_dict(d)
    fi.is_latest = d.get("_latest", True)
    fi.num_versions = d.get("_nv", 0)
    fi.successor_mod_time = d.get("_smt", 0)
    return fi


class StorageRESTClient(StorageAPI):
    """StorageAPI over HTTP to a peer's drive (keep-alive pooled)."""

    def __init__(self, host: str, port: int, drive_index: int, token: str, endpoint: str = ""):
        self.host, self.port = host, port
        self.drive_index = drive_index
        self.token = token
        self.endpoint = endpoint or f"http://{host}:{port}/#{drive_index}"
        self.disk_id = ""
        self._local = threading.local()
        # small metadata RPCs ride the muxed grid connection shared by all
        # drives pointing at this peer; bulk shard bodies stay on HTTP
        from .grid import GridGate

        self._gate = GridGate(host, port, token, "storage")

    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            from ..crypto import tlsconf

            c = tlsconf.http_connection(self.host, self.port, timeout=30)
            self._local.conn = c
        return c

    # per-op idempotency class (fault/retry.py is the single source):
    # only these ops may be resent after a dropped connection or timeout
    _RETRYABLE = retry_mod.IDEMPOTENT_STORAGE_OPS

    # bulk shard payloads: per the grid design (reference grid README) these
    # stay on their own HTTP bodies so one large transfer can't stall every
    # muxed RPC behind it
    _BULK_OPS = frozenset({"createfile", "appendfile", "readfile"})

    def _check_net_fault(self, op: str) -> None:
        """Injected network faults (fault/ registry): delay stalls the
        call; everything else raises the same OS-class error a real
        transport failure would, so the unified retry policy absorbs
        transient rules and the circuit breaker (HealthCheckedDisk wraps
        this client) counts persistent ones."""
        rule = fault_registry.check("network", f"{self.host}:{self.port}", op)
        if rule is not None:
            if rule.mode == "delay":
                fault_registry.sleep_latency(rule)
            else:
                raise OSError(
                    f"{self.endpoint}: injected network fault ({rule.mode})"
                )

    def _rpc(self, op: str, args: dict | None = None) -> bytes:
        body = msgpack.packb(args or {})
        # trace context crosses the internode hop: as a 4th payload element
        # on the grid, as a header on HTTP. The server accepts both payload
        # arities, but a tracing caller does require a server that knows the
        # 4-element form — all internode planes already assume one code
        # version cluster-wide (bootstrap verifies config consistency)
        req_id = obs.current_request_id()
        if op not in self._BULK_OPS:
            g = self._gate.client()
            if g is not None:
                from .grid import GridConnectError, GridError, RemoteError

                payload = (
                    [self.drive_index, op, body, req_id]
                    if req_id else [self.drive_index, op, body]
                )
                try:
                    return g.call(
                        "storage.call",
                        msgpack.packb(payload),
                        retry=op in self._RETRYABLE,
                    )
                except RemoteError as e:
                    err_type = _ERR_TYPES.get(e.err_type, errors.StorageError)
                    raise err_type(str(e)) from None
                except GridConnectError:
                    # never sent: safe to fall back to HTTP for any op
                    self._gate.failed()
                except GridError:
                    self._gate.failed()
                    if op not in self._RETRYABLE:
                        # may have been applied remotely; resending over
                        # HTTP would violate the no-replay discipline
                        raise errors.DiskNotFound(
                            f"{self.endpoint} grid rpc {op} failed mid-flight"
                        ) from None
        path = f"{STORAGE_PREFIX}/{self.drive_index}/{op}"

        def attempt() -> tuple:
            # inside the retry loop: a transient injected fault (count- or
            # prob-limited) is absorbed exactly like a real blip would be
            self._check_net_fault(op)
            conn = self._conn()
            try:
                hdrs = {"x-minio-token": self.token,
                        "Content-Type": "application/msgpack"}
                if req_id:
                    hdrs["x-minio-reqid"] = req_id
                conn.request("POST", path, body=body, headers=hdrs)
                r = conn.getresponse()
                d = r.read()
            except (http.client.HTTPException, OSError):
                self._local.conn = None
                raise
            # internode accounting covers the HTTP plane too (bulk
            # shard bodies + grid fallback), not just the mux
            from .grid import stats_add

            stats_add("calls")
            stats_add("tx_bytes", len(body))
            stats_add("rx_bytes", len(d))
            return r, d

        # unified retry (fault/retry.py): transport failures resend only
        # for the idempotent op class, with jittered backoff
        policy = retry_mod.shared_policy(idempotent=op in self._RETRYABLE)
        try:
            resp, data = policy.run(
                attempt,
                retryable=lambda e: isinstance(
                    e, (http.client.HTTPException, OSError)
                ),
            )
        except (http.client.HTTPException, OSError):
            raise errors.DiskNotFound(f"{self.endpoint} unreachable") from None
        if resp.status == 460:
            err_type = _ERR_TYPES.get(
                resp.headers.get("x-storage-err", ""), errors.StorageError
            )
            raise err_type(data.decode("utf-8", "replace"))
        if resp.status == 403:
            raise errors.FileAccessDenied("internode auth failed")
        if resp.status != 200:
            raise errors.StorageError(f"storage rpc {op}: HTTP {resp.status}")
        return data

    # -- StorageAPI --------------------------------------------------------

    def disk_info(self) -> DiskInfo:
        d = msgpack.unpackb(self._rpc("diskinfo"), raw=False)
        di = DiskInfo()
        di.__dict__.update(d)
        return di

    def make_vol(self, volume: str) -> None:
        self._rpc("makevol", {"volume": volume})

    def list_vols(self) -> list[VolInfo]:
        return [
            VolInfo(n, c) for n, c in msgpack.unpackb(self._rpc("listvols"), raw=False)
        ]

    def stat_vol(self, volume: str) -> VolInfo:
        n, c = msgpack.unpackb(self._rpc("statvol", {"volume": volume}), raw=False)
        return VolInfo(n, c)

    def delete_vol(self, volume: str, force: bool = False) -> None:
        self._rpc("deletevol", {"volume": volume, "force": force})

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._rpc("writemetadata", {"volume": volume, "path": path, "fi": fi.to_dict()})

    def update_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self._rpc("updatemetadata", {"volume": volume, "path": path, "fi": fi.to_dict()})

    def read_version(
        self, volume: str, path: str, version_id: str = "", read_data: bool = False
    ) -> FileInfo:
        d = msgpack.unpackb(
            self._rpc(
                "readversion",
                {"volume": volume, "path": path, "version_id": version_id,
                 "read_data": read_data},
            ),
            raw=False,
        )
        fi = _fi_unwire(d)
        fi.volume, fi.name = volume, path
        return fi

    def read_versions(self, volume: str, path: str) -> list[FileInfo]:
        out = msgpack.unpackb(
            self._rpc("readversions", {"volume": volume, "path": path}), raw=False
        )
        fis = [_fi_unwire(d) for d in out]
        for fi in fis:
            fi.volume, fi.name = volume, path
        return fis

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        self._rpc("deleteversion", {"volume": volume, "path": path, "fi": fi.to_dict()})

    def delete_versions(self, volume, path, versions):
        out = []
        for fi in versions:
            try:
                self.delete_version(volume, path, fi)
                out.append(None)
            except Exception as e:  # noqa: BLE001
                out.append(e)
        return out

    def rename_data(
        self, src_volume: str, src_path: str, fi: FileInfo, dst_volume: str, dst_path: str
    ) -> None:
        self._rpc(
            "renamedata",
            {"src_volume": src_volume, "src_path": src_path, "fi": fi.to_dict(),
             "dst_volume": dst_volume, "dst_path": dst_path},
        )

    def create_file(self, volume: str, path: str, data: bytes | BinaryIO) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            data = data.read()
        self._rpc("createfile", {"volume": volume, "path": path, "data": bytes(data)})

    def append_file(self, volume: str, path: str, data) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            # writev vectors serialize at the RPC boundary — the one
            # legitimate copy on a remote-drive append, counted so the
            # zero-copy claim stays enumerable
            from ..erasure import bufpool

            bufpool.count_copy("append-rpc")
            data = b"".join(data)
        self._rpc("appendfile", {"volume": volume, "path": path, "data": data})

    def read_file(self, volume: str, path: str, offset: int = 0, length: int = -1) -> bytes:
        return self._rpc(
            "readfile", {"volume": volume, "path": path, "offset": offset, "length": length}
        )

    def read_file_stream(self, volume: str, path: str, offset: int, length: int):
        import io

        return io.BytesIO(self.read_file(volume, path, offset, length))

    def rename_file(self, src_volume, src_path, dst_volume, dst_path) -> None:
        self._rpc(
            "renamefile",
            {"src_volume": src_volume, "src_path": src_path,
             "dst_volume": dst_volume, "dst_path": dst_path},
        )

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        self._rpc("delete", {"volume": volume, "path": path, "recursive": recursive})

    def list_dir(self, volume: str, path: str, count: int = -1) -> list[str]:
        return msgpack.unpackb(
            self._rpc("listdir", {"volume": volume, "path": path, "count": count}),
            raw=False,
        )

    def walk_dir(self, volume: str, base: str = "") -> Iterator[str]:
        after = ""
        g = self._gate.client()
        if g is not None:
            from .grid import GridError, RemoteError

            st = None
            try:
                st = g.stream(
                    "storage.walkdir",
                    msgpack.packb([self.drive_index, volume, base, after]),
                )
                while True:
                    item = st.recv()
                    if item is None:
                        return
                    for key in msgpack.unpackb(item, raw=False):
                        yield key
                        after = key
            except RemoteError as e:
                err_type = _ERR_TYPES.get(e.err_type, errors.StorageError)
                raise err_type(str(e)) from None
            except GridError:
                # keys stream in sorted walk order, so the HTTP pager below
                # resumes exactly after the last delivered key
                self._gate.failed()
            finally:
                # listings abandon per-drive walks early (k-way merge stops
                # at the prefix end); cancel tells the server to release
                # the handler parked on credits instead of leaking it
                if st is not None:
                    st.cancel()
        limit = 10000
        while True:
            page = msgpack.unpackb(
                self._rpc(
                    "walkdir",
                    {"volume": volume, "base": base, "after": after, "limit": limit},
                ),
                raw=False,
            )
            yield from page
            if len(page) < limit:
                return
            after = page[-1]

    def stat_info_file(self, volume: str, path: str) -> int:
        return msgpack.unpackb(
            self._rpc("statinfofile", {"volume": volume, "path": path}), raw=False
        )

    def verify_file(self, volume: str, path: str, fi: FileInfo) -> None:
        self._rpc("verifyfile", {"volume": volume, "path": path, "fi": fi.to_dict()})
