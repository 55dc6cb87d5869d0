"""Muxed internode RPC: one websocket per peer pair, credit flow control.

Analogue of MinIO's grid package
(internal/grid/connection.go, muxclient.go, muxserver.go,
README.md): all small internode RPCs between two servers share a SINGLE
two-way websocket connection, multiplexed by a per-request mux id, with
credit-based congestion control on streams so a slow consumer
backpressures the producer instead of ballooning queues. Bulk shard data
deliberately stays off the grid (the reference's README: "do not use for
large payloads") and keeps riding dedicated HTTP bodies.

Wire format (inside websocket binary messages):

    [1B type][4B mux id LE][payload]

    T_REQ       payload = msgpack [handler, request-bytes]
    T_RESP      payload = msgpack [ok, err-type-or-payload, err-msg]
    T_STR_OPEN  payload = msgpack [handler, request-bytes, window]
    T_STR_MSG   payload = raw stream message (either direction)
    T_STR_CREDIT payload = msgpack int (credits granted back to sender)
    T_STR_EOF   sender is done (half-close)
    T_STR_ERR   payload = msgpack [err-type, err-msg]; terminates the mux
    T_PING/T_PONG keepalive (app-level so the sync client stays simple)

The server side rides the node's existing HTTP front, ``server/web.py`` (route
/minio/grid/v1, same internode token auth as the storage REST plane); the
client side is a from-scratch blocking RFC 6455 websocket client usable
from the threaded storage/lock callers, with one reader thread per
connection and auto-reconnect.

Two-plane split: callers ask for a connection per PLANE (e.g. "storage",
"lock"); each plane gets its own websocket so lock traffic never queues
behind a burst of metadata RPCs — mirroring the reference's dedicated
lock grid (cmd/grid.go:76).
"""

from __future__ import annotations

import base64
import hashlib
import os
import queue
import socket
import struct
import threading
import time
from typing import Awaitable, Callable

from ..utils import msgpack_lite as msgpack

from ..fault import registry as fault_registry
from ..fault import retry as retry_mod

GRID_ROUTE = "/minio/grid/v1"
_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

T_REQ = 1
T_RESP = 2
T_STR_OPEN = 3
T_STR_MSG = 4
T_STR_CREDIT = 5
T_STR_EOF = 6
T_STR_ERR = 7
T_PING = 8
T_PONG = 9
T_STR_CANCEL = 10  # client abandons a stream; server cancels the handler

DEFAULT_WINDOW = 32  # stream messages in flight before the sender blocks
SEND_TIMEOUT = 30.0  # socket write timeout: a wedged peer errors, not hangs
_HDR = struct.Struct("<BI")

# process-wide internode transport counters (metrics v3
# /system/network/internode — reference minio_system_network_internode_*)
STATS = {
    "dials": 0, "dial_errors": 0, "disconnects": 0,
    "tx_bytes": 0, "rx_bytes": 0, "calls": 0, "streams": 0,
}
_stats_lock = threading.Lock()


def stats_add(key: str, n: int = 1) -> None:
    # dict += is not atomic under the GIL (load/add/store interleaves);
    # counters feed metrics, so take the (uncontended) lock
    with _stats_lock:
        STATS[key] += n


class GridError(Exception):
    """Transport-level failure (disconnected, timeout, handshake)."""


class GridConnectError(GridError):
    """Could not establish the connection: the request was never sent, so
    the caller may safely fall back to another transport and resend even
    for non-idempotent operations."""


class GridTimeout(GridError):
    """No response within the deadline. The request MAY have been applied
    remotely — only idempotent callers retry it."""


class RemoteError(Exception):
    """Typed application error propagated from the remote handler."""

    def __init__(self, err_type: str, message: str):
        super().__init__(message)
        self.err_type = err_type


def _frame(ftype: int, mux: int, payload: bytes = b"") -> bytes:
    return _HDR.pack(ftype, mux) + payload


# ---------------------------------------------------------------------------
# Server side (asyncio, rides the node's HTTP front)
# ---------------------------------------------------------------------------


class ServerStream:
    """Server end of a muxed stream: credit-gated send, queued recv."""

    def __init__(self, send_frame, mux: int, window: int):
        import asyncio

        self._send_frame = send_frame
        self.mux = mux
        self._send_credits = asyncio.Semaphore(window)
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._window = window
        self._consumed = 0
        self.client_eof = False

    async def send(self, data: bytes) -> None:
        await self._send_credits.acquire()
        await self._send_frame(_frame(T_STR_MSG, self.mux, data))

    async def recv(self) -> bytes | None:
        """Next client->server message, or None at client EOF."""
        item = await self._inbox.get()
        if item is None:
            return None
        # grant credits back in half-window batches (the reference grants
        # as the mux server consumes input, not per message)
        self._consumed += 1
        if self._consumed >= self._window // 2:
            grant, self._consumed = self._consumed, 0
            await self._send_frame(
                _frame(T_STR_CREDIT, self.mux, msgpack.packb(grant))
            )
        return item


SingleHandler = Callable[[bytes], bytes]
StreamHandler = Callable[[bytes, ServerStream], Awaitable[None]]


class GridServer:
    """Registers grid handlers and serves GRID_ROUTE on the node's app."""

    def __init__(self, token: str):
        self.token = token
        self._single: dict[str, SingleHandler] = {}
        self._stream: dict[str, StreamHandler] = {}
        self._inline: set[str] = set()
        self.connections = 0  # live websocket count (tests assert muxing)
        self._live_ws: set = set()  # open server-side sockets (shutdown)

    def register_single(self, name: str, fn: SingleHandler,
                        inline: bool = False) -> None:
        """Default: fn is BLOCKING (storage calls) and runs in the
        executor. inline=True runs it directly on the event loop — for
        pure in-memory handlers (locks) that must never queue behind
        disk-bound executor work (the two-plane isolation would otherwise
        be lost server-side)."""
        self._single[name] = fn
        if inline:
            self._inline.add(name)

    def register_stream(self, name: str, fn: StreamHandler) -> None:
        self._stream[name] = fn

    def register(self, app) -> None:
        from ..server import web

        app.router.add_route("GET", GRID_ROUTE, self.handle)
        # grid websockets are LONG-LIVED by design; without this hook a
        # graceful app cleanup waits the full shutdown timeout for every
        # peer that hasn't closed its end yet (two pool workers stopping
        # together would stall each other's drains)
        app.on_shutdown.append(self._close_live)

    async def _close_live(self, _app) -> None:
        import asyncio

        for ws in list(self._live_ws):
            try:
                await ws.close()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass

    async def handle(self, request):
        import asyncio

        from ..server import web

        if request.headers.get("x-minio-token") != self.token:
            return web.Response(status=403)
        # protocol-level heartbeat: a silently-dead peer (power loss,
        # partition — no FIN ever arrives) gets its connection, parked
        # stream handlers, and tasks reaped instead of leaking forever;
        # the sync client answers ws pings in its reader thread
        ws = web.WebSocketResponse(max_msg_size=16 << 20, heartbeat=30.0)
        await ws.prepare(request)
        self.connections += 1
        self._live_ws.add(ws)
        send_lock = asyncio.Lock()

        async def send_frame(data: bytes) -> None:
            async with send_lock:
                await ws.send_bytes(data)
            stats_add("tx_bytes", len(data))

        streams: dict[int, ServerStream] = {}
        stream_tasks: dict[int, asyncio.Task] = {}
        tasks: set[asyncio.Task] = set()
        try:
            async for msg in ws:
                if msg.type != web.WSMsgType.BINARY:
                    continue
                data = msg.data
                stats_add("rx_bytes", len(data))
                ftype, mux = _HDR.unpack_from(data)
                payload = data[_HDR.size:]
                if ftype == T_PING:
                    await send_frame(_frame(T_PONG, mux))
                elif ftype == T_REQ:
                    stats_add("calls")
                    t = asyncio.create_task(self._run_single(send_frame, mux, payload))
                    tasks.add(t)
                    t.add_done_callback(tasks.discard)
                elif ftype == T_STR_OPEN:
                    stats_add("streams")
                    handler, req, window = msgpack.unpackb(payload, raw=False)
                    fn = self._stream.get(handler)
                    if fn is None:
                        await send_frame(
                            _frame(T_STR_ERR, mux,
                                   msgpack.packb(["GridError", f"no handler {handler}"]))
                        )
                        continue
                    st = ServerStream(send_frame, mux, window)
                    streams[mux] = st
                    t = asyncio.create_task(
                        self._run_stream(send_frame, mux, fn, req, st, streams)
                    )
                    stream_tasks[mux] = t
                    tasks.add(t)
                    t.add_done_callback(tasks.discard)
                    t.add_done_callback(lambda _t, m=mux: stream_tasks.pop(m, None))
                elif ftype == T_STR_CANCEL:
                    # abandoned client iterator: release the handler (it may
                    # be parked on a credit acquire) instead of leaking it
                    t = stream_tasks.pop(mux, None)
                    if t is not None:
                        t.cancel()
                    streams.pop(mux, None)
                elif ftype == T_STR_MSG:
                    st = streams.get(mux)
                    if st is not None:
                        st._inbox.put_nowait(bytes(payload))
                elif ftype == T_STR_EOF:
                    st = streams.get(mux)
                    if st is not None:
                        st.client_eof = True
                        st._inbox.put_nowait(None)
                elif ftype == T_STR_CREDIT:
                    st = streams.get(mux)
                    if st is not None:
                        for _ in range(msgpack.unpackb(payload, raw=False)):
                            st._send_credits.release()
        finally:
            self.connections -= 1
            self._live_ws.discard(ws)
            for t in tasks:
                t.cancel()
        # returning the WebSocketResponse is the front's contract (as in
        # aiohttp): the connection then serves no more HTTP
        return ws

    async def _run_single(self, send_frame, mux: int, payload: bytes) -> None:
        import asyncio

        try:
            handler, req = msgpack.unpackb(payload, raw=False)
            fn = self._single.get(handler)
            if fn is None:
                raise GridError(f"no handler {handler}")
            if handler in self._inline:
                result = fn(req)
            else:
                loop = asyncio.get_running_loop()
                result = await loop.run_in_executor(None, fn, req)
            body = msgpack.packb([True, result, ""])
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — typed errors cross the wire
            body = msgpack.packb([False, type(e).__name__, str(e)])
        try:
            await send_frame(_frame(T_RESP, mux, body))
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — peer went away mid-response
            pass

    async def _run_stream(self, send_frame, mux, fn, req, st, streams) -> None:
        import asyncio

        try:
            await fn(req, st)
            await send_frame(_frame(T_STR_EOF, mux))
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001
            try:
                await send_frame(
                    _frame(T_STR_ERR, mux, msgpack.packb([type(e).__name__, str(e)]))
                )
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — peer went away mid-error
                pass
        finally:
            streams.pop(mux, None)


# ---------------------------------------------------------------------------
# Client side (blocking, thread-safe, one reader thread per connection)
# ---------------------------------------------------------------------------


class _WSock:
    """Minimal RFC 6455 client: upgrade handshake + masked binary frames."""

    def __init__(self, host: str, port: int, path: str, headers: dict[str, str],
                 timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        from ..crypto import tlsconf

        # internode TLS: the grid rides wss when the cluster serves https
        self.sock = tlsconf.wrap_client_socket(self.sock, host)
        key = base64.b64encode(os.urandom(16)).decode()
        req = (
            f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
        )
        for k, v in headers.items():
            req += f"{k}: {v}\r\n"
        self.sock.sendall((req + "\r\n").encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise GridError("grid handshake: connection closed")
            resp += chunk
            if len(resp) > 65536:
                raise GridError("grid handshake: oversized response")
        head, _, rest = resp.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        if " 101 " not in lines[0] + " ":
            raise GridError(f"grid handshake rejected: {lines[0]}")
        accept = ""
        for ln in lines[1:]:
            k, _, v = ln.partition(":")
            if k.strip().lower() == "sec-websocket-accept":
                accept = v.strip()
        want = base64.b64encode(
            hashlib.sha1((key + _WS_GUID).encode()).digest()
        ).decode()
        if accept != want:
            raise GridError("grid handshake: bad Sec-WebSocket-Accept")
        self._buf = bytearray(rest)
        # one bounded socket timeout, interpreted per direction: a WRITE
        # hitting it means the peer is wedged (full TCP window) and the
        # caller gets an error instead of hanging behind the write lock;
        # a READ hitting it just keeps waiting (idle connections are
        # normal — the keepalive loop detects dead links)
        self.sock.settimeout(SEND_TIMEOUT)
        self._wlock = threading.Lock()  # frames must not interleave

    def send_binary(self, payload: bytes) -> None:
        n = len(payload)
        if n < 126:
            hdr = struct.pack("!BB", 0x82, 0x80 | n)
        elif n < 65536:
            hdr = struct.pack("!BBH", 0x82, 0x80 | 126, n)
        else:
            hdr = struct.pack("!BBQ", 0x82, 0x80 | 127, n)
        mask = os.urandom(4)
        with self._wlock:
            self.sock.sendall(hdr + mask + _mask_fast(payload, mask))

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            try:
                chunk = self.sock.recv(65536)
            except TimeoutError:
                continue  # idle is fine; only writes treat timeout as fatal
            if not chunk:
                raise GridError("grid connection closed")
            self._buf += chunk
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def recv_message(self) -> bytes | None:
        """Next binary message (handles fragmentation, ping, close)."""
        parts: list[bytes] = []
        while True:
            b0, b1 = self._read_exact(2)
            fin, opcode = b0 & 0x80, b0 & 0x0F
            plen = b1 & 0x7F
            if plen == 126:
                (plen,) = struct.unpack("!H", self._read_exact(2))
            elif plen == 127:
                (plen,) = struct.unpack("!Q", self._read_exact(8))
            mask = self._read_exact(4) if b1 & 0x80 else b""
            data = self._read_exact(plen)
            if mask:
                data = _mask_fast(data, mask)
            if opcode == 0x8:  # close
                return None
            if opcode == 0x9:  # ping -> pong
                n = len(data)
                m = os.urandom(4)
                with self._wlock:
                    self.sock.sendall(
                        struct.pack("!BB", 0x8A, 0x80 | n) + m + _mask_fast(data, m)
                    )
                continue
            if opcode == 0xA:  # ws-level pong
                continue
            parts.append(data)
            if fin:
                return b"".join(parts)

    def close(self) -> None:
        try:
            with self._wlock:
                self.sock.sendall(struct.pack("!BB", 0x88, 0x80) + os.urandom(4))
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _mask_fast(data: bytes, mask: bytes) -> bytes:
    # XOR via one big-int op: ~40x faster than a per-byte Python loop
    n = len(data)
    if n == 0:
        return b""
    key = int.from_bytes((mask * ((n + 3) // 4))[:n], "little")
    return (int.from_bytes(data, "little") ^ key).to_bytes(n, "little")


class ClientStream:
    """Client end of a muxed stream (blocking API)."""

    def __init__(self, conn: GridClient, mux: int, window: int):
        self._conn = conn
        self.mux = mux
        self._window = window
        self._send_credits = threading.Semaphore(window)
        self._inbox: queue.Queue = queue.Queue()
        self._consumed = 0
        self._err: RemoteError | GridError | None = None

    def send(self, data: bytes, timeout: float = 30.0) -> None:
        if self._err is not None:
            raise self._err
        if not self._send_credits.acquire(timeout=timeout):
            raise GridError("stream send: no credits (peer stalled)")
        self._conn._send(_frame(T_STR_MSG, self.mux, data))

    def close_send(self) -> None:
        self._conn._send(_frame(T_STR_EOF, self.mux))

    def cancel(self) -> None:
        """Abandon the stream: tell the server to cancel its handler (which
        may be parked waiting for credits) so neither side leaks state."""
        with self._conn._lock:
            st = self._conn._streams.pop(self.mux, None)
        if st is None:
            return  # already finished or errored
        try:
            self._conn._send(_frame(T_STR_CANCEL, self.mux))
        except GridError:
            pass  # connection already gone: server side was dropped too

    def recv(self, timeout: float = 30.0) -> bytes | None:
        """Next server->client message, or None at server EOF."""
        if self._err is not None:
            raise self._err
        try:
            item = self._inbox.get(timeout=timeout)
        except queue.Empty:
            raise GridError("stream recv timeout") from None
        if isinstance(item, Exception):
            self._err = item
            raise item
        if item is None:
            return None
        self._consumed += 1
        if self._consumed >= self._window // 2:
            grant, self._consumed = self._consumed, 0
            self._conn._send(_frame(T_STR_CREDIT, self.mux, msgpack.packb(grant)))
        return item

    def __iter__(self):
        while True:
            item = self.recv()
            if item is None:
                return
            yield item


class GridClient:
    """One muxed connection to a peer (per plane). Thread-safe."""

    def __init__(self, host: str, port: int, token: str, plane: str = "storage",
                 ping_interval: float = 10.0):
        self.host, self.port, self.token, self.plane = host, port, token, plane
        self._ws: _WSock | None = None
        self._lock = threading.Lock()  # mux/calls/streams state (never I/O)
        self._conn_lock = threading.Lock()  # serializes connect attempts
        self._connect_fail_until = 0.0  # queued threads fail fast after one
        self._mux = 0
        self._calls: dict[int, queue.Queue] = {}
        self._streams: dict[int, ClientStream] = {}
        self._gen = 0  # bumped per reconnect; reader threads exit on mismatch
        self._ping_interval = ping_interval
        self._last_pong = 0.0
        self._closed = False

    # -- connection management --------------------------------------------

    def _ensure(self) -> _WSock:
        with self._lock:
            if self._closed:
                raise GridError("grid client closed")
            if self._ws is not None:
                return self._ws
            if time.monotonic() < self._connect_fail_until:
                # a sibling thread just paid the connect timeout; don't make
                # every queued caller pay it again serially
                raise GridConnectError(
                    f"grid {self.host}:{self.port}: recent connect failure"
                )
        # connect OUTSIDE _lock: a blackholed peer costs one caller the
        # connect timeout, not every thread touching this client's state
        with self._conn_lock:
            with self._lock:
                if self._closed:
                    raise GridError("grid client closed")
                if self._ws is not None:
                    return self._ws
                if time.monotonic() < self._connect_fail_until:
                    raise GridConnectError(
                        f"grid {self.host}:{self.port}: recent connect failure"
                    )
            try:
                stats_add("dials")
                ws = _WSock(
                    self.host, self.port, GRID_ROUTE,
                    {"x-minio-token": self.token,
                     "x-minio-grid-plane": self.plane},
                )
            except (OSError, GridError) as e:
                stats_add("dial_errors")
                with self._lock:
                    self._connect_fail_until = time.monotonic() + 1.0
                raise GridConnectError(str(e)) from None
            with self._lock:
                if self._closed:
                    ws.close()
                    raise GridError("grid client closed")
                self._ws = ws
                self._gen += 1
                gen = self._gen
                self._last_pong = time.monotonic()
            threading.Thread(
                target=self._read_loop, args=(ws, gen), daemon=True
            ).start()
            if self._ping_interval > 0:
                threading.Thread(
                    target=self._keepalive_loop, args=(ws, gen), daemon=True
                ).start()
            return ws

    def _drop(self, ws: _WSock) -> None:
        """Fail everything pending on this connection and forget it."""
        with self._lock:
            if self._ws is not ws:
                return
            self._ws = None
            calls, self._calls = self._calls, {}
            streams, self._streams = self._streams, {}
        stats_add("disconnects")
        err = GridError(f"grid {self.host}:{self.port} disconnected")
        for q in calls.values():
            q.put(err)
        for st in streams.values():
            # _err makes the NEXT send() fail fast too: the server lost the
            # mux, so further sends would vanish silently after reconnect
            st._err = err
            st._inbox.put(err)
        ws.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            ws, self._ws = self._ws, None
        if ws is not None:
            ws.close()

    def _send(self, data: bytes) -> None:
        ws = self._ensure()
        try:
            # _WSock serializes frames internally; _lock is NOT held during
            # the (possibly slow) socket write, so a stalled send to a
            # wedged peer cannot block unrelated state transitions
            ws.send_binary(data)
            stats_add("tx_bytes", len(data))
        except OSError as e:
            self._drop(ws)
            raise GridError(f"grid send failed: {e}") from None

    def _read_loop(self, ws: _WSock, gen: int) -> None:
        try:
            while True:
                msg = ws.recv_message()
                if msg is None:
                    break
                stats_add("rx_bytes", len(msg))
                ftype, mux = _HDR.unpack_from(msg)
                payload = msg[_HDR.size:]
                # mux-table lookups take _lock: `_drop` (fired from the
                # keepalive thread or any caller thread whose send
                # failed) swaps _calls/_streams under it, and an
                # unlocked pop here could deliver into the already-
                # failed generation's table (miniovet races pass)
                if ftype == T_RESP:
                    with self._lock:
                        q = self._calls.pop(mux, None)
                    if q is not None:
                        q.put(payload)
                elif ftype == T_STR_MSG:
                    with self._lock:
                        st = self._streams.get(mux)
                    if st is not None:
                        st._inbox.put(payload)
                elif ftype == T_STR_EOF:
                    with self._lock:
                        st = self._streams.pop(mux, None)
                    if st is not None:
                        st._inbox.put(None)
                elif ftype == T_STR_ERR:
                    with self._lock:
                        st = self._streams.pop(mux, None)
                    if st is not None:
                        et, em = msgpack.unpackb(payload, raw=False)
                        st._inbox.put(RemoteError(et, em))
                elif ftype == T_STR_CREDIT:
                    with self._lock:
                        st = self._streams.get(mux)
                    if st is not None:
                        for _ in range(msgpack.unpackb(payload, raw=False)):
                            st._send_credits.release()
                elif ftype == T_PONG:
                    with self._lock:
                        self._last_pong = time.monotonic()
        except (GridError, OSError):
            pass
        finally:
            if self._gen == gen:
                self._drop(ws)

    def _keepalive_loop(self, ws: _WSock, gen: int) -> None:
        """Ping the peer every interval; a silently-dead link (NAT drop,
        peer wedge) is detected here instead of stalling the next RPC for
        its full timeout."""
        while True:
            # miniovet: ignore[blocking] -- keepalive pacing on the
            # dedicated daemon ping thread, not the event loop
            time.sleep(self._ping_interval)
            with self._lock:
                if self._ws is not ws or self._closed:
                    return
            try:
                ws.send_binary(_frame(T_PING, 0))
            except OSError:
                self._drop(ws)
                return
            with self._lock:
                last_pong = self._last_pong
            if time.monotonic() - last_pong > 2 * self._ping_interval:
                self._drop(ws)
                return

    def _next_mux(self) -> int:
        with self._lock:
            self._mux = (self._mux + 1) & 0xFFFFFFFF
            return self._mux

    # -- public API --------------------------------------------------------

    def _apply_net_fault(self, rule, handler: str) -> None:
        """Injected network fault (fault/ registry) on this peer link."""
        if rule.mode == "delay":
            fault_registry.sleep_latency(rule)
            return
        if rule.mode == "disconnect":
            with self._lock:
                ws = self._ws
            if ws is not None:
                self._drop(ws)
            raise GridError(
                f"grid {self.host}:{self.port}: injected disconnect"
            )
        if rule.mode == "partition":
            # never-sent semantics: callers may fall back / resend freely
            raise GridConnectError(
                f"grid {self.host}:{self.port}: injected partition"
            )
        raise GridError(
            f"grid call {handler}: injected drop"
        )

    def call(self, handler: str, payload: bytes, timeout: float = 30.0,
             retry: bool = False) -> bytes:
        """Single-payload request/response. Raises RemoteError (typed) or
        GridError (transport). retry=True retries transport failures AND
        timeouts through the shared backoff policy (fault/retry.py) —
        callers must only set it for idempotent ops (a timed-out request
        may still have been applied remotely). The retry budget is
        deadline-bounded at 1.5x the caller's timeout: a blackholed peer
        costs at most half a timeout more than the old single-attempt
        behaviour, instead of attempts x timeout."""
        deadline = time.monotonic() + timeout * 1.5 if retry else None

        def attempt() -> bytes:
            rule = fault_registry.check(
                "network", f"{self.host}:{self.port}", handler
            )
            if rule is not None:
                self._apply_net_fault(rule, handler)
            mux = self._next_mux()
            q: queue.Queue = queue.Queue()
            # registration under _lock: _drop swaps the dict under the same
            # lock, so an entry lands either in the old dict (and gets the
            # disconnect error) or the new one (served by the reconnect) —
            # never silently orphaned between the two
            with self._lock:
                self._calls[mux] = q
            wait_s = timeout
            if deadline is not None:
                wait_s = max(min(timeout, deadline - time.monotonic()), 0.01)
            try:
                self._send(_frame(T_REQ, mux, msgpack.packb([handler, payload])))
                resp = q.get(timeout=wait_s)
            except queue.Empty:
                with self._lock:
                    self._calls.pop(mux, None)
                raise GridTimeout(f"grid call {handler}: timeout") from None
            except GridError:
                with self._lock:
                    self._calls.pop(mux, None)
                raise
            if isinstance(resp, Exception):
                raise resp
            ok, a, b = msgpack.unpackb(resp, raw=False)
            if ok:
                return a if isinstance(a, bytes) else bytes(a)
            raise RemoteError(a, b)

        stats_add("calls")
        # the policy deadline bounds attempt waits AND backoff sleeps
        policy = retry_mod.shared_policy(
            idempotent=retry,
            deadline_s=timeout * 1.5 if retry else None,
        )
        return policy.run(
            attempt, retryable=lambda e: isinstance(e, GridError)
        )

    def stream(self, handler: str, payload: bytes,
               window: int = DEFAULT_WINDOW) -> ClientStream:
        stats_add("streams")
        mux = self._next_mux()
        st = ClientStream(self, mux, window)
        with self._lock:
            self._streams[mux] = st
        try:
            self._send(
                _frame(T_STR_OPEN, mux, msgpack.packb([handler, payload, window]))
            )
        except GridError:
            with self._lock:
                self._streams.pop(mux, None)
            raise
        return st

    def ping(self, timeout: float = 5.0) -> bool:
        start = time.monotonic()
        self._send(_frame(T_PING, 0))
        while time.monotonic() - start < timeout:
            if self._last_pong >= start:
                return True
            # miniovet: ignore[blocking] -- blocking client API: pong
            # arrives on the reader thread; callers run in executors
            time.sleep(0.01)
        return False


# Shared per-process connection registry: ONE grid connection per
# (peer, plane), however many StorageRESTClient drives point at the peer —
# the muxing is the point.
_registry: dict[tuple, GridClient] = {}
_registry_lock = threading.Lock()


def shared_client(host: str, port: int, token: str, plane: str = "storage") -> GridClient:
    key = (host, port, token, plane)
    with _registry_lock:
        c = _registry.get(key)
        if c is None or c._closed:
            c = GridClient(host, port, token, plane)
            _registry[key] = c
        return c


def close_shared_clients() -> None:
    """Shutdown hook: close every outgoing grid connection. Without
    this, the PEER's HTTP front keeps a parked websocket handler
    per connection and its graceful cleanup waits out the full shutdown
    timeout — two pool workers stopping together would deadlock each
    other's drains for up to a minute."""
    with _registry_lock:
        clients = list(_registry.values())
        _registry.clear()
    for c in clients:
        try:
            c.close()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass


class GridGate:
    """Grid-with-fallback policy shared by every transport adapter
    (storage REST client, remote locker): enabled via MINIO_TPU_GRID,
    backs off for a few seconds after a transport failure so callers pay
    one reconnect attempt per window, not per RPC."""

    BACKOFF_S = 5.0

    def __init__(self, host: str, port: int, token: str, plane: str):
        self.host, self.port, self.token, self.plane = host, port, token, plane
        self.enabled = os.environ.get("MINIO_TPU_GRID", "1") != "0"
        self._down_until = 0.0

    def client(self) -> GridClient | None:
        """The shared connection for this peer/plane, or None while the
        grid is disabled or backing off (caller uses its fallback)."""
        if not self.enabled or time.monotonic() < self._down_until:
            return None
        return shared_client(self.host, self.port, self.token, self.plane)

    def failed(self) -> None:
        self._down_until = time.monotonic() + self.BACKOFF_S
