"""The port's muxed internode RPC (``minio_tpu_torch/cluster/grid.py``) on
its own HTTP front, and the websocket under it.

The cases of ``tests/test_grid.py`` run three ways: the port's server with
the port's client, and each package's server with the other's client, so
the grid's wire format (frame types, msgpack payloads, credits) is held
against the reference in both directions. The storage and lock planes ride
the same pairs. Then the front's RFC 6455 rules are held against aiohttp on
raw sockets: the same frames go to an echo handler on each server and the
bytes that come back must agree.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import importlib
import os
import socket
import struct
import threading
import time

import pytest

from minio_tpu_torch.utils import msgpack_lite as msgpack
from tests.test_s3_api import _free_port

# (server package, client package) of each pair
PAIRS = {"port": ("minio_tpu_torch", "minio_tpu_torch"),
         "ref-server": ("minio_tpu", "minio_tpu_torch"),
         "ref-client": ("minio_tpu_torch", "minio_tpu")}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class _Loop:
    """An app of ``webmod`` (aiohttp.web or the port's front) served on a
    loopback port from an event loop thread of its own."""

    def __init__(self, webmod, app):
        self.loop = asyncio.new_event_loop()
        self.port = _free_port()
        self.runner = webmod.AppRunner(app, shutdown_timeout=0.5)
        started = threading.Event()

        async def start():
            await self.runner.setup()
            await webmod.TCPSite(self.runner, "127.0.0.1", self.port).start()
            started.set()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(start())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(10)

    def stop(self):
        async def shutdown():
            await self.runner.cleanup()
            self.loop.stop()

        asyncio.run_coroutine_threadsafe(shutdown(), self.loop)
        self.thread.join(10)


def _web(pkg: str):
    if pkg == "minio_tpu":
        from aiohttp import web

        return web
    from minio_tpu_torch.server import web

    return web


@pytest.fixture(params=sorted(PAIRS))
def grid_app(request):
    """A GridServer of the pair's server package on its front, and the
    pair's client package."""
    spkg, cpkg = PAIRS[request.param]
    webmod = _web(spkg)
    token = "grid-test-token"
    gs = _mod(spkg, "cluster.grid").GridServer(token)
    app = webmod.Application()
    gs.register(app)
    srv = _Loop(webmod, app)
    yield gs, "127.0.0.1", srv.port, token, spkg, cpkg
    _mod(cpkg, "cluster.grid").close_shared_clients()
    srv.stop()


def _client(grid_app, **kw):
    _, host, port, token, _, cpkg = grid_app
    return _mod(cpkg, "cluster.grid").GridClient(host, port, token, **kw)


def _errors(grid_app):
    g = _mod(grid_app[5], "cluster.grid")
    return g.GridError, g.RemoteError


def test_single_call_roundtrip(grid_app):
    gs = grid_app[0]
    gs.register_single("echo", lambda p: b"you said " + p)
    c = _client(grid_app)
    try:
        assert c.call("echo", b"hi") == b"you said hi"
        assert c.call("echo", b"again") == b"you said again"
    finally:
        c.close()


def test_bad_token_rejected(grid_app):
    _, host, port, _, _, cpkg = grid_app
    c = _mod(cpkg, "cluster.grid").GridClient(host, port, "wrong-token")
    with pytest.raises(_errors(grid_app)[0]):
        c.call("echo", b"x")


def test_typed_error_propagates(grid_app):
    gs = grid_app[0]

    class FileNotFound(Exception):
        pass

    def boom(_p):
        raise FileNotFound("no such thing")

    gs.register_single("boom", boom)
    c = _client(grid_app)
    try:
        with pytest.raises(_errors(grid_app)[1]) as ei:
            c.call("boom", b"")
        assert ei.value.err_type == "FileNotFound"
        assert "no such thing" in str(ei.value)
    finally:
        c.close()


def test_concurrent_calls_share_one_connection(grid_app):
    """32 threads x 8 calls interleave on ONE websocket: the muxing."""
    gs = grid_app[0]
    gs.register_single("double", lambda p: p * 2)
    c = _client(grid_app)
    errs: list = []

    def worker(i: int):
        try:
            for j in range(8):
                body = f"{i}:{j}".encode()
                assert c.call("double", body) == body * 2
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    try:
        assert not errs
        assert gs.connections == 1
    finally:
        c.close()


def test_stream_server_to_client(grid_app):
    gs = grid_app[0]

    async def count(payload, st):
        n = msgpack.unpackb(payload, raw=False)
        for i in range(n):
            await st.send(str(i).encode())

    gs.register_stream("count", count)
    c = _client(grid_app)
    try:
        st = c.stream("count", msgpack.packb(100))
        assert [int(m) for m in st] == list(range(100))
    finally:
        c.close()


def test_stream_flow_control_backpressure(grid_app):
    """A slow consumer caps the producer at the credit window."""
    gs = grid_app[0]
    sent = {"n": 0}

    async def firehose(_payload, st):
        for i in range(60):
            await st.send(b"m%d" % i)
            sent["n"] += 1

    gs.register_stream("firehose", firehose)
    c = _client(grid_app)
    try:
        window = 8
        st = c.stream("firehose", b"", window=window)
        time.sleep(0.4)  # consume nothing: the producer stalls at the window
        assert sent["n"] <= window
        assert len(list(st)) == 60
        assert sent["n"] == 60
    finally:
        c.close()


def test_stream_client_to_server(grid_app):
    gs = grid_app[0]

    async def summer(_payload, st):
        total = 0
        while True:
            item = await st.recv()
            if item is None:
                break
            total += int(item)
        await st.send(str(total).encode())

    gs.register_stream("sum", summer)
    c = _client(grid_app)
    try:
        st = c.stream("sum", b"")
        for i in range(50):
            st.send(str(i).encode())
        st.close_send()
        assert st.recv() == str(sum(range(50))).encode()
        assert st.recv() is None
    finally:
        c.close()


def test_stream_error_propagates(grid_app):
    gs = grid_app[0]

    async def failing(_payload, st):
        await st.send(b"one")
        raise ValueError("stream exploded")

    gs.register_stream("failing", failing)
    c = _client(grid_app)
    try:
        st = c.stream("failing", b"")
        assert st.recv() == b"one"
        with pytest.raises(_errors(grid_app)[1]) as ei:
            while st.recv() is not None:
                pass
        assert ei.value.err_type == "ValueError"
    finally:
        c.close()


def test_stream_cancel_releases_server_handler(grid_app):
    """An abandoned client iterator cancels the server-side handler that
    is parked on credits."""
    gs = grid_app[0]
    state = {"cancelled": False}

    async def firehose(_payload, st):
        try:
            for i in range(1000):
                await st.send(b"x%d" % i)
        except asyncio.CancelledError:
            state["cancelled"] = True
            raise

    gs.register_stream("firehose2", firehose)
    c = _client(grid_app)
    try:
        st = c.stream("firehose2", b"", window=4)
        assert st.recv() == b"x0"
        assert st.recv() == b"x1"
        st.cancel()
        deadline = time.time() + 5
        while not state["cancelled"] and time.time() < deadline:
            time.sleep(0.05)
        assert state["cancelled"]
        assert st.mux not in c._streams
    finally:
        c.close()


def test_keepalive_detects_dead_link(grid_app):
    gs = grid_app[0]
    gs.register_single("echo", lambda p: p)
    c = _client(grid_app, ping_interval=0.2)
    try:
        assert c.call("echo", b"a") == b"a"
        ws = c._ws
        assert ws is not None
        ws.sock.close()
        deadline = time.time() + 5
        while c._ws is ws and time.time() < deadline:
            time.sleep(0.05)
        assert c._ws is not ws  # the keepalive noticed, no RPC needed
        assert c.call("echo", b"b", retry=True) == b"b"  # and it reconnects
    finally:
        c.close()


def test_reconnect_after_drop(grid_app):
    gs = grid_app[0]
    gs.register_single("echo", lambda p: p)
    c = _client(grid_app)
    try:
        assert c.call("echo", b"a") == b"a"
        c._ws.sock.close()  # sever the TCP connection under the client
        assert c.call("echo", b"b", retry=True) == b"b"
    finally:
        c.close()


def test_ping(grid_app):
    c = _client(grid_app)
    try:
        assert c.ping()
    finally:
        c.close()


def test_large_message_roundtrip(grid_app):
    """Over 64 KiB takes the 8-byte websocket length both ways."""
    gs = grid_app[0]
    gs.register_single("echo", lambda p: p)
    c = _client(grid_app)
    try:
        blob = os.urandom(300_000)
        assert c.call("echo", blob) == blob
    finally:
        c.close()


# storage and lock planes over the grid (no HTTP routes are registered, so
# success proves the ops rode the mux)


def test_storage_plane_over_grid(grid_app, tmp_path):
    gs, host, port, token, spkg, cpkg = grid_app
    errors = _mod(cpkg, "storage.errors")
    FileInfo = _mod(cpkg, "storage.datatypes").FileInfo
    drive = _mod(spkg, "storage.xlstorage").XLStorage(str(tmp_path / "d1"))
    _mod(spkg, "cluster.storage_rest").StorageRESTServer({0: drive}, token).register_grid(gs)

    cli = _mod(cpkg, "cluster.storage_rest").StorageRESTClient(host, port, 0, token)
    cli.make_vol("vol")
    assert any(v.name == "vol" for v in cli.list_vols())
    fi = FileInfo(volume="vol", name="obj/a", mod_time=time.time_ns())
    fi.metadata["x-test"] = "1"
    cli.write_metadata("vol", "obj/a", fi)
    assert cli.read_version("vol", "obj/a").metadata.get("x-test") == "1"
    with pytest.raises(errors.FileNotFound):
        cli.read_version("vol", "missing/obj")
    for i in range(30):  # walkdir rides the credit-controlled stream
        cli.write_metadata("vol", f"walk/k{i:03d}",
                           FileInfo(volume="vol", name=f"walk/k{i:03d}",
                                    mod_time=time.time_ns()))
    keys = [k for k in cli.walk_dir("vol", "walk") if "k0" in k]
    assert len(keys) == 30 and keys == sorted(keys)
    assert gs.connections >= 1


def test_lock_plane_separate_connection(grid_app):
    gs, host, port, token, spkg, cpkg = grid_app
    _mod(spkg, "cluster.storage_rest").StorageRESTServer({}, token).register_grid(gs)
    slocks = _mod(spkg, "cluster.locks")
    slocks.LockRESTServer(slocks.LocalLocker(), token).register_grid(gs)

    _mod(cpkg, "cluster.grid").shared_client(host, port, token, "storage").ping()
    lk = _mod(cpkg, "cluster.locks")._RemoteLocker(host, port, token)
    assert lk.lock("bucket/obj", "uid-1")
    assert not lk.lock("bucket/obj", "uid-2")  # held
    assert lk.unlock("bucket/obj", "uid-1")
    assert lk.lock("bucket/obj", "uid-2")
    assert lk.unlock("bucket/obj", "uid-2")
    assert gs.connections == 2  # the lock plane has its own websocket


# -- the front's websocket against aiohttp, on raw sockets ----------------------

MAX_MSG = 100_000
HEARTBEAT = 0.4


def _echo_app(webmod):
    """The same handler on both fronts: echo TEXT and BINARY; a TEXT
    "close" makes the server start the close."""
    async def handler(request):
        hb = HEARTBEAT if request.rel_url.query.get("hb") else None
        ws = webmod.WebSocketResponse(max_msg_size=MAX_MSG, heartbeat=hb)
        await ws.prepare(request)
        async for msg in ws:
            if msg.type == webmod.WSMsgType.TEXT:
                if msg.data == "close":
                    await ws.close(code=1001, message=b"bye")
                    break
                await ws.send_str(msg.data)
            elif msg.type == webmod.WSMsgType.BINARY:
                await ws.send_bytes(msg.data)
        return ws

    app = webmod.Application()
    app.router.add_route("GET", "/ws", handler)
    return app


@pytest.fixture(scope="module")
def fronts():
    from aiohttp import web as aioweb

    from minio_tpu_torch.server import web as portweb

    servers = {"aiohttp": _Loop(aioweb, _echo_app(aioweb)),
               "port": _Loop(portweb, _echo_app(portweb))}
    yield {k: s.port for k, s in servers.items()}
    for s in servers.values():
        s.stop()


KEY = base64.b64encode(b"0123456789abcdef").decode()


def _frame(opcode: int, payload: bytes = b"", *, fin=True, mask=True, rsv=0,
           length=None) -> bytes:
    n = len(payload) if length is None else length
    b0 = (0x80 if fin else 0) | rsv | opcode
    if n < 126:
        hdr = struct.pack("!BB", b0, (0x80 if mask else 0) | n)
    elif n < 65536:
        hdr = struct.pack("!BBH", b0, (0x80 if mask else 0) | 126, n)
    else:
        hdr = struct.pack("!BBQ", b0, (0x80 if mask else 0) | 127, n)
    if not mask:
        return hdr + payload
    key = b"\x11\x22\x33\x44"
    return hdr + key + bytes(b ^ key[i % 4] for i, b in enumerate(payload))


def _close(code: int, msg: bytes = b"") -> bytes:
    return _frame(0x8, struct.pack("!H", code) + msg)


# (upgrade request headers or None for a good one, frames sent, query)
CASES = {
    "binary-masked": (None, [_frame(0x2, b"hello")], ""),
    "binary-unmasked": (None, [_frame(0x2, b"plain", mask=False)], ""),
    "binary-64k": (None, [_frame(0x2, b"x" * 70000)], ""),
    "text": (None, [_frame(0x1, "grüße".encode())], ""),
    "fragments-with-ping": (None, [_frame(0x1, b"ab", fin=False), _frame(0x9, b"p1"),
                                   _frame(0x0, b"cd", fin=False), _frame(0x0, b"ef")], ""),
    "pong-ignored": (None, [_frame(0xA, b"x"), _frame(0x2, b"after")], ""),
    "close-1000": (None, [_close(1000, b"done")], ""),
    "close-empty": (None, [_frame(0x8, b"")], ""),
    "server-closes": (None, [_frame(0x1, b"close"), _close(1000)], ""),
    "continuation-first": (None, [_frame(0x0, b"zz")], ""),
    "new-opcode-mid-message": (None, [_frame(0x2, b"a", fin=False), _frame(0x2, b"b")], ""),
    "reserved-bits": (None, [_frame(0x2, b"r", rsv=0x40)], ""),
    "fragmented-control": (None, [_frame(0x9, b"p", fin=False)], ""),
    "long-control": (None, [_frame(0x9, b"p" * 126)], ""),
    "unknown-opcode": (None, [_frame(0x3, b"?")], ""),
    "bad-close-code": (None, [_close(1004)], ""),
    "short-close": (None, [_frame(0x8, b"\x03")], ""),
    "bad-utf8-text": (None, [_frame(0x1, b"\xff\xfe")], ""),
    "oversize": (None, [_frame(0x2, b"y" * MAX_MSG)], ""),
    "oversize-fragments": (None, [_frame(0x2, b"y" * 60_000, fin=False),
                                  _frame(0x0, b"y" * 60_000)], ""),
    "just-under-limit": (None, [_frame(0x2, b"y" * (MAX_MSG - 1))], ""),
    "heartbeat-no-pong": (None, [], "?hb=1"),
    "heartbeat-answered": (None, ["pong-after-ping"], "?hb=1"),
    "bad-version": ({"Sec-WebSocket-Version": "12"}, [], ""),
    "no-key": ({"Sec-WebSocket-Key": None}, [], ""),
    "short-key": ({"Sec-WebSocket-Key": base64.b64encode(b"short").decode()}, [], ""),
    "no-upgrade": ({"Upgrade": None}, [], ""),
    "no-connection-upgrade": ({"Connection": "keep-alive"}, [], ""),
}


def _talk(port: int, case) -> tuple[bytes, list[bytes]]:
    """(the response head, Date and Server dropped, sorted; the frames
    that came after it). Reading stops at EOF or after an idle spell."""
    hdr_over, frames, query = case
    hdrs = {"Host": f"127.0.0.1:{port}", "Upgrade": "websocket", "Connection": "Upgrade",
            "Sec-WebSocket-Key": KEY, "Sec-WebSocket-Version": "13"}
    for k, v in (hdr_over or {}).items():
        if v is None:
            hdrs.pop(k)
        else:
            hdrs[k] = v
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        req = f"GET /ws{query} HTTP/1.1\r\n" + "".join(f"{k}: {v}\r\n" for k, v in hdrs.items())
        s.sendall((req + "\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        lines = sorted(ln for ln in head.split(b"\r\n")
                       if not ln.lower().startswith((b"date:", b"server:")))
        answer_ping = "pong-after-ping" in frames
        for f in frames:
            if f != "pong-after-ping":
                s.sendall(f)
                time.sleep(0.02)
        idle = 3 * HEARTBEAT if query else 0.3
        s.settimeout(0.02)
        last = time.time()
        pong_at = None
        while time.time() - last < idle:
            try:
                chunk = s.recv(65536)
            except socket.timeout:
                chunk = None
            except ConnectionResetError:
                break
            if chunk == b"":
                break
            if chunk:
                rest += chunk
                last = time.time()
            if answer_ping and pong_at is None and rest.startswith(b"\x89\x00"):
                s.sendall(_frame(0xA))
                pong_at = time.time()
            if pong_at is not None and time.time() - pong_at > HEARTBEAT * 0.75:
                s.sendall(_frame(0x2, b"alive"))  # past the pong deadline
                answer_ping, pong_at = False, None
        return b"\r\n".join(lines), _split_frames(rest)
    finally:
        s.close()


def _split_frames(data: bytes) -> list[bytes]:
    out, pos = [], 0
    while pos + 2 <= len(data):
        n = data[pos + 1] & 0x7F
        hl = 2
        if n == 126:
            n, hl = struct.unpack("!H", data[pos + 2:pos + 4])[0], 4
        elif n == 127:
            n, hl = struct.unpack("!Q", data[pos + 2:pos + 10])[0], 10
        out.append(data[pos:pos + hl + n])
        pos += hl + n
    if pos < len(data):
        out.append(data[pos:])
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_websocket_rules_match_aiohttp(fronts, case):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as ex:
        got = dict(zip(fronts, ex.map(lambda p: _talk(p, CASES[case]), fronts.values())))
    assert got["port"] == got["aiohttp"]


def test_handshake_accept_key(fronts):
    """Sec-WebSocket-Accept is RFC 6455's digest of the client key."""
    head, _ = _talk(fronts["port"], (None, [], ""))
    want = base64.b64encode(hashlib.sha1(
        KEY.encode() + b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11").digest())
    assert b"Sec-WebSocket-Accept: " + want in head.split(b"\r\n")
    assert b"HTTP/1.1 101 Switching Protocols" in head.split(b"\r\n")


def test_shutdown_closes_live_websockets():
    """``on_shutdown`` runs at cleanup before in-flight requests are
    awaited, so a runner holding a grid websocket stops at once."""
    from minio_tpu_torch.cluster.grid import GridClient, GridServer
    from minio_tpu_torch.server import web

    gs = GridServer("t")
    app = web.Application()
    gs.register(app)
    srv = _Loop(web, app)
    srv.runner.shutdown_timeout = 30.0
    gs.register_single("echo", lambda p: p)
    c = GridClient("127.0.0.1", srv.port, "t")
    try:
        assert c.call("echo", b"a") == b"a"
        assert gs.connections == 1
        t0 = time.time()
        srv.stop()
        assert time.time() - t0 < 10
        assert gs.connections == 0
    finally:
        c.close()
