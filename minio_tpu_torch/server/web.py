"""A stdlib asyncio HTTP/1.1 server with the slice of ``aiohttp.web`` the
S3 handlers use, so they run on a host without aiohttp.

Surface: ``Application`` (routes, the ``on_response_prepare`` /
``on_startup`` / ``on_shutdown`` / ``on_cleanup`` signals, item storage),
``AppRunner`` and ``TCPSite``; ``Request`` (case-insensitive multi-valued ``headers``,
``method``, decoded ``path`` and ``match_info``, ``rel_url`` with a
multi-valued ``query`` and the raw path and query string, ``read()``,
``content.read(n)``, ``body_exists``, ``transport``, ``remote`` and item
storage); ``Response``, ``StreamResponse`` and ``json_response``; and a
server-side RFC 6455 ``WebSocketResponse`` with ``WSMsgType`` (the
internode grid's transport).

On the wire: keep-alive, ``Expect: 100-continue``, request bodies by
Content-Length or chunked transfer coding, chunked responses when no
length is set, HEAD and 204/304 without a body, 413 when ``read()`` passes
``client_max_size``, and a 500 for an exception a handler does not catch.
Framing is refused (400) where aiohttp's parser refuses it: a header name
that is not a token or a value with control characters, a Content-Length
that is not all digits or comes twice, Transfer-Encoding together with
Content-Length or without ``chunked`` as its last coding, a chunk size
that is not hex digits. A response header with CR or LF is never sent.
Paths and queries decode as yarl decodes them: routes match on the path
with ``%2F`` and ``%25`` kept encoded, and each matched value then decodes
those two, so ``/b/a%2Fb`` gives the key ``a/b``.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import codecs
import enum
import hashlib
import http
import json
import re
import socket
import struct
import sys
import threading
import traceback
from collections.abc import MutableMapping
from email.utils import formatdate
from typing import NamedTuple

__all__ = [
    "AppRunner",
    "Application",
    "CIMultiDict",
    "HTTPBadRequest",
    "HTTPException",
    "HTTPRequestEntityTooLarge",
    "MultiDict",
    "Request",
    "Response",
    "StreamResponse",
    "TCPSite",
    "WSMessage",
    "WSMsgType",
    "WebSocketResponse",
    "json_response",
    "serve_in_thread",
]

SERVER_SOFTWARE = f"Python/{sys.version_info[0]}.{sys.version_info[1]} minio_tpu_torch"
MAX_HEAD = 64 * 1024  # request line + headers
DRAIN_LIMIT = 1 << 20  # unread request body drained to keep a connection
KEEPALIVE_S = 75.0  # an idle keep-alive connection closes after (aiohttp's)
SHUTDOWN_S = 60.0  # requests in flight get this long at cleanup (aiohttp's)

_TOKEN = re.compile(r"[!#$%&'*+\-.^_`|~0-9A-Za-z]+")  # a header name (RFC 9110)
_CTL = re.compile(r"[\x00-\x08\x0a-\x1f\x7f]")  # not in a header value
_LENGTH = re.compile(r"[0-9]{1,18}")
_CHUNK = re.compile(rb"([0-9A-Fa-f]{1,16})(?:;[^\r\n]*)?\r\n")  # size [; ext] CRLF


# -- multi-dicts ---------------------------------------------------------------


class MultiDict(MutableMapping):
    """Ordered (key, value) pairs; a key may repeat. ``d[k]`` and ``get``
    give the first value, ``items()`` every pair."""

    def __init__(self, items=()):
        self._items: list[tuple[str, str]] = []
        for k, v in (items.items() if hasattr(items, "items") else items):
            self.add(k, v)

    @staticmethod
    def _k(key: str) -> str:
        return key

    def add(self, key: str, value) -> None:
        self._items.append((key, value))

    def _first(self, key: str, default=...):
        ck = self._k(key)
        for k, v in self._items:
            if self._k(k) == ck:
                return v
        if default is ...:
            raise KeyError(key)
        return default

    def __getitem__(self, key: str):
        return self._first(key)

    def get(self, key: str, default=None):
        return self._first(key, default)

    def __setitem__(self, key: str, value) -> None:
        ck = self._k(key)
        for i, (k, _) in enumerate(self._items):
            if self._k(k) == ck:
                self._items[i] = (k, value)
                self._items[i + 1:] = [
                    kv for kv in self._items[i + 1:] if self._k(kv[0]) != ck
                ]
                return
        self._items.append((key, value))

    def __delitem__(self, key: str) -> None:
        ck = self._k(key)
        kept = [kv for kv in self._items if self._k(kv[0]) != ck]
        if len(kept) == len(self._items):
            raise KeyError(key)
        self._items = kept

    def setdefault(self, key: str, default=None):
        ck = self._k(key)
        for k, v in self._items:
            if self._k(k) == ck:
                return v
        self._items.append((key, default))
        return default

    def __contains__(self, key) -> bool:
        if not isinstance(key, str):
            return False
        ck = self._k(key)
        return any(self._k(k) == ck for k, _ in self._items)

    def __iter__(self):
        return (k for k, _ in self._items)

    def __len__(self) -> int:
        return len(self._items)

    def keys(self):
        return [k for k, _ in self._items]

    def values(self):
        return [v for _, v in self._items]

    def items(self):
        return list(self._items)

    def __repr__(self) -> str:
        return f"<{type(self).__name__}({self._items!r})>"


class CIMultiDict(MultiDict):
    """A ``MultiDict`` whose keys compare without case (HTTP headers); the
    case each key was given in is kept for iteration and the wire."""

    @staticmethod
    def _k(key: str) -> str:
        return key.lower()


# -- decoding, as yarl decodes --------------------------------------------------

_HEX = re.compile(r"[0-9A-Fa-f]{2}")


def _unquote(val: str, *, plus: bool = False, keep: str = "") -> str:
    """Percent-decode ``val`` as UTF-8 the way yarl's unquoter does: a byte
    run that is not valid UTF-8 stays as its %XX text, a malformed escape
    stays as it is, ``+`` becomes a space only when ``plus``, and decoded
    characters in ``keep`` are re-encoded as %XX (upper case)."""
    if "%" not in val and not (plus and "+" in val):
        return val
    decoder = codecs.getincrementaldecoder("utf-8")()
    ret: list[str] = []
    idx, n = 0, len(val)
    while idx < n:
        ch = val[idx]
        idx += 1
        if ch == "%" and idx <= n - 2 and _HEX.fullmatch(val, idx, idx + 2):
            b = bytes([int(val[idx:idx + 2], 16)])
            idx += 2
            try:
                out = decoder.decode(b)
            except UnicodeDecodeError:
                start = idx - 3 - len(decoder.buffer) * 3
                ret.append(val[start:idx - 3])
                decoder.reset()
                try:
                    out = decoder.decode(b)
                except UnicodeDecodeError:
                    ret.append(val[idx - 3:idx])
                    continue
            if not out:
                continue
            ret.append(f"%{ord(out):02X}" if out in keep else out)
            continue
        if decoder.buffer:
            start = idx - 1 - len(decoder.buffer) * 3
            ret.append(val[start:idx - 1])
            decoder.reset()
        ret.append(" " if plus and ch == "+" else ch)
    if decoder.buffer:
        ret.append(val[-len(decoder.buffer) * 3:])
    return "".join(ret)


def _parse_query(raw: str) -> MultiDict:
    """Split on ``&`` only and keep blank values (``?uploads`` gives
    ``uploads`` = ``""``), as yarl's ``URL.query`` does."""
    out = MultiDict()
    if raw:
        for kv in raw.split("&"):
            k, _, v = kv.partition("=")
            out.add(_unquote(k, plus=True), _unquote(v, plus=True))
    return out


def _unquote_path_safe(value: str) -> str:
    if "%" not in value:
        return value
    return value.replace("%2F", "/").replace("%25", "%")


class URL:
    """The request target's decoded and raw parts (the yarl attributes the
    handlers read)."""

    def __init__(self, raw_path: str, raw_query: str):
        self.raw_path = raw_path
        self.raw_query_string = raw_query
        self.path = _unquote(raw_path)
        self.path_safe = _unquote(raw_path, keep="/%")
        self._query: MultiDict | None = None

    @property
    def query(self) -> MultiDict:
        if self._query is None:
            self._query = _parse_query(self.raw_query_string)
        return self._query



# -- errors --------------------------------------------------------------------


class HTTPException(Exception):
    """Raised out of a handler (or by ``Request.read``), it is sent as the
    response: its status and a text body."""

    status_code = 500

    def __init__(self, text: str):
        self.text = text
        super().__init__(text)

    def response(self) -> "Response":
        return Response(status=self.status_code, text=self.text)


class HTTPBadRequest(HTTPException):
    status_code = 400


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413

    def __init__(self, max_size: int, actual_size: int):
        super().__init__(f"Maximum request body size {max_size} exceeded, "
                         f"actual body size {actual_size}")


class _BadRequest(Exception):
    pass


def _framing(headers: CIMultiDict) -> tuple[bool, int | None]:
    """(chunked, Content-Length) of a request body. Anything that two
    parsers could read as two different bodies is refused, as aiohttp
    refuses it (request smuggling)."""
    te = [v for k, v in headers.items() if k.lower() == "transfer-encoding"]
    cl = [v for k, v in headers.items() if k.lower() == "content-length"]
    if len(cl) > 1:
        raise _BadRequest("duplicate Content-Length")
    if te:
        if cl:
            raise _BadRequest("Content-Length can't be present with Transfer-Encoding")
        codings = [c.strip(" \t").lower() for c in ",".join(te).split(",")]
        if codings[-1] != "chunked" or "chunked" in codings[:-1]:
            raise _BadRequest("invalid Transfer-Encoding")
        return True, None
    if cl:
        value = cl[0].strip(" \t")
        if not _LENGTH.fullmatch(value):
            raise _BadRequest("invalid Content-Length")
        return False, int(value)
    return False, None


# -- request bodies ------------------------------------------------------------


class _Body:
    """A request body over the connection's reader: ``read(n)`` returns up
    to n bytes (what is buffered, at least one byte) and b"" at its end.
    Content-Length bodies stop at their length; chunked ones decode the
    framing (a size line longer than the reader's limit, or trailers past
    ``MAX_HEAD``, are refused) and discard trailers."""

    def __init__(self, reader: asyncio.StreamReader, length: int | None,
                 chunked: bool):
        self._r = reader
        self._left = length or 0
        self._chunked = chunked
        self._chunk_left = 0
        self._eof = not chunked and not length
        self.exists = not self._eof

    def at_eof(self) -> bool:
        return self._eof

    async def _line(self) -> bytes:
        try:
            line = await self._r.readline()
        except ValueError:  # longer than the reader's limit
            raise _BadRequest("chunk line too long") from None
        if not line.endswith(b"\n"):
            raise ConnectionResetError("chunked body ended early")
        return line

    async def read(self, n: int = -1) -> bytes:
        if self._eof:
            return b""
        if n is None or n < 0:
            parts = []
            while True:
                b = await self.read(1 << 20)
                if not b:
                    return b"".join(parts)
                parts.append(b)
        if n == 0:
            return b""
        if not self._chunked:
            data = await self._r.read(min(n, self._left))
            if not data:
                raise ConnectionResetError("request body ended early")
            self._left -= len(data)
            if self._left == 0:
                self._eof = True
            return data
        if self._chunk_left == 0:
            m = _CHUNK.fullmatch(await self._line())
            if m is None:
                raise _BadRequest("invalid chunk size")
            size = int(m.group(1), 16)
            if size == 0:
                got = 0
                while (t := await self._line()) not in (b"\r\n", b"\n"):
                    got += len(t)  # trailers, then the blank line
                    if got > MAX_HEAD:
                        raise _BadRequest("trailers too large")
                self._eof = True
                return b""
            self._chunk_left = size
        data = await self._r.read(min(n, self._chunk_left))
        if not data:
            raise ConnectionResetError("chunked body ended early")
        self._chunk_left -= len(data)
        if self._chunk_left == 0:
            if await self._r.readexactly(2) != b"\r\n":
                raise _BadRequest("chunk not followed by CRLF")
        return data

    async def drain(self, limit: int) -> bool:
        """Read and drop what is left, up to ``limit`` bytes; True when the
        body ended (the connection can serve another request)."""
        got = 0
        while not self._eof:
            b = await self.read(1 << 16)
            got += len(b)
            if got > limit:
                return False
        return True


# -- request -------------------------------------------------------------------


class _State(MutableMapping):
    """Item storage on requests, responses and the application, as
    aiohttp's objects offer it (``request["_tx"]``, ``app["bootstrap"]``)."""

    _state: dict

    def __getitem__(self, k):
        return self._state[k]

    def __setitem__(self, k, v) -> None:
        self._state[k] = v

    def __delitem__(self, k) -> None:
        del self._state[k]

    def __iter__(self):
        return iter(self._state)

    def __len__(self) -> int:
        return len(self._state)

    # identity, not contents, as aiohttp's objects compare (they go into sets)
    def __eq__(self, other) -> bool:
        return self is other

    __hash__ = object.__hash__


class Request(_State):
    def __init__(self, app, method: str, target: str, version: tuple[int, int],
                 headers: CIMultiDict, body: _Body, writer: asyncio.StreamWriter):
        self.app = app
        self.method = method
        self.version = version
        self.raw_path = target
        path, _, _fragment = target.partition("#")
        raw_path, _, raw_query = path.partition("?")
        self.rel_url = URL(raw_path, raw_query)
        self.headers = headers
        self.content = body
        self._reader = body._r
        self._writer = writer
        self.match_info: dict[str, str] = {}
        self._state: dict = {}
        self._read_bytes: bytes | None = None
        conn = headers.get("Connection", "").lower()
        if version >= (1, 1):
            self.keep_alive = "close" not in conn
        else:
            self.keep_alive = "keep-alive" in conn

    @property
    def path(self) -> str:
        return self.rel_url.path

    @property
    def transport(self):
        return self._writer.transport

    @property
    def remote(self) -> str | None:
        peer = self._writer.get_extra_info("peername")
        if isinstance(peer, (list, tuple)) and peer:
            return str(peer[0])
        return None

    @property
    def body_exists(self) -> bool:
        return self.content.exists

    async def read(self) -> bytes:
        if self._read_bytes is None:
            max_size = self.app.client_max_size
            parts, size = [], 0
            while True:
                b = await self.content.read(1 << 20)
                if not b:
                    break
                size += len(b)
                if max_size and size >= max_size:
                    raise HTTPRequestEntityTooLarge(max_size, size)
                parts.append(b)
            self._read_bytes = b"".join(parts)
        return self._read_bytes

    def __repr__(self) -> str:
        return f"<Request {self.method} {self.raw_path}>"


# -- responses -----------------------------------------------------------------

_EMPTY_STATUS = {204, 304}


def _must_be_empty(method: str, status: int) -> bool:
    return status in _EMPTY_STATUS or 100 <= status < 200 or method == "HEAD"


class StreamResponse(_State):
    """Headers go out at ``prepare``; then ``write`` and ``write_eof``.
    With no Content-Length the body is sent chunked (HTTP/1.1)."""

    def __init__(self, *, status: int = 200, headers=None):
        self._headers = CIMultiDict(headers or ())
        self.set_status(status)
        self._writer: asyncio.StreamWriter | None = None
        self._chunked_out = False
        self._empty = False
        self._eof_sent = False
        self._keep_alive: bool | None = None
        self._state: dict = {}

    @property
    def headers(self) -> CIMultiDict:
        return self._headers

    @property
    def status(self) -> int:
        return self._status

    def set_status(self, status: int) -> None:
        self._status = int(status)
        try:
            self._reason = http.HTTPStatus(self._status).phrase
        except ValueError:
            self._reason = ""

    @property
    def prepared(self) -> bool:
        return self._writer is not None

    @property
    def keep_alive(self) -> bool | None:
        return self._keep_alive

    def force_close(self) -> None:
        self._keep_alive = False

    @property
    def content_length(self) -> int | None:
        v = self._headers.get("Content-Length")
        return int(v) if v is not None else None

    @content_length.setter
    def content_length(self, value: int | None) -> None:
        if value is None:
            self._headers.pop("Content-Length", None)
        else:
            self._headers["Content-Length"] = str(int(value))

    def _prepare_headers(self, request: Request) -> None:
        keep_alive = self._keep_alive
        if keep_alive is None:
            keep_alive = request.keep_alive
        self._empty = _must_be_empty(request.method, self._status)
        h = self._headers
        length = self.content_length
        if length is None:
            if request.version >= (1, 1):
                if not self._empty:
                    self._chunked_out = True
                    h["Transfer-Encoding"] = "chunked"
            elif not self._empty:
                keep_alive = False
        if self._empty:
            if "Content-Length" in h and (
                self._status in _EMPTY_STATUS or 100 <= self._status < 200
            ):
                del h["Content-Length"]
            if "Transfer-Encoding" in h:
                del h["Transfer-Encoding"]
        elif length != 0:
            h.setdefault("Content-Type", "application/octet-stream")
        h.setdefault("Date", formatdate(usegmt=True))
        h.setdefault("Server", SERVER_SOFTWARE)
        if "Connection" not in h:
            if keep_alive:
                if request.version == (1, 0):
                    h["Connection"] = "keep-alive"
            elif request.version == (1, 1):
                h["Connection"] = "close"
        self._keep_alive = keep_alive

    async def prepare(self, request: Request):
        if self._writer is not None:
            return self._writer
        self._prepare_headers(request)
        for hook in request.app.on_response_prepare:
            await hook(request, self)
        ver = f"HTTP/{request.version[0]}.{request.version[1]}"
        lines = [f"{ver} {self._status} {self._reason}\r\n"]
        for k, v in self._headers.items():
            k, v = str(k), str(v)
            if "\r" in k or "\n" in k or "\r" in v or "\n" in v:
                # as aiohttp refuses it: the value would split the response
                raise ValueError(f"newline or carriage return in header {k!r}")
            lines.append(f"{k}: {v}\r\n")
        lines.append("\r\n")
        self._writer = request._writer
        self._writer.write("".join(lines).encode("utf-8", "surrogateescape"))
        return self._writer

    async def write(self, data) -> None:
        if self._writer is None:
            raise RuntimeError("Cannot call write() before prepare()")
        if self._eof_sent:
            raise RuntimeError("Cannot call write() after write_eof()")
        if self._empty or not data:
            return
        if self._chunked_out:
            self._writer.write(f"{len(data):x}\r\n".encode())
            self._writer.write(data)
            self._writer.write(b"\r\n")
        else:
            self._writer.write(data)
        await self._writer.drain()

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof_sent:
            return
        if self._writer is None:
            raise RuntimeError("Cannot call write_eof() before prepare()")
        if data:
            await self.write(data)
        if self._chunked_out and not self._empty:
            self._writer.write(b"0\r\n\r\n")
        self._eof_sent = True
        await self._writer.drain()

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self._status} {self._reason}>"


class Response(StreamResponse):
    """A whole body known up front: Content-Length is set from it."""

    def __init__(self, *, body=None, status: int = 200, text: str | None = None,
                 headers=None, content_type: str | None = None):
        if body is not None and text is not None:
            raise ValueError("body and text are not allowed together")
        real = CIMultiDict(headers or ())
        if text is not None:
            # aiohttp's: a text body is typed text/plain and says its charset
            real.setdefault("Content-Type", f"{content_type or 'text/plain'}; charset=utf-8")
            body = text.encode()
        elif content_type is not None:
            real["Content-Type"] = content_type
        super().__init__(status=status, headers=real)
        self.body = body

    @property
    def body(self):
        return self._body

    @body.setter
    def body(self, value) -> None:
        if value is not None and not isinstance(value, (bytes, bytearray, memoryview)):
            raise TypeError(f"body must be bytes, not {type(value).__name__}")
        self._body = bytes(value) if value is not None else None

    async def prepare(self, request: Request):
        if self._writer is not None:
            return self._writer
        h = self._headers
        if "Content-Length" in h:
            if self._status in _EMPTY_STATUS or 100 <= self._status < 200:
                del h["Content-Length"]
        else:
            n = len(self._body) if self._body else 0
            if n != 0 or (self._status != 304 and request.method != "HEAD"):
                h["Content-Length"] = str(n)
        return await super().prepare(request)

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof_sent:
            return
        if self._body and not self._empty:
            self._writer.write(self._body)
        self._eof_sent = True
        await self._writer.drain()


# -- websockets (RFC 6455, server side) -----------------------------------------

WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class WSMsgType(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    PING = 0x9
    PONG = 0xA
    CLOSE = 0x8
    CLOSING = 0x100  # the receive side after a close began (aiohttp's)
    CLOSED = 0x101
    ERROR = 0x102


class WSMessage(NamedTuple):
    type: WSMsgType
    data: object
    extra: str | None


# close codes a peer may send below 3000 (aiohttp's WSCloseCode)
_CLOSE_CODES = frozenset({1000, 1001, 1002, 1003, 1006, 1007, 1008, 1009, 1010,
                          1011, 1012, 1013, 1014})
WS_PROTOCOL_ERROR = 1002
WS_INVALID_TEXT = 1007
WS_MESSAGE_TOO_BIG = 1009


class _WSError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _ws_mask(data: bytes, mask: bytes) -> bytes:
    n = len(data)
    if n == 0:
        return b""
    key = int.from_bytes((mask * ((n + 3) // 4))[:n], "little")
    return (int.from_bytes(data, "little") ^ key).to_bytes(n, "little")


def _ws_header(opcode: int, n: int) -> bytes:
    if n < 126:
        return struct.pack("!BB", 0x80 | opcode, n)
    if n < 65536:
        return struct.pack("!BBH", 0x80 | opcode, 126, n)
    return struct.pack("!BBQ", 0x80 | opcode, 127, n)


class WebSocketResponse(StreamResponse):
    """The server end of a websocket, as aiohttp's behaves without
    extensions: ``prepare`` answers the upgrade (400 on a bad handshake)
    and hands the connection over, ``receive`` (or ``async for``) yields
    TEXT and BINARY messages, answers pings, replies to a close and stops.
    A protocol error (reserved bits, a fragmented or long control frame, a
    stray continuation, a bad close code) closes with 1002, bad UTF-8 text
    with 1007, a message of ``max_msg_size`` bytes or more with 1009; each
    yields one ERROR message first. With ``heartbeat`` a ping goes out
    after that many idle seconds, and no frame within half of it closes
    the connection. Client frames may be masked or not, as aiohttp
    accepts both. No extension is negotiated (no compression)."""

    def __init__(self, *, timeout: float = 10.0, heartbeat: float | None = None,
                 max_msg_size: int = 4 * 1024 * 1024):
        super().__init__(status=101)
        self._timeout = timeout
        self._heartbeat = heartbeat
        self._max_msg_size = max_msg_size
        self._reader: asyncio.StreamReader | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._closed = False
        self._closing = False
        self._waiting = False
        self._exception: BaseException | None = None  # why the heartbeat closed
        self._partial = bytearray()
        self._partial_op: int | None = None
        self._hb: asyncio.TimerHandle | None = None
        self._pong_wait: asyncio.TimerHandle | None = None

    def _handshake(self, request: Request) -> None:
        h = request.headers
        if h.get("Upgrade", "").lower().strip() != "websocket":
            raise HTTPBadRequest(
                f"No WebSocket UPGRADE hdr: {h.get('Upgrade')}\n"
                ' Can "Upgrade" only to "WebSocket".')
        if "upgrade" not in h.get("Connection", "").lower():
            raise HTTPBadRequest(f"No CONNECTION upgrade hdr: {h.get('Connection')}")
        version = h.get("Sec-WebSocket-Version", "")
        if version not in ("13", "8", "7"):
            raise HTTPBadRequest(f"Unsupported version: {version}")
        key = h.get("Sec-WebSocket-Key")
        try:
            if not key or len(base64.b64decode(key)) != 16:
                raise HTTPBadRequest(f"Handshake error: {key!r}")
        except binascii.Error:
            raise HTTPBadRequest(f"Handshake error: {key!r}") from None
        accept = base64.b64encode(hashlib.sha1(key.encode() + WS_GUID).digest()).decode()
        self._headers["Upgrade"] = "websocket"
        self._headers["Connection"] = "upgrade"
        self._headers["Sec-WebSocket-Accept"] = accept

    async def prepare(self, request: Request):
        if self._writer is not None:
            return self._writer
        self._handshake(request)
        self.force_close()  # the connection serves no more HTTP
        writer = await super().prepare(request)
        await writer.drain()
        self._reader = request._reader
        self._loop = asyncio.get_running_loop()
        self._reset_heartbeat()
        return writer

    # -- sending --

    async def _send(self, opcode: int, payload) -> None:
        if self._writer is None:
            raise RuntimeError("Call .prepare() first")
        if self._closed and opcode != WSMsgType.CLOSE:
            raise ConnectionResetError("Cannot write to closing transport")
        payload = bytes(payload)
        # one synchronous pair of writes: frames of concurrent senders
        # never interleave
        self._writer.write(_ws_header(opcode, len(payload)))
        self._writer.write(payload)
        await self._writer.drain()

    async def send_bytes(self, data) -> None:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError(f"data argument must be byte-ish ({type(data)!r})")
        await self._send(WSMsgType.BINARY, data)

    async def send_str(self, data: str) -> None:
        if not isinstance(data, str):
            raise TypeError(f"data argument must be str ({type(data)!r})")
        await self._send(WSMsgType.TEXT, data.encode("utf-8"))

    async def pong(self, message: bytes = b"") -> None:
        await self._send(WSMsgType.PONG, message)

    async def write(self, data) -> None:
        raise RuntimeError("Cannot call .write() for websocket")

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof_sent:
            return
        if self._writer is None:
            raise RuntimeError("Response has not been started")
        await self.close()
        self._eof_sent = True

    # -- heartbeat --

    def _cancel_heartbeat(self) -> None:
        for h in (self._hb, self._pong_wait):
            if h is not None:
                h.cancel()
        self._hb = self._pong_wait = None

    def _reset_heartbeat(self) -> None:
        if self._heartbeat is None or self._closed:
            return
        self._cancel_heartbeat()
        self._hb = self._loop.call_later(self._heartbeat, self._send_heartbeat)

    def _send_heartbeat(self) -> None:
        self._hb = None
        if self._closed:
            return
        self._pong_wait = self._loop.call_later(self._heartbeat / 2.0, self._pong_not_received)
        try:
            self._writer.write(_ws_header(WSMsgType.PING, 0))
        except (ConnectionError, RuntimeError):
            pass  # the pong deadline closes the connection

    def _pong_not_received(self) -> None:
        self._pong_wait = None
        if self._closed:
            return
        self._exception = asyncio.TimeoutError(
            f"No PONG received after {self._heartbeat / 2.0} seconds")
        self._closed = True
        self._cancel_heartbeat()
        self._writer.transport.close()  # a waiting receive wakes with ERROR

    # -- receiving --

    async def _frame(self) -> tuple[bool, int, bytes]:
        r = self._reader
        b0, b1 = await r.readexactly(2)
        fin, opcode = bool(b0 & 0x80), b0 & 0x0F
        if b0 & 0x70:
            raise _WSError(WS_PROTOCOL_ERROR, "Received frame with non-zero reserved bits")
        if opcode > 0x7 and not fin:
            raise _WSError(WS_PROTOCOL_ERROR, "Received fragmented control frame")
        n = b1 & 0x7F
        if opcode > 0x7 and n > 125:
            raise _WSError(WS_PROTOCOL_ERROR,
                           "Control frame payload cannot be larger than 125 bytes")
        if n == 126:
            (n,) = struct.unpack("!H", await r.readexactly(2))
        elif n == 127:
            (n,) = struct.unpack("!Q", await r.readexactly(8))
        mask = await r.readexactly(4) if b1 & 0x80 else b""
        if (self._max_msg_size and opcode <= WSMsgType.BINARY
                and len(self._partial) + n >= self._max_msg_size):
            # refused once the frame is read, as aiohttp refuses it (so the
            # close reaches the peer before FIN, not behind an RST), but its
            # payload is dropped as it arrives instead of buffered
            left = n
            while left:
                left -= len(await r.readexactly(min(left, 1 << 16)))
            raise _WSError(WS_MESSAGE_TOO_BIG,
                           f"Message size {len(self._partial) + n} exceeds limit "
                           f"{self._max_msg_size}")
        payload = await r.readexactly(n) if n else b""
        return fin, opcode, _ws_mask(payload, mask) if mask else payload

    async def _message(self) -> WSMessage:
        while True:
            fin, op, payload = await self._frame()
            if op in (WSMsgType.CONTINUATION, WSMsgType.TEXT, WSMsgType.BINARY):
                if op == WSMsgType.CONTINUATION and self._partial_op is None:
                    raise _WSError(WS_PROTOCOL_ERROR,
                                   "Continuation frame for non started message")
                if not fin:
                    if op != WSMsgType.CONTINUATION:
                        self._partial_op = op
                    self._partial += payload
                    continue
                if op == WSMsgType.CONTINUATION:
                    op, self._partial_op = self._partial_op, None
                elif self._partial:
                    raise _WSError(WS_PROTOCOL_ERROR,
                                   "The opcode in non-fin frame is expected to be "
                                   f"zero, got {op!r}")
                data = bytes(self._partial) + payload if self._partial else payload
                self._partial.clear()
                if op == WSMsgType.TEXT:
                    try:
                        return WSMessage(WSMsgType.TEXT, data.decode("utf-8"), "")
                    except UnicodeDecodeError:
                        raise _WSError(WS_INVALID_TEXT, "Invalid UTF-8 text message") from None
                return WSMessage(WSMsgType.BINARY, data, "")
            if op == WSMsgType.CLOSE:
                if len(payload) >= 2:
                    (code,) = struct.unpack("!H", payload[:2])
                    if code < 3000 and code not in _CLOSE_CODES:
                        raise _WSError(WS_PROTOCOL_ERROR, f"Invalid close code: {code}")
                    try:
                        return WSMessage(WSMsgType.CLOSE, code, payload[2:].decode("utf-8"))
                    except UnicodeDecodeError:
                        raise _WSError(WS_INVALID_TEXT, "Invalid UTF-8 text message") from None
                if payload:
                    raise _WSError(WS_PROTOCOL_ERROR, f"Invalid close frame: {payload!r}")
                return WSMessage(WSMsgType.CLOSE, 0, "")
            if op == WSMsgType.PING:
                return WSMessage(WSMsgType.PING, payload, "")
            if op == WSMsgType.PONG:
                return WSMessage(WSMsgType.PONG, payload, "")
            raise _WSError(WS_PROTOCOL_ERROR, f"Unexpected opcode={op!r}")

    async def receive(self) -> WSMessage:
        if self._reader is None:
            raise RuntimeError("Call .prepare() first")
        while True:
            if self._waiting:
                raise RuntimeError("Concurrent call to receive() is not allowed")
            if self._closed:
                return WSMessage(WSMsgType.CLOSED, None, None)
            if self._closing:
                return WSMessage(WSMsgType.CLOSING, None, None)
            self._waiting = True
            try:
                msg = await self._message()
            except _WSError as e:
                self._closing = True  # the stream is mid-frame: no more reads
                await self.close(code=e.code)
                return WSMessage(WSMsgType.ERROR, e, None)
            except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
                if self._exception is not None:  # the heartbeat gave up
                    return WSMessage(WSMsgType.ERROR, self._exception, None)
                if self._closed:  # close() from another task
                    return WSMessage(WSMsgType.CLOSING, None, None)
                self._closing = True
                await self.close()
                return WSMessage(WSMsgType.CLOSED, None, None)
            finally:
                self._waiting = False
            self._reset_heartbeat()
            if msg.type == WSMsgType.CLOSE:
                self._closing = True
                await self.close(drain=False)
                return msg
            if msg.type == WSMsgType.PING:
                await self.pong(msg.data)
                continue
            if msg.type == WSMsgType.PONG:
                continue
            return msg

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.CLOSED):
            raise StopAsyncIteration
        return msg

    async def close(self, *, code: int = 1000, message: bytes = b"",
                    drain: bool = True) -> bool:
        """Send a close frame. When this side starts the close and no
        receive is waiting, wait up to ``timeout`` for the peer's close
        frame, as aiohttp does; then close the connection."""
        if self._writer is None:
            raise RuntimeError("Call .prepare() first")
        if self._closed:
            return False
        self._closed = True
        self._cancel_heartbeat()
        try:
            self._writer.write(_ws_header(WSMsgType.CLOSE, 2 + len(message)))
            self._writer.write(struct.pack("!H", code) + message)
            if drain:
                await self._writer.drain()
        except (ConnectionError, RuntimeError):
            self._writer.transport.close()
            return True
        if not (self._closing or self._waiting):
            try:
                async with asyncio.timeout(self._timeout):
                    while (await self._message()).type != WSMsgType.CLOSE:
                        pass
            except asyncio.CancelledError:
                self._writer.transport.close()
                raise
            except Exception:  # noqa: BLE001 — the peer went away instead
                pass
        self._writer.transport.close()
        return True


def json_response(data, *, status: int = 200, headers=None) -> Response:
    return Response(text=json.dumps(data), status=status, headers=headers,
                    content_type="application/json")


# -- application and routing ---------------------------------------------------

_PARAM = re.compile(r"\{(?P<name>[A-Za-z_][A-Za-z0-9_]*)(?::(?P<re>[^{}]*))?\}")


def _route_regex(path: str) -> re.Pattern:
    out, pos = [], 0
    for m in _PARAM.finditer(path):
        out.append(re.escape(path[pos:m.start()]))
        out.append(f"(?P<{m.group('name')}>{m.group('re') or '[^{}/]+'})")
        pos = m.end()
    out.append(re.escape(path[pos:]))
    return re.compile("".join(out))


class _Router:
    """Routes indexed as aiohttp indexes them: by the static part of their
    path. A request walks its path from the whole down to ``/`` and takes
    the first route that matches at the longest prefix, in registration
    order within one prefix; so ``/minio/grid/v1`` wins over a catch-all
    ``/{bucket}/{key:.*}`` registered before it."""

    def __init__(self):
        self._index: dict[str, list[tuple[str, re.Pattern, object]]] = {}

    @staticmethod
    def _key(path: str) -> str:
        if "{" in path:
            path = path.partition("{")[0].rpartition("/")[0]
        return path.rstrip("/") or "/"

    def add_route(self, method: str, path: str, handler) -> None:
        self._index.setdefault(self._key(path), []).append(
            (method.upper(), _route_regex(path), handler))

    def resolve(self, method: str, path_safe: str):
        """(handler, match_info), or (None, status) when no route fits."""
        allowed = False
        part = path_safe
        while part:
            for m, rx, handler in self._index.get(part, ()):
                mt = rx.fullmatch(path_safe)
                if mt is None:
                    continue
                if m in ("*", method):
                    return handler, {k: _unquote_path_safe(v)
                                     for k, v in mt.groupdict().items()}
                allowed = True
            if part == "/":
                break
            part = part.rpartition("/")[0] or "/"
        return None, 405 if allowed else 404


class Application(_State):
    def __init__(self, *, client_max_size: int = 1024 ** 2):
        self.client_max_size = client_max_size
        self.router = _Router()
        self.on_response_prepare: list = []
        self.on_startup: list = []
        self.on_shutdown: list = []
        self.on_cleanup: list = []
        self._state: dict = {}

    def __bool__(self) -> bool:
        return True


# -- serving -------------------------------------------------------------------


class _Conn:
    """One client connection: requests in turn (keep-alive)."""

    def __init__(self, runner: "AppRunner", reader, writer):
        self.runner = runner
        self.reader = reader
        self.writer = writer
        self.busy = False

    async def _read_head(self, first: bool):
        try:
            head = await asyncio.wait_for(
                self.reader.readuntil(b"\r\n\r\n"),
                None if first else KEEPALIVE_S,
            )
        except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                ConnectionError):
            return None
        except asyncio.LimitOverrunError:
            raise _BadRequest("request head too large") from None
        if len(head) > MAX_HEAD:
            raise _BadRequest("request head too large")
        return head

    @staticmethod
    def _parse_head(head: bytes):
        text = head.decode("utf-8", "surrogateescape")
        lines = text.split("\r\n")
        while lines and lines[0] == "":  # tolerate stray CRLFs between requests
            lines.pop(0)
        if not lines:
            raise _BadRequest("empty request")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/"):
            raise _BadRequest(f"bad request line {lines[0]!r}")
        method, target, ver = parts
        try:
            major, minor = (int(x) for x in ver[5:].split("."))
        except ValueError:
            raise _BadRequest(f"bad version {ver!r}") from None
        if target.startswith(("http://", "https://")):
            rest = target.split("://", 1)[1]
            target = "/" + rest.split("/", 1)[1] if "/" in rest else "/"
        headers = CIMultiDict()
        for ln in lines[1:]:
            if not ln:
                continue
            name, sep, value = ln.partition(":")
            if not sep or not _TOKEN.fullmatch(name) or _CTL.search(value):
                raise _BadRequest(f"bad header line {ln!r}")
            headers.add(name, value.lstrip(" \t"))  # as aiohttp keeps it
        return method, target, (major, minor), headers

    async def _error(self, status: int, text: str) -> None:
        body = text.encode()
        self.writer.write(
            f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}\r\n"
            f"Content-Type: text/plain; charset=utf-8\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
            + body
        )
        await self.writer.drain()

    async def serve(self) -> None:
        first = True
        try:
            while not self.runner._closing:
                try:
                    head = await self._read_head(first)
                    if head is None:
                        return
                    method, target, version, headers = self._parse_head(head)
                except _BadRequest as e:
                    await self._error(400, f"400, message:\n  {e}")
                    return
                first = False
                self.busy = True
                try:
                    keep = await self._one(method, target, version, headers)
                finally:
                    self.busy = False
                if not keep:
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self.runner._conns.discard(self)
            try:
                self.writer.close()
            except Exception:  # noqa: BLE001 — the socket may be gone already
                pass

    async def _one(self, method, target, version, headers) -> bool:
        app = self.runner.app
        try:
            chunked, length = _framing(headers)
        except _BadRequest as e:
            await self._error(400, f"400, message:\n  {e}")
            return False
        body = _Body(self.reader, length, chunked)
        request = Request(app, method, target, version, headers, body, self.writer)
        handler, match = app.router.resolve(method, request.rel_url.path_safe)
        resp: StreamResponse | None = None
        try:
            if handler is None:
                resp = Response(status=match, text=f"{match}: {http.HTTPStatus(match).phrase}")
            else:
                request.match_info = match
                if version >= (1, 1) and headers.get("Expect", "").lower() == "100-continue":
                    # the client waits for this before it sends the body:
                    # answered at once, as aiohttp's expect handler does
                    self.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                resp = await handler(request)
        except HTTPException as e:
            resp = e.response()
        except asyncio.CancelledError:
            raise
        except (ConnectionError, _BadRequest) as e:
            if isinstance(e, _BadRequest) and (resp is None or not resp.prepared):
                await self._error(400, f"400, message:\n  {e}")
            return False
        except Exception:  # noqa: BLE001 — a handler bug answers 500
            traceback.print_exc()
            if resp is not None and resp.prepared:
                return False
            resp = _server_error()
        if resp is None:
            resp = Response(status=500, text="500 Internal Server Error")
        if not resp.prepared:
            try:
                await resp.prepare(request)
            except ValueError:  # a header that would split the response
                traceback.print_exc()
                resp = _server_error()
                await resp.prepare(request)
        await resp.write_eof()
        keep = bool(resp.keep_alive) and request.keep_alive
        if keep and not body.at_eof():
            try:
                keep = await body.drain(DRAIN_LIMIT)
            except (ConnectionError, _BadRequest, asyncio.IncompleteReadError):
                keep = False
        return keep


def _server_error() -> Response:
    resp = Response(status=500, text="500 Internal Server Error\n\nServer got itself in trouble")
    resp.force_close()
    return resp


class AppRunner:
    def __init__(self, app: Application, *, read_bufsize: int = 2 ** 16,
                 shutdown_timeout: float = SHUTDOWN_S):
        self.app = app
        self.read_bufsize = int(read_bufsize)
        self.shutdown_timeout = shutdown_timeout
        self._sites: list[TCPSite] = []
        self._conns: set[_Conn] = set()
        self._tasks: set[asyncio.Task] = set()
        self._closing = False

    async def setup(self) -> None:
        for hook in self.app.on_startup:
            await hook(self.app)

    async def _client(self, reader, writer) -> None:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        conn = _Conn(self, reader, writer)
        self._conns.add(conn)
        task = asyncio.current_task()
        if task is not None:
            self._tasks.add(task)
        try:
            await conn.serve()
        finally:
            if task is not None:
                self._tasks.discard(task)

    async def cleanup(self) -> None:
        """Close the listeners, run on_shutdown (which closes long-lived
        connections such as websockets), close idle connections, give
        requests in flight ``shutdown_timeout`` to finish, then run
        on_cleanup."""
        self._closing = True
        for s in list(self._sites):
            await s.stop()
        for hook in self.app.on_shutdown:
            await hook(self.app)
        for c in list(self._conns):
            if not c.busy:
                c.writer.close()
        pending = [t for t in self._tasks if not t.done()]
        if pending:
            _, late = await asyncio.wait(pending, timeout=self.shutdown_timeout)
            for t in late:
                t.cancel()
        for hook in self.app.on_cleanup:
            await hook(self.app)


class TCPSite:
    def __init__(self, runner: AppRunner, host: str | None = None, port: int = 8080,
                 *, ssl_context=None, reuse_port: bool | None = None):
        self._runner = runner
        self._host = host or "0.0.0.0"
        self._port = port
        self._ssl = ssl_context
        self._reuse_port = reuse_port
        self._server: asyncio.base_events.Server | None = None

    async def start(self) -> None:
        self._runner._sites.append(self)
        self._server = await asyncio.start_server(
            self._runner._client, self._host, self._port,
            limit=max(self._runner.read_bufsize, MAX_HEAD), ssl=self._ssl,
            reuse_port=self._reuse_port, backlog=128,
        )

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
        if self in self._runner._sites:
            self._runner._sites.remove(self)


def serve_in_thread(app: Application, host: str = "127.0.0.1", port: int = 0, *,
                    read_bufsize: int = 2 ** 16) -> tuple[int, object]:
    """Serve ``app`` on ``host``:``port`` (0: a free port) through an
    ``AppRunner`` / ``TCPSite`` pair on an event loop thread of its own.
    Returns (the port, ``stop``); ``stop()`` runs the runner's cleanup and
    joins the thread."""
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    out: dict = {}

    def run():
        asyncio.set_event_loop(loop)
        runner = AppRunner(app, read_bufsize=read_bufsize)
        try:
            loop.run_until_complete(runner.setup())
            site = TCPSite(runner, host, port)
            loop.run_until_complete(site.start())
            out["port"] = site._server.sockets[0].getsockname()[1]
        except BaseException as e:  # noqa: BLE001 — raised in the caller
            out["error"] = e
            ready.set()
            loop.close()
            return
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    th = threading.Thread(target=run, name=f"web-{host}:{port}", daemon=True)
    th.start()
    if not ready.wait(60):
        raise RuntimeError(f"the server on {host}:{port} did not start listening")
    if "error" in out:
        raise out["error"]

    def stop() -> None:
        loop.call_soon_threadsafe(loop.stop)
        th.join(SHUTDOWN_S + 30)

    return out["port"], stop
