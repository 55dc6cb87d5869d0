"""The port's HTTP front (minio_tpu_torch/server/web.py) against aiohttp.

The same raw bytes go over a socket to one echo application served twice:
once by aiohttp, once by the port's stdlib front. What the handler sees
(method, path, raw path, match_info, the query multi-dict, the raw query
string, headers, body) and what the client gets back (status, headers but
Date and Server, body, framing) must agree. The inputs are the places a
hand-written front goes wrong: percent-decoding of keys (%2F, %20, +,
UTF-8, broken escapes), blank query values (?uploads), repeated headers,
chunked bodies, Expect: 100-continue, keep-alive, HEAD, 204, streamed and
JSON responses, 413 and an exception in the handler; and framing the
front must refuse as aiohttp does (chunk sizes and Content-Lengths that
are not plain digits, Transfer-Encoding with Content-Length, header names
and values a parser could split), and response headers with CR or LF.
"""

from __future__ import annotations

import asyncio
import base64
import json
import socket
import threading

import pytest
from aiohttp import web as aioweb

from minio_tpu_torch.server import web as portweb

MAX_SIZE = 4096


def _echo_app(web):
    async def echo(request):
        mode = request.rel_url.query.get("resp", "echo")
        if mode == "raise":
            raise RuntimeError("handler bug")
        if mode == "stream":
            resp = web.StreamResponse(status=200, headers={"X-Amz-Meta-S": "1"})
            await resp.prepare(request)
            for i in range(3):
                await resp.write(b"part%d;" % i)
            await resp.write_eof()
            return resp
        if mode == "streamlen":
            resp = web.StreamResponse(status=206, headers={"Content-Range": "bytes 0-9/20"})
            resp.content_length = 10
            await resp.prepare(request)
            await resp.write(b"0123456789")
            await resp.write_eof()
            return resp
        if mode == "empty":
            return web.Response(status=200)
        if mode == "nocontent":
            return web.Response(status=204)
        if mode == "xml":
            return web.Response(body=b"<a>1</a>", content_type="application/xml")
        if mode == "text":
            return web.Response(text="plain words")
        if mode == "json":
            return web.json_response({"k": [1, 2]})
        if mode == "etag":
            return web.Response(body=b"1234567", headers={
                "ETag": '"abc"', "Content-Length": "7", "x-amz-meta-color": "teal"})
        if mode == "crlf":  # a stored x-amz-meta-* value that would split the response
            return web.Response(body=b"x", headers={"X-Amz-Meta-A": "v\r\nSet-Cookie: s=1"})
        if mode == "crlfname":
            return web.Response(body=b"x", headers={"X-Amz-Meta-A\nX": "v"})
        if mode == "crlfstream":
            resp = web.StreamResponse(headers={"X-Amz-Meta-A": "v\nSet-Cookie: s=1"})
            await resp.prepare(request)
            await resp.write_eof(b"x")
            return resp
        if mode == "chunks":
            parts = []
            while True:
                b = await request.content.read(5)
                if not b:
                    break
                parts.append(b)
            body = b"".join(parts)
        else:
            body = await request.read() if request.body_exists else b""
        request["seen"] = len(body)
        out = {
            "method": request.method,
            "path": request.path,
            "raw_path": request.raw_path,
            "rel_raw_path": request.rel_url.raw_path,
            "match_info": dict(request.match_info),
            "query": list(request.rel_url.query.items()),
            "uploads": "uploads" in request.rel_url.query,
            "raw_query": request.rel_url.raw_query_string,
            "headers": [(k, v) for k, v in request.headers.items() if k.lower() != "host"],
            "ci_get": request.headers.get("x-AMZ-meta-a"),
            "body": base64.b64encode(body).decode(),
            "body_exists": request.body_exists,
            "seen": request.get("seen"),
            "remote": request.remote,
        }
        return web.Response(body=json.dumps(out).encode(), content_type="application/json")

    app = web.Application(client_max_size=MAX_SIZE)
    app.router.add_route("*", "/", echo)
    app.router.add_route("*", "/{bucket}", echo)
    app.router.add_route("*", "/{bucket}/{key:.*}", echo)
    return app


class _Serve:
    def __init__(self, web):
        self.loop = asyncio.new_event_loop()
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        self.port = s.getsockname()[1]
        s.close()
        self.web = web
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.runner = web.AppRunner(_echo_app(web))
            self.loop.run_until_complete(self.runner.setup())
            self.loop.run_until_complete(web.TCPSite(self.runner, "127.0.0.1", self.port).start())
            ready.set()
            self.loop.run_forever()
            self.loop.run_until_complete(self.runner.cleanup())

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert ready.wait(10)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


@pytest.fixture(scope="module")
def servers():
    import logging

    logging.getLogger("aiohttp.server").disabled = True
    a, p = _Serve(aioweb), _Serve(portweb)
    yield a, p
    a.stop()
    p.stop()
    logging.getLogger("aiohttp.server").disabled = False


def _read_response(f, method):
    """(status, headers without Date/Server, de-chunked body, chunked?)"""
    line = f.readline()
    status = int(line.split(b" ")[1])
    headers = []
    while True:
        h = f.readline()
        if h in (b"\r\n", b""):
            break
        k, _, v = h.decode().partition(":")
        headers.append((k.strip().lower(), v.strip()))
    hd = dict(headers)
    body = b""
    chunked = hd.get("transfer-encoding") == "chunked"
    if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
        pass
    elif chunked:
        while True:
            size = int(f.readline().split(b";")[0], 16)
            if size == 0:
                f.readline()
                break
            body += f.read(size)
            f.readline()
    elif "content-length" in hd:
        body = f.read(int(hd["content-length"]))
    else:
        body = f.read()
    headers = sorted(kv for kv in headers if kv[0] not in ("date", "server"))
    return status, headers, body, chunked


def _exchange(port, raw: bytes, methods, expect_100=False):
    """Send ``raw`` (one or more requests) and read one response per
    method. With ``expect_100`` the head goes first and the body only
    after the server's 100 Continue."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        f = s.makefile("rb")
        out = []
        if expect_100:
            head, _, body = raw.partition(b"\r\n\r\n")
            s.sendall(head + b"\r\n\r\n")
            cont = f.readline()
            assert f.readline() == b"\r\n"
            out.append(cont.strip())
            s.sendall(body)
        else:
            s.sendall(raw)
        for m in methods:
            out.append(_read_response(f, m))
        return out


def _norm(res):
    """Echo bodies compare as JSON (the remote port differs); others raw."""
    outs = []
    for r in res:
        if isinstance(r, tuple) and r[1] and dict(r[1]).get("content-type") == "application/json" \
                and r[2].startswith(b'{"method"'):
            d = json.loads(r[2])
            headers = [(k, v) for k, v in r[1] if k != "content-length"]
            outs.append((r[0], headers, d, r[3]))
        else:
            outs.append(r)
    return outs


PATHS = [
    "/",
    "/bkt",
    "/bkt/",
    "/bkt/plain.txt",
    "/bkt/a%2Fb%20c+d%2B%C3%A9",
    "/bkt/dir/sub/",
    "/bkt/%E2%82%AC/x%25y",
    "/bkt/%e2%82%ac%2f",
    "/bkt/k%3Fq",
    "/bkt//double//slash",
    "/bkt/bad%C3%28utf8%FF%zz%",
    "/bkt/%F0%9F%98%80%F0",
    "/bkt/semi;colon",
    "/bkt/%7Bbrace%7D",
    "/%62kt/encoded-bucket",
    "/b%2Fc/k",
    "/bkt/a%00b",
    "/bkt/sp ace",
]
QUERIES = [
    "",
    "uploads",
    "versioning=&acl",
    "x=1+2&a=%2F&a=2&k=%zz&e=",
    "list-type=2&prefix=a%2Fb&delimiter=%2F&max-keys=1&encoding-type=url",
    "uploadId=abc%3D%3D&partNumber=1",
    "X-Amz-Credential=AKIA%2F20240101%2Fus-east-1%2Fs3%2Faws4_request&X-Amz-Signature=ab",
    "=v&&a==b&c",
    "x=1;y=2",
    "u=%C3%A9%C3&plus=a+b%2Bc",
]


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("query", QUERIES[:3] + QUERIES[3:])
def test_decoding_matches_aiohttp(servers, path, query):
    target = path + ("?" + query if query else "")
    raw = f"GET {target} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n".encode()
    a, p = (_norm(_exchange(s.port, raw, ["GET"])) for s in servers)
    if a[0][0] == 400:  # a request line the parsers refuse: the wording differs
        assert p[0][0] == 400
        return
    assert p == a


HEADER_SETS = [
    "X-Amz-Meta-A: 1\r\nx-amz-meta-a: 2\r\nX-AMZ-DATE: 20240101T000000Z\r\n",
    "Content-Type: image/png\r\nx-amz-meta-name: caf\xc3\xa9\r\nx-amz-meta-pad:   sp  \r\n",
    "Authorization: AWS4-HMAC-SHA256 Credential=a/b/c/s3/aws4_request, "
    "SignedHeaders=host;x-amz-date, Signature=00\r\nRange: bytes=0-9\r\n",
]


@pytest.mark.parametrize("hs", range(len(HEADER_SETS)))
@pytest.mark.parametrize("method", ["GET", "PUT", "DELETE", "POST", "OPTIONS", "HEAD"])
def test_headers_and_methods_match_aiohttp(servers, hs, method):
    hdr = HEADER_SETS[hs].encode("latin-1")
    raw = (f"{method} /bkt/key%20one?uploads HTTP/1.1\r\nHost: x\r\n".encode()
           + hdr + b"Connection: close\r\n\r\n")
    a, p = (_norm(_exchange(s.port, raw, [method])) for s in servers)
    assert p == a


BODIES = [b"", b"x", bytes(range(256)) * 5, b"\r\n0\r\n\r\n"]


@pytest.mark.parametrize("mode", ["echo", "chunks"])
@pytest.mark.parametrize("n", range(len(BODIES)))
@pytest.mark.parametrize("framing", ["length", "chunked", "expect"])
def test_request_bodies_match_aiohttp(servers, mode, n, framing):
    body = BODIES[n]
    head = f"PUT /bkt/obj?resp={mode} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
    if framing == "chunked":
        parts = [body[i:i + 100] for i in range(0, len(body), 100)]
        wire = b"".join(b"%x;ext=1\r\n%s\r\n" % (len(c), c) for c in parts if c)
        raw = (head + "Transfer-Encoding: chunked\r\n\r\n").encode() + wire + \
            b"0\r\nX-Trailer: t\r\n\r\n"
    else:
        extra = "Expect: 100-continue\r\n" if framing == "expect" else ""
        raw = (head + extra + f"Content-Length: {len(body)}\r\n\r\n").encode() + body
    want_100 = framing == "expect"
    a, p = (_norm(_exchange(s.port, raw, ["PUT"], expect_100=want_100)) for s in servers)
    assert p == a
    assert p[-1][0] == 200
    assert base64.b64decode(p[-1][2]["body"]) == body
    if want_100:
        assert p[0] == b"HTTP/1.1 100 Continue"


RESPONSES = ["stream", "streamlen", "empty", "nocontent", "xml", "text", "json", "etag",
             "raise"]


@pytest.mark.parametrize("method", ["GET", "HEAD"])
@pytest.mark.parametrize("mode", RESPONSES)
def test_responses_match_aiohttp(servers, mode, method):
    raw = f"{method} /bkt/k?resp={mode} HTTP/1.1\r\nHost: x\r\nAccept: */*\r\n\r\n".encode()
    a, p = (_norm(_exchange(s.port, raw, [method])) for s in servers)
    assert p == a


@pytest.mark.parametrize("version", ["1.1", "1.0"])
def test_keep_alive_matches_aiohttp(servers, version):
    conn = "" if version == "1.1" else "Connection: keep-alive\r\n"
    one = (f"PUT /bkt/a HTTP/{version}\r\nHost: x\r\n{conn}Content-Length: 3\r\n\r\nabc").encode()
    # HTTP/1.0 has no chunked coding: a stream without a length would end
    # the connection, so the 1.0 case streams a length-known body
    mode = "stream" if version == "1.1" else "streamlen"
    two = (f"GET /bkt/b?resp={mode} HTTP/{version}\r\nHost: x\r\n{conn}\r\n").encode()
    three = f"HEAD /bkt/c?resp=xml HTTP/{version}\r\nHost: x\r\nConnection: close\r\n\r\n".encode()
    a, p = (_norm(_exchange(s.port, one + two + three, ["PUT", "GET", "HEAD"]))
            for s in servers)
    assert p == a
    assert [r[0] for r in p][::2] == [200, 200]


def test_too_large_and_handler_error(servers):
    big = b"z" * (MAX_SIZE + 10)
    raw = (f"PUT /bkt/big HTTP/1.1\r\nHost: x\r\nContent-Length: {len(big)}\r\n"
           "Connection: close\r\n\r\n").encode() + big
    a, p = (_exchange(s.port, raw, ["PUT"])[0] for s in servers)
    assert a[0] == p[0] == 413
    assert p[2].startswith(b"Maximum request body size 4096 exceeded")
    raw = b"GET /bkt/k?resp=raise HTTP/1.1\r\nHost: x\r\n\r\n"
    a, p = (_exchange(s.port, raw, ["GET"])[0] for s in servers)
    assert a == p and p[0] == 500 and ("connection", "close") in p[1]


_PUT = b"PUT /bkt/o HTTP/1.1\r\nHost: x\r\n"
_TE = _PUT + b"Transfer-Encoding: chunked\r\n\r\n"
FRAMING = {
    # chunk sizes are hex digits only: a negative size once read to EOF
    **{f"chunk size {v!r}": _TE + v + b"\r\nhello\r\n0\r\n\r\n" for v in [
        b"-1", b"+5", b"0x5", b"5_0", b" 5", b"5 ", b"5\t", b"05", b"5;ext=1",
        b"FFFFFFFFFFFFFFFFFFFF", b"", b"g"]},
    "chunk without its CRLF": _TE + b"5\r\nhelloXX0\r\n\r\n",
    "trailers": _TE + b"5\r\nhello\r\n0\r\nX-T: 1\r\nX-U: 2\r\n\r\n",
    **{f"content-length {v!r}": _PUT + b"Content-Length: " + v + b"\r\n\r\nhello" for v in [
        b"+5", b"5_0", b"0x5", b"-1", b"5 ", b"1e3", "\uff15".encode(), b"05",
        b"9" * 5000]},
    "content-length twice, equal": _PUT + b"Content-Length: 5\r\nContent-Length: 5\r\n\r\nhello",
    "content-length twice, unequal": _PUT + b"Content-Length: 5\r\nContent-Length: 6\r\n\r\nhello!",
    "transfer-encoding then content-length": _PUT + b"Transfer-Encoding: chunked\r\n"
    b"Content-Length: 5\r\n\r\n5\r\nhello\r\n0\r\n\r\n",
    "content-length then transfer-encoding": _PUT + b"Content-Length: 5\r\n"
    b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n",
    **{f"transfer-encoding {v!r}": _PUT + b"Transfer-Encoding: " + v
       + b"\r\n\r\n5\r\nhello\r\n0\r\n\r\n" for v in [
           b"chunked, gzip", b"xchunked", b"identity", b"gzip", b"Chunked", b"chunked ",
           b"chunked,chunked"]},
    "transfer-encoding twice": _PUT + b"Transfer-Encoding: gzip\r\n"
    b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n",
    **{f"header {v!r}": _PUT + v + b"\r\nContent-Length: 0\r\n\r\n" for v in [
        b"X Y: 1", b"X\x01Y: 1", b"X-A: a\nb", b"X-A: a\rb", b"X-A: a\r\n b", b"X-A: a\x00b",
        b"X-A: a\tb", b": v"]},
}


@pytest.mark.parametrize("case", list(FRAMING))
def test_request_framing_matches_aiohttp(servers, case):
    # what aiohttp's parser refuses, the front refuses (400, connection
    # closed) before a handler reads a byte; what it takes reads the same
    a, p = (_norm(_exchange(s.port, FRAMING[case], ["PUT"])) for s in servers)
    if a[0][0] == 400:  # the wording differs
        assert p[0][0] == 400 and ("connection", "close") in p[0][1]
    else:
        assert p == a


def _reply_until_close(port, raw: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(raw)
        out = b""
        while b := s.recv(1 << 16):
            out += b
        return out


@pytest.mark.parametrize("method", ["GET", "HEAD"])
@pytest.mark.parametrize("mode", ["crlf", "crlfname", "crlfstream"])
def test_response_header_injection_is_refused(servers, mode, method):
    raw = f"{method} /bkt/k?resp={mode} HTTP/1.1\r\nHost: x\r\n\r\n".encode()
    a, p = (_reply_until_close(s.port, raw) for s in servers)
    for reply in (a, p):
        assert b"Set-Cookie" not in reply and b"\nX: v" not in reply
    # a header with CR or LF is a handler fault: 500, connection closed
    # (aiohttp drops the connection when the handler returned the response)
    assert p.startswith(b"HTTP/1.1 500 ") and b"\r\nConnection: close\r\n" in p
    if mode == "crlfstream":
        assert a.startswith(b"HTTP/1.1 500 ")


def test_multidicts():
    h = portweb.CIMultiDict([("ETag", "a"), ("etag", "b"), ("X", "1")])
    assert h["ETAG"] == "a" and h.items()[:2] == [("ETag", "a"), ("etag", "b")] and "x" in h
    h["etag"] = "c"
    assert h.items() == [("ETag", "c"), ("X", "1")]
    assert h.setdefault("x", "9") == "1" and h.setdefault("New", "n") == "n"
    del h["NEW"]
    assert list(h) == ["ETag", "X"] and h.get("nope") is None
    q = portweb.MultiDict([("a", "1"), ("A", "2")])
    assert q.get("a") == "1" and q.get("A") == "2" and q.values() == ["1", "2"]


def test_unquote_matches_yarl_on_random_strings():
    import random

    from yarl._quoters import PATH_SAFE_UNQUOTER, PATH_UNQUOTER, UNQUOTER_PLUS

    rnd = random.Random(6)
    alphabet = ["%", "2F", "2f", "25", "C3", "A9", "E2", "82", "AC", "FF", "zz", "+", "a",
                "/", " ", "F0", "9F", "98", "80", "%C3", "%A9", "%2B", "%20"]
    for _ in range(3000):
        s = "".join(rnd.choice(alphabet) for _ in range(rnd.randint(0, 12)))
        assert portweb._unquote(s) == PATH_UNQUOTER(s), s
        assert portweb._unquote(s, keep="/%") == PATH_SAFE_UNQUOTER(s), s
        assert portweb._unquote(s, plus=True) == UNQUOTER_PLUS(s), s
