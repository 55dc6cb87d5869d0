"""The port's embedded console (minio_tpu_torch/server/console.py, answered
through server/web.py): the JAX package's console cases
(tests/test_console.py), each run unchanged against the port's server; the
page is the reference's, byte for byte, with the headers the reference's
aiohttp server sends, on GET and HEAD."""

from __future__ import annotations

import http.client
import inspect

import pytest

import tests.test_console as ref_cases
from tests.test_torch_s3_api import PORT_ENV, PortServerThread

REF_CASES = [n for n, f in vars(ref_cases).items()
             if n.startswith("test_") and inspect.isfunction(f)]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PORT_ENV.items():
            mp.setenv(k, v)
        base = tmp_path_factory.mktemp("port-console-drives")
        st = PortServerThread([str(base / f"d{i}") for i in range(4)])
        yield st
        st.stop()


def test_reference_cases_are_all_here():
    assert len(REF_CASES) == 5


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_case_on_the_port(case, server):
    getattr(ref_cases, case)(server)


def test_page_is_the_references():
    from minio_tpu.server import console as ref_console
    from minio_tpu_torch.server import console

    assert console.CONSOLE_HTML == ref_console.CONSOLE_HTML


def _fetch(port: int, method: str, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path)
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def ref_server(tmp_path_factory):
    from tests.test_s3_api import ServerThread

    base = tmp_path_factory.mktemp("ref-console-drives")
    st = ServerThread([str(base / f"d{i}") for i in range(4)])
    yield st
    st.stop()


HEADERS = ("content-type", "content-length", "cache-control", "content-security-policy",
           "x-frame-options")


@pytest.mark.parametrize("method,path", [("GET", "/minio/console/"),
                                         ("HEAD", "/minio/console"),
                                         ("GET", "/minio/console/buckets/x")])
def test_headers_and_body_match_the_reference(server, ref_server, method, path):
    from minio_tpu.server.console import CONSOLE_HTML

    got = {}
    for name, st in (("port", server), ("ref", ref_server)):
        status, hdrs, body = _fetch(st.port, method, path)
        got[name] = (status, {h: hdrs.get(h) for h in HEADERS}, body)
    assert got["port"] == got["ref"]
    status, hdrs, body = got["port"]
    assert status == 200 and hdrs["x-frame-options"] == "DENY"
    assert int(hdrs["content-length"]) == len(CONSOLE_HTML.encode())
    assert body == (b"" if method == "HEAD" else CONSOLE_HTML.encode())
