"""The port's S3 server answers as the JAX package's does.

The same scripted requests go to the JAX server (aiohttp) and to the
port's server (its stdlib front), each over four drives of its own. The
status, the headers that matter (ETag, Content-Length, Content-Type,
Content-Range, the x-amz-* headers but the request ids, the CORS headers)
and the bodies must agree; XML bodies compare with ids and dates masked.
Both servers run in this process under MINIO_TPU_BACKEND=torch: the port
writes full stripe blocks through its dispatcher on the CPU, and the JAX
package on a host without a TPU writes through its native plane.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest

from tests.conftest import requires_crypto
from tests.test_torch_s3_api import PORT_ENV, PortServerThread

MASK_TAGS = ("RequestId", "HostId", "LastModified", "Initiated", "VersionId", "UploadId",
             "CreationDate", "NextVersionIdMarker", "VersionIdMarker",
             "NextUploadIdMarker", "UploadIdMarker")
_MASK_RE = re.compile(r"<(%s)>[^<]*</\1>" % "|".join(MASK_TAGS))
DROP_HEADERS = {"date", "server", "x-amz-request-id", "x-amz-id-2", "connection",
                "keep-alive"}
MASK_HEADERS = {"last-modified", "x-amz-version-id"}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from tests.test_s3_api import ServerThread

    with pytest.MonkeyPatch.context() as mp:
        for k, v in PORT_ENV.items():
            mp.setenv(k, v)
        base = tmp_path_factory.mktemp("diff")
        ref = ServerThread([str(base / f"r{i}") for i in range(4)])
        port = PortServerThread([str(base / f"p{i}") for i in range(4)])
        yield ref, port
        ref.stop()
        port.stop()


def _clients(servers, **kw):
    from minio_tpu.client import S3Client

    return [S3Client(f"127.0.0.1:{s.port}", **kw) for s in servers]


def _norm(r, mask_etag=False):
    headers = {}
    for k, v in r.headers.items():
        if k in DROP_HEADERS:
            continue
        if k in MASK_HEADERS or (mask_etag and k == "etag"):
            v = "*" if v else v
        headers[k] = v
    body = r.body
    if body.lstrip().startswith(b"<"):
        body = _MASK_RE.sub(lambda m: f"<{m.group(1)}>*</{m.group(1)}>", body.decode())
    return r.status, headers, body


def _body(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _upload_id(r):
    return r.body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()


def _put_get_head(c):
    out = [c.make_bucket("dput")]
    for n, key in ((0, "empty"), (1000, "dir/small.bin"), (300_000, "mid"),
                   ((1 << 20) + 1, "block-and-tail")):
        body = _body(n, n)
        out.append(c.put_object("dput", key, body, headers={
            "content-type": "image/png", "x-amz-meta-color": "teal"}))
        g = c.get_object("dput", key)
        assert g.body == body
        out += [g, c.head_object("dput", key)]
    out += [c.get_object("dput", "missing"), c.head_object("dput", "missing"),
            c.get_object("nobucket", "k"), c.request("GET", "/dput", query={"location": ""})]
    return out


def _ranged(c):
    body = bytes(range(256)) * 64
    out = [c.make_bucket("drng"), c.put_object("drng", "r", body)]
    for rng in ("bytes=0-9", "bytes=-5", "bytes=16000-", "bytes=100-99999",
                f"bytes={len(body)}-", "bytes=5-2"):
        out.append(c.get_object("drng", "r", headers={"Range": rng}))
    return out


def _listing(c):
    out = [c.make_bucket("dlist")]
    for k in ("a/1", "a/2", "a/b/3", "b/4", "top", "sp ace/k#1", "z/"):
        out.append(c.put_object("dlist", k, b"x" * len(k)))
    out += [c.list_objects_v2("dlist"), c.list_objects_v2("dlist", delimiter="/"),
            c.list_objects_v2("dlist", prefix="a/", delimiter="/"),
            c.request("GET", "/dlist", query={"list-type": "2", "encoding-type": "url"}),
            c.request("GET", "/dlist", query={"list-type": "2", "max-keys": "2"}),
            c.request("GET", "/dlist", query={"list-type": "2", "start-after": "a/2"}),
            c.request("GET", "/dlist", query={"prefix": "a", "marker": "a/1"}),
            c.request("GET", "/")]
    return out


def _multipart(c):
    out = [c.make_bucket("dmp")]
    r = c.request("POST", "/dmp/big", query={"uploads": ""})
    uid = _upload_id(r)
    out.append(r)
    parts = [_body(70_000, 1), _body(90_001, 2), _body(5, 3)]
    for i, p in enumerate(parts, 1):
        out.append(c.request("PUT", "/dmp/big", query={"partNumber": str(i), "uploadId": uid},
                             body=p))
    out.append(c.request("GET", "/dmp/big", query={"uploadId": uid}))
    out.append(c.request("GET", "/dmp", query={"uploads": ""}))
    etags = [c.request("PUT", "/dmp/big", query={"partNumber": str(i), "uploadId": uid},
                       body=p).headers["etag"] for i, p in enumerate(parts, 1)]
    xml = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>"
    out.append(c.request("POST", "/dmp/big", query={"uploadId": uid}, body=xml.encode()))
    g = c.get_object("dmp", "big")
    assert g.body == b"".join(parts)
    out += [g, c.get_object("dmp", "big", query={"partNumber": "2"}),
            c.head_object("dmp", "big")]
    # an aborted upload is gone
    uid2 = _upload_id(c.request("POST", "/dmp/gone", query={"uploads": ""}))
    out += [c.request("DELETE", "/dmp/gone", query={"uploadId": uid2}),
            c.request("GET", "/dmp/gone", query={"uploadId": uid2})]
    return out


def _copy_and_delete(c):
    out = [c.make_bucket("dcp"), c.put_object("dcp", "src", b"copy-me",
                                              headers={"x-amz-meta-a": "1"})]
    out.append(c.request("PUT", "/dcp/dst", headers={"x-amz-copy-source": "/dcp/src"}))
    out.append(c.request("PUT", "/dcp/dst2", headers={
        "x-amz-copy-source": "/dcp/src", "x-amz-metadata-directive": "REPLACE",
        "x-amz-meta-b": "2"}))
    out += [c.get_object("dcp", "dst"), c.head_object("dcp", "dst2")]
    out.append(c.request("PUT", "/dcp/dst3", headers={"x-amz-copy-source": "/dcp/none"}))
    xml = (b"<Delete><Object><Key>src</Key></Object><Object><Key>dst</Key></Object>"
           b"<Object><Key>missing</Key></Object></Delete>")
    out.append(c.request("POST", "/dcp", query={"delete": ""}, body=xml))
    out += [c.get_object("dcp", "src"), c.delete_object("dcp", "dst2"),
            c.list_objects_v2("dcp"), c.delete_bucket("dcp")]
    return out


def _versioning(c):
    cfg = (b'<VersioningConfiguration xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
           b"<Status>Enabled</Status></VersioningConfiguration>")
    out = [c.make_bucket("dver"), c.request("PUT", "/dver", query={"versioning": ""}, body=cfg),
           c.request("GET", "/dver", query={"versioning": ""})]
    v1 = c.put_object("dver", "doc", b"one")
    out += [v1, c.put_object("dver", "doc", b"two"), c.get_object("dver", "doc")]
    out.append(c.get_object("dver", "doc", query={"versionId": v1.headers["x-amz-version-id"]}))
    d = c.delete_object("dver", "doc")
    out += [d, c.get_object("dver", "doc"), c.request("GET", "/dver", query={"versions": ""})]
    out += [c.delete_object("dver", "doc", version_id=d.headers["x-amz-version-id"]),
            c.get_object("dver", "doc")]
    return out


def _cors_and_auth(c):
    from minio_tpu.client import S3Client

    out = [c.make_bucket("dcors"), c.put_object("dcors", "k", b"v")]
    out.append(c.request("OPTIONS", "/dcors/k", headers={
        "Origin": "https://app.example", "Access-Control-Request-Method": "PUT",
        "Access-Control-Request-Headers": "content-type,x-amz-meta-a"}))
    out.append(c.get_object("dcors", "k", headers={"Origin": "https://app.example"}))
    bad = S3Client(f"{c.host}:{c.port}", secret_key="wrong")
    out += [bad.request("GET", "/"), bad.get_object("dcors", "k"),
            S3Client(f"{c.host}:{c.port}", access_key="nobody").request("GET", "/")]
    import http.client

    conn = http.client.HTTPConnection(c.host, c.port, timeout=10)
    conn.request("GET", "/dcors/k")
    r = conn.getresponse()
    from minio_tpu.client import S3Response

    out.append(S3Response(r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()))
    conn.close()
    return out


def _console(c):
    """The console plane. While the port had no console.py it answered an
    S3 error here; now it serves the page as the JAX server does. The admin
    plane is held to the reference in tests/test_torch_admin.py."""
    return [c.request("GET", "/minio/console"),
            c.request("HEAD", "/minio/console/index.html")]


SCENARIOS = {f.__name__[1:]: f for f in (
    _put_get_head, _ranged, _listing, _multipart, _copy_and_delete, _versioning,
    _cors_and_auth)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_answers_like_the_reference(servers, name):
    ref, port = (list(map(_norm, SCENARIOS[name](c))) for c in _clients(servers))
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert b == a, f"{name} step {i}"


def test_unported_planes_answer_an_s3_error(servers):
    ref, port = (_console(c) for c in _clients(servers))
    for r, p in zip(ref, port):
        assert p.status == r.status == 200
        assert p.headers["content-type"] == r.headers["content-type"] == "text/html"
        assert p.body == r.body


@pytest.mark.parametrize("path,series", [
    ("v2/metrics/node", "minio_s3_requests_total"),
    ("metrics/v3/api/tpu", "minio_tpu_dispatch_blocks_total"),
    ("metrics/v3/api/tpu", "minio_tpu_dispatch_total"),
    ("metrics/v3/api/requests", "minio_api_requests_total"),
    ("metrics/v3/api/tpu", "minio_tpu_kernel_launches_total"),
])
def test_metrics_keep_the_reference_series(servers, monkeypatch, path, series):
    import urllib.request

    monkeypatch.setenv("MINIO_PROMETHEUS_AUTH_TYPE", "public")
    names = []
    for s in servers:
        txt = urllib.request.urlopen(
            f"http://127.0.0.1:{s.port}/minio/{path}", timeout=30).read().decode()
        names.append({ln.split("{")[0].split(" ")[0] for ln in txt.splitlines()
                      if ln and not ln.startswith("#")})
    ref, port = names
    assert series in port
    assert ref - port == set(), sorted(ref - port)


@requires_crypto
@pytest.mark.parametrize("mode", ["sse-s3", "compression", "both"])
def test_transforms_answer_like_the_reference(servers, monkeypatch, mode):
    if mode in ("compression", "both"):
        monkeypatch.setenv("MINIO_COMPRESSION_ENABLE", "on")
        monkeypatch.setenv("MINIO_COMPRESSION_EXTENSIONS", ".txt")
    hdrs = {"x-amz-server-side-encryption": "AES256"} if mode != "compression" else {}
    bucket = f"dtx-{mode}"
    body = b"compress me, " * 30_000 + _body(70_000, 9)
    results = []
    for c in _clients(servers):
        out = [c.make_bucket(bucket), c.put_object(bucket, "doc.txt", body, headers=hdrs)]
        g = c.get_object(bucket, "doc.txt")
        assert g.status == 200 and g.body == body
        out += [g, c.head_object(bucket, "doc.txt"),
                c.get_object(bucket, "doc.txt", headers={"Range": "bytes=400000-400099"})]
        results.append([_norm(r, mask_etag=mode != "compression") for r in out])
    assert results[1] == results[0]
