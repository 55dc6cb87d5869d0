"""Objects cross between the JAX package's S3 server and the port's over
shared drives, in both directions: both servers run over the same four
drive directories (read cache off, so every GET reads the drives), an
object PUT through one is read back through the other byte for byte, with
the same ETag, size, content type and user metadata, and its xl.meta
records the same erasure layout.
"""

from __future__ import annotations

import numpy as np
import pytest

from minio_tpu.erasure.listing import encode_dir_object
from minio_tpu.storage.xlstorage import XLStorage as RefStorage
from minio_tpu_torch.storage.xlstorage import XLStorage
from tests.test_torch_s3_api import PORT_ENV, PortServerThread


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from minio_tpu.client import S3Client
    from tests.test_s3_api import ServerThread

    with pytest.MonkeyPatch.context() as mp:
        for k, v in PORT_ENV.items():
            mp.setenv(k, v)
        base = tmp_path_factory.mktemp("shared")
        drives = [str(base / f"d{i}") for i in range(4)]
        ref = ServerThread(drives)  # mints format.json
        port = PortServerThread(drives)
        clients = {"ref": S3Client(f"127.0.0.1:{ref.port}"),
                   "port": S3Client(f"127.0.0.1:{port.port}")}
        assert clients["ref"].make_bucket("from-ref").status == 200
        assert clients["port"].make_bucket("from-port").status == 200
        yield clients, drives
        ref.stop()
        port.stop()


def _body(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


KINDS = {
    "empty": 0,
    "small": 1000,
    "mid": 300_000,
    "block": (1 << 20) + 1,   # one full stripe block: the port's dispatcher route
    "multipart": None,
    "dirmarker": None,
}


def _put(c, bucket, kind, seed):
    if kind == "multipart":
        parts = [_body(65_536, seed), _body(100_003, seed + 1), _body(7, seed + 2)]
        r = c.request("POST", f"/{bucket}/mp.bin", query={"uploads": ""})
        uid = r.body.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
        xml = "<CompleteMultipartUpload>"
        for i, p in enumerate(parts, 1):
            e = c.request("PUT", f"/{bucket}/mp.bin",
                          query={"partNumber": str(i), "uploadId": uid}, body=p).headers["etag"]
            xml += f"<Part><PartNumber>{i}</PartNumber><ETag>{e}</ETag></Part>"
        r = c.request("POST", f"/{bucket}/mp.bin", query={"uploadId": uid},
                      body=(xml + "</CompleteMultipartUpload>").encode())
        assert r.status == 200, r.body
        return "mp.bin", b"".join(parts)
    if kind == "dirmarker":
        key, body = "folder/", b""
    else:
        key, body = f"{kind}.bin", _body(KINDS[kind], seed)
    r = c.put_object(bucket, key, body, headers={"content-type": "text/csv",
                                                 "x-amz-meta-origin": "interop"})
    assert r.status == 200, r.body
    return key, body


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_object_crosses_between_the_servers(pair, writer, reader, kind):
    clients, drives = pair
    bucket = f"from-{writer}"
    key, body = _put(clients[writer], bucket, kind, seed=len(kind))
    wrote = clients[writer].head_object(bucket, key)
    got = clients[reader].get_object(bucket, key)
    assert got.status == 200 and got.body == body
    for h in ("etag", "content-length", "content-type", "x-amz-meta-origin"):
        assert got.headers.get(h) == wrote.headers.get(h), h
    if body:
        rng = clients[reader].get_object(bucket, key, headers={"Range": f"bytes=1-{len(body)}"})
        assert rng.status == 206 and rng.body == body[1:]
    # the same xl.meta, read by each package's storage layer
    enc = encode_dir_object(key)
    a = RefStorage(drives[0]).read_version(bucket, enc, "")
    b = XLStorage(drives[0]).read_version(bucket, enc, "")
    assert (a.size, a.erasure.data_blocks, a.erasure.parity_blocks, a.erasure.distribution,
            a.erasure.algorithm, a.metadata.get("etag")) == (
        b.size, b.erasure.data_blocks, b.erasure.parity_blocks, b.erasure.distribution,
        b.erasure.algorithm, b.metadata.get("etag"))
    # listing through the reader shows the writer's object
    lst = clients[reader].list_objects_v2(bucket, prefix=key)
    assert f"<Key>{key}</Key>".encode() in lst.body
