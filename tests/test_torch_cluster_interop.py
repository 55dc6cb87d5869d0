"""The port's cluster plane holds to the reference's wire formats.

One reference node (``python -m minio_tpu.server``) and one port node
(``python -m minio_tpu_torch.server``) form one cluster over one endpoint
list, both on the host plane with the same MINIO_* environment: each reads
what the other wrote, the same body written through either node lands as
the same shard bytes, overwrites through both nodes serialize on the
distributed lock, and the bootstrap check finds no difference. Then the
HTTP planes (storage REST with the grid off, lock REST, bootstrap) are held
against the other package's server in both directions, in this process.
"""

from __future__ import annotations

import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from minio_tpu_torch.client import S3Client
from tests.test_s3_api import _free_port
from minio_tpu_torch.server.nodes import spawn, stop_all, tail, wait_online
from tests.test_torch_cluster import DEADLINE_S, node_env

BUCKET = "mixed"


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    base = tmp_path_factory.mktemp("mixed")
    pr, pp = _free_port(), _free_port()
    specs = [f"http://127.0.0.1:{pr}{base}/ref/d1", f"http://127.0.0.1:{pr}{base}/ref/d2",
             f"http://127.0.0.1:{pp}{base}/port/d1", f"http://127.0.0.1:{pp}{base}/port/d2"]
    env = node_env()
    logs = [base / "ref.log", base / "port.log"]
    procs = [spawn(pr, specs, env, logs[0], module="minio_tpu.server"),
             spawn(pp, specs, env, logs[1])]
    ref, port = S3Client(f"127.0.0.1:{pr}"), S3Client(f"127.0.0.1:{pp}")
    try:
        try:
            wait_online([ref, port], procs, DEADLINE_S)
        except (TimeoutError, RuntimeError):
            print(tail(logs[0]), tail(logs[1]))
            raise
        assert port.make_bucket(BUCKET).status == 200
        yield {"ref": ref, "port": port, "base": str(base), "logs": logs}
    finally:
        stop_all(procs)


def test_bootstrap_finds_no_difference(mixed):
    for log in mixed["logs"]:
        text = tail(log, 20000)
        assert "object layer online: 1 pool(s), 4 drives, distributed=True" in text, text
        assert "bootstrap config check" not in text, text


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("size", [0, 1000, 300_000, (1 << 20) + 17])
def test_each_node_reads_what_the_other_wrote(mixed, writer, size):
    reader = "port" if writer == "ref" else "ref"
    body = os.urandom(size)
    key = f"from-{writer}-{size}"
    r = mixed[writer].put_object(BUCKET, key, body)
    assert r.status == 200
    g = mixed[reader].get_object(BUCKET, key)
    assert g.status == 200 and g.body == body
    assert g.headers["etag"] == r.headers["etag"] == f'"{hashlib.md5(body).hexdigest()}"'
    h = mixed[reader].head_object(BUCKET, key)
    assert h.headers["content-length"] == str(size)


def _shards(base: str, key: str) -> list[bytes]:
    """Every drive's shard files of ``key`` (its data dir's part.N), sorted:
    which drive holds which erasure index follows the key's hash, so the
    two keys' shards compare as a set."""
    out = []
    for node in ("ref", "port"):
        for d in ("d1", "d2"):
            for dp, _, fs in os.walk(os.path.join(base, node, d, BUCKET, key)):
                out += [open(os.path.join(dp, f), "rb").read()
                        for f in fs if f.startswith("part.")]
    return sorted(out)


def test_same_body_same_shard_bytes(mixed):
    body = os.urandom(3 * (1 << 20) + 4097)
    assert mixed["ref"].put_object(BUCKET, "same-ref", body).status == 200
    assert mixed["port"].put_object(BUCKET, "same-port", body).status == 200
    a, b = _shards(mixed["base"], "same-ref"), _shards(mixed["base"], "same-port")
    assert len(a) == 4 and a == b


def test_listing_and_delete_cross_nodes(mixed):
    keys = [f"list/k{i:02d}" for i in range(12)]
    for i, k in enumerate(keys):
        assert mixed["ref" if i % 2 else "port"].put_object(BUCKET, k, b"v").status == 200
    for node in ("ref", "port"):
        body = mixed[node].request("GET", f"/{BUCKET}", query={"prefix": "list/"}).body
        assert [k for k in keys if f"<Key>{k}</Key>".encode() in body] == keys
    assert mixed["ref"].request("DELETE", f"/{BUCKET}/list/k03").status == 204
    assert mixed["port"].get_object(BUCKET, "list/k03").status == 404


def test_overwrites_through_both_nodes_serialize(mixed):
    """Writers on both nodes race on one key; the namespace lock spans the
    two packages, so every read through either node is one whole body."""
    bodies = [bytes([i]) * (200_000 + i) for i in range(6)]
    etags = {f'"{hashlib.md5(b).hexdigest()}"': b for b in bodies}

    def write(i):
        return mixed["ref" if i % 2 else "port"].put_object(BUCKET, "race", bodies[i]).status

    with ThreadPoolExecutor(6) as ex:
        assert list(ex.map(write, range(6))) == [200] * 6
    got = [mixed[n].get_object(BUCKET, "race") for n in ("ref", "port")]
    assert got[0].body == got[1].body
    assert etags[got[0].headers["etag"]] == got[0].body


# -- the HTTP planes, in this process, both directions ---------------------------


class _Served:
    """A package's storage REST, lock REST and bootstrap servers on its
    front, over one drive."""

    def __init__(self, pkg: str, tmp_path, token: str):
        import importlib

        from tests.test_torch_grid import _Loop, _web

        web = _web(pkg)
        sr = importlib.import_module(f"{pkg}.cluster.storage_rest")
        locks = importlib.import_module(f"{pkg}.cluster.locks")
        boot = importlib.import_module(f"{pkg}.cluster.bootstrap")
        xl = importlib.import_module(f"{pkg}.storage.xlstorage")
        self.drive = xl.XLStorage(str(tmp_path / f"{pkg}-d0"))
        self.cfg = boot.system_config(["http://a/d1", "http://b/d1"], salt=token)
        app = web.Application(client_max_size=1 << 30)
        sr.StorageRESTServer({0: self.drive}, token).register(app)
        locks.LockRESTServer(locks.LocalLocker(), token).register(app)
        boot.BootstrapRESTServer(self.cfg, token).register(app)
        self._loop = _Loop(web, app)
        self.port = self._loop.port

    def stop(self):
        self._loop.stop()


DIRECTIONS = {"port-client": ("minio_tpu", "minio_tpu_torch"),
              "ref-client": ("minio_tpu_torch", "minio_tpu")}


@pytest.fixture(params=sorted(DIRECTIONS))
def planes(request, tmp_path, monkeypatch):
    import importlib

    monkeypatch.setenv("MINIO_TPU_GRID", "0")  # every storage op over HTTP
    spkg, cpkg = DIRECTIONS[request.param]
    token = "interop-token"
    srv = _Served(spkg, tmp_path, token)
    try:
        yield srv, token, lambda name: importlib.import_module(f"{cpkg}.{name}")
    finally:
        srv.stop()


def test_storage_rest_over_http(planes):
    srv, token, cmod = planes
    FileInfo = cmod("storage.datatypes").FileInfo
    errors = cmod("storage.errors")
    cli = cmod("cluster.storage_rest").StorageRESTClient("127.0.0.1", srv.port, 0, token)
    assert cli._gate.client() is None  # the grid is off: HTTP carries it all
    cli.make_vol("vol")
    with pytest.raises(errors.VolumeExists):
        cli.make_vol("vol")
    assert [v.name for v in cli.list_vols() if v.name == "vol"] == ["vol"]
    assert cli.stat_vol("vol").name == "vol"
    cli.create_file("vol", "obj/part.1", b"abc" * 1000)
    cli.append_file("vol", "obj/part.1", [b"de", b"f"])
    assert cli.read_file("vol", "obj/part.1", 2998, 5) == b"bcdef"
    assert cli.stat_info_file("vol", "obj/part.1") == 3003
    fi = FileInfo(volume="vol", name="obj", mod_time=time.time_ns(), size=3003)
    fi.metadata["x-amz-meta-a"] = "1"
    cli.write_metadata("vol", "obj", fi)
    back = cli.read_version("vol", "obj")
    assert back.metadata["x-amz-meta-a"] == "1" and back.size == 3003
    assert [f.size for f in cli.read_versions("vol", "obj")] == [3003]
    assert sorted(cli.list_dir("vol", "obj")) == sorted(srv.drive.list_dir("vol", "obj"))
    assert list(cli.walk_dir("vol", "")) == list(srv.drive.walk_dir("vol", ""))
    cli.rename_file("vol", "obj/part.1", "vol", "obj2/part.1")
    with pytest.raises(errors.FileNotFound):
        cli.read_file("vol", "obj/part.1")
    cli.delete("vol", "obj2", recursive=True)
    with pytest.raises(errors.FileNotFound):
        cli.read_version("vol", "missing")
    assert cli.disk_info().total == srv.drive.disk_info().total


def test_lock_rest_over_http(planes):
    srv, token, cmod = planes
    lk = cmod("cluster.locks")._RemoteLocker("127.0.0.1", srv.port, token)
    assert lk._call_http("lock", "b/o", "u1")
    assert not lk._call_http("lock", "b/o", "u2")
    assert not lk._call_http("rlock", "b/o", "u3")
    assert lk._call_http("refresh", "b/o", "u1")
    assert lk._call_http("unlock", "b/o", "u1")
    assert lk._call_http("rlock", "b/o", "u3") and lk._call_http("rlock", "b/o", "u4")
    assert lk._call_http("runlock", "b/o", "u3") and lk._call_http("runlock", "b/o", "u4")
    bad = cmod("cluster.locks")._RemoteLocker("127.0.0.1", srv.port, "wrong")
    assert not bad._call_http("lock", "b/o", "u9")


def test_bootstrap_verify(planes, monkeypatch):
    srv, token, cmod = planes
    boot = cmod("cluster.bootstrap")
    mine = boot.system_config(["http://a/d1", "http://b/d1"], salt=token)
    assert mine == srv.cfg  # the same environment hashes the same
    peer = f"127.0.0.1:{srv.port}"
    assert boot.verify_peers(mine, [peer], token, retries=2, retry_delay=0.1) == []
    monkeypatch.setenv("MINIO_ONLY_HERE", "x")
    odd = boot.system_config(["http://a/d1", "http://b/d1"], salt=token)
    assert boot.verify_peers(odd, [peer], token, retries=1) == [
        f"peer {peer}: MINIO_* environment mismatch — missing on peer: ['MINIO_ONLY_HERE']"]
    assert "token mismatch" in boot.verify_peers(mine, [peer], "wrong", retries=1)[0]
