"""The port's FTP gateway (minio_tpu_torch/server/ftp.py) passes the JAX
package's FTP gateway cases (tests/test_ftp_health.py), each run unchanged
against the port's server on its stdlib HTTP front; a STOR takes the
STANDARD storage class as an S3 PUT does; and ``python -m
minio_tpu_torch.server`` started as a pool of two binds the gateways in
worker 0 only.

The gateway serves on an event loop thread of its own beside the server's
(``serve_ftp``, shared with the other gateway tests); its store calls run
on the server's I/O pool, as in ``main()``.
"""

from __future__ import annotations

import asyncio
import ftplib
import io
import os
import threading
import time

import pytest

import tests.test_ftp_health as ref_cases
from tests.test_torch_s3_api import PORT_ENV, PortServerThread

# the reference's FTP gateway cases (tests/test_ftp_health.py:94-158); the
# file's other cases test storage/health.py, which is not a gateway
REF_CASES = ["test_ftp_end_to_end", "test_ftp_bad_login", "test_concurrent_mixed_workload"]


def serve_ftp(gateway_cls, srv) -> tuple[int, object]:
    """``gateway_cls(srv)`` serving FTP on 127.0.0.1 from a loop thread of
    its own: (its port, ``stop``)."""
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, name="ftp-gateway", daemon=True)
    th.start()
    server = asyncio.run_coroutine_threadsafe(
        gateway_cls(srv).serve("127.0.0.1", 0), loop).result(10)

    def stop() -> None:
        loop.call_soon_threadsafe(server.close)
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)

    return server.sockets[0].getsockname()[1], stop


@pytest.fixture(scope="module")
def port_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PORT_ENV.items():
            mp.setenv(k, v)
        yield mp


@pytest.fixture(scope="module")
def server(port_env, tmp_path_factory):
    from minio_tpu_torch.server.ftp import FTPGateway

    base = tmp_path_factory.mktemp("port-ftp-drives")
    st = PortServerThread([str(base / f"d{i}") for i in range(4)])
    st.drive0 = str(base / "d0")
    st.ftp_port, stop = serve_ftp(FTPGateway, st.srv)
    yield st
    stop()
    st.stop()


def test_reference_cases_are_all_here():
    gateway_cases = [n for n in vars(ref_cases) if n.startswith("test_")
                     and "server" in ref_cases.__dict__[n].__code__.co_varnames]
    assert sorted(gateway_cases) == sorted(REF_CASES)


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_case_on_the_port(case, server):
    getattr(ref_cases, case)(server)


def _ftp(port: int) -> ftplib.FTP:
    f = ftplib.FTP()
    f.connect("127.0.0.1", port, timeout=30)
    f.login("minioadmin", "minioadmin")
    return f


@pytest.mark.parametrize("spec,want", [("EC:1", (3, 1)), ("", (2, 2))])
def test_stor_takes_the_standard_storage_class(server, monkeypatch, spec, want):
    """MinIO applies MINIO_STORAGE_CLASS_STANDARD to every frontend's writes;
    the reference's gateway wrote at the set's default parity whatever the
    class said (ROADMAP Queue 3)."""
    from minio_tpu_torch.client import S3Client
    from minio_tpu_torch.erasure.listing import encode_dir_object
    from minio_tpu_torch.storage.xlstorage import XLStorage

    monkeypatch.setenv("MINIO_STORAGE_CLASS_STANDARD", spec)
    cli = S3Client(f"127.0.0.1:{server.port}")
    assert cli.make_bucket("ftp-class").status in (200, 409)
    key = f"stor-{spec or 'default'}.bin"
    f = _ftp(server.ftp_port)
    try:
        f.storbinary(f"STOR /ftp-class/{key}", io.BytesIO(b"standard" * 1000))
        f.mkd(f"/ftp-class/dir-{spec or 'default'}")
    finally:
        f.quit()
    assert cli.put_object("ftp-class", f"s3-{key}", b"standard" * 1000).status == 200
    for k in (key, f"s3-{key}", encode_dir_object(f"dir-{spec or 'default'}/")):
        e = XLStorage(server.drive0).read_version("ftp-class", k, "").erasure
        assert (e.data_blocks, e.parity_blocks) == want, k
    assert cli.get_object("ftp-class", key).body == b"standard" * 1000


def test_a_pool_binds_the_gateways_in_worker_0_only(tmp_path):
    """``--ftp`` and ``--sftp`` on a pool of two: worker 0 binds both ports
    after its bootstrap, worker 1 prints the reference's line and binds
    neither, and the FTP gateway serves a STOR and a RETR."""
    from minio_tpu_torch.client import S3Client
    from minio_tpu_torch.server.nodes import free_port_block, free_ports, spawn, stop_all, tail
    from tests.test_torch_cluster import node_env

    port = free_port_block(3)
    fport, sport = free_ports(2)
    log = tmp_path / "pool.log"
    env = node_env(MINIO_TPU_WORKERS="2", MINIO_TPU_WORKER_PORT_BASE=str(port + 1))
    proc = spawn(port, ["--ftp", fport, "--sftp", sport,
                        *[tmp_path / f"d{i}" for i in range(4)]], env, log)
    want = [f"FTP gateway on port {fport}", f"SFTP gateway on port {sport}",
            "worker 1: FTP/SFTP gateways served by worker 0 only"]
    try:
        deadline = time.monotonic() + 90
        while not all(w in tail(log, 200_000) for w in want):
            assert proc.poll() is None and time.monotonic() < deadline, tail(log)
            time.sleep(0.25)
        lines = tail(log, 200_000).splitlines()
        bound = [ln for ln in lines if ln.startswith(("FTP gateway", "SFTP gateway"))]
        assert sorted(bound) == sorted(want[:2]), lines
        assert S3Client(f"127.0.0.1:{port + 1}").make_bucket("pool-ftp").status == 200
        f = _ftp(fport)
        try:
            f.storbinary("STOR /pool-ftp/obj.bin", io.BytesIO(os.urandom(5000) * 3))
            buf = io.BytesIO()
            f.retrbinary("RETR /pool-ftp/obj.bin", buf.write)
            assert len(buf.getvalue()) == 15000
        finally:
            f.quit()
    finally:
        stop_all([proc])
