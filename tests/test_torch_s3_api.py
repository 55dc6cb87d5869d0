"""The port's S3 server (minio_tpu_torch.server.app on its stdlib HTTP
front, server/web.py) passes the JAX package's own S3 API cases
(tests/test_s3_api.py), each run unchanged against it over a real socket.

The server writes through the port's dispatcher on the CPU
(MINIO_TPU_BACKEND=torch, MINIO_TPU_TORCH_DEVICE=cpu), and stands where
the reference's tests stand their server: ``make_server`` served by an
``AppRunner`` / ``TCPSite`` pair on its own event loop thread. The harness
here (``PortServerThread``) is shared by the other test_torch_s3_*.py files.
"""

from __future__ import annotations

import inspect
import os

import pytest

import tests.test_s3_api as ref_cases
from tests.test_torch_suites import PortServerThread  # noqa: F401 — shared by the other files

PORT_ENV = {
    "MINIO_TPU_BACKEND": "torch",
    "MINIO_TPU_TORCH_DEVICE": "cpu",
    "MINIO_TPU_CACHE": "0",
    "MINIO_TPU_SCAN_INTERVAL": "0",
    "MINIO_COMPRESSION_ENABLE": "off",
}


@pytest.fixture(scope="module")
def port_env():
    with pytest.MonkeyPatch.context() as mp:
        for k, v in PORT_ENV.items():
            mp.setenv(k, v)
        yield mp


@pytest.fixture(scope="module")
def server(port_env, tmp_path_factory):
    base = tmp_path_factory.mktemp("port-drives")
    st = PortServerThread([str(base / f"d{i}") for i in range(4)])
    yield st
    st.stop()


@pytest.fixture(scope="module")
def cli(server):
    from minio_tpu_torch.client import S3Client

    return S3Client(f"127.0.0.1:{server.port}")


REF_CASES = sorted(
    n for n, f in vars(ref_cases).items()
    if n.startswith("test_") and inspect.isfunction(f)
)


def test_reference_cases_are_all_here():
    # every S3 API case of the JAX package is run below, none skipped
    assert len(REF_CASES) == 23


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_case_on_the_port(case, server, cli):
    fn = getattr(ref_cases, case)
    given = {"cli": cli, "server": server}
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})


def test_server_is_the_ports_on_the_stdlib_front(server):
    from minio_tpu_torch.erasure.pools import ServerPools
    from minio_tpu_torch.server import app, web

    assert isinstance(server.srv, app.S3Server)
    assert isinstance(server.srv.app, web.Application)
    assert isinstance(server.srv.store, ServerPools)
    assert os.environ["MINIO_TPU_BACKEND"] == "torch"
