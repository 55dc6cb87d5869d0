"""The harness that runs the JAX package's data-path suites against the
port, and the checks that keep it honest.

Each ``tests/test_torch_<suite>.py`` file is one reference suite
(``tests/test_<suite>.py``) run as written through
``tests.test_torch_analysis.load_reference_tests``: the module's imports
and strings pointed at ``minio_tpu_torch``, its test helpers mapped by
``HELPERS`` onto the port's (the reference's ``ServerThread`` is the
port's ``PortServerThread``, ``grid_app`` serves the port's grid on the
port's front, the worker-pool helpers start ``python -m
minio_tpu_torch.server``). ``load_port_suite`` adds to each file:

- ``cpu_rung``: a module-scoped autouse fixture that puts the port on its
  CPU rung (``MINIO_TPU_BACKEND=torch``, ``MINIO_TPU_TORCH_DEVICE=cpu``)
  before any of the file's fixtures start a server, and restores the
  environment after its last case;
- ``case_time_limit``: every case fails after ``CASE_LIMIT_S`` seconds
  (several times the slowest case here: it catches a hang, not slowness)
  instead of hanging the run;
- ``port_only``: the guard. Every case fails, in its teardown, if since
  the file's first fixture the reference's ``minio_tpu.server`` or
  ``minio_tpu.cluster`` was imported, its ``S3Server`` or ``GridServer``
  was built, or a subprocess was started on a ``minio_tpu.`` module: a
  pass is the port's, whatever the order the cases ran in.

A reference case whose body cannot hold for the port is named in its
file's ``REPLACED`` with why, and defined anew there under the same name
(``check_replaced``).
"""

from __future__ import annotations

import ast
import os
import signal
import socket
import subprocess
import sys
import threading

import pytest

from minio_tpu_torch.client import S3Client  # noqa: F401 — a mapped helper
from minio_tpu_torch.server.nodes import free_port_block, wait_online
from tests.test_torch_analysis import ROOT, check_replaced, load_reference_tests

HERE = "tests.test_torch_suites"

# the reference suites' test-helper imports -> this module's port helpers
HELPERS = {
    "tests.test_s3_api": (HERE, {"ServerThread": "PortServerThread"}),
    "test_s3_api": (HERE, {"ServerThread": "PortServerThread"}),
    "tests.test_grid": (HERE, {}),
    "test_workers": (HERE, {}),
}

# the port's CPU rung: its device route, with the kernels' plain versions
CPU_RUNG = {"MINIO_TPU_BACKEND": "torch", "MINIO_TPU_TORCH_DEVICE": "cpu"}

# what a pass of the port must not have touched
REFERENCE_SERVING = ("minio_tpu.server", "minio_tpu.cluster")

# each suite case's own limit
CASE_LIMIT_S = 300.0


class PortServerThread:
    """The port's server on its own loop thread (``web.serve_in_thread``),
    started the way the reference's ``tests/test_s3_api.ServerThread``
    starts the JAX one (an explicit ``port``: a peer restarted on the
    address its partners hold)."""

    def __init__(self, drives, port=None, srv=None):
        from minio_tpu_torch.server import web
        from minio_tpu_torch.server.app import make_server

        self.srv = srv if srv is not None else make_server(drives)
        self.port, self._stop = web.serve_in_thread(self.srv.app, port=port or 0)

    def stop(self):
        """As the reference's: close the server, stop its loop, and wait
        for the thread at most 15 s (the front gives a request in flight,
        such as a trace stream whose reader left, 60 s to finish)."""
        self.srv.close()
        th = threading.Thread(target=self._stop, daemon=True)
        th.start()
        th.join(timeout=15)


def _free_port() -> int:
    """The reference's ``tests.test_s3_api._free_port``."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _free_port_block(n: int, lo: int = 20000, hi: int = 29000) -> int:
    """The reference's ``test_workers._free_port_block``: the port's."""
    return free_port_block(n, lo, hi)


def _wait_ready(clients, timeout: float = 60.0) -> None:
    """The reference's ``test_workers._wait_ready``: the port's."""
    wait_online(clients, timeout=timeout)


@pytest.fixture()
def grid_app():
    """The reference's ``tests.test_grid.grid_app`` on the port: a
    ``GridServer`` of ``minio_tpu_torch.cluster.grid`` on the port's
    front, yielding what the reference's fixture yields."""
    from minio_tpu_torch.cluster.grid import GridServer, close_shared_clients
    from minio_tpu_torch.server import web

    token = "grid-test-token"
    gs = GridServer(token)
    app = web.Application()
    gs.register(app)
    port, stop = web.serve_in_thread(app)
    yield gs, "127.0.0.1", port, token, app
    close_shared_clients()
    stop()


# -- the per-file fixtures ------------------------------------------------


def _reference_serving_modules() -> set:
    return {m for m in sys.modules if m.split(".")[0] == "minio_tpu"
            and m.startswith(REFERENCE_SERVING)}


class _Witness:
    """What of the reference's serving code a file's cases reached."""

    def __init__(self):
        self.modules_before = _reference_serving_modules()
        self.built: list[str] = []
        self.spawned: list[list[str]] = []

    def imported(self) -> list[str]:
        return sorted(_reference_serving_modules() - self.modules_before)


def _watch_constructors(mp: pytest.MonkeyPatch, witness: _Witness) -> None:
    for mod, cls in (("minio_tpu.server.app", "S3Server"),
                     ("minio_tpu.cluster.grid", "GridServer")):
        m = sys.modules.get(mod)
        if m is None:
            continue  # not imported: importing it shows in witness.imported()
        klass = getattr(m, cls)
        init = klass.__init__

        def watched(self, *a, __init=init, __name=f"{mod}.{cls}", **kw):
            witness.built.append(__name)
            __init(self, *a, **kw)

        mp.setattr(klass, "__init__", watched)
    popen_init = subprocess.Popen.__init__

    def popen(self, args, *a, **kw):
        argv = [str(x) for x in (args if isinstance(args, (list, tuple)) else [args])]
        if any(x.startswith("minio_tpu.") or "-m minio_tpu." in x for x in argv):
            witness.spawned.append(argv)
        popen_init(self, args, *a, **kw)

    mp.setattr(subprocess.Popen, "__init__", popen)


def check_port_only(witness: _Witness) -> None:
    """The guard: nothing the witness saw reached the reference's server
    or cluster plane."""
    assert witness.imported() == [], witness.imported()
    assert witness.built == [], witness.built
    assert witness.spawned == [], witness.spawned


def _fixtures():
    witness_box: dict = {}

    @pytest.fixture(scope="module", autouse=True)
    def cpu_rung():
        with pytest.MonkeyPatch.context() as mp:
            for k, v in CPU_RUNG.items():
                mp.setenv(k, v)
            witness_box["w"] = _Witness()
            _watch_constructors(mp, witness_box["w"])
            yield witness_box["w"]

    @pytest.fixture(autouse=True)
    def case_time_limit(request):
        if threading.current_thread() is not threading.main_thread():
            yield
            return

        def expire(signum, frame):
            raise TimeoutError(f"{request.node.name} ran past its limit of {CASE_LIMIT_S} s")

        old = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, CASE_LIMIT_S)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, old)

    @pytest.fixture(autouse=True)
    def port_only(cpu_rung):
        yield
        check_port_only(cpu_rung)

    return cpu_rung, case_time_limit, port_only


def load_port_suite(name: str, namespace: dict, replaced: dict[str, str]) -> None:
    """Run ``tests/<name>.py`` into ``namespace`` against the port (the
    module docstring): its helpers through ``HELPERS``, the cases named in
    ``replaced`` left for the caller to define anew, and this harness's
    fixtures added."""
    load_reference_tests(name, namespace, replaced, modules=HELPERS)
    namespace["cpu_rung"], namespace["case_time_limit"], namespace["port_only"] = _fixtures()


# -- the suites the port runs, and the harness's own checks -----------------

SUITES = ("test_chaos", "test_repair_plane", "test_zerocopy", "test_streaming_put",
          "test_inline_fastpath", "test_whole_file_bitrot", "test_erasure_set",
          "test_fault_injection", "test_multipart", "test_resume", "test_background",
          "test_bitrot", "test_cache")
# the port's file of each suite (test_torch_bitrot.py and
# test_torch_background.py hold the port's own cases of those layers)
PORT_FILE = {s: s.replace("test_", "test_torch_", 1) for s in SUITES}
PORT_FILE.update(test_background="test_torch_background_suite",
                 test_bitrot="test_torch_bitrot_suite")


def _helper_imports(name: str) -> set[str]:
    """Every module a reference suite imports from the test tree."""
    path = os.path.join(ROOT, "tests", f"{name}.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            top = node.module.split(".")[0]
            if top == "tests" or node.module.startswith("test_"):
                out.add(node.module)
        elif isinstance(node, ast.Import):
            out.update(a.name for a in node.names
                       if a.name.startswith(("tests.", "test_")))
    return out


@pytest.mark.parametrize("suite", SUITES)
def test_every_helper_import_is_mapped(suite):
    """A reference suite that took a helper from another test module would
    get the reference's server; each such import is mapped onto the
    port's (the conftest's markers are plain pytest)."""
    unmapped = _helper_imports(suite) - set(HELPERS) - {"tests.conftest"}
    assert unmapped == set(), unmapped


@pytest.mark.parametrize("suite", SUITES)
def test_every_suite_has_its_port_file(suite):
    path = os.path.join(ROOT, "tests", f"{PORT_FILE[suite]}.py")
    src = open(path, encoding="utf-8").read()
    assert f'load_port_suite("{suite}", globals(), REPLACED)' in src


@pytest.mark.parametrize("helper", sorted({n for _, names in HELPERS.values() for n in names.values()}
                                          | {"S3Client", "_free_port", "grid_app",
                                             "_free_port_block", "_wait_ready"}))
def test_mapped_helpers_are_the_ports(helper):
    obj = globals()[helper]
    mod = getattr(obj, "__module__", "") or ""
    assert not mod.startswith("minio_tpu."), (helper, mod)
    if helper == "S3Client":
        assert mod.startswith("minio_tpu_torch."), mod


def test_guard_sees_a_reference_server(tmp_path):
    """The guard's witness fails a case that builds the reference's
    server or spawns its module."""
    from minio_tpu.server.app import S3Server

    w = _Witness()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S3Server, "__init__", lambda self, *a, **kw: None)  # nothing started
        _watch_constructors(mp, w)
        S3Server(None)
        subprocess.run([sys.executable, "-c", "pass", "-m minio_tpu.server"], check=True)
    assert w.built == ["minio_tpu.server.app.S3Server"]
    assert len(w.spawned) == 1
    with pytest.raises(AssertionError, match="S3Server"):
        check_port_only(w)
    check_port_only(_Witness())  # a witness that saw nothing passes


__all__ = ["check_replaced", "load_port_suite"]
