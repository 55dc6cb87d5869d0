"""The harness that runs the JAX package's data-path suites against the
port, and the checks that keep it honest.

Each ``tests/test_torch_<suite>.py`` file is one reference suite
(``tests/test_<suite>.py``) run as written through
``tests.test_torch_analysis.load_reference_tests``: the module's imports
and strings pointed at ``minio_tpu_torch``, its test helpers mapped by
``HELPERS`` onto the port's (the reference's ``ServerThread`` is the
port's ``PortServerThread``, ``grid_app`` serves the port's grid on the
port's front, the worker-pool helpers start ``python -m
minio_tpu_torch.server``, ``requires_crypto`` is the conftest's marker),
and the reference's renamed APIs by ``RENAMED`` and ``NAMES``
(``TpuDispatcher`` is ``DeviceDispatcher``; ``rs_jax`` is a stand-in
whose ``get_tpu_codec`` is the port's torch codec). ``load_port_suite``
adds to each file:

- ``cpu_rung``: a module-scoped autouse fixture that puts the port on
  ``RUNG``, its CPU rung (``MINIO_TPU_BACKEND=torch``,
  ``MINIO_TPU_TORCH_DEVICE=cpu``; ``chip_smoke.py`` sets the card's),
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
(``check_replaced``); the reference's own body stays in the file's
``REFERENCE_CASES``, for a replacement that runs it unchanged
(``suite_backend``).
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import threading

import pytest

import chip_smoke
from minio_tpu_torch.client import S3Client  # noqa: F401 — a mapped helper
from minio_tpu_torch.server.nodes import free_port_block, wait_online
from tests.test_torch_analysis import ROOT, _ToPort, check_replaced, load_reference_tests

HERE = "tests.test_torch_suites"

# the reference suites' test-helper imports -> this module's port helpers
HELPERS = {
    "tests.test_s3_api": (HERE, {"ServerThread": "PortServerThread"}),
    "test_s3_api": (HERE, {"ServerThread": "PortServerThread"}),
    "tests.test_grid": (HERE, {}),
    "test_workers": (HERE, {}),
    "tests.conftest": (HERE, {}),
}

# the reference's renamed APIs: its dispatcher class, and its XLA codec
# module (one name of a statement, ``from minio_tpu.ops import rs, rs_jax``)
RENAMED = {"minio_tpu.parallel.dispatcher": ("minio_tpu_torch.parallel.dispatcher",
                                             {"TpuDispatcher": "DeviceDispatcher"})}
NAMES = {"minio_tpu.ops.rs_jax": (HERE, "rs_jax")}

# the port's CPU rung: its device route, with the kernels' plain versions
CPU_RUNG = {"MINIO_TPU_BACKEND": "torch", "MINIO_TPU_TORCH_DEVICE": "cpu"}
# the route the suites' cases run on: the CPU rung here; chip_smoke.py's
# suite phase sets the card's (the same backend, the device "cuda")
RUNG = dict(CPU_RUNG)


# what a pass of the port must not have touched
REFERENCE_SERVING = ("minio_tpu.server", "minio_tpu.cluster")

# each suite case's own limit
CASE_LIMIT_S = 300.0


# the reference's tests/conftest.requires_crypto, the one helper the suites
# take from there (the conftest imports the JAX package)
requires_crypto = pytest.mark.skipif(
    importlib.util.find_spec("cryptography") is None,
    reason="needs the optional 'cryptography' package (SSE / admin-wire encryption)",
)


class _RsJax:
    """The reference's ``minio_tpu.ops.rs_jax`` as its suites use it: the
    XLA codec's counterpart is the port's torch codec, on the device the
    port resolves (``MINIO_TPU_TORCH_DEVICE``)."""

    @staticmethod
    def get_tpu_codec(data_shards: int, parity_shards: int):
        from minio_tpu_torch.ops import rs_torch

        return rs_torch.get_torch_codec(data_shards, parity_shards)


rs_jax = _RsJax()


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


@contextlib.contextmanager
def suite_backend():
    """For a replaced case that runs the reference's body unchanged at the
    backend its suite sets at its top (``os.environ.setdefault(
    "MINIO_TPU_BACKEND", "numpy")``, the host plane): the CPU rung's plain
    HighwayHash cannot meet the case's wall-clock limit. On the card's
    route (``RUNG``'s device not the CPU) the card's route stays, and the
    kernels carry the case."""
    with pytest.MonkeyPatch.context() as mp:
        if RUNG["MINIO_TPU_TORCH_DEVICE"] == "cpu":
            mp.setenv("MINIO_TPU_BACKEND", "numpy")
        yield


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
            for k, v in RUNG.items():
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
    load_reference_tests(name, namespace, replaced, modules={**HELPERS, **RENAMED}, names=NAMES)
    namespace["cpu_rung"], namespace["case_time_limit"], namespace["port_only"] = _fixtures()


# -- the suites the port runs, and the harness's own checks -----------------

SUITES = ("test_chaos", "test_repair_plane", "test_zerocopy", "test_streaming_put",
          "test_inline_fastpath", "test_whole_file_bitrot", "test_erasure_set",
          "test_fault_injection", "test_multipart", "test_resume", "test_background",
          "test_bitrot", "test_cache",
          # the batching core, the second code family, the host data plane
          "test_dispatcher", "test_cauchy", "test_native", "test_dataplane",
          "test_checksums", "test_cache_segments", "test_lock_refresh", "test_storage",
          "test_metacache", "test_metacache_shards", "test_placement", "test_topology",
          "test_qos", "test_stress",
          # the S3 surface
          "test_s3_conformance", "test_s3_conformance2", "test_cors", "test_quota",
          "test_ops_breadth", "test_sse_compression", "test_madmin_wire",
          "test_metrics_v3", "test_obs",
          # IAM, STS and KMS
          "test_iam", "test_ldap_sts", "test_oidc_sts", "test_kms_api", "test_minkms",
          "test_etcd_iam", "test_sigv2_kes",
          # ILM, events, replication and Select
          "test_tiering", "test_warm_tiers", "test_events_ilm", "test_event_targets",
          "test_site_replication", "test_select", "test_select_sql")
# the port's file of each suite (test_torch_bitrot.py,
# test_torch_background.py and test_torch_cauchy.py hold the port's own
# cases of those layers)
PORT_FILE = {s: s.replace("test_", "test_torch_", 1) for s in SUITES}
PORT_FILE.update(test_background="test_torch_background_suite",
                 test_bitrot="test_torch_bitrot_suite",
                 test_cauchy="test_torch_cauchy_suite")


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
    unmapped = _helper_imports(suite) - set(HELPERS)
    assert unmapped == set(), unmapped


@pytest.mark.parametrize("suite", SUITES)
def test_every_suite_has_its_port_file(suite):
    path = os.path.join(ROOT, "tests", f"{PORT_FILE[suite]}.py")
    src = open(path, encoding="utf-8").read()
    assert f'load_port_suite("{suite}", globals(), REPLACED)' in src


@pytest.mark.parametrize("helper", sorted({n for _, names in HELPERS.values() for n in names.values()}
                                          | {"S3Client", "_free_port", "grid_app",
                                             "_free_port_block", "_wait_ready",
                                             "requires_crypto", "rs_jax"}))
def test_mapped_helpers_are_the_ports(helper):
    obj = globals()[helper]
    mod = getattr(obj, "__module__", "") or ""
    assert not mod.startswith("minio_tpu."), (helper, mod)
    if helper == "S3Client":
        assert mod.startswith("minio_tpu_torch."), mod


def _replaced(suite: str) -> set[str]:
    """The cases the suite's port file replaces (its ``REPLACED`` keys)."""
    return _replaced_in(os.path.join(ROOT, "tests", f"{PORT_FILE[suite]}.py"))


def _replaced_in(path: str) -> set[str]:
    """The ``REPLACED`` keys of the test file at ``path`` (none if it has none)."""
    for node in ast.parse(open(path, encoding="utf-8").read()).body:
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", "") == "REPLACED":
            return set(ast.literal_eval(node.value))
    return set()


def _imports(suite: str) -> list:
    """Every import statement of a reference suite that runs against the
    port: at module level, and in each case its port file does not
    replace."""
    path = os.path.join(ROOT, "tests", f"{suite}.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    skip = _replaced(suite)
    return [n for top in tree.body
            if not (isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef)) and top.name in skip)
            for n in ast.walk(top) if isinstance(n, (ast.Import, ast.ImportFrom))]


def _port_imports(suite: str) -> list:
    """``_imports`` as the loader rewrites them."""
    port = _ToPort({**HELPERS, **RENAMED}, NAMES)
    out = []
    for node in _imports(suite):
        new = port.visit(node)
        out.extend(new if isinstance(new, list) else [new])
    return out


@pytest.mark.parametrize("suite", SUITES)
def test_imports_resolve_to_the_port(suite, monkeypatch):
    """Every name a suite imports, at module level or in a case that runs
    as written, is the port's once the loader has rewritten it:
    ``rs_jax`` is the stand-in over the port's torch codec,
    ``TpuDispatcher`` the port's ``DeviceDispatcher``, and no module of
    the JAX package is reached."""
    from minio_tpu_torch.ops import rs_torch
    from minio_tpu_torch.parallel.dispatcher import DeviceDispatcher

    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")

    for node in _port_imports(suite):
        if isinstance(node, ast.Import):
            assert all(not a.name.startswith("minio_tpu.") and a.name != "minio_tpu"
                       for a in node.names), ast.unparse(node)
            continue
        assert node.module.split(".")[0] != "minio_tpu", ast.unparse(node)
        if node.module.split(".")[0] != "minio_tpu_torch" and node.module != HERE:
            continue  # the standard library and third parties
        mod = importlib.import_module(node.module)
        for a in node.names:
            obj = getattr(mod, a.name, None)
            if obj is None:
                obj = importlib.import_module(f"{node.module}.{a.name}")
            owner = getattr(obj, "__module__", None) or getattr(obj, "__name__", "")
            assert not str(owner).startswith("minio_tpu."), (ast.unparse(node), owner)
            bound = a.asname or a.name
            if bound == "rs_jax":
                assert obj is importlib.import_module(HERE).rs_jax
                assert obj.get_tpu_codec(4, 2) is rs_torch.get_torch_codec(4, 2)
            if bound == "TpuDispatcher":
                assert obj is DeviceDispatcher


def _split_imports() -> list:
    """(suite, statement) for each import that names a ``NAMES`` entry."""
    return [(suite, ast.unparse(node)) for suite in SUITES for node in _imports(suite)
            if isinstance(node, ast.ImportFrom)
            and any(f"{node.module}.{a.name}" in NAMES for a in node.names)]


@pytest.mark.parametrize("suite,statement", _split_imports())
def test_split_import_keeps_every_name_the_ports(suite, statement):
    """``from minio_tpu.ops import rs, rs_jax`` becomes two statements:
    ``rs_jax`` the stand-in, and ``rs`` still the port's own module."""
    tree = ast.fix_missing_locations(_ToPort({**HELPERS, **RENAMED}, NAMES).visit(
        ast.parse(statement)))
    ns: dict = {}
    exec(compile(tree, suite, "exec"), ns)
    names = [a.asname or a.name for a in ast.parse(statement).body[0].names]
    assert set(names) <= set(ns)
    for name in names:
        if name == "rs_jax":
            assert ns[name] is importlib.import_module(HERE).rs_jax
        else:
            assert ns[name] is importlib.import_module(f"minio_tpu_torch.ops.{name}")


@pytest.fixture(scope="module")
def loaded_alone():
    """Each suite loaded through ``load_port_suite`` in a fresh process
    (no conftest, no reference module imported before): the JAX package's
    modules each load brought in (dropped again after each, so the next
    suite's load would import them anew)."""
    code = (
        "import json, sys\n"
        "from tests.test_torch_suites import PORT_FILE, ROOT, SUITES, load_port_suite\n"
        "out = {}\n"
        "for s in SUITES:\n"
        "    load_port_suite(s, {'__name__': PORT_FILE[s],\n"
        "                        '__file__': f'{ROOT}/tests/{PORT_FILE[s]}.py'}, {})\n"
        "    out[s] = sorted(m for m in sys.modules\n"
        "                    if m == 'minio_tpu' or m.startswith('minio_tpu.'))\n"
        "    for m in out[s]:\n"
        "        del sys.modules[m]\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, **CPU_RUNG)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("suite", SUITES)
def test_loading_a_suite_imports_nothing_of_the_jax_package(loaded_alone, suite):
    """A suite with no analyzer entry point builds no ``Both`` (which
    imports the reference's analyzer), so the card's host, which has no
    JAX, can load it."""
    assert loaded_alone[suite] == []


# -- chip_smoke.py's suite phase: what it runs on the card ------------------

_COLLECT = """
import json, sys
import pytest

class Items:
    found = {}

    def pytest_collection_modifyitems(self, items):
        for it in items:
            self.found[it.nodeid] = it.function.__code__.co_filename

items = Items()
rc = pytest.main(["--collect-only", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                  "--noconftest", "-W", "ignore::pytest.PytestUnknownMarkWarning"]
                 + sys.argv[1:], plugins=[items])
print(json.dumps({"rc": int(rc), "items": items.found}))
"""


@pytest.fixture(scope="module")
def smoke_collected():
    """Every case of ``chip_smoke.SUITE_CASES``, collected as the smoke's
    suite phase collects them (``--noconftest``, in one pytest session):
    node id -> the file its function was compiled from."""
    files = sorted({c.split("::")[0] for c in chip_smoke.SUITE_CASES})
    r = subprocess.run([sys.executable, "-c", _COLLECT] + [f"tests/{f}" for f in files],
                       cwd=ROOT, env=dict(os.environ, **CPU_RUNG), capture_output=True,
                       text=True, timeout=300)
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return out["items"]


@pytest.mark.parametrize("entry", chip_smoke.SUITE_CASES)
def test_smoke_suite_case_is_collected(smoke_collected, entry):
    """Each entry of the smoke's suite phase names a file that exists and
    a case that pytest collects there (a whole file: at least one case),
    so a renamed case fails here instead of dropping out of the card's
    run; and a reference case the file's ``REPLACED`` swapped out runs
    only as the port's version."""
    path, _, case = entry.partition("::")
    here = os.path.join(ROOT, "tests", path)
    assert os.path.exists(here), entry
    got = {nid: src for nid, src in smoke_collected.items()
           if chip_smoke.suite_entry_runs(entry, nid)}
    assert got, f"{entry} is not collected"
    replaced = _replaced_in(here)
    for nid, src in got.items():
        if nid.split("::")[1].split("[")[0] in replaced:
            assert src == here, f"{nid} runs the reference's body ({src})"


@pytest.mark.parametrize("entry", chip_smoke.SUITE_IDLE)
def test_smoke_idle_case_is_one_it_runs(smoke_collected, entry):
    """A case the suite phase lets launch no kernel is one it runs."""
    assert any(chip_smoke.suite_entry_runs(e, f"tests/{entry}") for e in chip_smoke.SUITE_CASES)
    assert f"tests/{entry}" in smoke_collected


def _dispatcher_stats(**moved) -> tuple[dict, dict]:
    """A dispatcher's fault and ladder counters before and after a phase."""
    s0 = dict.fromkeys((*chip_smoke.SUITE_FAULTS, "promotions", "probes"), 3)
    return s0, {k: v + moved.get(k, 0) for k, v in s0.items()}


@pytest.mark.parametrize("case", [None, "tests/test_torch_chaos.py::test_tpu_slow_batch_injection",
                                  "tests/test_torch_erasure_set.py::test_range_reads"])
@pytest.mark.parametrize("counter", ["fused_failures", "device_faults", "demotions"])
def test_smoke_refuses_a_fault_outside_the_ladder_case(case, counter):
    assert chip_smoke.suite_faults(case, *_dispatcher_stats()) == []
    assert chip_smoke.suite_faults(case, *_dispatcher_stats(**{counter: 1})) == [
        f"{counter} moved by 1"]


def test_smoke_ladder_case_must_walk_the_ladder():
    """The ladder case's dispatchers must show what the case asserts: two
    device faults or more, one demotion, a probe and a promotion, and no
    fused-kernel failure; a ladder that demoted and never promoted fails."""
    case = chip_smoke.LADDER_CASE
    walked = {"device_faults": 3, "demotions": 1, "promotions": 1, "probes": 2}
    assert chip_smoke.suite_faults(case, *_dispatcher_stats(**walked)) == []
    assert chip_smoke.suite_faults(case, *_dispatcher_stats(**dict(walked, promotions=0))) == [
        "promotions moved by 0"]
    assert chip_smoke.suite_faults(case, *_dispatcher_stats(**dict(walked, fused_failures=1))) == [
        "fused_failures moved by 1"]
    assert len(chip_smoke.suite_faults(case, *_dispatcher_stats())) == 4  # never walked
    assert any(chip_smoke.suite_entry_runs(e, case) for e in chip_smoke.SUITE_CASES)


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
