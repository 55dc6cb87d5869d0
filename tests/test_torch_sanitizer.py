"""The port's runtime sanitizer (``minio_tpu_torch/analysis/sanitizer.py``):
the JAX package's cases (``tests/test_sanitizer.py``) against the port's
witnesses, then what is the port's own: it installs beside the reference
package's sanitizer (which the test process may have installed) and
leaves ``threading`` as it found it; its ids are ``minio_tpu_torch``-
relative; and a sanitized node, in process and through ``python -m
minio_tpu_torch.server``, answers ``sanitizer/status``, ``healthinfo`` and
``/minio/metrics/v3/api/sanitizer``.
"""

from __future__ import annotations

import gc
import json
import os
import re
import threading

import pytest

from minio_tpu_torch.analysis import sanitizer as port_sanitizer
from tests.test_torch_analysis import DOCS, check_replaced, load_reference_tests
from tests.test_torch_cluster import node_env

REPLACED: dict[str, str] = {}
load_reference_tests("test_sanitizer", globals(), REPLACED)


@pytest.fixture(autouse=True)
def port_witness():
    """The port's lock witness around each case (the reference's cases
    expect one installed, as the JAX package's conftest installs its
    own); whatever ``threading`` held before comes back after."""
    before = (threading.Lock, threading.RLock)
    port_sanitizer.install()
    yield
    port_sanitizer.uninstall()
    port_sanitizer.load_static_order()
    assert (threading.Lock, threading.RLock) == before


def test_reference_cases_have_counterparts():
    check_replaced(globals(), REPLACED, __file__)


# -- installing beside another sanitizer --------------------------------------


def test_install_under_the_reference_restores_its_factories():
    from minio_tpu.analysis import sanitizer as ref_sanitizer

    port_sanitizer.uninstall()
    ref_was = ref_sanitizer._installed
    ref_sanitizer.install()
    try:
        ref_lock, ref_rlock = threading.Lock, threading.RLock
        port_sanitizer.install()
        assert threading.Lock is not ref_lock
        # the raw allocators, never the reference's wrapping factory
        assert port_sanitizer._real_lock is ref_sanitizer._real_lock
        assert threading.Lock.__wrapped__ is ref_sanitizer._real_lock
        port_sanitizer.uninstall()
        assert (threading.Lock, threading.RLock) == (ref_lock, ref_rlock)
    finally:
        if not ref_was:
            ref_sanitizer.uninstall()
        port_sanitizer.install()


def test_uninstall_without_install_changes_nothing():
    port_sanitizer.uninstall()
    before = (threading.Lock, threading.RLock)
    port_sanitizer.uninstall()
    assert (threading.Lock, threading.RLock) == before
    port_sanitizer.install()


def test_reference_locks_keep_the_reference_witness():
    from minio_tpu.analysis import sanitizer as ref_sanitizer
    from minio_tpu.qos.lastminute import LastMinuteLatency as RefLatency
    from minio_tpu_torch.qos.lastminute import LastMinuteLatency

    port = LastMinuteLatency()
    assert isinstance(port._mu, port_sanitizer.SanitizedLock)
    assert port._mu.lock_id == "qos.lastminute.LastMinuteLatency._mu"
    ref = RefLatency()
    # a lock of the JAX package is the other sanitizer's business: the
    # port's factory hands it to the factory it replaced
    assert not isinstance(ref._mu, port_sanitizer.SanitizedLock)
    if ref_sanitizer._installed:
        assert isinstance(ref._mu, ref_sanitizer.SanitizedLock)
        assert ref._mu.lock_id == "qos.lastminute.LastMinuteLatency._mu"


@pytest.mark.parametrize("module,cls,attr", [
    ("erasure.bufpool", "BufferPool", "_lock"),
    ("server.metrics", "TracePubSub", "_mu"),
    ("qos.lastminute", "LastMinuteLatency", "_mu"),
])
def test_port_locks_get_package_relative_ids(module, cls, attr):
    import importlib

    mod = importlib.import_module(f"minio_tpu_torch.{module}")
    lk = getattr(getattr(mod, cls)(), attr)
    assert isinstance(lk, port_sanitizer.SanitizedLock)
    assert lk.lock_id == f"{module}.{cls}.{attr}"
    assert lk.lock_id in port_sanitizer._ranks


def _lock_from(path, monkeypatch, pkg_dir):
    monkeypatch.setattr(port_sanitizer, "_PKG_DIR", str(pkg_dir))
    monkeypatch.setattr(port_sanitizer, "_PKG_PREFIX", str(pkg_dir) + os.sep)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("sibling_mu = threading.Lock()\n")  # the id reads the line
    ns: dict = {"threading": threading}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    return ns["sibling_mu"]


def test_sibling_directory_with_the_packages_prefix_is_not_wrapped(tmp_path, monkeypatch):
    pkg = tmp_path / "minio_tpu_torch"
    inside = _lock_from(pkg / "cache" / "mod.py", monkeypatch, pkg)
    assert isinstance(inside, port_sanitizer.SanitizedLock)
    assert inside.lock_id == "cache.mod.sibling_mu"
    outside = _lock_from(tmp_path / "minio_tpu_torch_x" / "mod.py", monkeypatch, pkg)
    assert not isinstance(outside, port_sanitizer.SanitizedLock)


def test_static_order_is_the_ports_generated_table():
    assert port_sanitizer.load_static_order()
    with open(os.path.join(DOCS, "LOCK_ORDER.md"), encoding="utf-8") as fh:
        ranks = re.findall(r"^\|\s*\d+\s*\|\s*`([^`]+)`", fh.read(), re.M)
    assert ranks and set(port_sanitizer._ranks) == set(ranks)
    assert len(port_sanitizer._ranks) == len(ranks)


def test_access_witness_builds_port_module_names():
    import minio_tpu_torch.cluster.grid  # noqa: F401

    try:
        assert port_sanitizer.arm_access_witness() >= 1
        cls, name, _ = port_sanitizer._WATCHED["cluster.grid.GridClient._calls"]
        assert cls.__module__ == "minio_tpu_torch.cluster.grid" and name == "_calls"
    finally:
        port_sanitizer.disarm_access_witness()


def test_leak_table_names_the_ports_classes():
    import minio_tpu_torch.erasure.set  # noqa: F401
    import minio_tpu_torch.server.sftp  # noqa: F401

    try:
        assert port_sanitizer.arm_leak_witness() >= 2
        assert {"minio_tpu_torch.erasure.set.ObjectHandle",
                "minio_tpu_torch.server.sftp._WriteHandle"} <= set(port_sanitizer.leak_classes())
        assert all(m.startswith("minio_tpu_torch.") for m, *_ in port_sanitizer._LEAK_TABLE)
    finally:
        port_sanitizer.disarm_leak_witness()


# -- violations reach the counters the node serves ------------------------------


def _scrape_in_process() -> str:
    from minio_tpu_torch.server import metrics

    return "".join(metrics._g_api_sanitizer(None))


def test_seeded_lock_order_inversion_raises_its_counter():
    port_sanitizer.configure_order(["t.A", "t.B"], {"t.A": ["t.B"]})
    before = port_sanitizer.status()["violations"].get("lock.order", 0)
    try:
        raw = port_sanitizer._real_lock
        la = port_sanitizer.SanitizedLock(raw(), "t.A")
        lb = port_sanitizer.SanitizedLock(raw(), "t.B")
        with lb, la:
            pass
    finally:
        port_sanitizer.load_static_order()
    assert port_sanitizer.status()["violations"]["lock.order"] == before + 1
    assert f'minio_sanitizer_violations_total{{kind="lock.order"}} {before + 1}' in _scrape_in_process()


def test_leaked_object_handle_raises_its_counter():
    import minio_tpu_torch.erasure.set as set_mod

    class _Mutex:
        def runlock(self):
            pass

    try:
        port_sanitizer.arm_leak_witness()
        before = port_sanitizer.status()["violations"].get("resource.leak", 0)
        h = set_mod.ObjectHandle(None, "bkt", "obj", None, [], mutex=_Mutex())
        del h
        gc.collect()
        assert port_sanitizer.status()["violations"]["resource.leak"] == before + 1
        assert 'minio_sanitizer_violations_total{kind="resource.leak"}' in _scrape_in_process()
    finally:
        port_sanitizer.disarm_leak_witness()


def test_bufpool_lease_violation_reports_through_the_sanitizer():
    from minio_tpu_torch.erasure.bufpool import BufferPool

    pool = BufferPool()
    before = port_sanitizer.status()["violations"].get("pool.lease-violation", 0)
    lease = pool.acquire(4096)
    lease.release()
    lease.release()  # a dead lease: the violation hook fires
    assert port_sanitizer.status()["violations"]["pool.lease-violation"] == before + 1
    assert pool.stats_snapshot()["violations"] == 1


def test_metrics_group_has_the_reference_series():
    from minio_tpu.server import metrics as ref_metrics

    def names(text):
        return sorted(set(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M)))

    assert names(_scrape_in_process()) == names("".join(ref_metrics._g_api_sanitizer(None)))


def test_status_has_the_reference_keys():
    from minio_tpu.analysis import sanitizer as ref_sanitizer

    assert set(port_sanitizer.status()) == set(ref_sanitizer.status())


# -- a sanitized node through main() ------------------------------------------------


@pytest.fixture(scope="module")
def sanitized_node(tmp_path_factory):
    from minio_tpu_torch.client import S3Client
    from minio_tpu_torch.server.nodes import free_ports, spawn, stop_all, wait_online

    base = tmp_path_factory.mktemp("sanitized")
    port = free_ports(1)[0]
    log = base / "node.log"
    env = node_env(MINIO_TPU_SANITIZE="1", MINIO_PROMETHEUS_AUTH_TYPE="public")
    proc = spawn(port, [base / f"d{i}" for i in range(4)], env, log)
    cli = S3Client(f"127.0.0.1:{port}")
    try:
        wait_online([cli], [proc])
        assert cli.make_bucket("sanbkt").status == 200
        assert cli.put_object("sanbkt", "obj", os.urandom(3 << 20)).status == 200
        assert cli.get_object("sanbkt", "obj").status == 200
        yield {"cli": cli, "proc": proc, "log": log}
    finally:
        stop_all([proc])


def _log(node) -> str:
    return node["log"].read_text(errors="replace")


def test_sanitized_node_prints_its_witnesses(sanitized_node):
    log = _log(sanitized_node)
    m = re.search(r"^sanitizer: access witness armed on (\d+) attributes$", log, re.M)
    assert m and int(m.group(1)) > 0, log
    m = re.search(r"^sanitizer: leak witness armed on (\d+) resource classes$", log, re.M)
    assert m and int(m.group(1)) >= 1, log
    assert "object layer online" in log


def test_sanitized_node_answers_status(sanitized_node):
    r = sanitized_node["cli"].admin("GET", "sanitizer/status")
    assert r.status == 200, r.body
    st = json.loads(r.body)
    from minio_tpu.analysis import sanitizer as ref_sanitizer

    assert set(st) == set(ref_sanitizer.status())
    assert st["enabled"] is True and st["lockWitnessInstalled"] is True
    with open(os.path.join(DOCS, "LOCK_ORDER.md"), encoding="utf-8") as fh:
        ranks = len(re.findall(r"^\|\s*\d+\s*\|", fh.read(), re.M))
    assert st["staticLockRanks"] == ranks > 0
    assert st["witnessedAttrs"] and "minio_tpu_torch.erasure.set.ObjectHandle" in st["leakClasses"]
    bad = {k: v for k, v in st["violations"].items() if k != "loop.stall"}
    assert bad == {}, st["recent"]


def test_sanitized_node_scrape_agrees_with_status(sanitized_node):
    cli = sanitized_node["cli"]
    r = cli.request("GET", "/minio/metrics/v3/api/sanitizer")
    assert r.status == 200, r.body
    text = r.body.decode()
    st = json.loads(cli.admin("GET", "sanitizer/status").body)

    def value(name):
        m = re.search(rf"^{name} (\S+)$", text, re.M)
        return float(m.group(1))

    assert value("minio_sanitizer_enabled") == 1
    assert value("minio_sanitizer_static_lock_ranks") == st["staticLockRanks"]
    assert value("minio_sanitizer_witnessed_attributes") == len(st["witnessedAttrs"])
    assert value("minio_sanitizer_loop_stall_episodes_total") == st["stallEpisodes"]


def test_sanitized_node_answers_healthinfo(sanitized_node):
    cli = sanitized_node["cli"]
    r = cli.admin("GET", "healthinfo")
    assert r.status == 200, r.body
    info = json.loads(r.body)
    for key in ("time", "version", "hardware", "knobsNonDefault", "topology", "storage",
                "poolFill", "breakers", "sanitizer", "faults", "selftest"):
        assert key in info, key
    assert info["sanitizer"]["enabled"] is True
    knobs = {k["name"]: k for k in info["knobsNonDefault"]}
    # the port's registry: numpy differs from the port's default, torch
    assert knobs["MINIO_TPU_BACKEND"]["default"] == "torch"
    assert knobs["MINIO_TPU_TORCH_DEVICE"]["value"] == "cpu"


def test_sanitized_node_stops_cleanly(sanitized_node):
    import signal

    proc = sanitized_node["proc"]
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=30) == 0
    assert "Traceback" not in _log(sanitized_node)
