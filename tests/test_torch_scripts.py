"""The port's scripts (minio_tpu_torch/scripts/) against the repository's
``scripts/``: the surface harvest gives the reference script's result on
the same reference tree, the port's regeneration writes only its own
vendored copy, and the diag smoke passes against a pool of the port's
server on the CPU rung."""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

from minio_tpu_torch.scripts import diag_smoke, gen_reference_surface as port_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIAG_SMOKE_LIMIT_S = 120  # a 2-worker pool's start and the diag surface, on the CPU


def _reference_script():
    """The reference's functions, without ever running its ``main`` (which
    rewrites the JAX package's vendored surface)."""
    path = os.path.join(ROOT, "scripts", "gen_reference_surface.py")
    spec = importlib.util.spec_from_file_location("_ref_gen_reference_surface", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


METRICS_API = '''package cmd
const (
    apiRequestsTotal = "requests_total"
)
var apiRequestsTotalMD = NewCounterMD("minio_api_requests_total", "Total S3 requests")
var apiTTFB = NewHistogramMD("minio_api_requests_ttfb_seconds_distribution", "")
var x = "not_a_series"
'''
METRICS_SYSTEM = '''package cmd
var a = NewGaugeMD("minio_system_memory_used", "")
var b = NewGaugeMD("minio_system_drive_used_bytes", "")
var c = NewGaugeMD("minio_system_drive_free_inodes", "")
'''
METRICS_CLUSTER = '''package cmd
var h = NewGaugeMD("minio_cluster_health_status", "")
var e = NewGaugeMD("minio_cluster_erasure_set_overall_write_quorum", "")
'''
ADMIN_ROUTER = '''package cmd
func registerAdminRouter() {
    adminRouter.Methods(http.MethodPost).Path(adminVersion + "/speedtest")
    adminRouter.Methods(http.MethodPost).Path(adminVersion + "/speedtest/drive")
    adminRouter.Methods(http.MethodGet).Path(adminAPIVersionPrefix + "/healthinfo")
    adminRouter.Methods(http.MethodGet).Path(adminVersion + "/trace")
    adminRouter.Methods(http.MethodGet).Path(adminVersion + "/list-users")
}
'''


@pytest.fixture()
def reference_tree(tmp_path):
    cmd = tmp_path / "ref" / "cmd"
    cmd.mkdir(parents=True)
    (cmd / "metrics-v3-api-requests.go").write_text(METRICS_API)
    (cmd / "metrics-v3-system-memory.go").write_text(METRICS_SYSTEM)
    (cmd / "metrics-v3-cluster-health.go").write_text(METRICS_CLUSTER)
    (cmd / "metrics-v3-types.go").write_text(METRICS_API)  # no group: skipped
    (cmd / "admin-router.go").write_text(ADMIN_ROUTER)
    return str(tmp_path / "ref")


def test_harvest_matches_the_reference_script(reference_tree):
    ref = _reference_script()
    got = port_gen.harvest(reference_tree)
    assert got == ref.harvest(reference_tree)
    assert got["drive"] == {"minio_system_drive_used_bytes", "minio_system_drive_free_inodes"}
    assert got["api"] == {"minio_api_requests_total",
                          "minio_api_requests_ttfb_seconds_distribution"}
    ops = port_gen.harvest_admin_ops(reference_tree)
    assert ops == ref.harvest_admin_ops(reference_tree)
    assert ops == {"speedtest", "speedtest/drive", "healthinfo", "trace"}


def test_without_a_reference_tree_nothing_is_harvested(tmp_path):
    ref = _reference_script()
    missing = str(tmp_path / "absent")
    assert port_gen.harvest(missing) is None and ref.harvest(missing) is None
    assert port_gen.harvest_admin_ops(missing) == ref.harvest_admin_ops(missing) == set()


def test_the_port_writes_its_own_vendored_copy(reference_tree, tmp_path, monkeypatch):
    assert port_gen.VENDORED == os.path.join(ROOT, "minio_tpu_torch", "analysis",
                                             "reference_surface.json")
    vendored = tmp_path / "reference_surface.json"
    shutil.copyfile(port_gen.VENDORED, vendored)
    monkeypatch.setattr(port_gen, "VENDORED", str(vendored))
    before = json.loads(vendored.read_text())

    for argv in ([], [str(tmp_path / "absent")]):  # no tree given, or none there
        monkeypatch.setattr(sys, "argv", ["gen_reference_surface", *argv])
        assert port_gen.main() == 0
        assert json.loads(vendored.read_text()) == before  # untouched

    monkeypatch.setattr(sys, "argv", ["gen_reference_surface", reference_tree])
    assert port_gen.main() == 0
    after = json.loads(vendored.read_text())
    want = _reference_script().harvest(reference_tree)
    for group, names in want.items():
        assert after["groups"][group] == sorted(names)
    assert after["admin_groups"]["diagnostics"] == sorted(
        port_gen.harvest_admin_ops(reference_tree))
    assert {k: v for k, v in after.items() if k not in ("groups", "admin_groups")} == \
        {k: v for k, v in before.items() if k not in ("groups", "admin_groups")}


def test_declared_diag_series_are_the_ports():
    names = diag_smoke.declared_diag_series()
    assert names and all(n.startswith("minio_") for n in names)


def test_diag_smoke_passes_against_a_cpu_rung_pool(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("MINIO_")}
    env.update(MINIO_TPU_TORCH_DEVICE="cpu", PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "minio_tpu_torch.scripts.diag_smoke"],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=DIAG_SMOKE_LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("diag-smoke: PASS")
    assert not any(p.name.startswith("diag-smoke-") for p in tmp_path.iterdir())


def test_diag_smoke_fails_when_the_pool_cannot_start(tmp_path):
    # no card and no CPU rung asked for: the node refuses to start, and
    # the smoke says so with a non-zero exit
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the pool would start")
    env = {k: v for k, v in os.environ.items() if not k.startswith("MINIO_")}
    env.update(PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "minio_tpu_torch.scripts.diag_smoke"],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=DIAG_SMOKE_LIMIT_S)
    assert proc.returncode != 0
    assert "diag-smoke: FAIL: pool did not come online" in proc.stderr
    assert "PASS" not in proc.stdout
