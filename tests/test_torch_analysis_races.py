"""The races pass and the guarded-by table of the port's miniovet: the
JAX package's cases (``tests/test_analysis_races.py``), fixtures through
both analyzers (``test_torch_analysis.Both``), the table's facts on the
port's own tree, and the triage regressions against the port's classes."""

import threading

import pytest

from tests.test_torch_analysis import check_replaced, load_reference_tests

REPLACED = {
    "test_dispatcher_stats_snapshot_consistent_under_load":
        "the reference drives its TpuDispatcher over the JAX codec; the port's "
        "DeviceDispatcher runs over the torch codec (the plain versions on "
        "the CPU)",
}
BOTH = load_reference_tests("test_analysis_races", globals(), REPLACED)


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")


def test_dispatcher_stats_snapshot_consistent_under_load(cpu_device):
    """parallel/dispatcher.py triage: stats mutate under _cv and
    observers read consistent snapshots — a scrape racing a dispatch
    must never see torn histograms or lose blocks."""
    import numpy as np

    from minio_tpu_torch.ops import rs_torch
    from minio_tpu_torch.parallel.dispatcher import QUEUE_WAIT_BUCKETS, DeviceDispatcher

    codec = rs_torch.get_torch_codec(4, 2, "cpu")
    disp = DeviceDispatcher(codec, 256, window_s=0.0)
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 256, size=(1, 4, 256), dtype=np.uint8)
    disp.encode(blocks)  # warm

    stop = threading.Event()
    torn: list = []

    def scraper():
        while not stop.is_set():
            snap = disp.stats_snapshot()
            if len(snap["queue_wait_hist"]) != len(QUEUE_WAIT_BUCKETS) + 1:
                torn.append(snap)
            if snap["blocks"] < 0 or snap["dispatches"] < 0:
                torn.append(snap)

    threads = [threading.Thread(target=scraper) for _ in range(3)]
    for t in threads:
        t.start()
    total = 0
    for _ in range(40):
        disp.encode(blocks)
        total += 1
    stop.set()
    for t in threads:
        t.join()
    assert torn == []
    snap = disp.stats_snapshot()
    assert snap["blocks"] >= total
    # the snapshot is a COPY: mutating it must not poison live stats
    snap["queue_wait_hist"][0] = -999
    assert disp.stats["queue_wait_hist"][0] != -999


def test_reference_cases_have_counterparts():
    check_replaced(globals(), REPLACED, __file__)


def test_fixture_cases_went_through_both_analyzers():
    assert BOTH.calls >= 15
