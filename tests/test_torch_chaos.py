"""The reference's ``tests/test_chaos.py``, run as written against the port
(``tests/test_torch_suites.py``)."""

import time

import numpy as np

from tests.test_torch_suites import check_replaced, load_port_suite

REPLACED: dict[str, str] = {
    "test_backend_degradation_round_trip":
        "builds the reference's TpuDispatcher over minio_tpu.ops.rs_jax, which has no "
        "counterpart in the port; the port's case drives the same ladder through "
        "DeviceDispatcher over the torch codec",
    "test_tpu_slow_batch_injection":
        "builds the reference's TpuDispatcher over minio_tpu.ops.rs_jax; the port's case "
        "injects the same slow batch into DeviceDispatcher over the torch codec",
}

load_port_suite("test_chaos", globals(), REPLACED)


def test_replaced_cases_are_the_ports():
    check_replaced(globals(), REPLACED, __file__)


def test_backend_degradation_round_trip(monkeypatch):
    """Injected device faults -> the dispatcher serves every batch degraded
    (byte-identical to the device route), demotes to the numpy rung past
    the threshold, and re-promotes through a probe batch once the faults
    clear: the reference's case on the port's dispatcher and codec."""
    from minio_tpu_torch import fault
    from minio_tpu_torch.ops import rs_torch
    from minio_tpu_torch.parallel.dispatcher import LEVEL_NUMPY, DeviceDispatcher

    monkeypatch.setenv("MINIO_TPU_BACKEND_DEMOTE_FAULTS", "2")
    monkeypatch.setenv("MINIO_TPU_BACKEND_PROBE_AFTER", "2")
    codec = rs_torch.get_torch_codec(4, 2)
    disp = DeviceDispatcher(codec, 1024, window_s=0.0)
    blocks = np.random.default_rng(7).integers(0, 256, size=(2, 4, 1024), dtype=np.uint8)
    base_shards, base_digests = disp.encode(blocks)
    assert disp.stats["backend_level"] > LEVEL_NUMPY

    fault.inject({"boundary": "tpu", "mode": "device-lost", "seed": 5})
    try:
        for _ in range(3):
            shards, digests = disp.encode(blocks)
            np.testing.assert_array_equal(shards, base_shards)
            np.testing.assert_array_equal(digests, base_digests)
    finally:
        fault.clear()
    assert disp.stats["backend_level"] == LEVEL_NUMPY
    assert disp.stats["demotions"] == 1
    assert disp.stats["device_faults"] >= 2
    assert disp.stats["numpy_blocks"] >= 2

    promoted = False
    for _ in range(6):
        shards, digests = disp.encode(blocks)
        np.testing.assert_array_equal(shards, base_shards)
        np.testing.assert_array_equal(digests, base_digests)
        if disp.stats["backend_level"] > LEVEL_NUMPY:
            promoted = True
            break
    assert promoted, "probe batches never re-promoted the device backend"
    assert disp.stats["promotions"] >= 1
    assert disp.stats["probes"] >= 1


def test_tpu_slow_batch_injection():
    """slow-batch stalls a dispatch without failing it or demoting."""
    from minio_tpu_torch import fault
    from minio_tpu_torch.ops import rs_torch
    from minio_tpu_torch.parallel.dispatcher import DeviceDispatcher

    disp = DeviceDispatcher(rs_torch.get_torch_codec(4, 2), 512, window_s=0.0)
    blocks = np.zeros((1, 4, 512), dtype=np.uint8)
    disp.encode(blocks)
    fault.inject({"boundary": "tpu", "mode": "slow-batch", "latency_ms": 120,
                  "count": 1, "seed": 2})
    try:
        t0 = time.monotonic()
        disp.encode(blocks)
        assert time.monotonic() - t0 >= 0.1
    finally:
        fault.clear()
    assert disp.stats["demotions"] == 0

