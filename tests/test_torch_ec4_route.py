"""The dispatcher's device route for MinIO's default 16-drive set, EC:4
(12 data + 4 parity shards of 87,382 bytes a 1 MiB block), on the CPU
device: the fused kernel refuses d > 8, so the bit-plane matrix (K3 on
the card) and the chain kernel serve it (their plain versions here).

Each batch leaves the same device phases in the span ring as the fused
route (``dispatch.h2d``, ``dispatch.kernels``, ``dispatch.d2h``), and its
``dispatch.batch`` row names the route that served it; the shard files
the batch hands back are the NumPy reference's (``s3bench/reference.py``)
byte for byte. The numpy rung stamps no device phase.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

from minio_tpu_torch import obs
from minio_tpu_torch.fault import registry as fault_registry
from minio_tpu_torch.server.metrics import TracePubSub

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from s3bench import reference  # noqa: E402

D, P = 12, 4
N = reference.shard_size(reference.BLOCK_SIZE, D)  # 87,382
PHASES = ("dispatch.assemble", "dispatch.h2d", "dispatch.kernels", "dispatch.d2h",
          "dispatch.results")


@pytest.fixture()
def ring(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")
    prev = obs.publisher()
    pub = TracePubSub(ring=obs.SpanRing(4096))
    obs.set_publisher(pub)
    yield pub.ring
    obs.set_publisher(prev)


def _objects(seed: int, count: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, reference.BLOCK_SIZE, np.uint8).tobytes()
            for _ in range(count)]


def _blocks(objects: list[bytes]) -> np.ndarray:
    """[B, 12, 87,382]: each 1 MiB object split into its data shards,
    the last one padded with zeros, as the erasure layer splits it."""
    out = np.zeros((len(objects), D * N), dtype=np.uint8)
    for i, o in enumerate(objects):
        out[i, :len(o)] = np.frombuffer(o, dtype=np.uint8)
    return out.reshape(len(objects), D, N)


def _dispatcher(codec):
    from minio_tpu_torch.parallel.dispatcher import DeviceDispatcher

    return DeviceDispatcher(codec, N, window_s=0.05)


def _batches(ring, count: int) -> list:
    """The ring's ``dispatch.batch`` rows, once ``count`` batches have
    written their last phase."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        kept = ring.snapshot()[0]
        if sum(s.name == "dispatch.results" for s in kept) >= count:
            return [s for s in kept if s.name == "dispatch.batch"]
        time.sleep(0.01)
    raise AssertionError("the dispatcher wrote no finished batch")


def _phases(ring, batch) -> list[str]:
    """The names of the batch's children, each inside the batch, in
    time order, one after the other."""
    kids = sorted((s for s in ring.snapshot()[0] if s.parent_id == batch.span_id),
                  key=lambda s: s.start_ns)
    assert kids[0].start_ns == batch.start_ns and kids[-1].end_ns == batch.end_ns
    assert all(x.end_ns <= y.start_ns for x, y in zip(kids, kids[1:]))
    assert all(x.start_ns <= x.end_ns for x in kids)
    return [s.name for s in kids]


def _one_batch(disp, blocks: np.ndarray, codec=None):
    """Submit every block as one entry and wait for the batch."""
    return disp.submit(blocks, codec=codec).result(timeout=120)


@pytest.mark.parametrize("b", [1, 3, 4])
def test_bitplane_route_stamps_the_device_phases(ring, b):
    from minio_tpu_torch.ops import fused_cuda, rs_torch

    assert not fused_cuda.supports(D, P, 16, N)  # so the bit-plane route serves
    objects = _objects(2 ** 31 + b, b)
    disp = _dispatcher(rs_torch.get_torch_codec(D, P))
    shards, digests = _one_batch(disp, _blocks(objects))
    (batch,) = _batches(ring, 1)
    assert batch.label == "bitplane"
    assert _phases(ring, batch) == list(PHASES)
    # B = 3 pads to the power-of-two bucket of 4
    assert disp.stats["pad_blocks"] == {1: 0, 3: 1, 4: 0}[b]
    assert disp.stats["numpy_blocks"] == 0 and disp.stats["fused"] == 0
    # every drive's shard file: the digest, then the shard
    for j, obj in enumerate(objects):
        got = [digests[j, i].tobytes() + shards[j, i].tobytes() for i in range(D + P)]
        assert got == reference.shard_files(obj, D, P)


def test_cauchy_route_stamps_the_device_phases(ring):
    from minio_tpu_torch.erasure.coder import encode_blocks_numpy
    from minio_tpu_torch.ops import cauchy, rs_torch

    codec = cauchy.get_torch_codec(D, P)
    assert codec.family == "cauchy"
    blocks = _blocks(_objects(7, 3))
    disp = _dispatcher(rs_torch.get_torch_codec(D, P))
    shards, digests = _one_batch(disp, blocks, codec)
    (batch,) = _batches(ring, 1)
    assert batch.label == "cauchy"
    assert _phases(ring, batch) == list(PHASES)
    want_shards, want_digests = encode_blocks_numpy(cauchy.get_codec(D, P), blocks, "cauchy")
    assert np.array_equal(shards, want_shards) and np.array_equal(digests, want_digests)


@pytest.mark.parametrize("how", ["demoted", "device-lost"])
def test_numpy_rung_stamps_no_device_phase(ring, how):
    """The numpy rung serves the batch, byte-identical, and the ring shows
    none of the device route's phases: on a dispatcher already demoted to
    it, and after an injected device loss at the dispatch."""
    from minio_tpu_torch.ops import rs_torch
    from minio_tpu_torch.parallel.dispatcher import LEVEL_NUMPY

    objects = _objects(11, 2)
    disp = _dispatcher(rs_torch.get_torch_codec(D, P))
    if how == "demoted":
        with disp._cv:
            disp.stats["backend_level"] = LEVEL_NUMPY
        disp._probe_countdown = 10 ** 6
    else:
        fault_registry.inject({"boundary": "tpu", "mode": "device-lost",
                               "target": f"{D}+{P}", "op": "dispatch", "count": 1})
    try:
        shards, digests = _one_batch(disp, _blocks(objects))
    finally:
        fault_registry.clear()
    (batch,) = _batches(ring, 1)
    assert batch.label == "numpy"
    assert _phases(ring, batch) == ["dispatch.assemble", "dispatch.results"]
    assert disp.stats["numpy_blocks"] == 2
    assert disp.stats["device_faults"] == (how == "device-lost")
    for j, obj in enumerate(objects):
        got = [digests[j, i].tobytes() + shards[j, i].tobytes() for i in range(D + P)]
        assert got == reference.shard_files(obj, D, P)
