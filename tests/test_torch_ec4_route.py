"""The dispatcher's device route for MinIO's default 16-drive set, EC:4
(12 data + 4 parity shards of 87,382 bytes a 1 MiB block), on the CPU
device: the fused kernel refuses d > 8, so the bit-plane matrix (K3 on
the card) and the chain kernel serve it (their plain versions here).

Each batch leaves the same device phases in the span ring as the fused
route (``dispatch.h2d``, ``dispatch.kernels``, ``dispatch.d2h``), and its
``dispatch.batch`` row names the route that served it; the shard files
the batch hands back are the NumPy reference's (``s3bench/reference.py``)
byte for byte. The numpy rung stamps no device phase.

The route keeps a batch's shards in one slab at a 32-byte row pitch
(``bitrot_torch.shard_slab``): the pitch, the read path it gives K2
(``bitrot_cuda.aligned``), K3's row offsets into it, the layouts one
pitched copy takes, and the route's bytes against the numpy rung.
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
def test_bitplane_route_stamps_the_device_phases(ring, b, monkeypatch):
    from minio_tpu_torch.ops import bitrot_torch, fused_cuda, rs_torch
    from minio_tpu_torch.parallel import dispatcher

    assert not fused_cuda.supports(D, P, N)  # so the bit-plane route serves
    slabs, encoded = [], []
    real_slab, real_enc = dispatcher.shard_slab, bitrot_torch.encode_and_hash

    def slab(codec, data):
        slabs.append(real_slab(codec, data))
        return slabs[-1]

    def enc(codec, data):
        encoded.append(data)
        return real_enc(codec, data)

    monkeypatch.setattr(dispatcher, "shard_slab", slab)
    objects = _objects(2 ** 31 + b, b)
    disp = _dispatcher(rs_torch.get_torch_codec(D, P))
    disp._encode_and_hash = enc
    shards, digests = _one_batch(disp, _blocks(objects))
    (batch,) = _batches(ring, 1)
    assert batch.label == "bitplane"
    assert _phases(ring, batch) == list(PHASES)
    # the copy in filled the data rows of one slab at the 32-byte pitch,
    # and the launches took that slab
    (got,) = slabs
    assert encoded == [got]
    assert got.rows.shape == (b, D + P, bitrot_torch.pitch(N))
    # the slab holds the batch's own b blocks: no pad
    assert disp.stats["pad_blocks"] == 0
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


# -- the shard slab ------------------------------------------------------------

@pytest.mark.parametrize("n,want", [(0, 0), (17, 32), (1000, 1024), (1024, 1024),
                                    (87382, 87392), (131072, 131072)])
def test_slab_pitch(n, want):
    """A slab row's pitch: n rounded up to a multiple of 32, n itself
    where it is one (the layout is then rows back to back)."""
    from minio_tpu_torch.ops import bitrot_torch

    assert bitrot_torch.pitch(n) == want
    assert want % 32 == 0 and n <= want < n + 32


@pytest.mark.parametrize("off", range(32))
@pytest.mark.parametrize("n", [17, 1000, 87382, 87392])
def test_read_path_at_the_slab_pitch(off, n):
    """K2's rows one pitch apart: at the slab's pitch every row starts as
    the base does, so the launch takes the aligned path exactly when the
    base is 16-byte aligned; back to back (pitch n) it needs n % 16 == 0
    as well."""
    from minio_tpu_torch.ops import bitrot_cuda, bitrot_torch

    base = (1 << 20) + off
    for pitch in (bitrot_torch.pitch(n), n):
        for rows in (1, 16, 12 * 16 + 4 * 16):
            want = all((base + i * pitch) % 16 == 0 for i in range(rows))
            assert bitrot_cuda.aligned((base, rows, pitch)) == want
    assert bitrot_cuda.aligned((base, 16, bitrot_torch.pitch(n))) == (off % 16 == 0)


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("n", [17, 1000, 87382])
def test_k3_row_offsets_at_the_slab_pitch(b, n):
    """K3 reads item i's data row j at ``in + i*in_bs + offs[j]`` and
    writes its parity row r at ``out + i*out_bs + offs[d + r]``; with the
    strides the wrapper passes for a slab's data and parity views, each
    lands on that view's row, and the rows of one item never overlap."""
    from minio_tpu_torch.ops import bitrot_torch, rs_cuda, rs_torch

    codec = rs_torch.get_torch_codec(D, P, "cpu")
    slab = bitrot_torch.shard_slab(codec, np.zeros((b, D, n), np.uint8))
    data, par = slab.data, slab.parity
    pitch = bitrot_torch.pitch(n)
    assert data.stride() == ((D + P) * pitch, pitch, 1) and par.stride() == data.stride()
    offs = rs_cuda._offsets(D, P, n, 1, data.stride(1), par.stride(1), "cpu").tolist()
    assert offs == [j * pitch for j in range(D)] + [r * pitch for r in range(P)]
    for i in range(b):
        for j in range(D):
            assert data[i, j].data_ptr() == data.data_ptr() + i * data.stride(0) + offs[j]
        for r in range(P):
            assert par[i, r].data_ptr() == par.data_ptr() + i * par.stride(0) + offs[D + r]
    starts = sorted(data[i, j].data_ptr() for i in range(b) for j in range(D))
    starts = sorted(starts + [par[i, r].data_ptr() for i in range(b) for r in range(P)])
    assert all(y - x >= n for x, y in zip(starts, starts[1:]))
    # rows back to back, as before the slab: the offsets of a contiguous tensor
    assert rs_cuda._offsets(D, P, n, 1, n, n, "cpu").tolist() == (
        [j * n for j in range(D)] + [r * n for r in range(P)])


@pytest.mark.parametrize("shape,strides,want", [
    ((2, 12, 87382), (16 * 87392, 87392, 1), (87392, 16)),    # a slab's data rows
    ((2, 4, 87382), (16 * 87392, 87392, 1), (87392, 16)),     # its parity rows
    ((3, 12, 1000), (12 * 1000, 1000, 1), (1000, 12)),        # a host array
    ((1, 12, 17), (999, 32, 1), (32, 12)),                    # one item: its stride unused
    ((3, 1, 64), (96, 7, 1), (96, 1)),                        # one row an item
    ((2, 12, 100), (1250, 100, 1), None),                     # item stride not whole rows
    ((2, 12, 100), (1200, 50, 1), None),                      # rows overlap
    ((2, 12, 100), (2400, 200, 2), None),                     # bytes not contiguous
])
def test_pitched_copy_layouts(shape, strides, want):
    """The [B, r, n] layouts that one pitched copy addresses (each row's
    bytes contiguous, rows a pitch >= n apart, items whole pitches apart),
    as (pitch, rows an item)."""
    from minio_tpu_torch.ops import bitrot_cuda

    assert bitrot_cuda.pitched(shape, strides) == want


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("n", [17, 1000, N])
def test_cpu_encode_and_hash_matches_numpy_rung(b, n):
    """``encode_and_hash`` on the CPU, through the slab (the plain K3 and
    K2 on its views), gives the numpy rung's parity and digests at 12+4,
    from a host array and from the slab ``shard_slab`` filled; the parity
    is a view of the slab, and ``to_numpy`` brings it over whole."""
    from minio_tpu_torch.ops import bitrot_torch, rs_torch

    codec = rs_torch.get_torch_codec(D, P, "cpu")
    blocks = np.random.default_rng(b * n).integers(0, 256, size=(b, D, n), dtype=np.uint8)
    want_shards, want_digests = _dispatcher(codec)._encode_numpy(blocks)
    for data in (blocks, bitrot_torch.shard_slab(codec, blocks)):
        parity, digests = bitrot_torch.encode_and_hash(codec, data)
        assert parity.shape == (b, P, n) and parity.stride(1) == bitrot_torch.pitch(n)
        assert np.array_equal(bitrot_torch.to_numpy(parity), want_shards[:, D:])
        assert np.array_equal(bitrot_torch.to_numpy(digests), want_digests)
