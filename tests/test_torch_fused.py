"""minio_tpu_torch fused encode/decode + hash (K1): the wrapper's plain
version against the JAX package, the loss patterns, the finalization
golden, the shape gate, the dispatcher route, and the kernel build's
plain C interface. Byte-exact throughout.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from minio_tpu.ops import bitrot_jax, rs_jax
from minio_tpu.ops.highwayhash import hash256_batch_numpy
from minio_tpu_torch.ops import _build, bitrot_cuda, bitrot_torch, fused_cuda, gf_cuda, rs_torch
from minio_tpu_torch.parallel.dispatcher import DeviceDispatcher

D, P, B, N = 8, 8, 16, 1024

# the loss patterns of the multi-device graft drive: 1 data shard; 2 data
# + mixed parity; all data rebuilt from parity
PATTERNS = [
    ((0,), tuple(range(1, D + 1))),
    ((1, 5), (0, 2, 3, 4, 6, 7, 8, 12)),
    (tuple(range(D)), tuple(range(D, D + P))),
]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def encoded():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(B, D, N), dtype=np.uint8)
    before = fused_cuda.encode_launches
    par, dig = fused_cuda.fused_encode_hash(torch.from_numpy(data), D, P)
    assert fused_cuda.encode_launches == before  # CPU: plain version
    return data, par.numpy(), dig.numpy()


def test_encode_matches_jax(encoded):
    data, par, dig = encoded
    wp, wd = bitrot_jax.encode_and_hash(rs_jax.get_tpu_codec(D, P), data)
    assert np.array_equal(par, np.asarray(wp))
    assert np.array_equal(dig, np.asarray(wd))


@pytest.mark.parametrize("missing,present", PATTERNS)
def test_decode_loss_patterns(encoded, missing, present):
    data, par, dig = encoded
    full = np.concatenate([data, par], axis=1)
    surv = torch.from_numpy(np.ascontiguousarray(full[:, list(present)]))
    before = fused_cuda.decode_launches
    reb, ddig = fused_cuda.fused_decode_hash(surv, D, P, present, missing)
    assert fused_cuda.decode_launches == before
    assert np.array_equal(reb.numpy(), full[:, list(missing)])
    # survivors' digests first (verify verdicts), then the rebuilt shards'
    assert np.array_equal(ddig.numpy(), dig[:, list(present) + list(missing)])
    wr, wd = bitrot_jax.reconstruct_and_hash(
        rs_jax.get_tpu_codec(D, P), full[:, list(present)], present, missing
    )
    assert np.array_equal(reb.numpy(), np.asarray(wr))
    assert np.array_equal(ddig.numpy()[:, D:], np.asarray(wd))


def test_finalization_matches_numpy_golden():
    """The chain + finalization + modular reduction the kernels run,
    against the numpy HighwayHash and the JAX package's XLA finisher on
    the same inputs as the JAX package's epilogue golden."""
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 256, size=(16, 4 * 32), dtype=np.uint8)
    want = np.asarray(hash256_batch_numpy(list(blocks)))
    assert np.array_equal(np.asarray(bitrot_jax.hash256_blocks(blocks)), want)
    got = bitrot_torch.hash256_blocks_plain(torch.from_numpy(blocks)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "d,p,n,ok",
    [
        (8, 8, 131072, True),
        (4, 2, 1024, True),
        (8, 1, 1024, True),
        (12, 4, 87382, False),   # EC 12+4 keeps the bit-plane + K2 route
        (9, 4, 1024, False),
        (8, 9, 1024, False),
        (8, 0, 1024, False),
        (8, 8, 1000, False),     # n not a multiple of 1024
        (8, 8, 0, False),
    ],
)
def test_supports_gate(d, p, n, ok):
    assert fused_cuda.supports(d, p, n) is ok


@pytest.mark.parametrize("k", [1, 3, 8, 15, 17, 24])
def test_dispatcher_encodes_a_batch_at_its_own_size(k):
    """The dispatcher hands K1 the batch's own k blocks (no pad to a floor
    or a power of two): the wrapper sees B = k, and the parity and digests
    are the numpy codec's and the numpy HighwayHash's."""
    codec = rs_torch.get_torch_codec(D, P)
    disp = DeviceDispatcher(codec, N)
    seen = []
    real = fused_cuda.fused_encode_hash

    def spy(data, d, p):
        seen.append(tuple(data.shape))
        return real(data, d, p)

    blocks = np.random.default_rng(k).integers(0, 256, size=(k, D, N), dtype=np.uint8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_cuda, "fused_encode_hash", spy)
        shards, digests = disp.encode(blocks)
    assert seen == [(k, D, N)]
    assert shards.shape == (k, D + P, N) and digests.shape == (k, D + P, 32)
    _check_encoded(codec, blocks, shards, digests)
    st = disp.stats_snapshot()
    assert st["fused"] == st["dispatches"] == 1 and st["pad_blocks"] == 0
    assert st["blocks"] == k and st["arena_direct"] == 1


@pytest.mark.parametrize("family,d,p,n,route", [
    ("reedsolomon", 8, 8, 131072, "fused"),
    ("reedsolomon", 12, 4, 87382, "bitplane"),
    ("reedsolomon", 8, 8, 1000, "bitplane"),
    ("cauchy", 8, 8, 131072, "cauchy"),
])
def test_dispatcher_route_by_shape(monkeypatch, family, d, p, n, route):
    """The route the dispatcher takes for a shape: K1 where ``supports``
    holds, the bit-plane product + K2 where it does not (d > 8, n not a
    multiple of 1,024), the cauchy family's own for a cauchy codec. Each
    route's encoder is replaced by a recorder, so no hash runs."""
    from minio_tpu_torch.ops import cauchy

    taken = []

    def recorder(name, digest_shape):
        def enc(*args):
            taken.append(name)
            return (torch.zeros((1, p, n), dtype=torch.uint8),
                    torch.zeros((1, d + p, *digest_shape), dtype=torch.uint8))
        return enc

    monkeypatch.setattr(fused_cuda, "fused_encode_hash", recorder("fused", (32,)))
    monkeypatch.setattr(cauchy, "encode_and_hash_cauchy", recorder("cauchy", (2, 32)))
    disp = DeviceDispatcher(rs_torch.get_torch_codec(d, p), n)
    disp._encode_and_hash = recorder("bitplane", (32,))
    codec = cauchy.get_torch_codec(d, p) if family == "cauchy" else None
    disp.submit(np.zeros((1, d, n), dtype=np.uint8), codec=codec).result(timeout=60)
    assert taken == [route]
    st = disp.stats_snapshot()
    assert st["fused"] == (route == "fused") and st["numpy_blocks"] == 0


def test_wrapper_rejects_unsupported_shapes():
    with pytest.raises(ValueError):
        fused_cuda.fused_encode_hash(torch.zeros((8, 9, N), dtype=torch.uint8), 9, P)
    with pytest.raises(ValueError):
        fused_cuda.fused_encode_hash(torch.zeros((0, D, N), dtype=torch.uint8), D, P)
    with pytest.raises(ValueError):
        fused_cuda.fused_encode_hash(torch.zeros((B, D, N), dtype=torch.int32), D, P)


def test_gf_tables_are_products():
    m = rs_torch.get_torch_codec(4, 2).parity_matrix
    t = fused_cuda.gf_tables(m)
    from minio_tpu_torch.ops import gf

    assert t.shape == (2, 4, 256)
    for i in range(2):
        for j in range(4):
            for x in (0, 1, 2, 77, 255):
                assert t[i, j, x] == gf.gf_mul(int(m[i, j]), x)


def test_dispatcher_routes_8_8_through_fused(monkeypatch):
    """Three blocks go to the fused kernel as three; results match the
    numpy codec and the stats keys count one fused dispatch."""
    codec = rs_torch.get_torch_codec(D, P)
    disp = DeviceDispatcher(codec, N)
    blocks = np.random.default_rng(9).integers(0, 256, size=(3, D, N), dtype=np.uint8)
    shards, digests = disp.encode(blocks)
    ref = codec._ref
    for b in range(3):
        full = np.zeros((D + P, N), dtype=np.uint8)
        full[:D] = blocks[b]
        full = ref.encode(full)
        assert np.array_equal(shards[b], full)
        assert np.array_equal(digests[b], hash256_batch_numpy(full))
    st = disp.stats_snapshot()
    assert st["fused"] == st["dispatches"] == 1
    assert st["pad_blocks"] == 0 and st["fused_failures"] == 0
    assert st["numpy_blocks"] == 0 and st["device_faults"] == 0


def _check_encoded(codec, blocks, shards, digests):
    for b in range(blocks.shape[0]):
        full = np.zeros((D + P, N), dtype=np.uint8)
        full[:D] = blocks[b]
        full = codec._ref.encode(full)
        assert np.array_equal(shards[b], full)
        assert np.array_equal(digests[b], hash256_batch_numpy(full))


def test_dispatcher_ladder_serves_injected_faults():
    """An injected kernel-fail skips K1 for the bit-plane rung; repeated
    injected device losses demote to numpy. Bytes never change."""
    from minio_tpu_torch.fault import registry

    codec = rs_torch.get_torch_codec(D, P)
    disp = DeviceDispatcher(codec, N)
    rng = np.random.default_rng(11)
    try:
        registry.inject({"boundary": "tpu", "mode": "kernel-fail", "target": "8+8",
                         "op": "kernel", "count": 1})
        blocks = rng.integers(0, 256, size=(16, D, N), dtype=np.uint8)
        _check_encoded(codec, blocks, *disp.encode(blocks))
        st = disp.stats_snapshot()
        assert st["fused_failures"] == 1 and st["fused"] == 0 and st["numpy_blocks"] == 0
        registry.clear()
        registry.inject({"boundary": "tpu", "mode": "device-lost", "target": "8+8",
                         "op": "dispatch", "count": 3})
        for _ in range(3):
            blocks = rng.integers(0, 256, size=(2, D, N), dtype=np.uint8)
            _check_encoded(codec, blocks, *disp.encode(blocks))
        st = disp.stats_snapshot()
        assert st["device_faults"] == 3 and st["numpy_blocks"] == 6
        assert st["backend_level"] == 0 and st["demotions"] == 1
    finally:
        registry.clear()


def test_dispatcher_kernel_error_reaches_caller(monkeypatch):
    """A real kernel failure is not a rung of the ladder: the waiter gets
    the error, and no other path serves the batch."""
    def broken(*a, **k):
        raise RuntimeError("fused_encode_hash: launch failed")

    monkeypatch.setattr(fused_cuda, "fused_encode_hash", broken)
    disp = DeviceDispatcher(rs_torch.get_torch_codec(D, P), N)
    with pytest.raises(RuntimeError, match="launch failed"):
        disp.encode(np.zeros((16, D, N), dtype=np.uint8))
    st = disp.stats_snapshot()
    assert st["fused_failures"] == st["device_faults"] == st["numpy_blocks"] == 0


def test_fused_decode_kernel_error_reaches_caller(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("fused_encode_hash: launch failed")

    monkeypatch.setattr(fused_cuda, "fused_decode_hash", broken)
    missing, present = PATTERNS[0]
    before = dict(bitrot_torch.decode_stats)
    with pytest.raises(RuntimeError, match="launch failed"):
        bitrot_torch.reconstruct_and_hash(
            rs_torch.get_torch_codec(D, P), np.zeros((B, D, N), dtype=np.uint8),
            present, missing)
    assert bitrot_torch.decode_stats == before


def test_fused_decode_injected_fault_takes_bitplane_path(monkeypatch, encoded):
    from minio_tpu_torch.fault import registry

    bitrot_torch._decode_gate.cache_clear()  # a fresh gate: no cooldown left over
    data, par, dig = encoded
    full = np.concatenate([data, par], axis=1)
    missing, present = PATTERNS[1]
    before = dict(bitrot_torch.decode_stats)
    try:
        registry.inject({"boundary": "tpu", "mode": "kernel-fail", "target": "8+8",
                         "op": "kernel", "count": 1})
        reb, rdig = bitrot_torch.reconstruct_and_hash(
            rs_torch.get_torch_codec(D, P), full[:, list(present)], present, missing)
    finally:
        registry.clear()
    assert np.array_equal(bitrot_torch.to_numpy(reb), full[:, list(missing)])
    assert np.array_equal(bitrot_torch.to_numpy(rdig), dig[:, list(missing)])
    assert bitrot_torch.decode_stats["failures"] == before["failures"] + 1
    assert bitrot_torch.decode_stats["fused"] == before["fused"]


def test_build_interface_declares_void_pointers():
    assert {os.path.basename(s) for s in _build.sources()} == {
        "fused_encode_hash.cu", "gf_apply.cu", "hh_chain.cu"}
    for name, fns in _build.SIGNATURES.items():
        assert os.path.exists(os.path.join(_build.CSRC, name + ".cu"))
        for argtypes in fns.values():
            # pointers and the stream must never be passed as 32-bit ints
            assert argtypes[0] is ctypes.c_void_p
            assert argtypes[-1] is ctypes.c_void_p
    # the hash core's launch plan goes to K1 and K2 as five int64 before
    # the stream, after the read path (one int64: every row start 16-byte
    # aligned); the GF core's (threads, grid, row groups) to K1 and K3 as
    # three int64 (in K1 before the read path); K1's GF launch has an
    # entry point of its own
    plan_args = [ctypes.c_int64] * len(bitrot_cuda.plan(16, 131072).args())
    gf_args = [ctypes.c_int64] * len(gf_cuda.plan(256, D, P, 131072).args())
    assert len(gf_args) == 3
    assert _build.SIGNATURES["hh_chain"]["hh_chain"][-7:-1] == [ctypes.c_int64, *plan_args]
    assert _build.SIGNATURES["hh_chain"]["hh_chain"][-8] is ctypes.c_void_p  # digests
    assert _build.SIGNATURES["fused_encode_hash"]["fused_encode_hash"][-6:-1] == plan_args
    assert _build.SIGNATURES["fused_encode_hash"]["fused_encode_hash"][-7] is ctypes.c_int64
    assert _build.SIGNATURES["fused_encode_hash"]["fused_encode_hash"][-10:-7] == gf_args
    assert _build.SIGNATURES["fused_encode_hash"]["fused_encode_hash"][-11] is ctypes.c_void_p
    assert _build.SIGNATURES["fused_encode_hash"]["fused_gf_apply"][-4:-1] == gf_args
    assert _build.SIGNATURES["gf_apply"]["gf_apply"][-4:-1] == gf_args
    assert len(_build.SIGNATURES["fused_encode_hash"]["fused_gf_apply"]) == 11
    assert _build.key_words(bytes(range(32)))[0] == int.from_bytes(bytes(range(8)), "little")


def test_gf_launch_alone_is_card_only(encoded):
    """``gf_apply_only`` (K1's first launch, timed apart by the smoke) has
    no plain route: a CPU tensor is refused, and no K1 launch is counted."""
    data = torch.from_numpy(encoded[0])
    before = (fused_cuda.encode_launches, fused_cuda.decode_launches)
    with pytest.raises(ValueError, match="only on the card"):
        fused_cuda.gf_apply_only(data, torch.zeros((D, 256, 8), dtype=torch.uint8), P)
    assert (fused_cuda.encode_launches, fused_cuda.decode_launches) == before
