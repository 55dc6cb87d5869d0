"""minio_tpu_torch HighwayHash-256 (K2 wrapper and plain version) and the
encode/decode+hash dispatches, held against the JAX package byte for byte.

The plain torch hash keeps the reference's 32-bit (hi, lo) lane split in
int64 tensors; these tests pin it against ``bitrot_jax.hash256_blocks``
(XLA on the CPU) and the numpy HighwayHash at every remainder shape.
"""

import numpy as np
import pytest
import torch

from minio_tpu.ops import bitrot_jax, rs_jax
from minio_tpu.ops.highwayhash import hash256_batch_numpy
from minio_tpu_torch.ops import bitrot_cuda, bitrot_torch, rs_torch
from minio_tpu_torch.ops.highwayhash import MINIO_KEY

LENGTHS = [0, 1, 5, 17, 31, 32, 33, 100, 1024]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("n", LENGTHS)
def test_hash_matches_jax_and_numpy(n):
    rng = np.random.default_rng(n)
    blocks = rng.integers(0, 256, size=(6, n), dtype=np.uint8)
    want = hash256_batch_numpy(blocks)
    assert np.array_equal(np.asarray(bitrot_jax.hash256_blocks(blocks)), want)
    got = bitrot_torch.hash256_blocks_plain(torch.from_numpy(blocks))
    assert got.dtype == torch.uint8 and got.shape == (6, 32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [0, 33, 1024])
def test_wrapper_runs_plain_version_on_cpu(n):
    blocks = torch.from_numpy(
        np.random.default_rng(7).integers(0, 256, size=(9, n), dtype=np.uint8)
    )
    before = bitrot_cuda.launches
    got = bitrot_cuda.hash256_blocks(blocks)
    assert bitrot_cuda.launches == before  # no kernel launch for CPU tensors
    assert torch.equal(got, bitrot_torch.hash256_blocks_plain(blocks))


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        bitrot_cuda.hash256_blocks(torch.zeros((2, 3, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        bitrot_cuda.hash256_blocks(torch.zeros((2, 4), dtype=torch.int32))


def test_hash_other_key():
    key = bytes(range(32))
    blocks = np.random.default_rng(3).integers(0, 256, size=(4, 70), dtype=np.uint8)
    want = hash256_batch_numpy(blocks, key)
    assert np.array_equal(
        bitrot_torch.hash256_blocks_plain(torch.from_numpy(blocks), key).numpy(), want
    )
    assert not np.array_equal(want, hash256_batch_numpy(blocks, MINIO_KEY))


@pytest.mark.parametrize("d,p,n", [(2, 2, 96), (4, 2, 64), (12, 4, 70), (5, 3, 33)])
def test_encode_and_hash_matches_jax(d, p, n):
    rng = np.random.default_rng(d * 7 + p)
    data = rng.integers(0, 256, size=(3, d, n), dtype=np.uint8)
    wp, wd = bitrot_jax.encode_and_hash(rs_jax.get_tpu_codec(d, p), data)
    gp, gd = bitrot_torch.encode_and_hash(rs_torch.get_torch_codec(d, p), data)
    assert np.array_equal(gp.numpy(), np.asarray(wp))
    assert np.array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize(
    "d,p,present,missing",
    [
        (12, 4, tuple(range(1, 13)), (0,)),   # d > 8: bit-plane + chain path
        (4, 2, (1, 2, 3, 4), (0,)),           # fused path (B pads to 16)
        (8, 8, (0, 2, 3, 4, 6, 7, 8, 12), (1, 5)),
    ],
)
def test_reconstruct_and_hash_matches_jax(d, p, present, missing):
    rng = np.random.default_rng(11)
    n = 1024
    full = np.stack([
        rs_jax.get_tpu_codec(d, p)._ref.encode_data(
            rng.integers(0, 256, size=d * n, dtype=np.uint8).tobytes())
        for _ in range(2)
    ])
    surv = full[:, list(present)]
    wr, wd = rs_jax_reconstruct(d, p, surv, present, missing)
    before = dict(bitrot_torch.decode_stats)
    gr, gd = bitrot_torch.reconstruct_and_hash(
        rs_torch.get_torch_codec(d, p), surv, present, missing
    )
    gr, gd = bitrot_torch.to_numpy(gr), bitrot_torch.to_numpy(gd)
    assert np.array_equal(gr, wr) and np.array_equal(gr, full[:, list(missing)])
    assert np.array_equal(gd, wd)
    fused = bitrot_torch.decode_stats["fused"] - before["fused"]
    assert fused == (1 if d <= 8 else 0)
    assert bitrot_torch.decode_stats["failures"] == before["failures"]


def rs_jax_reconstruct(d, p, surv, present, missing):
    r, dg = bitrot_jax.reconstruct_and_hash(rs_jax.get_tpu_codec(d, p), surv, present, missing)
    return np.asarray(r), np.asarray(dg)


def test_fused_decode_disabled_by_knob(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_FUSED_CM", "0")
    surv = np.zeros((16, 8, 1024), dtype=np.uint8)
    assert bitrot_torch._try_fused_decode(
        rs_torch.get_torch_codec(8, 8), surv, tuple(range(1, 9)), (0,), MINIO_KEY
    ) is None
