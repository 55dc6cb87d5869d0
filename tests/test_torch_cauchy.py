"""minio_tpu_torch cauchy family on the device route, held against the JAX
package on the CPU.

- K3 (``ops/rs_cuda.py``): ``bitplane_tables`` against the GF product
  tables and against a direct XOR over random binary matrices; its plain
  version against ``rs_pallas.gf_apply_pallas(interpret=True)`` and
  ``rs_jax.gf_apply_bits``, for the cauchy composite matrices and a random
  binary matrix, at row lengths 1, 17, 512 and 1000;
- the cauchy device codec: ``encode_blocks``, ``encode_kernel`` and
  ``encode_and_hash_cauchy`` against the JAX package's XLA codec, Pallas
  route and fused-style dispatch, the odd-shard-size rule, the composite
  and bit-plane matrices, ``torch_codec_from_matrices``;
- routing: the coder sends even cauchy geometries to the dispatcher and odd
  ones to the host, and a dispatcher founded by a cauchy codec serves
  reedsolomon blocks of its shape (and the reverse).

Every comparison is byte-exact (GF(2^8) arithmetic and HighwayHash have
no tolerance). Tensors lie on the CPU, so every wrapper runs its plain
version and no launch is counted.
"""

import ctypes

import numpy as np
import pytest
import torch

from minio_tpu.erasure.coder import ErasureCoder as RefCoder
from minio_tpu.ops import cauchy as ref_cauchy
from minio_tpu.ops import rs_jax, rs_pallas
from minio_tpu.ops.highwayhash import hash256_batch_numpy
from minio_tpu_torch.erasure.coder import ErasureCoder
from minio_tpu_torch.ops import _build, cauchy, gf, rs, rs_cuda, rs_torch
from minio_tpu_torch.parallel.dispatcher import DeviceDispatcher

SHAPES = [(2, 2), (4, 2), (8, 8), (12, 4), (5, 3)]
LENGTHS = [1, 17, 512, 1000]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")


def _composite_bits(d, p):
    return rs_jax.gf_matrix_to_bitplanes(
        ref_cauchy.composite_parity_matrix(ref_cauchy.get_codec(d, p)))


def _random_bits(seed, r, k):
    """A binary [8r, 8k] matrix that is not the image of a GF matrix
    (its first 8x8 block is not a GF(2^8) multiplication)."""
    w = np.random.default_rng(seed).integers(0, 2, size=(8 * r, 8 * k)).astype(np.int8)
    w[0, :8] = 1
    w[1:8, :8] = 0
    assert not any((rs_torch.gf_matrix_to_bitplanes(np.array([[c]]))[:, :8] == w[:8, :8]).all()
                   for c in range(256))
    return w


def _table_apply(t, x):
    """Direct XOR of the byte tables: t [r, k, 256], x [B, k, n]."""
    out = np.zeros((x.shape[0], t.shape[0], x.shape[2]), dtype=np.uint8)
    for ri in range(t.shape[0]):
        for ki in range(t.shape[1]):
            out[:, ri] ^= t[ri, ki][x[:, ki]]
    return out


# -- K3: tables and plain version ------------------------------------------------

@pytest.mark.parametrize("d,p", SHAPES)
def test_tables_of_gf_bitplanes_are_product_tables(d, p):
    m = ref_cauchy.composite_parity_matrix(ref_cauchy.get_codec(d, p))
    w = _composite_bits(d, p)
    assert np.array_equal(rs_torch.gf_matrix_to_bitplanes(m), w)
    assert np.array_equal(rs_cuda.bitplane_tables(w), gf.MUL_TABLE[m])


def test_tables_of_random_binary_matrix():
    w = _random_bits(3, 3, 5)
    x = np.random.default_rng(4).integers(0, 256, size=(2, 5, 33), dtype=np.uint8)
    want = np.asarray(rs_jax.gf_apply_bits(w, x, 3))
    assert np.array_equal(_table_apply(rs_cuda.bitplane_tables(w), x), want)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("shape", SHAPES + [None], ids=lambda v: str(v))
def test_k3_plain_matches_jax_bitplane_product(shape, n):
    """The cauchy composites, and (None) a random binary matrix."""
    if shape is None:
        w, k, r = _random_bits(n, 3, 7), 7, 3
    else:
        w, k, r = _composite_bits(*shape), 2 * shape[0], 2 * shape[1]
    x = np.random.default_rng(k * 100 + r * 10 + n).integers(0, 256, size=(2, k, n),
                                                               dtype=np.uint8)
    before = rs_cuda.launches
    got = rs_cuda.gf_apply_cuda(w, torch.from_numpy(x), r)
    assert rs_cuda.launches == before  # CPU: the plain version
    assert got.dtype == torch.uint8 and got.shape == (2, r, n)
    assert np.array_equal(got.numpy(), np.asarray(rs_jax.gf_apply_bits(w, x, r)))


# the Pallas interpreter costs ~1 s a call: each shape once, at each length
PALLAS_CASES = [((2, 2), 1), ((4, 2), 17), ((8, 8), 512), ((12, 4), 1000), ((5, 3), 17),
                (None, 1000)]


@pytest.mark.parametrize("shape,n", PALLAS_CASES, ids=lambda v: str(v))
def test_k3_plain_matches_pallas_interpret(shape, n):
    if shape is None:
        w, k, r = _random_bits(7, 5, 6), 6, 5
    else:
        (d, p) = shape
        w, k, r = _composite_bits(d, p), 2 * d, 2 * p
    x = np.random.default_rng(n).integers(0, 256, size=(3, k, n), dtype=np.uint8)
    want = np.asarray(rs_pallas.gf_apply_pallas(w, x, r, interpret=True))
    assert np.array_equal(rs_cuda.gf_apply_cuda(w, torch.from_numpy(x), r).numpy(), want)
    # the [k, n] form squeezes like gf_apply_pallas
    assert np.array_equal(rs_cuda.gf_apply_cuda(w, torch.from_numpy(x[1]), r).numpy(), want[1])


def test_k3_subchunk_rows_match_explicit_composite():
    w = _random_bits(11, 6, 4)  # [8*2*3, 8*2*2]: r = 3, k = 2, sub = 2
    x = np.random.default_rng(12).integers(0, 256, size=(4, 2, 2 * 13), dtype=np.uint8)
    u = x.reshape(4, 2, 2, 13).transpose(0, 2, 1, 3).reshape(4, 4, 13)
    want = np.asarray(rs_jax.gf_apply_bits(w, u, 6)).reshape(4, 2, 3, 13)
    want = want.transpose(0, 2, 1, 3).reshape(4, 3, 26)
    got = rs_cuda.gf_apply_cuda(w, torch.from_numpy(x), 3, sub=2)
    assert np.array_equal(got.numpy(), want)


def test_k3_wrapper_rejects_bad_input():
    w = _composite_bits(4, 2)
    x = torch.zeros((2, 8, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_cuda(w, x, 3)  # matrix maps to 4 rows
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_cuda(w, x.to(torch.int32), 4)
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_cuda(w.astype(np.int8) * 2, x, 4)  # not 0/1
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_cuda(w[:, :12], x, 4)  # not [8r, 8k]
    with pytest.raises(ValueError):
        rs_cuda.gf_apply_cuda(_composite_bits(4, 2), torch.zeros((2, 4, 15), dtype=torch.uint8),
                              2, sub=2)  # 15 bytes do not split in two


def test_k3_shared_memory_sizes():
    # the cauchy composites of a 16-drive set: 64 KiB and 48 KiB of wide
    # tables (16- and 8-byte entries), both above the 48 KiB static limit
    # once the offsets are added; every 16-drive geometry fits a block,
    # EC 16+16 does not
    assert rs_cuda.smem_bytes(16, 16) == 65536 + 256
    assert rs_cuda.smem_bytes(24, 8) == 49152 + 256
    assert max(rs_cuda.smem_bytes(2 * d, 2 * (16 - d)) for d in range(1, 16)) <= rs_cuda.MAX_SMEM
    assert rs_cuda.smem_bytes(32, 32) > rs_cuda.MAX_SMEM


def test_build_interface_has_k3():
    assert "gf_apply.cu" in {s.rsplit("/", 1)[-1] for s in _build.sources()}
    argtypes = _build.SIGNATURES["gf_apply"]["gf_apply"]
    assert len(argtypes) == 13  # ..., offsets, the GF core's threads and grid, stream
    for i in (0, 2, 8, 9, 12):  # in, out, tables, offsets, stream
        assert argtypes[i] is ctypes.c_void_p


# -- the cauchy device codec ---------------------------------------------------------

@pytest.mark.parametrize("d,p", SHAPES)
def test_composite_matrices_match_reference(d, p):
    ref = ref_cauchy.get_codec(d, p)
    port = cauchy.get_codec(d, p)
    assert np.array_equal(cauchy.composite_parity_matrix(port),
                          ref_cauchy.composite_parity_matrix(ref))
    codec = cauchy.get_torch_codec(d, p)
    assert codec.device.type == "cpu" and codec.family == "cauchy"
    assert np.array_equal(codec.w_composite, ref_cauchy.get_tpu_codec(d, p).w_composite)


@pytest.mark.parametrize("d,p", SHAPES)
def test_encode_blocks_match_reference(d, p):
    per = 2 * (d + 3 * p)
    blocks = np.random.default_rng(d + 7 * p).integers(0, 256, size=(3, d, per), dtype=np.uint8)
    want = np.asarray(ref_cauchy.get_tpu_codec(d, p).encode_blocks(blocks))
    full = np.zeros((d + p, per), dtype=np.uint8)
    full[:d] = blocks[2]
    assert np.array_equal(ref_cauchy.get_codec(d, p).encode(full)[d:], want[2])
    codec = cauchy.get_torch_codec(d, p)
    got = codec.encode_blocks(blocks)
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), want)
    assert np.array_equal(cauchy.encode_kernel(cauchy.get_codec(d, p), blocks).numpy(), want)
    # leading batch dims fold away like the reference's
    assert np.array_equal(codec.encode_blocks(blocks[None]).numpy(), want[None])


@pytest.mark.parametrize("d,p", [(4, 4), (8, 8)])
def test_encode_paths_match_pallas_and_fused_dispatch(d, p):
    per = 512
    blocks = np.random.default_rng(1).integers(0, 256, size=(4, d, per), dtype=np.uint8)
    pallas = np.asarray(ref_cauchy.encode_blocks_pallas(ref_cauchy.get_codec(d, p), blocks,
                                                        interpret=True))
    assert np.array_equal(cauchy.encode_kernel(cauchy.get_codec(d, p), blocks).numpy(), pallas)
    rpar, rdig = ref_cauchy.encode_and_hash_cauchy(ref_cauchy.get_tpu_codec(d, p), blocks)
    par, dig = cauchy.encode_and_hash_cauchy(cauchy.get_torch_codec(d, p), blocks)
    assert np.array_equal(par.numpy(), np.asarray(rpar))
    assert np.array_equal(par.numpy(), pallas)
    assert dig.shape == (4, d + p, 2, 32)
    assert np.array_equal(dig.numpy(), np.asarray(rdig))
    shards = np.concatenate([blocks, pallas], axis=1)
    assert np.array_equal(dig.numpy(), hash256_batch_numpy(
        shards.reshape(-1, per // 2)).reshape(4, d + p, 2, 32))


def test_odd_shard_size_raises_like_reference():
    blocks = np.zeros((2, 4, 33), dtype=np.uint8)
    with pytest.raises(ValueError, match="even shard size"):
        ref_cauchy.get_tpu_codec(4, 2).encode_blocks(blocks)
    with pytest.raises(ValueError, match="even shard size"):
        ref_cauchy.encode_blocks_pallas(ref_cauchy.get_codec(4, 2), blocks, interpret=True)
    with pytest.raises(ValueError, match="even shard size"):
        cauchy.get_torch_codec(4, 2).encode_blocks(blocks)
    with pytest.raises(ValueError, match="even shard size"):
        cauchy.encode_kernel(cauchy.get_codec(4, 2), blocks)


def test_torch_codec_from_matrices():
    ref = ref_cauchy.get_codec(8, 8)
    codec = cauchy.torch_codec_from_matrices(ref.parity_matrix, ref.pb_matrix)
    assert codec is cauchy.get_torch_codec(8, 8)
    blocks = np.random.default_rng(9).integers(0, 256, size=(2, 8, 64), dtype=np.uint8)
    assert np.array_equal(codec.encode_blocks(blocks).numpy(),
                          np.asarray(ref_cauchy.get_tpu_codec(8, 8).encode_blocks(blocks)))
    bad = ref.pb_matrix.copy()
    bad[0, 0] ^= 1
    with pytest.raises(ValueError, match="piggyback"):
        cauchy.torch_codec_from_matrices(ref.parity_matrix, bad)
    with pytest.raises(ValueError, match="parity matrix"):
        cauchy.torch_codec_from_matrices(rs.get_codec(8, 8).parity_matrix, ref.pb_matrix)


# -- routing --------------------------------------------------------------------------

@pytest.mark.parametrize("d,p,block", [(4, 4, 8192), (3, 2, 3 * 2 * 700), (3, 2, 3 * 701)])
def test_coder_routes_cauchy_like_reference(monkeypatch, d, p, block):
    """Even shard sizes go through the dispatcher (K3 + K2's plain
    versions here), odd ones through the host codec; the shard files
    equal the JAX package's either way."""
    data = np.random.default_rng(block).integers(0, 256, 3 * block + 5, dtype=np.uint8).tobytes()
    monkeypatch.setenv("MINIO_TPU_BACKEND", "numpy")
    want = RefCoder(d, p, block_size=block, family="cauchy").encode_part(data)
    monkeypatch.setenv("MINIO_TPU_BACKEND", "torch")
    coder = ErasureCoder(d, p, block_size=block, family="cauchy")
    assert coder.device_active
    assert isinstance(coder._dev, cauchy.CauchyTorchCodec)
    from minio_tpu_torch.parallel import dispatcher

    before = {k: v.stats_snapshot()["blocks"] for k, v in dispatcher._dispatchers.items()}
    got = coder.encode_part(data)
    assert got.shard_files == want.shard_files and got.size == want.size
    key = (d, p, coder.shard_size, "cpu")
    served = (dispatcher._dispatchers[key].stats_snapshot()["blocks"] - before.get(key, 0)
              if key in dispatcher._dispatchers else 0)
    assert served == (3 if coder.shard_size % 2 == 0 else 0)


def test_dispatcher_founded_by_either_family_serves_both():
    d, p, n = 4, 4, 1024
    rng = np.random.default_rng(21)
    rs_codec = rs_torch.get_torch_codec(d, p)
    c_codec = cauchy.get_torch_codec(d, p)
    for founder in (c_codec, rs_codec):
        disp = DeviceDispatcher(founder, n)
        for codec, ref in ((rs_codec, rs.get_codec(d, p)), (c_codec, cauchy.get_codec(d, p))):
            blocks = rng.integers(0, 256, size=(3, d, n), dtype=np.uint8)
            shards, digests = disp.encode(blocks, codec=codec)
            for b in range(3):
                full = np.zeros((d + p, n), dtype=np.uint8)
                full[:d] = blocks[b]
                assert np.array_equal(shards[b], ref.encode(full))
            if codec is c_codec:
                assert digests.shape == (3, d + p, 2, 32)
                assert np.array_equal(digests, hash256_batch_numpy(
                    shards.reshape(-1, n // 2)).reshape(3, d + p, 2, 32))
            else:
                assert np.array_equal(digests, hash256_batch_numpy(
                    shards.reshape(-1, n)).reshape(3, d + p, 32))
        assert disp._probe_device()
        st = disp.stats_snapshot()
        assert st["numpy_blocks"] == st["device_faults"] == st["fused_failures"] == 0
        assert st["fused"] == 1  # the reedsolomon batch, padded to 16
