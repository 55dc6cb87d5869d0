"""The port's kernels on a CUDA card, held against their plain versions.

These cases need the card: each launches a hand-written kernel (K1
``ops/fused_cuda.py``, K2 ``ops/bitrot_cuda.py``, K3 ``ops/rs_cuda.py``)
and compares it byte for byte with the wrapper's plain PyTorch version on
the same inputs. Without a card every case skips. The file imports
nothing of the JAX package, so the card's machine, which has no JAX, can
collect it: ``chip_smoke.py`` runs it whole in its suite phase, where a
skip fails the run.
"""

import numpy as np
import pytest
import torch

from minio_tpu_torch.ops import bitrot_cuda, bitrot_torch, cauchy, fused_cuda, rs_cuda, rs_torch
from minio_tpu_torch.ops.highwayhash import hash256_batch_numpy

pytestmark = pytest.mark.cuda

D, P, B, N = 8, 8, 16, 1024


@pytest.fixture(scope="module", autouse=True)
def _card():
    """Every case here skips without a card: decided when the cases run,
    never as the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run via chip_smoke.py on the H100)")


@pytest.fixture(scope="module")
def encoded():
    """One batch at EC 8+8 encoded by K1's plain version (a CPU tensor)."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(B, D, N), dtype=np.uint8)
    before = fused_cuda.encode_launches
    par, dig = fused_cuda.fused_encode_hash(torch.from_numpy(data), D, P)
    assert fused_cuda.encode_launches == before  # CPU: plain version
    return data, par.numpy(), dig.numpy()


def test_cuda_hash_matches_plain():
    """The chain kernel against the plain version (odd lengths, row counts
    that are not multiples of 8)."""
    for n in (0, 1, 31, 32, 33, 87382):
        x = torch.randint(0, 256, (37, n), dtype=torch.uint8, device="cuda")
        assert torch.equal(bitrot_cuda.hash256_blocks(x).cpu(),
                           bitrot_torch.hash256_blocks_plain(x.cpu()))


@pytest.mark.parametrize("n", [33, 34, 38, 65, 70, 95, 161])
def test_cuda_hash_odd_rows_end_of_buffer(n):
    """Rows of odd length start at every alignment, and the last one ends
    at the last byte of its buffer: the whole-packet loop's look-ahead
    word must not read past a row's end, and the digests must not change."""
    rows = 9
    g = torch.Generator().manual_seed(n)
    host = torch.randint(0, 256, (rows * n,), dtype=torch.uint8, generator=g)
    buf = torch.empty(rows * n, dtype=torch.uint8, device="cuda")
    buf.copy_(host)
    got = bitrot_cuda.hash256_blocks(buf.view(rows, n))
    torch.cuda.synchronize()
    want = bitrot_torch.hash256_blocks_plain(host.view(rows, n))
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(got.cpu().numpy(), hash256_batch_numpy(host.view(rows, n).numpy()))


def test_cuda_k3_matches_plain():
    w = rs_torch.gf_matrix_to_bitplanes(cauchy.composite_parity_matrix(cauchy.get_codec(8, 8)))
    x = torch.randint(0, 256, (4, 8, 2 * 4097), dtype=torch.uint8).cuda()
    got = rs_cuda.gf_apply_cuda(w, x, 8, sub=2)
    assert torch.equal(got, rs_cuda.gf_apply_plain(w, x, 8, sub=2))


def test_cuda_fused_matches_plain(encoded):
    data, par, dig = encoded
    gp, gd = fused_cuda.fused_encode_hash(torch.from_numpy(data).cuda(), D, P)
    assert np.array_equal(gp.cpu().numpy(), par)
    assert np.array_equal(gd.cpu().numpy(), dig)
