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

from minio_tpu_torch.ops import (
    bitrot_cuda, bitrot_torch, cauchy, fused_cuda, rs, rs_cuda, rs_torch)
from minio_tpu_torch.ops.highwayhash import MINIO_KEY, hash256_batch_numpy

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


READ_N = [32, 33, 1024, 65536, 87382, 131072]


def _path_launches():
    return dict(bitrot_cuda.core_launches)


@pytest.mark.parametrize("n", READ_N)
def test_cuda_hash_both_read_paths(n):
    """K2 on rows starting at every offset 0-31 of a buffer, one row and
    three back to back: each launch takes the read path its row starts
    give (aligned exactly when all are 16-byte aligned, as
    ``bitrot_cuda.aligned`` says), counts under it, and its digests equal
    the plain version's."""
    g = torch.Generator().manual_seed(n)
    host = torch.randint(0, 256, (32 + 3 * n + 64,), dtype=torch.uint8, generator=g)
    buf = host.cuda()
    got, rows = [], []
    for off in range(32):
        for count in (1, 3):
            view = buf[off: off + count * n].view(count, n)
            path = "aligned" if bitrot_cuda.aligned((view.data_ptr(), count, n)) else "generic"
            assert path == ("aligned" if all((view.data_ptr() + i * n) % 16 == 0
                                             for i in range(count)) else "generic")
            before = _path_launches()
            got.append(bitrot_cuda.hash256_blocks(view))
            after = _path_launches()
            key = ("hh_chain", path)
            assert after.get(key, 0) == before.get(key, 0) + 1
            rows.append(host[off: off + count * n].view(count, n))
    want = bitrot_torch.hash256_blocks_plain(torch.cat(rows))
    assert torch.equal(torch.cat(got).cpu(), want)


@pytest.mark.parametrize("d,p", [(8, 8), (12, 4)])
@pytest.mark.parametrize("b", [1, 16])
def test_cuda_k1_aligned_matches_plain(d, p, b):
    """K1 encode at n = 131,072 on fresh (16-byte aligned) tensors takes
    the aligned read path and matches ``fused_plain`` byte for byte. The
    kernel is launched below the wrapper where the reference's routing
    gate (``supports``: d <= 8, B a multiple of 16) would refuse the shape;
    the kernel itself takes any."""
    n = 131072
    rng = np.random.default_rng(100 * d + b)
    data = torch.from_numpy(rng.integers(0, 256, size=(b, d, n), dtype=np.uint8))
    m = rs.get_codec(d, p).parity_matrix
    before = _path_launches()
    gp, gd = fused_cuda._launch("fused_encode_hash", data.cuda(),
                                fused_cuda._encode_tables(d, p, "cuda:0"), p, MINIO_KEY)
    after = _path_launches()
    key = ("fused_encode_hash", "aligned")
    assert after.get(key, 0) == before.get(key, 0) + 1
    wp, wd = fused_cuda.fused_plain(data, m)
    assert torch.equal(gp.cpu(), wp)
    assert torch.equal(gd.cpu(), wd)


def test_cuda_k1_misaligned_view_takes_generic_path():
    """A K1 encode on a view 8 bytes into its buffer (every shard start
    16-byte misaligned) takes the generic read path, counts there, and
    gives the same bytes as the same data on an aligned tensor, which the
    plain version holds."""
    d, p, b, n = 8, 8, 16, 131072
    rng = np.random.default_rng(77)
    host = torch.from_numpy(rng.integers(0, 256, size=(b, d, n), dtype=np.uint8))
    buf = torch.empty(8 + b * d * n, dtype=torch.uint8, device="cuda")
    view = buf[8:].view(b, d, n)
    view.copy_(host)
    assert view.data_ptr() % 16 == 8
    before = _path_launches()
    gp, gd = fused_cuda.fused_encode_hash(view, d, p)
    after = _path_launches()
    key = ("fused_encode_hash", "generic")
    assert after.get(key, 0) == before.get(key, 0) + 1
    ap, ad = fused_cuda.fused_encode_hash(host.cuda(), d, p)
    assert torch.equal(gp, ap) and torch.equal(gd, ad)
    wp, wd = fused_cuda.fused_plain(host, rs.get_codec(d, p).parity_matrix)
    assert torch.equal(ad.cpu(), wd) and torch.equal(ap.cpu(), wp)
