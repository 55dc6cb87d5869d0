"""The GF(2^8) apply core of K1 and K3 (``csrc/gf_core.cuh``): what the
CPU can hold of it.

- ``gf_cuda.wide_tables``: W[j, x, i] == t[i, j, x] with zero padding
  rows, for r and k in 1..30; the entry width by r; the wrappers' table
  caches (K3 per matrix, K1 per encode geometry and per loss pattern).
- ``gf_cuda.plan``: shared memory within a block, tiles that cover every
  column exactly once, at least min(tiles, 132) blocks, one wave; 256
  threads where those tiles fill three quarters of the SMs, else the
  small-batch regime's
  narrower tiles and row groups that split every input row exactly once,
  and its launches counted by regime.
- A model of the kernel's loads at every row offset 0-15 and at tails
  shorter than C (two aligned loads funnel-shifted, or byte loads).
- A torch model of the kernel's arithmetic: the wide-entry gather, the XOR
  over input rows into column-major accumulators, and the 4x4 byte
  transpose written with the kernel's ``__byte_perm`` selectors. It is
  held byte for byte against the JAX package's
  ``rs_pallas.gf_apply_pallas(interpret=True)`` for the cauchy composites
  and for binary matrices that are the image of no GF matrix, and against
  the reference GF matvec (``gf.gf_matvec_blocks``) for K1's encode and
  decode matrices; at odd n, tails shorter than C, and empty inputs.

Byte-exact throughout: GF(2^8) arithmetic has no tolerance.
"""

import os

import numpy as np
import pytest
import torch

from minio_tpu.ops import cauchy as ref_cauchy
from minio_tpu.ops import gf as ref_gf
from minio_tpu.ops import rs as ref_rs
from minio_tpu.ops import rs_jax, rs_pallas
from minio_tpu_torch.ops import _build, fused_cuda, gf_cuda, rs_cuda

# (B, k, r, n) of every GF-core launch on the smoke's main path: K3 on the
# cauchy composites (16x16 at h = 65,536; 8x24 at h = 43,691), K1 encode
# at 8+8 (B=1 a lone PUT's block), K1 decode at B=8 and 16 with 1-8 rows
# rebuilt, the device heal at B=64
MAIN_PATH = [
    (256, 16, 16, 65536), (128, 16, 16, 65536), (64, 16, 16, 65536), (16, 16, 16, 65536),
    (256, 24, 8, 43691), (64, 24, 8, 43691),
    (256, 8, 8, 131072), (128, 8, 8, 131072), (64, 8, 8, 131072), (1, 8, 8, 131072),
    *[(b, 8, m, 131072) for b in (8, 16) for m in range(1, 9)],
]
# odd lengths, tails shorter than C, empty inputs, more than 16 output rows
EDGES = [(b, k, r, n) for b in (0, 1, 3) for k, r in ((5, 3), (2, 30), (30, 2), (7, 17))
         for n in (0, 1, 7, 15, 17, 43691)]
# the benchmark cells' launches: K3 at EC 12+4 on a 1 MiB block's shards
# (87,382 bytes) and K1 at 8+8 (128 KiB), a few blocks a launch
CELLS = [(b, 12, 4, 87382) for b in range(1, 9)] + [(b, 8, 8, 131072) for b in range(1, 5)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")


def _random_bits(seed, r, k):
    """A binary [8r, 8k] matrix whose block (0, 0) maps byte 1 to 0xff and
    bytes 2..128 to 0: no GF(2^8) multiplication does that."""
    w = np.random.default_rng(seed).integers(0, 2, size=(8 * r, 8 * k)).astype(np.int8)
    w[0, :8] = 1
    w[1:8, :8] = 0
    return w


def _composite_bits(d, p):
    return rs_jax.gf_matrix_to_bitplanes(
        ref_cauchy.composite_parity_matrix(ref_cauchy.get_codec(d, p)))


# -- the wide tables ----------------------------------------------------------------

@pytest.mark.parametrize("r", range(1, 31))
def test_wide_tables_layout(r):
    e = 16 if r > 8 else 8 if r > 4 else 4
    g = -(-r // 16)
    assert (gf_cuda.entry_width(r), gf_cuda.groups(r)) == (e, g)
    assert gf_cuda.columns(e) * e <= 128  # 32 accumulator registers at most
    assert gf_cuda.registers(e) * 256 * (3 if e == 16 else 4) <= 65536
    rng = np.random.default_rng(r)
    for k in range(1, 31):
        t = rng.integers(0, 256, size=(r, k, 256), dtype=np.uint8)
        w = gf_cuda.wide_tables(t)
        assert w.shape == (k, 256, e * g) and w.dtype == np.uint8
        assert np.array_equal(w[:, :, :r], t.transpose(1, 2, 0))  # W[j, x, i] == t[i, j, x]
        assert not w[:, :, r:].any()  # padding rows contribute nothing
        assert gf_cuda.smem_bytes(k, r) == w.nbytes + 8 * (k + r)


def test_wide_tables_reject_bad_shapes():
    for shape in ((2, 3), (2, 3, 255), (0, 3, 256), (2, 0, 256)):
        with pytest.raises(ValueError):
            gf_cuda.wide_tables(np.zeros(shape, dtype=np.uint8))


def test_wrapper_table_caches():
    """K3 caches the wide tables of each matrix, K1 those of each encode
    geometry and of each loss pattern (rows 1..8 rebuilt: entries of 4 or
    8 bytes)."""
    w = _composite_bits(4, 2)
    t = rs_cuda._tables(w.tobytes(), *w.shape, "cpu")
    assert t is rs_cuda._tables(w.tobytes(), *w.shape, "cpu")
    assert np.array_equal(t.numpy(), gf_cuda.wide_tables(rs_cuda.bitplane_tables(w)))
    enc = fused_cuda._encode_tables(8, 8, "cpu")
    m = ref_rs.get_codec(8, 8).parity_matrix
    assert np.array_equal(enc.numpy(), gf_cuda.wide_tables(fused_cuda.gf_tables(m)))
    for lost in range(1, 9):
        missing, present = tuple(range(lost)), tuple(range(lost, 16))[:8]
        dec = fused_cuda._decode_tables(8, 8, present, missing, "cpu")
        assert dec is fused_cuda._decode_tables(8, 8, present, missing, "cpu")
        assert dec.shape == (8, 256, 8 if lost > 4 else 4)
        want = fused_cuda.gf_tables(fused_cuda.decode_matrix(8, 8, present, missing))
        assert np.array_equal(dec.numpy(), gf_cuda.wide_tables(want))


# -- the launch plan --------------------------------------------------------------

def _tiles(b, n, threads, cols):
    return b * -(-n // (threads * cols))


@pytest.mark.parametrize("b,k,r,n", MAIN_PATH + EDGES + CELLS)
def test_plan_fits_and_covers(b, k, r, n):
    p = gf_cuda.plan(b, k, r, n)
    assert (p.entry, p.groups) == (gf_cuda.entry_width(r), gf_cuda.groups(r))
    assert p.cols == gf_cuda.columns(p.entry) and p.entry * p.groups >= r
    # 256 threads where their tiles fill three quarters of the SMs; below
    # that tiles of the most column warps (4, 2, 1) whose tiles fill the
    # SMs, else of one, and row groups of them that split the k rows two
    # at a time
    if _tiles(b, n, 256, p.cols) >= 99:
        assert (p.threads, p.row_groups, p.regime) == (256, 0, "wave")
        assert p == gf_cuda.plan(b, k, r, n, small=False)
        assert p.smem_bytes == gf_cuda.smem_bytes(k, r)
        lanes = p.threads
    else:
        cw = next((w for w in (4, 2, 1) if _tiles(b, n, 32 * w, p.cols) >= 132), 1)
        rg = min(-(-k // 2), 8 // cw)
        assert (p.threads, p.row_groups, p.regime) == (32 * cw * rg, rg, "small")
        assert p.smem_bytes == gf_cuda.split_smem_bytes(k, r, p.threads, rg)
        lanes = 32 * cw
        # row group q applies rows q, q + rg, ...: every input row once
        rows = sorted(j for q in range(rg) for j in range(q, k, rg))
        assert rows == list(range(k))
    assert p.span == lanes * p.cols and p.threads % lanes == 0 and lanes % 32 == 0
    assert p.smem_bytes <= 227 * 1024
    assert p.blocks_per_sm >= 1
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= 228 * 1024
    assert p.blocks_per_sm * p.threads * gf_cuda.registers(p.entry, p.regime == "small") <= 65536
    assert p.blocks_per_sm * p.threads <= 2048 and p.blocks_per_sm <= 32
    span = p.span
    # one wave on whole column tiles; more where rows end in a partial one
    assert p.waves == (1 if n % span == 0 else gf_cuda.UNEVEN_WAVES)
    assert p.grid == min(p.tiles, p.waves * 132 * p.blocks_per_sm)
    assert p.grid >= min(p.tiles, 132)
    assert gf_cuda.plan(b, k, r, n, waves=2).grid == min(p.tiles, 2 * 132 * p.blocks_per_sm)
    per_item = -(-n // span)
    assert p.tiles == b * per_item  # tile -> (item, column tile) = divmod(tile, per_item)
    # the kernel's column tile and thread -> columns: every column once
    starts = (np.arange(per_item)[:, None] * span
              + np.arange(lanes)[None, :] * p.cols).ravel()
    starts = starts[starts < n]
    cover = np.zeros(n + 1, dtype=np.int64)
    np.add.at(cover, starts, 1)
    np.add.at(cover, np.minimum(starts + p.cols, n), -1)
    assert (np.cumsum(cover)[:n] == 1).all()
    assert p.args() == (p.threads, p.grid, p.row_groups)  # the C side derives the rest


@pytest.mark.parametrize("b,k,r,n", CELLS)
def test_plan_small_batch_spreads_over_the_card(b, k, r, n):
    """The cells' launches of one to a few blocks: the small-batch regime
    until 256-thread tiles fill three quarters of the SMs (B >= 5 at
    12+4, B >= 2 at 8+8), and at one block at 12+4 at least a tile an SM
    (22 at 256 threads)."""
    p = gf_cuda.plan(b, k, r, n)
    wave = gf_cuda.plan(b, k, r, n, small=False)
    assert wave.threads == 256 and wave.smem_bytes == gf_cuda.smem_bytes(k, r)
    assert p.regime == ("small" if b < (5 if k == 12 else 2) else "wave")
    if p.regime == "small":
        assert p.tiles > wave.tiles and p.grid == p.tiles
    one = gf_cuda.plan(1, 12, 4, 87382)
    assert (one.tiles, one.span, one.row_groups, one.threads) == (171, 512, 6, 192)
    one = gf_cuda.plan(1, 8, 8, 131072)
    assert (one.tiles, one.span, one.row_groups, one.threads) == (256, 512, 4, 256)


def test_plan_small_regime_falls_back_where_partials_do_not_fit():
    """Tables that nearly fill a block leave no room for the row groups'
    partial accumulators: the plan stays in the wave regime; forced off,
    any small launch does."""
    k, r = 28, 30  # 28 x 256 x 32 table bytes: 224 KiB
    assert gf_cuda.smem_bytes(k, r) <= gf_cuda.MAX_SMEM
    assert gf_cuda.split_smem_bytes(k, r, 256, 8) > gf_cuda.MAX_SMEM
    assert gf_cuda.plan(1, k, r, 4096).regime == "wave"
    assert gf_cuda.plan(1, 12, 4, 87382, small=False).regime == "wave"


def test_plan_launches_counted_by_regime(monkeypatch):
    """Each wrapper counts its GF-core launches by plan regime, and
    /api/tpu exports them as minio_tpu_gf_core_launches_total{kernel, plan}."""
    import collections

    from minio_tpu_torch.server import metrics

    monkeypatch.setattr(gf_cuda, "plan_launches", collections.Counter())
    gf_cuda.count_plan_launch("gf_apply", gf_cuda.plan(1, 12, 4, 87382))
    gf_cuda.count_plan_launch("gf_apply", gf_cuda.plan(64, 12, 4, 87382))
    gf_cuda.count_plan_launch("fused_encode_hash", gf_cuda.plan(1, 8, 8, 131072))
    gf_cuda.count_plan_launch("fused_encode_hash", gf_cuda.plan(1, 8, 8, 131072))
    assert gf_cuda.plan_launches == {("gf_apply", "small"): 1, ("gf_apply", "wave"): 1,
                                     ("fused_encode_hash", "small"): 2}
    lines = [ln for ln in metrics._g_api_tpu(None)
             if ln.startswith("minio_tpu_gf_core_launches_total{")]
    assert lines == [
        'minio_tpu_gf_core_launches_total{kernel="fused_encode_hash",plan="small"} 2',
        'minio_tpu_gf_core_launches_total{kernel="gf_apply",plan="small"} 1',
        'minio_tpu_gf_core_launches_total{kernel="gf_apply",plan="wave"} 1']


def test_plan_main_path_spread():
    # K1's decode windows (B=16) still give every SM a block, and K3 at
    # 16x16 takes its 64 KiB tables three blocks to an SM
    for m in range(1, 9):
        assert gf_cuda.plan(16, 8, m, 131072).grid >= 132
    p = gf_cuda.plan(256, 16, 16, 65536)
    assert (p.entry, p.cols, p.blocks_per_sm, p.grid) == (16, 8, 3, 396)
    p = gf_cuda.plan(256, 8, 8, 131072)
    assert (p.entry, p.cols, p.blocks_per_sm, p.smem_bytes) == (8, 8, 4, 16384 + 128)
    # K3 at 8x24: rows of 43,691 bytes end in a third of a column tile
    p = gf_cuda.plan(256, 24, 8, 43691)
    assert (p.tiles, p.blocks_per_sm, p.waves, p.grid) == (256 * 22, 4, 8, 8 * 132 * 4)


def test_plan_refuses_tables_over_a_block():
    with pytest.raises(ValueError, match="shared memory"):
        gf_cuda.plan(1, 32, 32, 1024)


# -- the loads at any row offset --------------------------------------------------

M32 = 0xFFFFFFFF


def _fetch_align(mem: bytes, a: int, rem: int, c: int) -> bytes:
    """gf_fetch then gf_align of gf_core.cuh: the C bytes at mem[a:] with
    rem bytes of the row left, as the kernel assembles them."""
    w = c // 4
    if rem < c:  # the row's last columns, byte by byte, zero past rem
        return bytes(mem[a: a + rem]) + bytes(c - rem)
    m = a % c
    lo = a - m
    chunks = mem[lo: lo + (2 * c if m else c)]
    assert lo <= a and (not m or lo + c <= a + c - 1)  # both loads hold a byte of the row
    y = [int.from_bytes(chunks[4 * i: 4 * i + 4], "little") for i in range(len(chunks) // 4)]
    if m == 0:
        x = y[:w]
    else:
        q, sh = m >> 2, (m & 3) * 8
        x = [(((y[i + q + 1] << 32) | y[i + q]) >> sh) & M32 for i in range(w)]
    return b"".join(v.to_bytes(4, "little") for v in x)


@pytest.mark.parametrize("c", [8, 16])
def test_loads_at_every_offset_and_tail(c):
    mem = np.random.default_rng(c).integers(0, 256, 256, dtype=np.uint8).tobytes()
    for start in range(16):
        for n in (1, c - 1, c, c + 1, 43, 96):
            for col in range(0, n, c):
                rem = n - col
                got = _fetch_align(mem, 64 + start + col, rem, c)
                want = mem[64 + start + col: 64 + start + col + min(rem, c)]
                assert got[: min(rem, c)] == want


# -- a torch model of the kernel's arithmetic --------------------------------------

SELECTORS = {"lo_pairs": 0x5140, "hi_pairs": 0x7362, "even_rows": 0x5410, "odd_rows": 0x7632,
             "extract": 0x4440}


def _byte_perm(x: torch.Tensor, y: torch.Tensor, s: int) -> torch.Tensor:
    """CUDA's __byte_perm on int64 tensors holding 32-bit words: byte i of
    the result is byte (s >> 4i) & 7 of the 8 bytes y:x."""
    src = x | (y << 32)
    out = torch.zeros_like(x)
    for i in range(4):
        out |= ((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
    return out


def _words(u8: torch.Tensor) -> torch.Tensor:
    """[..., 4m] uint8 -> [..., m] little-endian 32-bit words in int64."""
    v = u8.to(torch.int64).reshape(*u8.shape[:-1], u8.shape[-1] // 4, 4)
    return v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16) | (v[..., 3] << 24)


def _core_model(data: np.ndarray, wide: np.ndarray, r: int) -> np.ndarray:
    """gf_core.cuh's arithmetic on [B, k, n] bytes with the [k, 256, E*G]
    tables: per output group, the E-byte entry of each input byte XORed
    into a column's accumulator words (acc[c][q] = rows 4q..4q+3), then the
    4x4 byte transposes into row words. Columns past n are zero (the
    kernel's tail loads) and never stored."""
    b, k, n = data.shape
    p = gf_cuda.plan(max(b, 1), k, r, max(n, 1))
    e, g, c = p.entry, p.groups, p.cols
    cols = -(-n // c) * c
    x = torch.zeros((b, k, cols), dtype=torch.int64)
    x[..., :n] = torch.from_numpy(data).to(torch.int64)
    ent = _words(torch.from_numpy(wide))  # [k, 256, E*G/4]
    out = np.zeros((b, r, n), dtype=np.uint8)
    for gi in range(g):
        acc = torch.zeros((b, cols, e // 4), dtype=torch.int64)
        for j in range(k):
            # the extract selector takes byte c & 3 of the input word
            word = _words(x[:, j].to(torch.uint8))  # [b, cols/4]
            for t in range(4):
                xb = _byte_perm(word, torch.zeros_like(word), SELECTORS["extract"] | t)
                acc[:, t::4] ^= ent[j][xb][..., gi * e // 4: (gi + 1) * e // 4]
        a = acc.reshape(b, cols // 4, 4, e // 4)
        for q in range(e // 4):
            a0, a1, a2, a3 = (a[:, :, i, q] for i in range(4))
            t0 = _byte_perm(a0, a1, SELECTORS["lo_pairs"])
            t1 = _byte_perm(a0, a1, SELECTORS["hi_pairs"])
            t2 = _byte_perm(a2, a3, SELECTORS["lo_pairs"])
            t3 = _byte_perm(a2, a3, SELECTORS["hi_pairs"])
            rows = [_byte_perm(t0, t2, SELECTORS["even_rows"]),
                    _byte_perm(t0, t2, SELECTORS["odd_rows"]),
                    _byte_perm(t1, t3, SELECTORS["even_rows"]),
                    _byte_perm(t1, t3, SELECTORS["odd_rows"])]
            for t, wv in enumerate(rows):
                i = gi * e + 4 * q + t
                if i < r:  # padding rows are never stored
                    by = torch.stack([(wv >> (8 * s)) & 0xFF for s in range(4)], dim=-1)
                    out[:, i] = by.reshape(b, cols)[:, :n].to(torch.uint8).numpy()
    return out


def test_selectors_are_the_kernels():
    with open(os.path.join(_build.CSRC, "gf_core.cuh")) as fh:
        src = fh.read()
    for s in SELECTORS.values():
        assert f"0x{s:04x}" in src


# (bits, k, r, n): the cauchy composites of 16-drive sets and small ones,
# and binary matrices of no GF map (entries of 4, 8 and 16 bytes, and two
# row groups); the Pallas interpreter costs ~1 s a call
PALLAS_CASES = [
    ("cauchy", (8, 8), 1001), ("cauchy", (12, 4), 43), ("cauchy", (2, 2), 17),
    ("cauchy", (5, 3), 7), ("binary", (3, 5), 15), ("binary", (6, 24), 33),
    ("binary", (20, 7), 21),
]


@pytest.mark.parametrize("kind,shape,n", PALLAS_CASES, ids=lambda v: str(v))
def test_model_matches_pallas_interpret(kind, shape, n):
    if kind == "cauchy":
        d, p = shape
        w, k, r = _composite_bits(d, p), 2 * d, 2 * p
    else:
        r, k = shape
        w = _random_bits(n * 7 + r, r, k)
    x = np.random.default_rng(k * 31 + n).integers(0, 256, size=(2, k, n), dtype=np.uint8)
    wide = gf_cuda.wide_tables(rs_cuda.bitplane_tables(w))
    want = np.asarray(rs_pallas.gf_apply_pallas(w, x, r, interpret=True))
    assert np.array_equal(_core_model(x, wide, r), want)


@pytest.mark.parametrize("n", [1, 15, 17, 1024, 1037])
def test_model_matches_gf_matvec_for_k1(n):
    """K1's encode matrix at 8+8 and 4+2, and its decode matrices for
    1..8 rebuilt rows at 8+8 (entries of 4 and 8 bytes)."""
    rng = np.random.default_rng(n)
    mats = [ref_rs.get_codec(8, 8).parity_matrix, ref_rs.get_codec(4, 2).parity_matrix]
    for lost in range(1, 9):
        present = tuple(range(lost, 16))[:8]
        mats.append(fused_cuda.decode_matrix(8, 8, present, tuple(range(lost))))
    for m in mats:
        r, d = m.shape
        x = rng.integers(0, 256, size=(3, d, n), dtype=np.uint8)
        got = _core_model(x, gf_cuda.wide_tables(fused_cuda.gf_tables(m)), r)
        for bi in range(3):
            assert np.array_equal(got[bi], ref_gf.gf_matvec_blocks(m, x[bi]))


@pytest.mark.parametrize("b,n", [(0, 16), (2, 0), (0, 0)])
def test_model_and_wrapper_on_empty_inputs(b, n):
    w = _composite_bits(4, 2)
    x = np.zeros((b, 8, n), dtype=np.uint8)
    wide = gf_cuda.wide_tables(rs_cuda.bitplane_tables(w))
    assert _core_model(x, wide, 4).shape == (b, 4, n)
    got = rs_cuda.gf_apply_cuda(w, torch.from_numpy(x), 4)
    assert got.shape == (b, 4, n) and got.dtype == torch.uint8
