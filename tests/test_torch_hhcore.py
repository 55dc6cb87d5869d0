"""The HighwayHash core of K1 and K2 (``csrc/hh_core.cuh``): what the CPU
can hold of it.

- Lane-pair independence on the port's plain hash state
  (``bitrot_torch._St`` / ``_update``): whole-packet rounds never carry a
  value between lanes 0-1 and lanes 2-3, which is what lets the core run
  one thread per lane pair with no exchange in its hot loop.
- A scalar model of the core's split (two pair states, the remainder
  assembled whole and halved, finalization fed the partner pair's v0)
  against the JAX package's HighwayHash, at every remainder length.
- The round in 32-bit words, as the core's SASS runs it (64-bit adds as
  low-word sums whose carries feed the high words, the zipper as byte
  permutes, 32x32->64 products), against the port's HighwayHash round on
  random states.
- A model of the ring's copy windows and the consumers' reads at every
  row start 0-31: the chunks copied hold only message bytes and fit their
  slot, and the bytes read back are the packet halves, through the four
  4-byte reads and shift of the generic path and, where the row start is
  16-byte aligned, through the aligned path's one 16-byte read.
- The read-path choice (``bitrot_cuda.aligned``): a launch takes the
  aligned path exactly when every row start is 16-byte aligned, for K2's
  contiguous rows and K1's input and output rows; and its counter.
- ``bitrot_cuda.plan`` at every main-path shape and at short and odd
  lengths: shared memory, stage bytes, grid coverage and spread.
"""

import numpy as np
import pytest
import torch

from minio_tpu.ops.highwayhash import hash256_batch_numpy
from minio_tpu_torch.ops import bitrot_cuda, bitrot_torch
from minio_tpu_torch.ops.highwayhash import (
    INIT0, INIT1, MINIO_KEY, HighwayHash256, _zipper_merge_add)

M64 = (1 << 64) - 1
M32 = 0xFFFFFFFF

# (rows, n) of every hash-core launch on the smoke's main path: K2 on the
# RS 12+4 shards, the cauchy 8+8 / 12+4 sub-chunks, the single chain; K1
# encode at B=256 / 64 / 1 (8+8), decode at B=8 and 16 with 1-8 shards
# lost, heal B=64
MAIN_PATH = [
    (1024, 87382), (4096, 87382), (8192, 65536), (2048, 65536), (512, 65536),
    (8192, 43691), (2048, 43691), (1, 131072),
    (256 * 16, 131072), (64 * 16, 131072), (16, 131072),
    *[(b * (8 + m), 131072) for b in (8, 16) for m in range(1, 9)],
]
ODD_N = [0, 1, 31, 32, 33, 43691, 87382]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MINIO_TPU_TORCH_DEVICE", "cpu")


# -- lane-pair independence on the plain state --------------------------------

def _state_after(packets: np.ndarray):
    """Plain hash state after the whole-packet rounds of [B, P*32] bytes."""
    b = packets.shape[0]
    s = bitrot_torch._init_state(b, MINIO_KEY, "cpu")
    hi, lo = bitrot_torch._packet_halves(torch.from_numpy(packets))
    for p in range(hi.shape[0]):
        bitrot_torch._update(s, hi[p], lo[p])
    return s


@pytest.mark.parametrize("rounds", [1, 2, 5, 33])
@pytest.mark.parametrize("shared", [0, 1])
def test_lane_pairs_independent(rounds, shared):
    """Packets that agree in bytes 16*shared .. 16*shared+15 of every
    packet keep identical lanes 2*shared, 2*shared+1; the other pair,
    fed different bytes, differs."""
    rng = np.random.default_rng(rounds * 2 + shared)
    a = rng.integers(0, 256, size=(5, rounds * 32), dtype=np.uint8)
    b = rng.integers(0, 256, size=(5, rounds * 32), dtype=np.uint8)
    view_a, view_b = a.reshape(5, rounds, 32), b.reshape(5, rounds, 32)
    keep = slice(16 * shared, 16 * shared + 16)
    view_b[:, :, keep] = view_a[:, :, keep]
    sa, sb = _state_after(a), _state_after(b)
    same, other = slice(2 * shared, 2 * shared + 2), slice(2 - 2 * shared, 4 - 2 * shared)
    for field in bitrot_torch._St.__slots__:
        fa, fb = getattr(sa, field), getattr(sb, field)
        assert torch.equal(fa[same], fb[same]), field
    assert not torch.equal(sa.v1h[other], sb.v1h[other])


# -- scalar model of the two-thread split -----------------------------------

def _pair_reset(key: bytes, q: int) -> list[list[int]]:
    k = [int.from_bytes(key[8 * i: 8 * i + 8], "little") for i in range(4)]
    lanes = (2 * q, 2 * q + 1)
    rot = [((x >> 32) | (x << 32)) & M64 for x in k]
    return [[INIT0[i] ^ k[i] for i in lanes], [INIT1[i] ^ rot[i] for i in lanes],
            [INIT0[i] for i in lanes], [INIT1[i] for i in lanes]]


def _pair_update(st, a) -> None:
    """hh_update of highwayhash.cuh: one round on a lane pair."""
    v0, v1, mul0, mul1 = st
    for i in range(2):
        v1[i] = (v1[i] + mul0[i] + a[i]) & M64
        mul0[i] ^= ((v1[i] & M32) * (v0[i] >> 32)) & M64
        v0[i] = (v0[i] + mul1[i]) & M64
        mul1[i] ^= ((v0[i] & M32) * (v1[i] >> 32)) & M64
    v0[1], v0[0] = _zipper_merge_add(v1[1], v1[0], v0[1], v0[0])
    v1[1], v1[0] = _zipper_merge_add(v0[1], v0[0], v1[1], v1[0])


def _pair_remainder(st, rem: bytes, q: int) -> None:
    size = len(rem)
    v0, v1 = st[0], st[1]
    for i in range(2):
        v0[i] = (v0[i] + (size << 32) + size) & M64
        lo, hi = v1[i] & M32, v1[i] >> 32
        lo = ((lo << size) | (lo >> (32 - size))) & M32
        hi = ((hi << size) | (hi >> (32 - size))) & M32
        v1[i] = (hi << 32) | lo
    packet = bytearray(32)
    whole4 = size & ~3
    packet[:whole4] = rem[:whole4]
    if size & 16:
        packet[28:32] = rem[size - 4: size]
    elif size & 3:
        packet[16] = rem[whole4]
        packet[17] = rem[whole4 + ((size & 3) >> 1)]
        packet[18] = rem[whole4 + (size & 3) - 1]
    half = packet[16 * q: 16 * q + 16]
    _pair_update(st, [int.from_bytes(half[:8], "little"), int.from_bytes(half[8:], "little")])


def _split_hash(msg: bytes, key: bytes = MINIO_KEY) -> bytes:
    """The core's hash of one message, as its two threads compute it."""
    pairs = [_pair_reset(key, 0), _pair_reset(key, 1)]
    whole = len(msg) - len(msg) % 32
    for off in range(0, whole, 32):
        for q in (0, 1):
            half = msg[off + 16 * q: off + 16 * q + 16]
            _pair_update(pairs[q], [int.from_bytes(half[:8], "little"),
                                    int.from_bytes(half[8:], "little")])
    if len(msg) > whole:
        for q in (0, 1):
            _pair_remainder(pairs[q], msg[whole:], q)
    rot = lambda x: ((x >> 32) | (x << 32)) & M64  # noqa: E731
    for _ in range(10):
        partner_v0 = [list(pairs[1][0]), list(pairs[0][0])]  # the warp shuffle
        for q in (0, 1):
            _pair_update(pairs[q], [rot(partner_v0[q][0]), rot(partner_v0[q][1])])
    out = b""
    for v0, v1, mul0, mul1 in pairs:
        a0, a1 = (v0[0] + mul0[0]) & M64, (v0[1] + mul0[1]) & M64
        a2, a3 = (v1[0] + mul1[0]) & M64, (v1[1] + mul1[1]) & 0x3FFFFFFFFFFFFFFF
        m1 = a1 ^ (((a3 << 1) | (a2 >> 63)) & M64) ^ (((a3 << 2) | (a2 >> 62)) & M64)
        m0 = a0 ^ ((a2 << 1) & M64) ^ ((a2 << 2) & M64)
        out += m0.to_bytes(8, "little") + m1.to_bytes(8, "little")
    return out


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (s >> 4i) & 7 of
    the 8 bytes y:x."""
    src = x | (y << 32)
    return sum(((src >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


@pytest.mark.parametrize("seed", range(8))
def test_zipper_as_byte_permutes(seed):
    """highwayhash.cuh's zipper merge (six byte permutes) equals the
    reference's masks and shifts."""
    rng = np.random.default_rng(seed)
    v1, v0, add1, add0 = (int(x) for x in rng.integers(0, 1 << 64, 4, dtype=np.uint64))
    a_lo, a_hi, b_lo, b_hi = v0 & M32, v0 >> 32, v1 & M32, v1 >> 32
    z0 = _byte_perm(_byte_perm(a_lo, b_hi, 0x0243), a_hi, 0x5210) | \
        (_byte_perm(a_lo, b_hi, 0x0716) << 32)
    z1 = _byte_perm(_byte_perm(b_lo, a_hi, 0x0243), b_hi, 0x5210) | \
        (_byte_perm(b_lo, a_hi, 0x7061) << 32)
    assert _zipper_merge_add(v1, v0, add1, add0) == ((add1 + z1) & M64, (add0 + z0) & M64)


def _add64(*xs: int) -> int:
    """A 64-bit sum of two or three words as IADD3 and IADD3.X run it: the
    low words' sum, then the high words' sum with its carry (0-2), each
    kept to 32 bits."""
    lo = sum(x & M32 for x in xs)
    hi = (sum(x >> 32 for x in xs) + (lo >> 32)) & M32
    return (hi << 32) | (lo & M32)


def _xor64(x: int, y: int) -> int:
    """A 64-bit xor as two 32-bit LOP3s."""
    return (((x >> 32) ^ (y >> 32)) << 32) | ((x ^ y) & M32)


def _zipper_words(v1: int, v0: int) -> tuple[int, int]:
    """hh_zipper: (z1, z0) from six byte permutes of the four 32-bit words."""
    a_lo, a_hi, b_lo, b_hi = v0 & M32, v0 >> 32, v1 & M32, v1 >> 32
    z0 = _byte_perm(_byte_perm(a_lo, b_hi, 0x0243), a_hi, 0x5210) | \
        (_byte_perm(a_lo, b_hi, 0x0716) << 32)
    z1 = _byte_perm(_byte_perm(b_lo, a_hi, 0x0243), b_hi, 0x5210) | \
        (_byte_perm(b_lo, a_hi, 0x7061) << 32)
    return z1, z0


def _word_round(st, a) -> None:
    """hh_update of highwayhash.cuh on one lane pair, in 32-bit words."""
    v0, v1, mul0, mul1 = st
    for i in range(2):
        v1[i] = _add64(v1[i], mul0[i], a[i])
        mul0[i] = _xor64(mul0[i], (v1[i] & M32) * (v0[i] >> 32))
        v0[i] = _add64(v0[i], mul1[i])
        mul1[i] = _xor64(mul1[i], (v0[i] & M32) * (v1[i] >> 32))
    z1, z0 = _zipper_words(v1[1], v1[0])
    v0[0], v0[1] = _add64(v0[0], z0), _add64(v0[1], z1)
    z1, z0 = _zipper_words(v0[1], v0[0])
    v1[0], v1[1] = _add64(v1[0], z0), _add64(v1[1], z1)


@pytest.mark.parametrize("seed", range(8))
def test_word_round_matches_port_round(seed):
    """The round as the core's instructions compute it, on each lane pair of
    a random state, equals ``HighwayHash256._update`` on the whole state,
    packet after packet (carries out of the low words and 64-bit
    wraparound included: states near 2^64 are drawn on purpose)."""
    rng = np.random.default_rng(1000 + seed)
    ref = HighwayHash256()
    draw = lambda: [int(x) for x in rng.integers(0, 1 << 64, 4, dtype=np.uint64)]  # noqa: E731
    ref.v0, ref.v1, ref.mul0, ref.mul1 = draw(), draw(), draw(), draw()
    ref.v1[0] = M64 - int(rng.integers(0, 1 << 16))  # low-word carries and wraparound
    pairs = [[list(f[2 * q: 2 * q + 2]) for f in (ref.v0, ref.v1, ref.mul0, ref.mul1)]
             for q in (0, 1)]
    for _ in range(5):
        packet = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        ref._update(packet)
        for q in (0, 1):
            half = packet[16 * q: 16 * q + 16]
            _word_round(pairs[q], [int.from_bytes(half[:8], "little"),
                                   int.from_bytes(half[8:], "little")])
        for f, field in enumerate((ref.v0, ref.v1, ref.mul0, ref.mul1)):
            assert pairs[0][f] + pairs[1][f] == field


@pytest.mark.parametrize("n", [0, 1, 3, 4, 15, 16, 17, 19, 31, 32, 33, 63, 64, 95, 100])
def test_split_model_matches_jax_package(n):
    msgs = np.random.default_rng(100 + n).integers(0, 256, size=(3, n), dtype=np.uint8)
    want = hash256_batch_numpy(msgs)
    for i in range(3):
        assert _split_hash(msgs[i].tobytes()) == want[i].tobytes()


# -- the ring's copy windows and the 16-byte shift ---------------------------

def _load16(slot: bytes, off: int, r: int) -> bytes:
    """hh_load16: five 4-byte words from offset off (a multiple of 4),
    funnel-shifted right by r & 3 bytes."""
    x = [int.from_bytes(slot[off + 4 * i: off + 4 * i + 4], "little") for i in range(5)]
    sh = 8 * (r & 3)
    o = [(((x[i + 1] << 32) | x[i]) >> sh) & M32 for i in range(4)]
    return b"".join(v.to_bytes(4, "little") for v in o)


@pytest.mark.parametrize("n", [32, 33, 95, 1000, 4097])
@pytest.mark.parametrize("start", range(32))
def test_ring_windows_model(n, start):
    """Copy every window of a row starting at byte `start` of a buffer it
    ends, as the copiers do (32-byte sectors, trimmed to 16-byte chunks at
    the row's ends), and read it back as the consumers do."""
    p = bitrot_cuda.plan(1, n)
    mem = np.random.default_rng(n * 32 + start).integers(0, 256, start + n, dtype=np.uint8)
    row = mem[start:].tobytes()
    whole = n - n % 32
    w = p.stage_bytes
    r = start & 31
    for k in range(-(-whole // w)):
        a = start + k * w
        y = a + min(w, whole - k * w)
        a32 = a & ~31
        lo = max(a32, start & ~15)
        hi = min((y + 31) & ~31, (start + n + 15) & ~15)
        assert (hi - lo) % 16 == 0 and hi - a32 <= p.slot_bytes
        for chunk in range(lo, hi, 16):  # every chunk holds a byte of the row
            assert start <= chunk + 15 and chunk < start + n
        slot = bytearray(p.slot_bytes)
        slot[lo - a32: hi - a32] = mem[lo:hi].tobytes()
        assert a - a32 == r
        for pk in range((y - a) // 32):
            for q in (0, 1):
                off = 32 * pk + 16 * q + (r & 28)
                assert off + 20 <= p.slot_bytes  # reads stay in the slot
                got = _load16(bytes(slot), off, r)
                want = row[k * w + 32 * pk + 16 * q: k * w + 32 * pk + 16 * q + 16]
                assert got == want


@pytest.mark.parametrize("n", [32, 33, 95, 1000, 4097, 131072])
@pytest.mark.parametrize("start", [0, 16, 32, 48])
def test_ring_windows_aligned_reads(n, start):
    """Where the row start is 16-byte aligned (r = 0 or 16), the aligned
    path reads each packet half of every window as one 16-byte aligned
    read at 32p + 16q + r in the slot, inside the slot, and gets the
    generic path's bytes. Every read is of a packet the window holds: the
    read issued a round ahead stops at the window's last packet."""
    p = bitrot_cuda.plan(1, n)
    mem = np.random.default_rng(n + start).integers(0, 256, start + n, dtype=np.uint8)
    row = mem[start:].tobytes()
    whole = n - n % 32
    w, r = p.stage_bytes, start & 31
    assert r in (0, 16)
    for k in range(-(-whole // w)):
        a = start + k * w
        y = a + min(w, whole - k * w)
        a32 = a & ~31
        lo = max(a32, start & ~15)
        hi = min((y + 31) & ~31, (start + n + 15) & ~15)
        slot = bytearray(p.slot_bytes)
        slot[lo - a32: hi - a32] = mem[lo:hi].tobytes()
        packets = (y - a) // 32
        assert packets >= 1
        for pk in range(packets):  # the window's rounds, each read one ahead
            for q in (0, 1):
                off = 32 * pk + 16 * q + (r & 28)
                assert off % 16 == 0 and off + 16 <= p.slot_bytes
                got = bytes(slot[off: off + 16])
                assert got == _load16(bytes(slot), off, r)
                assert got == row[k * w + 32 * pk + 16 * q: k * w + 32 * pk + 16 * q + 16]


# -- the read-path choice ------------------------------------------------------

READ_N = [32, 33, 1024, 65536, 87382, 131072]


@pytest.mark.parametrize("n", READ_N)
@pytest.mark.parametrize("off", range(32))
def test_read_path_contiguous_rows(off, n):
    """K2's rows, back to back from ``base``: aligned exactly when every
    row start is 16-byte aligned (one row: its start alone)."""
    base = (1 << 20) + off
    for rows in (1, 2, 7, 1024):
        want = all((base + i * n) % 16 == 0 for i in range(rows))
        assert bitrot_cuda.aligned((base, rows, n)) == want
    assert bitrot_cuda.aligned((base, 0, n))  # no row, nothing misaligned


@pytest.mark.parametrize("n", READ_N)
@pytest.mark.parametrize("off", range(32))
def test_read_path_fused_rows(off, n):
    """K1's shards: B*d input rows from ``data`` and B*r output rows from
    ``out``; the launch is aligned exactly when every start of both is."""
    for b, d, r, out_off in ((1, 1, 1, 0), (1, 8, 8, 16), (16, 8, 8, 0), (2, 12, 4, 8)):
        data, out = (1 << 20) + off, (1 << 24) + out_off
        starts = [data + (i * d + j) * n for i in range(b) for j in range(d)]
        starts += [out + (i * r + j) * n for i in range(b) for j in range(r)]
        want = all(x % 16 == 0 for x in starts)
        assert bitrot_cuda.aligned((data, b * d, n), (out, b * r, n)) == want


def test_core_launches_counted_by_path(monkeypatch):
    """Each hash-core launch counts once under its wrapper and read path,
    and /api/tpu exports the counts as
    minio_tpu_hash_core_launches_total{kernel, path}."""
    import collections

    from minio_tpu_torch.server import metrics

    monkeypatch.setattr(bitrot_cuda, "core_launches", collections.Counter())
    bitrot_cuda.count_core_launch("fused_encode_hash", True)
    bitrot_cuda.count_core_launch("fused_encode_hash", True)
    bitrot_cuda.count_core_launch("fused_encode_hash", False)
    bitrot_cuda.count_core_launch("hh_chain", False)
    assert bitrot_cuda.core_launches == {("fused_encode_hash", "aligned"): 2,
                                         ("fused_encode_hash", "generic"): 1,
                                         ("hh_chain", "generic"): 1}
    lines = [ln for ln in metrics._g_api_tpu(None)
             if ln.startswith("minio_tpu_hash_core_launches_total{")]
    assert lines == [
        'minio_tpu_hash_core_launches_total{kernel="fused_encode_hash",path="aligned"} 2',
        'minio_tpu_hash_core_launches_total{kernel="fused_encode_hash",path="generic"} 1',
        'minio_tpu_hash_core_launches_total{kernel="hh_chain",path="generic"} 1']


# -- the launch plan -----------------------------------------------------------

@pytest.mark.parametrize("rows,n", MAIN_PATH + [(r, n) for n in ODD_N for r in (1, 7, 1000, 8192)])
def test_plan_fits_and_covers(rows, n):
    p = bitrot_cuda.plan(rows, n)
    assert p.smem_bytes <= 227 * 1024
    assert p.smem_bytes >= p.stages * p.msgs * p.slot_bytes + 16 * p.stages
    assert p.stage_bytes % 32 == 0 and p.stage_bytes >= 32
    assert p.slot_bytes == p.stage_bytes + 32
    assert p.ctas * p.msgs >= rows > (p.ctas - 1) * p.msgs
    assert p.ctas >= min(-(-rows // 8), 132)
    assert p.msgs in (8, 16)  # a CTA is one warp, 2 threads a message
    assert len(p.args()) == 5


def test_plan_zero_rows_launches_nothing():
    assert bitrot_cuda.plan(0, 65536).ctas == 0
    assert bitrot_cuda.hash256_blocks(torch.zeros((0, 64), dtype=torch.uint8)).shape == (0, 32)
