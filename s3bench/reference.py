"""The plain reference: what MinIO's erasure set writes for an object.

NumPy only, written from the published algorithms and independent of the
program under test: Reed-Solomon over GF(2^8) with the systematic
Vandermonde matrix of klauspost/reedsolomon (the coder MinIO uses), and
HighwayHash-256 (google/highwayhash) under MinIO's bitrot key. From an
object's bytes it works out every shard file a drive holds: for each
1 MiB stripe block, the shard's 32-byte digest followed by the shard.
"""

from __future__ import annotations

import numpy as np

BLOCK_SIZE = 1 << 20  # MinIO's erasure stripe block (blockSizeV2)
DIGEST = 32

# -- GF(2^8), polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11d), generator 2 ------

_EXP = np.zeros(512, dtype=np.int64)
_LOG = np.zeros(256, dtype=np.int64)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
_EXP[255:510] = _EXP[:255]
del _x, _i

# MUL[a, b] = a * b in GF(2^8)
MUL = np.zeros((256, 256), dtype=np.uint8)
MUL[1:, 1:] = _EXP[(_LOG[1:, None] + _LOG[None, 1:]) % 255]


def gf_mul(a: int, b: int) -> int:
    return int(MUL[a, b])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(_EXP[(255 - _LOG[a]) % 255])


def gf_exp(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] * n) % 255])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = 0
            for k in range(a.shape[1]):
                acc ^= gf_mul(int(a[i, k]), int(b[k, j]))
            out[i, j] = acc
    return out


def gf_invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square GF(2^8) matrix."""
    n = m.shape[0]
    a = [[int(v) for v in row] + [int(i == j) for j in range(n)] for i, row in enumerate(m)]
    for c in range(n):
        piv = next((r for r in range(c, n) if a[r][c]), None)
        if piv is None:
            raise ValueError("singular matrix")
        a[c], a[piv] = a[piv], a[c]
        inv = gf_inv(a[c][c])
        a[c] = [gf_mul(v, inv) for v in a[c]]
        for r in range(n):
            if r != c and a[r][c]:
                f = a[r][c]
                a[r] = [v ^ gf_mul(f, w) for v, w in zip(a[r], a[c])]
    return np.array([row[n:] for row in a], dtype=np.uint8)


def rs_matrix(d: int, p: int) -> np.ndarray:
    """klauspost/reedsolomon's encoding matrix: the (d+p) x d Vandermonde
    matrix (r^c) times the inverse of its top d x d square, so the top
    is the identity and the bottom p rows make the parity."""
    vm = np.array([[gf_exp(r, c) for c in range(d)] for r in range(d + p)], dtype=np.uint8)
    return gf_matmul(vm, gf_invert(vm[:d]))


_PARITY: dict = {}


def parity_rows(d: int, p: int) -> np.ndarray:
    if (d, p) not in _PARITY:
        _PARITY[(d, p)] = rs_matrix(d, p)[d:]
    return _PARITY[(d, p)]


def rs_encode(shards: np.ndarray, p: int) -> np.ndarray:
    """data shards [d, n] uint8 -> parity shards [p, n]."""
    d = shards.shape[0]
    rows = parity_rows(d, p)
    out = np.zeros((p, shards.shape[1]), dtype=np.uint8)
    for i in range(p):
        for j in range(d):
            c = int(rows[i, j])
            if c:
                out[i] ^= MUL[c][shards[j]]
    return out


# -- HighwayHash-256 --------------------------------------------------------

# MinIO's bitrot key (cmd/bitrot.go magicHighwayHash256Key): the
# HighwayHash-256, under the zero key, of the first 100 decimals of pi
MINIO_KEY = bytes.fromhex("4be734fa8e238acd263e83e6bb968552040f935da39f441497e09d1322de36a0")

_INIT0 = np.array([0xDBE6D5D5FE4CCE2F, 0xA4093822299F31D0, 0x13198A2E03707344,
                   0x243F6A8885A308D3], dtype=np.uint64)
_INIT1 = np.array([0x3BD39E10CB0EF593, 0xC0ACF169B5F18A8C, 0xBE5466CF34E90C6C,
                   0x452821E638D01377], dtype=np.uint64)
_LO32 = np.uint64(0xFFFFFFFF)
_U = np.uint64


def _zipper(v1, v0):
    """The two addends ZipperMergeAndAdd adds to (add1, add0)."""
    a0 = ((((v0 & _U(0xFF000000)) | (v1 & _U(0xFF00000000))) >> _U(24))
          | (((v0 & _U(0xFF0000000000)) | (v1 & _U(0xFF000000000000))) >> _U(16))
          | (v0 & _U(0xFF0000)) | ((v0 & _U(0xFF00)) << _U(32))
          | ((v1 & _U(0xFF00000000000000)) >> _U(8)) | (v0 << _U(56)))
    a1 = ((((v1 & _U(0xFF000000)) | (v0 & _U(0xFF00000000))) >> _U(24))
          | (v1 & _U(0xFF0000)) | ((v1 & _U(0xFF0000000000)) >> _U(16))
          | ((v1 & _U(0xFF00)) << _U(24)) | ((v0 & _U(0xFF000000000000)) >> _U(8))
          | ((v1 & _U(0xFF)) << _U(48)) | (v0 & _U(0xFF00000000000000)))
    return a1, a0


class _State:
    """HighwayHash state for R messages at once: arrays [R, 4] of uint64."""

    def __init__(self, rows: int, key: bytes):
        k = np.frombuffer(key, dtype="<u8").astype(np.uint64)
        self.mul0 = np.tile(_INIT0, (rows, 1))
        self.mul1 = np.tile(_INIT1, (rows, 1))
        self.v0 = self.mul0 ^ k
        self.v1 = self.mul1 ^ ((k >> _U(32)) | (k << _U(32)))

    def update(self, lanes: np.ndarray) -> None:
        v0, v1, mul0, mul1 = self.v0, self.v1, self.mul0, self.mul1
        v1 += mul0 + lanes
        mul0 ^= (v1 & _LO32) * (v0 >> _U(32))
        v0 += mul1
        mul1 ^= (v0 & _LO32) * (v1 >> _U(32))
        for hi, lo in ((1, 0), (3, 2)):
            a1, a0 = _zipper(v1[:, hi], v1[:, lo])
            v0[:, hi] += a1
            v0[:, lo] += a0
        for hi, lo in ((1, 0), (3, 2)):
            a1, a0 = _zipper(v0[:, hi], v0[:, lo])
            v1[:, hi] += a1
            v1[:, lo] += a0

    def remainder(self, tail: np.ndarray) -> None:
        """The last size % 32 bytes of each message ([R, m], 0 < m < 32)."""
        m = tail.shape[1]
        self.v0 += _U((m << 32) + m)
        if m:
            h0 = self.v1 & _LO32
            h1 = self.v1 >> _U(32)
            c, r = _U(m), _U(32 - m)
            self.v1 = (((h0 << c) | (h0 >> r)) & _LO32) | ((((h1 << c) | (h1 >> r)) & _LO32) << _U(32))
        packet = np.zeros((tail.shape[0], 32), dtype=np.uint8)
        m4 = m & 3
        whole = m & ~3
        packet[:, :whole] = tail[:, :whole]
        rem = tail[:, whole:]
        if m & 16:
            for i in range(4):
                packet[:, 28 + i] = tail[:, whole + i + m4 - 4]
        elif m4:
            packet[:, 16] = rem[:, 0]
            packet[:, 17] = rem[:, m4 >> 1]
            packet[:, 18] = rem[:, m4 - 1]
        self.update(packet.view("<u8").astype(np.uint64))

    def finalize(self) -> np.ndarray:
        for _ in range(10):
            v0 = self.v0
            perm = np.stack([v0[:, 2], v0[:, 3], v0[:, 0], v0[:, 1]], axis=1)
            self.update((perm >> _U(32)) | (perm << _U(32)))
        out = np.zeros((self.v0.shape[0], 4), dtype=np.uint64)
        for hi, lo in ((1, 0), (3, 2)):
            a3 = (self.v1[:, hi] + self.mul1[:, hi]) & _U(0x3FFFFFFFFFFFFFFF)
            a2 = self.v1[:, lo] + self.mul1[:, lo]
            a1 = self.v0[:, hi] + self.mul0[:, hi]
            a0 = self.v0[:, lo] + self.mul0[:, lo]
            out[:, hi] = a1 ^ ((a3 << _U(1)) | (a2 >> _U(63))) ^ ((a3 << _U(2)) | (a2 >> _U(62)))
            out[:, lo] = a0 ^ (a2 << _U(1)) ^ (a2 << _U(2))
        return out.astype("<u8").view(np.uint8).reshape(-1, 32)


def highwayhash256(msgs: np.ndarray, key: bytes = MINIO_KEY) -> np.ndarray:
    """HighwayHash-256 of R equal-length messages [R, n] uint8 -> [R, 32]."""
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    rows, n = msgs.shape
    st = _State(rows, key)
    full = n // 32
    if full:
        lanes = msgs[:, : full * 32].reshape(rows, full * 32).view("<u8").reshape(rows, full, 4)
        with np.errstate(over="ignore"):
            for i in range(full):
                st.update(lanes[:, i].astype(np.uint64))
    with np.errstate(over="ignore"):
        if n % 32:
            st.remainder(msgs[:, full * 32:])
        return st.finalize()


# -- what the drives hold ---------------------------------------------------

def shard_size(block_len: int, d: int) -> int:
    return -(-block_len // d)


def shard_files(data: bytes, d: int, p: int) -> list[bytes]:
    """The d + p shard files of an object written in one part, in erasure
    index order: per stripe block, digest || shard."""
    blocks = [data[o:o + BLOCK_SIZE] for o in range(0, len(data), BLOCK_SIZE)]
    groups: dict[int, list[np.ndarray]] = {}
    order = []
    for b in blocks:
        n = shard_size(len(b), d)
        arr = np.zeros(d * n, dtype=np.uint8)
        arr[: len(b)] = np.frombuffer(b, dtype=np.uint8)
        shards = arr.reshape(d, n)
        full = np.concatenate([shards, rs_encode(shards, p)], axis=0)
        groups.setdefault(n, []).append(full)
        order.append((n, len(groups[n]) - 1))
    digests = {n: highwayhash256(np.concatenate(g, axis=0)).reshape(len(g), d + p, DIGEST)
               for n, g in groups.items()}
    files = [bytearray() for _ in range(d + p)]
    for n, j in order:
        shards = groups[n][j]
        for i in range(d + p):
            files[i] += digests[n][j, i].tobytes()
            files[i] += shards[i].tobytes()
    return [bytes(f) for f in files]
