"""Cauchy MDS + regenerating-style piggyback codec — the "cauchy" family.

Second TPU-batchable erasure family next to ops/rs.py ("reedsolomon"),
recorded per object in xl.meta (ErasureInfo.algorithm) and selected per
storage class (MINIO_TPU_EC_FAMILY*). Two ideas from the literature:

1. **Cauchy MDS construction with XOR-schedule minimization**
   (arXiv:1611.09968): the parity matrix is a systematic Cauchy matrix
   C[i,j] = 1/(x_i + y_j). Every square submatrix of a Cauchy matrix is
   nonsingular, so [I; C] is MDS for any d+p <= 256. Because the whole
   compute plane lowers GF(2^8) matrix applies to binary bit-plane
   matmuls (ops/rs_jax.py), the decode/encode cost is exactly the number
   of ones in the bit-plane expansion — the XOR-gate count of the
   schedule. Construction therefore greedily rescales rows/columns
   (MDS-preserving: diagonal x Cauchy x diagonal stays Cauchy-like) to
   minimize that count; ``xor_gates`` exposes it for bench/docs.

2. **Piggybacked sub-chunks for partial repair** (the piggybacking
   framework of the product-matrix/regenerating-code line, PAPERS.md
   arXiv:1412.3022): each shard block splits into two sub-chunks
   (a = first half, b = second half). Sub-chunk 1 of every shard is a
   plain Cauchy codeword over the a-instance; sub-chunk 2 is a Cauchy
   codeword over the b-instance, except parity rows 1..p-1 additionally
   XOR a *piggyback* — the XOR of the a-sub-chunks of one group of data
   shards. Repairing a single lost data shard i then reads only
     - sub-chunk 2 of d survivors (decode the b-instance -> b_i),
     - sub-chunk 2 of i's piggyback parity (subtract the recomputed
       clean parity -> the piggyback XOR),
     - sub-chunk 1 of i's group mates (peel the XOR -> a_i),
   i.e. about (d + 2 + |group|-1)/2 shard-equivalents instead of the d
   full shards MDS repair reads — >= 25% fewer survivor bytes at EC 8+8
   (ISSUE acceptance; the repair schedule is exact, see
   ``repair_schedule``). Any multi-failure decodes generically: the
   piggyback is a known function of the a-instance and subtracts out.

On-disk framing (erasure/bitrot_io.py): each shard block stores TWO
bitrot frames, ``H(sub1) || sub1 || H(sub2) || sub2``, so sub-chunk
ranged reads stay bitrot-verified without touching the other half.

Byte-identity contract: the numpy paths here are the reference; the
device codec (``CauchyTorchCodec``, K3 reading the sub-chunks in place)
and ``encode_kernel`` (K3 on the explicit composite, the counterpart of
the JAX package's Pallas route) must agree bit-for-bit with it and with
the JAX package (tests/test_torch_cauchy.py).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import device as devmod
from . import decode_cache, gf

FAMILY = "cauchy"
SUB_CHUNKS = 2  # sub-packetization: sub-chunks per shard block

__all__ = [
    "FAMILY",
    "SUB_CHUNKS",
    "sub_lens",
    "xor_gates",
    "cauchy_parity_matrix",
    "CauchyPiggyback",
    "RepairSchedule",
    "get_codec",
    "composite_parity_matrix",
    "CauchyTorchCodec",
    "get_torch_codec",
    "torch_codec_from_matrices",
    "encode_and_hash_cauchy",
    "encode_kernel",
]


# -- XOR-schedule weight ----------------------------------------------------

def _build_weight_table() -> np.ndarray:
    """ones(bit-matrix of multiply-by-c) for every c: the XOR-gate cost of
    one GF constant in the bit-plane lowering (arXiv:1611.09968 measures
    schedules in exactly these gates)."""
    w = np.zeros(256, dtype=np.int32)
    for c in range(256):
        ones = 0
        for i in range(8):
            ones += int(bin(int(gf.MUL_TABLE[c, 1 << i])).count("1"))
        w[c] = ones
    return w


WEIGHT_TABLE = _build_weight_table()


def xor_gates(m: np.ndarray) -> int:
    """Total ones in the bit-plane expansion of a GF matrix — the XOR
    count of the straight-line schedule that applies it."""
    return int(WEIGHT_TABLE[np.asarray(m, dtype=np.uint8)].sum())


def cauchy_parity_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """Systematic Cauchy parity matrix [p, d], XOR-schedule-minimized.

    Base points x_i = i (parity rows), y_j = p + j (data columns) are
    disjoint so every x_i ^ y_j != 0. Greedy improvement: scale each
    column, then each row, by the GF constant minimizing its bit-plane
    weight — diagonal scaling preserves the any-d-rows-invertible MDS
    property of [I; C] (the determinant picks up nonzero scalars only).
    """
    d, p = data_shards, parity_shards
    if d <= 0 or p < 0:
        raise ValueError("invalid shard count")
    if d + p > 256:
        raise ValueError("too many shards (max 256)")
    c = np.zeros((p, d), dtype=np.uint8)
    for i in range(p):
        for j in range(d):
            c[i, j] = gf.INV_TABLE[i ^ (p + j)]

    def _best_scale(vec: np.ndarray) -> int:
        best, best_w = 1, int(WEIGHT_TABLE[vec].sum())
        for s in range(2, 256):
            w = int(WEIGHT_TABLE[gf.MUL_TABLE[s, vec]].sum())
            if w < best_w:
                best, best_w = s, w
        return best

    for j in range(d):
        c[:, j] = gf.MUL_TABLE[_best_scale(c[:, j]), c[:, j]]
    for i in range(p):
        c[i] = gf.MUL_TABLE[_best_scale(c[i]), c[i]]
    return c


def sub_lens(shard_size: int) -> tuple[int, int]:
    """(len(sub-chunk 1), len(sub-chunk 2)) of a shard block. sub1 takes
    the floor half so the piggyback (a-length) always fits inside the
    b-length parity sub-chunk it is XORed into."""
    h1 = shard_size // 2
    return h1, shard_size - h1


@dataclass(frozen=True)
class RepairSchedule:
    """Sub-chunk read plan rebuilding ONE lost data shard.

    All indices are erasure (code) positions. ``b_helpers`` read
    sub-chunk 2 (decode the b-instance), ``pb_parity`` reads sub-chunk 2
    of the piggybacked parity, ``mates`` read sub-chunk 1 (peel the
    piggyback XOR down to a_i)."""

    missing: int
    b_helpers: tuple[int, ...]
    pb_parity: int
    mates: tuple[int, ...]
    helpers: frozenset[int] = field(default=frozenset())

    def reads(self, shard_size: int, digest: int = 32) -> int:
        """Survivor bytes moved (frames included): the repair-bandwidth
        number heal_ingress_bytes reports."""
        h1, h2 = sub_lens(shard_size)
        n2 = len(self.b_helpers) + 1  # + pb_parity
        return n2 * (digest + h2) + len(self.mates) * (digest + h1)


class CauchyPiggyback:
    """Systematic Cauchy(d+p, d) codec with 2-way piggybacked sub-chunks.

    numpy reference implementation; shard-block layout is
    ``shard = a_i || b_i`` with ``len(a_i) = shard_size // 2``.
    """

    family = FAMILY

    def __init__(self, data_shards: int, parity_shards: int):
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.parity_matrix = cauchy_parity_matrix(data_shards, parity_shards)
        self.matrix = np.concatenate(
            [np.eye(data_shards, dtype=np.uint8), self.parity_matrix]
        )  # [t, d] generator, per instance
        # piggyback groups: data shards partitioned round-robin over
        # parity rows 1..p-1 (row 0 stays clean so the b-instance always
        # has one pure parity to decode with). p < 2 -> no piggybacks,
        # the family still works but single-shard repair has no shortcut.
        groups: list[list[int]] = [[] for _ in range(max(parity_shards - 1, 0))]
        if groups:
            for j in range(data_shards):
                groups[j % len(groups)].append(j)
        self.pb_groups = [tuple(g) for g in groups]
        q = np.zeros((parity_shards, data_shards), dtype=np.uint8)
        for gi, grp in enumerate(self.pb_groups):
            for j in grp:
                q[1 + gi, j] = 1
        self.pb_matrix = q

    # -- encoding ----------------------------------------------------------

    def split(self, data: bytes | np.ndarray) -> np.ndarray:
        """bytes -> [t, per] with zero padding; parity rows zeroed."""
        if isinstance(data, np.ndarray):
            if data.dtype != np.uint8 or data.ndim != 1:
                raise ValueError("split expects 1-D uint8 array or bytes")
            buf = data
        else:
            buf = np.frombuffer(bytes(data), dtype=np.uint8)
        if buf.size == 0:
            raise ValueError("empty data")
        per = -(-buf.size // self.data_shards)
        shards = np.zeros((self.total_shards, per), dtype=np.uint8)
        flat = shards[: self.data_shards].reshape(-1)
        flat[: buf.size] = buf
        return shards

    def encode(self, shards: np.ndarray) -> np.ndarray:
        """Fill parity rows in-place from data rows; returns shards."""
        d = self.data_shards
        h1, _h2 = sub_lens(shards.shape[1])
        a = shards[:d, :h1]
        b = shards[:d, h1:]
        shards[d:, :h1] = gf.gf_matvec_blocks(self.parity_matrix, a)
        pb = gf.gf_matvec_blocks(self.parity_matrix, b)
        if h1:
            pb[:, :h1] ^= gf.gf_matvec_blocks(self.pb_matrix, a)
        shards[d:, h1:] = pb
        return shards

    def encode_data(self, data: bytes) -> np.ndarray:
        return self.encode(self.split(data))

    def verify(self, shards: np.ndarray) -> bool:
        expect = np.array(shards[: self.data_shards], dtype=np.uint8, copy=True)
        full = np.concatenate([expect, np.zeros(
            (self.parity_shards, shards.shape[1]), dtype=np.uint8
        )])
        self.encode(full)
        return bool(np.array_equal(full[self.data_shards:],
                                   shards[self.data_shards:]))

    # -- generic decode ----------------------------------------------------

    def _decode_matrix(self, rows: list[int]) -> np.ndarray:
        """[d, d] inverse mapping the survivor values at ``rows`` (pure,
        per instance) back to the d data values. Per-pattern inverses go
        through the shared decode-matrix LRU (ops/decode_cache) so a
        failure storm with churning patterns pays `gf_mat_inv` once per
        pattern, not once per block. Read-only by contract."""
        if len(rows) < self.data_shards:
            raise ValueError("need at least data_shards surviving shards")
        key = tuple(rows[: self.data_shards])
        return decode_cache.get(
            "cauchy", self.data_shards, self.parity_shards, key,
            lambda: gf.gf_mat_inv(self.matrix[list(key), :]),
        )

    def _pure_b(self, rows: list[int], bvals: np.ndarray, a: np.ndarray) -> np.ndarray:
        """Subtract the piggyback pollution from survivor b-instance rows.

        bvals: [k, h2] stored sub-chunk-2 values at code rows ``rows``;
        a: [d, h1] the fully decoded a-instance. Returns purified values
        that are plain Cauchy codewords over b."""
        h1 = a.shape[1]
        if not h1:
            return bvals
        out = np.array(bvals, dtype=np.uint8, copy=True)
        for k, r in enumerate(rows):
            if r >= self.data_shards:
                q = self.pb_matrix[r - self.data_shards]
                if q.any():
                    out[k, :h1] ^= gf.gf_matvec_blocks(q[None], a)[0]
        return out

    def reconstruct(
        self, shards: list[np.ndarray | None], data_only: bool = False
    ) -> list[np.ndarray | None]:
        """Recover missing shards (None entries); returns a NEW list.

        Decode order: a-instance first (sub-chunk 1 is pure everywhere),
        purify survivor sub-chunk 2 with the now-known piggybacks, decode
        the b-instance, then re-emit any missing parity with its
        piggyback re-applied."""
        if len(shards) != self.total_shards:
            raise ValueError("wrong shard count")
        d = self.data_shards
        present = [i for i, s in enumerate(shards) if s is not None and len(s) > 0]
        if len(present) == self.total_shards:
            return [np.asarray(s) for s in shards]
        if len(present) < d:
            raise ValueError("too few shards to reconstruct")
        per = len(shards[present[0]])
        if any(len(shards[i]) != per for i in present):
            raise ValueError("surviving shards have mismatched lengths")
        h1, _h2 = sub_lens(per)
        rows = present[:d]
        surv = np.stack(
            [np.asarray(shards[i], dtype=np.uint8) for i in rows]
        )  # [d, per]
        dec = self._decode_matrix(rows)
        a = gf.gf_matvec_blocks(dec, surv[:, :h1])  # [d, h1] data a-instance
        b = gf.gf_matvec_blocks(dec, self._pure_b(rows, surv[:, h1:], a))

        out: list[np.ndarray | None] = [
            np.asarray(s, dtype=np.uint8) if s is not None and len(s) > 0 else None
            for s in shards
        ]
        missing_parity: list[int] = []
        for i in range(self.total_shards):
            if out[i] is not None:
                continue
            if i < d:
                out[i] = np.concatenate([a[i], b[i]])
            elif not data_only:
                missing_parity.append(i)
        if missing_parity:
            rebuilt = np.zeros((self.total_shards, per), dtype=np.uint8)
            rebuilt[:d, :h1] = a
            rebuilt[:d, h1:] = b
            self.encode(rebuilt)
            for i in missing_parity:
                out[i] = rebuilt[i]
        return out

    def reconstruct_flat(
        self,
        survivors: np.ndarray,
        present: tuple[int, ...],
        missing: tuple[int, ...],
    ) -> np.ndarray:
        """Batched decode: survivors [d, W, per] (shard-major, at code
        rows present[:d]) -> [len(missing), W, per]. The GET window
        path's layout; sub-chunk columns flatten into the matvec length
        so the native AVX2 GF apply carries the whole window."""
        d = self.data_shards
        rows = list(present[:d])
        d_, w, per = survivors.shape
        if d_ != d:
            raise ValueError("survivors must carry data_shards rows")
        h1, h2 = sub_lens(per)
        dec = self._decode_matrix(rows)
        aflat = np.ascontiguousarray(survivors[:, :, :h1]).reshape(d, w * h1)
        bflat = np.ascontiguousarray(survivors[:, :, h1:]).reshape(d, w * h2)
        a = gf.gf_matvec_blocks(dec, aflat)  # [d, w*h1]
        if h1:
            pure = np.array(bflat, dtype=np.uint8, copy=True)
            for k, r in enumerate(rows):
                if r >= d:
                    q = self.pb_matrix[r - d]
                    if q.any():
                        poll = gf.gf_matvec_blocks(q[None], a)[0]  # [w*h1]
                        pr = pure[k].reshape(w, h2)
                        pr[:, :h1] ^= poll.reshape(w, h1)
            bflat = pure
        b = gf.gf_matvec_blocks(dec, bflat)
        out = np.empty((len(missing), w, per), dtype=np.uint8)
        av = a.reshape(d, w, h1)
        bv = b.reshape(d, w, h2)
        for mi, i in enumerate(missing):
            if i < d:
                out[mi, :, :h1] = av[i]
                out[mi, :, h1:] = bv[i]
            else:
                pr = self.parity_matrix[i - d]
                out[mi, :, :h1] = gf.gf_matvec_blocks(
                    pr[None], a
                )[0].reshape(w, h1)
                pb = gf.gf_matvec_blocks(pr[None], b)[0].reshape(w, h2)
                q = self.pb_matrix[i - d]
                if h1 and q.any():
                    pb[:, :h1] ^= gf.gf_matvec_blocks(
                        q[None], a
                    )[0].reshape(w, h1)
                out[mi, :, h1:] = pb
        return out

    def join(self, shards: list[np.ndarray], size: int) -> bytes:
        flat = np.concatenate(
            [np.asarray(s, dtype=np.uint8) for s in shards[: self.data_shards]]
        )
        return flat[:size].tobytes()

    # -- single-shard repair ----------------------------------------------

    def repair_schedule(self, missing: int) -> RepairSchedule | None:
        """Sub-chunk repair plan for one lost DATA shard, or None when no
        shortcut exists (parity shard lost, p < 2, or d < 2 — callers
        fall back to the generic full-read decode)."""
        d, p = self.data_shards, self.parity_shards
        if p < 2 or d < 2 or not (0 <= missing < d):
            return None
        gi = missing % (p - 1)
        mates = tuple(j for j in self.pb_groups[gi] if j != missing)
        b_helpers = tuple(j for j in range(d) if j != missing) + (d,)
        pb_parity = d + 1 + gi
        helpers = frozenset(b_helpers) | {pb_parity} | frozenset(mates)
        return RepairSchedule(missing, b_helpers, pb_parity, mates, helpers)

    def repair_data_shard(
        self,
        sched: RepairSchedule,
        shard_size: int,
        sub2: dict[int, np.ndarray],
        pb_sub2: np.ndarray,
        sub1: dict[int, np.ndarray],
    ) -> np.ndarray:
        """Execute a repair schedule: rebuild the full lost shard block.

        sub2: code idx -> sub-chunk-2 bytes for every b_helper;
        pb_sub2: sub-chunk 2 of the piggybacked parity;
        sub1: code idx -> sub-chunk-1 bytes for every group mate.
        Returns the rebuilt [shard_size] uint8 shard (a_i || b_i)."""
        d = self.data_shards
        i = sched.missing
        h1, h2 = sub_lens(shard_size)
        rows = list(sched.b_helpers)
        bvals = np.stack(
            [np.asarray(sub2[r], dtype=np.uint8) for r in rows]
        )  # [d, h2] — all pure: data rows + the clean parity row 0
        dec = self._decode_matrix(rows)
        b = gf.gf_matvec_blocks(dec, bvals)  # [d, h2] full b-instance
        shard = np.empty(shard_size, dtype=np.uint8)
        shard[h1:] = b[i]
        if h1:
            clean = gf.gf_matvec_blocks(
                self.parity_matrix[sched.pb_parity - d][None], b
            )[0]
            acc = np.asarray(pb_sub2, dtype=np.uint8)[:h1] ^ clean[:h1]
            for j in sched.mates:
                acc = acc ^ np.asarray(sub1[j], dtype=np.uint8)
            shard[:h1] = acc
        return shard


@functools.lru_cache(maxsize=None)
def get_codec(data_shards: int, parity_shards: int) -> CauchyPiggyback:
    return CauchyPiggyback(data_shards, parity_shards)


# -- device paths -----------------------------------------------------------

def composite_parity_matrix(codec: CauchyPiggyback) -> np.ndarray:
    """[2p, 2d] GF matrix computing both parity sub-chunks in ONE apply:
    input rows [a_0..a_{d-1}, b_0..b_{d-1}], output rows
    [pa_0..pa_{p-1}, pb_0..pb_{p-1}] (even shard sizes only; odd ones
    take the numpy path)."""
    d, p = codec.data_shards, codec.parity_shards
    m = np.zeros((2 * p, 2 * d), dtype=np.uint8)
    m[:p, :d] = codec.parity_matrix
    m[p:, :d] = codec.pb_matrix
    m[p:, d:] = codec.parity_matrix
    return m


class CauchyTorchCodec:
    """Device-side cauchy encode on one torch device: the composite
    [2p, 2d] matrix's bit planes applied by K3 (ops/rs_cuda.py), which
    reads the a and b halves of each data shard and writes those of each
    parity shard in place. Decode stays on the numpy/native plane, as in
    the reference.

    It offers the RS torch codec's surface (``device``, ``as_tensor``,
    ``data_shards``, ``parity_shards``, ``family``, ``encode_blocks``):
    dispatchers are keyed by shape, so a dispatcher this codec founds also
    serves reedsolomon blocks of the same shape, and calls these on it.
    Creating it on a CUDA device builds the port's kernels."""

    family = FAMILY

    def __init__(self, data_shards: int, parity_shards: int,
                 device: str | torch.device | None = None):
        from .rs_torch import gf_matrix_to_bitplanes

        self.device = devmod.resolve(device)
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self._ref = get_codec(data_shards, parity_shards)
        self.parity_matrix = self._ref.parity_matrix
        self.pb_matrix = self._ref.pb_matrix
        self.w_composite = gf_matrix_to_bitplanes(composite_parity_matrix(self._ref))
        if self.device.type == "cuda":
            from . import _build

            _build.load()

    def as_tensor(self, x) -> torch.Tensor:
        """uint8 array/tensor -> uint8 tensor on this codec's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.uint8)
        a = np.asarray(x, dtype=np.uint8)
        if not a.flags.writeable or not a.flags.c_contiguous:
            a = np.array(a, dtype=np.uint8)
        return torch.from_numpy(a).to(self.device)

    def encode_blocks(self, data, out: torch.Tensor | None = None) -> torch.Tensor:
        """[..., d, per] uint8 (per even) -> [..., p, per] parity, on the
        codec's device; written into ``out`` where given, as
        ``TorchRSCodec.encode_blocks`` does."""
        from .rs_cuda import gf_apply_cuda

        data = self.as_tensor(data)
        *batch, d, per = data.shape
        if per % 2:
            raise ValueError("device cauchy encode needs an even shard size")
        p = self.parity_shards
        par = gf_apply_cuda(self.w_composite, data.reshape(-1, d, per), p, sub=SUB_CHUNKS,
                            out=None if out is None else out.reshape(-1, p, per))
        return par.reshape(*batch, p, per)

    def encode_data(self, data: bytes) -> np.ndarray:
        """bytes -> [t, per] encoded shards (host round-trip, test path).
        Odd shard sizes fall back to the numpy reference."""
        shards = self._ref.split(data)
        if shards.shape[1] % 2:
            return self._ref.encode(shards)
        parity = self.encode_blocks(shards[None, : self.data_shards])[0]
        shards[self.data_shards:] = parity.cpu().numpy()
        return shards


@functools.lru_cache(maxsize=None)
def _torch_codec(data_shards: int, parity_shards: int, device: str) -> CauchyTorchCodec:
    return CauchyTorchCodec(data_shards, parity_shards, device)


def get_torch_codec(data_shards: int, parity_shards: int,
                    device: str | torch.device | None = None) -> CauchyTorchCodec:
    return _torch_codec(data_shards, parity_shards, str(devmod.resolve(device)))


def torch_codec_from_matrices(parity_matrix: np.ndarray, pb_matrix: np.ndarray,
                              device: str | torch.device | None = None) -> CauchyTorchCodec:
    """The port's cauchy codec for another codec's matrices (numpy
    arrays): the Cauchy parity matrix [p, d] and the piggyback matrix
    [p, d]. Raises when they are not the matrices this package derives
    for (d, p): decode and repair use the same construction, so a
    mismatch would rebuild wrong bytes."""
    pm = np.asarray(parity_matrix, dtype=np.uint8)
    p, d = pm.shape
    codec = get_torch_codec(d, p, device)
    if not np.array_equal(codec.parity_matrix, pm):
        raise ValueError(f"parity matrix differs from this package's cauchy({d + p},{d})")
    if not np.array_equal(codec.pb_matrix, np.asarray(pb_matrix, dtype=np.uint8)):
        raise ValueError(f"piggyback matrix differs from this package's cauchy({d + p},{d})")
    return codec


def encode_and_hash_cauchy(codec: CauchyTorchCodec, data, key: bytes | None = None):
    """Device dispatch for the cauchy family: composite encode (K3) +
    per-SUB-CHUNK HighwayHash digests (K2; two bitrot frames per shard
    block, the family's on-disk format).

    data: [B, d, per] uint8, per even. Returns tensors on the codec's
    device: (parity [B, p, per], digests [B, t, 2, 32])."""
    from .bitrot_cuda import hash256_blocks
    from .highwayhash import MINIO_KEY

    if key is None:
        key = MINIO_KEY
    data = codec.as_tensor(data)
    b, d, per = data.shape
    h = per // 2
    parity = codec.encode_blocks(data)
    shards = torch.cat([data, parity], dim=1)  # [B, t, per]
    t = codec.total_shards
    digests = hash256_blocks(shards.reshape(b * t * 2, h), key).reshape(b, t, 2, 32)
    return parity, digests


def encode_kernel(codec: CauchyPiggyback, data) -> torch.Tensor:
    """Counterpart of the reference's ``encode_blocks_pallas``: the
    [B, 2d, h] a/b composite built explicitly (a copy) and applied by K3
    with the plain contract. data: [B, d, per] uint8 (numpy or tensor;
    numpy goes to the default device) -> parity [B, p, per]."""
    from .rs_cuda import gf_apply_cuda
    from .rs_torch import gf_matrix_to_bitplanes

    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8)).to(devmod.resolve())
    b, d, per = data.shape
    if per % 2:
        raise ValueError("device cauchy encode needs an even shard size")
    h = per // 2
    p = codec.parity_shards
    w = gf_matrix_to_bitplanes(composite_parity_matrix(codec))
    u = data.reshape(b, d, 2, h).transpose(1, 2).reshape(b, 2 * d, h)
    par = gf_apply_cuda(w, u, 2 * p)
    return par.reshape(b, 2, p, h).transpose(1, 2).reshape(b, p, per)
