"""ErasureCoder — routes stripe blocks to the right codec backend.

Device-first split: every FULL stripe block of an object has the same
shape ([d, ceil(block_size/d)]), so all full blocks batch into fixed-shape
fused encode+hash device dispatches (ops/fused_cuda.py, or
ops/rs_torch.py + ops/bitrot_cuda.py for shapes the fused kernel does not
take). Only the object's final partial block has a variable shard
size; it runs on the numpy codec (ops/rs.py + ops/highwayhash.py), which is
byte-identical. GetObject/Heal reconstruction follows the same split.

CODE FAMILIES: two families share this interface — ``reedsolomon``
(ops/rs.py / ops/rs_torch.py, the default) and ``cauchy`` (ops/cauchy.py:
Cauchy MDS with piggybacked sub-chunks for partial repair). Cauchy full
blocks of an even shard size encode on the device (K3 + K2 through the
dispatcher); odd sizes, decode and partial repair stay on the
numpy/native plane, as in the reference. The family is chosen per
storage class at write time (MINIO_TPU_EC_FAMILY*), recorded in xl.meta
(ErasureInfo.algorithm), and every decode/heal path dispatches on the
STORED family, so objects of both families coexist on the same drives.
Per-family counters (encode/decode blocks, heal/degraded ingress bytes)
aggregate here for the metrics-v3 /api/tpu group.

Backend: MINIO_TPU_BACKEND=numpy keeps every block on the host; any other
value (default) builds a device codec on the torch device that
device.resolve() picks (MINIO_TPU_TORCH_DEVICE, default cuda).
MINIO_TPU_BACKEND=torch also routes writes through the device plane when
that device is the CPU (tests exercise the dispatcher that way).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .. import obs
from ..ops import rs
from ..ops.highwayhash import hash256_batch_numpy
from . import bitrot_io, bufpool
from .bitrot_io import FAMILY_CAUCHY, FAMILY_RS

# max shards per device dispatch (kept at the reference's value so the
# batches match its batches)
MAX_DEVICE_SHARDS = 3072

BLOCK_SIZE = 1 << 20  # 1 MiB stripe block, reference blockSizeV2
# (MinIO cmd/object-api-common.go:37)


def _use_device() -> bool:
    return os.environ.get("MINIO_TPU_BACKEND", "torch") != "numpy"


def default_ec_family() -> str:
    """Write-time code family (MINIO_TPU_EC_FAMILY). Malformed values
    fall back to reedsolomon — a tuning typo must not take down PUTs —
    but reads always dispatch on the family RECORDED in xl.meta."""
    fam = os.environ.get("MINIO_TPU_EC_FAMILY", FAMILY_RS)
    return fam if fam in bitrot_io.FAMILIES else FAMILY_RS


def repair_reads_enabled() -> bool:
    """MINIO_TPU_EC_REPAIR gates the sub-chunk partial-repair read plans
    (heal + degraded GET) of sub-packetized families; decode correctness
    never depends on it — off means full-shard reads everywhere."""
    return os.environ.get("MINIO_TPU_EC_REPAIR", "1") != "0"


# -- per-family counters (metrics-v3 /api/tpu) ------------------------------

_FSTATS_LOCK = threading.Lock()
_FAMILY_STATS: dict[str, dict[str, int]] = {}
_FSTAT_KEYS = (
    "encode_blocks", "decode_blocks", "heal_ingress_bytes",
    "degraded_ingress_bytes", "repair_partial_blocks",
)


def family_stats_add(family: str, key: str, n: int = 1) -> None:
    with _FSTATS_LOCK:
        st = _FAMILY_STATS.get(family)
        if st is None:
            st = _FAMILY_STATS[family] = {k: 0 for k in _FSTAT_KEYS}
        st[key] = st.get(key, 0) + n


def family_stats_snapshot() -> dict[str, dict[str, int]]:
    """Copy of the per-family counter table; families that served no
    traffic yet report zeroed rows so metrics series exist from boot."""
    with _FSTATS_LOCK:
        out = {f: dict(st) for f, st in _FAMILY_STATS.items()}
    for fam in bitrot_io.FAMILIES:
        out.setdefault(fam, {k: 0 for k in _FSTAT_KEYS})
    return out


def decode_matrix_cache_snapshot() -> dict:
    """Per-family decode-matrix LRU hit/miss counters + entry count
    (ops/decode_cache) — the /api/tpu series that make pattern-churn
    storms diagnosable from a scrape."""
    from ..ops import decode_cache

    return decode_cache.snapshot()


def encode_blocks_numpy(
    np_codec, blocks: np.ndarray, family: str = FAMILY_RS
) -> tuple[np.ndarray, np.ndarray]:
    """CPU full-block encode+hash, byte-identical to the device rungs.

    [B, d, n] -> (shards [B, t, n], digests [B, t, 32] rs /
    [B, t, 2, 32] cauchy). Shared by ErasureCoder's no-device path and
    the dispatcher's numpy degradation rung, so the two can never
    drift."""
    from ..ops.bitrot import fast_hash256_batch

    b, d, n = blocks.shape
    t = np_codec.total_shards
    shards = np.zeros((b, t, n), dtype=np.uint8)
    shards[:, :d] = blocks
    for i in range(b):
        shards[i] = np_codec.encode(shards[i])
    if family == FAMILY_CAUCHY:
        h1 = n // 2
        # per-sub-chunk digests: two bitrot frames per shard block. The
        # halves hash as separate batches (unequal lengths when n is odd).
        d1 = fast_hash256_batch(
            np.ascontiguousarray(shards[:, :, :h1]).reshape(b * t, h1)
        )
        d2 = fast_hash256_batch(
            np.ascontiguousarray(shards[:, :, h1:]).reshape(b * t, n - h1)
        )
        digests = np.stack(
            [np.asarray(d1), np.asarray(d2)], axis=1
        ).reshape(b, t, 2, 32)
        return shards, digests
    digests = np.asarray(
        fast_hash256_batch(shards.reshape(b * t, -1))
    ).reshape(b, t, 32)
    return shards, digests


@dataclass
class EncodedPart:
    """One erasure-coded part: per-drive shard file bytes (bitrot
    interleaved) in erasure-index order [0..d+p)."""

    shard_files: list[bytes]
    size: int  # input size


class EncodedBatch:
    """One streaming-encode batch on the zero-copy plane.

    ``shard_vecs[i]`` is the writev-style buffer sequence for erasure
    index i — alternating digest-row / shard-row views into the encode
    output, framed exactly like the legacy bytearray chunks. ``raw`` is
    the input slice this batch encoded (md5/size folding); on the pooled
    path it is a memoryview into the ingest arena, so the caller MUST
    finish both the md5 fold and every ``append_file(shard_vecs[i])``
    before calling :meth:`release` — the release returns the arena to
    the pool (docs/ERASURE.md buffer-ownership contract)."""

    __slots__ = ("shard_vecs", "raw", "_lease")

    def __init__(self, shard_vecs, raw, lease=None):
        self.shard_vecs: list[list] = shard_vecs
        self.raw = raw
        self._lease = lease

    def release(self) -> None:
        """Return the backing ingest arena (if pooled). Idempotent."""
        lease, self._lease = self._lease, None
        if lease is not None:
            lease.release()


class ErasureCoder:
    def __init__(
        self, data_blocks: int, parity_blocks: int,
        block_size: int = BLOCK_SIZE, family: str = FAMILY_RS,
    ):
        self.family = bitrot_io.check_family(family)
        self.d = data_blocks
        self.p = parity_blocks
        self.t = data_blocks + parity_blocks
        self.block_size = block_size
        self.shard_size = -(-block_size // data_blocks)
        # on-disk digest overhead per shard block (1 frame for rs, 2 for
        # the sub-packetized cauchy family)
        self.frame_digests = bitrot_io.frames_per_block(self.family)
        if self.family == FAMILY_CAUCHY:
            from ..ops import cauchy as cauchy_mod

            self._np = cauchy_mod.get_codec(self.d, self.p)
        else:
            self._np = rs.get_codec(self.d, self.p)
        # device codec of the family; creating it on CUDA builds the
        # kernels, and a build error propagates
        self._dev = None
        if _use_device():
            if self.family == FAMILY_CAUCHY:
                self._dev = cauchy_mod.get_torch_codec(self.d, self.p)
            else:
                from ..ops import rs_torch

                self._dev = rs_torch.get_torch_codec(self.d, self.p)

    @property
    def device_active(self) -> bool:
        """True when writes should route through the device dispatcher:
        the device codec lives on a CUDA card, or the operator forced
        MINIO_TPU_BACKEND=torch (tests exercise the device plane on the
        CPU that way). A CPU codec alone must NOT disable the native C++
        plane."""
        if self._dev is None:
            return False
        if os.environ.get("MINIO_TPU_BACKEND") == "torch":
            return True
        return self._dev.device.type == "cuda"

    # -- encode ------------------------------------------------------------

    def _encode_block_np(self, block: bytes) -> tuple[np.ndarray, np.ndarray]:
        from .. import native
        from ..ops.highwayhash import MINIO_KEY

        # tail blocks count like full blocks so the per-family encode
        # series stays comparable across families
        family_stats_add(self.family, "encode_blocks", 1)
        if native.available():
            shards = self._np.split(block)
            parity, digests = native.gf_encode_hash(
                self._np.parity_matrix, shards[: self.d], MINIO_KEY
            )
            shards[self.d :] = parity
            return shards, digests
        shards = self._np.encode_data(block)  # [t, per]
        digests = hash256_batch_numpy(shards)
        return shards, digests

    def _encode_full_blocks(self, blocks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """blocks: [B, d, shard_size] -> (shards [B, t, n], digests).

        digests: [B, t, 32] for reedsolomon, [B, t, 2, 32] (per
        sub-chunk) for cauchy. The device path goes through the batching
        dispatcher: blocks from concurrent requests of BOTH families
        coalesce into one stream (family tag per batch entry). The
        cauchy composite apply needs an even shard size; odd geometries
        take the numpy path below."""
        if self._dev is not None and (
            self.family != FAMILY_CAUCHY or blocks.shape[2] % 2 == 0
        ):
            from ..parallel.dispatcher import get_dispatcher

            # the request's view of the dispatcher: queue, batch, copies
            with obs.span(obs.TYPE_INTERNAL, "erasure.put.encode-wait"):
                return get_dispatcher(self._dev, blocks.shape[2]).encode(
                    blocks, codec=self._dev
                )
        family_stats_add(self.family, "encode_blocks", blocks.shape[0])
        return encode_blocks_numpy(self._np, blocks, self.family)

    def _encode_full_buffer(self, data: memoryview) -> list[bytearray]:
        """len(data) is a multiple of block_size -> per-shard file chunks
        (family-framed digest || shard interleave) for these blocks."""
        full = len(data) // self.block_size
        per = self.shard_size
        padded_block = self.d * per  # >= block_size; zero padding at tail
        bufpool.count_copy("staging")  # bytes -> numpy staging materialization
        arr = np.zeros((full, self.d, per), dtype=np.uint8)
        flat = np.frombuffer(data, dtype=np.uint8)
        if padded_block == self.block_size:
            arr[:] = flat.reshape(full, self.d, per)
        else:
            for b in range(full):
                blk = flat[b * self.block_size : (b + 1) * self.block_size]
                a = arr[b].reshape(-1)
                a[: self.block_size] = blk
        files = [bytearray() for _ in range(self.t)]
        max_blocks = max(1, MAX_DEVICE_SHARDS // self.t)
        cauchy = self.family == FAMILY_CAUCHY
        h1 = per // 2
        for start in range(0, full, max_blocks):
            chunk = arr[start : start + max_blocks]
            shards, digests = self._encode_full_blocks(chunk)
            for b in range(chunk.shape[0]):
                for i in range(self.t):
                    if cauchy:
                        files[i] += digests[b, i, 0].tobytes()
                        files[i] += shards[b, i, :h1].tobytes()
                        files[i] += digests[b, i, 1].tobytes()
                        files[i] += shards[b, i, h1:].tobytes()
                    else:
                        files[i] += digests[b, i].tobytes()
                        files[i] += shards[b, i].tobytes()
        bufpool.count_copy("frame-tobytes", full * self.t)
        return files

    def _encode_tail_buffer(self, data: bytes) -> list[bytearray]:
        """Partial final block (numpy codec, byte-identical)."""
        bufpool.count_copy("tail-block", self.t)
        if self.family == FAMILY_CAUCHY:
            shards = self._np.encode_data(data)
            family_stats_add(self.family, "encode_blocks", 1)
            return [
                bytearray(bitrot_io.frame_block(shards[i].tobytes(), self.family))
                for i in range(self.t)
            ]
        shards, digests = self._encode_block_np(data)
        files = [bytearray() for _ in range(self.t)]
        for i in range(self.t):
            files[i] += digests[i].tobytes()
            files[i] += shards[i].tobytes()
        return files

    def iter_encode(
        self, reader, max_batch_bytes: int | None = None
    ) -> "Iterator[tuple[list[bytearray], bytes]]":
        """Streaming encode: consume an iterator of byte chunks, yield
        (per-shard file chunks, the raw input slice encoded) per batch.

        Bounded memory: at most one batch of input is resident, mirroring
        the reference's block-at-a-time ring buffer
        (MinIO cmd/bitrot-streaming.go:108-133) at device-batch
        granularity. The raw slice lets callers fold md5/size incrementally.
        max_batch_bytes clamps the batch below the device HBM cap —
        streaming callers pass their memory bound; in-memory callers leave
        it None for full-width device dispatches.
        """
        batch_bytes = max(1, MAX_DEVICE_SHARDS // self.t) * self.block_size
        if max_batch_bytes is not None:
            batch_bytes = min(batch_bytes, max(self.block_size, max_batch_bytes))
        buf = bytearray()
        for chunk in reader:
            if not chunk:
                continue
            buf += chunk
            while len(buf) >= batch_bytes:
                bufpool.count_copy("staging")
                piece = bytes(buf[:batch_bytes])
                del buf[:batch_bytes]
                yield self._encode_full_buffer(memoryview(piece)), piece
        full = (len(buf) // self.block_size) * self.block_size
        if full:
            bufpool.count_copy("staging")
            piece = bytes(buf[:full])
            del buf[:full]
            yield self._encode_full_buffer(memoryview(piece)), piece
        if buf:
            piece = bytes(buf)
            yield self._encode_tail_buffer(piece), piece

    def _frame_into(
        self, vecs: list[list], shards: np.ndarray, digests: np.ndarray
    ) -> None:
        """Append digest/shard ROW VIEWS to the per-shard writev vectors
        — same on-disk frame interleave as _encode_full_buffer, zero
        materialization. The views pin the encode-output arrays alive
        until the disk layer consumes them."""
        cauchy = self.family == FAMILY_CAUCHY
        h1 = shards.shape[2] // 2
        for b in range(shards.shape[0]):
            for i in range(self.t):
                v = vecs[i]
                if cauchy:
                    v.append(digests[b, i, 0].data)
                    v.append(shards[b, i, :h1].data)
                    v.append(digests[b, i, 1].data)
                    v.append(shards[b, i, h1:].data)
                else:
                    v.append(digests[b, i].data)
                    v.append(shards[b, i].data)

    def _emit_zc(self, lease, nbytes: int) -> EncodedBatch:
        """Encode the first nbytes (whole stripe blocks) of a pooled
        ingest arena. The arena IS the dispatch geometry — reshape, no
        copy — and the batch takes over the lease (released by the
        caller once md5 + shard appends are done)."""
        full = nbytes // self.block_size
        arr = lease.array[:nbytes].reshape(full, self.d, self.shard_size)
        vecs: list[list] = [[] for _ in range(self.t)]
        max_blocks = max(1, MAX_DEVICE_SHARDS // self.t)
        for start in range(0, full, max_blocks):
            shards, digests = self._encode_full_blocks(arr[start : start + max_blocks])
            self._frame_into(vecs, shards, digests)
        return EncodedBatch(vecs, lease.view(nbytes), lease)

    def iter_encode_zc(
        self, reader, max_batch_bytes: int | None = None
    ) -> "Iterator[EncodedBatch]":
        """Zero-copy streaming encode: reader chunks land DIRECTLY in a
        pooled arena laid out in dispatcher geometry [B, d, shard_size],
        the device consumes the arena view, and framing yields shard-row
        views for writev-style appends — no staging copy anywhere on the
        full-block path (site "staging" stays 0; the partial tail block
        is the one inherent copy, counted as "tail-block").

        Falls back to the counting legacy path when MINIO_TPU_ZEROCOPY=0
        (the A/B lever) or when d does not divide block_size (the flat
        stream cannot alias as [B, d, per] — shard padding interleaves).
        Every yielded batch must be release()d by the caller; abandoning
        the generator releases the in-fill arena via close().
        """
        per = self.shard_size
        if self.d * per != self.block_size or not bufpool.zerocopy_enabled():
            for chunks, raw in self.iter_encode(reader, max_batch_bytes):
                yield EncodedBatch([[bytes(c)] for c in chunks], raw)
            return
        batch_blocks = max(1, MAX_DEVICE_SHARDS // self.t)
        if max_batch_bytes is not None:
            batch_blocks = max(1, min(batch_blocks, max_batch_bytes // self.block_size))
        # round DOWN to a power of two: ingest arenas come from bufpool's
        # power-of-two size classes (192 blocks of 1 MiB would go past the
        # top class of 128 MiB, unpooled); the dispatcher takes a batch
        # at any size
        p2 = 1
        while p2 * 2 <= batch_blocks:
            p2 <<= 1
        batch_blocks = p2
        batch_bytes = batch_blocks * self.block_size
        pool = bufpool.get_pool()
        lease = None
        mv: memoryview | None = None
        pos = 0
        try:
            for chunk in reader:
                if not chunk:
                    continue
                cmv = memoryview(chunk)
                off = 0
                while off < len(cmv):
                    if lease is None:
                        lease = pool.acquire(batch_bytes)
                        mv = lease.view(batch_bytes)
                        pos = 0
                    n = min(len(cmv) - off, batch_bytes - pos)
                    mv[pos : pos + n] = cmv[off : off + n]
                    pos += n
                    off += n
                    if pos == batch_bytes:
                        batch, lease, mv = self._emit_zc(lease, pos), None, None
                        yield batch
            if lease is not None:
                full = (pos // self.block_size) * self.block_size
                # the tail residue is copied OUT of the arena before the
                # full-block batch hands the lease to the caller
                tail = bytes(mv[full:pos]) if pos > full else b""
                if full:
                    batch, lease, mv = self._emit_zc(lease, full), None, None
                    yield batch
                else:
                    lease.release()
                    lease = mv = None
                if tail:
                    yield EncodedBatch(
                        [[bytes(c)] for c in self._encode_tail_buffer(tail)], tail
                    )
        finally:
            if lease is not None:
                lease.release()

    def encode_part(self, data: bytes) -> EncodedPart:
        """Erasure-code one in-memory part into per-drive shard files.

        Full stripe blocks go to the device in batches; the partial tail
        block (if any) uses the numpy codec. Output per drive is the
        bitrot-interleaved shard file (digest || shard block per stripe).
        Large/streamed parts should use iter_encode via the streaming
        put path instead of materializing here.
        """
        n = len(data)
        files = [bytearray() for _ in range(self.t)]
        if n == 0:
            return EncodedPart([bytes(f) for f in files], 0)
        for chunks, _raw in self.iter_encode(iter([data])):
            for i in range(self.t):
                files[i] += chunks[i]
        return EncodedPart([bytes(f) for f in files], n)

    # -- decode ------------------------------------------------------------

    def reconstruct_block(
        self, present: dict[int, np.ndarray], per_shard: int
    ) -> dict[int, np.ndarray]:
        """Rebuild ALL missing shards of one stripe block from >= d present.

        present: {erasure_index: shard bytes [per_shard]}. Returns the full
        {index: shard} map. numpy path (single block; device batching is for
        the heal plane)."""
        idxs = sorted(present.keys())
        if len(idxs) < self.d:
            raise ValueError("not enough shards to reconstruct")
        shards: list[np.ndarray | None] = [None] * self.t
        for i in idxs:
            shards[i] = present[i]
        rec = self._np.reconstruct(shards)
        family_stats_add(self.family, "decode_blocks", 1)
        return {i: rec[i] for i in range(self.t)}

    def reconstruct_data_flat(
        self,
        survivors: np.ndarray,
        present: tuple[int, ...],
        missing: tuple[int, ...],
        pool=None,
    ) -> np.ndarray:
        """Rebuild missing data shards from [d, W, per] (shard-major) input.

        Returns [len(missing), W, per]. The GET hot layout: survivors land
        contiguous per shard row, the native AVX2 GF apply consumes them
        without a transpose, and a thread pool splits the column range so
        the apply scales past one core (ctypes releases the GIL).
        """
        from .. import native

        d_, w, per = survivors.shape
        family_stats_add(self.family, "decode_blocks", w)
        if self.family == FAMILY_CAUCHY:
            # cauchy decode runs on the numpy/native GF plane: the
            # piggyback purify step chains two applies, and repair-path
            # reads (the family's point) are bandwidth- not compute-
            # bound. Device decode is a named next lever.
            return self._np.reconstruct_flat(survivors, present, missing)
        if (
            self._dev is not None
            and w * self.t >= int(os.environ.get("MINIO_TPU_DECODE_MIN_SHARDS", "64"))
        ):
            from ..ops.bitrot_torch import _try_fused_decode, to_numpy
            from ..ops.highwayhash import MINIO_KEY

            arr = survivors.transpose(1, 0, 2)  # [W, d, per]
            # degraded GET rides the fused decode kernel when shapes allow
            fused = _try_fused_decode(self._dev, arr, present, missing, MINIO_KEY)
            if fused is not None:
                return fused[0].transpose(1, 0, 2)
            out = self._dev.reconstruct_blocks(arr, present, missing)
            return to_numpy(out).transpose(1, 0, 2)
        mat = self._decode_rows(present, missing)
        flat = survivors.reshape(self.d, w * per)
        if native.available():
            cols = w * per
            shards_split = max(1, min(4, cols // (1 << 20)))
            if pool is not None and shards_split > 1:
                step = -(-cols // shards_split)
                out = np.empty((len(missing), cols), dtype=np.uint8)

                def apply_slice(s):
                    # the strided->contiguous copy happens in the worker too
                    return native.gf_apply(mat, flat[:, s:s + step])

                futs = [(s, pool.submit(apply_slice, s)) for s in range(0, cols, step)]
                for s, f in futs:
                    piece = f.result()
                    out[:, s:s + piece.shape[1]] = piece
            else:
                out = native.gf_apply(mat, flat)
            return out.reshape(len(missing), w, per)
        return self._np_reconstruct_batch(
            survivors.transpose(1, 0, 2), present, missing
        ).transpose(1, 0, 2)

    def _decode_rows(
        self, present: tuple[int, ...], missing: tuple[int, ...]
    ) -> np.ndarray:
        return self._np.reconstruct_rows_for(list(present), list(missing))

    def _np_reconstruct_batch(
        self,
        survivors: np.ndarray,
        present: tuple[int, ...],
        missing: tuple[int, ...],
    ) -> np.ndarray:
        from .. import native
        from ..ops import gf

        mat = self._decode_rows(present, missing)  # [m, d]
        w, _, per = survivors.shape
        if native.available():
            # AVX2 GF apply: fold the window into the column length
            flat = np.ascontiguousarray(survivors.transpose(1, 0, 2)).reshape(
                self.d, w * per
            )
            return native.gf_apply(mat, flat).reshape(len(missing), w, per).transpose(1, 0, 2)
        out = np.zeros((w, len(missing), per), dtype=np.uint8)
        for r, row in enumerate(mat):
            acc = out[:, r]
            for k in range(self.d):
                c = int(row[k])
                if c:
                    acc ^= gf.MUL_TABLE[c][survivors[:, k]]
        return out

    # -- partial repair (sub-packetized families) --------------------------

    def repair_schedule(self, missing: int):
        """Sub-chunk repair plan for ONE lost data shard, or None when
        the family has no shortcut (reedsolomon, parity loss, p < 2, or
        repair reads disabled via MINIO_TPU_EC_REPAIR=0)."""
        if self.family != FAMILY_CAUCHY or not repair_reads_enabled():
            return None
        return self._np.repair_schedule(missing)

    def repair_data_shard(self, sched, shard_size, sub2, pb_sub2, sub1):
        """Execute a repair schedule (ops/cauchy.repair_data_shard)."""
        family_stats_add(self.family, "repair_partial_blocks", 1)
        return self._np.repair_data_shard(sched, shard_size, sub2, pb_sub2, sub1)

    # -- geometry ----------------------------------------------------------

    def shard_sizes_for(self, total: int) -> list[tuple[int, int]]:
        """[(block_data_len, per_shard)] for each stripe block of a part."""
        out = []
        full = total // self.block_size
        for _ in range(full):
            out.append((self.block_size, self.shard_size))
        tail = total - full * self.block_size
        if tail:
            out.append((tail, -(-tail // self.d)))
        return out
