"""Batched HighwayHash-256 and the encode/decode+hash dispatches (torch).

Counterpart of the JAX package's ``ops/bitrot_jax.py``. Holds:

- ``hash256_blocks_plain``: the plain PyTorch HighwayHash-256 of B
  equal-length messages — the reference arithmetic that the CUDA chain
  kernel (``ops/bitrot_cuda.py``) is held against, and what its wrapper
  runs for CPU tensors;
- ``encode_and_hash`` / ``reconstruct_and_hash``: RS encode or rebuild
  followed by the per-shard bitrot digests, the shards staying on the
  device between the two; the encode keeps a batch's shards in one
  ``ShardSlab`` at a 32-byte row pitch (``shard_slab``);
- ``_try_fused_decode``: the decode route into the fused CUDA kernel,
  behind its ``fused_cuda.Gate``, with ``decode_stats``.

Torch has no working uint64 and little uint32 arithmetic, so the hash
keeps each 64-bit lane as a (hi, lo) pair of 32-bit values held in int64
tensors. The 32x32 -> 64 multiply goes through 16-bit halves (a full
u32*u32 product would overflow int64), and every left shift and add is
masked back to 32 bits. The four lanes of each state word stack into one
[4, B] tensor, so each step is a handful of elementwise ops over all
lanes and messages.

Validated against ops/highwayhash.py (scalar + numpy).
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..fault import registry as fault_registry
from .highwayhash import INIT0, INIT1, MINIO_KEY

__all__ = ["hash256_blocks_plain", "encode_and_hash", "reconstruct_and_hash", "ShardSlab",
           "shard_slab", "pitch"]

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
_B3 = 0xFF000000
_PERM = [2, 3, 0, 1]


def _add64(ah, al, bh, bl):
    lo = al + bl
    return (ah + bh + (lo >> 32)) & _M32, lo & _M32


def _mul32x32(a, b):
    """Full 32x32 -> 64 product as (hi, lo), via 16-bit halves."""
    al, ah = a & _M16, a >> 16
    bl, bh = b & _M16, b >> 16
    mid = al * bh + ah * bl           # < 2^33: fits int64
    lo = al * bl + ((mid & _M16) << 16)
    hi = ah * bh + (mid >> 16) + (lo >> 32)
    return hi & _M32, lo & _M32


def _zipper_lo_half(v1hi, v1lo, v0hi, v0lo):
    """(hi, lo) of the 64-bit zipper-merge shuffle added into add0."""
    masked = (v0hi & 0xFF00) | (v1hi & 0xFF0000)
    lo = (
        ((v0lo & _B3) >> 24)
        | ((v1hi & 0xFF) << 8)
        | ((masked << 16) & _M32)
        | (v0lo & 0xFF0000)
    )
    hi = (
        (masked >> 16)
        | (v0lo & 0xFF00)
        | ((v1hi & _B3) >> 8)
        | ((v0lo & 0xFF) << 24)
    )
    return hi, lo


def _zipper_hi_half(v1hi, v1lo, v0hi, v0lo):
    """(hi, lo) of the 64-bit zipper-merge shuffle added into add1."""
    lo = (
        ((v1lo & _B3) >> 24)
        | ((v0hi & 0xFF) << 8)
        | (v1lo & 0xFF0000)
        | ((v1hi & 0xFF00) << 16)
    )
    hi = (
        ((v1lo & 0xFF00) >> 8)
        | ((v0hi & 0xFF0000) >> 8)
        | ((v1lo & 0xFF) << 16)
        | (v0hi & _B3)
    )
    return hi, lo


def _interleave(even, odd):
    """[2, B] lanes (0, 2) and (1, 3) -> [4, B] lanes (0, 1, 2, 3)."""
    return torch.stack([even, odd], dim=1).reshape(4, -1)


def _zipper_into(srch, srcl, dsth, dstl):
    """dst += zipper(src) for lane pairs (1, 0) and (3, 2)."""
    args = (srch[1::2], srcl[1::2], srch[0::2], srcl[0::2])
    zh, zl = _zipper_lo_half(*args)
    eh, el = _add64(dsth[0::2], dstl[0::2], zh, zl)
    zh, zl = _zipper_hi_half(*args)
    oh, ol = _add64(dsth[1::2], dstl[1::2], zh, zl)
    return _interleave(eh, oh), _interleave(el, ol)


class _St:
    """HighwayHash state: each field a [4, B] int64 tensor of 32-bit halves."""

    __slots__ = ("v0h", "v0l", "v1h", "v1l", "m0h", "m0l", "m1h", "m1l")


def _update(s: _St, ah, al) -> None:
    """One HighwayHash round; ah/al: [4, B] packet lane halves."""
    s.v1h, s.v1l = _add64(s.v1h, s.v1l, *_add64(s.m0h, s.m0l, ah, al))
    ph, pl = _mul32x32(s.v1l, s.v0h)
    s.m0h, s.m0l = s.m0h ^ ph, s.m0l ^ pl
    s.v0h, s.v0l = _add64(s.v0h, s.v0l, s.m1h, s.m1l)
    ph, pl = _mul32x32(s.v0l, s.v1h)
    s.m1h, s.m1l = s.m1h ^ ph, s.m1l ^ pl
    s.v0h, s.v0l = _zipper_into(s.v1h, s.v1l, s.v0h, s.v0l)
    s.v1h, s.v1l = _zipper_into(s.v0h, s.v0l, s.v1h, s.v1l)


def _init_state(batch: int, key: bytes, device) -> _St:
    k = [int.from_bytes(key[8 * i : 8 * i + 8], "little") for i in range(4)]
    krot = [((x >> 32) | (x << 32)) & ((1 << 64) - 1) for x in k]

    def split(vals):
        hi = torch.tensor([v >> 32 for v in vals], dtype=torch.int64, device=device)
        lo = torch.tensor([v & _M32 for v in vals], dtype=torch.int64, device=device)
        return (hi[:, None].expand(4, batch).contiguous(),
                lo[:, None].expand(4, batch).contiguous())

    s = _St()
    s.v0h, s.v0l = split([INIT0[i] ^ k[i] for i in range(4)])
    s.v1h, s.v1l = split([INIT1[i] ^ krot[i] for i in range(4)])
    s.m0h, s.m0l = split(list(INIT0))
    s.m1h, s.m1l = split(list(INIT1))
    return s


def _packet_halves(packets: torch.Tensor):
    """[B, P*32] uint8 -> (hi, lo): [P, 4, B] int64 32-bit lane halves."""
    b, nb = packets.shape
    words = packets.contiguous().view(torch.int32).to(torch.int64) & _M32
    words = words.reshape(b, nb // 32, 4, 2).permute(1, 3, 2, 0)  # [P, 2, 4, B]
    return words[:, 1], words[:, 0]  # little-endian: word 0 is the low half


def _remainder_packet(tail: torch.Tensor) -> torch.Tensor:
    """[B, rem] uint8 (0 < rem < 32) -> the padded [B, 32] final packet."""
    b, rem = tail.shape
    packet = torch.zeros((b, 32), dtype=torch.uint8, device=tail.device)
    whole4 = rem & ~3
    packet[:, :whole4] = tail[:, :whole4]
    if rem & 16:
        packet[:, 28:32] = tail[:, rem - 4 : rem]
    elif rem & 3:
        size4 = rem & 3
        packet[:, 16] = tail[:, whole4]
        packet[:, 17] = tail[:, whole4 + (size4 >> 1)]
        packet[:, 18] = tail[:, whole4 + size4 - 1]
    return packet


def _digest_bytes(s: _St) -> torch.Tensor:
    """Modular reduction of a finalized state -> [B, 32] uint8 digests."""
    halves = []
    for ev in (slice(0, 4, 2), slice(1, 4, 2)):  # lanes (0, 2) then (1, 3)
        halves.append(((s.v0h[ev], s.v0l[ev]), (s.m0h[ev], s.m0l[ev]),
                       (s.v1h[ev], s.v1l[ev]), (s.m1h[ev], s.m1l[ev])))
    (v0e, m0e, v1e, m1e), (v0o, m0o, v1o, m1o) = halves
    a0h, a0l = _add64(*v0e, *m0e)
    a1h, a1l = _add64(*v0o, *m0o)
    a2h, a2l = _add64(*v1e, *m1e)
    a3h, a3l = _add64(*v1o, *m1o)
    a3h = a3h & 0x3FFFFFFF
    # m1 = a1 ^ ((a3<<1)|(a2>>63)) ^ ((a3<<2)|(a2>>62))
    m1h = a1h ^ (((a3h << 1) & _M32) | (a3l >> 31)) ^ (((a3h << 2) & _M32) | (a3l >> 30))
    m1l = a1l ^ (((a3l << 1) & _M32) | (a2h >> 31)) ^ (((a3l << 2) & _M32) | (a2h >> 30))
    # m0 = a0 ^ (a2<<1) ^ (a2<<2)
    m0h = a0h ^ (((a2h << 1) & _M32) | (a2l >> 31)) ^ (((a2h << 2) & _M32) | (a2l >> 30))
    m0l = a0l ^ ((a2l << 1) & _M32) ^ ((a2l << 2) & _M32)
    words = torch.stack([m0l, m0h, m1l, m1h], dim=1)       # [2 halves, 4, B]
    words = words.permute(2, 0, 1).reshape(-1, 8)          # [B, 8] LE order
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=words.device)
    return ((words[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1, 32)


def hash256_blocks_plain(blocks: torch.Tensor, key: bytes = MINIO_KEY) -> torch.Tensor:
    """HighwayHash-256 of B equal-length messages in plain torch.

    blocks: [B, n] uint8 on any device -> [B, 32] uint8 digests there.
    """
    b, n = blocks.shape
    s = _init_state(b, key, blocks.device)
    whole = n - (n % 32)
    if whole:
        hi, lo = _packet_halves(blocks[:, :whole])
        for pi in range(whole // 32):
            _update(s, hi[pi], lo[pi])
    rem = n - whole
    if rem:
        # v0 += (size << 32) + size; each 32-bit half of v1 rotated by size
        s.v0h, s.v0l = _add64(s.v0h, s.v0l, rem, rem)
        s.v1h = ((s.v1h << rem) & _M32) | (s.v1h >> (32 - rem))
        s.v1l = ((s.v1l << rem) & _M32) | (s.v1l >> (32 - rem))
        hi, lo = _packet_halves(_remainder_packet(blocks[:, whole:]))
        _update(s, hi[0], lo[0])
    for _ in range(10):
        # Permute(v0) = lanes [2, 3, 0, 1], each with its halves swapped
        _update(s, s.v0l[_PERM], s.v0h[_PERM])
    return _digest_bytes(s)


# -- encode / decode + hash --------------------------------------------------

# served-traffic observability: lets tests (and the admin plane) assert
# the fused decode kernel actually carried degraded reads. Lock-guarded:
# concurrent degraded GETs reconstruct on worker threads.
decode_stats = {"fused": 0, "blocks": 0, "failures": 0}
_decode_stats_lock = threading.Lock()


@functools.cache
def _decode_gate():
    """The decode route's ``fused_cuda.Gate``, one for the process."""
    from .fused_cuda import Gate

    return Gate()


def _try_fused_decode(codec, survivors, present, missing, key):
    """Fused reconstruct + hash through the CUDA kernel where the decode
    route's gate admits the batch, at the survivors' own B.

    survivors: [B, d, n] uint8 (numpy or tensor). Returns (rebuilt
    [B, m, n], rebuilt_digests [B, m, 32], survivor_digests [B, d, 32])
    as numpy, or None for the bit-plane + chain-kernel path."""
    from . import fused_cuda as fc

    b, d, n = survivors.shape
    gate = _decode_gate()
    take, fired = gate.admit(f"{d}+{codec.parity_shards}", d, len(missing), n)
    if fired:
        with _decode_stats_lock:
            decode_stats["failures"] += 1
    if not take:
        return None
    # a real kernel error is not caught here: it reaches the caller
    rebuilt, digests = fc.fused_decode_hash(
        codec.as_tensor(survivors), d, codec.parity_shards, tuple(present), tuple(missing), key
    )
    rebuilt = rebuilt.cpu().numpy()
    digs = digests.cpu().numpy()
    gate.succeeded()
    with _decode_stats_lock:
        decode_stats["fused"] += 1
        decode_stats["blocks"] += b
    return rebuilt, digs[:, d:, :], digs[:, :d, :]


def reconstruct_and_hash(codec, survivors, present: tuple[int, ...],
                         missing: tuple[int, ...], key: bytes = MINIO_KEY):
    """HealObject's hot loop in one device pass: rebuild the missing
    shards and produce their bitrot digests while they are still on the
    card. Shapes the fused kernel takes go through it; others through the
    bit-plane product and the chain kernel.

    survivors: [B, d, n] (shards at indices present[:d]); returns
    (rebuilt [B, m, n], digests [B, m, 32]).
    """
    from .bitrot_cuda import hash256_blocks

    fused = _try_fused_decode(codec, survivors, present, missing, key)
    if fused is not None:
        rebuilt, rdig, _sdig = fused
        return rebuilt, rdig
    surv = codec.as_tensor(survivors)
    b, _, n = surv.shape
    m = len(missing)
    rebuilt = codec.reconstruct_blocks(surv, present, missing)
    digests = hash256_blocks(rebuilt.reshape(b * m, n), key).reshape(b, m, 32)
    return rebuilt, digests


SECTOR = 32  # bytes: a slab row starts on a sector, K2's copies' unit


def pitch(n: int) -> int:
    """The shard slab's row pitch for rows of n bytes: n rounded up to a
    whole number of 32-byte sectors (n itself where it is one)."""
    return -(-n // SECTOR) * SECTOR


class ShardSlab(NamedTuple):
    """A batch's shards in one [B, d + p, P] uint8 tensor, P = pitch(n):
    block b's shard j (data first, then parity) is the first n bytes of
    ``rows[b, j]``, so every shard starts on a sector of an aligned
    allocation; the P - n bytes after it are never read."""

    rows: torch.Tensor
    d: int
    n: int

    @property
    def data(self) -> torch.Tensor:
        """The data shards, a [B, d, n] view."""
        return self.rows[:, :self.d, :self.n]

    @property
    def parity(self) -> torch.Tensor:
        """The parity shards, a [B, p, n] view."""
        return self.rows[:, self.d:, :self.n]

    def shards(self) -> torch.Tensor:
        """Every shard of the batch, a [B * (d + p), n] view at pitch P."""
        b, t, p = self.rows.shape
        return self.rows.view(b * t, p)[:, :self.n]


def shard_slab(codec, data) -> ShardSlab:
    """[B, d, n] uint8 data (an array or a tensor) -> a new ``ShardSlab``
    on the codec's device with the data shards copied in: from the host
    to the card in one pitched copy of the data's own bytes
    (``bitrot_cuda.rows_to_card``), so no kernel lays rows out."""
    b, d, n = data.shape
    rows = torch.empty((b, d + codec.parity_shards, pitch(n)), dtype=torch.uint8,
                       device=codec.device)
    slab = ShardSlab(rows, d, n)
    if rows.is_cuda and not (isinstance(data, torch.Tensor) and data.is_cuda):
        from .bitrot_cuda import rows_to_card

        rows_to_card(slab.data, data)
    else:
        slab.data.copy_(codec.as_tensor(data))
    return slab


def encode_and_hash(codec, data, key: bytes = MINIO_KEY):
    """RS-encode + bitrot-hash: data [B, d, n] uint8 (an array, a tensor,
    or the ``ShardSlab`` that ``shard_slab`` filled) -> (parity [B, p, n],
    digests [B, d+p, 32]) as tensors on the codec's device. The shards
    stay in one slab: the bit-plane product (K3 on the card) writes the
    parity rows in place and the chain kernel (K2) hashes every row where
    it lies, so no shard is copied on the device. The parity is a view of
    the slab (``to_numpy`` brings it over in one pitched copy)."""
    from .bitrot_cuda import hash256_blocks

    slab = data if isinstance(data, ShardSlab) else shard_slab(codec, data)
    b, t, _ = slab.rows.shape
    codec.encode_blocks(slab.data, out=slab.parity)
    digests = hash256_blocks(slab.shards(), key).reshape(b, t, 32)
    return slab.parity, digests


def to_numpy(x) -> np.ndarray:
    """Tensor (any device) or array -> host numpy array. A [B, r, n]
    CUDA view whose rows lie at a pitch (a shard slab's parity) comes
    over in one pitched copy, with no compacting kernel on the card."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda and x.dim() == 3 and x.dtype == torch.uint8 and not x.is_contiguous():
            from .bitrot_cuda import pitched, rows_to_host

            if pitched(tuple(x.shape), x.stride()) is not None:
                return rows_to_host(x)
        return x.cpu().numpy()
    return np.asarray(x)
