"""K1 wrapper: fused GF(2^8) encode/decode + HighwayHash-256 on the card.

Counterpart of the JAX package's ``ops/fused_pallas.py`` (the chunk-major
Pallas mega-kernel). One call turns d input shards into p output shards
— parity rows for encode, rebuild rows (``rs.reconstruct_rows_for``) for
decode — and returns the bitrot digests of all d + p shards. The CUDA
kernel is ``csrc/fused_encode_hash.cu`` (two launches on one stream: the
GF core of ``csrc/gf_core.cuh``, which K3 shares, on the matrix's product
tables laid out by ``gf_cuda.wide_tables`` and planned by
``gf_cuda.plan``; then the hash core of ``csrc/hh_core.cuh`` over all
d + p shards, planned by ``bitrot_cuda.plan``). ``gf_apply_only`` runs
the first launch alone, so its time can be read apart.

The contract is the reference's bytes, in row-major shapes: [B, d, n] in,
([B, p, n], [B, d+p, 32]) out, at any B; the TPU's chunk-major layout and
paired bit-plane weight are not carried over. ``Gate`` decides whether a
batch goes to K1: the knob, a backoff after an injected ``kernel-fail``,
and ``supports`` on (d, p, n) (EC 12+4 keeps going through the bit-plane
product and K2).

For CPU tensors the wrappers run the plain PyTorch version
(``fused_plain``: the bit-plane product then the plain hash); for CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import collections
import functools
import os

import numpy as np
import torch

from ..fault import registry as fault_registry
from . import _build, gf, gf_cuda, rs
from .bitrot_cuda import aligned, count_core_launch, plan
from .bitrot_torch import hash256_blocks_plain
from .highwayhash import MINIO_KEY
from .rs_torch import gf_apply_bits, gf_matrix_to_bitplanes

__all__ = [
    "supports", "Gate", "fused_encode_hash", "fused_decode_hash", "fused_plain",
    "decode_matrix", "gf_apply_only", "encode_launches", "decode_launches",
    "launch_shapes", "CHUNK_BYTES",
]

CHUNK_BYTES = 1024  # the reference's per-chunk shard bytes; n must be a multiple

# kernel launches made by each wrapper (CPU calls do not count), and the
# shapes they were made at: ("encode", B, d, p, n) or
# ("decode", B, d, p, n, present, missing) -> launches
encode_launches = 0
decode_launches = 0
launch_shapes: collections.Counter = collections.Counter()


def supports(d: int, p: int, n: int) -> bool:
    """Whether the fused kernel takes this shape (else the bit-plane
    product + chain kernel), at any batch size: encode (p = parity count)
    and decode (p = missing count) alike."""
    if d > 8 or p > 8 or p < 1 or d < 1:
        return False
    return n % CHUNK_BYTES == 0 and n > 0


class Gate:
    """Whether K1 takes a batch. Checked in order: ``MINIO_TPU_FUSED_CM``
    (0 keeps K1 off), the cooldown after an injected ``kernel-fail``,
    ``supports``, then the fault registry, so an injected fault fires only
    for shapes K1 takes. A fault sets a cooldown of 8 batches that doubles
    to 1,024 while faults repeat; a K1 success (``succeeded``) resets it
    to 8. One gate per caller: the dispatcher's per instance, the decode
    route's at module level."""

    def __init__(self):
        self.cooldown = 0   # batches to skip before K1 is tried again
        self._backoff = 8   # the next cooldown

    def admit(self, shape: str, d: int, p: int, n: int) -> tuple[bool, bool]:
        """(K1 takes the batch, an injected ``kernel-fail`` just fired);
        shape names the codec ("d+p") to the fault registry."""
        if os.environ.get("MINIO_TPU_FUSED_CM", "1") == "0":
            return False, False
        if self.cooldown > 0:
            self.cooldown -= 1
            return False, False
        if not supports(d, p, n):
            return False, False
        if fault_registry.check("tpu", shape, "kernel", modes=("kernel-fail",)) is not None:
            self.cooldown = self._backoff
            self._backoff = min(self._backoff * 2, 1024)
            return False, True
        return True, False

    def succeeded(self) -> None:
        self._backoff = 8


def gf_tables(m: np.ndarray) -> np.ndarray:
    """GF matrix [r, k] -> product tables [r, k, 256]: t[i, j, x] = m[i, j] * x."""
    m = np.asarray(m, dtype=np.uint8)
    return np.ascontiguousarray(gf.MUL_TABLE[m])


def decode_matrix(d: int, p: int, present: tuple, missing: tuple) -> np.ndarray:
    """Rows mapping the first d present shards onto the missing ones
    (ops/rs.py reconstruct_rows_for, cached in ops/decode_cache)."""
    return rs.get_codec(d, p).reconstruct_rows_for(list(present), list(missing))


def _wide(m: np.ndarray, device: str) -> torch.Tensor:
    return torch.from_numpy(gf_cuda.wide_tables(gf_tables(m))).to(device)


@functools.lru_cache(maxsize=32)
def _encode_tables(d: int, p: int, device: str) -> torch.Tensor:
    """The GF core's tables of the parity rows, on the card."""
    return _wide(rs.get_codec(d, p).parity_matrix, device)


@functools.lru_cache(maxsize=256)
def _decode_tables(d: int, p: int, present: tuple, missing: tuple, device: str) -> torch.Tensor:
    """The GF core's tables of the decode rows, on the card, per failure
    pattern (the reference's ``_decode_w3`` cache)."""
    return _wide(decode_matrix(d, p, present, missing), device)


def fused_plain(data: torch.Tensor, m: np.ndarray, key: bytes = MINIO_KEY):
    """Plain PyTorch K1: data [B, d, n] uint8, GF matrix m [r, d] ->
    (out [B, r, n], digests [B, d+r, 32]) on data's device."""
    b, d, n = data.shape
    r = m.shape[0]
    w = torch.from_numpy(gf_matrix_to_bitplanes(m).astype(np.float32)).to(data.device)
    out = gf_apply_bits(w, data, r)
    shards = torch.cat([data, out], dim=1).reshape(b * (d + r), n)
    return out, hash256_blocks_plain(shards, key).reshape(b, d + r, 32)


def _launch(kernel: str, data: torch.Tensor, tables: torch.Tensor, r: int, key: bytes):
    b, d, n = data.shape
    lib = _build.load()["fused_encode_hash"]
    out = torch.empty((b, r, n), dtype=torch.uint8, device=data.device)
    digests = torch.empty((b, d + r, 32), dtype=torch.uint8, device=data.device)
    rows_aligned = aligned((data.data_ptr(), b * d, n), (out.data_ptr(), b * r, n))
    gf_plan = gf_cuda.plan(b, d, r, n)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_encode_hash(
            data.data_ptr(), b, d, r, n, tables.data_ptr(),
            *_build.key_words(key), out.data_ptr(), digests.data_ptr(),
            *gf_plan.args(), rows_aligned, *plan(b * (d + r), n).args(),
            stream,
        )
    _build.check(rc, "fused_encode_hash")
    count_core_launch(kernel, rows_aligned)
    gf_cuda.count_plan_launch(kernel, gf_plan)
    return out, digests


def gf_apply_only(data: torch.Tensor, tables: torch.Tensor, r: int,
                  waves: int | None = None, small: bool | None = None) -> torch.Tensor:
    """K1's first launch alone on a CUDA tensor: data [B, d, n] and the GF
    core's [d, 256, E] tables of an [r, d] matrix (``_encode_tables``,
    ``_decode_tables``) -> out [B, r, n], on ``gf_cuda.plan``'s grid (or
    one of ``waves`` waves, or with its small-batch regime forced on or
    off by ``small``).
    Not a K1 launch: it counts nowhere (the smoke times it beside the
    whole kernel, and on grids of other sizes)."""
    if data.device.type != "cuda":
        raise ValueError(f"the GF launch runs only on the card, not {data.device}")
    b, d, n = data.shape
    want = (d, 256, gf_cuda.entry_width(r) * gf_cuda.groups(r))
    if tuple(tables.shape) != want or tables.dtype != torch.uint8:
        raise ValueError(f"want {want} uint8 tables, got {tuple(tables.shape)} {tables.dtype}")
    data = data.contiguous()
    lib = _build.load()["fused_encode_hash"]
    out = torch.empty((b, r, n), dtype=torch.uint8, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fused_gf_apply(data.data_ptr(), b, d, r, n, tables.data_ptr(),
                                out.data_ptr(), *gf_cuda.plan(b, d, r, n, waves, small).args(),
                                stream)
    _build.check(rc, "fused_gf_apply")
    return out


def _check(data: torch.Tensor, d: int, r: int) -> torch.Tensor:
    if data.dim() != 3 or data.dtype != torch.uint8 or data.shape[1] != d:
        raise ValueError(f"want a [B, {d}, n] uint8 tensor, got {tuple(data.shape)} {data.dtype}")
    b, _, n = data.shape
    if b < 1 or not supports(d, r, n):
        raise ValueError(f"fused kernel does not take d={d}, p={r}, B={b}, n={n}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused kernel for device {data.device}")
    return data.contiguous()


def fused_encode_hash(data: torch.Tensor, d: int, p: int, key: bytes = MINIO_KEY):
    """data [B, d, n] uint8 -> (parity [B, p, n], digests [B, d+p, 32]).
    Digest order matches hashing shards [B, d+p, n] row by row."""
    global encode_launches
    data = _check(data, d, p)
    if data.device.type == "cpu":
        return fused_plain(data, rs.get_codec(d, p).parity_matrix, key)
    out = _launch("fused_encode_hash", data, _encode_tables(d, p, str(data.device)), p, key)
    encode_launches += 1
    launch_shapes[("encode", data.shape[0], d, p, data.shape[2])] += 1
    return out


def fused_decode_hash(survivors: torch.Tensor, d: int, p: int, present: tuple,
                      missing: tuple, key: bytes = MINIO_KEY):
    """Fused reconstruct + hash.

    survivors: [B, d, n] uint8 — the first d present shards in
    present[:d] order. Returns (rebuilt [B, m, n], digests [B, d+m, 32]):
    digests[:, :d] are the survivors' (the verify verdicts), digests[:, d:]
    the rebuilt shards' (ready for heal frames).
    """
    global decode_launches
    m = len(missing)
    survivors = _check(survivors, d, m)
    pres, miss = tuple(present[:d]), tuple(missing)
    if survivors.device.type == "cpu":
        return fused_plain(survivors, decode_matrix(d, p, pres, miss), key)
    tables = _decode_tables(d, p, pres, miss, str(survivors.device))
    out = _launch("fused_decode_hash", survivors, tables, m, key)
    decode_launches += 1
    launch_shapes[("decode", survivors.shape[0], d, p, survivors.shape[2], pres, miss)] += 1
    return out
