"""K2 wrapper: HighwayHash-256 of B equal-length messages on the card.

Counterpart of the JAX package's ``ops/bitrot_pallas.py``
(``hash256_blocks_pallas``, the Pallas chain kernel). The CUDA kernel is
``csrc/hh_chain.cu`` on the hash core ``csrc/hh_core.cuh``: two threads
per message (one per lane pair), packets fed through a TMA-filled ring
in shared memory, tail packet and finalization included, so any length
n >= 0, any number of messages and any row start work, the rows back to
back or at any pitch. ``plan`` sizes the core's launch for K1 and K2
alike, and ``aligned`` picks its read path from the launch's row starts:
one 16-byte shared-memory read a packet half where every row start is
16-byte aligned, else five 4-byte reads and four funnel shifts. For a
CPU tensor the wrapper runs the plain PyTorch version
(``bitrot_torch.hash256_blocks_plain``); for a CUDA tensor it launches the
kernel or raises.

``rows_to_card`` and ``rows_to_host`` move [B, r, n] rows between a host
array and a CUDA tensor view whose rows lie at any pitch, in one pitched
copy (``copy_rows`` in ``csrc/hh_chain.cu``): the encode route's way into
and out of its shard slab (``bitrot_torch.shard_slab``).
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .bitrot_torch import hash256_blocks_plain
from .card import BLOCK_SMEM_MAX, BLOCK_SMEM_RESERVED, SM_SMEM, SMS
from .highwayhash import MINIO_KEY

__all__ = ["hash256_blocks", "plan", "Plan", "aligned", "count_core_launch", "launches",
           "launch_shapes", "core_launches", "pitched", "rows_to_card", "rows_to_host"]

# kernel launches made by hash256_blocks (CPU calls do not count), and
# the (B, n) shapes they were made at -> launches
launches = 0
launch_shapes: collections.Counter = collections.Counter()
# hash-core launches of K1 and K2 by (wrapper kernel, read path): path
# "aligned" or "generic" (``aligned``)
core_launches: collections.Counter = collections.Counter()

STAGES = 3                 # ring depth: 2 windows in flight ahead of the chain
WINDOWS = (8192, 4096, 2048, 1024, 512)  # a message's bytes per stage, largest first


class Plan(NamedTuple):
    """The hash core's launch: ``ctas`` CTAs of ``msgs`` messages (2
    threads each, one warp at most), a ring of ``stages`` stages holding
    ``stage_bytes`` of each message in a ``slot_bytes`` slot, and
    ``smem_bytes`` of dynamic shared memory (ring + 2 mbarriers a
    stage)."""

    msgs: int
    stages: int
    stage_bytes: int
    slot_bytes: int
    smem_bytes: int
    ctas: int

    def args(self) -> tuple[int, int, int, int, int]:
        """The plan's arguments of the C entry points, in their order."""
        return self.msgs, self.stages, self.stage_bytes, self.slot_bytes, self.smem_bytes


def plan(rows: int, n: int) -> Plan:
    """Launch plan of the hash core for ``rows`` messages of ``n`` bytes.

    Up to 16 x 132 messages, 8 a CTA, so the chains spread over every SM
    where rows allow; beyond that 16 a CTA (one full warp). The window
    (a message's bytes per stage) is the largest of ``WINDOWS`` with which
    every CTA is resident at once, capped at the whole-packet prefix:
    each window costs its copies' issue and its barriers (~0.3 us of the
    chain on an H100), so larger windows cost less per round, until
    shared memory would push CTAs into a second wave (8,192 bytes fit
    only at 8 messages a CTA, one CTA an SM). A slot holds the window
    plus the 32 bytes an unaligned row's copy adds (copies take whole
    32-byte sectors)."""
    whole = n - n % 32
    msgs = 8 if rows <= 16 * SMS else 16
    ctas = -(-rows // msgs)
    for w in WINDOWS:
        w = max(32, min(w, whole))
        slot = w + 32
        smem = STAGES * msgs * slot + 16 * STAGES
        per_sm = SM_SMEM // (smem + BLOCK_SMEM_RESERVED)
        if smem <= BLOCK_SMEM_MAX and ctas <= SMS * per_sm:
            break
    return Plan(msgs, STAGES, w, slot, smem, ctas)


def aligned(*runs: tuple[int, int, int]) -> bool:
    """Whether every row start of a hash-core launch is 16-byte aligned,
    which gives it the 16-byte read path. ``runs``: (address, rows,
    pitch), each ``rows`` rows from ``address``, one every ``pitch``
    bytes (the row length n for rows back to back)."""
    return all(rows <= 0 or (addr % 16 == 0 and (rows == 1 or pitch % 16 == 0))
               for addr, rows, pitch in runs)


def count_core_launch(kernel: str, is_aligned: bool) -> None:
    """Count one hash-core launch of wrapper ``kernel`` by its read path."""
    core_launches[(kernel, "aligned" if is_aligned else "generic")] += 1


def hash256_blocks(blocks: torch.Tensor, key: bytes = MINIO_KEY) -> torch.Tensor:
    """[B, n] uint8 -> [B, 32] uint8 digests, on blocks' device. On the
    card the rows are hashed where they lie, ``blocks.stride(0)`` bytes
    apart (the shard slab's pitch, ``bitrot_torch.shard_slab``), where
    each row's bytes are contiguous; another layout is made contiguous
    first."""
    global launches
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError(f"want a [B, n] uint8 tensor, got {tuple(blocks.shape)} {blocks.dtype}")
    if blocks.device.type == "cpu":
        return hash256_blocks_plain(blocks, key)
    if blocks.device.type != "cuda":
        raise ValueError(f"no HighwayHash kernel for device {blocks.device}")
    lib = _build.load()["hh_chain"]
    b, n = blocks.shape
    if (n > 1 and blocks.stride(1) != 1) or (b > 1 and blocks.stride(0) < n):
        blocks = blocks.contiguous()
    pitch = blocks.stride(0) if b > 1 else n
    out = torch.empty((b, 32), dtype=torch.uint8, device=blocks.device)
    if b == 0:
        return out
    rows_aligned = aligned((blocks.data_ptr(), b, pitch))
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hh_chain(blocks.data_ptr(), b, n, pitch, *_build.key_words(key),
                          out.data_ptr(), rows_aligned, *plan(b, n).args(), stream)
    _build.check(rc, "hh_chain")
    launches += 1
    launch_shapes[(b, n)] += 1
    count_core_launch("hh_chain", rows_aligned)
    return out


def pitched(shape: tuple[int, ...], strides: tuple[int, ...]) -> tuple[int, int] | None:
    """(pitch, rows an item) of a [B, r, n] uint8 layout (strides in
    bytes) that one pitched copy can address: each row's bytes
    contiguous, a row every ``pitch`` >= n bytes, an item every ``rows``
    >= r pitches. None for any other layout."""
    b, r, n = shape
    if n > 1 and strides[2] != 1:
        return None
    pitch = strides[1] if r > 1 else (strides[0] if b > 1 else n)
    rows = strides[0] // pitch if b > 1 and pitch > 0 else r
    if pitch < n or rows < r or (b > 1 and strides[0] != rows * pitch):
        return None
    return pitch, rows


def _copy_rows(card: torch.Tensor, host: np.ndarray, to_device: bool) -> None:
    """One pitched copy between a [B, r, n] CUDA view and a host array of
    the same shape, both laid out as ``pitched`` takes."""
    if not card.numel():
        return
    lay_card = pitched(tuple(card.shape), card.stride())
    lay_host = pitched(host.shape, host.strides)
    if lay_card is None or lay_host is None:
        raise ValueError(f"rows of shape {tuple(card.shape)} cannot go in one pitched copy")
    b, r, n = card.shape
    lib = _build.load()["hh_chain"]
    host_ptr = host.ctypes.data
    with torch.cuda.device(card.device):
        stream = torch.cuda.current_stream().cuda_stream
        if to_device:
            rc = lib.copy_rows(card.data_ptr(), *lay_card, host_ptr, *lay_host, n, r, b, 1, stream)
        else:
            rc = lib.copy_rows(host_ptr, *lay_host, card.data_ptr(), *lay_card, n, r, b, 0, stream)
    _build.check(rc, "copy_rows")


def rows_to_card(dst: torch.Tensor, src) -> None:
    """Copy host rows ``src`` ([B, r, n] uint8 array) into the CUDA view
    ``dst`` of the same shape, whose rows may lie at any pitch, in one
    pitched copy; returns once the copy has finished."""
    # miniovet: ignore[hostsync] -- src is host memory (an array or a CPU
    # tensor); nothing on the card is read
    src = np.asarray(src, dtype=np.uint8)
    if src.shape != tuple(dst.shape) or dst.dtype != torch.uint8 or dst.device.type != "cuda":
        raise ValueError(f"want a [B, r, n] uint8 CUDA view of shape {src.shape}, "
                         f"got {tuple(dst.shape)} {dst.dtype} on {dst.device}")
    if pitched(src.shape, src.strides) is None:
        src = np.ascontiguousarray(src)
    _copy_rows(dst, src, to_device=True)


def rows_to_host(src: torch.Tensor) -> np.ndarray:
    """A [B, r, n] uint8 CUDA view whose rows may lie at any pitch -> a
    new C-contiguous host array, in one pitched copy (``.cpu()`` of a
    strided view compacts it with a kernel on the card first)."""
    out = np.empty(tuple(src.shape), dtype=np.uint8)
    _copy_rows(src, out, to_device=False)
    return out
