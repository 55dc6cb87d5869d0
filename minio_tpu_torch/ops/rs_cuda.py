"""K3 wrapper: a binary bit-plane matrix applied to shard bytes on the card.

Counterpart of the JAX package's ``ops/rs_pallas.py`` (``gf_apply_pallas``,
the Pallas bit-plane matmul kernel), with its contract: an [8r, 8k] 0/1
matrix applied to [B, k, n] uint8 gives [B, r, n] uint8 — the GF(2^8)
matrix apply when the matrix is ``gf_matrix_to_bitplanes`` of one, and
exact for any other binary matrix too. The CUDA kernel is
``csrc/gf_apply.cu`` on the GF core ``csrc/gf_core.cuh``, which K1's GF
launch shares: the matrix becomes r*k 256-entry byte tables
(``bitplane_tables``, built on the host from the bit planes), laid out
input-major and wide (``gf_cuda.wide_tables``) and cached per matrix, so
one shared-memory lookup per input byte covers a whole output row group;
the launch is ``gf_cuda.plan``'s. Any n and any row alignment are taken,
so nothing is padded.

``sub`` > 1 applies a matrix over sub-chunk rows in place: data
[B, k, sub*h] is read as the [B, sub*k, h] composite whose row s*k + j is
sub-chunk s of row j, and the [B, sub*r, h] composite result is written
back as [B, r, sub*h] the same way. The cauchy family's encode is this
with sub = 2 (its a and b halves), with no transpose copy on either side.

Rows are read and written where they lie: the input may be a view whose
rows sit at any pitch (each row's bytes contiguous), and ``out`` a view
to write into, as the encode route writes parity into its shard slab
(``bitrot_torch.shard_slab``).

For a CPU tensor the wrapper runs the plain PyTorch version
(``gf_apply_plain``: the bit-plane product of ``rs_torch.gf_apply_bits``);
for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from . import _build, gf_cuda
from .gf_cuda import MAX_SMEM, smem_bytes
from .rs_torch import gf_apply_bits

__all__ = [
    "gf_apply_cuda", "gf_apply_plain", "bitplane_tables", "smem_bytes",
    "launches", "launch_shapes", "MAX_SMEM",
]

# kernel launches made by gf_apply_cuda (CPU calls do not count), and the
# shapes they were made at: (B, k, r, n, sub) -> launches, with k and r
# the matrix's composite row counts and n the composite row length
launches = 0
launch_shapes: collections.Counter = collections.Counter()


def _as_bits(w_bits) -> np.ndarray:
    w = np.asarray(w_bits)
    if w.ndim != 2 or w.shape[0] % 8 or w.shape[1] % 8 or not w.size:
        raise ValueError(f"want an [8r, 8k] bit-plane matrix, got shape {w.shape}")
    w = w.astype(np.uint8)
    if (w > 1).any():
        raise ValueError("bit-plane matrix entries must be 0 or 1")
    return w


def bitplane_tables(w_bits) -> np.ndarray:
    """[8r, 8k] 0/1 matrix -> [r, k, 256] uint8 byte tables:
    t[ri, ki, x] = XOR over the set bits i of x of column 8ki+i of block
    (ri, ki), bit j of that column being row 8ri+j."""
    w = _as_bits(w_bits)
    r, k = w.shape[0] // 8, w.shape[1] // 8
    blocks = w.reshape(r, 8, k, 8)  # [ri, j, ki, i]
    col = np.zeros((r, k, 8), dtype=np.uint8)  # column (ri, ki, i) as a byte
    for j in range(8):
        col |= blocks[:, j] << j
    x = np.arange(256)
    t = np.zeros((r, k, 256), dtype=np.uint8)
    for i in range(8):
        t ^= col[:, :, i, None] * ((x >> i) & 1).astype(np.uint8)
    return t


@functools.lru_cache(maxsize=64)
def _tables(key: bytes, r8: int, k8: int, device: str) -> torch.Tensor:
    w = np.frombuffer(key, dtype=np.uint8).reshape(r8, k8)
    return torch.from_numpy(gf_cuda.wide_tables(bitplane_tables(w))).to(device)


@functools.lru_cache(maxsize=64)
def _offsets(k: int, r: int, n: int, sub: int, in_pitch: int, out_pitch: int,
             device: str) -> torch.Tensor:
    """Byte offsets of the composite rows inside one batch item: input
    row s*k + j at j*in_pitch + s*n, then output row s*r + i at
    i*out_pitch + s*n (a pitch of sub*n for rows back to back)."""
    rows_in = [j * in_pitch + s * n for s in range(sub) for j in range(k)]
    rows_out = [i * out_pitch + s * n for s in range(sub) for i in range(r)]
    return torch.tensor(rows_in + rows_out, dtype=torch.int64, device=device)


def _check(w: np.ndarray, data: torch.Tensor, out_shards: int, sub: int) -> int:
    if data.dim() != 3 or data.dtype != torch.uint8:
        raise ValueError(f"want a [B, k, n] uint8 tensor, got {tuple(data.shape)} {data.dtype}")
    b, k, n = data.shape
    if sub < 1 or n % sub:
        raise ValueError(f"row length {n} does not split into {sub} sub-chunks")
    if w.shape != (8 * sub * out_shards, 8 * sub * k):
        raise ValueError(f"matrix {w.shape} does not map {sub}x{k} rows to {sub}x{out_shards}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no GF apply kernel for device {data.device}")
    return n // sub


def gf_apply_plain(w_bits, data: torch.Tensor, out_shards: int, sub: int = 1) -> torch.Tensor:
    """Plain PyTorch K3 on data's device: bit extraction, one float32
    matmul (TF32 off on the card), packing. Same contract as
    ``gf_apply_cuda``."""
    w = _as_bits(w_bits)
    h = _check(w, data, out_shards, sub)
    b, k, _ = data.shape
    wt = torch.from_numpy(w.astype(np.float32)).to(data.device)
    u = data.reshape(b, k, sub, h).transpose(1, 2).reshape(b, sub * k, h)
    out = gf_apply_bits(wt, u, sub * out_shards)
    return out.reshape(b, sub, out_shards, h).transpose(1, 2).reshape(b, out_shards, sub * h)


def gf_apply_cuda(w_bits, data: torch.Tensor, out_shards: int, sub: int = 1,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """[8r, 8k] bit-plane matrix applied to [B, k, n] (or [k, n]) uint8
    shard bytes -> [B, r, n] (or [r, n]) on data's device; with ``sub``,
    the [8*sub*r, 8*sub*k] matrix over sub-chunk rows (module docstring).
    ``out``: a view of that shape on data's device to write the result
    into (each row's bytes contiguous, no byte shared with ``data`` or
    another row), returned; by default a new tensor."""
    global launches
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
        out = None if out is None else out[None]
    w = _as_bits(w_bits)
    h = _check(w, data, out_shards, sub)
    b, k, n = data.shape
    if out is not None and (tuple(out.shape) != (b, out_shards, n) or out.dtype != torch.uint8
                            or out.device != data.device or (n > 1 and out.stride(2) != 1)):
        raise ValueError(f"want out of shape {(b, out_shards, n)} uint8 on {data.device} with "
                         f"contiguous rows, got {tuple(out.shape)} {out.dtype} on {out.device}")
    if data.device.type == "cpu":
        res = gf_apply_plain(w, data, out_shards, sub)
        if out is not None:
            res = out.copy_(res)
        return res[0] if squeeze else res
    kc, rc = sub * k, sub * out_shards
    launch = gf_cuda.plan(b, kc, rc, h)  # raises where the tables do not fit a block
    if n > 1 and data.stride(2) != 1:
        data = data.contiguous()
    if out is None:
        out = torch.empty((b, out_shards, n), dtype=torch.uint8, device=data.device)
    dev = str(data.device)
    tables = _tables(w.tobytes(), w.shape[0], w.shape[1], dev)
    offs = _offsets(k, out_shards, h, sub, data.stride(1), out.stride(1), dev)
    lib = _build.load()["gf_apply"]
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gf_apply(data.data_ptr(), data.stride(0), out.data_ptr(), out.stride(0), b, kc,
                           rc, h, tables.data_ptr(), offs.data_ptr(), *launch.args(), stream)
    _build.check(err, "gf_apply")
    launches += 1
    launch_shapes[(b, kc, rc, h, sub)] += 1
    gf_cuda.count_plan_launch("gf_apply", launch)
    return out[0] if squeeze else out
