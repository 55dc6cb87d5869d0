"""Reed-Solomon erasure codec on torch tensors (bit-plane matmul).

Counterpart of the JAX package's ``ops/rs_jax.py``. GF(2^8)
multiplication by a constant is linear over GF(2) in the 8 bits of the
input byte, so a whole [r, k] GF matrix apply (encode parity, rebuild
missing shards) is ONE binary matrix product over bit planes:

    out_bits[8r, n] = W[8r, 8k] @ in_bits[8k, n]  (mod 2)

``torch.matmul`` has no integer path on CUDA, so the 0/1 planes multiply
in float32 with TF32 off: every sum is at most 8k <= 96, an exact float.
This product is plain torch (outside any hand-written kernel), as the
reference left it to XLA. On the card, encode takes K3 instead
(``ops/rs_cuda.py``, the same bit-plane matrix as byte tables in one
launch), and the dispatcher's EC <= 8+8 shapes take the fused CUDA
kernel (``ops/fused_cuda.py``).

Byte-identical with ``ops/rs.py`` (the numpy reference codec).
"""

from __future__ import annotations

import collections
import functools
import math

import numpy as np
import torch

from .. import device as devmod
from . import gf, rs

__all__ = [
    "gf_matrix_to_bitplanes", "gf_apply_bits", "TorchRSCodec",
    "get_torch_codec", "codec_from_matrices",
]

# bound on the float32 bit-plane temporaries of one gf_apply_bits chunk
_APPLY_CHUNK_BYTES = 512 << 20


def gf_matrix_to_bitplanes(m: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix [r,k] into its binary bit-plane form [8r,8k].

    W[8*ri + j, 8*ki + i] = bit j of gf_mul(m[ri,ki], 1<<i): applying W to the
    bit-decomposition of k shards and reducing mod 2 equals the GF matrix
    apply on bytes.
    """
    m = np.asarray(m, dtype=np.uint8)
    r, k = m.shape
    w = np.zeros((8 * r, 8 * k), dtype=np.int8)
    for ri in range(r):
        for ki in range(k):
            c = int(m[ri, ki])
            if c == 0:
                continue
            for i in range(8):
                prod = gf.MUL_TABLE[c, 1 << i]
                for j in range(8):
                    w[8 * ri + j, 8 * ki + i] = (prod >> j) & 1
    return w


def gf_apply_bits(w: torch.Tensor, data: torch.Tensor, out_shards: int) -> torch.Tensor:
    """Apply a bit-plane GF matrix to shard data.

    w: [8r, 8k] float32 0/1 on data's device; data: [..., k, n] uint8;
    returns [..., r, n] uint8. Leading batch dims are walked in chunks so
    the float32 planes stay bounded.
    """
    *batch, k, n = data.shape
    flat = data.reshape(math.prod(batch), k, n)  # -1 is ambiguous for empty rows
    out = torch.empty((flat.shape[0], out_shards, n), dtype=torch.uint8,
                      device=data.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    weights = (torch.ones((), dtype=torch.int32, device=data.device)
               << shifts.to(torch.int32)).view(1, 1, 8, 1)
    step = max(1, _APPLY_CHUNK_BYTES // max(1, 4 * 8 * (k + out_shards) * n))
    for s in range(0, flat.shape[0], step):
        x = flat[s:s + step]
        # [b, k, 8, n] bit planes, LSB first -> [b, 8k, n]
        bits = ((x.unsqueeze(-2) >> shifts.view(1, 1, 8, 1)) & 1).to(torch.float32)
        acc = torch.matmul(w, bits.reshape(x.shape[0], 8 * k, n))  # [b, 8r, n]
        ob = (acc.to(torch.int32) & 1).reshape(x.shape[0], out_shards, 8, n)
        out[s:s + step] = (ob * weights).sum(dim=2).to(torch.uint8)
    return out.reshape(*batch, out_shards, n)


class TorchRSCodec:
    """Systematic RS(d+p, d) codec on one torch device.

    Shares matrix construction (and therefore bytes) with the numpy
    reference codec; adds the batched device entry points used by the
    parallel dispatcher. Creating a codec on a CUDA device builds the
    port's kernels (``ops/_build.py``); a build error propagates.
    """

    def __init__(self, data_shards: int, parity_shards: int,
                 device: str | torch.device | None = None):
        self.device = devmod.resolve(device)
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self._ref = rs.get_codec(data_shards, parity_shards)
        self.parity_matrix = self._ref.parity_matrix
        self.w_encode = gf_matrix_to_bitplanes(self.parity_matrix)
        if self.device.type == "cuda":
            from . import _build

            _build.load()
            # the 0/1 bit-plane sums must stay exact: full float32 products
            torch.backends.cuda.matmul.allow_tf32 = False
        self._w_encode_dev = self._w(self.w_encode)
        # LRU-bounded: degraded reads across many distinct failure patterns
        # must not accumulate unbounded matrices.
        self._decode_w_cache: "collections.OrderedDict[tuple, np.ndarray]" = (
            collections.OrderedDict()
        )
        self._decode_w_cache_max = 512

    def _w(self, w: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(w.astype(np.float32)).to(self.device)

    def as_tensor(self, x) -> torch.Tensor:
        """uint8 array/tensor -> uint8 tensor on this codec's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.uint8)
        a = np.asarray(x, dtype=np.uint8)
        if not a.flags.writeable or not a.flags.c_contiguous:
            a = np.array(a, dtype=np.uint8)
        return torch.from_numpy(a).to(self.device)

    # -- encode ------------------------------------------------------------

    def encode_blocks(self, data, out: torch.Tensor | None = None) -> torch.Tensor:
        """[B, d, n] data shards -> [B, p, n] parity shards (on device),
        written into ``out`` where given (a view whose rows may lie at any
        pitch: the shard slab's parity rows) and returned. On the card,
        K3 applies the bit-plane matrix in one launch, where the product
        here takes a dozen kernels and twice as many host calls."""
        x = self.as_tensor(data)
        if x.device.type == "cuda" and x.numel():
            from .rs_cuda import gf_apply_cuda

            return gf_apply_cuda(self.w_encode, x, self.parity_shards, out=out)
        parity = gf_apply_bits(self._w_encode_dev, x, self.parity_shards)
        return parity if out is None else out.copy_(parity)

    def encode_data(self, data: bytes) -> np.ndarray:
        """bytes -> [total, per_shard] encoded shards (host round-trip).

        Convenience / test path; the server uses encode_blocks via the
        batching dispatcher.
        """
        shards = self._ref.split(data)
        parity = self.encode_blocks(shards[None, : self.data_shards])[0]
        shards[self.data_shards :] = parity.cpu().numpy()
        return shards

    # -- reconstruct -------------------------------------------------------

    def _reconstruct_w(self, present: tuple[int, ...], missing: tuple[int, ...]) -> np.ndarray:
        """Bit-plane matrix mapping the first d present shards -> missing
        shards, cached host-side per erasure pattern (LRU)."""
        key = (present[: self.data_shards], missing)
        cached = self._decode_w_cache.get(key)
        if cached is not None:
            self._decode_w_cache.move_to_end(key)
            return cached
        m = self._ref.reconstruct_rows_for(list(present), list(missing))
        w = gf_matrix_to_bitplanes(m)
        self._decode_w_cache[key] = w
        if len(self._decode_w_cache) > self._decode_w_cache_max:
            self._decode_w_cache.popitem(last=False)
        return w

    def reconstruct_blocks(self, survivors, present: tuple[int, ...],
                           missing: tuple[int, ...]) -> torch.Tensor:
        """Rebuild missing shards from the first d surviving shards.

        survivors: [..., d, n] — shards at indices present[:d], in that
        order. Returns [..., len(missing), n] on the codec's device.
        """
        w = self._w(self._reconstruct_w(tuple(present), tuple(missing)))
        return gf_apply_bits(w, self.as_tensor(survivors), len(missing))


@functools.lru_cache(maxsize=None)
def _codec(data_shards: int, parity_shards: int, device: str) -> TorchRSCodec:
    return TorchRSCodec(data_shards, parity_shards, device)


def get_torch_codec(data_shards: int, parity_shards: int,
                    device: str | torch.device | None = None) -> TorchRSCodec:
    return _codec(data_shards, parity_shards, str(devmod.resolve(device)))


def codec_from_matrices(parity_matrix: np.ndarray, w_encode: np.ndarray,
                        device: str | torch.device | None = None) -> TorchRSCodec:
    """The port's codec for another codec's matrices (numpy arrays): the
    GF parity matrix [p, d] and its bit-plane form [8p, 8d]. Raises when
    they are not the matrices this package derives for (d, p) — decode
    rows come from the same construction, so a mismatch would rebuild
    wrong bytes."""
    pm = np.asarray(parity_matrix, dtype=np.uint8)
    p, d = pm.shape
    codec = get_torch_codec(d, p, device)
    if not np.array_equal(codec.parity_matrix, pm):
        raise ValueError(f"parity matrix differs from this package's RS({d + p},{d})")
    if not np.array_equal(codec.w_encode, np.asarray(w_encode, dtype=np.int8)):
        raise ValueError("bit-plane encode matrix differs from the parity matrix's")
    return codec
