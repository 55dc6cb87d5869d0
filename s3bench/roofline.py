"""The card's peaks and the least time a kernel's work can take.

Peaks of one H100 SXM, dense, as NVIDIA publishes them (at the full
700 W power limit): HBM at 3.35 TB/s, and 67 T operations a second, the
float32 rate outside the tensor cores, for the kernels' integer
operations. Work is counted from shapes: each input byte read once, each
output byte written once, and the operations the algorithm needs.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
ALU_OPS_S = 67e12
# 64-bit integer operations of one 32-byte HighwayHash packet round (4
# lanes x (adds, 32x32 multiply, xors) + 4 zipper merges), each once
HASH_OPS_PER_PACKET = 150
DIGEST = 32


def bound_s(read_b: float, write_b: float, ops: float) -> float:
    """The least time: the larger of bytes over the HBM rate and
    operations over the ALU rate."""
    return max((read_b + write_b) / HBM_BYTES_S, ops / ALU_OPS_S)


def packets(n: int) -> int:
    """HighwayHash packets of an n-byte message (a short tail is one)."""
    return -(-n // 32)


def k1(blocks: float, d: int, r: int, n: int) -> float:
    """K1 (fused GF apply + HighwayHash-256) on ``blocks`` stripe blocks:
    d input rows of n bytes in; r output rows and d + r digests out; one
    multiply and one add per output byte and input row, and the hash of
    all d + r rows."""
    return bound_s(blocks * d * n, blocks * (r * n + (d + r) * DIGEST),
                   blocks * (2 * r * d * n + (d + r) * packets(n) * HASH_OPS_PER_PACKET))

