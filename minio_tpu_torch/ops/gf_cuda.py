"""The GF(2^8) apply core of K1 and K3 (``csrc/gf_core.cuh``): its wide
tables and its launch plan.

K3 (``rs_cuda.gf_apply_cuda``) and K1's first launch (``fused_cuda``, C
entry ``fused_gf_apply``) both apply an [r, k] GF(2^8)-linear map, held
as per-byte tables ``t[i, j, x]`` (the byte that input byte x of row j
contributes to output row i), to k input rows. The core reads them
input-major and wide: ``wide_tables`` turns t into ``W[j, x, i]`` with the
output rows padded to an entry of E bytes (``entry_width``: 16, 8 or 4
from r) and, above 16 rows, G groups of 16 (``groups``), so that one
E-byte shared-memory lookup per input byte covers a whole output row
group. ``plan`` fixes the launch; the C entry points take its threads,
grid and row groups, and derive the rest from k, r and the plan as
``entry_width``, ``groups``, ``columns``, ``smem_bytes`` and
``split_smem_bytes`` do here. ``plan_launches`` counts the wrappers'
launches by plan regime. Nothing here touches the card.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import numpy as np

from .card import BLOCK_SMEM_MAX as MAX_SMEM
from .card import BLOCK_SMEM_RESERVED, SM_BLOCKS, SM_REGS, SM_SMEM, SM_THREADS, SMS

__all__ = ["Plan", "plan", "wide_tables", "entry_width", "groups", "columns", "registers",
           "smem_bytes", "split_smem_bytes", "count_plan_launch", "plan_launches",
           "MAX_SMEM", "UNEVEN_WAVES", "SMALL_BELOW", "COLUMN_WARPS", "ROWS_PER_WARP"]

THREADS = 256     # threads a block
# the small-batch regime: where the wave regime's tiles number fewer than
# this, its tiles of the most of COLUMN_WARPS warps whose tiles reach the
# SMs, their rows split ROWS_PER_WARP to a warp
SMALL_BELOW = SMS * 3 // 4
COLUMN_WARPS = (4, 2, 1)
ROWS_PER_WARP = 2  # input rows a warp loads at once in the small-batch regime (GF_SPLIT_ROWS)
UNEVEN_WAVES = 8  # waves of resident blocks where rows end in a partial column tile

# GF-core launches made by the wrappers (CPU calls do not count), by
# (wrapper, regime): "small" or "wave" (``Plan.regime``)
plan_launches: collections.Counter = collections.Counter()


def entry_width(r: int) -> int:
    """Bytes of a table entry's output row group: 16 above 8 rows, 8 above 4, else 4."""
    return 16 if r > 8 else 8 if r > 4 else 4


def groups(r: int) -> int:
    """Output row groups an entry holds: ceil(r / 16) above 16 rows, else 1."""
    return -(-r // 16) if r > 16 else 1


def columns(entry: int) -> int:
    """Columns a thread owns: 16 at 4-byte entries, else 8. Its
    accumulators (columns x entry bytes) take 16 or 32 registers."""
    return 16 if entry == 4 else 8


def registers(entry: int, small: bool = False) -> int:
    """Registers a thread may take (gf_core.cuh's launch bounds,
    ``GF_MIN_BLOCKS``): 80 at 16-byte entries (three blocks of 256 an SM),
    else 64 (four); 128 in the small-batch regime's instantiation (two).
    ``chip_smoke.py`` holds ptxas's count against it."""
    return 128 if small else 80 if entry == 16 else 64


def smem_bytes(k: int, r: int) -> int:
    """Dynamic shared memory of one block: k x 256 wide entries, then the
    k + r row offsets (int64)."""
    return 256 * k * entry_width(r) * groups(r) + 8 * (k + r)


def split_smem_bytes(k: int, r: int, threads: int, row_groups: int) -> int:
    """Dynamic shared memory of one block of the small-batch regime: the
    tables and offsets of ``smem_bytes`` up to a 16-byte boundary, then
    the accumulators of row groups 1.. (C x E bytes a thread of a row
    group of threads / row_groups)."""
    e = entry_width(r)
    parts = (row_groups - 1) * (threads // row_groups) * columns(e) * e
    return -(-smem_bytes(k, r) // 16) * 16 + parts


def wide_tables(t: np.ndarray) -> np.ndarray:
    """Per-byte tables [r, k, 256] -> the core's [k, 256, E*G] layout:
    W[j, x, i] = t[i, j, x] for i < r, zero for the padding rows."""
    t = np.asarray(t, dtype=np.uint8)
    if t.ndim != 3 or t.shape[2] != 256 or not t.shape[0] or not t.shape[1]:
        raise ValueError(f"want [r, k, 256] byte tables, got shape {t.shape}")
    r, k, _ = t.shape
    w = np.zeros((k, 256, entry_width(r) * groups(r)), dtype=np.uint8)
    w[:, :, :r] = t.transpose(1, 2, 0)
    return w


class Plan(NamedTuple):
    """The core's launch for B batch items of k input and r output rows of
    n bytes: ``threads`` a block, ``grid`` blocks (``waves`` waves of
    ``blocks_per_sm`` an SM, at most one a tile) and ``row_groups`` (0 in
    the wave regime; in the small-batch regime the groups of
    threads / row_groups that split a tile's k input rows), which the C
    entry points take; ``cols`` columns a thread, ``entry`` bytes an
    entry's output row group, ``groups`` output row groups and
    ``smem_bytes`` of dynamic shared memory, which they derive from k, r
    and the plan; ``tiles`` (batch item, column tile) pairs of ``span``
    columns."""

    cols: int
    entry: int
    groups: int
    threads: int
    grid: int
    smem_bytes: int
    blocks_per_sm: int
    waves: int
    tiles: int
    row_groups: int

    @property
    def regime(self) -> str:
        """"small" where the kernel splits a tile's rows over row groups,
        else "wave"."""
        return "small" if self.row_groups else "wave"

    @property
    def span(self) -> int:
        """Columns a tile: a row group's threads x ``cols``."""
        return self.threads // max(self.row_groups, 1) * self.cols

    def args(self) -> tuple[int, int, int]:
        """The plan's arguments of the C entry points, in their order."""
        return self.threads, self.grid, self.row_groups


def count_plan_launch(wrapper: str, p: Plan) -> None:
    """One GF-core launch by ``wrapper`` on plan p, under its regime."""
    plan_launches[(wrapper, p.regime)] += 1


@functools.lru_cache(maxsize=256)
def plan(b: int, k: int, r: int, n: int, waves: int | None = None,
         small: bool | None = None) -> Plan:
    """Launch plan of the GF core for b items of k -> r rows of n bytes.

    Blocks of 256 threads stage their tables once and stride over the
    tiles. Where every row splits into whole column tiles the grid is one
    wave of them; where rows end in a partial tile (K3 at the 8x24
    composite, h = 43,691) it is ``UNEVEN_WAVES`` waves, so that the
    block scheduler, not the stride, spreads the light tiles: on an H100
    that is ~11% faster there, while on whole tiles more waves cost 1-19%,
    each extra block staging its tables again (chip_smoke.py's
    ``gf_waves``, PERF.md). ``waves`` overrides the choice.

    The small-batch regime: where those tiles number fewer than
    ``SMALL_BELOW``, three quarters of the SMs (one 1 MiB block is 22
    tiles at EC 12+4, 64 at 8+8; on an H100 the regime takes 12+4 at
    B = 4, 88 tiles, from 9.0 to 7.4 us, and would take 8+8 at B = 2,
    128 tiles, from 4.2 to 4.5 us: PERF.md), a tile is the
    columns of the most of ``COLUMN_WARPS`` warps whose tiles reach the
    SMs (else of one warp), and ceil(k / ``ROWS_PER_WARP``) row groups of
    that many warps split its k rows (at most ``THREADS`` threads a
    block), their accumulators meeting in shared memory
    (``split_smem_bytes``). Where those do not fit a block, or rows
    outgrow 31 bits, the plan stays in the wave regime. ``small`` forces
    the regime on (where it fits) or off.

    Blocks per SM: the least of what shared memory (the block's + the
    system's 1 KiB), registers (``registers`` of the regime) and the SM's
    thread and block limits allow. Raises where the tables do not fit a block."""
    e, g = entry_width(r), groups(r)
    c = columns(e)
    smem = smem_bytes(k, r)
    if smem > MAX_SMEM:
        raise ValueError(f"a {r}x{k} table set needs {smem} B of shared memory, "
                         f"above the {MAX_SMEM} B a block may use")
    threads, row_groups, span = THREADS, 0, THREADS * c
    if small is None:
        small = b * -(-n // span) < SMALL_BELOW
    if small:
        cw = next((w for w in COLUMN_WARPS if b * -(-n // (32 * w * c)) >= SMS), 1)
        rg = max(1, min(-(-k // ROWS_PER_WARP), THREADS // (32 * cw)))
        if split_smem_bytes(k, r, 32 * cw * rg, rg) <= MAX_SMEM and n < 2**31 - 32 * cw * c:
            threads, row_groups, span = 32 * cw * rg, rg, 32 * cw * c
            smem = split_smem_bytes(k, r, threads, rg)
    tiles = b * -(-n // span)
    if waves is None:
        waves = 1 if n % span == 0 else UNEVEN_WAVES
    per_sm = min(SM_SMEM // (smem + BLOCK_SMEM_RESERVED),
                 SM_REGS // (registers(e, row_groups > 0) * threads),
                 SM_THREADS // threads, SM_BLOCKS)
    return Plan(c, e, g, threads, min(tiles, waves * SMS * per_sm), smem, per_sm, waves, tiles,
                row_groups)
