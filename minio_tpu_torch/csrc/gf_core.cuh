// The GF(2^8) apply core of K1 and K3: an [r, k] GF(2^8)-linear map, held
// as per-byte tables, applied to k input rows of n bytes for each of B
// batch items.
//
// Replaces, with one design for both:
//  - K3: minio_tpu/ops/rs_pallas.py:75 gf_apply_pallas -> _encode_kernel
//    (pallas_call :59), the [8r, 8k] bit-plane matrix on the MXU;
//  - the GF half of K1: minio_tpu/ops/fused_pallas.py:301/315
//    (fused_encode_hash_cm / fused_decode_hash_cm) -> _build.kern
//    (pallas_call :249), a paired bit-plane weight on the MXU.
// An [8r, 8k] binary matrix is r*k GF(2)-linear byte maps, and each map is
// a 256-entry byte table; a GF(2^8) matrix is the special case of product
// tables. The wrappers build the tables on the host and cache them per
// matrix (ops/rs_cuda.py, ops/fused_cuda.py; layout: ops/gf_cuda.py).
//
// Bound on the H100: bytes. Each input byte is read once (B*k*n) and each
// output byte written once (B*r*n): 512 MiB, 0.160 ms at 3.35 TB/s, both
// at the 8+8 cauchy composite (k = r = 16, n = 64 KiB) and at K1 encode
// 8+8 (n = 128 KiB) with B = 256.
//
// Why not one byte table per output row: that is one shared-memory byte
// lookup per output byte and input row, at k = r = 16, B = 256 4.3e9
// lookups into 256-byte tables (64 words on 32 banks, ~2 wavefronts a
// warp load): ~268 M shared-memory cycles over 132 SMs, ~1 ms, plus ~3
// integer operations a lookup to extract, shift and merge. Nor tables
// staged by every small block: at B = 256 that pulls 128 MiB from L2.
//
// Design.
//  - Wide, input-major tables. Entry (j, x) holds the E bytes that byte
//    value x of input row j contributes to E output rows (E = 16, 8 or 4
//    from r; rows past r are zero). One E-byte shared-memory load per
//    input byte replaces E byte loads, and an XOR of E/4 registers
//    accumulates it. Above 16 output rows an entry holds G groups of 16,
//    and the inputs are read once per group.
//  - The wavefront model. A warp's 16-byte loads go in quarter-warp phases
//    (8 lanes x 16 bytes, one wavefront when the 8 entries sit in 8
//    different groups of 4 banks). Entries are random, and 8 of them over
//    8 bank groups put ~2.5 on the fullest: ~10 wavefronts a warp lookup
//    (8-byte entries: two half-warp phases, ~6; 4-byte: ~4). At k = r = 16,
//    B = 256: 8.4 M warp lookups, ~84 M wavefronts over 132 SMs at one a
//    cycle, ~0.36 ms. All-zero input reads entry 0 in every lane, a
//    broadcast with no conflict: timing both (chip_smoke.py,
//    gf_conflict_ratio) measures the conflicts. On an H100 80GB HBM3 at
//    700 W they cost 1.5x there, not 2.5x, and the all-zero time is itself
//    1.6x the byte bound: a 16-byte entry moves 16 bytes through the SM's
//    shared-memory data path per input byte, which the rows' loads and
//    stores share (PERF.md).
//  - Column-major accumulators. A thread owns C columns (16 at E = 4, else
//    8: 16 or 32 accumulator registers) of one batch item; acc[c][q]
//    holds output rows 4q..4q+3 of column c. Before the stores, 4x4 byte
//    transposes (eight byte permutes per 16 bytes) turn them into row
//    words, and each output row's C bytes go out in stores as wide as the
//    row address allows (16, 8, 4, 2 or 1 bytes).
//  - Registers. The unrolled lookups keep C entries in flight, so a
//    thread takes 80 registers at E = 16 (three blocks of 256 an SM) and
//    64 otherwise (four). No instantiation spills within those caps; 64
//    at E = 16, and 16 columns at E = 8, did. The small-batch regime is
//    its own instantiation (Small), capped at 128 (two blocks of 256),
//    which holds its rows' loads in flight.
//  - Blocks that stride over (batch item, column tile) tiles, each
//    staging its tables once with one TMA bulk copy (cp.async.bulk on an
//    mbarrier, hh_core.cuh's helpers), which lands while its first tile's
//    first input row is loading. The grid (ops/gf_cuda.plan) is one wave
//    of resident blocks where rows split into whole tiles, and several
//    where rows end in a partial tile, so that the block scheduler
//    spreads the light tiles.
//  - Two regimes (ops/gf_cuda.plan). The wave regime, where tiles of
//    GF_THREADS fill the SMs: each thread loads its next input row one
//    step ahead of the current row's lookups. The small-batch regime,
//    where they would leave SMs idle (one 1 MiB block is 22 of them at
//    EC 12+4): narrower tiles spread the launch over the card, and a
//    tile's k rows are split over row groups of warps, each loading its
//    few rows at once, whose accumulators meet in shared memory: no warp
//    walks all k rows, and a tile waits on one memory latency, not k in
//    series. On an H100 one warp's chain of lookups takes ~430 cycles a
//    row, so a lone warp over 12 rows outlasts the whole launch's work
//    (PERF.md).
//  - Any row start (K3's rows are addressed by offsets, so the cauchy a/b
//    halves are read and written in place, at odd addresses at EC 12+4).
//    A row's start modulo C is the same for all its columns, so the
//    branch on it does not diverge. An unaligned thread's C bytes are two
//    aligned C-byte loads, both holding a byte of the row, funnel-shifted;
//    the last columns of a row are loaded and stored byte by byte.
// The launch's threads, grid and row groups come from ops/gf_cuda.plan;
// the entry width, columns a thread, output row groups and dynamic shared
// memory follow from k, r and the plan here (gf_core_launch), as they do
// in ops/gf_cuda.py.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hh_core.cuh"  // mbar_init, mbar_arrive_expect_tx, mbar_wait, bulk_g2s

#define GF_THREADS 256      // the most threads a block
// blocks of GF_THREADS an SM holds at entry width E: 80 registers a
// thread at E = 16, else 64 (ops/gf_cuda.registers); in the small-batch
// regime two, 128 registers a thread
#define GF_MIN_BLOCKS(E, Small) ((Small) ? 2 : (E) == 16 ? 3 : 4)
#define GF_MAX_SMEM 232448  // 227 KiB a block

// One apply: batch item b's input row j starts at in + b*in_bs + off[j]
// (j < k), its output row i at out + b*out_bs + off[k + i] (i < r); every
// row is n bytes. off: k + r int64 on the device, or null for rows back to
// back (off[j] = j*n, off[k + i] = i*n). tables: [k][256][E*G] u8 on the
// device, 16-byte aligned. Input and output must not overlap. row_groups:
// the launch plan's (ops/gf_cuda.plan), set by gf_core_launch.
struct GfJob {
  const uint8_t* in;
  int64_t in_bs;
  uint8_t* out;
  int64_t out_bs;
  int64_t B, n;
  int k, r;
  const uint8_t* tables;
  const int64_t* off;
  int row_groups;  // 0: the wave regime; else the small-batch regime's row groups
};

// x[i] = bytes 4(i+Q)+sh/8 .. of y, for the W words of an unaligned load
template <int W, int Q>
static __device__ __forceinline__ void gf_funnel(const uint32_t* y, unsigned sh, uint32_t* x) {
#pragma unroll
  for (int i = 0; i < W; ++i) x[i] = __funnelshift_r(y[i + Q], y[i + Q + 1], sh);
}

// Starts the loads of the C bytes at p into y (2C/4 words); rem bytes of
// the row are left from p on. Returns the byte shift that gf_align applies
// once they land: p's offset from the C-byte boundary below it, or 0 where
// p is aligned (y[0..C/4) then holds the bytes) or where fewer than C
// bytes are left (the row's last columns, loaded byte by byte, zero past
// rem). Both aligned loads of an unaligned p hold a byte of the row.
template <int C>
static __device__ __forceinline__ unsigned gf_fetch(const uint8_t* p, int64_t rem, uint32_t* y) {
  constexpr int W = C / 4;
  if (rem < C) {
#pragma unroll
    for (int i = 0; i < W; ++i) y[i] = 0u;
#pragma unroll
    for (int i = 0; i < C; ++i)
      if (i < rem) y[i >> 2] |= (uint32_t)__ldg(p + i) << (8 * (i & 3));
    return 0;
  }
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned m = (unsigned)(a & (C - 1));
  if constexpr (C == 16) {
    const uint4* w = reinterpret_cast<const uint4*>(a - m);
    const uint4 lo = __ldg(w);
    y[0] = lo.x, y[1] = lo.y, y[2] = lo.z, y[3] = lo.w;
    if (m) {
      const uint4 hi = __ldg(w + 1);
      y[4] = hi.x, y[5] = hi.y, y[6] = hi.z, y[7] = hi.w;
    }
  } else {
    const uint2* w = reinterpret_cast<const uint2*>(a - m);
    const uint2 lo = __ldg(w);
    y[0] = lo.x, y[1] = lo.y;
    if (m) {
      const uint2 hi = __ldg(w + 1);
      y[2] = hi.x, y[3] = hi.y;
    }
  }
  return m;
}

// x = the C bytes that start m bytes into y (gf_fetch's words and shift)
template <int C>
static __device__ __forceinline__ void gf_align(const uint32_t* y, unsigned m, uint32_t* x) {
  constexpr int W = C / 4;
  if (m == 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) x[i] = y[i];
    return;
  }
  const unsigned q = m >> 2, sh = (m & 3) * 8;
  if (q == 0) {
    gf_funnel<W, 0>(y, sh, x);
  } else if (q == 1) {
    gf_funnel<W, 1>(y, sh, x);
  } else if constexpr (C == 16) {
    if (q == 2)
      gf_funnel<W, 2>(y, sh, x);
    else
      gf_funnel<W, 3>(y, sh, x);
  }
}

// The C bytes of o (C/4 little-endian words) to p, as wide as p's
// alignment allows; rem < C stores only the first rem.
template <int C>
static __device__ __forceinline__ void gf_store(uint8_t* p, const uint32_t* o, int64_t rem) {
  constexpr int W = C / 4;
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(p);
  if (rem >= C) {
    if constexpr (C == 16) {
      if ((a & 15) == 0) {
        *reinterpret_cast<uint4*>(p) = make_uint4(o[0], o[1], o[2], o[3]);
        return;
      }
    }
    if ((a & 7) == 0) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i)
        reinterpret_cast<uint2*>(p)[i] = make_uint2(o[2 * i], o[2 * i + 1]);
      return;
    }
    if ((a & 3) == 0) {
#pragma unroll
      for (int i = 0; i < W; ++i) reinterpret_cast<uint32_t*>(p)[i] = o[i];
      return;
    }
    if ((a & 1) == 0) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        reinterpret_cast<uint16_t*>(p)[2 * i] = (uint16_t)o[i];
        reinterpret_cast<uint16_t*>(p)[2 * i + 1] = (uint16_t)(o[i] >> 16);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < C; ++i)
    if (i < rem) p[i] = (uint8_t)(o[i >> 2] >> (8 * (i & 3)));
}

// acc ^= the E-byte table entry at e (shared memory)
template <int E>
static __device__ __forceinline__ void gf_xor_entry(uint32_t* acc, const uint8_t* e) {
  if constexpr (E == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(e);
    acc[0] ^= v.x, acc[1] ^= v.y, acc[2] ^= v.z, acc[3] ^= v.w;
  } else if constexpr (E == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(e);
    acc[0] ^= v.x, acc[1] ^= v.y;
  } else {
    acc[0] ^= *reinterpret_cast<const uint32_t*>(e);
  }
}

// Rows 0..rows-1 of a group (out_off: their offsets) from the column-major
// accumulators: 4x4 byte transposes, then each row's C bytes stored.
template <int E, int C>
static __device__ __forceinline__ void gf_store_rows(const uint32_t (&acc)[C][E / 4],
                                                     uint8_t* dst, const int64_t* out_off,
                                                     int rows, int64_t rem) {
  constexpr int W = C / 4;
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    uint32_t o[4][W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      // a_c = rows 4q..4q+3 of column 4w+c -> o[t][w] = row 4q+t of columns 4w..4w+3
      const uint32_t t0 = __byte_perm(acc[4 * w][q], acc[4 * w + 1][q], 0x5140);
      const uint32_t t1 = __byte_perm(acc[4 * w][q], acc[4 * w + 1][q], 0x7362);
      const uint32_t t2 = __byte_perm(acc[4 * w + 2][q], acc[4 * w + 3][q], 0x5140);
      const uint32_t t3 = __byte_perm(acc[4 * w + 2][q], acc[4 * w + 3][q], 0x7362);
      o[0][w] = __byte_perm(t0, t2, 0x5410);
      o[1][w] = __byte_perm(t0, t2, 0x7632);
      o[2][w] = __byte_perm(t1, t3, 0x5410);
      o[3][w] = __byte_perm(t1, t3, 0x7632);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (4 * q + t < rows) gf_store<C>(dst + out_off[4 * q + t], o[t], rem);
  }
}

#define GF_SPLIT_ROWS 2  // input rows a warp loads at once in the small-batch regime

// Shared memory from the tables on: the k + r row offsets (int64), then,
// in the small-batch regime, at a 16-byte boundary, the accumulators of
// row groups 1.. (ops/gf_cuda.split_smem_bytes)
static __host__ __device__ __forceinline__ int64_t gf_parts_at(int64_t tab_bytes, int k, int r) {
  return tab_bytes + ((8 * (int64_t)(k + r) + 15) & ~(int64_t)15);
}

// The small-batch regime: the block's threads are row_groups groups of
// whole warps; a tile is one group's columns (C a thread) of one batch
// item, and group q applies rows q, q + row_groups, ... of it, loading
// GF_SPLIT_ROWS of them at once, so that a tile waits on one memory
// latency, not k in series. Groups 1.. leave their accumulators in
// shared memory, and group 0 XORs them into its own and stores the
// tile's output rows. n and the tiles fit 31 bits (gf_core_launch).
template <int E, int C>
static __device__ __forceinline__ void gf_split_tiles(const GfJob& job, int groups,
                                                      uint8_t* smem, const int64_t* s_off,
                                                      uint32_t tab_bytes, uint32_t bar) {
  constexpr int V = C * E / 16;  // a thread's accumulators as uint4
  const int k = job.k, r = job.r, tid = threadIdx.x, rgs = job.row_groups;
  const int stride = E * groups;
  const int lanes = (int)blockDim.x / rgs;            // threads a row group
  const int rg = tid / lanes, ct = tid - rg * lanes;  // its row group and column thread
  const int n = (int)job.n, span = lanes * C;
  const int per_item = (n + span - 1) / span, tiles = (int)job.B * per_item;
  uint4* part = reinterpret_cast<uint4*>(smem + gf_parts_at(tab_bytes, k, r));  // [rgs-1][V][lanes]
  bool ready = false;  // the tables have landed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / per_item;
    const int col = (tile - b * per_item) * span + ct * C, rem = n - col;
    const uint8_t* src = job.in + b * job.in_bs + col;
    for (int g = 0; g < groups; ++g) {
      uint32_t acc[C][E / 4];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int q = 0; q < E / 4; ++q) acc[c][q] = 0u;
      if (rem > 0) {
        for (int j0 = rg; j0 < k; j0 += GF_SPLIT_ROWS * rgs) {
          uint32_t y[GF_SPLIT_ROWS][C / 2];
          unsigned m[GF_SPLIT_ROWS];
#pragma unroll
          for (int i = 0; i < GF_SPLIT_ROWS; ++i)
            if (j0 + i * rgs < k) m[i] = gf_fetch<C>(src + s_off[j0 + i * rgs], rem, y[i]);
          if (!ready) {
            mbar_wait(bar, 0);
            ready = true;
          }
#pragma unroll
          for (int i = 0; i < GF_SPLIT_ROWS; ++i) {
            const int j = j0 + i * rgs;
            if (j >= k) break;
            uint32_t x[C / 4];
            gf_align<C>(y[i], m[i], x);
            const uint8_t* t = smem + g * E + j * 256 * stride;
#pragma unroll
            for (int c = 0; c < C; ++c)
              gf_xor_entry<E>(acc[c], t + __byte_perm(x[c >> 2], 0, 0x4440 | (c & 3)) * stride);
          }
        }
      }
      if (rgs > 1) {
        if (g) __syncthreads();  // group 0 has read the last output group's partials
        if (rg) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            uint32_t w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) w[i] = acc[(4 * v + i) / (E / 4)][(4 * v + i) % (E / 4)];
            part[((rg - 1) * V + v) * lanes + ct] = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
        __syncthreads();
        if (!rg) {
          for (int p = 0; p < rgs - 1; ++p) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const uint4 u = part[(p * V + v) * lanes + ct];
              const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[(4 * v + i) / (E / 4)][(4 * v + i) % (E / 4)] ^= w[i];
            }
          }
        }
      }
      if (!rg && rem > 0)
        gf_store_rows<E, C>(acc, job.out + b * job.out_bs + col, s_off + k + g * E,
                            min(E, r - g * E), rem);
    }
    if (rgs > 1) __syncthreads();  // the partials are free
  }
  if (!ready) mbar_wait(bar, 0);  // no block retires with its table copy in flight
}

// The wave regime: blocks of GF_THREADS stride over the tiles, each
// thread loading its next input row one step ahead of the current row's
// lookups.
template <int E, int C>
static __device__ __forceinline__ void gf_wave_tiles(const GfJob& job, int groups,
                                                     const uint8_t* smem, const int64_t* s_off,
                                                     uint32_t bar) {
  const int k = job.k, r = job.r, tid = threadIdx.x;
  const int stride = E * groups;  // bytes of one table entry
  const int64_t span = (int64_t)blockDim.x * C;  // columns a tile
  const int64_t per_item = (job.n + span - 1) / span;
  const int64_t tiles = job.B * per_item;
  bool ready = false;  // the tables have landed
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t b = tile / per_item;
    const int64_t col = (tile - b * per_item) * span + (int64_t)tid * C;
    if (col >= job.n) continue;
    const int64_t rem = job.n - col;
    const uint8_t* src = job.in + b * job.in_bs + col;
    uint8_t* dst = job.out + b * job.out_bs + col;
    for (int g = 0; g < groups; ++g) {
      uint32_t acc[C][E / 4];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int q = 0; q < E / 4; ++q) acc[c][q] = 0u;
      uint32_t y[C / 2], x[C / 4];
      unsigned m = gf_fetch<C>(src + s_off[0], rem, y);
      if (!ready) {
        mbar_wait(bar, 0);
        ready = true;
      }
      const uint8_t* t = smem + g * E;  // row j's entries, this group's bytes
      for (int j = 0;; ++j, t += 256 * stride) {
        gf_align<C>(y, m, x);
        // the next row's loads are in flight while this row's lookups run
        const bool more = j + 1 < k;
        if (more) m = gf_fetch<C>(src + s_off[j + 1], rem, y);
#pragma unroll
        for (int c = 0; c < C; ++c)
          gf_xor_entry<E>(acc[c], t + __byte_perm(x[c >> 2], 0, 0x4440 | (c & 3)) * stride);
        if (!more) break;
      }
      gf_store_rows<E, C>(acc, dst, s_off + k + g * E, min(E, r - g * E), rem);
    }
  }
  if (!ready) mbar_wait(bar, 0);  // no block retires with its table copy in flight
}

// Small: the small-batch regime (job.row_groups > 0), else the wave regime
template <int E, int C, bool Small>
__global__ void __launch_bounds__(GF_THREADS, GF_MIN_BLOCKS(E, Small))
gf_core_kernel(const GfJob job, const int groups) {
  extern __shared__ __align__(128) uint8_t smem[];  // tables, offsets, partials (small)
  __shared__ __align__(8) uint64_t bar_word;
  const int k = job.k, r = job.r, tid = threadIdx.x;
  const int stride = E * groups;  // bytes of one table entry
  const uint32_t tab_bytes = (uint32_t)k * 256u * (uint32_t)stride;
  int64_t* s_off = reinterpret_cast<int64_t*>(smem + tab_bytes);
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(&bar_word);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_arrive_expect_tx(bar, tab_bytes);
    bulk_g2s((uint32_t)__cvta_generic_to_shared(smem), job.tables, tab_bytes, bar);
  }
  for (int i = tid; i < k + r; i += blockDim.x)
    s_off[i] = job.off ? job.off[i] : (int64_t)(i < k ? i : i - k) * job.n;
  __syncthreads();

  if constexpr (Small) {
    gf_split_tiles<E, C>(job, groups, smem, s_off, tab_bytes, bar);
  } else {
    gf_wave_tiles<E, C>(job, groups, smem, s_off, bar);
  }
}

template <int E, int C, bool Small>
static int gf_core_launch_ec(const GfJob& job, int groups, int threads, int grid, int smem,
                             cudaStream_t stream) {
  // the shared-memory limit is the kernel's, not the launch's: another
  // thread setting a smaller one between this set and this launch would
  // fail the launch, so the two go together
  static std::mutex mu;
  const std::lock_guard<std::mutex> hold(mu);
  const cudaError_t e = cudaFuncSetAttribute(
      gf_core_kernel<E, C, Small>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  gf_core_kernel<E, C, Small>
      <<<(unsigned)grid, (unsigned)threads, (size_t)smem, stream>>>(job, groups);
  return (int)cudaGetLastError();
}

// Launches the job on `stream` with the plan's threads, grid and row
// groups (ops/gf_cuda.plan; row_groups 0 is the wave regime, else the
// small-batch regime's groups of threads / row_groups, a multiple of 32).
// The entry width E (16 above 8 output rows, 8 above 4, else 4), the
// columns a thread (16 at E = 4, else 8), the row groups of output rows
// (ceil(r / 16) above 16 rows) and the dynamic shared memory follow from
// k, r and the plan: k*256*E*G table bytes, then k + r int64 offsets,
// then in the small-batch regime, at a 16-byte boundary,
// (row_groups - 1)*threads/row_groups partial accumulators of C*E bytes.
// Returns the cudaError_t (0 on success); B <= 0 or n <= 0 launches
// nothing.
static int gf_core_launch(GfJob job, int64_t threads, int64_t grid, int64_t row_groups,
                          cudaStream_t stream) {
  if (job.B <= 0 || job.n <= 0) return 0;
  if (job.k < 1 || job.r < 1 || threads < 32 || threads > GF_THREADS || threads % 32 ||
      grid < 1 || grid > INT32_MAX || reinterpret_cast<uintptr_t>(job.tables) % 16 ||
      row_groups < 0 || (row_groups && (threads % (32 * row_groups))))
    return (int)cudaErrorInvalidValue;
  const int entry = job.r > 8 ? 16 : job.r > 4 ? 8 : 4;
  const int groups = job.r > 16 ? (job.r + 15) / 16 : 1;
  const int cols = entry == 4 ? 16 : 8;
  const int64_t tab = (int64_t)job.k * 256 * entry * groups;
  int64_t smem = tab + 8 * (int64_t)(job.k + job.r);
  if (row_groups) {
    const int64_t lanes = threads / row_groups, span = lanes * cols;
    if (job.n > INT32_MAX - span || job.B * ((job.n + span - 1) / span) > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    smem = gf_parts_at(tab, job.k, job.r) + (row_groups - 1) * lanes * cols * entry;
  }
  if (smem > GF_MAX_SMEM) return (int)cudaErrorInvalidValue;
  job.row_groups = (int)row_groups;
  const int t = (int)threads, n = (int)grid, s = (int)smem;
  if (row_groups) {
    if (entry == 4) return gf_core_launch_ec<4, 16, true>(job, groups, t, n, s, stream);
    if (entry == 8) return gf_core_launch_ec<8, 8, true>(job, groups, t, n, s, stream);
    return gf_core_launch_ec<16, 8, true>(job, groups, t, n, s, stream);
  }
  if (entry == 4) return gf_core_launch_ec<4, 16, false>(job, groups, t, n, s, stream);
  if (entry == 8) return gf_core_launch_ec<8, 8, false>(job, groups, t, n, s, stream);
  return gf_core_launch_ec<16, 8, false>(job, groups, t, n, s, stream);
}
