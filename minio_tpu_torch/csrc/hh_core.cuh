// The HighwayHash-256 core of K1 and K2: many equal-length messages, two
// threads per message, packets fed through an asynchronous ring in
// shared memory.
//
// Bound. The bytes are read once (rows x n) and 32 bytes a message
// written. The chain is the other bound: a message's packet rounds are
// serial, so no message finishes faster than n/32 rounds of one round's
// dependent arithmetic, whatever the batch. One thread per message with
// 8-byte loads from device memory in each round waited out a full memory
// latency every round (0.6-1.4 us per round on the H100), far above the
// round's own arithmetic. Below a few thousand messages a chain has an SM
// sub-partition to itself, and there the round's time is its instruction
// count: on the H100 a lone warp issues about one instruction every 2.3
// cycles, to the integer ALU and the FMA pipe alike (PERF.md: ns a round
// track the SASS count of the hot loop at ~1.17 ns an instruction; adds
// moved onto the FMA pipe as IMADs only added instructions, since ptxas
// splits a wide multiply-add back into IADD3s). So the design cuts
// instructions from the round and keeps its reads off the critical path.
//
// Design.
//  - Two threads per message, one per lane pair (highwayhash.cuh): each
//    runs half of every round and reads 16 of every 32 bytes, with no
//    exchange until finalization. Partner threads are adjacent lanes of
//    one warp, so finalization's exchange is a shuffle.
//  - A CTA is one warp that hashes `msgs` (8 or 16) messages through a
//    ring of `stages` stages in shared memory, each holding the next
//    `stage_bytes` bytes of every message. The first thread of each
//    message fills its slot with a TMA 1-D bulk copy (cp.async.bulk,
//    completion counted in bytes on the stage's `full` mbarrier, on which
//    each copier posts its own count), S - 1 windows ahead of the window the
//    chain is on. Threads wait on `full`, run their rounds from shared
//    memory and arrive on the stage's `empty` mbarrier, which the copiers
//    wait on before refilling the stage. No round waits on device memory
//    once the ring is primed. There is no producer warp: CTAs of one warp
//    spread evenly over an SM's four schedulers, and a row's address is
//    computed once, not per copy. A window's barriers and copies cost the
//    chain ~0.3 us, so the plan takes the largest window that keeps every
//    CTA resident.
//  - All of a CTA's messages have length n, so one stage holds the same
//    byte window of each message, in a slot of `slot_bytes` each.
//  - Any row start: a window's copy takes the 32-byte sectors that hold
//    its bytes, less a first or last 16-byte chunk that holds no byte of
//    the message (only at the message's two ends), so no copy leaves the
//    rows' allocation. Copies then start on a sector whatever the row's
//    alignment (copies starting mid-sector, as 16-byte granular ones of an
//    odd-length row do, ran markedly below the memory rate of
//    sector-aligned ones). The window's first byte sits at r = (row start
//    mod 32) in its slot.
//  - Two read paths, chosen per launch on the host from the row starts
//    (ops/bitrot_cuda.aligned; HHPlan::aligned). Aligned, where every row
//    start is 16-byte aligned (K1 always; r is 0 or 16): a thread's 16
//    bytes of a packet, at 32p + 16q + r in the slot, are one LDS.128,
//    with no bank conflict at the plan's slot (32 mod 128 bytes: a
//    quarter-warp's four messages cover the 32 banks). Generic: the five
//    4-byte words that hold them (from 32p + 16q + (r & 28)),
//    funnel-shifted by r & 3 bytes; 4-byte reads meet bank conflicts (up
//    to 4-way where rows share r), which cost less than the selects that
//    conflict-free 16-byte reads of an unaligned window need. Both issue
//    a packet's reads a round ahead of its use (~8% of an aligned round).
//    Measured (PERF.md, the H100): 39.6 SASS instructions a round aligned
//    (32.1 integer ALU, 6.1 FMA, 1 LSU), 47.6 generic (36.1, 6.1, 5),
//    against 48.25 for every round before the aligned path.
//  - The remainder packet (n mod 32 bytes, read from device memory once)
//    and the 10 finalization rounds end each message. n < 32 runs only
//    those; n = 0 only finalization.
//
// The launch plan (messages per CTA, stages, stage and slot bytes,
// dynamic shared memory) comes from ops/bitrot_cuda.plan and is checked
// here; a plan that does not fit is refused with cudaErrorInvalidValue.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "highwayhash.cuh"

#define HH_MAX_MSGS 16  // one warp a CTA
#define HH_MAX_SMEM 232448  // 227 KiB a CTA

struct HHPlan {
  int msgs;         // messages per CTA
  int stages;       // ring depth
  int stage_bytes;  // a message's bytes per stage: a multiple of 32
  int slot_bytes;   // a message's slot in a stage: >= stage_bytes + 32, multiple of 16
  int aligned;      // every row start 16-byte aligned: the 16-byte read path
};

static __device__ __forceinline__ int64_t hh_min(int64_t a, int64_t b) { return a < b ? a : b; }

static __device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

static __device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
static __device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA 1-D bulk copy, device memory -> shared memory; both addresses and
// the size multiples of 16. Completion is counted on `bar` in bytes.
static __device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A thread's 16 bytes of a packet, read from shared memory at `w` (its
// first 4-byte word of the packet): aligned (w 16-byte aligned), one
// 16-byte load; generic, the five 4-byte words that hold them, shifted
// right by sh/8 bytes (0-3) when the packet is hashed.
template <bool Aligned>
struct HHHalf {
  uint32_t x[Aligned ? 4 : 5];

  __device__ __forceinline__ void load(const uint32_t* w) {
    if constexpr (Aligned) {
      const uint4 v = *reinterpret_cast<const uint4*>(w);
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 5; ++i) x[i] = w[i];
    }
  }

  // the two little-endian 8-byte packet words
  __device__ __forceinline__ void words(unsigned sh, uint64_t a[2]) const {
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (Aligned)
        o[i] = x[i];
      else
        o[i] = __funnelshift_r(x[i], x[i + 1], sh);
    }
    a[0] = ((uint64_t)o[1] << 32) | o[0];
    a[1] = ((uint64_t)o[3] << 32) | o[2];
  }
};

// The packet rounds of one window: `packets` (>= 1) packets at 32-byte
// steps from `w`, the thread's first 4-byte word of the window in its slot
// (16q + (r & 28) past the slot's start). Each packet's read is issued a
// round ahead of its use, so no round waits on shared memory.
template <bool Aligned>
static __device__ __forceinline__ void hh_window(HHPair& st, const uint32_t* w, int packets,
                                                 unsigned r) {
  HHHalf<Aligned> cur;
  cur.load(w);
  uint64_t a[2];
#pragma unroll 8
  for (int p = 1; p < packets; ++p) {
    HHHalf<Aligned> next;
    next.load(w + 8 * p);
    cur.words(8 * (r & 3), a);
    hh_update(st, a);
    cur = next;
  }
  cur.words(8 * (r & 3), a);
  hh_update(st, a);
}

// Rows: a functor, message index -> address of its first byte.
// digests: 32 bytes a message, in message order.
template <class Rows>
__global__ void hh_ring_kernel(Rows rows, int64_t count, int64_t n, uint64_t k0, uint64_t k1,
                               uint64_t k2, uint64_t k3, uint8_t* __restrict__ digests,
                               HHPlan plan) {
  extern __shared__ __align__(128) uint8_t ring[];
  const int M = plan.msgs, S = plan.stages, W = plan.stage_bytes, slot = plan.slot_bytes;
  const uint32_t ring_u32 = (uint32_t)__cvta_generic_to_shared(ring);
  // barriers after the ring: full[0..S), empty[0..S)
  const uint32_t full0 = ring_u32 + (uint32_t)(S * M * slot);
  const uint32_t empty0 = full0 + 8u * S;
  const int64_t first = (int64_t)blockIdx.x * M;
  const int live = (int)hh_min(M, count - first);
  const int64_t whole = n & ~(int64_t)31;
  const int windows = (int)((whole + W - 1) / W);
  // threads 2m, 2m+1 hash message m: lane pairs q = 0, 1
  const int tid = threadIdx.x;
  const int m = tid >> 1, q = tid & 1;
  const bool valid = m < live;
  // a thread past the last message shadows message 0 (valid reads, no
  // copies, no store) so that every thread runs the same rounds
  const uint8_t* src = rows(first + (valid ? m : 0));
  // window copies start at the 32-byte sector at or below the window's
  // first byte, which then sits r bytes into its slot
  const unsigned r = (unsigned)((uintptr_t)src & 31);
  const bool copier = valid && q == 0;  // issues its message's copies
  const unsigned rest = blockDim.x - (unsigned)(tid & ~31);  // threads in this warp
  const unsigned mask = rest < 32u ? (1u << rest) - 1u : 0xffffffffu;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8u * s, live);  // one arrival per copier
      mbar_init(empty0 + 8u * s, 2u * M);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // window j of the thread's message into stage s, if it is a copier: the
  // 32-byte sectors that hold the window's bytes, less a first or last 16
  // bytes that hold no byte of the message (at its two ends); the copier
  // posts the byte count on the stage's `full` barrier, then copies
  auto fill = [&](int j, int s) {
    if (!copier) return;
    const uintptr_t a = (uintptr_t)src + (int64_t)j * W;
    const uintptr_t y = a + hh_min(W, whole - (int64_t)j * W);
    const uintptr_t a32 = a & ~(uintptr_t)31;
    const uintptr_t start16 = (uintptr_t)src & ~(uintptr_t)15;
    const uintptr_t lo = a32 > start16 ? a32 : start16;
    const uintptr_t end16 = ((uintptr_t)src + n + 15) & ~(uintptr_t)15;
    const uintptr_t y32 = (y + 31) & ~(uintptr_t)31;
    const uintptr_t hi = y32 < end16 ? y32 : end16;
    mbar_arrive_expect_tx(full0 + 8u * s, (uint32_t)(hi - lo));
    bulk_g2s(ring_u32 + (uint32_t)((s * M + m) * slot + (lo - a32)), (const void*)lo,
             (uint32_t)(hi - lo), full0 + 8u * s);
  };
  for (int j = 0; j < S && j < windows; ++j) fill(j, j);

  const uint64_t key[4] = {k0, k1, k2, k3};
  HHPair st;
  hh_reset(st, key, q);
  // stage and phase parity of window k, and of window k - 1, whose stage
  // is refilled with window k - 1 + S (stage and phase kept as counters:
  // a division by S costs more than a window's copies)
  int s = 0, rs = 0;
  uint32_t ph = 0, rph = 0;
  for (int k = 0; k < windows; ++k) {
    if (k >= 1) {
      if (k - 1 + S < windows) {
        if (copier) mbar_wait(empty0 + 8u * rs, rph);
        fill(k - 1 + S, rs);
      }
      if (++rs == S) rs = 0, rph ^= 1;
    }
    mbar_wait(full0 + 8u * s, ph);
    const uint32_t* base = reinterpret_cast<const uint32_t*>(
        ring + (size_t)(s * M + m) * slot + 16 * q + (r & 28));
    const int packets = (int)(hh_min(W, whole - (int64_t)k * W) >> 5);
    if (plan.aligned)
      hh_window<true>(st, base, packets, r);
    else
      hh_window<false>(st, base, packets, r);
    mbar_arrive(empty0 + 8u * s);
    if (++s == S) s = 0, ph ^= 1;
  }
  const int rem = (int)(n - whole);
  if (rem) hh_update_remainder(st, src + whole, rem, q);
  hh_finalize(st, mask, valid ? digests + (first + m) * 32 : nullptr, q);
}

// Checks the plan against the kernel's needs and launches on `stream`.
// Returns the cudaError_t (0 on success); count <= 0 launches nothing.
template <class Rows>
static int hh_ring_launch(Rows rows, int64_t count, int64_t n, uint64_t k0, uint64_t k1,
                          uint64_t k2, uint64_t k3, uint8_t* digests, int64_t aligned,
                          int64_t msgs, int64_t stages, int64_t stage_bytes, int64_t slot_bytes,
                          int64_t smem_bytes, cudaStream_t stream) {
  if (count <= 0) return 0;
  if (n < 0 || msgs < 1 || msgs > HH_MAX_MSGS || stages < 1 || stage_bytes < 32 ||
      stage_bytes % 32 || slot_bytes % 16 || slot_bytes < stage_bytes + 32 ||
      (n + stage_bytes - 1) / stage_bytes > INT32_MAX ||
      smem_bytes < stages * msgs * slot_bytes + 16 * stages || smem_bytes > HH_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      hh_ring_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const HHPlan plan = {(int)msgs, (int)stages, (int)stage_bytes, (int)slot_bytes,
                       aligned != 0};
  const unsigned grid = (unsigned)((count + msgs - 1) / msgs);
  hh_ring_kernel<Rows><<<grid, (unsigned)(2 * msgs), (size_t)smem_bytes, stream>>>(
      rows, count, n, k0, k1, k2, k3, digests, plan);
  return (int)cudaGetLastError();
}
