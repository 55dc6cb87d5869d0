// HighwayHash-256 on one lane pair: the algorithm of the hash core
// (hh_core.cuh), which K2 (hh_chain.cu) and K1 (fused_encode_hash.cu)
// share.
//
// The same algorithm as ops/highwayhash.py (the numpy reference), with
// native 64-bit lanes: the TPU kernels split every lane into 32-bit
// halves, CUDA does not need to. The multiply is the 32x32 -> 64 product
// (mul.wide.u32), the zipper merge six byte permutes.
//
// A round is some 38 instructions on a lane pair: 12 byte permutes, 8
// xors and the 64-bit adds on the integer ALU (ptxas moves a few carries
// onto the FMA pipe as IMAD.X), 4 products (IMAD.WIDE.U32) on the FMA
// pipe. In a chain alone on its SM sub-partition the count, not any one
// pipe, sets the round's time (hh_core.cuh).
//
// The state is split by lane pair. In a whole-packet round (hh_update)
// lanes 0-1 and lanes 2-3 never exchange a value: each lane's update is
// its own, and each zipper merge stays inside its pair. So one thread
// per pair (q = 0: lanes 0-1, q = 1: lanes 2-3) runs the packet chain on
// 16 of every 32 bytes with no communication. The pairs meet only in
// finalization: each permutation round feeds a pair the other pair's v0
// (hh_finalize, one warp shuffle between partner lanes), and each
// 128-bit half of the digest reduces one pair.
#pragma once
#include <stdint.h>

struct HHPair {
  uint64_t v0[2], v1[2], mul0[2], mul1[2];
};

static __device__ __forceinline__ uint64_t hh_rot32(uint64_t x) {
  return (x >> 32) | (x << 32);
}

// lanes 2q, 2q+1 of the keyed initial state
static __device__ __forceinline__ void hh_reset(HHPair& s, const uint64_t key[4], int q) {
  const uint64_t init0[4] = {0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull,
                             0x13198a2e03707344ull, 0x243f6a8885a308d3ull};
  const uint64_t init1[4] = {0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull,
                             0xbe5466cf34e90c6cull, 0x452821e638d01377ull};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint64_t i0 = q ? init0[2 + i] : init0[i];
    const uint64_t i1 = q ? init1[2 + i] : init1[i];
    const uint64_t k = q ? key[2 + i] : key[i];
    s.mul0[i] = i0;
    s.mul1[i] = i1;
    s.v0[i] = i0 ^ k;
    s.v1[i] = i1 ^ hh_rot32(k);
  }
}

// The zipper merge is a byte permutation of the 16 bytes of (v1, v0).
// With a0..a7 the bytes of v0 and b0..b7 those of v1 (least significant
// first), add0 gets [a3 b4 a2 a5 | b6 a1 b7 a0] and add1
// [b3 a4 b2 b5 | b1 a6 b0 a7], so each 32-bit half is one or two byte
// permutes (PRMT) where masks and shifts took some 25 instructions.
static __device__ __forceinline__ void hh_zipper_merge_add(
    uint64_t v1, uint64_t v0, uint64_t& add1, uint64_t& add0) {
  const uint32_t a_lo = (uint32_t)v0, a_hi = (uint32_t)(v0 >> 32);
  const uint32_t b_lo = (uint32_t)v1, b_hi = (uint32_t)(v1 >> 32);
  const uint32_t z0lo = __byte_perm(__byte_perm(a_lo, b_hi, 0x0243), a_hi, 0x5210);
  const uint32_t z0hi = __byte_perm(a_lo, b_hi, 0x0716);
  const uint32_t z1lo = __byte_perm(__byte_perm(b_lo, a_hi, 0x0243), b_hi, 0x5210);
  const uint32_t z1hi = __byte_perm(b_lo, a_hi, 0x7061);
  add0 += ((uint64_t)z0hi << 32) | z0lo;
  add1 += ((uint64_t)z1hi << 32) | z1lo;
}

// lo32(x) * hi32(y), the 32x32 -> 64 product of a lane update. Written
// as mul.wide.u32: as a 64-bit C product of masked operands the compiler
// kept the zero cross terms as extra adds.
static __device__ __forceinline__ uint64_t hh_mul32(uint64_t x, uint64_t y) {
  uint64_t p;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"((uint32_t)x), "r"((uint32_t)(y >> 32)));
  return p;
}

// One HighwayHash round on a lane pair: a = the pair's two 8-byte packet
// words (packet words 2q, 2q+1). The whole-state round is this on both
// pairs.
static __device__ __forceinline__ void hh_update(HHPair& s, const uint64_t a[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v1[i] += s.mul0[i] + a[i];
    s.mul0[i] ^= hh_mul32(s.v1[i], s.v0[i]);
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= hh_mul32(s.v0[i], s.v1[i]);
  }
  hh_zipper_merge_add(s.v1[1], s.v1[0], s.v0[1], s.v0[0]);
  hh_zipper_merge_add(s.v0[1], s.v0[0], s.v1[1], s.v1[0]);
}

// The remainder packet: size in (0, 32) bytes at `bytes`. Both threads of
// a message assemble the whole padded packet; each takes its pair's half.
static __device__ __forceinline__ void hh_update_remainder(
    HHPair& s, const uint8_t* __restrict__ bytes, int size, int q) {
  const int whole4 = size & ~3;
  const int size4 = size & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v0[i] += ((uint64_t)size << 32) + (uint64_t)size;
    uint32_t lo = (uint32_t)s.v1[i], hi = (uint32_t)(s.v1[i] >> 32);
    lo = (lo << size) | (lo >> (32 - size));
    hi = (hi << size) | (hi >> (32 - size));
    s.v1[i] = ((uint64_t)hi << 32) | lo;
  }
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < 28; ++k)  // whole4 <= 28
    if (k < whole4) w[k >> 3] |= (uint64_t)bytes[k] << (8 * (k & 7));
  if (size & 16) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[3] |= (uint64_t)bytes[size - 4 + k] << (8 * (4 + k));
  } else if (size4) {
    w[2] |= (uint64_t)bytes[whole4] | ((uint64_t)bytes[whole4 + (size4 >> 1)] << 8) |
            ((uint64_t)bytes[whole4 + size4 - 1] << 16);
  }
  const uint64_t a[2] = {q ? w[2] : w[0], q ? w[3] : w[1]};
  hh_update(s, a);
}

// The 10 permutation rounds and the modular reduction. The permuted
// packet of the whole state is rot32 of v0 lanes (2, 3, 0, 1): pair q's
// half is the partner pair's v0, fetched from the partner lane (lane ^ 1,
// in `mask`). Each thread writes its pair's 16 bytes of the digest.
static __device__ __forceinline__ void hh_finalize(HHPair& s, unsigned mask,
                                                   uint8_t* __restrict__ out, int q) {
  for (int r = 0; r < 10; ++r) {
    const uint64_t o0 = __shfl_xor_sync(mask, (unsigned long long)s.v0[0], 1);
    const uint64_t o1 = __shfl_xor_sync(mask, (unsigned long long)s.v0[1], 1);
    const uint64_t p[2] = {hh_rot32(o0), hh_rot32(o1)};
    hh_update(s, p);
  }
  const uint64_t a0 = s.v0[0] + s.mul0[0];
  const uint64_t a1 = s.v0[1] + s.mul0[1];
  const uint64_t a2 = s.v1[0] + s.mul1[0];
  const uint64_t a3 = (s.v1[1] + s.mul1[1]) & 0x3fffffffffffffffull;
  const uint64_t m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  const uint64_t m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
  // 32-byte aligned digest slot: the pair's half is one 16-byte store
  if (out) *reinterpret_cast<ulonglong2*>(out + 16 * q) = make_ulonglong2(m0, m1);
}
