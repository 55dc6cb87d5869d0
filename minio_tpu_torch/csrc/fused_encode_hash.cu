// K1: GF(2^8) matrix apply + HighwayHash-256 of every input and output
// shard, for RS encode (parity rows) and decode (rebuild rows) alike.
//
// Replaces the Pallas mega-kernel minio_tpu/ops/fused_pallas.py (_build
// -> kern, entered by fused_encode_hash_cm and fused_decode_hash_cm).
// The TPU kernel read chunk-major input, multiplied bit planes on the
// MXU with a paired [128, 128] weight and hashed in VMEM sub-batches;
// those shapes answered the TPU's memory system and are not carried
// over. The contract kept is the bytes: data [B, d, n] in, outputs
// [B, p, n] and digests [B, d+p, 32] out, with the reference's row order.
//
// Two launches on one stream:
//  1. gf_apply (C entry fused_gf_apply, also timed alone): each thread
//     takes 16 bytes of one column range of one stripe block, loads them
//     from all d input rows (16-byte loads, neighbouring threads on
//     neighbouring addresses) and XORs the p output rows out of the
//     p x d x 256 product tables, which the wrapper builds on the host
//     per matrix and this kernel stages in shared memory (16 KiB at 8+8).
//  2. the hash core (hh_core.cuh) over the B*(d+p) shards: shard s of
//     block b = s / (d+p) is input row j = s mod (d+p) when j < d, else
//     output row j - d.
//
// Bound on the H100: bytes — read B*d*n, write B*p*n + 32*B*(d+p),
// about 0.16 ms at B = 256, 8+8, n = 128 KiB; the hash re-reads all
// d+p rows, mostly from L2 right after the GF pass wrote the outputs.
// The chain bounds the hash from below: n/32 = 4,096 serial rounds per
// shard, whatever B. The core runs each shard on two threads (one per
// lane pair) with its packets fed from a TMA-filled shared-memory ring,
// so a round costs its arithmetic, not a device-memory wait. Fusing the
// GF pass into the hash's producer is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hh_core.cuh"

#define MAX_SHARDS 8

__global__ void gf_apply_kernel(const uint8_t* __restrict__ in, int d, int p,
                                int64_t n, const uint8_t* __restrict__ tables,
                                uint8_t* __restrict__ out) {
  extern __shared__ uint8_t tab[];  // [p][d][256]
  const int ntab = p * d * 256;
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int64_t b = blockIdx.y;
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 16;
  if (col >= n) return;
  const uint8_t* src = in + b * d * n + col;
  uint4 x[MAX_SHARDS];
#pragma unroll
  for (int di = 0; di < MAX_SHARDS; ++di)
    if (di < d) x[di] = __ldg(reinterpret_cast<const uint4*>(src + di * n));
  uint8_t* dst = out + b * p * n + col;
#pragma unroll
  for (int pi = 0; pi < MAX_SHARDS; ++pi) {
    if (pi >= p) break;
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int di = 0; di < MAX_SHARDS; ++di) {
      if (di >= d) break;
      const uint8_t* t = tab + (pi * d + di) * 256;
      const uint32_t w[4] = {x[di].x, x[di].y, x[di].z, x[di].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q] ^= (uint32_t)t[w[q] & 0xff] |
                  ((uint32_t)t[(w[q] >> 8) & 0xff] << 8) |
                  ((uint32_t)t[(w[q] >> 16) & 0xff] << 16) |
                  ((uint32_t)t[w[q] >> 24] << 24);
      }
    }
    *reinterpret_cast<uint4*>(dst + pi * n) = make_uint4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// shard s -> its first byte: input row j < d, else output row j - d
struct FusedRows {
  const uint8_t* in;
  const uint8_t* out;
  int d, p;
  int64_t n;
  __device__ __forceinline__ const uint8_t* operator()(int64_t s) const {
    const int t = d + p;
    const int64_t b = s / t;
    const int j = (int)(s - b * t);
    return j < d ? in + (b * d + j) * n : out + (b * p + (j - d)) * n;
  }
};

// data: [B, d, n] u8; tables: [p, d, 256] u8 (tables[i][j][x] =
// gf_mul(m[i][j], x)); out: [B, p, n] u8. Needs 1 <= d, p <= 8 and
// n % 16 == 0 (the wrapper's gate is stricter). The GF launch alone.
extern "C" int fused_gf_apply(const void* data, int64_t B, int d, int p, int64_t n,
                              const void* tables, void* out, void* stream) {
  if (d < 1 || d > MAX_SHARDS || p < 1 || p > MAX_SHARDS || n < 0 || n % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || n == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((n / 16 + threads - 1) / threads), (unsigned)B);
  gf_apply_kernel<<<grid, threads, p * d * 256, (cudaStream_t)stream>>>(
      (const uint8_t*)data, d, p, n, (const uint8_t*)tables, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// As fused_gf_apply, then digests: [B, d+p, 32] u8 of every shard.
// msgs_per_cta .. smem_bytes: the hash core's launch plan for B*(d+p)
// messages of n bytes (ops/bitrot_cuda.plan). Returns the first non-zero
// cudaError_t of the two launches.
extern "C" int fused_encode_hash(const void* data, int64_t B, int d, int p, int64_t n,
                                 const void* tables, uint64_t k0, uint64_t k1, uint64_t k2,
                                 uint64_t k3, void* out, void* digests, int64_t msgs_per_cta,
                                 int64_t stages, int64_t stage_bytes, int64_t slot_bytes,
                                 int64_t smem_bytes, void* stream) {
  if (B <= 0) return 0;
  const int e = fused_gf_apply(data, B, d, p, n, tables, out, stream);
  if (e != 0) return e;
  const FusedRows rows = {(const uint8_t*)data, (const uint8_t*)out, d, p, n};
  return hh_ring_launch(rows, B * (d + p), n, k0, k1, k2, k3, (uint8_t*)digests, msgs_per_cta,
                        stages, stage_bytes, slot_bytes, smem_bytes, (cudaStream_t)stream);
}
