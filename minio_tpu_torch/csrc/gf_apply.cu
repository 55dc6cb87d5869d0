// K3: a binary bit-plane matrix [8r, 8k] applied to shard bytes,
// [B, k, n] uint8 -> [B, r, n] uint8 (GF(2^8) encode through its
// GF(2)-linear image, exact for any binary matrix).
//
// Replaces the Pallas kernel minio_tpu/ops/rs_pallas.py (_encode_kernel,
// entered by gf_apply_pallas). The TPU kernel extracted the 8k input bit
// planes into int32, multiplied them by the matrix on the MXU and packed
// 512-lane tiles; that tiling answered the MXU and is not carried over.
// The contract kept is the bytes.
//
// An [8r, 8k] binary matrix is r*k 8x8 GF(2)-linear byte maps, and each
// map is exactly a 256-entry lookup table:
//   T[ri][ki][x] = XOR over the set bits i of x of column 8ki+i of block
//   (ri, ki), packed as a byte.
// The wrapper (ops/rs_cuda.py) builds the r*k*256 tables on the host from
// the bit-plane matrix itself and caches them per matrix; this kernel
// stages them in dynamic shared memory (64 KiB for the cauchy composite at
// EC 8+8, 48 KiB at 12+4: above the 48 KiB static limit, so the launch
// raises the block's limit with cudaFuncSetAttribute first).
//
// Rows are addressed through per-row byte offsets (k input rows, then r
// output rows, relative to each batch item's base), so a caller can read
// and write sub-rows in place: the cauchy codec reads the a and b halves
// of [B, d, 2h] data and writes the a and b halves of [B, p, 2h] parity
// with no transpose copy on either side. Any n and any row alignment are
// taken: each thread owns 4 output columns; a 4-byte input word is two
// aligned 32-bit loads funnel-shifted into place (both aligned words hold
// a byte of the row, so no load leaves the row's allocation), the last
// 1-3 columns of a row are loaded and stored byte by byte, and an output
// word is one 32-bit store when aligned and four byte stores otherwise.
// Output rows are accumulated 16 at a time in registers while the input
// rows stream past, so k and r are unbounded (the cauchy composite has
// k = 2d, up to 30 on a 16-drive set).
//
// Bound on the H100: bytes - read B*k*n, write B*r*n; at the 8+8 cauchy
// composite, B = 256, n = 64 KiB that is 512 MiB, 0.16 ms at 3.35 TB/s.
// The kernel is limited by its B*r*k*n shared-memory lookups instead
// (random byte indices conflict in the banks); a bit-sliced or tensor-core
// formulation is later work. Blocks stride over (batch item, column tile)
// work so each block loads its tables once.
#include <cuda_runtime.h>
#include <stdint.h>

#define R_TILE 16
#define THREADS 256

__device__ __forceinline__ uint32_t load4(const uint8_t* p, int64_t rem) {
  if (rem >= 4) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
    const unsigned sh = (unsigned)(a & 3) * 8u;
    const uint32_t lo = __ldg(w);
    if (sh == 0) return lo;
    return __funnelshift_r(lo, __ldg(w + 1), sh);
  }
  uint32_t x = 0;
  for (int j = 0; j < (int)rem; ++j) x |= (uint32_t)__ldg(p + j) << (8 * j);
  return x;
}

__device__ __forceinline__ void store4(uint8_t* p, uint32_t v, int64_t rem) {
  if (rem >= 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
  const int m = rem < 4 ? (int)rem : 4;
  for (int j = 0; j < m; ++j) p[j] = (uint8_t)(v >> (8 * j));
}

__global__ void __launch_bounds__(THREADS)
gf_apply_kernel(const uint8_t* __restrict__ in, int64_t in_bs,
                uint8_t* __restrict__ out, int64_t out_bs, int64_t B, int k,
                int r, int64_t n, const uint8_t* __restrict__ tables,
                const int64_t* __restrict__ offs) {
  extern __shared__ __align__(16) uint8_t smem[];
  int64_t* s_off = reinterpret_cast<int64_t*>(smem);  // [k + r]
  uint8_t* tab = smem + (size_t)(k + r) * 8;            // [r][k][256]
  for (int i = threadIdx.x; i < k + r; i += blockDim.x) s_off[i] = offs[i];
  const int nwords = r * k * 64;
  for (int i = threadIdx.x; i < nwords; i += blockDim.x)
    reinterpret_cast<uint32_t*>(tab)[i] = __ldg(reinterpret_cast<const uint32_t*>(tables) + i);
  __syncthreads();

  const int64_t words = (n + 3) / 4;
  const int64_t tiles_per_row = (words + blockDim.x - 1) / blockDim.x;
  const int64_t ntiles = B * tiles_per_row;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int64_t b = tile / tiles_per_row;
    const int64_t col = ((tile % tiles_per_row) * blockDim.x + threadIdx.x) * 4;
    if (col >= n) continue;
    const int64_t rem = n - col;
    const uint8_t* src = in + b * in_bs + col;
    uint8_t* dst = out + b * out_bs + col;
    for (int r0 = 0; r0 < r; r0 += R_TILE) {
      uint32_t acc[R_TILE];
#pragma unroll
      for (int i = 0; i < R_TILE; ++i) acc[i] = 0u;
      for (int ki = 0; ki < k; ++ki) {
        const uint32_t x = load4(src + s_off[ki], rem);
        const uint8_t* t = tab + ((size_t)r0 * k + ki) * 256;
#pragma unroll
        for (int i = 0; i < R_TILE; ++i) {
          if (r0 + i < r) {
            const uint8_t* ti = t + (size_t)i * k * 256;
            acc[i] ^= (uint32_t)ti[x & 0xff] | ((uint32_t)ti[(x >> 8) & 0xff] << 8) |
                      ((uint32_t)ti[(x >> 16) & 0xff] << 16) |
                      ((uint32_t)ti[x >> 24] << 24);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R_TILE; ++i)
        if (r0 + i < r) store4(dst + s_off[k + r0 + i], acc[i], rem);
    }
  }
}

// in: B batch items, item b at in + b*in_bs, input row j at byte offset
// offs[j] within it (j < k); out likewise with out_bs and offs[k + i]
// (i < r); each row n bytes. tables: [r][k][256] u8 on the device; offs:
// [k + r] int64 on the device. Input and output must not overlap.
// Returns the cudaError_t of the launch (or of its configuration).
extern "C" int gf_apply(const void* in, int64_t in_bs, void* out, int64_t out_bs,
                        int64_t B, int k, int r, int64_t n, const void* tables,
                        const void* offs, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (k < 1 || r < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(k + r) * 8 + (size_t)r * k * 256;
  cudaError_t e = cudaFuncSetAttribute(gf_apply_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf_apply_kernel, THREADS,
                                                         smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t words = (n + 3) / 4;
  const int64_t ntiles = B * ((words + THREADS - 1) / THREADS);
  const int64_t cap = (int64_t)sms * per_sm;
  const unsigned grid = (unsigned)(ntiles < cap ? ntiles : cap);
  gf_apply_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, in_bs, (uint8_t*)out, out_bs, B, k, r, n,
      (const uint8_t*)tables, (const int64_t*)offs);
  return (int)cudaGetLastError();
}
