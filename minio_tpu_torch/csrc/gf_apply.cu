// K3: a binary bit-plane matrix [8r, 8k] applied to shard bytes,
// [B, k, n] uint8 -> [B, r, n] uint8 (GF(2^8) encode through its
// GF(2)-linear image, exact for any binary matrix).
//
// Replaces the Pallas kernel minio_tpu/ops/rs_pallas.py:75 gf_apply_pallas
// -> _encode_kernel (pallas_call :59). The TPU kernel extracted the 8k
// input bit planes into int32, multiplied them by the matrix on the MXU
// and packed 512-lane tiles; that tiling answered the MXU and is not
// carried over. The contract kept is the bytes.
//
// The matrix is r*k 8x8 GF(2)-linear byte maps, each exactly a 256-entry
// byte table; the wrapper (ops/rs_cuda.py) builds them on the host from
// the bit planes, lays them out input-major and wide (ops/gf_cuda.py) and
// caches them per matrix. The apply is the GF core, gf_core.cuh: one
// 16-, 8- or 4-byte shared-memory lookup per input byte covers a whole
// output row group, tables staged once per block by a TMA bulk
// copy (64 KiB for the cauchy composite at EC 8+8, 48 KiB at 12+4).
//
// Bound on the H100: bytes - read B*k*n, write B*r*n; at the 8+8 cauchy
// composite, B = 256, n = 64 KiB that is 512 MiB, 0.16 ms at 3.35 TB/s.
// The core's shared-memory wavefront model (gf_core.cuh) puts it near
// 2-2.5x that bound; per-byte lookups for each output row would sit near
// 10x.
//
// Rows are addressed through per-row byte offsets (k input rows, then r
// output rows, relative to each batch item's base), so a caller can read
// and write sub-rows in place: the cauchy codec reads the a and b halves
// of [B, d, 2h] data and writes the a and b halves of [B, p, 2h] parity
// with no transpose copy on either side, at any row alignment (odd
// addresses at EC 12+4, where h = 43,691).
#include <cuda_runtime.h>
#include <stdint.h>

#include "gf_core.cuh"

// in: B batch items, item b at in + b*in_bs, input row j at byte offset
// offs[j] within it (j < k); out likewise with out_bs and offs[k + i]
// (i < r); each row n bytes. tables: [k][256][E*G] u8 on the device
// (ops/gf_cuda.wide_tables); offs: [k + r] int64 on the device. threads,
// grid, row_groups: the launch plan (ops/gf_cuda.plan). Input and output
// must not overlap. Returns the cudaError_t of the launch (or of its
// checks).
extern "C" int gf_apply(const void* in, int64_t in_bs, void* out, int64_t out_bs, int64_t B,
                        int k, int r, int64_t n, const void* tables, const void* offs,
                        int64_t threads, int64_t grid, int64_t row_groups, void* stream) {
  const GfJob job = {(const uint8_t*)in, in_bs, (uint8_t*)out, out_bs, B, n, k, r,
                     (const uint8_t*)tables, (const int64_t*)offs, 0};
  return gf_core_launch(job, threads, grid, row_groups, (cudaStream_t)stream);
}
