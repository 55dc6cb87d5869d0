// K1: GF(2^8) matrix apply + HighwayHash-256 of every input and output
// shard, for RS encode (parity rows) and decode (rebuild rows) alike.
//
// Replaces the Pallas mega-kernel minio_tpu/ops/fused_pallas.py:249
// (_build -> kern, entered by fused_encode_hash_cm :301 and
// fused_decode_hash_cm :315). The TPU kernel read chunk-major input,
// multiplied bit planes on the MXU with a paired [128, 128] weight and
// hashed in VMEM sub-batches; those shapes answered the TPU's memory
// system and are not carried over. The contract kept is the bytes: data
// [B, d, n] in, outputs [B, p, n] and digests [B, d+p, 32] out, with the
// reference's row order.
//
// Two launches on one stream:
//  1. the GF core (gf_core.cuh; C entry fused_gf_apply, also timed alone):
//     the product tables of the [p, d] matrix, input-major and 8 or 4
//     bytes wide (16 KiB at 8+8; ops/gf_cuda.py), staged once per block
//     (one wave of them at n = 128 KiB) by a TMA bulk copy; one 8- or
//     4-byte shared-memory lookup per input byte covers all p output
//     rows, XORed into column
//     accumulators, transposed by byte permutes and stored 8 or 16 bytes
//     at a time (the rows are back to back and 16-byte aligned).
//  2. the hash core (hh_core.cuh) over the B*(d+p) shards: shard s of
//     block b = s / (d+p) is input row j = s mod (d+p) when j < d, else
//     output row j - d.
//
// Bound on the H100: bytes - read B*d*n, write B*p*n + 32*B*(d+p),
// about 0.16 ms at B = 256, 8+8, n = 128 KiB; the hash re-reads all
// d+p rows, mostly from L2 right after the GF pass wrote the outputs.
// The GF launch alone is bound by the same bytes less the digests; the
// core's wavefront model (gf_core.cuh) puts its 8-byte lookups at ~6
// wavefronts a warp load, ~0.2 ms at B = 256. The chain bounds the hash
// from below: n/32 = 4,096 serial rounds per shard, whatever B. The hash
// core runs each shard on two threads (one per lane pair) with its
// packets fed from a TMA-filled shared-memory ring, so a round costs its
// arithmetic, not a device-memory wait. Fusing the GF pass into the
// hash's producer is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gf_core.cuh"
#include "hh_core.cuh"

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

// data: [B, d, n] u8; tables: [d][256][E] u8 (byte i of entry (j, x) =
// gf_mul(m[i][j], x), zero for i >= p: ops/gf_cuda.wide_tables); out:
// [B, p, n] u8. threads, grid, row_groups: the GF core's launch plan
// (ops/gf_cuda.plan). The GF launch alone.
extern "C" int fused_gf_apply(const void* data, int64_t B, int d, int p, int64_t n,
                              const void* tables, void* out, int64_t threads, int64_t grid,
                              int64_t row_groups, void* stream) {
  const GfJob job = {(const uint8_t*)data, d * n, (uint8_t*)out, p * n, B, n, d, p,
                     (const uint8_t*)tables, nullptr, 0};
  return gf_core_launch(job, threads, grid, row_groups, (cudaStream_t)stream);
}

// As fused_gf_apply (its plan: gf_threads, gf_grid, gf_row_groups), then digests:
// [B, d+p, 32] u8 of every shard. aligned: non-zero when every shard's
// start is 16-byte aligned (ops/bitrot_cuda.aligned). msgs_per_cta ..
// smem_bytes: the hash core's launch plan for B*(d+p) messages of n bytes
// (ops/bitrot_cuda.plan). Returns the first non-zero cudaError_t of the
// two launches.
extern "C" int fused_encode_hash(const void* data, int64_t B, int d, int p, int64_t n,
                                 const void* tables, uint64_t k0, uint64_t k1, uint64_t k2,
                                 uint64_t k3, void* out, void* digests, int64_t gf_threads,
                                 int64_t gf_grid, int64_t gf_row_groups, int64_t aligned,
                                 int64_t msgs_per_cta,
                                 int64_t stages, int64_t stage_bytes, int64_t slot_bytes,
                                 int64_t smem_bytes, void* stream) {
  if (B <= 0) return 0;
  const int e = fused_gf_apply(data, B, d, p, n, tables, out, gf_threads, gf_grid,
                               gf_row_groups, stream);
  if (e != 0) return e;
  const FusedRows rows = {(const uint8_t*)data, (const uint8_t*)out, d, p, n};
  return hh_ring_launch(rows, B * (d + p), n, k0, k1, k2, k3, (uint8_t*)digests, aligned,
                        msgs_per_cta, stages, stage_bytes, slot_bytes, smem_bytes,
                        (cudaStream_t)stream);
}
