// K2: HighwayHash-256 of `rows` equal-length messages, contiguous.
//
// Replaces the Pallas chain kernel minio_tpu/ops/bitrot_pallas.py
// (_chain_kernel, entered by hash256_blocks_pallas). The TPU kernel ran
// only the whole-packet chain, with the state in VMEM across a
// sequential grid, and left the tail packet and finalization to XLA.
// Here the hash core (hh_core.cuh) runs the whole hash of each message:
// whole packets, remainder, 10 finalization rounds and the modular
// reduction, for any n >= 0, any row count and any row start.
//
// Bound on the H100: bytes, rows x n read once plus 32 x rows written
// (0.16 ms at 8,192 rows of 65,536 bytes), and the chain: n/32 serial
// packet rounds per message. The core's design answers both (see
// hh_core.cuh): two threads per message halve each round's dependent
// work, and packets arrive through a TMA-filled shared-memory ring
// several stages ahead, so rounds no longer wait on device memory. Rows
// that all start 16-byte aligned take the core's 16-byte read path;
// others (as 12+4 shards of 87,382 bytes) its generic reads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hh_core.cuh"

struct ContigRows {
  const uint8_t* base;
  int64_t n;
  __device__ __forceinline__ const uint8_t* operator()(int64_t i) const { return base + i * n; }
};

// msgs: rows x n bytes, contiguous (any start address); out: rows x 32.
// aligned: non-zero when every row start is 16-byte aligned
// (ops/bitrot_cuda.aligned). msgs_per_cta .. smem_bytes: the launch plan
// (ops/bitrot_cuda.plan).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int hh_chain(const void* msgs, int64_t rows, int64_t n, uint64_t k0, uint64_t k1,
                        uint64_t k2, uint64_t k3, void* out, int64_t aligned,
                        int64_t msgs_per_cta, int64_t stages, int64_t stage_bytes,
                        int64_t slot_bytes, int64_t smem_bytes, void* stream) {
  const ContigRows r = {(const uint8_t*)msgs, n};
  return hh_ring_launch(r, rows, n, k0, k1, k2, k3, (uint8_t*)out, aligned, msgs_per_cta,
                        stages, stage_bytes, slot_bytes, smem_bytes, (cudaStream_t)stream);
}
