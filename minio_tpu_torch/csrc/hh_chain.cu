// K2: HighwayHash-256 of `rows` equal-length messages at a fixed pitch.
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
// others (as 12+4 shards of 87,382 bytes back to back) its generic reads.
// The encode route keeps a batch's shards at a 32-byte pitch
// (ops/bitrot_torch.shard_slab), so its rows take the 16-byte path.
//
// Beside it, copy_rows: the route's copies between the host and its shard
// slab, one pitched copy each way, so that no kernel re-lays rows out.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hh_core.cuh"

// row i at base + i * pitch (pitch = n for rows back to back)
struct ContigRows {
  const uint8_t* base;
  int64_t pitch;
  __device__ __forceinline__ const uint8_t* operator()(int64_t i) const {
    return base + i * pitch;
  }
};

// msgs: rows messages of n bytes, row i at msgs + i * pitch (any start
// address, pitch >= n); out: rows x 32. aligned: non-zero when every row
// start is 16-byte aligned (ops/bitrot_cuda.aligned). msgs_per_cta ..
// smem_bytes: the launch plan (ops/bitrot_cuda.plan).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int hh_chain(const void* msgs, int64_t rows, int64_t n, int64_t pitch, uint64_t k0,
                        uint64_t k1, uint64_t k2, uint64_t k3, void* out, int64_t aligned,
                        int64_t msgs_per_cta, int64_t stages, int64_t stage_bytes,
                        int64_t slot_bytes, int64_t smem_bytes, void* stream) {
  if (pitch < n) return (int)cudaErrorInvalidValue;
  const ContigRows r = {(const uint8_t*)msgs, pitch};
  return hh_ring_launch(r, rows, n, k0, k1, k2, k3, (uint8_t*)out, aligned, msgs_per_cta,
                        stages, stage_bytes, slot_bytes, smem_bytes, (cudaStream_t)stream);
}

// items x rows rows of width bytes between host and device memory, one
// pitched copy on `stream` (cudaMemcpy3DAsync), then the stream's sync:
// row j of item b at src + (b * src_rows + j) * src_pitch goes to
// dst + (b * dst_rows + j) * dst_pitch. to_device: host -> device, else
// device -> host. Each side's pitch >= width and its item stride is a
// whole number of its pitches (src_rows, dst_rows >= rows): a [B, r, n]
// host array (pitch n, r rows an item) and the slab's rows (pitch P,
// d + p rows an item). Host memory may be pageable; the copy has finished
// when this returns. Returns the cudaError_t (0 on success).
extern "C" int copy_rows(void* dst, int64_t dst_pitch, int64_t dst_rows, const void* src,
                         int64_t src_pitch, int64_t src_rows, int64_t width, int64_t rows,
                         int64_t items, int64_t to_device, void* stream) {
  if (width <= 0 || rows <= 0 || items <= 0) return 0;
  if (dst_pitch < width || src_pitch < width || dst_rows < rows || src_rows < rows)
    return (int)cudaErrorInvalidValue;
  cudaMemcpy3DParms p = {};
  p.srcPtr = make_cudaPitchedPtr(const_cast<void*>(src), (size_t)src_pitch, (size_t)width,
                                 (size_t)src_rows);
  p.dstPtr = make_cudaPitchedPtr(dst, (size_t)dst_pitch, (size_t)width, (size_t)dst_rows);
  p.extent = make_cudaExtent((size_t)width, (size_t)rows, (size_t)items);
  p.kind = to_device ? cudaMemcpyHostToDevice : cudaMemcpyDeviceToHost;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpy3DAsync(&p, s);
  if (e == cudaSuccess) e = cudaStreamSynchronize(s);
  return (int)e;
}
