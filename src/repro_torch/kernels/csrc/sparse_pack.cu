// Sparse wire-frame body packing of the compressed upload leg, for Hopper
// (sm_90a).  Replaces one Pallas kernel of src/repro/kernels/sparse_pack.py:
//
//   sp_pack_body <- pack_body (:60), _pack_only_kernel (:51)
//
// An existing payload (q int8 [k], scales f32 [ng], idx int32 [k]) becomes
// the frame body transfer/wire.py pins, little-endian:
//
//   body = q bytes [k] || scales bytes [4*ng] || idx bytes [4*k]
//
// Pure byte copies, no arithmetic: the body must carry the payload's own
// bytes (re-quantizing drifts a ULP, sparse_pack.py:62-66).  The scales
// section starts at byte k, which is unaligned for most k (k = 656 or
// 1,313 on the MLP's upload leg), so the kernel writes bytes, never
// words: thread t of the grid-stride loop owns output byte t and reads
// it from whichever section it falls in.
//
// Bound on the H100 (3.35 TB/s): 2*(5k + 4ng) bytes moved, no flops.  At
// the MLP's k the launch costs more than the bytes; the byte-per-thread
// design is the simple one, and a word-wide variant that shifts across
// the unaligned seam is work for a later change.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

__global__ void pack_kernel(const uint8_t* __restrict__ q,
                            const uint8_t* __restrict__ scales,
                            const uint8_t* __restrict__ idx,
                            uint8_t* __restrict__ body, int64_t k,
                            int64_t scale_bytes) {
  const int64_t total = k + scale_bytes + 4 * k;
  const int64_t idx_at = k + scale_bytes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    uint8_t b;
    if (i < k)
      b = q[i];
    else if (i < idx_at)
      b = scales[i - k];
    else
      b = idx[i - idx_at];
    body[i] = b;
  }
}

}  // namespace

extern "C" {

const char* sp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q int8 [k], scales f32 [ng], idx int32 [k] -> body uint8 [5k + 4ng]
int sp_pack_body(const void* q, const void* scales, const void* idx,
                 void* body, int64_t k, int64_t ng, void* stream) {
  if (k < 1 || ng < 1) return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<<<grid_for(5 * k + 4 * ng), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(scales),
      static_cast<const uint8_t*>(idx), static_cast<uint8_t*>(body), k,
      4 * ng);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
