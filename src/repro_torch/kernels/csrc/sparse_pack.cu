// Sparse wire-frame body packing of the compressed upload leg, for Hopper
// (sm_90a).  Replaces two Pallas kernels of src/repro/kernels/sparse_pack.py:
//
//   sp_pack_body     <- pack_body (:60), _pack_only_kernel (:51)      (B12)
//   sp_quantize_pack <- quantize_pack (:84), _pack_kernel (:35)       (B11)
//
// The frame body transfer/wire.py pins, little-endian:
//
//   body = q bytes [k] || scales bytes [4*ng] || idx bytes [4*k]
//
// B12 packs an existing payload (q int8 [k], scales f32 [ng], idx int32
// [k]) with pure byte copies, no arithmetic: the body must carry the
// payload's own bytes (re-quantizing drifts a ULP, sparse_pack.py:62-66).
// The scales section starts at byte k and the index section at k + 4 ng,
// both unaligned for most k (k = 656 or 1,313 on the MLP's upload leg,
// 105,075 on the bench bus), so both kernels write bytes, never words:
// B12's thread t of the grid-stride loop owns output byte t and reads it
// from whichever section it falls in.
//
// B11 quantizes the selected values sel f32 [k] and packs them in the
// same launch: B9's quantizer (quantize.cu) followed by B12's layout.
// One 256-thread block per group of `block` values; the group's max|x|
// by warp shuffles and shared memory (lanes past k read as 0, the
// reference's zero padding; max is exact in any order), then
//   s = max(max|x| / 127, 1e-12)  (IEEE division: __fdiv_rn)
//   q = clip(rint(x / s), -127, 127)
// written to q int8 [ng * block] (zero-padded past k), to scales f32
// [ng], and as bytes to the body: q's byte, the scale's four bytes (the
// block's thread 0) and each index's four bytes.  This file must never be
// built with --use_fast_math.
//
// Bound on the H100 (3.35 TB/s): B12 moves 2*(5k + 4ng) bytes, no flops;
// B11 reads 8k (sel, idx) and writes the body (5k + 4ng), q (ng * block)
// and the scales (4ng), for a divide, a round and a compare a value.  At
// the MLP's k a launch costs more than the bytes; the byte-per-thread
// design is the simple one, and a word-wide variant that shifts across
// the unaligned seams is work for a later change.
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ void put_u32(uint8_t* __restrict__ at,
                                        uint32_t v) {
#pragma unroll
  for (int b = 0; b < 4; ++b) at[b] = static_cast<uint8_t>(v >> (8 * b));
}

__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ sel,
                     const int32_t* __restrict__ idx,
                     uint8_t* __restrict__ body, int8_t* __restrict__ q,
                     float* __restrict__ scales, int64_t k, int block,
                     int64_t ng) {
  __shared__ float warp_part[kThreads / 32];
  __shared__ float scale_s;
  const int64_t g = blockIdx.x;
  const int64_t lo = g * block;
  // 1. the group's max|x| (lanes past k are the zero padding)
  float m = 0.0f;
  for (int j = threadIdx.x; j < block; j += blockDim.x) {
    const int64_t i = lo + j;
    if (i < k) m = fmaxf(m, fabsf(sel[i]));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < (blockDim.x >> 5) ? warp_part[threadIdx.x] : 0.0f;
    w = warp_max(w);
    if (threadIdx.x == 0) {
      const float s = fmaxf(__fdiv_rn(w, 127.0f), 1e-12f);
      scale_s = s;
      scales[g] = s;
      put_u32(body + k + 4 * g, __float_as_uint(s));
    }
  }
  __syncthreads();
  // 2. q, and the body's value and index bytes
  const float s = scale_s;
  uint8_t* idx_bytes = body + k + 4 * ng;
  for (int j = threadIdx.x; j < block; j += blockDim.x) {
    const int64_t i = lo + j;
    const float x = i < k ? sel[i] : 0.0f;
    const float r = rintf(__fdiv_rn(x, s));
    const int8_t qv = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
    q[i] = qv;
    if (i < k) {
      body[i] = static_cast<uint8_t>(qv);
      put_u32(idx_bytes + 4 * i, static_cast<uint32_t>(idx[i]));
    }
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

// sel f32 [k], idx int32 [k] -> body uint8 [5k + 4ng], q int8 [ng * block],
// scales f32 [ng], ng = ceil(k / block)
int sp_quantize_pack(const void* sel, const void* idx, void* body, void* q,
                     void* scales, int64_t k, int block, void* stream) {
  if (k < 1 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ng = (k + block - 1) / block;
  if (ng > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  quantize_pack_kernel<<<static_cast<unsigned>(ng), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sel), static_cast<const int32_t*>(idx),
      static_cast<uint8_t*>(body), static_cast<int8_t*>(q),
      static_cast<float*>(scales), k, block, ng);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
