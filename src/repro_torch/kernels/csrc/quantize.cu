// Symmetric per-block int8 codec of the compressed upload leg, for Hopper
// (sm_90a).  Each entry replaces one Pallas kernel of
// src/repro/kernels/quantize.py:
//
//   qz_quantize   <- quantize_int8 (:32), _quant_kernel (:17)
//   qz_dequantize <- dequantize_int8 (:55), _dequant_kernel (:26)
//
// quantize: x f32 [k] -> q int8 [k], scales f32 [ceil(k/block)].  Per
// block of `block` values (the last one zero-padded, as
// core/compression.py:178-184 pads it):
//   scale = max(max|x| / 127, 1e-12)          (f32)
//   q     = clip(rint(x / scale), -127, 127)  (half to even, as jnp.round)
// dequantize: out[i] = float(q[i]) * scales[i / block].
//
// Exactness: the reference pins q bit for bit, so the quotients are IEEE
// divisions (__fdiv_rn; this file must never be built with
// --use_fast_math), the rounding is rintf (the current rounding mode,
// nearest-even), and the product is one __fmul_rn.  max|x| is exact in
// any order, so the block reduction may use shuffles.  Inputs are
// assumed finite (the payload of a top-k over a finite delta).
//
// Bound on the H100 (3.35 TB/s): both move 5 bytes a value plus 4 a
// block (quantize: 4 in, 1 + 4/block out; dequantize the reverse) for a
// handful of flops, so both are memory-bound.  On the upload leg k is
// 656 or 1,313 (densities 0.05 and 0.1 of the MLP), where a launch costs
// more than the bytes.  The design is the simplest one that streams:
// quantize gives each block of values one thread block of 256 threads
// (the block max is a warp-shuffle reduction, then one pass writes q);
// dequantize is one thread per value, grid-stride.
//
// Every entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ scales, int64_t k,
                                int block) {
  __shared__ float warp_part[kThreads / 32];
  __shared__ float scale_s;
  const int64_t g = blockIdx.x;
  const int64_t lo = g * block;
  // 1. max |x| over the block (the zero padding past k adds nothing)
  float m = 0.0f;
  for (int j = threadIdx.x; j < block; j += blockDim.x) {
    const int64_t i = lo + j;
    if (i < k) m = fmaxf(m, fabsf(x[i]));
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
    }
  }
  __syncthreads();
  // 2. q = clip(rint(x / scale), -127, 127)
  const float s = scale_s;
  for (int j = threadIdx.x; j < block; j += blockDim.x) {
    const int64_t i = lo + j;
    if (i < k) {
      const float r = rintf(__fdiv_rn(x[i], s));
      q[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
    }
  }
}

__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, int64_t k,
                                  int block) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < k; i += stride)
    out[i] = __fmul_rn(static_cast<float>(q[i]), scales[i / block]);
}

}  // namespace

extern "C" {

const char* qz_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x f32 [k] -> q int8 [k], scales f32 [ceil(k / block)]
int qz_quantize(const void* x, void* q, void* scales, int64_t k, int block,
                void* stream) {
  if (k < 1 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ng = (k + block - 1) / block;
  if (ng > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  quantize_kernel<<<static_cast<unsigned>(ng), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), k, block);
  return static_cast<int>(cudaGetLastError());
}

// q int8 [k], scales f32 [ceil(k / block)] -> out f32 [k]
int qz_dequantize(const void* q, const void* scales, void* out, int64_t k,
                  int block, void* stream) {
  if (k < 1 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  dequantize_kernel<<<grid_for(k), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), k, block);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
