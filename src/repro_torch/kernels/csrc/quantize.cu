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
// more than the bytes.  quantize gives each block of values one thread
// block of 256 threads (the block max is a warp-shuffle reduction, then
// one pass writes q).
//
// dequantize streams.  A thread takes kDeqWords 4-byte words of q (16
// values), each with the evict-first hint, a block's width apart, and
// writes one float4 for each: every load of a warp is one coalesced
// 128-byte access and every store one 512-byte access.  (A 16-byte pack
// of q a thread, stored as four float4, puts a warp's stores 64 bytes
// apart: on the H100 at k = 6.7M that took 0.025 ms, 40% of the bound,
// where the grid-stride loop of one byte a thread took 0.018-0.020.)
// The grid covers the payload, kDeqWords * kStreamThreads words a block
// (grid.cuh stream_grid), with no grid-stride loop.  The wire ships
// block = 256 only (QBLOCK): that size is a template parameter, so a word
// aligned to its own index lies in one group (one scale load, i >> 8).
// Every other block size takes one generic instance that walks the group
// boundaries with a runtime block and no division a value.  q may start
// at any byte (a view of a larger buffer): the words are taken at q's
// 4-byte address boundaries, the values before the first (the head) and
// after the last whole word (the tail) go one a thread to the first
// threads of block 0, and a word of an unaligned q may straddle two
// groups, so it loads both scales; its outputs then start off a 16-byte
// boundary, so it stores value by value.
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

__host__ __device__ constexpr int log2_of(int v) {
  return v <= 1 ? 0 : 1 + log2_of(v / 2);
}

// one value of q, scaled: one IEEE product
__device__ __forceinline__ float dequant1(int8_t q, float s) {
  return __fmul_rn(static_cast<float>(q), s);
}

// dequantize: one 4-byte word of q (4 values) to one float4, each thread
// kDeqWords words a block's width apart, so every load and store of a
// warp is one coalesced access (128 bytes of q, 512 of out)
constexpr int kDeqWords = 4;

// BLOCK: the group size as a template parameter (256, the wire's), or 0
// for the generic instance, which reads it from `block`.  head: the
// values before q's first 4-byte boundary (at most 3); nword: the whole
// words after them; the rest of k (at most 3) is the tail.
template <int BLOCK>
__global__ void __launch_bounds__(kStreamThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  int64_t k, int block, int head, int64_t nword) {
  static_assert(BLOCK == 0 || (BLOCK % 4 == 0 && (BLOCK & (BLOCK - 1)) == 0),
                "a fixed block is a power of two of whole words");
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + head);
  const int64_t w0 =
      static_cast<int64_t>(blockIdx.x) * kDeqWords * kStreamThreads +
      threadIdx.x;
  uint32_t word[kDeqWords];
#pragma unroll
  for (int u = 0; u < kDeqWords; ++u) {
    const int64_t w = w0 + u * kStreamThreads;
    if (w < nword) word[u] = __ldcs(qw + w);
  }
#pragma unroll
  for (int u = 0; u < kDeqWords; ++u) {
    const int64_t w = w0 + u * kStreamThreads;
    if (w >= nword) continue;
    const int64_t i0 = head + 4 * w;
    float sv[4];
    if constexpr (BLOCK != 0) {
      constexpr int kShift = log2_of(BLOCK);
      const int64_t g0 = i0 >> kShift, g1 = (i0 + 3) >> kShift;
      const float s0 = __ldg(scales + g0);
      const float s1 = g1 != g0 ? __ldg(scales + g1) : s0;
      const int nb = static_cast<int>((g0 + 1) * BLOCK - i0);  // in group g0
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sv[e] = dequant1(static_cast<int8_t>(word[u] >> (8 * e)),
                         e < nb ? s0 : s1);
    } else {
      int64_t g = i0 / block;
      int rem = static_cast<int>(i0 - g * block);
      float s = __ldg(scales + g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (rem == block) {
          rem = 0;
          s = __ldg(scales + ++g);
        }
        sv[e] = dequant1(static_cast<int8_t>(word[u] >> (8 * e)), s);
        ++rem;
      }
    }
    float* o = out + i0;
    if (head == 0) {
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(sv[0], sv[1], sv[2], sv[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) __stcs(o + e, sv[e]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    // threads 0-3: the head's values; 4-7: the tail's
    const int64_t tail0 = head + 4 * nword;
    const int64_t i = threadIdx.x < 4 ? threadIdx.x
                                      : tail0 + (threadIdx.x - 4);
    const bool mine = threadIdx.x < 4 ? i < head : i < k;
    if (mine) {
      const int b = BLOCK != 0 ? BLOCK : block;
      out[i] = dequant1(q[i], scales[i / b]);
    }
  }
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

// q int8 [k] at any byte address, scales f32 [ceil(k / block)] -> out
// f32 [k], 16-byte aligned
int qz_dequantize(const void* q, const void* scales, void* out, int64_t k,
                  int block, void* stream) {
  if (k < 1 || block < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int64_t to_edge =
      (4 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(qp) & 3)) & 3;
  const int head = static_cast<int>(to_edge < k ? to_edge : k);
  const int64_t nword = (k - head) / 4;
  const unsigned grid = stream_grid(nword, kDeqWords);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  if (block == 256)
    dequantize_kernel<256><<<grid, kStreamThreads, 0, s>>>(
        qp, sp, op, k, block, head, nword);
  else
    dequantize_kernel<0><<<grid, kStreamThreads, 0, s>>>(
        qp, sp, op, k, block, head, nword);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
