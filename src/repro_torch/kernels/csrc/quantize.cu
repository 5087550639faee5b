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
// more than the bytes.
//
// quantize: a warp a group, kQuantWarps warps (groups) a 256-thread
// block, a grid that covers the groups with no grid-stride loop.  At the
// wire's block of 256 (a template instance; one generic instance takes
// every other size) a lane holds 8 values, two 16-byte loads (value by
// value where x is not 16-byte aligned, a view, or across k, where the
// zero padding starts), the group's max|x| is 5 xor shuffles, and the
// lane's 8 q bytes go out as one 8-byte store at 256 g + 8 lane; lane 0
// writes the scale.  q is exactly [k] (the wrapper's fresh allocation,
// so every 8-byte store is aligned): the lane across k stores only its
// bytes below k.  The per-group walk is quant_group.cuh's, shared with
// B11 (sparse_pack.cu).  Loads and stores take default caching: the
// upload leg dequantizes q at once (B10) and reads x again for the error
// feedback, and at k = 6.7M both fit the 50 MB L2.  (The old design, a
// 256-thread block a group that read x twice across two barriers and
// stored q a byte a thread, held an H100 at 26% of its bound at k =
// 6,710,886; PERF.md.)
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
#include "quant_group.cuh"

namespace {

// quantize: groups (one warp each) a block
constexpr int kQuantWarps = 8;
constexpr int kQuantThreads = 32 * kQuantWarps;

// BLOCK: the group size as a template parameter (256, the wire's), or 0
// for the generic instance, which reads it from `block`.  Warp w of the
// grid quantizes group w; x16: x is 16-byte aligned.
template <int BLOCK>
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, int64_t k, int block, int64_t ng,
                int x16) {
  static_assert(BLOCK == 0 || BLOCK == 256, "the wire's block, or generic");
  const int lane = threadIdx.x & 31;
  const int64_t g =
      static_cast<int64_t>(blockIdx.x) * kQuantWarps + (threadIdx.x >> 5);
  if (g >= ng) return;                        // the whole warp
  if constexpr (BLOCK == 256) {
    const int64_t i0 = g * BLOCK + 8 * lane;
    float v[8];
    load_lane8<false>(x, i0, k, x16, v);
    const float s = lane8_scale(v);
    const uint2 w = lane8_bytes(v, s);
    if (i0 + 8 <= k) {
      *reinterpret_cast<uint2*>(q + i0) = w;
    } else {                                  // the lane across k
      for (int j = 0; i0 + j < k; ++j)
        q[i0 + j] = static_cast<int8_t>(lane8_byte(w, j));
    }
    if (lane == 0) scales[g] = s;
  } else {
    const int64_t lo = g * block;
    const float s = generic_scale(x, lo, block, k, lane);
    for (int j = lane; j < block && lo + j < k; j += 32)
      q[lo + j] = static_cast<int8_t>(quant_byte(x[lo + j], s));
    if (lane == 0) scales[g] = s;
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

// x f32 [k] (4-byte aligned) -> q int8 [k] (8-byte aligned), scales f32
// [ceil(k / block)]
int qz_quantize(const void* x, void* q, void* scales, int64_t k, int block,
                void* stream) {
  if (k < 1 || block < 1 || reinterpret_cast<uintptr_t>(q) % 8 ||
      reinterpret_cast<uintptr_t>(x) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ng = (k + block - 1) / block;
  const int64_t blocks = (ng + kQuantWarps - 1) / kQuantWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int x16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  if (block == 256)
    quantize_kernel<256><<<static_cast<unsigned>(blocks), kQuantThreads, 0,
                           s>>>(xp, qp, sp, k, block, ng, x16);
  else
    quantize_kernel<0><<<static_cast<unsigned>(blocks), kQuantThreads, 0,
                         s>>>(xp, qp, sp, k, block, ng, x16);
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
