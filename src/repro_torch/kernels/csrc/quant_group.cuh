// The per-group int8 quantize shared by B9 (quantize.cu, quantize_kernel)
// and B11 (sparse_pack.cu, quantize_pack_kernel): one warp quantizes one
// group of `block` values,
//   s = max(max|x| / 127, 1e-12)          (IEEE division: __fdiv_rn)
//   q = clip(rint(x / s), -127, 127)      (half to even)
// with the reference's zero padding past k.  The files that include this
// must never be built with --use_fast_math.
//
// At the wire's block of 256, a lane holds 8 values, x[i0, i0 + 8) for
// i0 = 256 g + 8 lane: two 16-byte loads where x is 16-byte aligned and
// the 8 lie below k, else value by value, zero at and past k.  The
// group's max|x| is exact in any order, so it takes 5 xor shuffles and no
// barrier, and the lane's 8 q bytes come back little-endian in one uint2,
// ready for one 8-byte store at q + i0.  Every other block size walks the
// group a value a lane (generic_scale, then quant_byte a value).
//
// kStream picks the loads: the evict-first hint (__ldcs) for a caller
// whose x is not read again, or default caching.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the group's scale from each lane's partial max|x| (every lane takes part)
__device__ __forceinline__ float group_scale(float lane_max) {
  return fmaxf(__fdiv_rn(warp_max(lane_max), 127.0f), 1e-12f);
}

// q = clip(rint(x / s), -127, 127) as a byte
__device__ __forceinline__ uint32_t quant_byte(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  return static_cast<uint8_t>(
      static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

// a lane's 8 values x[i0, i0 + 8), 0.0 at and past k; x16: x is 16-byte
// aligned (i0 is a multiple of 8, so x + i0 is too)
template <bool kStream>
__device__ __forceinline__ void load_lane8(const float* __restrict__ x,
                                           int64_t i0, int64_t k, bool x16,
                                           float v[8]) {
  if (x16 && i0 + 8 <= k) {
    const float4* p = reinterpret_cast<const float4*>(x + i0);
    const float4 a = kStream ? __ldcs(p) : p[0];
    const float4 b = kStream ? __ldcs(p + 1) : p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = i0 + j < k ? (kStream ? __ldcs(x + i0 + j) : x[i0 + j]) : 0.0f;
  }
}

// the group's scale from every lane's 8 values (a warp's 256)
__device__ __forceinline__ float lane8_scale(const float v[8]) {
  float m = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  return group_scale(m);
}

// a lane's 8 q bytes, value j in byte j (little-endian across .x, .y)
__device__ __forceinline__ uint2 lane8_bytes(const float v[8], float s) {
  uint2 w = make_uint2(0u, 0u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w.x |= quant_byte(v[j], s) << (8 * j);
    w.y |= quant_byte(v[j + 4], s) << (8 * j);
  }
  return w;
}

// byte j (0-7) of a lane's 8 q bytes
__device__ __forceinline__ uint8_t lane8_byte(uint2 w, int j) {
  return static_cast<uint8_t>((j < 4 ? w.x : w.y) >> (8 * (j & 3)));
}

// the scale of the group of `block` values at x[lo, lo + block), a value
// a lane (the generic instances)
__device__ __forceinline__ float generic_scale(const float* __restrict__ x,
                                               int64_t lo, int block,
                                               int64_t k, int lane) {
  float m = 0.0f;
  for (int j = lane; j < block; j += 32)
    if (lo + j < k) m = fmaxf(m, fabsf(x[lo + j]));
  return group_scale(m);
}

}  // namespace
