// Storage helpers shared by the port's elementwise bus kernels: f32 or
// bf16 storage (bf16 as raw uint16 bits), f32 math.  Widening is exact;
// narrowing rounds to nearest even.  A Pack is V elements of T in one
// aligned 16-byte register load or store.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ uint16_t narrow<uint16_t>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// V elements of T in one aligned register pack (16 bytes for V*sizeof(T)=16)
template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

}  // namespace
