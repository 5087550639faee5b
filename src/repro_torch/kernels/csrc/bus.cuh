// Storage helpers shared by the port's elementwise bus kernels: f32 or
// bf16 storage (bf16 as raw uint16 bits), f32 math.  Widening is exact;
// narrowing rounds to nearest even.  A Pack is V elements of T in one
// aligned 16-byte (or 8-byte) register load or store; load_stream /
// store_stream move one with the evict-first hint (ld.global.cs /
// st.global.cs) for passes that touch each byte once.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

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

// the register word of one 16- or 8-byte Pack
template <typename P>
using PackWord = typename std::conditional<sizeof(P) == 16, uint4, uint2>::type;

template <typename P>
__device__ __forceinline__ P load_stream(const P* p) {
  static_assert(sizeof(P) == 16 || sizeof(P) == 8, "16- or 8-byte packs");
  const PackWord<P> w = __ldcs(reinterpret_cast<const PackWord<P>*>(p));
  P out;
  memcpy(&out, &w, sizeof(P));
  return out;
}

template <typename P>
__device__ __forceinline__ void store_stream(P* p, const P& v) {
  static_assert(sizeof(P) == 16 || sizeof(P) == 8, "16- or 8-byte packs");
  PackWord<P> w;
  memcpy(&w, &v, sizeof(P));
  __stcs(reinterpret_cast<PackWord<P>*>(p), w);
}

}  // namespace
