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
//
// B12's design: a word-wide pack.  The body is the wrapper's fresh
// allocation, so it is 16-byte aligned, and thread t of a grid that covers
// it owns output word t, bytes [16t, 16t + 16), written with one 16-byte
// evict-first store.  The scales section starts at byte k and the index
// section at k + 4 ng, both unaligned for most k (k = 656 or 1,313 on the
// MLP's upload leg, 105,075 on the bench bus), and q may be a slice at
// any byte offset.  A word that lies inside one section takes its 16
// bytes from that source at byte p: the aligned 4-byte words at p & ~3
// onwards, four of them when p is 4-byte aligned, else five joined by
// __funnelshift_r over (p & 3) bytes (little-endian: the lower address is
// the low word).  Every word read holds at least one byte of the 16, so
// no read leaves the source allocation's aligned 4-byte granule.  For
// scales and idx (4-byte aligned) the shift is (-k) mod 4 for the whole
// section; for q it is q's own address mod 4.  The at most three words
// that straddle a seam (at k and at k + 4 ng; one word can hold both when
// ng < 4) and the last word, when the body is no multiple of 16, are
// assembled byte by byte: the owner's warp fetches the word's 16 bytes one
// a lane and ORs them into place (__reduce_or_sync), so the word costs one
// load's latency (with one thread loading all 16 a launch at k = 656 took
// 2.5 us, graph-timed by benchmarks/wrapper_cost.py, against 1.5 for the
// old byte-per-thread kernel; PERF.md); the last word stores only its
// valid bytes.
// The old design, one thread a byte in a grid-stride loop, held the H100
// at 29% of its byte bound at k = 6,710,886 (PERF.md).
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
// the MLP's k a launch costs more than the bytes: there a call costs its
// host path (sparse_pack.py keeps it lean).
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

// the address of byte i of the body in whichever source holds it
__device__ __forceinline__ const uint8_t* body_src(
    const uint8_t* q, const uint8_t* sc, const uint8_t* idx, int64_t k,
    int64_t idx_at, int64_t i) {
  return i < k ? q + i : (i < idx_at ? sc + (i - k) : idx + (i - idx_at));
}

// the 16 bytes at p, which lie inside one source: the aligned 4-byte
// words from p & ~3 (a fifth when p & 3 != 0, so that every word read
// holds one of the 16 bytes), loaded here and joined across the byte shift
// by join() once they are needed
struct Words {
  uint32_t x[5];
  unsigned int sh;
};

__device__ __forceinline__ Words load_words(const uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned int* w =
      reinterpret_cast<const unsigned int*>(a & ~uintptr_t{3});
  Words r = {};
  r.sh = 8u * static_cast<unsigned int>(a & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) r.x[j] = __ldcs(w + j);
  r.x[4] = r.sh ? __ldcs(w + 4) : 0u;
  return r;
}

__device__ __forceinline__ uint4 join(const Words& r) {
  if (r.sh == 0) return make_uint4(r.x[0], r.x[1], r.x[2], r.x[3]);
  return make_uint4(__funnelshift_r(r.x[0], r.x[1], r.sh),
                    __funnelshift_r(r.x[1], r.x[2], r.sh),
                    __funnelshift_r(r.x[2], r.x[3], r.sh),
                    __funnelshift_r(r.x[3], r.x[4], r.sh));
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ sc,
            const uint8_t* __restrict__ idx, uint8_t* __restrict__ body,
            int64_t k, int64_t idx_at, int64_t total) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t lo = 16 * t, hi = lo + 16;    // this thread's word's bytes
  // a word inside one section: its source words, loaded now and stored
  // after the seams below, so both loads are in flight together
  const uint8_t* src = nullptr;
  if (hi <= k)
    src = q + lo;                             // inside q
  else if (lo >= k && hi <= idx_at)
    src = sc + (lo - k);                      // inside the scales
  else if (lo >= idx_at && hi <= total)
    src = idx + (lo - idx_at);                // inside the indices
  Words r = {};
  if (src) r = load_words(src);
  // a word across a seam, or the last word: its warp's lanes 0-15 fetch its
  // 16 bytes, one a lane, and OR them together into the owner's word (no
  // thread returns early: every lane of the warp takes part)
  unsigned todo = __ballot_sync(0xffffffffu, !src && lo < total);
  const int lane = threadIdx.x & 31, b = lane & 15;
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t wlo = __shfl_sync(0xffffffffu, lo, owner);
    // a byte past the body reads the body's last byte again, never stored
    const int64_t i = wlo + b < total ? wlo + b : total - 1;
    const uint32_t byte = lane < 16 ? *body_src(q, sc, idx, k, idx_at, i) : 0u;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = __reduce_or_sync(0xffffffffu,
                              b / 4 == j ? byte << (8 * (b % 4)) : 0u);
    if (lane == owner) {
      if (wlo + 16 <= total) {
        __stcs(reinterpret_cast<uint4*>(body) + t,
               make_uint4(v[0], v[1], v[2], v[3]));
      } else {              // only the body's bytes: it ends inside the word
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (wlo + j < total)
            body[wlo + j] = static_cast<uint8_t>(v[j / 4] >> (8 * (j % 4)));
      }
    }
  }
  if (src) __stcs(reinterpret_cast<uint4*>(body) + t, join(r));
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

// q int8 [k] (any byte offset), scales f32 [ng], idx int32 [k] (4-byte
// aligned) -> body uint8 [5k + 4ng] (16-byte aligned)
int sp_pack_body(const void* q, const void* scales, const void* idx,
                 void* body, int64_t k, int64_t ng, void* stream) {
  if (k < 1 || ng < 1 || reinterpret_cast<uintptr_t>(body) % 16 ||
      reinterpret_cast<uintptr_t>(scales) % 4 ||
      reinterpret_cast<uintptr_t>(idx) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = 5 * k + 4 * ng;
  const int64_t words = (total + 15) / 16;
  pack_kernel<<<static_cast<unsigned>((words + kThreads - 1) / kThreads),
                kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(scales),
      static_cast<const uint8_t*>(idx), static_cast<uint8_t*>(body), k,
      k + 4 * ng, total);
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
