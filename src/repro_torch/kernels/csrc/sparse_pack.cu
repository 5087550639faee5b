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
// same launch: B9's quantizer (quantize.cu) followed by B12's layout,
//   s = max(max|x| / 127, 1e-12)  (IEEE division: __fdiv_rn)
//   q = clip(rint(x / s), -127, 127)
// written to q int8 [ng * block] (zero-padded past k), to scales f32
// [ng], and to the body.  This file must never be built with
// --use_fast_math.
//
// B11's design: a warp a group, 8 warps (groups) a block.  At the wire's
// block of 256 (a template instance; one generic instance takes every
// other size) a lane loads 8 values as two 16-byte loads (value by value
// when sel is not 16-byte aligned, or across k, where the reference's
// zero padding starts), the group's max|x| is 5 xor shuffles (max is
// exact in any order; no barrier), and the lane's 8 q bytes go out as
// one 8-byte store to q and one to the body's value section, at 256 g +
// 8 lane (the per-group walk is quant_group.cuh's, shared with B9; B11
// loads sel and stores q with the evict-first hint).  The group's lane 0
// writes its scale and the scale's 4 bytes at k + 4 g (one word when k
// is a multiple of 4, else byte by byte).
// The index section, idx's bytes at k + 4 ng on, needs nothing the
// quantize computes: warp w also writes its 64 16-byte words, B12's
// aligned loads and funnel shifts (load_words, join) over the section's
// constant shift k mod 4, their loads issued before the quantize.  No
// byte of the body is written twice: the words at the seams hold bytes
// that other warps compute (q of the last group, the first and last
// scales), so each owner writes its own bytes there one at a time (B12's
// warp byte-OR path gathers a seam word's bytes from memory, where
// B11's q and scales are not yet); the index section's first word and
// the body's last store only their index bytes.  The old design, a
// 256-thread block a group with two barriers and a byte store for every
// q byte and index byte, held an H100 80GB HBM3 (700 W) at 46% of its
// bound at k = 6,710,886 (PERF.md).
//
// Bound on the H100 (3.35 TB/s): B12 moves 2*(5k + 4ng) bytes, no flops;
// B11 reads 8k (sel, idx) and writes the body (5k + 4ng), q (ng * block)
// and the scales (4ng), for a divide, a round and a compare a value.  At
// the MLP's k and the bench bus's a launch costs more than the bytes:
// there a call costs its host path (sparse_pack.py keeps both lean).
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "grid.cuh"
#include "quant_group.cuh"

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

__device__ __forceinline__ void put_u32(uint8_t* __restrict__ at,
                                        uint32_t v) {
#pragma unroll
  for (int b = 0; b < 4; ++b) at[b] = static_cast<uint8_t>(v >> (8 * b));
}

// B11: groups (one warp each) a block, and body words of the index
// section a lane (the warp's 64 words, 1,024 bytes: one group's indices)
constexpr int kGroupWarps = 8;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kIdxWords = 2;

// the index section, body bytes [at, total) = idx's bytes: 16-byte body
// words from the one holding byte `at` on, kIdxWords * 32 a warp, word j
// of lane l at 32 j + l (each store of a warp one 512-byte run).  A word
// inside the section takes its bytes by B12's aligned loads and funnel
// shifts (load_words, join); the first word, which starts in the scales
// section, and the last, which may end past the body, store only their
// index bytes, one at a time.
struct IdxWords {
  Words r[kIdxWords];
  int64_t t[kIdxWords];
};

__device__ __forceinline__ IdxWords load_idx_words(const uint8_t* idx,
                                                   int64_t at, int64_t total,
                                                   int64_t warp, int lane) {
  IdxWords w;
#pragma unroll
  for (int j = 0; j < kIdxWords; ++j) {
    w.t[j] = at / 16 + warp * 32 * kIdxWords + 32 * j + lane;
    const int64_t lo = 16 * w.t[j];
    w.r[j] = Words{};
    if (lo >= at && lo + 16 <= total) w.r[j] = load_words(idx + (lo - at));
  }
  return w;
}

__device__ __forceinline__ void store_idx_words(const IdxWords& w,
                                                const uint8_t* idx,
                                                uint8_t* body, int64_t at,
                                                int64_t total) {
#pragma unroll
  for (int j = 0; j < kIdxWords; ++j) {
    const int64_t lo = 16 * w.t[j];
    if (lo >= at && lo + 16 <= total) {
      __stcs(reinterpret_cast<uint4*>(body) + w.t[j], join(w.r[j]));
    } else if (lo < total) {
      for (int b = 0; b < 16; ++b)
        if (lo + b >= at && lo + b < total) body[lo + b] = idx[lo + b - at];
    }
  }
}

// the group's scale to scales[g] and its four bytes to the body at k + 4g
__device__ __forceinline__ void put_scale(uint8_t* body, float* scales,
                                          int64_t k, int64_t g, float s) {
  scales[g] = s;
  const uint32_t v = __float_as_uint(s);
  if ((k & 3) == 0)
    *reinterpret_cast<uint32_t*>(body + k + 4 * g) = v;
  else
    put_u32(body + k + 4 * g, v);
}

// B11.  BLOCK: the group size as a template parameter (256, the wire's),
// or 0 for the generic instance, which reads it from `block`.  Warp w
// quantizes group w (w < ng) and writes the index section's words of
// warp w (load_idx_words); sel16: sel is 16-byte aligned.
template <int BLOCK>
__global__ void __launch_bounds__(kGroupThreads)
quantize_pack_kernel(const float* __restrict__ sel,
                     const uint8_t* __restrict__ idx,
                     uint8_t* __restrict__ body, int8_t* __restrict__ q,
                     float* __restrict__ scales, int64_t k, int block,
                     int64_t ng, int64_t warps, int sel16) {
  static_assert(BLOCK == 0 || BLOCK == 256, "the wire's block, or generic");
  const int lane = threadIdx.x & 31;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kGroupWarps + (threadIdx.x >> 5);
  if (w >= warps) return;                     // the whole warp
  const int64_t at = k + 4 * ng, total = 5 * k + 4 * ng;
  // the index words' loads in flight during the quantize
  const IdxWords iw = load_idx_words(idx, at, total, w, lane);
  if (w < ng) {
    const int64_t g = w;
    if constexpr (BLOCK == 256) {
      // 8 values a lane: the group's max|x| by 5 shuffles, then the lane's
      // 8 q bytes as one 8-byte store to q and one to the body
      const int64_t i0 = g * BLOCK + 8 * lane;
      float x[8];
      load_lane8<true>(sel, i0, k, sel16, x);
      const float s = lane8_scale(x);
      const uint2 v = lane8_bytes(x, s);
      __stcs(reinterpret_cast<uint2*>(q + i0), v);  // zero-padded past k
      if (i0 + 8 <= k) {
        __stcs(reinterpret_cast<uint2*>(body + i0), v);
      } else {                                // the lane across k
        for (int j = 0; i0 + j < k; ++j) body[i0 + j] = lane8_byte(v, j);
      }
      if (lane == 0) put_scale(body, scales, k, g, s);
    } else {
      const int64_t lo = g * block;
      const float s = generic_scale(sel, lo, block, k, lane);
      for (int j = lane; j < block; j += 32) {
        const int64_t i = lo + j;
        const uint32_t b = quant_byte(i < k ? sel[i] : 0.0f, s);
        q[i] = static_cast<int8_t>(b);
        if (i < k) body[i] = static_cast<uint8_t>(b);
      }
      if (lane == 0) put_scale(body, scales, k, g, s);
    }
  }
  store_idx_words(iw, idx, body, at, total);
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

// sel f32 [k], idx int32 [k] -> body uint8 [5k + 4ng] (16-byte aligned),
// q int8 [ng * block] (8-byte aligned), scales f32 [ng], ng = ceil(k /
// block)
int sp_quantize_pack(const void* sel, const void* idx, void* body, void* q,
                     void* scales, int64_t k, int block, void* stream) {
  if (k < 1 || block < 1 || reinterpret_cast<uintptr_t>(body) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 8 ||
      reinterpret_cast<uintptr_t>(idx) % 4 ||
      reinterpret_cast<uintptr_t>(sel) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ng = (k + block - 1) / block;
  const int64_t at = k + 4 * ng, total = 5 * k + 4 * ng;
  const int64_t idx_words = (total + 15) / 16 - at / 16;
  const int64_t per_warp = 32 * kIdxWords;
  const int64_t warps = std::max(ng, (idx_words + per_warp - 1) / per_warp);
  const int64_t blocks = (warps + kGroupWarps - 1) / kGroupWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int sel16 = reinterpret_cast<uintptr_t>(sel) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(sel);
  const uint8_t* ip = static_cast<const uint8_t*>(idx);
  uint8_t* bp = static_cast<uint8_t*>(body);
  int8_t* qp = static_cast<int8_t*>(q);
  float* scp = static_cast<float*>(scales);
  if (block == 256)
    quantize_pack_kernel<256><<<static_cast<unsigned>(blocks), kGroupThreads,
                                0, s>>>(sp, ip, bp, qp, scp, k, block, ng,
                                     warps, sel16);
  else
    quantize_pack_kernel<0><<<static_cast<unsigned>(blocks), kGroupThreads,
                              0, s>>>(sp, ip, bp, qp, scp, k, block, ng, warps,
                                   sel16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
