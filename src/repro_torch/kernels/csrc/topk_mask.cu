// The two passes of the blocked exact top-k, for Hopper (sm_90a).  Each
// entry replaces one Pallas kernel of src/repro/kernels/topk_mask.py:
//
//   tk_stats <- blocked_topk_stats (:91), _stats_kernel (:78)        (B6)
//   tk_exact <- threshold_sparsify_exact (:138), _exact_kernel (:122) (B7)
//   tk_threshold_* <- threshold_sparsify (:50), _mask_kernel (:42)      (B8)
//
// Both tile the flat f32 bus into blocks of 8,192 elements (the
// reference's BLOCK; elements past n read as 0.0, its zero padding) and
// give each tile one thread block of 256 threads.  Warp w of a tile owns
// the contiguous 1,024-element chunk [w * 1024, (w + 1) * 1024): at step s
// (0..31) its lanes read the 32 consecutive floats of word s of the
// chunk, one coalesced 128-byte line.
//
// B6: word = __ballot_sync of (bits(x) & 0x7fffffff) >= lo, so bit i of
// word w is element 32 w + i of the tile, as the reference packs it.  Lane
// s keeps word s and the warp stores its 32 words in one coalesced store;
// the tile's count is a shared-memory sum of the 8 warps' popcounts.
// `lo` (u32 magnitude bits, > 0 on the selection path) is read from
// device memory where the caller has it there (the path's bracket), so
// the launch never waits on the host, or taken by value (a number: no
// copy to the card).
//
// B7: keep |x| > tau always and |x| == tau while the global tie rank is
// below `budget`; the rank is tie_start[tile] + the ties of the earlier
// warps of the tile (a shared-memory exclusive scan of the 8 warps' tie
// counts) + the ties earlier in the warp's chunk (a running count) + the
// ties of lower lanes in the step (__popc(ballot & lanemask_lt)).  Lowest
// index wins, lax.top_k's rule.  Each lane holds its 32 values in
// registers between the counting pass and the emit pass, so x is read
// once.  kept = keep ? x : 0.0 and residual = x - kept in f32 (one IEEE
// subtraction), so kept + residual == x exactly and the results equal the
// plain version's bit for bit.  tau and budget are read from device
// memory (the refinement's tensors) or taken by value (numbers: no copy
// to the card).
//
// What bounds it.  It moves 12 B an element: 0.0075 ms on the compressed
// round's bench bus (2,105,344 elements, 257 tiles, one partial wave) at
// 3.35 TB/s.  There the bus is fresh in the 50 MB L2, and on the H100
// this walk takes 6.9 us a call graph-timed, above that byte bound; at
// 2^27 it holds 86-87%.  In turns with it (codec_variants.py), none of
// these beat it at the bench bus: warps holding no tie of tau (almost
// all, on the path) storing before the tile's barrier, +0.3-0.4 us (and
// 7% slower at 2^27); a lane holding 4 consecutive floats a step (16-byte
// loads and stores, ties ranked by a __shfl_up_sync scan), +0.5-0.7 us,
// +1.1-1.3 with the early stores; evict-first kept stores, +0.1 (2%
// slower at 2^27).  512-thread tiles came within 0.15 us of it (PERF.md,
// PR 24).

// B8, the plain threshold pass (not exact-k: every |x| >= tau is kept,
// ties and all): kept = |x| >= tau ? x : 0.0 and residual = x - kept, in
// f32 math, both stored in x's dtype (f32 or bf16; either value is x or
// zero, so narrowing is exact and kept + residual == x).  tau is an f32
// read from device memory and compared in f32, as the Pallas kernel does
// (the reference's jnp oracle compares bf16 x against tau rounded to
// bf16, a different cut for a tau between two bf16 values).  It needs no
// tiles: a grid-stride pass over 16-byte packs, then the n % V elements
// after them, one each for the first threads of block 0.
//
// Bound on the H100 (3.35 TB/s HBM3): all three are memory-bound, with a
// compare, a ballot and a popcount an element.  B6 moves 4n bytes in and
// n/8 + 4 nb out; B7 4n in, 8n out and 4 nb of tie_start; B8 4n in and
// 8n out in f32 (2n and 4n in bf16).
//
// Every entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bus.cuh"
#include "grid.cuh"

namespace {

constexpr int kBlock = 8192;                 // elements of a tile
constexpr int kTileThreads = 256;
constexpr int kWarps = kTileThreads / 32;    // 8 chunks of 1,024 a tile
constexpr int kSteps = kBlock / kWarps / 32; // 32 words a chunk

__global__ void __launch_bounds__(kTileThreads)
stats_kernel(const float* __restrict__ x, const uint32_t* __restrict__ lo_p,
             uint32_t lo_v, uint32_t* __restrict__ words,
             int32_t* __restrict__ counts, int64_t n) {
  __shared__ int warp_count[kWarps];
  const uint32_t lo = lo_p != nullptr ? *lo_p : lo_v;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kBlock +
                        warp * (kSteps * 32);
  float v[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t i = chunk + s * 32 + lane;
    v[s] = i < n ? x[i] : 0.0f;
  }
  uint32_t mine = 0;
  int count = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint32_t ball =
        __ballot_sync(0xffffffffu, (__float_as_uint(v[s]) & 0x7fffffffu) >= lo);
    if (lane == s) mine = ball;
    count += __popc(ball);
  }
  words[static_cast<int64_t>(blockIdx.x) * (kBlock / 32) + warp * kSteps +
        lane] = mine;
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_count[w];
    counts[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kTileThreads)
exact_kernel(const float* __restrict__ x, const float* __restrict__ tau_p,
             float tau_v, const int32_t* __restrict__ budget_p,
             int32_t budget_v, const int32_t* __restrict__ tie_start,
             float* __restrict__ kept, float* __restrict__ residual,
             int64_t n) {
  __shared__ int warp_ties[kWarps];
  const float tau = tau_p != nullptr ? *tau_p : tau_v;
  const int budget = budget_p != nullptr ? *budget_p : budget_v;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kBlock +
                        warp * (kSteps * 32);
  float v[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t i = chunk + s * 32 + lane;
    v[s] = i < n ? x[i] : 0.0f;
  }
  // 1. the chunk's ties, then the exclusive scan over the tile's warps
  int ties = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
    ties += __popc(__ballot_sync(0xffffffffu, fabsf(v[s]) == tau));
  if (lane == 0) warp_ties[warp] = ties;
  __syncthreads();
  int rank0 = tie_start[blockIdx.x];
  for (int w = 0; w < warp; ++w) rank0 += warp_ties[w];
  // 2. emit: the global tie rank of a tie is rank0 + the ties before it
  const uint32_t lanes_below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float mag = fabsf(v[s]);
    const bool tie = mag == tau;
    const uint32_t ball = __ballot_sync(0xffffffffu, tie);
    const int rank = rank0 + __popc(ball & lanes_below);
    const bool keep = mag > tau || (tie && rank < budget);
    const float k = keep ? v[s] : 0.0f;
    const int64_t i = chunk + s * 32 + lane;
    if (i < n) {
      kept[i] = k;
      residual[i] = __fsub_rn(v[s], k);
    }
    rank0 += __popc(ball);
  }
}

template <typename T>
__device__ __forceinline__ void threshold1(T x, float tau, T* kept, T* res) {
  const float xf = widen(x);
  const float k = fabsf(xf) >= tau ? xf : 0.0f;
  *kept = narrow<T>(k);
  *res = narrow<T>(__fsub_rn(xf, k));
}

template <typename T>
__global__ void threshold_kernel(const T* __restrict__ x,
                                 const float* __restrict__ tau_p, float tau_v,
                                 T* __restrict__ kept, T* __restrict__ res,
                                 int64_t n) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const float tau = tau_p != nullptr ? *tau_p : tau_v;
  const int64_t nvec = n / V;
  const P* xp = reinterpret_cast<const P*>(x);
  P* kp = reinterpret_cast<P*>(kept);
  P* rp = reinterpret_cast<P*>(res);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const P xv = xp[i];
    P kv, rv;
#pragma unroll
    for (int k = 0; k < V; ++k) threshold1(xv.v[k], tau, &kv.v[k], &rv.v[k]);
    kp[i] = kv;
    rp[i] = rv;
  }
  const int64_t t = nvec * V + threadIdx.x;
  if (blockIdx.x == 0 && t < n) threshold1(x[t], tau, &kept[t], &res[t]);
}

template <typename T>
int threshold_launch(const void* x, const void* tau, float tau_v, void* kept,
                     void* res, int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  threshold_kernel<T><<<grid_for(n / (16 / sizeof(T))), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(tau), tau_v,
      static_cast<T*>(kept), static_cast<T*>(res), n);
  return static_cast<int>(cudaGetLastError());
}

bool tiles_for(int64_t n, unsigned* tiles) {
  if (n < 1) return false;
  const int64_t nb = (n + kBlock - 1) / kBlock;
  if (nb > 2147483647LL || n > 2147483647LL) return false;  // i32 ranks
  *tiles = static_cast<unsigned>(nb);
  return true;
}

}  // namespace

extern "C" {

const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x f32 [n], lo u32 [1] (or NULL: lo_v) -> words u32 [nb, 256], counts
// i32 [nb]
int tk_stats(const void* x, const void* lo, uint32_t lo_v, void* words,
             void* counts, int64_t n, void* stream) {
  unsigned tiles = 0;
  if (!tiles_for(n, &tiles)) return static_cast<int>(cudaErrorInvalidValue);
  stats_kernel<<<tiles, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(lo), lo_v,
      static_cast<uint32_t*>(words), static_cast<int32_t*>(counts), n);
  return static_cast<int>(cudaGetLastError());
}

// x f32 [n], tau f32 [1] (or NULL: tau_v), budget i32 [1] (or NULL:
// budget_v), tie_start i32 [nb] -> kept f32 [n], residual f32 [n]
int tk_exact(const void* x, const void* tau, float tau_v, const void* budget,
             int32_t budget_v, const void* tie_start, void* kept,
             void* residual, int64_t n, void* stream) {
  unsigned tiles = 0;
  if (!tiles_for(n, &tiles)) return static_cast<int>(cudaErrorInvalidValue);
  exact_kernel<<<tiles, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(tau), tau_v,
      static_cast<const int32_t*>(budget), budget_v,
      static_cast<const int32_t*>(tie_start), static_cast<float*>(kept),
      static_cast<float*>(residual), n);
  return static_cast<int>(cudaGetLastError());
}

// x [n] (f32 or bf16), tau f32 [1] (or NULL: tau_v) -> kept [n],
// residual [n] in x's dtype
int tk_threshold_f32(const void* x, const void* tau, float tau_v, void* kept,
                     void* res, int64_t n, void* stream) {
  return threshold_launch<float>(x, tau, tau_v, kept, res, n, stream);
}

int tk_threshold_bf16(const void* x, const void* tau, float tau_v, void* kept,
                      void* res, int64_t n, void* stream) {
  return threshold_launch<uint16_t>(x, tau, tau_v, kept, res, n, stream);
}

}  // extern "C"
