// The WKV6 recurrence (RWKV-6 "Finch" time mix), for Hopper (sm_90a).
// Replaces one Pallas kernel of src/repro/kernels/rwkv6_scan.py:
//
//   wkv6_forward <- wkv6 (:46), _wkv6_kernel (:19)
//
// r, k, v, w [b, h, T, hd] (w the decay in (0, 1)), u [h, hd] f32.  Per
// (b, h), from S = 0 and for t = 0 .. T-1, all in f32:
//
//   out_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//   S[i,j]  <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
//
// out [b, h, T, hd] is stored in r's dtype (f32 or bf16 storage, like
// the inputs); the final state S_T [b, h, hd, hd] in f32 (the Pallas
// kernel drops it; the model's prefill hands it to decode).  Every
// tensor but u and S_T is given by its (b, h, t) strides with a unit
// stride on hd, so the model's [b, T, h, hd] projections are read in
// place.
//
// Design.  Columns j of S are independent, and so are the rows i up to
// the sum over i in out_t[j].  One block of 4 * hd threads per (b, h):
// thread (j, g), g = tid % 4, holds S[i, j] for the hd / 4 rows
// i = (4 q + g) * 4 + c (q < hd / 16, c < 4) in registers for the whole
// sequence, so the state never leaves the SM.  Per step a thread does
// the reference's four operations per row over its rows, then the four
// threads of a column (neighbouring lanes) sum their parts of out_t[j]
// with two shuffles.  r, k, w and v arrive in chunks of kChunk steps in
// shared memory, as f32; a thread reads its rows of r, k and w as float4
// at float4 index 4 q + g, so the four lane groups of a warp hit four
// consecutive float4 (no bank conflict) and every other lane is a
// broadcast.  The next chunk is loaded into registers while the current
// one is computed, and stored into the other half of a double buffer:
// one __syncthreads per chunk.  Any T is taken (steps past T are loaded
// as zeros and not run).
//
// Bound on the H100 at the serving shape (b 4, h 32, T 2,048, hd 64,
// f32): 4 inputs and out of 67.1 MB each plus S_T 2.1 MB = 337.6 MB, or
// 0.101 ms at 3.35 TB/s; about 3 * 4,096 FMAs per step per chain, 6.44
// GFLOP, 0.096 ms at 67 TFLOP/s on the CUDA cores.  The serial chain of
// T steps per (b, h), one block each (128 blocks on 132 SMs, 8 warps an
// SM), keeps this kernel well above either: each step takes its SM at
// least 4 * hd * hd / 128 cycles of FP32 instructions.  Splitting T (the
// chunked form) is the later redesign.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 4;      // threads sharing one column j
constexpr int kChunk = 16;     // time steps staged per shared buffer
constexpr int kArrays = 4;     // r, k, w, v

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;              // [h, hd]
  void* out;
  float* s_out;                // [b, h, hd, hd]
  int64_t st[15];              // (b, h, t) strides of r, k, v, w, out
  int h, seq;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * 2 * kArrays * kChunk * HD;
}

template <int HD, typename E>
__global__ void __launch_bounds__(kGroup * HD) wkv6_fwd(const Params P) {
  constexpr int kThreads = kGroup * HD;
  constexpr int kRows = HD / kGroup;        // rows of S per thread
  constexpr int kQuads = kRows / 4;         // float4 reads per array
  constexpr int kTile = kChunk * HD;        // one array's chunk
  constexpr int kLoads = kArrays * kTile / kThreads;   // = kChunk
  extern __shared__ __align__(16) float smem[];        // [2][4][kChunk][HD]

  const int tid = threadIdx.x, g = tid % kGroup, j = tid / kGroup;
  const int bi = blockIdx.x / P.h, hi = blockIdx.x % P.h;
  const E* src[kArrays];
  int64_t ts[kArrays];
  const void* bases[kArrays] = {P.r, P.k, P.w, P.v};
  const int order[kArrays] = {0, 1, 3, 2};   // P.st holds r, k, v, w
#pragma unroll
  for (int a = 0; a < kArrays; ++a) {
    const int64_t* s = P.st + 3 * order[a];
    src[a] = static_cast<const E*>(bases[a]) + bi * s[0] + hi * s[1];
    ts[a] = s[2];
  }
  E* out = static_cast<E*>(P.out) + bi * P.st[12] + hi * P.st[13];
  const int64_t out_ts = P.st[14];

  float S[kRows], u[kRows];
#pragma unroll
  for (int q = 0; q < kQuads; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      S[4 * q + c] = 0.0f;
      u[4 * q + c] = P.u[hi * HD + (4 * q + g) * 4 + c];
    }

  // chunk t0's values for this thread's load slots, zero past the end:
  // slot n is element n * kThreads + tid of the chunk's [4][kChunk][HD],
  // so its array is n / kPerArray (a constant once unrolled)
  constexpr int kPerArray = kTile / kThreads;
  float pf[kLoads];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int a = n / kPerArray;
      const int rem = (n % kPerArray) * kThreads + tid;
      const int t = t0 + rem / HD, d = rem % HD;
      pf[n] = t < P.seq ? load_f32(src[a] + t * ts[a] + d) : 0.0f;
    }
  };
  auto stash = [&](float* buf) {
#pragma unroll
    for (int n = 0; n < kLoads; ++n) buf[tid + n * kThreads] = pf[n];
  };

  fetch(0);
  stash(smem);
  __syncthreads();
  const int chunks = (P.seq + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kChunk;
    const bool more = c + 1 < chunks;
    if (more) fetch(t0 + kChunk);             // in flight during compute
    const float* buf = smem + (c & 1) * kArrays * kTile;
    const int steps = min(kChunk, P.seq - t0);
    for (int tt = 0; tt < steps; ++tt) {
      const float* row = buf + tt * HD;
      const float4* r4 = reinterpret_cast<const float4*>(row);
      const float4* k4 = reinterpret_cast<const float4*>(row + kTile);
      const float4* w4 = reinterpret_cast<const float4*>(row + 2 * kTile);
      const float vj = row[3 * kTile + j];
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 rq = r4[kGroup * q + g];
        const float4 kq = k4[kGroup * q + g];
        const float4 wq = w4[kGroup * q + g];
        const float rv[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kv4[4] = {kq.x, kq.y, kq.z, kq.w};
        const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s = S[4 * q + e];
          const float kv = kv4[e] * vj;
          acc = fmaf(rv[e], fmaf(u[4 * q + e], kv, s), acc);
          s = fmaf(wv[e], s, kv);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) store_f32(out + (t0 + tt) * out_ts + j, acc);
    }
    if (more) stash(smem + ((c + 1) & 1) * kArrays * kTile);
    __syncthreads();
  }

  float* s_out = P.s_out + static_cast<int64_t>(blockIdx.x) * HD * HD;
#pragma unroll
  for (int q = 0; q < kQuads; ++q)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s_out[((4 * q + g) * 4 + c) * HD + j] = S[4 * q + c];
}

template <int HD, typename E>
cudaError_t launch_typed(const Params& p, int blocks, cudaStream_t stream) {
  static bool configured = false;         // one attribute call per kernel
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_fwd<HD, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<HD>()));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  wkv6_fwd<HD, E><<<blocks, kGroup * HD, smem_bytes<HD>(), stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Params& p, int bf16, int blocks,
                      cudaStream_t stream) {
  return bf16 ? launch_typed<HD, __nv_bfloat16>(p, blocks, stream)
              : launch_typed<HD, float>(p, blocks, stream);
}

}  // namespace

extern "C" {

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: 15 int64 in elements, (batch, head, time) of r, k, v, w, out.
// dtype of r, k, v, w and out: 0 f32, 1 bf16; u and s_out are f32.
// hd in {16, 64} (rwkv6's reduced and published head dims); other values
// return cudaErrorInvalidValue (the wrapper refuses them first).
int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                 const float* u, void* out, float* s_out,
                 const int64_t* strides, int bf16, int b, int h, int T,
                 int hd, void* stream) {
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.out = out;
  p.s_out = s_out;
  for (int i = 0; i < 15; ++i) p.st[i] = strides[i];
  p.h = h;
  p.seq = T;
  const int blocks = b * h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(p, bf16, blocks, s);
    case 64: return launch_hd<64>(p, bf16, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
