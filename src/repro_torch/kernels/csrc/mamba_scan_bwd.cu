// The backward of the selective scan (B15's backward), for Hopper (sm_90a).
// Replaces the autodiff the reference's training takes through its
// chunked scan, src/repro/models/mamba.py::_chunk_scan (:84) in
// mamba_chunked (:105), under jax.grad:
//
//   mamba_scan_backward <- jax.grad of _chunk_scan's recurrence
//
// u [b, T, di] (f32 or bf16), dt [b, T, di] f32, B / C [b, T, ds] f32 by
// their (b, t) strides (unit stride on the last dim), A [di, ds], D [di]
// f32, dy [b, T, di] contiguous in u's dtype, and the forward's state at
// the start of each chunk of kChunk steps, [b, ceil(T / kChunk), di, ds]
// f32 (csrc/mamba_scan.cu writes it under autograd).  Per (b, d), with
// a_t = exp(dt_t A), h_{t-1} the state before step t and g_t the gradient
// w.r.t. h_t (g_t = C_t dy_t + a_{t+1} g_{t+1}; the final state is not
// differentiated):
//
//   du_t  = D dy_t + dt_t sum_s g_t B_t          (stored in u's dtype)
//   ddt_t = u_t sum_s g_t B_t + sum_s g_t A a_t h_{t-1}
//   dA   += g_t dt_t a_t h_{t-1}                 (a partial [b, di, ds])
//   dD   += dy_t u_t                             (a partial [b, di])
//   dB_t  = sum_d g_t dt_t u_t,  dC_t = sum_d dy_t h_t
//
// dB and dC sum over the channels, which cross blocks: each block writes
// its channels' sums, [b, T, blocks a row, 2 ds] (dB then dC), and the
// wrapper sums the partials (and dA's and dD's over b) in a fixed order.
// No float atomics: every sum has one order, so two runs are bit-equal.
//
// Bound on the H100 at jamba's training shape (b 8, T 128, di 8,192, ds
// 16; u, dy, du bf16): u, dy, du 16.8 MB each, dt and ddt 33.6 MB each,
// the checkpoints 33.6 MB: 152 MB, 0.045 ms at 3.35 TB/s, the larger;
// a_t once a state-step, 1.3e8 exps at 16 a clock per SM, 0.032 ms (this
// kernel takes two: one in the recompute, one in the reverse walk).
// Measured (chip_smoke.py 15a, PERF.md): 0.635 ms, 7% of the bound.
//
// Design: the forward's (csrc/mamba_scan.cu) lanes, kStates states a
// lane (2 lanes a channel at ds 16, 1 at ds 4), kThreads threads a block
// over the channels of one batch row; chunks of kChunk steps walked in
// reverse.  A chunk's u, dt, dy and B / C rows are staged in shared
// memory (identity steps past T: u = dt = dy = B = C = 0, which leave g
// and h as they are; channels past di compute on zeros); each lane steps
// its states forward from the chunk's checkpoint by the forward's own
// arithmetic (so h_{t-1} is the forward's, bit for bit), stashing
// h_{t-1} for each step in shared memory (its own slots: no barrier),
// then walks the chunk in reverse carrying a_{t+1} g_{t+1} in registers.
// sum_s g B and sum_s g A a h take a shuffle across the channel's lanes;
// the block's sums of dB and dC over its channels a transposed butterfly
// across the warp's channels and the warps' partials in warp order after
// the chunk.  expf is the accurate one: never build with --use_fast_math.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 128;  // threads a block (csrc/mamba_scan.cu's)
constexpr int kChunk = 16;     // csrc/mamba_scan.cu's: the checkpoint spacing
constexpr int kStates = 8;     // states a lane, at most (float4s)
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int lanes_of(int ds) {
  return ds > kStates ? ds / kStates : 1;
}

struct Params {
  const void* u;
  const float* dt;
  const float* B;
  const float* C;
  const float* A;              // [di, ds]
  const float* D;              // [di]
  const void* dy;              // [b, T, di] contiguous, u's dtype
  const float* h_ck;           // [b, chunks, di, ds]
  void* du;                    // [b, T, di] contiguous, u's dtype
  float* ddt;                  // [b, T, di] contiguous
  float* dbc;                  // [b, T, blocks a row, 2 ds]
  float* dA;                   // [b, di, ds]
  float* dD;                   // [b, di]
  int64_t st[8];               // (b, t) strides of u, dt, B, C
  int di, seq;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DS>
struct Layout {
  static constexpr int kLanes = lanes_of(DS), kSt = DS / kLanes;
  static constexpr int kChannels = kThreads / kLanes, NV = kSt / 4;
  // shared memory in floats: u, dt, dy [C][kChannels]; B then C
  // [C][2 DS]; the stash [C][NV][kThreads] float4s; the warps' partials
  // of dB and dC [C][kWarps][2 DS]
  static constexpr int kU = 0, kDt = kChunk * kChannels;
  static constexpr int kDy = 2 * kChunk * kChannels;
  static constexpr int kBC = 3 * kChunk * kChannels;
  static constexpr int kStash = kBC + kChunk * 2 * DS;
  static constexpr int kPart = kStash + kChunk * kSt * kThreads;
  static constexpr int kFloats = kPart + kChunk * kWarps * 2 * DS;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kSt % 4 == 0 && kLanes * kSt == DS &&
                    (kLanes & (kLanes - 1)) == 0 && kLanes <= 32,
                "whole float4s of states; a power of two lanes a channel");
  static_assert(kStash % 4 == 0, "the stash on a 16-byte boundary");
};

// the block's dB / dC partials of one step across the warp's channels:
// from lane bit BIT up, each round halves the N values left across lane
// xor BIT, keeping the lower or upper half by that bit; once one value is
// left, a plain sum.  base gains the offset of the half kept.
template <int N, int BIT>
__device__ __forceinline__ void channel_rounds(float* x, int lane, int& base) {
  if constexpr (BIT < 32) {
    if constexpr (N > 1) {
      constexpr int half = N / 2;
      const bool upper = lane & BIT;
#pragma unroll
      for (int m = 0; m < half; ++m) {
        const float send = upper ? x[m] : x[m + half];
        const float keep = upper ? x[m + half] : x[m];
        x[m] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
      }
      if (upper) base += half;
      channel_rounds<half, BIT * 2>(x, lane, base);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], BIT);
      channel_rounds<1, BIT * 2>(x, lane, base);
    }
  }
}

// lane bits of the plain rounds (where a lane holds another's copy)
template <int N, int BIT>
__host__ __device__ constexpr int dup_bits() {
  if constexpr (BIT >= 32) {
    return 0;
  } else if constexpr (N > 1) {
    return dup_bits<N / 2, BIT * 2>();
  } else {
    return BIT | dup_bits<1, BIT * 2>();
  }
}

template <int DS, typename E>
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel(const Params P) {
  using Lt = Layout<DS>;
  constexpr int kLanes = Lt::kLanes, kSt = Lt::kSt;
  constexpr int kChannels = Lt::kChannels, NV = Lt::NV, C = kChunk;
  constexpr int kVals = 2 * kSt;                // dB, dC partials a lane
  constexpr int kDup = dup_bits<kVals, kLanes>();
  extern __shared__ __align__(16) float sm[];
  float* const su = sm + Lt::kU;
  float* const sdt = sm + Lt::kDt;
  float* const sdy = sm + Lt::kDy;
  float* const sbc = sm + Lt::kBC;
  float4* const stash = reinterpret_cast<float4*>(sm + Lt::kStash);
  float* const part = sm + Lt::kPart;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / kLanes, q = tid % kLanes;
  const int per_row = (P.di + kChannels - 1) / kChannels;
  const int bi = blockIdx.x / per_row, blk = blockIdx.x % per_row;
  const int d0 = blk * kChannels, nch = min(kChannels, P.di - d0);
  const int d = d0 + c;
  const bool live = c < nch;
  const int seq = P.seq, chunks = (seq + C - 1) / C;

  const E* ub = static_cast<const E*>(P.u) + bi * P.st[0] + d0;
  const float* dtb = P.dt + bi * P.st[2] + d0;
  const float* Bb = P.B + bi * P.st[4];
  const float* Cb = P.C + bi * P.st[6];
  const int64_t row0 = static_cast<int64_t>(bi) * seq * P.di + d0;
  const E* dyb = static_cast<const E*>(P.dy) + row0;
  E* const dub = static_cast<E*>(P.du) + row0;
  float* const ddtb = P.ddt + row0;

  float A[kSt], dA[kSt], carry[kSt];
#pragma unroll
  for (int s = 0; s < kSt; ++s) {
    A[s] = live ? P.A[static_cast<int64_t>(d) * DS + kSt * q + s] : 0.0f;
    dA[s] = 0.0f;
    carry[s] = 0.0f;                            // a_{t+1} g_{t+1}
  }
  const float Dd = live ? P.D[d] : 0.0f;
  float dD = 0.0f;

  for (int ci = chunks - 1; ci >= 0; --ci) {
    const int t0 = ci * C;
    __syncthreads();                  // the last chunk's readers are done
    for (int n = tid; n < C * kChannels; n += kThreads) {
      const int i = n / kChannels, ch = n % kChannels, t = t0 + i;
      const bool ok = t < seq && ch < nch;
      su[n] = ok ? to_f32(ub[t * P.st[1] + ch]) : 0.0f;
      sdt[n] = ok ? dtb[t * P.st[3] + ch] : 0.0f;
      sdy[n] = ok ? to_f32(dyb[static_cast<int64_t>(t) * P.di + ch]) : 0.0f;
    }
    for (int n = tid; n < C * 2 * DS; n += kThreads) {
      const int i = n / (2 * DS), s = n % (2 * DS), t = t0 + i;
      sbc[n] = t >= seq ? 0.0f
               : s < DS ? Bb[t * P.st[5] + s] : Cb[t * P.st[7] + s - DS];
    }
    float h[kSt];
    {
      const float4* hc = reinterpret_cast<const float4*>(
          P.h_ck + ((static_cast<int64_t>(bi) * chunks + ci) * P.di
                    + (live ? d : 0)) * DS + kSt * q);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 x = live ? hc[v] : make_float4(0.f, 0.f, 0.f, 0.f);
        h[4 * v] = x.x;
        h[4 * v + 1] = x.y;
        h[4 * v + 2] = x.z;
        h[4 * v + 3] = x.w;
      }
    }
    __syncthreads();
    // the forward's steps from the checkpoint, h_{t-1} stashed
#pragma unroll 1
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int v = 0; v < NV; ++v)
        stash[(i * NV + v) * kThreads + tid] =
            make_float4(h[4 * v], h[4 * v + 1], h[4 * v + 2], h[4 * v + 3]);
      const float dtv = sdt[i * kChannels + c], uv = su[i * kChannels + c];
      const float du = dtv * uv;
#pragma unroll
      for (int s = 0; s < kSt; ++s)
        h[s] = fmaf(expf(dtv * A[s]), h[s],
                    du * sbc[i * 2 * DS + kSt * q + s]);
    }
    // the reverse walk
#pragma unroll 1
    for (int i = C - 1; i >= 0; --i) {
      const int t = t0 + i;
      const float dtv = sdt[i * kChannels + c], uv = su[i * kChannels + c];
      const float dyv = sdy[i * kChannels + c], duv = dtv * uv;
      const float* bt = sbc + i * 2 * DS + kSt * q;
      const float* ct = bt + DS;
      float hp[kSt], x[kVals];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 y = stash[(i * NV + v) * kThreads + tid];
        hp[4 * v] = y.x;
        hp[4 * v + 1] = y.y;
        hp[4 * v + 2] = y.z;
        hp[4 * v + 3] = y.w;
      }
      float gB = 0.0f, gAah = 0.0f;
#pragma unroll
      for (int s = 0; s < kSt; ++s) {
        const float a = expf(dtv * A[s]);
        const float ht = fmaf(a, hp[s], duv * bt[s]);
        const float g = fmaf(ct[s], dyv, carry[s]);
        const float gah = g * a * hp[s];
        gB = fmaf(g, bt[s], gB);
        gAah = fmaf(gah, A[s], gAah);
        dA[s] = fmaf(gah, dtv, dA[s]);
        x[s] = g * duv;                         // dB_t[s], this channel
        x[kSt + s] = dyv * ht;                  // dC_t[s], this channel
        carry[s] = a * g;
      }
#pragma unroll
      for (int m = 1; m < kLanes; m <<= 1) {    // the channel's lanes
        gB += __shfl_xor_sync(0xffffffffu, gB, m);
        gAah += __shfl_xor_sync(0xffffffffu, gAah, m);
      }
      dD = fmaf(dyv, uv, dD);
      if (q == 0 && live && t < seq) {
        store_f32(dub + static_cast<int64_t>(t) * P.di + c,
                  fmaf(Dd, dyv, dtv * gB));
        ddtb[static_cast<int64_t>(t) * P.di + c] = fmaf(uv, gB, gAah);
      }
      int base = 0;
      channel_rounds<kVals, kLanes>(x, lane, base);
      if (!(lane & kDup)) {
        const int st = base < kSt ? kSt * q + base : DS + kSt * q + base - kSt;
        part[(i * kWarps + warp) * 2 * DS + st] = x[0];
      }
    }
    __syncthreads();
    for (int n = tid; n < C * 2 * DS; n += kThreads) {
      const int i = n / (2 * DS), e = n % (2 * DS), t = t0 + i;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += part[(i * kWarps + w) * 2 * DS + e];
      if (t < seq)
        P.dbc[((static_cast<int64_t>(bi) * seq + t) * per_row + blk) * 2 * DS
              + e] = sum;
    }
  }
  if (live) {
    float* da = P.dA + (static_cast<int64_t>(bi) * P.di + d) * DS + kSt * q;
#pragma unroll
    for (int s = 0; s < kSt; ++s) da[s] = dA[s];
    if (q == 0) P.dD[static_cast<int64_t>(bi) * P.di + d] = dD;
  }
}

template <int DS, typename E>
cudaError_t launch_typed(const Params& p, int blocks, cudaStream_t stream) {
  using Lt = Layout<DS>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = once_a_device(configured, [] {
    return cudaFuncSetAttribute(mamba_scan_bwd_kernel<DS, E>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Lt::kBytes));
  });
  if (err != cudaSuccess) return err;
  mamba_scan_bwd_kernel<DS, E><<<blocks, kThreads, Lt::kBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DS>
cudaError_t launch_ds(const Params& p, int bf16, int b, cudaStream_t stream) {
  const int blocks = b * ((p.di + Layout<DS>::kChannels - 1)
                          / Layout<DS>::kChannels);
  return bf16 ? launch_typed<DS, __nv_bfloat16>(p, blocks, stream)
              : launch_typed<DS, float>(p, blocks, stream);
}

}  // namespace

extern "C" {

const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: 8 int64 in elements, (batch, time) of u, dt, B, C.  u, dy and
// du: 0 f32, 1 bf16; everything else f32.  dy, du and ddt contiguous
// [b, T, di]; h_ck [b, ceil(T / 16), di, ds] (16-byte aligned), the
// forward's chunk-start states; dbc [b, T, ceil(di / channels a block),
// 2 ds]; dA [b, di, ds]; dD [b, di].  ds in {4, 16}; other values return
// cudaErrorInvalidValue (the wrapper refuses them first).
int mamba_scan_backward(const void* u, const float* dt, const float* B,
                        const float* C, const float* A, const float* D,
                        const void* dy, const float* h_ck, void* du,
                        float* ddt, float* dbc, float* dA, float* dD,
                        const int64_t* strides, int bf16, int b, int T,
                        int di, int ds, void* stream) {
  Params p;
  p.u = u;
  p.dt = dt;
  p.B = B;
  p.C = C;
  p.A = A;
  p.D = D;
  p.dy = dy;
  p.h_ck = h_ck;
  p.du = du;
  p.ddt = ddt;
  p.dbc = dbc;
  p.dA = dA;
  p.dD = dD;
  for (int i = 0; i < 8; ++i) p.st[i] = strides[i];
  p.di = di;
  p.seq = T;
  if (reinterpret_cast<uintptr_t>(h_ck) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 4: return launch_ds<4>(p, bf16, b, s);
    case 16: return launch_ds<16>(p, bf16, b, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
