// The selective scan (Mamba's recurrence), for Hopper (sm_90a).
// Replaces one Pallas kernel of src/repro/kernels/mamba_scan.py:
//
//   mamba_scan_forward <- mamba_scan (:47), _mamba_kernel (:20)
//
// u [b, T, di] (f32 or bf16), dt [b, T, di] f32, B / C [b, T, ds] f32,
// A [di, ds] f32, D [di] f32.  Per (b, d), from h = 0 and for t = 0 ..
// T-1, all in f32:
//
//   h[s]   <- exp(dt_t[d] * A[d, s]) * h[s] + (dt_t[d] * u_t[d]) * B_t[s]
//   y_t[d]  = sum_s C_t[s] * h[s] + D[d] * u_t[d]
//
// y [b, T, di] is stored in u's dtype, rounded once (the model's single
// rounding of the scan plus its skip term); the final state h_T
// [b, di, ds] in f32 (the Pallas kernel drops it; the model's prefill
// hands it to decode).  u, dt, B and C are given by their (b, t) strides
// with a unit stride on their last dim, so B and C may be column slices
// of the model's x_proj output, read in place.
//
// Design.  The channels d are independent; the states s of one channel
// share dt_t and u_t.  One thread per (b, d) holds its ds states and its
// row of A in registers for the whole sequence, so the state never
// leaves the SM.  A block covers kThreads channels of one batch row:
// u_t and dt_t are read coalesced along di, kChunk steps at a time into
// registers, the next chunk's loads in flight while the current one is
// computed.  B_t and C_t, which every channel of the row reads, are
// staged kChunk steps at a time in a double-buffered shared tile and
// read as broadcast float4: one __syncthreads per chunk.  Any T is taken
// (steps past T are loaded as zeros and not run); any di (channels past
// di load zeros and store nothing).
//
// Bound on the H100 at the serving shape (b 4, T 2,048, di 8,192, ds 16;
// u and y bf16): u and y 134.2 MB each, dt 268.4 MB, B, C and h_T 3.1 MB:
// 540 MB, or 0.161 ms at 3.35 TB/s.  The b * T * di * ds = 1.07e9 exps
// go through the SFU at 16 a clock per SM: 0.257 ms on 132 SMs at 1.98
// GHz, the larger of the two (the ~5.4 GFLOP of FMAs take 0.08 ms on the
// CUDA cores).  The layout gives b * di / kThreads = 256 blocks, 8 warps
// an SM, each step a serial chain per channel: the SM spends >= 256
// clocks a step on exps alone, and with 2 warps a scheduler a step's
// dependent chain (dt * A, exp, the FMA into h, the sum into y) is not
// hidden.  Splitting a channel's states over threads, or T into chunks
// with a state hand-off (the chunked form), so more warps share the
// work is the later redesign.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 16;     // time steps staged at a time

struct Params {
  const void* u;
  const float* dt;
  const float* B;
  const float* C;
  const float* A;              // [di, ds]
  const float* D;              // [di]
  void* y;                     // [b, T, di] contiguous, u's dtype
  float* h_out;                // [b, di, ds]
  int64_t st[8];               // (b, t) strides of u, dt, B, C
  int di, seq;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DS, typename E>
__global__ void __launch_bounds__(kThreads) mamba_scan_fwd(const Params P) {
  constexpr int kRow = 2 * DS;                 // B_t then C_t
  constexpr int kTile = kChunk * kRow;         // floats of one chunk
  constexpr int kLoads = (kTile + kThreads - 1) / kThreads;
  __shared__ __align__(16) float tile[2][kTile];

  const int tid = threadIdx.x;
  const int per_row = (P.di + kThreads - 1) / kThreads;
  const int bi = blockIdx.x / per_row;
  const int d = (blockIdx.x % per_row) * kThreads + tid;
  const bool live = d < P.di;
  const int seq = P.seq;

  const E* u = static_cast<const E*>(P.u) + bi * P.st[0] + (live ? d : 0);
  const float* dt = P.dt + bi * P.st[2] + (live ? d : 0);
  const float* Bp = P.B + bi * P.st[4];
  const float* Cp = P.C + bi * P.st[6];
  const int64_t su = P.st[1], sdt = P.st[3], sB = P.st[5], sC = P.st[7];

  float A[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    A[s] = live ? P.A[static_cast<int64_t>(d) * DS + s] : 0.0f;
    h[s] = 0.0f;
  }
  const float Dd = live ? P.D[d] : 0.0f;

  // chunk t0's u, dt (this thread's channel) and its share of B/C,
  // zero past the end
  float pu[kChunk], pdt[kChunk], pbc[kLoads];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = t0 + i;
      const bool ok = live && t < seq;
      pu[i] = ok ? load_f32(u + t * su) : 0.0f;
      pdt[i] = ok ? dt[t * sdt] : 0.0f;
    }
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int idx = n * kThreads + tid;
      const int t = t0 + idx / kRow, c = idx % kRow;
      float v = 0.0f;
      if (idx < kTile && t < seq)
        v = c < DS ? Bp[t * sB + c] : Cp[t * sC + (c - DS)];
      pbc[n] = v;
    }
  };
  auto stash = [&](float* buf) {
#pragma unroll
    for (int n = 0; n < kLoads; ++n) {
      const int idx = n * kThreads + tid;
      if (idx < kTile) buf[idx] = pbc[n];
    }
  };

  E* y = static_cast<E*>(P.y) + static_cast<int64_t>(bi) * seq * P.di + d;
  fetch(0);
  stash(tile[0]);
  __syncthreads();
  const int chunks = (seq + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kChunk;
    float cu[kChunk], cdt[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      cu[i] = pu[i];
      cdt[i] = pdt[i];
    }
    const bool more = c + 1 < chunks;
    if (more) fetch(t0 + kChunk);             // in flight during compute
    const float* buf = tile[c & 1];
    const int steps = min(kChunk, seq - t0);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (i < steps) {
        const float dtv = cdt[i], uv = cu[i], du = dtv * uv;
        const float4* b4 = reinterpret_cast<const float4*>(buf + i * kRow);
        const float4* c4 = reinterpret_cast<const float4*>(buf + i * kRow + DS);
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < DS / 4; ++q) {
          const float4 bq = b4[q], cq = c4[q];
          const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
          const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& hs = h[4 * q + e];
            hs = fmaf(expf(dtv * A[4 * q + e]), hs, du * bv[e]);
            acc = fmaf(hs, cv[e], acc);
          }
        }
        if (live) store_f32(y + static_cast<int64_t>(t0 + i) * P.di,
                            fmaf(Dd, uv, acc));
      }
    }
    if (more) stash(tile[(c + 1) & 1]);
    __syncthreads();
  }

  if (live) {
    float* ho = P.h_out + (static_cast<int64_t>(bi) * P.di + d) * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) ho[s] = h[s];
  }
}

template <int DS>
cudaError_t launch_ds(const Params& p, int bf16, int blocks,
                      cudaStream_t stream) {
  if (bf16)
    mamba_scan_fwd<DS, __nv_bfloat16><<<blocks, kThreads, 0, stream>>>(p);
  else
    mamba_scan_fwd<DS, float><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: 8 int64 in elements, (batch, time) of u, dt, B, C.  u and y:
// 0 f32, 1 bf16; dt, B, C, A, D and h_out are f32.  ds in {4, 16}
// (jamba's reduced and published d_state); other values return
// cudaErrorInvalidValue (the wrapper refuses them first).
int mamba_scan_forward(const void* u, const float* dt, const float* B,
                       const float* C, const float* A, const float* D,
                       void* y, float* h_out, const int64_t* strides,
                       int bf16, int b, int T, int di, int ds, void* stream) {
  Params p;
  p.u = u;
  p.dt = dt;
  p.B = B;
  p.C = C;
  p.A = A;
  p.D = D;
  p.y = y;
  p.h_out = h_out;
  for (int i = 0; i < 8; ++i) p.st[i] = strides[i];
  p.di = di;
  p.seq = T;
  const int blocks = b * ((di + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 4: return launch_ds<4>(p, bf16, blocks, s);
    case 16: return launch_ds<16>(p, bf16, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
