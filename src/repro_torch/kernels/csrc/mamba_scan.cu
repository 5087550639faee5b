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
// Bound on the H100 at the serving shape (b 4, T 2,048, di 8,192, ds 16;
// u and y bf16): u and y 134.2 MB each, dt 268.4 MB, B, C and h_T 3.1 MB:
// 540 MB, or 0.161 ms at 3.35 TB/s.  The b * T * di * ds = 1.07e9 exps
// go through the SFU at 16 a clock per SM: 0.257 ms on 132 SMs at 1.98
// GHz, the larger of the two.  The accurate expf also costs 5 FP32
// instructions of range reduction, a shift and a scaling multiply, and
// each state-step two multiplies and two FMAs besides: 12 instructions a
// state-step (the SASS), 0.38 ms of issue at one a clock per scheduler.
//
// Design.  The channels d are independent; the states s of one channel
// share dt_t and u_t.  kLanes = ds / kStates lanes share a channel, each
// holding kSt = kStates of its states and their entries of A in
// registers for the whole sequence (float4s of B_t, C_t and h): at ds 16
// two lanes a channel, b * di * 2 = 65,536 threads at the serving shape,
// 16 warps an SM in one wave of 128-thread blocks at up to 128 registers
// a thread.  At ds 4 one lane holds the whole channel.  (One thread a
// channel with 16 states in registers and no staging, 8 warps an SM,
// took 1.5408 ms on an H100 80GB HBM3 at 700 W; four lanes a channel at
// 64 registers spilled and took 0.91 ms, one lane with the staging below
// 0.72, the same as two; PERF.md.)
//
// Time goes in chunks of kChunk steps.  A block covers kChannels
// channels of one batch row; each chunk's u and dt rows (kChannels
// values a step) and B_t, C_t are staged in a double-buffered shared
// tile by cp.async, the next chunk's copies in flight while this one is
// computed: as 16-byte pieces of each row when the rows are 16-byte
// aligned (a warp covers only 32 / kLanes channels, so a load a thread
// would waste most of each sector), else value by value.  Within a chunk
// each lane keeps its partial y (the sum over its own states) for every
// step, and at the chunk's end a transposed butterfly sums the lanes'
// partials: round r exchanges half of the remaining steps across lane
// xor 2^r (at ds 16 one round, 8 shuffles a chunk, not 16 for a sum
// every step), so each lane ends holding the complete y of kChunk /
// kLanes steps, to which it adds D * u.  y goes back through a shared
// tile as 16-byte pieces of each row, h_T as float4s.  No step is
// guarded: the last chunk is padded with identity steps (u = dt = 0, B =
// C = 0: exp(0) = 1 and a zero input, so h is unchanged), whose y is not
// stored.  Channels past di compute on zeros and store nothing.  expf is
// the accurate one: this file must never be built with --use_fast_math.
//
// What holds it back (benchmarks/scan_variants.py probes, PERF.md): the
// steps themselves.  Staging and stores alone take 0.24 ms, the steps
// without their exps 0.39, with them 0.71: the exps' 8 instructions a
// state-step, issued at ~55% of the schedulers' rate.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads a block
constexpr int kMinBlocks = 4;  // blocks an SM: 16 warps, <= 128 registers
constexpr int kChunk = 16;     // time steps staged at a time
constexpr int kStates = 8;     // states a lane, at most (float4s)

// lanes a channel at state dim ds: kStates states each, or all ds in one
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
  void* y;                     // [b, T, di] contiguous, u's dtype
  float* h_out;                // [b, di, ds]
  float* h_ck;                 // [b, chunks, di, ds] or null
  int64_t st[8];               // (b, t) strides of u, dt, B, C
  int di, seq;
  int rows16;                  // u, dt and y rows in 16-byte pieces
  int bc16;                    // B and C rows in 16-byte pieces
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
template <typename E>
__device__ __forceinline__ E zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// cp.async of `bytes` (4 or 16) from src to shared dst; with ok false
// nothing is read and dst is zero-filled (src must still be a valid
// address)
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int DS, typename E>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba_scan_fwd(const Params P) {
  constexpr int kLanes = lanes_of(DS);          // lanes a channel
  constexpr int kSt = DS / kLanes;              // states a lane
  constexpr int kChannels = kThreads / kLanes;  // channels a block
  constexpr int kRow = 2 * DS;                  // B_t then C_t
  constexpr int kRounds = kLanes == 8 ? 3 : kLanes == 4 ? 2 : kLanes == 2;
  constexpr int kMine = kChunk / kLanes;        // y steps a lane ends with
  constexpr int kUPiece = 16 / sizeof(E);       // u values a 16-byte piece
  static_assert(kSt % 4 == 0 && kLanes * kSt == DS &&
                (1 << kRounds) == kLanes && kMine >= 1,
                "whole float4s of states; 1, 2, 4 or 8 lanes a channel");
  __shared__ __align__(16) E su[2][kChunk][kChannels];
  __shared__ __align__(16) float sdt[2][kChunk][kChannels];
  __shared__ __align__(16) float sbc[2][kChunk][kRow];
  __shared__ __align__(16) E sy[kChunk][kChannels];

  const int tid = threadIdx.x;
  const int c = tid / kLanes;                   // channel in the block
  const int q = tid % kLanes;                   // this lane's states / kSt
  const int per_row = (P.di + kChannels - 1) / kChannels;
  const int bi = blockIdx.x / per_row;
  const int d0 = (blockIdx.x % per_row) * kChannels;
  const int nch = min(kChannels, P.di - d0);    // live channels
  const int d = d0 + c;
  const bool live = c < nch;
  const int seq = P.seq;

  const E* ub = static_cast<const E*>(P.u) + bi * P.st[0] + d0;
  const float* dtb = P.dt + bi * P.st[2] + d0;
  const float* Bb = P.B + bi * P.st[4];
  const float* Cb = P.C + bi * P.st[6];
  const int64_t sut = P.st[1], sdtt = P.st[3], sB = P.st[5], sC = P.st[7];

  // chunk t0 into buffer buf: zeros past T and past di.  A thread's
  // copies take the same (step, piece) slots in every chunk, so only the
  // chunk's offsets along T change from one chunk to the next.
  auto stage = [&](int buf, int t0) {
    const int64_t tu = t0 * sut, td = t0 * sdtt, tb = t0 * sB, tc = t0 * sC;
    if (P.rows16) {
      constexpr int kUP = kChannels / kUPiece, kDP = kChannels / 4;
#pragma unroll
      for (int n = tid; n < kChunk * kUP; n += kThreads) {
        const int i = n / kUP, ch = (n % kUP) * kUPiece;
        const bool ok = t0 + i < seq && ch < nch;
        copy_async<16>(&su[buf][i][ch], ok ? ub + tu + i * sut + ch : ub, ok);
      }
#pragma unroll
      for (int n = tid; n < kChunk * kDP; n += kThreads) {
        const int i = n / kDP, ch = (n % kDP) * 4;
        const bool ok = t0 + i < seq && ch < nch;
        copy_async<16>(&sdt[buf][i][ch], ok ? dtb + td + i * sdtt + ch : dtb,
                       ok);
      }
    } else {
#pragma unroll 4
      for (int n = tid; n < kChunk * kChannels; n += kThreads) {
        const int i = n / kChannels, ch = n % kChannels;
        const bool ok = t0 + i < seq && ch < nch;
        su[buf][i][ch] = ok ? ub[tu + i * sut + ch] : zero<E>();
        copy_async<4>(&sdt[buf][i][ch], ok ? dtb + td + i * sdtt + ch : dtb,
                      ok);
      }
    }
    if (P.bc16) {
      constexpr int kBP = kRow / 4;             // 16-byte pieces a step
#pragma unroll
      for (int n = tid; n < kChunk * kBP; n += kThreads) {
        const int i = n / kBP, s = (n % kBP) * 4;
        const bool ok = t0 + i < seq;
        const float* src = s < DS ? Bb + tb + i * sB + s
                                  : Cb + tc + i * sC + (s - DS);
        copy_async<16>(&sbc[buf][i][s], ok ? src : Bb, ok);
      }
    } else {
#pragma unroll
      for (int n = tid; n < kChunk * kRow; n += kThreads) {
        const int i = n / kRow, s = n % kRow;
        const bool ok = t0 + i < seq;
        const float* src = s < DS ? Bb + tb + i * sB + s
                                  : Cb + tc + i * sC + (s - DS);
        copy_async<4>(&sbc[buf][i][s], ok ? src : Bb, ok);
      }
    }
    copy_commit();
  };

  float A[kSt], h[kSt];
#pragma unroll
  for (int s = 0; s < kSt; ++s) {
    A[s] = live ? P.A[static_cast<int64_t>(d) * DS + kSt * q + s] : 0.0f;
    h[s] = 0.0f;
  }
  const float Dd = live ? P.D[d] : 0.0f;
  // the first step whose y this lane ends with (the butterfly's order)
  int mine0 = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    mine0 += ((q >> r) & 1) * (kChunk >> (r + 1));

  E* yb = static_cast<E*>(P.y) + static_cast<int64_t>(bi) * seq * P.di + d0;
  const int chunks = (seq + kChunk - 1) / kChunk;
  stage(0, 0);
  for (int ci = 0; ci < chunks; ++ci) {
    const int buf = ci & 1, t0 = ci * kChunk;
    // under autograd: the state at the start of each chunk, for the
    // backward (csrc/mamba_scan_bwd.cu)
    if (P.h_ck != nullptr && live) {
      float4* hc = reinterpret_cast<float4*>(
          P.h_ck + ((static_cast<int64_t>(bi) * chunks + ci) * P.di + d) * DS
          + kSt * q);
#pragma unroll
      for (int v = 0; v < kSt / 4; ++v)
        hc[v] = make_float4(h[4 * v], h[4 * v + 1], h[4 * v + 2],
                            h[4 * v + 3]);
    }
    if (ci + 1 < chunks)
      stage(buf ^ 1, t0 + kChunk);            // in flight during compute
    else
      copy_commit();                          // an empty group
    copy_wait<1>();                           // chunk ci's copies landed
    __syncthreads();

    // the chunk's steps: this lane's states, its partial y of each step
    float p[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float dtv = sdt[buf][i][c], uv = to_f32(su[buf][i][c]);
      const float du = dtv * uv;
      float acc = 0.0f;
#pragma unroll
      for (int v = 0; v < kSt / 4; ++v) {
        const float4 bq = *reinterpret_cast<const float4*>(
            &sbc[buf][i][kSt * q + 4 * v]);
        const float4 cq = *reinterpret_cast<const float4*>(
            &sbc[buf][i][DS + kSt * q + 4 * v]);
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& hs = h[4 * v + e];
          hs = fmaf(expf(dtv * A[4 * v + e]), hs, du * bv[e]);
          acc = fmaf(hs, cv[e], acc);
        }
      }
      p[i] = acc;
    }
    // transposed butterfly: round r keeps the lower or upper half of the
    // remaining steps (by bit r of q) and sends the other half to lane
    // xor 2^r, which keeps it
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int half = kChunk >> (r + 1);
      const bool upper = (q >> r) & 1;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = upper ? p[j] : p[j + half];
        const float keep = upper ? p[j + half] : p[j];
        p[j] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << r);
      }
    }
#pragma unroll
    for (int j = 0; j < kMine; ++j) {
      const int i = mine0 + j;
      store_f32(&sy[i][c], fmaf(Dd, to_f32(su[buf][i][c]), p[j]));
    }
    __syncthreads();

    // y rows of the chunk's steps before T, channels before di
    if (P.rows16) {
      constexpr int kYP = kChannels / kUPiece;
#pragma unroll
      for (int n = tid; n < kChunk * kYP; n += kThreads) {
        const int i = n / kYP, ch = (n % kYP) * kUPiece, t = t0 + i;
        if (t < seq && ch < nch)
          *reinterpret_cast<uint4*>(yb + static_cast<int64_t>(t) * P.di + ch) =
              *reinterpret_cast<const uint4*>(&sy[i][ch]);
      }
    } else {
#pragma unroll 4
      for (int n = tid; n < kChunk * kChannels; n += kThreads) {
        const int i = n / kChannels, ch = n % kChannels, t = t0 + i;
        if (t < seq && ch < nch)
          yb[static_cast<int64_t>(t) * P.di + ch] = sy[i][ch];
      }
    }
  }

  if (live) {
    float4* ho = reinterpret_cast<float4*>(
        P.h_out + (static_cast<int64_t>(bi) * P.di + d) * DS + kSt * q);
#pragma unroll
    for (int v = 0; v < kSt / 4; ++v)
      ho[v] = make_float4(h[4 * v], h[4 * v + 1], h[4 * v + 2], h[4 * v + 3]);
  }
}

template <int DS>
cudaError_t launch_ds(const Params& p, int bf16, int b, cudaStream_t stream) {
  constexpr int kChannels = kThreads / lanes_of(DS);
  const int blocks = b * ((p.di + kChannels - 1) / kChannels);
  if (bf16)
    mamba_scan_fwd<DS, __nv_bfloat16><<<blocks, kThreads, 0, stream>>>(p);
  else
    mamba_scan_fwd<DS, float><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: 8 int64 in elements, (batch, time) of u, dt, B, C.  u and y:
// 0 f32, 1 bf16; dt, B, C, A, D and h_out are f32; y and h_out fresh
// (16-byte aligned).  h_ck: null, or [b, ceil(T / 16), di, ds] f32
// (16-byte aligned) that the launch fills with the state at the start of
// each chunk (what the backward, csrc/mamba_scan_bwd.cu, steps forward
// from).  ds in {4, 16} (jamba's reduced and published d_state); other
// values return cudaErrorInvalidValue (the wrapper refuses them first).
int mamba_scan_forward_ck(const void* u, const float* dt, const float* B,
                          const float* C, const float* A, const float* D,
                          void* y, float* h_out, float* h_ck,
                          const int64_t* strides, int bf16, int b, int T,
                          int di, int ds, void* stream) {
  Params p;
  p.u = u;
  p.dt = dt;
  p.B = B;
  p.C = C;
  p.A = A;
  p.D = D;
  p.y = y;
  p.h_out = h_out;
  p.h_ck = h_ck;
  for (int i = 0; i < 8; ++i) p.st[i] = strides[i];
  p.di = di;
  p.seq = T;
  const int64_t esize = bf16 ? 2 : 4;
  // every row of u, dt and y, and each block's piece of it, starts on a
  // 16-byte boundary, and di is a whole number of pieces
  p.rows16 = aligned16(u) && aligned16(dt) && aligned16(y) &&
             (strides[0] * esize) % 16 == 0 &&
             (strides[1] * esize) % 16 == 0 && (strides[2] * 4) % 16 == 0 &&
             (strides[3] * 4) % 16 == 0 && (di * esize) % 16 == 0 &&
             di % 4 == 0;
  p.bc16 = aligned16(B) && aligned16(C) && (strides[4] * 4) % 16 == 0 &&
           (strides[5] * 4) % 16 == 0 && (strides[6] * 4) % 16 == 0 &&
           (strides[7] * 4) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(h_out) % 16 ||
      reinterpret_cast<uintptr_t>(h_ck) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 4: return launch_ds<4>(p, bf16, b, s);
    case 16: return launch_ds<16>(p, bf16, b, s);
    default: return cudaErrorInvalidValue;
  }
}

// mamba_scan_forward_ck without the chunk states (what serving launches)
int mamba_scan_forward(const void* u, const float* dt, const float* B,
                       const float* C, const float* A, const float* D,
                       void* y, float* h_out, const int64_t* strides,
                       int bf16, int b, int T, int di, int ds, void* stream) {
  return mamba_scan_forward_ck(u, dt, B, C, A, D, y, h_out, nullptr, strides,
                               bf16, b, T, di, ds, stream);
}

}  // extern "C"
