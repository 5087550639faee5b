// The backward of the WKV6 recurrence (B14's backward), for Hopper (sm_90a).
// Replaces the autodiff the reference's training takes through its
// chunked time mix, src/repro/models/rwkv.py::time_mix_chunked (:132),
// under jax.grad:
//
//   wkv6_backward <- jax.grad of time_mix_chunked's recurrence
//
// r, k, v, w, do [b, h, T, hd] f32 (w the decay), u [h, hd] f32, and the
// forward's state at the start of each chunk of kChunk steps, [b * h,
// ceil(T / kChunk), hd, hd] f32 (csrc/wkv6.cu writes it under autograd).
// Per (b, h), with S_{t-1} the state before step t and G_t the gradient
// w.r.t. S_t (G_{T-1} = 0; the final state is not differentiated):
//
//   dr_t    = (S_{t-1} + u k_t v_t^T) do_t
//   dk_t    = (G_t + u r_t do_t^T) v_t
//   dv_t    = (G_t + u r_t do_t^T)^T k_t
//   dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//   du     += r_t k_t (v_t . do_t)          (a partial [hd] per (b, h))
//   G_{t-1} = w_t G_t + r_t do_t^T          (row-scaled)
//
// dr, dk, dv, dw are stored in f32 by their (b, h, t) strides, the du
// partials [b * h, hd] in f32; the wrapper sums the partials over b in a
// fixed order.  No float atomics: every sum has one order, so two runs
// are bit-equal.
//
// The states are stepped forward from the chunk's checkpoint, never
// recovered backward as S_{t-1} = (S_t - k v^T) / w_t: a decay
// underflows to 0 once exp(-exp(ww)) passes ww ~4.5 (csrc/wkv6.cu), and
// nothing is left to divide.  Nor is dw taken by the suffix-sum identity
// for d log w, which subtracts two large sums and divides by w.
//
// Bound on the H100 at rwkv6-1.6b's training shape (b 8, h 32, T 128, hd
// 64): r, k, v, w, do in and dr, dk, dv, dw out, 8.4 MB each, and the
// checkpoints 33.6 MB: 109 MB, 0.033 ms at 3.35 TB/s; about 6 FMAs per
// (i, j) and step (the state step, G's step, dr, dk, dv, dw), 1.6 GFLOP,
// 0.024 ms at 67 TFLOP/s on the CUDA cores.  Measured (chip_smoke.py
// 15a, PERF.md): 0.353 ms, 9% of the bound.
//
// Design: a simple one first.  One block a (b, h) walks the chunks in
// reverse; 4 lanes a row i of the state, each holding hd / 4 columns j =
// 4 (c + 4 q) + e (c the lane's quarter) of G in registers, so a warp
// covers 8 rows and its float4 loads of v_t and do_t fall in distinct
// banks.  A chunk's r, k, w, v, do are staged in shared memory (identity
// steps past T: r = k = v = do = 0, w = 1).  A chunk is walked in kSub
// steps at a time: each lane steps its own tile of the state forward from
// the chunk's checkpoint (S <- w_t S + k_t v_t^T), stashes S_{t-1} for the
// sub-walk's steps in shared memory (its own slots: no barrier), then
// walks them in reverse.  Per step a lane forms its partial sums over its
// columns; the row sums (dr, dk, dw and v . do) take a transposed
// butterfly over the row's 4 lanes (3 shuffles: each lane ends with one
// of the four), the column sums (dv) one over the warp's 8 rows, then
// the warps' partials are summed in warp order after the sub-walk.  The
// second sub-walk of a chunk recomputes the first's steps: 24 state
// steps a chunk of 16.  At hd 64 the stash of 8 states takes 128 KB, one
// block an SM.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kChunk = 16;   // csrc/wkv6.cu's chunk: the checkpoint spacing
constexpr int kSub = 8;      // steps stashed and walked at a time
constexpr int kRowLanes = 4;  // lanes a row of the state

struct Params {
  const float* in[5];          // r, k, w, v, do by (b, h, t) strides
  const float* u;              // [h, hd]
  const float* states;         // [b * h, chunks, hd, hd]
  float* out[4];               // dr, dk, dw, dv by (b, h, t) strides
  float* du_part;              // [b * h, hd]
  int64_t st[27];              // (b, h, t) strides of in[0..4], out[0..3]
  int h, seq;
};

template <int HD>
struct Layout {
  static constexpr int NT = HD * kRowLanes;       // threads a block
  static constexpr int JW = HD / kRowLanes;       // columns a lane
  static constexpr int NV = JW / 4;               // float4s a lane
  static constexpr int NW = NT / 32;              // warps
  static constexpr int C = kChunk, L = kSub;
  // shared memory in floats: the chunk's inputs [5][C][HD]; the stash
  // [L][NV][NT] float4s; the row sums [3][L][HD] (dr, dk, dw); the warps'
  // column partials [L][NW][HD] (dv)
  static constexpr int kIn = 0, kStash = 5 * C * HD;
  static constexpr int kRows = kStash + L * HD * HD;
  static constexpr int kCols = kRows + 3 * L * HD;
  static constexpr int kFloats = kCols + L * NW * HD;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(JW % 4 == 0 && C % L == 0 && NT % 32 == 0,
                "whole float4s a lane, whole sub-walks a chunk");
};

// the column sums of a warp: round R halves the N values left across
// lane xor (4 << R) (the warp's rows), keeping the lower or upper half by
// that lane bit; once one value is left, a plain sum.  base gains the
// offset of the half kept.
template <int N, int R>
__device__ __forceinline__ void column_rounds(float* x, int lane, int& base) {
  if constexpr (R < 3) {
    constexpr int bit = 4 << R;
    if constexpr (N > 1) {
      constexpr int half = N / 2;
      const bool upper = lane & bit;
#pragma unroll
      for (int m = 0; m < half; ++m) {
        const float send = upper ? x[m] : x[m + half];
        const float keep = upper ? x[m + half] : x[m];
        x[m] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
      }
      if (upper) base += half;
      column_rounds<half, R + 1>(x, lane, base);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], bit);
      column_rounds<1, R + 1>(x, lane, base);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::NT, 1)
wkv6_bwd_kernel(const Params P) {
  using Lt = Layout<HD>;
  constexpr int NT = Lt::NT, JW = Lt::JW, NV = Lt::NV, NW = Lt::NW;
  constexpr int C = Lt::C, L = Lt::L;
  // values left a lane after the column rounds, and whether a lane's are
  // another lane's copies (a plain round over lane bit 16)
  constexpr int kLeft = JW >= 8 ? JW / 8 : 1;
  constexpr bool kDup16 = JW < 8;
  extern __shared__ __align__(16) float sm[];
  float* const in_s = sm + Lt::kIn;
  float4* const stash = reinterpret_cast<float4*>(sm + Lt::kStash);
  float* const rows_s = sm + Lt::kRows;
  float* const cols_s = sm + Lt::kCols;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / kRowLanes, cq = tid % kRowLanes;
  const int bh = blockIdx.x, bi = bh / P.h, hi = bh % P.h;
  const int seq = P.seq, chunks = (seq + C - 1) / C;
  const float* src[5];
  int64_t ts[5];
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    src[a] = P.in[a] + bi * P.st[3 * a] + hi * P.st[3 * a + 1];
    ts[a] = P.st[3 * a + 2];
  }
  float* dst[4];
  int64_t tds[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    dst[a] = P.out[a] + bi * P.st[15 + 3 * a] + hi * P.st[16 + 3 * a];
    tds[a] = P.st[17 + 3 * a];
  }
  const float ui = P.u[hi * HD + i];
  const float* const ck =
      P.states + static_cast<int64_t>(bh) * chunks * HD * HD;
  // this lane's column of float4 q
  auto col = [&](int q) { return 4 * (cq + kRowLanes * q); };
  auto row_of = [&](int a, int t) { return in_s + (a * C + t) * HD; };
  auto cols4 = [&](const float* p, float (&x)[JW]) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const float4 y = *reinterpret_cast<const float4*>(p + col(q));
      x[4 * q] = y.x;
      x[4 * q + 1] = y.y;
      x[4 * q + 2] = y.z;
      x[4 * q + 3] = y.w;
    }
  };
  // S <- w_t S + k_t v_t^T on this lane's tile
  auto step = [&](float (&S)[JW], int t) {
    float v[JW];
    cols4(row_of(3, t), v);
    const float kk = row_of(1, t)[i], ww = row_of(2, t)[i];
#pragma unroll
    for (int e = 0; e < JW; ++e) S[e] = fmaf(ww, S[e], kk * v[e]);
  };

  float G[JW];
#pragma unroll
  for (int e = 0; e < JW; ++e) G[e] = 0.0f;
  float du_acc = 0.0f;

  for (int ch = chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * C;
    __syncthreads();                  // the last chunk's readers are done
    for (int n = tid; n < 5 * C * HD; n += NT) {
      const int a = n / (C * HD), t = t0 + (n / HD) % C, j = n % HD;
      in_s[n] = t < seq ? src[a][t * ts[a] + j] : (a == 2 ? 1.0f : 0.0f);
    }
    float S0[JW];
    {
      const float* p = ck + (static_cast<int64_t>(ch) * HD + i) * HD;
      cols4(p, S0);
    }
    __syncthreads();
    for (int sw = C / L - 1; sw >= 0; --sw) {
      float S[JW];
#pragma unroll
      for (int e = 0; e < JW; ++e) S[e] = S0[e];
      for (int t = 0; t < sw * L; ++t) step(S, t);
#pragma unroll
      for (int l = 0; l < L; ++l) {   // stash S_{t-1} of the sub-walk
#pragma unroll
        for (int q = 0; q < NV; ++q)
          stash[(l * NV + q) * NT + tid] =
              make_float4(S[4 * q], S[4 * q + 1], S[4 * q + 2], S[4 * q + 3]);
        if (l + 1 < L) step(S, sw * L + l);
      }
#pragma unroll 1
      for (int l = L - 1; l >= 0; --l) {
        const int t = sw * L + l;
        const float rr = row_of(0, t)[i], kk = row_of(1, t)[i];
        const float ww = row_of(2, t)[i];
        float v[JW], dd[JW], Sp[JW], dv[JW];
        cols4(row_of(3, t), v);
        cols4(row_of(4, t), dd);
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const float4 y = stash[(l * NV + q) * NT + tid];
          Sp[4 * q] = y.x;
          Sp[4 * q + 1] = y.y;
          Sp[4 * q + 2] = y.z;
          Sp[4 * q + 3] = y.w;
        }
        const float uk = ui * kk, ur = ui * rr;
        float pr = 0.0f, pk = 0.0f, pw = 0.0f, pvd = 0.0f;
#pragma unroll
        for (int e = 0; e < JW; ++e) {
          const float sh = fmaf(uk, v[e], Sp[e]);      // S_{t-1} + u k v
          const float gh = fmaf(ur, dd[e], G[e]);      // G_t + u r do
          pr = fmaf(sh, dd[e], pr);
          pk = fmaf(gh, v[e], pk);
          pw = fmaf(G[e], Sp[e], pw);
          pvd = fmaf(v[e], dd[e], pvd);
          dv[e] = gh * kk;
          G[e] = fmaf(ww, G[e], rr * dd[e]);
        }
        // the row's 4 lanes: quarter 0 ends with dr, 2 with dk, 1 with
        // dw, 3 with v . do
        const bool up1 = cq & 1, up2 = cq & 2;
        const float x0 = (up1 ? pw : pr)
                         + __shfl_xor_sync(0xffffffffu, up1 ? pr : pw, 1);
        const float x1 = (up1 ? pvd : pk)
                         + __shfl_xor_sync(0xffffffffu, up1 ? pk : pvd, 1);
        const float y = (up2 ? x1 : x0)
                        + __shfl_xor_sync(0xffffffffu, up2 ? x0 : x1, 2);
        if (cq == 3)
          du_acc = fmaf(rr * kk, y, du_acc);
        else
          rows_s[((cq == 0 ? 0 : cq == 2 ? 1 : 2) * L + l) * HD + i] = y;
        // the warp's 8 rows, then the warps in order after the sub-walk
        int base = 0;
        column_rounds<JW, 0>(dv, lane, base);
        if (!kDup16 || !(lane & 16))
#pragma unroll
          for (int m = 0; m < kLeft; ++m) {
            const int s = base + m;
            cols_s[(l * NW + warp) * HD + 4 * (cq + kRowLanes * (s / 4))
                   + s % 4] = dv[m];
          }
      }
      __syncthreads();
      for (int n = tid; n < 3 * L * HD; n += NT) {
        const int a = n / (L * HD), t = t0 + sw * L + (n / HD) % L;
        if (t < seq) dst[a][t * tds[a] + n % HD] = rows_s[n];
      }
      for (int n = tid; n < L * HD; n += NT) {
        const int l = n / HD, j = n % HD, t = t0 + sw * L + l;
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < NW; ++w) sum += cols_s[(l * NW + w) * HD + j];
        if (t < seq) dst[3][t * tds[3] + j] = sum;
      }
      __syncthreads();
    }
  }
  if (cq == 3) P.du_part[static_cast<int64_t>(bh) * HD + i] = du_acc;
}

template <int HD>
cudaError_t launch_hd(const Params& p, int blocks, cudaStream_t stream) {
  using Lt = Layout<HD>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = once_a_device(configured, [] {
    return cudaFuncSetAttribute(wkv6_bwd_kernel<HD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Lt::kBytes));
  });
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<HD><<<blocks, Lt::NT, Lt::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: 27 int64 in elements, (batch, head, time) of r, k, w, v, do,
// dr, dk, dw, dv (each with a unit stride on hd); every tensor f32.
// states: [b * h, ceil(T / 16), hd, hd], the forward's chunk-start
// states; du_part [b * h, hd].  hd in {16, 64}; other values return
// cudaErrorInvalidValue (the wrapper refuses them first).  The grid is
// b * h blocks.
int wkv6_backward(const float* r, const float* k, const float* w,
                  const float* v, const float* dout, const float* u,
                  const float* states, float* dr, float* dk, float* dw,
                  float* dv, float* du_part, const int64_t* strides, int b,
                  int h, int T, int hd, void* stream) {
  Params p;
  p.in[0] = r;
  p.in[1] = k;
  p.in[2] = w;
  p.in[3] = v;
  p.in[4] = dout;
  p.u = u;
  p.states = states;
  p.out[0] = dr;
  p.out[1] = dk;
  p.out[2] = dw;
  p.out[3] = dv;
  p.du_part = du_part;
  for (int n = 0; n < 27; ++n) p.st[n] = strides[n];
  p.h = h;
  p.seq = T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(p, b * h, s);
    case 64: return launch_hd<64>(p, b * h, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
