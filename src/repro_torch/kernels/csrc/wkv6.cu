// The WKV6 recurrence (RWKV-6 "Finch" time mix), for Hopper (sm_90a).
// Replaces one Pallas kernel of src/repro/kernels/rwkv6_scan.py:
//
//   wkv6_forward <- wkv6 (:46), _wkv6_kernel (:19)
//
// r, k, v, w [b, h, T, hd] (w the decay in [0, 1]), u [h, hd] f32.  Per
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
// Bound on the H100 at the serving shape (b 4, h 32, T 2,048, hd 64,
// f32): 4 inputs and out of 67.1 MB each plus S_T 2.1 MB = 337.6 MB, or
// 0.101 ms at 3.35 TB/s; about 3 * 4,096 FMAs per step per chain, 6.44
// GFLOP, 0.096 ms at 67 TFLOP/s on the CUDA cores.  The step-by-step
// form (one 4 * hd-thread block a (b, h), 128 blocks on 132 SMs, a
// dependent FMA chain and two shuffles a step) left each SM 8 warps and
// nothing to hide their latencies: 0.63-0.64 ms.
//
// Design: the chunked form (the reference prefill's time_mix_chunked,
// repro/models/rwkv.py:132-177) in f32 on the CUDA cores, one launch.
// For a chunk of C steps from state S (local steps tau, sigma):
//
//   c_tau[i]   = prod_{m <= tau} w_m[i]                 (c_{-1} = 1)
//   P_i(s, t)  = prod_{s < m < t} w_m[i]
//   A[t, s]    = sum_i r_t[i] k_s[i] P_i(s, t)  (s < t);
//   A[t, t]    = sum_i r_t[i] u[i] k_t[i]                (the bonus)
//   out_t[j]   = sum_i (r_t[i] c_{t-1}[i]) S[i,j] + sum_{s <= t} A[t,s] v_s[j]
//   S[i,j]    <- c_{C-1}[i] S[i,j] + sum_s (k_s[i] P_i(s, C)) v_s[j]
//
// Every decay is a running product in linear space: no log w, no
// division by a cumulative decay, no exp of a difference.  A decay of 0
// (w = exp(-exp(ww)) underflows once ww passes ~4.5) gives 0, as the
// step-by-step form does, and never NaN or inf; a factorisation through a
// chunk-wide reference point would overflow for strong decays.  The sums
// associate differently from the step-by-step form: about C ulps.
//
// One block of 256 threads (8 warps) takes a (b, h): 128 blocks at the
// serving shape, one an SM.  A block walks its chunks in order; no state
// passes between blocks.  Per chunk of C = 16 steps:
//   1. rd = r * c_{t-1} and c_{C-1}: four lanes a column i, each over 4
//      steps, their partial products joined by a multiplicative scan
//      across the lanes.  The intra walk: warp p takes the pair of
//      sources p and C-1-p (C-1 steps together, so every warp does the
//      same work), two i's a lane, carries k_s[i] P_i(s, t) forward in
//      registers (one multiply by w_t a step; the pair shares each load
//      of r_t and w_t) in straight-line code (the pair is a compile-time
//      constant of the warp's branch), and leaves each lane's partial
//      dot product in shared memory; the walk ends with
//      k_s[i] P_i(s, C) for the state update.
//   2. A = the sum of the 32 lanes' partials; S <- c_{C-1} S + kd^T v,
//      S held in registers a 4 x 4 tile a thread.
//   3. out = rd . S + A . v: each 4 x 4 output tile is summed over four
//      quarters of i (and of s) by four lanes, joined by two shuffles.
// Shared memory returns 128 bytes a clock to the registers (a float4
// load of a warp takes 4), so the products are tiled for bytes an FMA:
// 2 for the 4 x 4 tiles, where a 1 x 4 output tile a thread takes 5 (and
// that product alone then takes 0.19 ms of 0.44).  The steps are
// pipelined two barriers a chunk: [2 and the inter product of chunk c] |
// [the intra product and store of chunk c, 1 of chunk c+1]; r, k, w, v
// of the chunk after next are loaded into registers (16-byte loads where
// the rows allow) while this one computes, and stored to shared memory
// after the last read of the buffer they replace (rd, v and S are
// double-buffered).  Steps past T are the identity step, r = k = v = 0,
// w = 1.  Rows in shared memory are padded by 4 floats, so the loads of
// a warp that span rows fall in distinct banks.
//
// Measured on the H100 (src/repro_torch/benchmarks/wkv6_variants.py, the
// step-by-step kernel it replaces timed in the same turns): 0.37 ms at
// the serving shape against 0.63, 27% of the bound.  The chunk length
// and the threads a block (Geometry below) were chosen there (PERF.md);
// splitting a head's columns over several blocks, each recomputing A and
// restaging r, k and w, was slower and is not built.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "smem.cuh"

namespace {

// chunk length and threads a block for head dim HD
template <int HD>
struct Geometry;
template <>
struct Geometry<64> {
  static constexpr int kChunk = 16, kThreads = 256;
};
template <>
struct Geometry<16> {
  static constexpr int kChunk = 16, kThreads = 64;
};

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

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// W consecutive floats of shared memory at p (aligned to min(W, 4) floats)
template <int W>
__device__ __forceinline__ void lds(const float* p, float (&x)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) x[q] = p[q];
  }
}

// W consecutive elements of global memory at p (aligned to W elements for
// W = 4) into floats
template <int W>
__device__ __forceinline__ void load_n(const float* p, float* x) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = p[c];
  }
}
template <int W>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float* x) {
  if constexpr (W == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) x[c] = __bfloat162float(p[c]);
  }
}
// W floats to shared memory at p (aligned to W floats for W = 4)
template <int W>
__device__ __forceinline__ void sts_n(float* p, const float* x) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
#pragma unroll
    for (int c = 0; c < W; ++c) p[c] = x[c];
}

// the intra walk's partial sums are kept for t >= s at t (t + 1) / 2 + s
__host__ __device__ constexpr int tri(int t, int s) {
  return t * (t + 1) / 2 + s;
}

// f(integral_constant<P>) for the runtime p in [P, N)
template <int P, int N, typename F>
__device__ __forceinline__ void for_pair(int p, F& f) {
  if constexpr (P < N) {
    if (p == P)
      f(std::integral_constant<int, P>{});
    else
      for_pair<P + 1, N>(p, f);
  }
}

// a warp's lanes over a grid of ROWS x COLS thread tiles: 32 / WC rows by
// WC columns a warp, the warps row-major over the grid
template <int ROWS, int COLS, int NT>
struct WarpGrid {
  static constexpr int WC = COLS < 4 ? COLS : 4, WR = 32 / WC;
  static_assert(ROWS % WR == 0 && COLS % WC == 0 &&
                    (ROWS / WR) * (COLS / WC) * 32 == NT,
                "warp tiles cover the grid");
  __device__ static int row(int tid) {
    return (tid / 32) / (COLS / WC) * WR + (tid % 32) / WC;
  }
  __device__ static int col(int tid) {
    return (tid / 32) % (COLS / WC) * WC + tid % WC;
  }
};

template <int HD>
struct Layout {
  using G = Geometry<HD>;
  static constexpr int C = G::kChunk, NT = G::kThreads;
  static constexpr int LD = HD + 4;          // row of r, k, w, v, rd, kd, S
  static constexpr int LA = C + 4;           // row of A
  // staging: loads a thread a chunk of each of r, k, w, v
  static constexpr int kPer = C * HD / NT;
  // the intra walk: source pairs, threads a pair (a warp at hd 64), i's a
  // thread
  static constexpr int kPairs = C / 2, kGroup = NT / kPairs;
  static constexpr int kIntra = HD / kGroup;
  static constexpr int kIntraVec = kIntra < 4 ? kIntra : 4;
  // outputs: a 4 x 4 tile over a quarter of the sum a thread (4 lanes a
  // tile); state: an IR x JE tile a thread
  static constexpr int kTilesJ = HD / 4;
  static constexpr int kState = HD * HD / NT;
  static constexpr int JE = 4, IR = kState / JE;
  using StateGrid = WarpGrid<HD / IR, HD / JE, NT>;
  // shared memory in floats: r, k, w, kd [C][LD]; rd [2][C][LD]; v
  // [2][C][LD]; S [2][HD][LD]; A [C][LA]; c_{C-1} [HD]; the walk's
  // partial sums [C (C + 1) / 2][kApRow]
  static constexpr int kR = 0, kK = C * LD, kW = 2 * C * LD;
  static constexpr int kKd = 3 * C * LD, kRd = 4 * C * LD;
  static constexpr int kV = 6 * C * LD, kS = kV + 2 * C * LD;
  static constexpr int kA = kS + 2 * HD * LD, kCc = kA + C * LA;
  static constexpr int kAp = kCc + HD;
  // a row of partials: whole float4s, rows 4 banks apart
  static constexpr int kApRow = kGroup % 4 == 0 ? kGroup + 4 : kGroup + 1;
  static constexpr int kFloats = kAp + tri(C, 0) * kApRow;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(C % 4 == 0 && HD % 4 == 0, "rows of whole float4s");
  static_assert(kPer * NT == C * HD, "staging");
  static_assert(kGroup * kPairs == NT && kIntra * kGroup == HD &&
                    kIntra % kIntraVec == 0 && NT >= HD,
                "the intra walk: a group of lanes a pair");
  static_assert(NT * 4 == C * HD && (HD / 4) % 4 == 0,
                "4 lanes a 4 x 4 output tile cover [C][HD]");
  static_assert(IR >= 1 && IR * JE == kState && (IR <= 2 || IR % 4 == 0),
                "state tiles cover [HD][HD]");
};

// one block an SM is all the grid needs: without the 1, ptxas holds the
// kernel near 100 registers (a spill at hd 16 in bf16) and it runs slower
template <int HD, typename E>
__global__ void __launch_bounds__(Geometry<HD>::kThreads, 1)
wkv6_chunked(const Params P) {
  using L = Layout<HD>;
  constexpr int C = L::C, NT = L::NT, LD = L::LD;
  constexpr int LA = L::LA, GP = L::kApRow;
  extern __shared__ __align__(16) float sm[];
  float* const r_s = sm + L::kR;
  float* const k_s = sm + L::kK;
  float* const w_s = sm + L::kW;
  float* const kd_s = sm + L::kKd;
  float* const rd_s = sm + L::kRd;           // [2]: chunks alternate
  float* const v_s = sm + L::kV;             // [2]
  float* const s_s = sm + L::kS;             // [2]: S at each chunk's start
  float* const a_s = sm + L::kA;
  float* const cc_s = sm + L::kCc;
  float* const ap_s = sm + L::kAp;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int bi = bh / P.h, hi = bh % P.h;
  // r, k, w, v by their (b, h, t) strides (P.st holds r, k, v, w)
  const E* src[4];
  int64_t ts[4];
  const void* bases[4] = {P.r, P.k, P.w, P.v};
  const int order[4] = {0, 1, 3, 2};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t* s = P.st + 3 * order[a];
    src[a] = static_cast<const E*>(bases[a]) + bi * s[0] + hi * s[1];
    ts[a] = s[2];
  }
  E* const out = static_cast<E*>(P.out) + bi * P.st[12] + hi * P.st[13];
  const int64_t out_ts = P.st[14];

  // S starts at 0; A's upper triangle stays 0 (only t >= s is written)
  for (int n = tid; n < HD * LD; n += NT) s_s[n] = 0.0f;
  for (int n = tid; n < C * LA; n += NT) a_s[n] = 0.0f;

  // ---- staging: chunk t0's values for this thread's slots; past T the
  // identity step (r = k = v = 0, w = 1).  Where every row starts on a
  // 4-element boundary (the rows of a [b, T, h, hd] buffer do), a slot is
  // 4 consecutive elements in one load (16 bytes in f32, 8 in bf16)
  bool vec = true;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    vec = vec && reinterpret_cast<uintptr_t>(src[a]) % (4 * sizeof(E)) == 0
          && ts[a] % 4 == 0;
  float pf[4 * L::kPer];
  // W elements a slot: r, k, w, v [C][HD], slot n of this thread at
  // element (n NT + tid) W
  auto fetch_w = [&](auto wc, int t0) {
    constexpr int W = decltype(wc)::value;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int n = 0; n < L::kPer / W; ++n) {
        const int e = (n * NT + tid) * W, t = t0 + e / HD, i = e % HD;
        float* x = pf + a * L::kPer + W * n;
        if (t < P.seq)
          load_n<W>(src[a] + t * ts[a] + i, x);
        else
#pragma unroll
          for (int c = 0; c < W; ++c) x[c] = a == 2 ? 1.0f : 0.0f;
      }
  };
  auto stash_w = [&](auto wc, int buf) {
    constexpr int W = decltype(wc)::value;
    float* const dst[4] = {r_s, k_s, w_s, v_s + buf * C * LD};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int n = 0; n < L::kPer / W; ++n) {
        const int e = (n * NT + tid) * W;
        sts_n<W>(dst[a] + (e / HD) * LD + e % HD, pf + a * L::kPer + W * n);
      }
  };
  constexpr int kVec = L::kPer % 4 == 0 ? 4 : 1;
  auto fetch = [&](int t0) {
    if (vec)
      fetch_w(std::integral_constant<int, kVec>{}, t0);
    else
      fetch_w(std::integral_constant<int, 1>{}, t0);
  };
  auto stash = [&](int buf) {
    if (vec)
      stash_w(std::integral_constant<int, kVec>{}, buf);
    else
      stash_w(std::integral_constant<int, 1>{}, buf);
  };

  // ---- the intra walk's thread: pair p (sources p and C-1-p), lane g of
  // its group, i = V (g + kGroup q) + c for q < kIntra / V, c < V
  constexpr int V = L::kIntraVec, NQ = L::kIntra / V, NI = L::kIntra;
  const int p = tid / L::kGroup, g = tid % L::kGroup;
  float uu[NI];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int c = 0; c < V; ++c)
      uu[V * q + c] = P.u[hi * HD + V * (g + L::kGroup * q) + c];
  auto row = [&](const float* base, int t, float (&x)[NI]) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float y[V];
      lds<V>(base + t * LD + V * (g + L::kGroup * q), y);
#pragma unroll
      for (int c = 0; c < V; ++c) x[V * q + c] = y[c];
    }
  };
  // the pair of sources s1 < s2 = C-1-s1, known at compile time: s1's
  // bonus, then t = s1+1 .. C-1 carrying k_s P(s, t) forward for s1 and,
  // from t = s2 (its bonus) on, for s2 too, one load of r_t and w_t a
  // step (straight-line code)
  auto pair = [&](auto pc) {
    constexpr int s1 = decltype(pc)::value, s2 = C - 1 - s1;
    auto put = [&](int t, int s, float part) {
      ap_s[tri(t, s) * GP + g] = part;
    };
    float kd1[NI], kd2[NI], x[NI];
    row(k_s, s1, kd1);
    row(k_s, s2, kd2);
    row(r_s, s1, x);
    float b = 0.0f;
#pragma unroll
    for (int e = 0; e < NI; ++e) b = fmaf(x[e], uu[e] * kd1[e], b);
    put(s1, s1, b);
#pragma unroll
    for (int t = s1 + 1; t < C; ++t) {
      float ww[NI];
      row(r_s, t, x);
      row(w_s, t, ww);
      float part = 0.0f;
#pragma unroll
      for (int e = 0; e < NI; ++e) {
        part = fmaf(x[e], kd1[e], part);
        kd1[e] *= ww[e];
      }
      put(t, s1, part);
      if (t == s2) {
        part = 0.0f;
#pragma unroll
        for (int e = 0; e < NI; ++e) part = fmaf(x[e], uu[e] * kd2[e], part);
        put(t, s2, part);
      } else if (t > s2) {
        part = 0.0f;
#pragma unroll
        for (int e = 0; e < NI; ++e) {
          part = fmaf(x[e], kd2[e], part);
          kd2[e] *= ww[e];
        }
        put(t, s2, part);
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int c = 0; c < V; ++c) {
        kd_s[s1 * LD + V * (g + L::kGroup * q) + c] = kd1[V * q + c];
        kd_s[s2 * LD + V * (g + L::kGroup * q) + c] = kd2[V * q + c];
      }
  };
  // 1. rd = r * c_{t-1} and c_{C-1}, the running product down column i:
  // kSpan threads a column, each over C / kSpan consecutive steps, their
  // partial products joined by a multiplicative scan across the span's
  // neighbouring lanes; and the intra walk
  constexpr int kSpan = NT / HD, kSteps = C / kSpan;
  static_assert(kSpan * HD == NT && kSteps * kSpan == C && kSpan <= 32 &&
                    (kSpan & (kSpan - 1)) == 0,
                "a power-of-two span of lanes a column");
  const int ci = tid / kSpan, cq = tid % kSpan;
  auto phase1 = [&](int buf) {
    {
      float* const rd = rd_s + buf * C * LD;
      float lp[kSteps], c = 1.0f;
#pragma unroll
      for (int m = 0; m < kSteps; ++m) {
        lp[m] = c;
        c *= w_s[(cq * kSteps + m) * LD + ci];
      }
      // exclusive product of the earlier spans' totals
      float incl = c;
#pragma unroll
      for (int off = 1; off < kSpan; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off, kSpan);
        if (cq >= off) incl *= y;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1, kSpan);
      if (cq == 0) before = 1.0f;
#pragma unroll
      for (int m = 0; m < kSteps; ++m) {
        const int t = cq * kSteps + m;
        rd[t * LD + ci] = r_s[t * LD + ci] * (before * lp[m]);
      }
      if (cq == kSpan - 1) cc_s[ci] = incl;
    }
    for_pair<0, C / 2>(p, pair);
  };

  // ---- the output tile: rows 4 tt + a, columns 4 jt + c, summed over
  // the quarter kq of i (i = 4 (kq + 4 n) + e) and of s (s = 4 (kq + 4 n)
  // + e); a warp's 8 tiles share their rows
  const int kq = tid % 4, tile = tid / 4;
  const int tt = tile / L::kTilesJ, jt = tile % L::kTilesJ;
  // ---- the state tile: rows ig * IR + a, columns je * JE + c, in registers
  constexpr int JE = L::JE, IR = L::IR;
  const int ig = L::StateGrid::row(tid), je = L::StateGrid::col(tid);
  float S[IR][JE];
#pragma unroll
  for (int a = 0; a < IR; ++a)
#pragma unroll
    for (int c = 0; c < JE; ++c) S[a][c] = 0.0f;

  // 2. A = the walk's partial sums; S <- c_{C-1} S + kd^T v, kept in
  // registers and written to the other S buffer
  auto phase2 = [&](int buf) {
    for (int n = tid; n < C * C; n += NT) {
      const int t = n / C, s = n % C;
      if (s <= t) {
        const float* part = ap_s + tri(t, s) * GP;
        float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (L::kGroup % 4 == 0) {
#pragma unroll
          for (int q = 0; q < L::kGroup; q += 4) {
            float x[4];
            lds<4>(part + q, x);
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[e] += x[e];
          }
        } else {
#pragma unroll
          for (int q = 0; q < L::kGroup; ++q) sum[q % 4] += part[q];
        }
        a_s[t * LA + s] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
      }
    }
    const float* const v = v_s + buf * C * LD;
#pragma unroll
    for (int a = 0; a < IR; ++a) {
      const float cc = cc_s[ig * IR + a];
#pragma unroll
      for (int c = 0; c < JE; ++c) S[a][c] *= cc;
    }
#pragma unroll
    for (int s = 0; s < C; ++s) {
      float kv[IR], vv[JE];
      lds<IR>(kd_s + s * LD + ig * IR, kv);
      lds<JE>(v + s * LD + je * JE, vv);
#pragma unroll
      for (int a = 0; a < IR; ++a)
#pragma unroll
        for (int c = 0; c < JE; ++c) S[a][c] = fmaf(kv[a], vv[c], S[a][c]);
    }
    float* const sn = s_s + (buf ^ 1) * HD * LD;
#pragma unroll
    for (int a = 0; a < IR; ++a)
#pragma unroll
      for (int c = 0; c < JE; ++c)
        sn[(ig * IR + a) * LD + je * JE + c] = S[a][c];
  };
  // 3. out_t[j] = sum_i rd[t][i] S[i][j] + sum_s A[t][s] v[s][j]: the
  // inter product (3a) beside phase 2, the intra product, the sum of the
  // four quarters and the store (3b) beside the next chunk's phase 1.
  // Each 4 x 4 tile loads 8 floats for 16 FMAs (shared memory returns
  // 128 bytes a clock: the wider the tile, the fewer bytes an FMA)
  float acc[4][4];
  auto tile_sum = [&](const float* x, int lx, const float* y, int ly,
                      auto steps) {
    constexpr int kBlocks = decltype(steps)::value / 4;
#pragma unroll
    for (int n = 0; n < (kBlocks + 3) / 4; ++n) {
      const int b = kq + 4 * n;
      if (kBlocks % 4 != 0 && b >= kBlocks) break;
      float xs[4][4], ys[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) lds<4>(x + (4 * tt + a) * lx + 4 * b, xs[a]);
#pragma unroll
      for (int e = 0; e < 4; ++e) lds<4>(y + (4 * b + e) * ly + 4 * jt, ys[e]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][c] = fmaf(xs[a][e], ys[e][c], acc[a][c]);
    }
  };
  auto phase3a = [&](int buf) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
    tile_sum(rd_s + buf * C * LD, LD, s_s + buf * HD * LD, LD,
             std::integral_constant<int, HD>{});
  };
  auto phase3b = [&](int buf, int t0) {
    tile_sum(a_s, LA, v_s + buf * C * LD, LD,
             std::integral_constant<int, C>{});
    // the four quarters' sums: lane kq ends with row kq of the tile
    const bool hi2 = kq & 2, hi1 = kq & 1;
    float half[2][4], row[4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float send = hi2 ? acc[r][c] : acc[2 + r][c];
        half[r][c] = (hi2 ? acc[2 + r][c] : acc[r][c])
                     + __shfl_xor_sync(0xffffffffu, send, 2);
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float send = hi1 ? half[0][c] : half[1][c];
      row[c] = (hi1 ? half[1][c] : half[0][c])
               + __shfl_xor_sync(0xffffffffu, send, 1);
    }
    const int t = t0 + 4 * tt + kq;
    if (t < P.seq)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store_f32(out + t * out_ts + 4 * jt + c, row[c]);
  };

  // the pipeline, two barriers a chunk: [2 and 3a of chunk c] | [3b of
  // chunk c, 1 of chunk c+1]; inputs two chunks ahead in registers
  const int chunks = (P.seq + C - 1) / C;
  fetch(0);
  stash(0);
  __syncthreads();
  if (chunks > 1) fetch(C);
  phase1(0);
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    phase2(buf);
    phase3a(buf);
    if (ch + 1 < chunks) stash(buf ^ 1);
    __syncthreads();
    if (ch + 2 < chunks) fetch((ch + 2) * C);
    phase3b(buf, ch * C);
    if (ch + 1 < chunks) phase1(buf ^ 1);
    __syncthreads();
  }

  float* s_out = P.s_out + static_cast<int64_t>(bh) * HD * HD;
#pragma unroll
  for (int a = 0; a < IR; ++a)
#pragma unroll
    for (int c = 0; c < JE; ++c)
      s_out[(ig * IR + a) * HD + je * JE + c] = S[a][c];
}

template <int HD, typename E>
cudaError_t launch_typed(const Params& p, int blocks, cudaStream_t stream) {
  constexpr size_t bytes = Layout<HD>::kBytes;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = once_a_device(configured, [] {
    return cudaFuncSetAttribute(wkv6_chunked<HD, E>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Layout<HD>::kBytes));
  });
  if (err != cudaSuccess) return err;
  wkv6_chunked<HD, E><<<blocks, Geometry<HD>::kThreads, bytes, stream>>>(p);
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
// return cudaErrorInvalidValue (the wrapper refuses them first).  The
// grid is b * h blocks.
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
