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
// 0.024 ms at 67 TFLOP/s on the CUDA cores.  An earlier design (one CTA
// a (b, h), 140 registers, one CTA of 8 warps an SM) took 0.353 ms, 9% of
// the bound; probes that left one part out each (PERF.md) put 42% of it
// in staging loads issued between chunks and waited on at once, ~6% each
// in the column rounds, the stash and the recompute.
//
// Design.  Each row i of the state evolves on its own (S and G are both
// row-scaled), and dr, dk, dw, du of row i need only row i; only dv sums
// over the rows.  So a (b, h) is a cluster of kRanks CTAs (kCluster = 4
// at hd 64: 16 rows a CTA, 256 threads), 16 lanes a row, each lane 4
// columns of S and G (one float4).  A chunk is walked in sub-walks of
// kSub steps, the last first: each steps the lane's columns of S forward
// from the chunk's checkpoint to its first step, stashes S_{t-1} of its
// steps in registers (no shared-memory stash) and walks them in reverse,
// fully unrolled (the only chain across steps is G's FMA).  kSub = 8
// recomputes the first half of a chunk once (24 state steps a chunk of
// 16) and holds a lane to 80 registers, so 3 CTAs (24 warps) share an
// SM; kSub = 16 (no recompute) needs 128 and fits 2, and measured 18%
// slower (PERF.md).  Per step a lane forms its partials over its 4
// columns; the row sums (dr, dk, dw and v . do) take a transposed
// butterfly over the row's 16 lanes (5 shuffles: each lane ends with one
// of the four), the column sums (dv) one round across the warp's 2 rows
// (2 shuffles); the warps' partials are summed in warp order once a
// chunk, and the cluster's CTAs' partials in rank order through
// distributed shared memory: each CTA sums a quarter of the chunk's
// steps over the ranks and stores them.  The cluster barrier is split: a
// CTA arrives once its chunk partials are written and waits only after
// walking the next chunk, so the barrier's latency hides behind a walk;
// the partials are double-buffered.  The next chunk's r, k, w (the CTA's
// rows) and v, do are staged by cp.async while this one walks (16-byte
// copies where every base and stride allows, else 4-byte), and its
// checkpoint rows are loaded into registers a chunk ahead.  hd 16: one
// CTA a (b, h), 4 lanes a row.  Shared memory ~66 KB a CTA at hd 64.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_walk.cuh"
#include "smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 16;    // csrc/wkv6.cu's chunk: the checkpoint spacing
constexpr int kCluster = 4;   // CTAs a (b, h) at hd 64
constexpr int kColsLane = 4;  // state columns a lane (one float4)
constexpr int kSub = 8;       // steps stashed at a time (divides kChunk)
constexpr int kMinBlocks = 3;  // CTAs an SM the launch bound asks for

template <int HD>
struct Geometry;
template <>
struct Geometry<16> { static constexpr int kRanks = 1; };
template <>
struct Geometry<64> { static constexpr int kRanks = kCluster; };

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
  static constexpr int NC = Geometry<HD>::kRanks;   // CTAs a (b, h)
  static constexpr int R = HD / NC;                 // rows a CTA
  static constexpr int LR = HD / kColsLane;         // lanes a row
  static constexpr int NT = R * LR;                 // threads a CTA
  static constexpr int NW = NT / 32;                // warps
  static constexpr int C = kChunk;
  // shared memory in floats: two staging buffers, each r, k, w [3][C][R]
  // (the CTA's rows) then v, do [2][C][HD]; the row sums [3][C][R] (dr,
  // dk, dw); the warps' dv partials [C][NW][HD]; the CTA's dv partials
  // [2][C][HD], read by the cluster
  static constexpr int kStage = 3 * C * R + 2 * C * HD;
  static constexpr int kRows = 2 * kStage;
  static constexpr int kWarps = kRows + 3 * C * R;
  static constexpr int kCta = kWarps + C * NW * HD;
  static constexpr int kFloats = kCta + 2 * C * HD;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(HD % NC == 0 && R % 4 == 0 && LR >= 4 && LR <= 32 &&
                    (LR & (LR - 1)) == 0 && NT % 32 == 0 && NT <= 1024 &&
                    (C * HD) % NC == 0 && C % kSub == 0,
                "whole 16-byte rows a CTA, 4 to 32 lanes a row, whole "
                "sub-walks a chunk");
};

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::NT, kMinBlocks)
wkv6_bwd_kernel(const Params P) {
  using Lt = Layout<HD>;
  constexpr int NC = Lt::NC, R = Lt::R, LR = Lt::LR, NT = Lt::NT;
  constexpr int NW = Lt::NW, C = Lt::C;
  // the column rounds across the warp's rows: values left a lane, and
  // the lane bits whose lanes hold copies
  constexpr int kLeft = fold_left<kColsLane, LR, 32>();
  constexpr int kCopies = fold_copies<kColsLane, LR, 32>();
  extern __shared__ __align__(16) float sm[];
  float* const rows_s = sm + Lt::kRows;
  float* const warp_s = sm + Lt::kWarps;
  float* const cta_s = sm + Lt::kCta;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int il = tid / LR, cq = tid % LR;        // local row, lane of the row
  const int rank = blockIdx.x % NC, bh = blockIdx.x / NC;
  const int bi = bh / P.h, hi = bh % P.h;
  const int row0 = rank * R, i = row0 + il;
  const int seq = P.seq, chunks = (seq + C - 1) / C;
  const float ui = P.u[hi * HD + i];
  const float* const ck =
      P.states + (static_cast<int64_t>(bh) * chunks * HD + i) * HD
      + kColsLane * cq;
  // 16-byte copies need every base and (b, h, t) stride on 16 bytes
  bool vec = true;
#pragma unroll
  for (int a = 0; a < 5; ++a)
    vec = vec && reinterpret_cast<uintptr_t>(P.in[a]) % 16 == 0 &&
          P.st[3 * a] % 4 == 0 && P.st[3 * a + 1] % 4 == 0 &&
          P.st[3 * a + 2] % 4 == 0;

  // chunk c's inputs into staging buffer s (identity steps past T: r = k
  // = v = do = 0, w = 1)
  auto stage = [&](int c, int s) {
    float* const buf = sm + s * Lt::kStage;
    const int t0 = c * C;
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      const int width = a < 3 ? R : HD;            // floats a step
      const int pieces = C * width / 4;
      float* const dst =
          buf + (a < 3 ? a * C * R : 3 * C * R + (a - 3) * C * HD);
      const float* const src = P.in[a] + bi * P.st[3 * a]
                               + hi * P.st[3 * a + 1] + (a < 3 ? row0 : 0);
      const int64_t ts = P.st[3 * a + 2];
      for (int n = tid; n < pieces; n += NT) {
        const int l = n / (width / 4), j = 4 * (n % (width / 4));
        float* const d = dst + l * width + j;
        if (t0 + l < seq) {
          const float* const g = src + (t0 + l) * ts + j;
          if (vec) {
            copy_async<16>(d, g);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) copy_async<4>(d + e, g + e);
          }
        } else {
          const float fill = a == 2 ? 1.0f : 0.0f;
          *reinterpret_cast<float4*>(d) = make_float4(fill, fill, fill, fill);
        }
      }
    }
    copy_commit();
  };
  // the cluster's sums of chunk c's dv partials: this rank's share of the
  // chunk's steps, the ranks in order
  auto cluster_sum = [&](int c) {
    constexpr int per = C * HD / NC;
    cg::cluster_group cluster = cg::this_cluster();
    const float* part[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q)
      part[q] = cluster.map_shared_rank(cta_s + (c & 1) * C * HD, q);
    float* const dv = P.out[3] + bi * P.st[24] + hi * P.st[25];
    for (int n = rank * per + tid; n < (rank + 1) * per; n += NT) {
      const int t = c * C + n / HD;
      float sum = 0.0f;
#pragma unroll
      for (int q = 0; q < NC; ++q) sum += part[q][n];
      if (t < seq) dv[t * P.st[26] + n % HD] = sum;
    }
  };

  float G[kColsLane];
#pragma unroll
  for (int e = 0; e < kColsLane; ++e) G[e] = 0.0f;
  float du_acc = 0.0f;
  stage(chunks - 1, (chunks - 1) & 1);
  float4 S0 = *reinterpret_cast<const float4*>(ck + (chunks - 1) * HD * HD);

  for (int ch = chunks - 1; ch >= 0; --ch) {
    const float* const in_s = sm + (ch & 1) * Lt::kStage;
    const float* const r_s = in_s;
    const float* const k_s = in_s + C * R;
    const float* const w_s = in_s + 2 * C * R;
    const float* const v_s = in_s + 3 * C * R;
    const float* const do_s = v_s + C * HD;
    copy_wait_all();
    __syncthreads();        // chunk ch staged; the last chunk's readers done
    float4 S0n = S0;
    if (ch > 0) {
      stage(ch - 1, (ch - 1) & 1);
      S0n = *reinterpret_cast<const float4*>(ck + (ch - 1) * HD * HD);
    }
    // S <- w_t S + k_t v_t^T at the chunk's step l, on this lane's columns
    auto step = [&](const float4 S, int l) {
      const float4 v = *reinterpret_cast<const float4*>(v_s + l * HD
                                                        + kColsLane * cq);
      const float kk = k_s[l * R + il], ww = w_s[l * R + il];
      return make_float4(fmaf(ww, S.x, kk * v.x), fmaf(ww, S.y, kk * v.y),
                         fmaf(ww, S.z, kk * v.z), fmaf(ww, S.w, kk * v.w));
    };
    // the chunk in sub-walks of kSub steps, the last first: each steps the
    // state from the checkpoint to its first step, stashes S_{t-1} of its
    // steps in registers and walks them in reverse
#pragma unroll
    for (int sw = C / kSub - 1; sw >= 0; --sw) {
      float4 Sp[kSub];
      Sp[0] = S0;
#pragma unroll
      for (int l = 0; l < sw * kSub; ++l) Sp[0] = step(Sp[0], l);
#pragma unroll
      for (int m = 0; m + 1 < kSub; ++m)
        Sp[m + 1] = step(Sp[m], sw * kSub + m);
#pragma unroll
      for (int m = kSub - 1; m >= 0; --m) {
        const int l = sw * kSub + m;
        const float rr = r_s[l * R + il], kk = k_s[l * R + il];
        const float ww = w_s[l * R + il];
        const float4 v4 = *reinterpret_cast<const float4*>(v_s + l * HD
                                                           + kColsLane * cq);
        const float4 d4 = *reinterpret_cast<const float4*>(do_s + l * HD
                                                           + kColsLane * cq);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
        const float S[4] = {Sp[m].x, Sp[m].y, Sp[m].z, Sp[m].w};
        const float uk = ui * kk, ur = ui * rr;
        float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // dr, dk, dw, v . do
        float dv[kColsLane];
#pragma unroll
        for (int e = 0; e < kColsLane; ++e) {
          const float sh = fmaf(uk, v[e], S[e]);      // S_{t-1} + u k v
          const float gh = fmaf(ur, dd[e], G[e]);     // G_t + u r do
          x[0] = fmaf(sh, dd[e], x[0]);
          x[1] = fmaf(gh, v[e], x[1]);
          x[2] = fmaf(G[e], S[e], x[2]);
          x[3] = fmaf(v[e], dd[e], x[3]);
          dv[e] = gh * kk;
          G[e] = fmaf(ww, G[e], rr * dd[e]);
        }
        // the row's lanes: lane cq ends with x[2 (cq & 1) + (cq >> 1 & 1)]
        int slot = 0;
        fold_rounds<4, 1, LR>(x, lane, slot);
        if (cq < 4) {
          if (slot == 3)
            du_acc = fmaf(rr * kk, x[0], du_acc);
          else
            rows_s[(slot * C + l) * R + il] = x[0];
        }
        // the warp's rows, then the warps in order once a chunk
        int base = 0;
        fold_rounds<kColsLane, LR, 32>(dv, lane, base);
        if (!(lane & kCopies)) {
#pragma unroll
          for (int e = 0; e < kLeft; ++e)
            warp_s[(l * NW + warp) * HD + kColsLane * cq + base + e] = dv[e];
        }
      }
    }
    __syncthreads();        // the chunk's row sums and warp partials
    if (ch + 1 < chunks) {  // chunk ch + 1's partials, the walk behind us
      cluster_wait();
      cluster_sum(ch + 1);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float* const dst = P.out[a] + bi * P.st[15 + 3 * a]
                         + hi * P.st[16 + 3 * a] + row0;
      for (int n = tid; n < C * R; n += NT) {
        const int t = ch * C + n / R;
        if (t < seq) dst[t * P.st[17 + 3 * a] + n % R] = rows_s[a * C * R + n];
      }
    }
    float* const cta = cta_s + (ch & 1) * C * HD;
    for (int n = tid; n < C * HD; n += NT) {
      const int l = n / HD, j = n % HD;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += warp_s[(l * NW + w) * HD + j];
      cta[n] = sum;
    }
    cluster_arrive();
    S0 = S0n;
  }
  cluster_wait();
  cluster_sum(0);
  cluster_arrive();         // no CTA leaves while another reads its partials
  cluster_wait();
  if (cq == 3) P.du_part[static_cast<int64_t>(bh) * HD + i] = du_acc;
}

template <int HD>
cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  return once_a_device(configured, [] {
    return cudaFuncSetAttribute(wkv6_bwd_kernel<HD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Layout<HD>::kBytes));
  });
}

template <int HD>
int blocks_per_sm() {
  int n = 0;
  if (configure<HD>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wkv6_bwd_kernel<HD>, Layout<HD>::NT, Layout<HD>::kBytes)
          != cudaSuccess)
    return 0;
  return n;
}

template <int HD>
cudaError_t launch_hd(const Params& p, int bh, cudaStream_t stream) {
  using Lt = Layout<HD>;
  cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh * Lt::NC);
  cfg.blockDim = dim3(Lt::NT);
  cfg.dynamicSmemBytes = Lt::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Lt::NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_kernel<HD>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// CTAs of the kernel an SM holds at hd (registers and shared memory;
// 0 for another hd or on an error)
int wkv6_bwd_blocks_per_sm(int hd) {
  return hd == 16 ? blocks_per_sm<16>() : hd == 64 ? blocks_per_sm<64>() : 0;
}

// strides: 27 int64 in elements, (batch, head, time) of r, k, w, v, do,
// dr, dk, dw, dv (each with a unit stride on hd); every tensor f32.
// states: [b * h, ceil(T / 16), hd, hd], the forward's chunk-start
// states (16-byte aligned); du_part [b * h, hd].  hd in {16, 64}; other
// values return cudaErrorInvalidValue (the wrapper refuses them first).
// The grid is b * h clusters of Geometry<hd>::kRanks CTAs.
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
  if (reinterpret_cast<uintptr_t>(states) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(p, b * h, s);
    case 64: return launch_hd<64>(p, b * h, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
