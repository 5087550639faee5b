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
// dB and dC sum over the channels, which cross CTAs: a cluster of
// kCluster CTAs sums its channels' partials through distributed shared
// memory and writes [b, T, clusters a row, 2 ds] (dB then dC); the
// wrapper sums those over the clusters (and dA's and dD's over b) in a
// fixed order.  No float atomics: every sum has one order, so two runs
// are bit-equal.
//
// Bound on the H100 at jamba's training shape (b 8, T 128, di 8,192, ds
// 16; u, dy, du bf16): u, dy, du 16.8 MB each, dt and ddt 33.6 MB each,
// the checkpoints 33.6 MB: 152 MB, 0.045 ms at 3.35 TB/s, the larger;
// a_t once a state-step, 1.3e8 exps at 16 a clock per SM, 0.032 ms.
// An earlier design (2 lanes a channel, two exps a state-step, a 64 KB
// stash, two CTAs an SM) took 0.635 ms, 7% of the bound; probes that
// left one part out each (PERF.md) put 44% of it in staging loads in
// series with the walk, 29% in the per-step 16-value butterfly, 7% in
// the second exp and 3% in the stash.
//
// Design.  kStates = 4 states a lane (4 lanes a channel at ds 16, 1 at
// ds 4), kThreads threads a CTA over the channels of one batch row, a
// cluster of kCluster CTAs side by side along the channels; chunks of
// kChunk steps walked in reverse.  A chunk's u, dt, dy and B / C rows
// are staged in shared memory by cp.async while the chunk before it is
// walked (identity steps past T: u = dt = dy = B = C = 0, which leave g
// and h as they are; channels past di compute on zeros).  The chunk is
// walked in sub-walks of kSub steps, the last first: each steps the
// lane's states forward from the chunk's checkpoint by the forward's own
// arithmetic (so h is the forward's, bit for bit) and holds h of its own
// steps in registers; the first takes a_t = expf(dt A) of every step of
// the chunk and keeps it in shared memory, the others read it back: one
// accurate expf a state-step (the earlier design took two), and a
// recompute of FMAs only.  kSub = 8 holds a lane to 128 registers and,
// with ~56 KB of shared memory, 4 CTAs (16 warps) share an SM at ds 16.
// The reverse walk (fully unrolled; the chain across steps is g's FMA
// and a g) sums g B and g A a h across the channel's lanes by a
// transposed butterfly (3 shuffles, du and ddt stored by two of the four
// lanes), and the lane's 8 dB / dC values across the warp's 8 channels
// by another (7 shuffles: each lane ends with one, where 2 lanes a
// channel took 15 for 16 values); the warps' partials are summed in warp
// order once a chunk, the cluster's in rank order (each CTA a share of
// the chunk's sums), behind a split cluster barrier that waits only
// after the next chunk's walk; the partials are double-buffered.  expf
// is the accurate one: never build with --use_fast_math.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_walk.cuh"
#include "smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // threads a CTA
constexpr int kChunk = 16;     // csrc/mamba_scan.cu's: the checkpoint spacing
constexpr int kStates = 4;     // states a lane (one float4)
constexpr int kCluster = 8;    // CTAs a cluster, side by side along di
constexpr int kSub = 8;        // steps whose h a lane holds (divides kChunk)
constexpr int kMinBlocks = 4;  // CTAs an SM the launch bound asks for at
                               // ds 16 (3 at ds 4, whose staging is wider)
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
  float* dbc;                  // [b, T, clusters a row, 2 ds]
  float* dA;                   // [b, di, ds]
  float* dD;                   // [b, di]
  int64_t st[8];               // (b, t) strides of u, dt, B, C
  int di, seq, per_row;        // per_row: CTAs a batch row
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DS, typename E>
struct Layout {
  static constexpr int kLanes = lanes_of(DS), kSt = DS / kLanes;
  static constexpr int kChannels = kThreads / kLanes;
  static constexpr int C = kChunk;
  // shared memory in bytes: two staging buffers, each dt [C][kChannels]
  // f32, B then C [C][2 DS] f32, u and dy [C][kChannels] E; a_t of the
  // chunk's steps [C][kThreads] float4s; the warps' dB / dC partials
  // [C][kWarps][2 DS] f32; the CTA's [2][C][2 DS] f32, read by the
  // cluster
  static constexpr int kDt = 0;
  static constexpr int kBC = kDt + 4 * C * kChannels;
  static constexpr int kU = kBC + 4 * C * 2 * DS;
  static constexpr int kDy = kU + sizeof(E) * C * kChannels;
  static constexpr int kStage = kDy + sizeof(E) * C * kChannels;
  static constexpr int kA = 2 * kStage;
  static constexpr int kWarpPart = kA + 16 * C * kThreads;
  static constexpr int kCtaPart = kWarpPart + 4 * C * kWarps * 2 * DS;
  static constexpr int kBytes = kCtaPart + 4 * 2 * C * 2 * DS;
  static_assert(kSt == 4 && kLanes * kSt == DS &&
                    (kLanes & (kLanes - 1)) == 0 && kLanes <= 32,
                "one float4 of states a lane; a power of two lanes a channel");
  static_assert(kStage % 16 == 0 && (sizeof(E) * kChannels) % 16 == 0 &&
                    (C * 2 * DS) % kCluster == 0 && C % kSub == 0,
                "16-byte staging rows; whole shares of a chunk's sums; "
                "whole sub-walks a chunk");
};

// kChunk rows of N elements (row t at src + t * stride) into dst, rows
// PITCH elements apart: 16-byte copies where the rows allow them (vec),
// else plain loads; zeros past `live` elements, or past T
template <typename T, int N, int PITCH = N>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           int64_t stride, int t0, int seq,
                                           int live, bool vec, int tid) {
  constexpr int PE = 16 / sizeof(T), NP = N / PE;   // elements, pieces a row
  static_assert(N % PE == 0, "whole 16-byte pieces a row");
  for (int p = tid; p < kChunk * NP; p += kThreads) {
    const int i = p / NP, j = (p % NP) * PE, t = t0 + i;
    const bool ok = t < seq;
    T* const d = dst + i * PITCH + j;
    const T* const s = src + (ok ? t : 0) * stride + j;
    if (ok && vec && j + PE <= live) {
      copy_async<16>(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < PE; ++e) d[e] = ok && j + e < live ? s[e] : T(0.0f);
    }
  }
}

template <int DS, typename E>
__global__ void __launch_bounds__(kThreads, DS == 4 ? 3 : kMinBlocks)
mamba_scan_bwd_kernel(const Params P) {
  using Lt = Layout<DS, E>;
  constexpr int kLanes = Lt::kLanes, kSt = Lt::kSt, C = Lt::C;
  constexpr int kChannels = Lt::kChannels;
  constexpr int kVals = 2 * kSt;                // dB, dC values a lane
  constexpr int kCopies = fold_copies<kVals, kLanes, 32>();
  static_assert(fold_left<kVals, kLanes, 32>() == 1,
                "one dB / dC sum a lane after the channel rounds");
  extern __shared__ __align__(16) unsigned char smem[];
  float4* const a_s = reinterpret_cast<float4*>(smem + Lt::kA);
  float* const warp_s = reinterpret_cast<float*>(smem + Lt::kWarpPart);
  float* const cta_s = reinterpret_cast<float*>(smem + Lt::kCtaPart);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / kLanes, q = tid % kLanes;
  const int bi = blockIdx.x / P.per_row, blk = blockIdx.x % P.per_row;
  const int rank = blk % kCluster, cl = blk / kCluster;
  const int clusters = P.per_row / kCluster;
  const int d0 = blk * kChannels;
  const int nch = min(kChannels, P.di - d0);    // <= 0: a padding CTA
  const int d = d0 + c;
  const bool live = c < nch;
  const int seq = P.seq, chunks = (seq + C - 1) / C;

  const E* const ub = static_cast<const E*>(P.u) + bi * P.st[0] + d0;
  const float* const dtb = P.dt + bi * P.st[2] + d0;
  const float* const Bb = P.B + bi * P.st[4];
  const float* const Cb = P.C + bi * P.st[6];
  const int64_t row0 = static_cast<int64_t>(bi) * seq * P.di + d0;
  const E* const dyb = static_cast<const E*>(P.dy) + row0;
  E* const dub = static_cast<E*>(P.du) + row0;
  float* const ddtb = P.ddt + row0;
  // 16-byte copies need the rows' bases and strides on 16 bytes
  const auto on16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  constexpr int ePE = 16 / sizeof(E);
  const bool vec_u = on16(ub) && P.st[1] % ePE == 0;
  const bool vec_dt = on16(dtb) && P.st[3] % 4 == 0;
  const bool vec_dy = on16(dyb) && P.di % ePE == 0;
  const bool vec_b = on16(Bb) && P.st[5] % 4 == 0;
  const bool vec_c = on16(Cb) && P.st[7] % 4 == 0;

  // chunk ci's rows into staging buffer s
  auto stage = [&](int ci, int s) {
    unsigned char* const buf = smem + s * Lt::kStage;
    float* const bc = reinterpret_cast<float*>(buf + Lt::kBC);
    const int t0 = ci * C;
    stage_rows<float, kChannels>(reinterpret_cast<float*>(buf + Lt::kDt),
                                 dtb, P.st[3], t0, seq, nch, vec_dt, tid);
    stage_rows<E, kChannels>(reinterpret_cast<E*>(buf + Lt::kU), ub,
                             P.st[1], t0, seq, nch, vec_u, tid);
    stage_rows<E, kChannels>(reinterpret_cast<E*>(buf + Lt::kDy), dyb,
                             P.di, t0, seq, nch, vec_dy, tid);
    // B then C, each row [2 DS] apart
    stage_rows<float, DS, 2 * DS>(bc, Bb, P.st[5], t0, seq, DS, vec_b, tid);
    stage_rows<float, DS, 2 * DS>(bc + DS, Cb, P.st[7], t0, seq, DS, vec_c,
                                  tid);
    copy_commit();
  };
  // the cluster's sums of chunk ci's dB / dC partials: this rank's share
  // of the chunk's C x 2 DS sums, the ranks in order
  auto cluster_sum = [&](int ci) {
    constexpr int per = C * 2 * DS / kCluster;
    cg::cluster_group cluster = cg::this_cluster();
    const float* part[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      part[r] = cluster.map_shared_rank(cta_s + (ci & 1) * C * 2 * DS, r);
    for (int n = rank * per + tid; n < (rank + 1) * per; n += kThreads) {
      const int t = ci * C + n / (2 * DS);
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) sum += part[r][n];
      if (t < seq)
        P.dbc[((static_cast<int64_t>(bi) * seq + t) * clusters + cl) * 2 * DS
              + n % (2 * DS)] = sum;
    }
  };
  auto checkpoint = [&](int ci) {
    return live ? *reinterpret_cast<const float4*>(
                      P.h_ck + ((static_cast<int64_t>(bi) * chunks + ci)
                                * P.di + d) * DS + kSt * q)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float A[kSt], dA[kSt], carry[kSt];
#pragma unroll
  for (int s = 0; s < kSt; ++s) {
    A[s] = live ? P.A[static_cast<int64_t>(d) * DS + kSt * q + s] : 0.0f;
    dA[s] = 0.0f;
    carry[s] = 0.0f;                            // a_{t+1} g_{t+1}
  }
  const float Dd = live ? P.D[d] : 0.0f;
  float dD = 0.0f;
  stage(chunks - 1, (chunks - 1) & 1);
  float4 h0 = checkpoint(chunks - 1);

  for (int ci = chunks - 1; ci >= 0; --ci) {
    const unsigned char* const buf = smem + (ci & 1) * Lt::kStage;
    const float* const sdt = reinterpret_cast<const float*>(buf + Lt::kDt);
    const float* const sbc = reinterpret_cast<const float*>(buf + Lt::kBC);
    const E* const su = reinterpret_cast<const E*>(buf + Lt::kU);
    const E* const sdy = reinterpret_cast<const E*>(buf + Lt::kDy);
    copy_wait_all();
    __syncthreads();        // chunk ci staged; the last chunk's readers done
    float4 h0n = h0;
    if (ci > 0) {
      stage(ci - 1, (ci - 1) & 1);
      h0n = checkpoint(ci - 1);
    }
    // the chunk in sub-walks of kSub steps, the last first.  Each steps h
    // forward from the checkpoint by the forward's arithmetic through its
    // own steps, holding h_{t-1} and h_t of those in registers; the first
    // (the chunk's last steps) takes a_t = expf(dt A) of every step and
    // keeps it in shared memory, the others read it back: one exp a
    // state-step.  A lane reads back only its own a_t: no barrier.
#pragma unroll
    for (int sw = C / kSub - 1; sw >= 0; --sw) {
      float hs[kSub + 1][kSt];
      float h[kSt] = {h0.x, h0.y, h0.z, h0.w};
#pragma unroll
      for (int i = 0; i < (sw + 1) * kSub; ++i) {
        const float dtv = sdt[i * kChannels + c];
        const float du = dtv * to_f32(su[i * kChannels + c]);
        const float4 b4 = *reinterpret_cast<const float4*>(sbc + i * 2 * DS
                                                           + kSt * q);
        const float bt[4] = {b4.x, b4.y, b4.z, b4.w};
        float a[kSt];
        if (sw == C / kSub - 1) {
#pragma unroll
          for (int s = 0; s < kSt; ++s) a[s] = expf(dtv * A[s]);
          a_s[i * kThreads + tid] = make_float4(a[0], a[1], a[2], a[3]);
        } else {
          const float4 a4 = a_s[i * kThreads + tid];
          a[0] = a4.x;
          a[1] = a4.y;
          a[2] = a4.z;
          a[3] = a4.w;
        }
        if (i == sw * kSub) {
#pragma unroll
          for (int s = 0; s < kSt; ++s) hs[0][s] = h[s];
        }
#pragma unroll
        for (int s = 0; s < kSt; ++s) h[s] = fmaf(a[s], h[s], du * bt[s]);
        if (i >= sw * kSub) {
#pragma unroll
          for (int s = 0; s < kSt; ++s) hs[i - sw * kSub + 1][s] = h[s];
        }
      }
      // the reverse walk of the sub-walk's steps
#pragma unroll
      for (int m = kSub - 1; m >= 0; --m) {
        const int i = sw * kSub + m, t = ci * C + i;
        const float dtv = sdt[i * kChannels + c];
        const float uv = to_f32(su[i * kChannels + c]);
        const float dyv = to_f32(sdy[i * kChannels + c]);
        const float duv = dtv * uv;
        const float4 b4 = *reinterpret_cast<const float4*>(sbc + i * 2 * DS
                                                           + kSt * q);
        const float4 c4 = *reinterpret_cast<const float4*>(sbc + i * 2 * DS
                                                           + DS + kSt * q);
        const float4 a4 = a_s[i * kThreads + tid];
        const float bt[4] = {b4.x, b4.y, b4.z, b4.w};
        const float ct[4] = {c4.x, c4.y, c4.z, c4.w};
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        float x[kVals], gs[2] = {0.0f, 0.0f};   // sum_s g B, g A a h
#pragma unroll
        for (int s = 0; s < kSt; ++s) {
          const float g = fmaf(ct[s], dyv, carry[s]);
          const float gah = g * a[s] * hs[m][s];
          gs[0] = fmaf(g, bt[s], gs[0]);
          gs[1] = fmaf(gah, A[s], gs[1]);
          dA[s] = fmaf(gah, dtv, dA[s]);
          x[s] = g * duv;                       // dB_t[s], this channel
          x[kSt + s] = dyv * hs[m + 1][s];      // dC_t[s], this channel
          carry[s] = a[s] * g;
        }
        dD = fmaf(dyv, uv, dD);
        // the channel's lanes: lane q ends with gs[q & 1] summed, and
        // takes the other from its neighbour
        if constexpr (kLanes > 1) {
          int slot = 0;
          fold_rounds<2, 1, kLanes>(gs, lane, slot);
          const float other = __shfl_xor_sync(0xffffffffu, gs[0], 1);
          if (live && t < seq) {
            if (q == 0)
              store_f32(dub + static_cast<int64_t>(t) * P.di + c,
                        fmaf(Dd, dyv, dtv * gs[0]));
            else if (q == 1)
              ddtb[static_cast<int64_t>(t) * P.di + c] =
                  fmaf(uv, other, gs[0]);
          }
        } else if (live && t < seq) {
          store_f32(dub + static_cast<int64_t>(t) * P.di + c,
                    fmaf(Dd, dyv, dtv * gs[0]));
          ddtb[static_cast<int64_t>(t) * P.di + c] = fmaf(uv, gs[0], gs[1]);
        }
        // the warp's channels, then the warps in order once a chunk
        int base = 0;
        fold_rounds<kVals, kLanes, 32>(x, lane, base);
        if (!(lane & kCopies)) {
          const int e = base < kSt ? kSt * q + base
                                   : DS + kSt * q + base - kSt;
          warp_s[(i * kWarps + warp) * 2 * DS + e] = x[0];
        }
      }
    }
    __syncthreads();        // the chunk's warp partials
    if (ci + 1 < chunks) {  // chunk ci + 1's partials, the walk behind us
      cluster_wait();
      cluster_sum(ci + 1);
    }
    float* const cta = cta_s + (ci & 1) * C * 2 * DS;
    for (int n = tid; n < C * 2 * DS; n += kThreads) {
      const int i = n / (2 * DS), e = n % (2 * DS);
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += warp_s[(i * kWarps + w) * 2 * DS + e];
      cta[n] = sum;
    }
    cluster_arrive();
    h0 = h0n;
  }
  cluster_wait();
  cluster_sum(0);
  cluster_arrive();         // no CTA leaves while another reads its partials
  cluster_wait();
  if (live) {
    float* da = P.dA + (static_cast<int64_t>(bi) * P.di + d) * DS + kSt * q;
#pragma unroll
    for (int s = 0; s < kSt; ++s) da[s] = dA[s];
    if (q == 0) P.dD[static_cast<int64_t>(bi) * P.di + d] = dD;
  }
}

template <int DS, typename E>
cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  return once_a_device(configured, [] {
    return cudaFuncSetAttribute(mamba_scan_bwd_kernel<DS, E>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Layout<DS, E>::kBytes);
  });
}

template <int DS, typename E>
int blocks_per_sm() {
  int n = 0;
  if (configure<DS, E>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, mamba_scan_bwd_kernel<DS, E>, kThreads, Layout<DS, E>::kBytes)
          != cudaSuccess)
    return 0;
  return n;
}

template <int DS, typename E>
cudaError_t launch_typed(const Params& p, int blocks, cudaStream_t stream) {
  using Lt = Layout<DS, E>;
  cudaError_t err = configure<DS, E>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Lt::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mamba_scan_bwd_kernel<DS, E>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DS>
cudaError_t launch_ds(Params& p, int bf16, int b, cudaStream_t stream) {
  constexpr int ch = kThreads / lanes_of(DS);
  const int clusters = (p.di + ch * kCluster - 1) / (ch * kCluster);
  p.per_row = clusters * kCluster;
  return bf16 ? launch_typed<DS, __nv_bfloat16>(p, b * p.per_row, stream)
              : launch_typed<DS, float>(p, b * p.per_row, stream);
}

}  // namespace

extern "C" {

const char* mamba_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// CTAs of the kernel an SM holds at ds with u in bf16 or f32 (registers
// and shared memory; 0 for another ds or on an error)
int mamba_scan_bwd_blocks_per_sm(int ds, int bf16) {
  if (ds == 4)
    return bf16 ? blocks_per_sm<4, __nv_bfloat16>()
                : blocks_per_sm<4, float>();
  if (ds == 16)
    return bf16 ? blocks_per_sm<16, __nv_bfloat16>()
                : blocks_per_sm<16, float>();
  return 0;
}

// strides: 8 int64 in elements, (batch, time) of u, dt, B, C.  u, dy and
// du: 0 f32, 1 bf16; everything else f32.  dy, du and ddt contiguous
// [b, T, di]; h_ck [b, ceil(T / 16), di, ds] (16-byte aligned), the
// forward's chunk-start states; dbc [b, T, ceil(di / (kCluster x
// channels a CTA)), 2 ds]; dA [b, di, ds]; dD [b, di].  ds in {4, 16};
// other values return cudaErrorInvalidValue (the wrapper refuses them
// first).
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
