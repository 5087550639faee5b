// Blocked attention backward (flash) for Hopper (sm_90a): the gradients
// of B13's forward (flash_attention.cu, flash_attention_sm90.cu) with
// respect to q, k and v.
//
// It replaces no Pallas kernel: the reference trains through the jnp
// blocked attention of src/repro/models/layers.py::blocked_attention
// (:186), which XLA differentiates.  It computes what that autodiff
// computes, so that training on the card runs no plain version:
//
//   fa_backward <- jax.grad of blocked_attention (:186)
//
// q [b, h, sq, hd], k / v [b, kvh, skv, hd], o and dO [b, h, sq, hd]
// (f32 or bf16 storage, any strides with a unit stride on hd) ->
// dq [b, h, sq, hd], dk / dv [b, kvh, skv, hd] in the inputs' dtype,
// every sum in f32.  Query head hi reads kv head hi / (h / kvh), and dk,
// dv of a kv head are summed over the h / kvh query heads of its group.
// The mask is the forward's: key j is masked for query i when causal and
// j > i, or a window is given and j <= i - window; keys past skv weigh
// nothing.  With s = (q_i . k_j) * scale, p = softmax_j(s) (the forward's
// running max m and sum l, recomputed here one kv tile at a time in the
// forward's order; p = exp(s - m) / max(l, 1e-30)), delta_i =
// sum_d dO_id o_id, ds = p (dO_i . v_j - delta_i):
//
//   dq_i = scale * sum_j ds_ij k_j    dk_j = scale * sum_i ds_ij q_i
//   dv_j = sum_i p_ij dO_i
//
// Two kernels, one stream, no float atomics: every output element is
// written once by the one block that owns it, each sum walked in a fixed
// order, so a backward gives the same bits on every run (resume and the
// kill-and-restore checks compare bits).
//
// - tiles of T rows: T = 64, and T = 32 at hd 256 (the 64-row tiles'
//   dq pass would need 361 KB of shared memory there).  R = T / 16.
// - dq pass: one block of 256 threads per (T-row query tile, b * h).
//   It computes delta, walks its kv tiles once for the row statistics
//   (m, l), stores them with delta for the second kernel, then walks them
//   again for ds and dq.  Thread (ty, tx) of the 16 x 16 layout owns
//   rows R ty..R ty+R-1 and, per kv tile, columns R tx..R tx+R-1 of the
//   T x T score tile (the forward's layout at T = 64), and output
//   columns tx, tx+16, ... of its rows.
// - dk / dv pass: one block per (T-key tile, b * kvh).  It keeps the
//   tile's dk and dv in registers (thread (ty, tx): keys R ty..R ty+R-1,
//   columns tx, tx+16, ...) and walks, for each query head of the group
//   in order, every query tile that sees one of its keys (causal: from
//   the tile's first key; window: up to its last key + window).
//
// Shared memory holds the tiles in f32, the row operands of an R x R
// tile product transposed ([hd][T + 4]), so a thread's R rows and R
// columns are one 16-byte (R = 4) or 8-byte (R = 2) load each: dq pass
// 4 * (4 * (T + 4) * hd + T * hd + T * (T + 4)) bytes (189 KB at hd 128,
// 181 KB at hd 256), dk / dv pass 4 * (4 * (T + 4) * hd + 2 * T * hd +
// T * (T + 4) + 3 * T) bytes (223 KB at hd 128, 213 KB at hd 256: one
// block an SM).
//
// Bound on the H100: the backward needs five products a visible (query,
// key) pair — S again, dP, dV, dQ and dK — 10 * hd FLOPs, 2.5x the
// forward's, on the tensor cores at best.  This design does eight (16 *
// hd: the dq pass computes S twice, once for the statistics, and the
// dk / dv pass computes S and dP again) as f32 FMAs on the CUDA cores
// (67 TFLOP/s peak), so it cannot come near that bound; it is the simple
// kernel that is right first.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing (the wrapper hands it the statistics' scratch) and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr float kMasked = -1e30f;

// the tile rows of a head dim: 64, and 32 at hd 256
template <int HD>
constexpr int kTileRows = HD == 256 ? 32 : 64;
// blocks an SM the launch bounds promise: one, so that ptxas may use up
// to 255 registers (without it, it spilled 16 bytes at hd 80 and 128,
// where shared memory holds one block an SM anyway)
constexpr int kMinBlocks = 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;                  // [3][b * h * sq]: m, max(l, 1e-30), delta
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, db, dh, ds;
  int64_t gqb, gqh, gqs, gkb, gkh, gks, gvb, gvh, gvs;
  int h, kvh, group, sq, skv, causal, window;   // window <= 0: none
  int64_t n_rows;                               // b * h * sq
  float scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// R consecutive floats as one 16-byte (R = 4) or 8-byte (R = 2) access
template <int R>
__device__ __forceinline__ void load_r(const float* p, float (&x)[R]) {
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    static_assert(R == 2, "R = 2 or 4");
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  }
}
template <int R>
__device__ __forceinline__ void store_r(float* p, const float (&x)[R]) {
  if constexpr (R == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool masked(const Params& P, int qp, int kp) {
  return (P.causal && kp > qp) || (P.window > 0 && kp <= qp - P.window);
}

// s[i][j] = sum_d a[d][R ty + i] * b[d][R tx + j]: an R x R block of the
// product of two transposed [HD][T + 4] tiles
template <int HD, int T>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx,
                                         float (&s)[T / 16][T / 16]) {
  constexpr int R = T / 16, LD = T + 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float xv[R], yv[R];
    load_r<R>(a + d * LD + R * ty, xv);
    load_r<R>(b + d * LD + R * tx, yv);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

// acc[i][c] += sum_r pt[r][R ty + i] * rows[r][tx + 16c] over the T rows
// r of a transposed [T][T + 4] tile and a row-major [T][HD] tile
template <int HD, int T>
__device__ __forceinline__ void tile_acc(const float* pt, const float* rows,
                                         int ty, int tx,
                                         float (&acc)[T / 16][HD / 16]) {
  constexpr int R = T / 16, LD = T + 4;
#pragma unroll 4
  for (int r = 0; r < T; ++r) {
    float p[R];
    load_r<R>(pt + r * LD + R * ty, p);
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float x = rows[r * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
    }
  }
}

// rows [r0, r0 + T) of a [n, HD] operand (row stride rs) into a
// transposed [HD][T + 4] tile and, when row_major is given, a row-major
// [T][HD] copy; rows past n are zero
template <int HD, int T, typename E>
__device__ __forceinline__ void load_tile(const E* src, int64_t rs, int r0,
                                          int n, float* transposed,
                                          float* row_major) {
  for (int idx = threadIdx.x; idx < T * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = r0 + r;
    const float x = row < n ? load_f32(src + row * rs + d) : 0.0f;
    transposed[d * (T + 4) + r] = x;
    if (row_major != nullptr) row_major[r * HD + d] = x;
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  constexpr int T = kTileRows<HD>, LD = T + 4;
  return sizeof(float) * (4 * HD * LD + T * HD + T * LD);
}
template <int HD>
constexpr size_t dkv_smem_bytes() {
  constexpr int T = kTileRows<HD>, LD = T + 4;
  return sizeof(float) * (4 * HD * LD + 2 * T * HD + T * LD + 3 * T);
}

template <int HD, typename E>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attn_bwd_dq(const Params P) {
  constexpr int T = kTileRows<HD>, R = T / 16, LD = T + 4, NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                        // [HD][LD]  q tile
  float* dot = qt + HD * LD;               // [HD][LD]  dO tile
  float* kt = dot + HD * LD;               // [HD][LD]  k tile
  float* vt = kt + HD * LD;                // [HD][LD]  v tile
  float* kr = vt + HD * LD;                // [T][HD]   k tile, row-major
  float* pt = kr + T * HD;                 // [T][LD]   ds tile, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.y / P.h, hi = blockIdx.y % P.h;
  const int kvi = hi / P.group;
  const int q0 = blockIdx.x * T;
  const E* q = static_cast<const E*>(P.q) + bi * P.qb + hi * P.qh;
  const E* dout = static_cast<const E*>(P.dout) + bi * P.db + hi * P.dh;
  const E* o = static_cast<const E*>(P.o) + bi * P.ob + hi * P.oh;
  const E* k = static_cast<const E*>(P.k) + bi * P.kb + kvi * P.kh;
  const E* v = static_cast<const E*>(P.v) + bi * P.vb + kvi * P.vh;
  E* dq = static_cast<E*>(P.dq) + bi * P.gqb + hi * P.gqh;

  load_tile<HD, T>(q, P.qs, q0, P.sq, qt, static_cast<float*>(nullptr));
  load_tile<HD, T>(dout, P.ds, q0, P.sq, dot, static_cast<float*>(nullptr));
  __syncthreads();

  // delta_i = dO_i . o_i over the 16 lanes of the row's half-warp
  float delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i, qp = q0 + r;
    float part = 0.0f;
    if (qp < P.sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        part = fmaf(dot[d * LD + r], load_f32(o + qp * P.os + d), part);
      }
    }
    delta[i] = half_warp_sum(part);
  }

  const int q_last = min(q0 + T, P.sq) - 1;
  const int kv_hi = P.causal ? min(P.skv, q_last + 1) : P.skv;
  const int kv_lo = P.window > 0 ? max(0, q0 - P.window + 1) : 0;
  const int k_first = (kv_lo / T) * T;

  // pass 1: the forward's row statistics, in its tile order
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
  }
  for (int k0 = k_first; k0 < kv_hi; k0 += T) {
    __syncthreads();
    load_tile<HD, T>(k, P.ks, k0, P.skv, kt, static_cast<float*>(nullptr));
    __syncthreads();
    float s[R][R];
    tile_dot<HD, T>(qt, kt, ty, tx, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + R * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + R * tx + j;
        float x = s[i][j] * P.scale;
        if (kp >= P.skv)
          x = -INFINITY;
        else if (masked(P, qp, kp))
          x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }
  float den[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    den[i] = fmaxf(l[i], 1e-30f);
    const int qp = q0 + R * ty + i;
    if (tx == 0 && qp < P.sq) {
      const int64_t row = static_cast<int64_t>(blockIdx.y) * P.sq + qp;
      P.stats[row] = m[i];
      P.stats[P.n_rows + row] = den[i];
      P.stats[2 * P.n_rows + row] = delta[i];
    }
  }

  // pass 2: ds and dq
  float acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int k0 = k_first; k0 < kv_hi; k0 += T) {
    __syncthreads();                       // previous tile consumed
    load_tile<HD, T>(k, P.ks, k0, P.skv, kt, kr);
    load_tile<HD, T>(v, P.vs, k0, P.skv, vt, static_cast<float*>(nullptr));
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<HD, T>(qt, kt, ty, tx, s);
    tile_dot<HD, T>(dot, vt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + R * ty + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + R * tx + j;
        const bool out = kp >= P.skv || masked(P, qp, kp);
        const float p = out ? 0.0f : expf(s[i][j] * P.scale - m[i]) / den[i];
        s[i][j] = p * (dp[i][j] - delta[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float col[R];
#pragma unroll
      for (int i = 0; i < R; ++i) col[i] = s[i][j];
      store_r<R>(pt + (R * tx + j) * LD + R * ty, col);
    }
    __syncthreads();
    tile_acc<HD, T>(pt, kr, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = q0 + R * ty + i;
    if (qp >= P.sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_f32(dq + qp * P.gqs + tx + 16 * c, acc[i][c] * P.scale);
  }
}

template <int HD, typename E>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attn_bwd_dkv(const Params P) {
  constexpr int T = kTileRows<HD>, R = T / 16, LD = T + 4, NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                        // [HD][LD]  k tile
  float* vt = kt + HD * LD;                // [HD][LD]  v tile
  float* qt = vt + HD * LD;                // [HD][LD]  q tile
  float* dot = qt + HD * LD;               // [HD][LD]  dO tile
  float* qr = dot + HD * LD;               // [T][HD]   q tile, row-major
  float* dor = qr + T * HD;                // [T][HD]   dO tile, row-major
  float* pt = dor + T * HD;                // [T][LD]   p, then ds
  float* sm_m = pt + T * LD;               // [T] the rows' statistics
  float* sm_den = sm_m + T;
  float* sm_delta = sm_den + T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.y / P.kvh, kvi = blockIdx.y % P.kvh;
  const int k0 = blockIdx.x * T;
  const E* k = static_cast<const E*>(P.k) + bi * P.kb + kvi * P.kh;
  const E* v = static_cast<const E*>(P.v) + bi * P.vb + kvi * P.vh;
  E* dk = static_cast<E*>(P.dk) + bi * P.gkb + kvi * P.gkh;
  E* dv = static_cast<E*>(P.dv) + bi * P.gvb + kvi * P.gvh;

  load_tile<HD, T>(k, P.ks, k0, P.skv, kt, static_cast<float*>(nullptr));
  load_tile<HD, T>(v, P.vs, k0, P.skv, vt, static_cast<float*>(nullptr));

  // the query rows that see one of this tile's keys: [q_lo, q_hi)
  const int k_last = min(k0 + T, P.skv) - 1;
  const int q_lo = P.causal ? k0 : 0;
  const int q_hi = P.window > 0 ? min(P.sq, k_last + P.window) : P.sq;

  float dk_acc[R][NC], dv_acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk_acc[i][c] = 0.0f;
      dv_acc[i][c] = 0.0f;
    }

  for (int g = 0; g < P.group; ++g) {
    const int hi = kvi * P.group + g;
    const E* q = static_cast<const E*>(P.q) + bi * P.qb + hi * P.qh;
    const E* dout = static_cast<const E*>(P.dout) + bi * P.db + hi * P.dh;
    const int64_t row0 = (static_cast<int64_t>(bi) * P.h + hi) * P.sq;
    for (int q0 = (q_lo / T) * T; q0 < q_hi; q0 += T) {
      __syncthreads();                     // previous tile consumed
      load_tile<HD, T>(q, P.qs, q0, P.sq, qt, qr);
      load_tile<HD, T>(dout, P.ds, q0, P.sq, dot, dor);
      if (tid < T) {
        const int qp = q0 + tid;
        const bool in = qp < P.sq;
        sm_m[tid] = in ? P.stats[row0 + qp] : 0.0f;
        sm_den[tid] = in ? P.stats[P.n_rows + row0 + qp] : 1.0f;
        sm_delta[tid] = in ? P.stats[2 * P.n_rows + row0 + qp] : 0.0f;
      }
      __syncthreads();
      // transposed tiles: rows are this block's keys, columns the queries
      float p[R][R], dp[R][R];
      tile_dot<HD, T>(kt, qt, ty, tx, p);
      tile_dot<HD, T>(vt, dot, ty, tx, dp);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kp = k0 + R * ty + j;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int c = R * tx + i, qp = q0 + c;
          const bool out = kp >= P.skv || qp >= P.sq || masked(P, qp, kp);
          p[j][i] = out ? 0.0f
                        : expf(p[j][i] * P.scale - sm_m[c]) / sm_den[c];
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float col[R];
#pragma unroll
        for (int j = 0; j < R; ++j) col[j] = p[j][i];
        store_r<R>(pt + (R * tx + i) * LD + R * ty, col);
      }
      __syncthreads();
      tile_acc<HD, T>(pt, dor, ty, tx, dv_acc);
      __syncthreads();                     // p read by every thread
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float dl = sm_delta[R * tx + i];
        float col[R];
#pragma unroll
        for (int j = 0; j < R; ++j) col[j] = p[j][i] * (dp[j][i] - dl);
        store_r<R>(pt + (R * tx + i) * LD + R * ty, col);
      }
      __syncthreads();
      tile_acc<HD, T>(pt, qr, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int kp = k0 + R * ty + j;
    if (kp >= P.skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store_f32(dk + kp * P.gks + tx + 16 * c, dk_acc[j][c] * P.scale);
      store_f32(dv + kp * P.gvs + tx + 16 * c, dv_acc[j][c]);
    }
  }
}

template <int HD, typename E>
cudaError_t launch_typed(const Params& p, int b, cudaStream_t stream) {
  constexpr int T = kTileRows<HD>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = once_a_device(configured, [] {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dq<HD, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem_bytes<HD>()));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        attn_bwd_dkv<HD, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkv_smem_bytes<HD>()));
  });
  if (err != cudaSuccess) return err;
  const dim3 grid_dq((p.sq + T - 1) / T, b * p.h);
  attn_bwd_dq<HD, E><<<grid_dq, kThreads, dq_smem_bytes<HD>(), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkv((p.skv + T - 1) / T, b * p.kvh);
  attn_bwd_dkv<HD, E>
      <<<grid_dkv, kThreads, dkv_smem_bytes<HD>(), stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Params& p, int bf16, int b, cudaStream_t s) {
  return bf16 ? launch_typed<HD, __nv_bfloat16>(p, b, s)
              : launch_typed<HD, float>(p, b, s);
}

}  // namespace

extern "C" {

const char* fa_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: 24 int64 in elements, (batch, head, seq) of q, k, v, o, dO,
// dq, dk, dv.  stats: 3 * b * h * sq f32 of scratch.  dtype: 0 f32,
// 1 bf16.  hd in {16, 32, 64, 80, 128, 256}; anything else returns
// cudaErrorInvalidValue (the wrapper refuses it first).
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv, float* stats,
                const int64_t* strides, int bf16, int b, int h, int kvh,
                int sq, int skv, int hd, int causal, int window, float scale,
                void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.stats = stats;
  p.qb = strides[0]; p.qh = strides[1]; p.qs = strides[2];
  p.kb = strides[3]; p.kh = strides[4]; p.ks = strides[5];
  p.vb = strides[6]; p.vh = strides[7]; p.vs = strides[8];
  p.ob = strides[9]; p.oh = strides[10]; p.os = strides[11];
  p.db = strides[12]; p.dh = strides[13]; p.ds = strides[14];
  p.gqb = strides[15]; p.gqh = strides[16]; p.gqs = strides[17];
  p.gkb = strides[18]; p.gkh = strides[19]; p.gks = strides[20];
  p.gvb = strides[21]; p.gvh = strides[22]; p.gvs = strides[23];
  p.h = h;
  p.kvh = kvh;
  p.group = h / kvh;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = window;
  p.n_rows = static_cast<int64_t>(b) * h * sq;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(p, bf16, b, s);
    case 32: return launch_hd<32>(p, bf16, b, s);
    case 64: return launch_hd<64>(p, bf16, b, s);
    case 80: return launch_hd<80>(p, bf16, b, s);
    case 128: return launch_hd<128>(p, bf16, b, s);
    case 256: return launch_hd<256>(p, bf16, b, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
