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
// - dq pass: one block of 256 threads per (64-row query tile, b * h).
//   It computes delta, walks its kv tiles once for the row statistics
//   (m, l), stores them with delta for the second kernel, then walks them
//   again for ds and dq.  Thread (ty, tx) of the 16 x 16 layout owns
//   rows 4ty..4ty+3 and, per kv tile, columns 4tx..4tx+3 of the 64 x 64
//   score tile (the forward's layout), and output columns tx, tx+16, ...
//   of its rows.
// - dk / dv pass: one block per (64-key tile, b * kvh).  It keeps the
//   tile's dk and dv in registers (thread (ty, tx): keys 4ty..4ty+3,
//   columns tx, tx+16, ...) and walks, for each query head of the group
//   in order, every query tile that sees one of its keys (causal: from
//   the tile's first key; window: up to its last key + window).
//
// Shared memory holds the tiles in f32, the row operands of a 4 x 4 tile
// product transposed ([hd][68]), so a thread's 4 rows and 4 columns are
// one 16-byte load each: dq pass 4 * (4 * 68 * hd + 64 * hd + 64 * 68)
// bytes (189 KB at hd 128), dk / dv pass 4 * (4 * 68 * hd + 2 * 64 * hd +
// 64 * 68 + 3 * 64) bytes (223 KB at hd 128: one block an SM).
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

constexpr int kBQ = 64;          // query rows a tile
constexpr int kBK = 64;          // keys a tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLD = kBQ + 4;     // leading dim of the transposed tiles
constexpr float kMasked = -1e30f;

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

// s[i][j] = sum_d a[d][4ty + i] * b[d][4tx + j]: a 4 x 4 block of the
// product of two transposed [HD][kLD] tiles
template <int HD>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * kLD + 4 * ty);
    const float4 y = *reinterpret_cast<const float4*>(b + d * kLD + 4 * tx);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
  }
}

// acc[i][c] += sum_r pt[r][4ty + i] * rows[r][tx + 16c] over the 64 rows
// r of a transposed [64][kLD] tile and a row-major [64][HD] tile
template <int HD>
__device__ __forceinline__ void tile_acc(const float* pt, const float* rows,
                                         int ty, int tx,
                                         float (&acc)[4][HD / 16]) {
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    const float4 p4 = *reinterpret_cast<const float4*>(pt + r * kLD + 4 * ty);
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float x = rows[r * HD + tx + 16 * c];
      acc[0][c] = fmaf(p4.x, x, acc[0][c]);
      acc[1][c] = fmaf(p4.y, x, acc[1][c]);
      acc[2][c] = fmaf(p4.z, x, acc[2][c]);
      acc[3][c] = fmaf(p4.w, x, acc[3][c]);
    }
  }
}

// rows [r0, r0 + 64) of a [n, HD] operand (row stride rs) into a
// transposed [HD][kLD] tile and, when row_major is given, a row-major
// [64][HD] copy; rows past n are zero
template <int HD, typename T>
__device__ __forceinline__ void load_tile(const T* src, int64_t rs, int r0,
                                          int n, float* transposed,
                                          float* row_major) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, row = r0 + r;
    const float x = row < n ? load_f32(src + row * rs + d) : 0.0f;
    transposed[d * kLD + r] = x;
    if (row_major != nullptr) row_major[r * HD + d] = x;
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * HD * kLD + kBK * HD + kBK * kLD);
}
template <int HD>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * HD * kLD + 2 * kBQ * HD + kBQ * kLD + 3 * kBQ);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(const Params P) {
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                        // [HD][kLD]  q tile
  float* dot = qt + HD * kLD;              // [HD][kLD]  dO tile
  float* kt = dot + HD * kLD;              // [HD][kLD]  k tile
  float* vt = kt + HD * kLD;               // [HD][kLD]  v tile
  float* kr = vt + HD * kLD;               // [kBK][HD]  k tile, row-major
  float* pt = kr + kBK * HD;               // [kBK][kLD] ds tile, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.y / P.h, hi = blockIdx.y % P.h;
  const int kvi = hi / P.group;
  const int q0 = blockIdx.x * kBQ;
  const T* q = static_cast<const T*>(P.q) + bi * P.qb + hi * P.qh;
  const T* dout = static_cast<const T*>(P.dout) + bi * P.db + hi * P.dh;
  const T* o = static_cast<const T*>(P.o) + bi * P.ob + hi * P.oh;
  const T* k = static_cast<const T*>(P.k) + bi * P.kb + kvi * P.kh;
  const T* v = static_cast<const T*>(P.v) + bi * P.vb + kvi * P.vh;
  T* dq = static_cast<T*>(P.dq) + bi * P.gqb + hi * P.gqh;

  load_tile<HD>(q, P.qs, q0, P.sq, qt, static_cast<float*>(nullptr));
  load_tile<HD>(dout, P.ds, q0, P.sq, dot, static_cast<float*>(nullptr));
  __syncthreads();

  // delta_i = dO_i . o_i over the 16 lanes of the row's half-warp
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, qp = q0 + r;
    float part = 0.0f;
    if (qp < P.sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        part = fmaf(dot[d * kLD + r], load_f32(o + qp * P.os + d), part);
      }
    }
    delta[i] = half_warp_sum(part);
  }

  const int q_last = min(q0 + kBQ, P.sq) - 1;
  const int kv_hi = P.causal ? min(P.skv, q_last + 1) : P.skv;
  const int kv_lo = P.window > 0 ? max(0, q0 - P.window + 1) : 0;
  const int k_first = (kv_lo / kBK) * kBK;

  // pass 1: the forward's row statistics, in its tile order
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
  }
  for (int k0 = k_first; k0 < kv_hi; k0 += kBK) {
    __syncthreads();
    load_tile<HD>(k, P.ks, k0, P.skv, kt, static_cast<float*>(nullptr));
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(qt, kt, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * tx + j;
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
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }
  float den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    den[i] = fmaxf(l[i], 1e-30f);
    const int qp = q0 + 4 * ty + i;
    if (tx == 0 && qp < P.sq) {
      const int64_t row = static_cast<int64_t>(blockIdx.y) * P.sq + qp;
      P.stats[row] = m[i];
      P.stats[P.n_rows + row] = den[i];
      P.stats[2 * P.n_rows + row] = delta[i];
    }
  }

  // pass 2: ds and dq
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int k0 = k_first; k0 < kv_hi; k0 += kBK) {
    __syncthreads();                       // previous tile consumed
    load_tile<HD>(k, P.ks, k0, P.skv, kt, kr);
    load_tile<HD>(v, P.vs, k0, P.skv, vt, static_cast<float*>(nullptr));
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(qt, kt, ty, tx, s);
    tile_dot<HD>(dot, vt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * tx + j;
        const bool out = kp >= P.skv || masked(P, qp, kp);
        const float p = out ? 0.0f : expf(s[i][j] * P.scale - m[i]) / den[i];
        s[i][j] = p * (dp[i][j] - delta[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kLD + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    tile_acc<HD>(pt, kr, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= P.sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_f32(dq + qp * P.gqs + tx + 16 * c, acc[i][c] * P.scale);
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv(const Params P) {
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                        // [HD][kLD]  k tile
  float* vt = kt + HD * kLD;               // [HD][kLD]  v tile
  float* qt = vt + HD * kLD;               // [HD][kLD]  q tile
  float* dot = qt + HD * kLD;              // [HD][kLD]  dO tile
  float* qr = dot + HD * kLD;              // [kBQ][HD]  q tile, row-major
  float* dor = qr + kBQ * HD;              // [kBQ][HD]  dO tile, row-major
  float* pt = dor + kBQ * HD;              // [kBQ][kLD] p, then ds
  float* sm_m = pt + kBQ * kLD;            // [kBQ] the rows' statistics
  float* sm_den = sm_m + kBQ;
  float* sm_delta = sm_den + kBQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.y / P.kvh, kvi = blockIdx.y % P.kvh;
  const int k0 = blockIdx.x * kBK;
  const T* k = static_cast<const T*>(P.k) + bi * P.kb + kvi * P.kh;
  const T* v = static_cast<const T*>(P.v) + bi * P.vb + kvi * P.vh;
  T* dk = static_cast<T*>(P.dk) + bi * P.gkb + kvi * P.gkh;
  T* dv = static_cast<T*>(P.dv) + bi * P.gvb + kvi * P.gvh;

  load_tile<HD>(k, P.ks, k0, P.skv, kt, static_cast<float*>(nullptr));
  load_tile<HD>(v, P.vs, k0, P.skv, vt, static_cast<float*>(nullptr));

  // the query rows that see one of this tile's keys: [q_lo, q_hi)
  const int k_last = min(k0 + kBK, P.skv) - 1;
  const int q_lo = P.causal ? k0 : 0;
  const int q_hi = P.window > 0 ? min(P.sq, k_last + P.window) : P.sq;

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk_acc[i][c] = 0.0f;
      dv_acc[i][c] = 0.0f;
    }

  for (int g = 0; g < P.group; ++g) {
    const int hi = kvi * P.group + g;
    const T* q = static_cast<const T*>(P.q) + bi * P.qb + hi * P.qh;
    const T* dout = static_cast<const T*>(P.dout) + bi * P.db + hi * P.dh;
    const int64_t row0 = (static_cast<int64_t>(bi) * P.h + hi) * P.sq;
    for (int q0 = (q_lo / kBQ) * kBQ; q0 < q_hi; q0 += kBQ) {
      __syncthreads();                     // previous tile consumed
      load_tile<HD>(q, P.qs, q0, P.sq, qt, qr);
      load_tile<HD>(dout, P.ds, q0, P.sq, dot, dor);
      if (tid < kBQ) {
        const int qp = q0 + tid;
        const bool in = qp < P.sq;
        sm_m[tid] = in ? P.stats[row0 + qp] : 0.0f;
        sm_den[tid] = in ? P.stats[P.n_rows + row0 + qp] : 1.0f;
        sm_delta[tid] = in ? P.stats[2 * P.n_rows + row0 + qp] : 0.0f;
      }
      __syncthreads();
      // transposed tiles: rows are this block's keys, columns the queries
      float p[4][4], dp[4][4];
      tile_dot<HD>(kt, qt, ty, tx, p);
      tile_dot<HD>(vt, dot, ty, tx, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * ty + j;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * tx + i, qp = q0 + c;
          const bool out = kp >= P.skv || qp >= P.sq || masked(P, qp, kp);
          p[j][i] = out ? 0.0f
                        : expf(p[j][i] * P.scale - sm_m[c]) / sm_den[c];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(pt + (4 * tx + i) * kLD + 4 * ty) =
            make_float4(p[0][i], p[1][i], p[2][i], p[3][i]);
      __syncthreads();
      tile_acc<HD>(pt, dor, ty, tx, dv_acc);
      __syncthreads();                     // p read by every thread
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dl = sm_delta[4 * tx + i];
        *reinterpret_cast<float4*>(pt + (4 * tx + i) * kLD + 4 * ty) =
            make_float4(p[0][i] * (dp[0][i] - dl), p[1][i] * (dp[1][i] - dl),
                        p[2][i] * (dp[2][i] - dl), p[3][i] * (dp[3][i] - dl));
      }
      __syncthreads();
      tile_acc<HD>(pt, qr, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kp = k0 + 4 * ty + j;
    if (kp >= P.skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store_f32(dk + kp * P.gks + tx + 16 * c, dk_acc[j][c] * P.scale);
      store_f32(dv + kp * P.gvs + tx + 16 * c, dv_acc[j][c]);
    }
  }
}

template <int HD, typename T>
cudaError_t launch_typed(const Params& p, int b, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = once_a_device(configured, [] {
    cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dq<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dq_smem_bytes<HD>()));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        attn_bwd_dkv<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkv_smem_bytes<HD>()));
  });
  if (err != cudaSuccess) return err;
  const dim3 grid_dq((p.sq + kBQ - 1) / kBQ, b * p.h);
  attn_bwd_dq<HD, T><<<grid_dq, kThreads, dq_smem_bytes<HD>(), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkv((p.skv + kBK - 1) / kBK, b * p.kvh);
  attn_bwd_dkv<HD, T>
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
// 1 bf16.  hd in {16, 32, 64, 80, 128}; anything else returns
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
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
