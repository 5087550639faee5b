// Blocked online-softmax attention (flash) forward, for Hopper (sm_90a).
// Replaces one Pallas kernel of src/repro/kernels/flash_attention.py:
//
//   fa_forward <- flash_attention (:78), _attn_kernel (:23)
//
// q [b, h, sq, hd], k / v [b, kvh, skv, hd] -> o [b, h, sq, hd] in q's
// dtype (f32 or bf16 storage), every tensor given by its strides with a
// unit stride on hd, so the model's [b, s, h, hd] projections are read in
// place.  Query head hi reads kv head hi / (h / kvh) (GQA without a K/V
// copy).  For query position i and key position j (both counted from 0):
//
//   s   = (q_i . k_j) * scale                 f32, scale = 1/sqrt(hd)
//   s   = tanh(s / softcap) * softcap         when softcap is given
//   s   = -1e30 where causal and j > i, or a window is given and
//         j <= i - window                     (the Pallas kernel's mask)
//   o_i = sum_j exp(s - m) v_j / max(sum_j exp(s - m), 1e-30)
//
// with the running max m, the running sum and the output accumulator in
// f32, updated one kv tile at a time (online softmax) and p kept in f32
// for the P.V product, as the Pallas kernel does.  Keys past skv (the
// ragged last tile) get -inf and weigh nothing; query rows past sq are
// computed and not stored, so any sq and skv are taken.  The scale is
// applied to the f32 dot product (the model's blocked_attention spelling;
// the Pallas kernel scales q first and the plain version divides by
// sqrt(hd): equal up to rounding, see the tolerances in the tests).
//
// Grid: one block of 256 threads per (64-row query tile, b * h).  The
// block walks the kv tiles of 64 keys that its rows can see: tiles wholly
// above the diagonal (causal) or wholly before the window are skipped,
// as the Pallas kernel skips its causal tiles (:31-36).  Thread (ty, tx)
// of the 16 x 16 layout owns query rows 4ty..4ty+3 and, per tile, score
// columns 4tx..4tx+3; its rows' statistics are reduced over the 16 lanes
// of a half-warp with shuffles.  For the product with V it owns output
// columns tx, tx+16, ... of its 4 rows.  q, k, v and p tiles are staged
// in shared memory as f32 (q and k transposed, so a thread's 4 rows and
// 4 columns are one 16-byte load each): 4*(2*hd*68 + 64*hd + 64*68)
// bytes, 117 KB at hd 128 and 217 KB at hd 256.
//
// Bound on the H100: 4*hd FLOPs per visible (query, key) pair, for
// internlm2's prefill ([4,16,2048,128] bf16, causal) 68.7 GFLOP against
// 101 MB moved, so the product is the bound: 0.069 ms at the dense bf16
// tensor-core peak.  This design does the arithmetic on the CUDA cores
// (f32 FMAs; 67 TFLOP/s peak), so it cannot come near that bound.  bf16
// at hd 128 (the serving prefills' attention) therefore goes to the
// wgmma kernel on TMA-fed tiles, flash_attention_sm90.cu; this kernel
// keeps f32 (which the 2e-5 card-vs-CPU checks need) and every other
// head dim (flash_attention.py::route), and is not built for bf16 at hd
// 128.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per kv tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLD = kBQ + 4;     // leading dim of the transposed tiles
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  int h, group, sq, skv, causal, window;   // window <= 0: none
  float softcap, scale;                    // softcap <= 0: none
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// max / sum over the 16 lanes of a half-warp (the threads sharing ty)
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

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * HD * kLD + kBK * HD + kBK * kLD);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) attn_fwd(const Params P) {
  constexpr int NC = HD / 16;              // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                        // [HD][kLD]  q tile, transposed
  float* kt = qt + HD * kLD;               // [HD][kLD]  k tile, transposed
  float* vt = kt + HD * kLD;               // [kBK][HD]  v tile
  float* pt = vt + kBK * HD;               // [kBK][kLD] p tile, transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bi = blockIdx.y / P.h, hi = blockIdx.y % P.h;
  const int kvi = hi / P.group;
  const int q0 = blockIdx.x * kBQ;
  const T* q = static_cast<const T*>(P.q) + bi * P.qb + hi * P.qh;
  const T* k = static_cast<const T*>(P.k) + bi * P.kb + kvi * P.kh;
  const T* v = static_cast<const T*>(P.v) + bi * P.vb + kvi * P.vh;
  T* o = static_cast<T*>(P.o) + bi * P.ob + hi * P.oh;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD, qi = q0 + r;
    qt[d * kLD + r] = qi < P.sq ? load_f32(q + qi * P.qs + d) : 0.0f;
  }

  // the keys this tile's rows can see: [kv_lo, kv_hi)
  const int q_last = min(q0 + kBQ, P.sq) - 1;
  const int kv_hi = P.causal ? min(P.skv, q_last + 1) : P.skv;
  const int kv_lo = P.window > 0 ? max(0, q0 - P.window + 1) : 0;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (kv_lo / kBK) * kBK; k0 < kv_hi; k0 += kBK) {
    __syncthreads();                       // previous tile fully consumed
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD, kj = k0 + r;
      const bool in = kj < P.skv;
      kt[d * kLD + r] = in ? load_f32(k + kj * P.ks + d) : 0.0f;
      vt[r * HD + d] = in ? load_f32(v + kj * P.vs + d) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLD + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kLD + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * tx + j;
        float x = s[i][j] * P.scale;
        if (P.softcap > 0.0f) x = tanhf(x / P.softcap) * P.softcap;
        if (kp >= P.skv)
          x = -INFINITY;                   // past the ragged end: no weight
        else if ((P.causal && kp > qp) ||
                 (P.window > 0 && kp <= qp - P.window))
          x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (4 * tx + j) * kLD + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + j * kLD + 4 * ty);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vt[j * HD + tx + 16 * c];
        acc[0][c] = fmaf(p4.x, vv, acc[0][c]);
        acc[1][c] = fmaf(p4.y, vv, acc[1][c]);
        acc[2][c] = fmaf(p4.z, vv, acc[2][c]);
        acc[3][c] = fmaf(p4.w, vv, acc[3][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= P.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_f32(o + qp * P.os + tx + 16 * c, acc[i][c] / den);
  }
}

template <int HD, typename T>
cudaError_t launch_typed(const Params& p, dim3 grid, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err = once_a_device(configured, [] {
    return cudaFuncSetAttribute(attn_fwd<HD, T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_bytes<HD>()));
  });
  if (err != cudaSuccess) return err;
  attn_fwd<HD, T><<<grid, kThreads, smem_bytes<HD>(), stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const Params& p, int bf16, dim3 grid,
                      cudaStream_t stream) {
  return bf16 ? launch_typed<HD, __nv_bfloat16>(p, grid, stream)
              : launch_typed<HD, float>(p, grid, stream);
}

}  // namespace

extern "C" {

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: 12 int64 in elements, (batch, head, seq) of q, k, v, o.
// dtype: 0 f32, 1 bf16.  hd in {16, 32, 64, 80, 128, 256}, bf16 at hd
// 128 excepted (flash_attention_sm90.cu takes it); anything else returns
// cudaErrorInvalidValue (the wrapper routes or refuses it first).
int fa_forward(const void* q, const void* k, const void* v, void* o,
               const int64_t* strides, int bf16, int b, int h, int kvh,
               int sq, int skv, int hd, int causal, int window,
               float softcap, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qb = strides[0]; p.qh = strides[1]; p.qs = strides[2];
  p.kb = strides[3]; p.kh = strides[4]; p.ks = strides[5];
  p.vb = strides[6]; p.vh = strides[7]; p.vs = strides[8];
  p.ob = strides[9]; p.oh = strides[10]; p.os = strides[11];
  p.h = h;
  p.group = h / kvh;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(p, bf16, grid, s);
    case 32: return launch_hd<32>(p, bf16, grid, s);
    case 64: return launch_hd<64>(p, bf16, grid, s);
    case 80: return launch_hd<80>(p, bf16, grid, s);
    case 128:                    // bf16 is the wgmma kernel's
      return bf16 ? cudaErrorInvalidValue
                  : launch_typed<128, float>(p, grid, s);
    case 256: return launch_hd<256>(p, bf16, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
