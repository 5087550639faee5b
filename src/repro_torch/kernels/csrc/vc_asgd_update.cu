// Flat-bus kernels of the VC-ASGD main path, for Hopper (sm_90a).
//
// Five elementwise passes over the BLOCK-padded flat parameter bus
// (core/flat.py): Eq. 1 (lerp), DC-ASGD's corrected lerp, Eq. 2 (the
// weighted multi-client reduction), fused Adam and the elastic EASGD
// round.  Each replaces one Pallas kernel of
// src/repro/kernels/vc_asgd_update.py:
//
//   vc_lerp_*      <- vc_asgd_lerp_flat (:172), vc_asgd_lerp (:146),
//                     _lerp_kernel (:49)                              (B1)
//   vc_dc_lerp_*   <- vc_asgd_dc_lerp_flat (:180), vc_asgd_dc_lerp (:153),
//                     _dc_lerp_kernel (:56)                           (B4)
//   vc_assimilate_*<- assimilate_flat (:188), _assimilate_kernel (:69)
//   vc_adam_*      <- adam_update_flat (:222), _adam_kernel (:80)
//   vc_easgd_*     <- easgd_elastic_flat (:251), _easgd_kernel (:98)
//
// Bound on the H100 (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s f32): all five
// are memory-bound by two orders of magnitude.  Per element of an f32 bus
// they move 12 B (lerp: s, c in, out), 20 B (DC lerp: s, c, g, b in, out;
// 10 B in bf16), 4*(n+2) B (Eq. 2 over n clients), 28 B (Adam: p, g, m,
// v in, p, m, v out) and 8*(n+1) B (EASGD: center and n replicas in and
// out) for 3, 8, 2n+1, 14 and 4n+2 flops.
// The design answers that bound with the simplest thing that streams:
// each thread owns whole 16-byte vectors, a grid-stride loop over a grid
// of a few blocks per SM, loads and stores issued straight from
// registers, nothing staged in shared memory (no reuse to exploit).  Eq. 2
// and EASGD read the n client or replica rows in order inside the thread,
// so every output is one pass.  The flat bus is a multiple of 8192, so it
// has no tail; the lerps also serve the per-tensor entries (any shape),
// whose n % V elements after the last pack the first threads of block 0
// take one each: no padded copies.
//
// Numerics: the reference pins these results bit for bit (separate f32
// multiply and add, no FMA; IEEE division and square root), so every
// operation is spelled out with the _rn intrinsics — nvcc would contract
// a*s + b*c into an FMA otherwise.  DC-ASGD keeps the reference's order,
// ((lam*g)*g)*(s - b).  Storage is f32 or bf16 (bus.cuh).
//
// Every entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "bus.cuh"
#include "grid.cuh"

namespace {

constexpr int kMaxWeights = 512;   // Eq. 2: n_clients + 1 <= kMaxWeights

// Eq. 2 weights ride in the kernel's parameter space (read-only, uniform
// across threads); __grid_constant__ keeps the indexed reads there instead
// of copying the array into every thread's local memory
struct Weights {
  float w[kMaxWeights];
};

// ---- Eq. 1: out = a*s + (1-a)*c ------------------------------------------
template <typename T>
__device__ __forceinline__ T lerp1(float a, float oma, T s, T c) {
  return narrow<T>(__fadd_rn(__fmul_rn(a, widen(s)), __fmul_rn(oma, widen(c))));
}

// DC-ASGD: c' = c + ((lam*g)*g)*(s - b), then Eq. 1 on c'
template <typename T>
__device__ __forceinline__ T dc_lerp1(float a, float oma, float lam, T s, T c,
                                      T g, T b) {
  const float sf = widen(s), gf = widen(g);
  const float corr = __fmul_rn(__fmul_rn(__fmul_rn(lam, gf), gf),
                               __fsub_rn(sf, widen(b)));
  const float cc = __fadd_rn(widen(c), corr);
  return narrow<T>(__fadd_rn(__fmul_rn(a, sf), __fmul_rn(oma, cc)));
}

// n elements: n / V whole packs by the grid-stride loop, then the n % V
// elements after them (the per-tensor entries' ragged tail), one each
// for the first threads of block 0
template <typename T>
__global__ void lerp_kernel(const T* __restrict__ s, const T* __restrict__ c,
                            T* __restrict__ out, float a, float oma,
                            int64_t n) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const int64_t nvec = n / V;
  const P* sp = reinterpret_cast<const P*>(s);
  const P* cp = reinterpret_cast<const P*>(c);
  P* op = reinterpret_cast<P*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const P sv = sp[i];
    const P cv = cp[i];
    P ov;
#pragma unroll
    for (int k = 0; k < V; ++k) ov.v[k] = lerp1(a, oma, sv.v[k], cv.v[k]);
    op[i] = ov;
  }
  const int64_t t = nvec * V + threadIdx.x;
  if (blockIdx.x == 0 && t < n) out[t] = lerp1(a, oma, s[t], c[t]);
}

template <typename T>
__global__ void dc_lerp_kernel(const T* __restrict__ s,
                               const T* __restrict__ c,
                               const T* __restrict__ g,
                               const T* __restrict__ b, T* __restrict__ out,
                               float a, float oma, float lam, int64_t n) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const int64_t nvec = n / V;
  const P* sp = reinterpret_cast<const P*>(s);
  const P* cp = reinterpret_cast<const P*>(c);
  const P* gp = reinterpret_cast<const P*>(g);
  const P* bp = reinterpret_cast<const P*>(b);
  P* op = reinterpret_cast<P*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const P sv = sp[i], cv = cp[i], gv = gp[i], bv = bp[i];
    P ov;
#pragma unroll
    for (int k = 0; k < V; ++k)
      ov.v[k] = dc_lerp1(a, oma, lam, sv.v[k], cv.v[k], gv.v[k], bv.v[k]);
    op[i] = ov;
  }
  const int64_t t = nvec * V + threadIdx.x;
  if (blockIdx.x == 0 && t < n)
    out[t] = dc_lerp1(a, oma, lam, s[t], c[t], g[t], b[t]);
}

template <typename T>
int lerp_launch(const void* s, const void* c, void* out, float a, float oma,
                int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  lerp_kernel<T><<<grid_for(n / (16 / sizeof(T))), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const T*>(c), static_cast<T*>(out),
      a, oma, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dc_lerp_launch(const void* s, const void* c, const void* g, const void* b,
                   void* out, float a, float oma, float lam, int64_t n,
                   void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  dc_lerp_kernel<T><<<grid_for(n / (16 / sizeof(T))), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const T*>(c),
      static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(out), a, oma, lam, n);
  return static_cast<int>(cudaGetLastError());
}

// ---- Eq. 2: out = w0*s + sum_j w[j+1]*c_j, j in arrival order -------------
template <typename T>
__global__ void assimilate_kernel(const T* __restrict__ s,
                                  const T* __restrict__ clients,
                                  T* __restrict__ out,
                                  const __grid_constant__ Weights w,
                                  int n_clients, int64_t nvec) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const P* sp = reinterpret_cast<const P*>(s);
  const P* cp = reinterpret_cast<const P*>(clients);
  P* op = reinterpret_cast<P*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const P sv = sp[i];
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = __fmul_rn(w.w[0], widen(sv.v[k]));
    for (int j = 0; j < n_clients; ++j) {
      const P cv = cp[static_cast<int64_t>(j) * nvec + i];
      const float wj = w.w[j + 1];
#pragma unroll
      for (int k = 0; k < V; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, widen(cv.v[k])));
    }
    P ov;
#pragma unroll
    for (int k = 0; k < V; ++k) ov.v[k] = narrow<T>(acc[k]);
    op[i] = ov;
  }
}

// ---- fused Adam ------------------------------------------------------------
struct AdamScalars {
  float lr, b1, omb1, b2, omb2, eps, lr_wd, c1, c2;
};

template <typename T>
__global__ void adam_kernel(const T* __restrict__ p, const float* __restrict__ g,
                            const float* __restrict__ m,
                            const float* __restrict__ v, T* __restrict__ po,
                            float* __restrict__ mo, float* __restrict__ vo,
                            const AdamScalars sc, int64_t nvec) {
  constexpr int V = 4;
  using PT = Pack<T, V>;
  using PF = Pack<float, V>;
  const PT* pp = reinterpret_cast<const PT*>(p);
  const PF* gp = reinterpret_cast<const PF*>(g);
  const PF* mp = reinterpret_cast<const PF*>(m);
  const PF* vp = reinterpret_cast<const PF*>(v);
  PT* pop = reinterpret_cast<PT*>(po);
  PF* mop = reinterpret_cast<PF*>(mo);
  PF* vop = reinterpret_cast<PF*>(vo);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const PT pv = pp[i];
    const PF gv = gp[i], mv = mp[i], vv = vp[i];
    PT pn;
    PF mn, vn;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float gk = gv.v[k];
      // m' = b1*m + (1-b1)*g ; v' = b2*v + ((1-b2)*g)*g
      const float mk = __fadd_rn(__fmul_rn(sc.b1, mv.v[k]), __fmul_rn(sc.omb1, gk));
      const float vk = __fadd_rn(__fmul_rn(sc.b2, vv.v[k]),
                                 __fmul_rn(__fmul_rn(sc.omb2, gk), gk));
      const float pk = widen(pv.v[k]);
      // step = (lr*(m'/c1)) / (sqrt(v'/c2) + eps) [+ (lr*wd)*p]
      float step = __fdiv_rn(__fmul_rn(sc.lr, __fdiv_rn(mk, sc.c1)),
                             __fadd_rn(__fsqrt_rn(__fdiv_rn(vk, sc.c2)), sc.eps));
      if (sc.lr_wd != 0.0f) step = __fadd_rn(step, __fmul_rn(sc.lr_wd, pk));
      pn.v[k] = narrow<T>(__fsub_rn(pk, step));
      mn.v[k] = mk;
      vn.v[k] = vk;
    }
    pop[i] = pn;
    mop[i] = mn;
    vop[i] = vn;
  }
}

// ---- elastic EASGD round over the whole pod ---------------------------------
// diff_j = x_j - c;  acc = ((0 + diff_0) + diff_1) + ...  (replica order,
// from zero, as the Pallas _easgd_kernel carries it);  c' = c + beta*acc;
// x_j' = x_j - beta*diff_j.  Separate f32 multiply and add, beta an f32.
template <typename T>
__global__ void easgd_kernel(const T* __restrict__ c,
                             const T* __restrict__ x, T* __restrict__ co,
                             T* __restrict__ xo, float beta, int n_replicas,
                             int64_t nvec) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const P* cp = reinterpret_cast<const P*>(c);
  const P* xp = reinterpret_cast<const P*>(x);
  P* cop = reinterpret_cast<P*>(co);
  P* xop = reinterpret_cast<P*>(xo);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += stride) {
    const P cv = cp[i];
    float cf[V], acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      cf[k] = widen(cv.v[k]);
      acc[k] = 0.0f;
    }
    for (int j = 0; j < n_replicas; ++j) {
      const int64_t row = static_cast<int64_t>(j) * nvec + i;
      const P xv = xp[row];
      P ov;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xk = widen(xv.v[k]);
        const float d = __fsub_rn(xk, cf[k]);
        acc[k] = __fadd_rn(acc[k], d);
        ov.v[k] = narrow<T>(__fsub_rn(xk, __fmul_rn(beta, d)));
      }
      xop[row] = ov;
    }
    P ov;
#pragma unroll
    for (int k = 0; k < V; ++k)
      ov.v[k] = narrow<T>(__fadd_rn(cf[k], __fmul_rn(beta, acc[k])));
    cop[i] = ov;
  }
}

template <typename T>
int easgd_launch(const void* c, const void* x, void* co, void* xo,
                 float beta, int n_replicas, int64_t n, void* stream) {
  if (n_replicas < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nvec = n / (16 / sizeof(T));
  easgd_kernel<T><<<grid_for(nvec), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(c), static_cast<const T*>(x), static_cast<T*>(co),
      static_cast<T*>(xo), beta, n_replicas, nvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int assimilate_launch(const void* s, const void* clients, void* out,
                      const float* weights, int n_clients, int64_t n,
                      void* stream) {
  if (n_clients < 1 || n_clients + 1 > kMaxWeights)
    return static_cast<int>(cudaErrorInvalidValue);
  Weights w;
  for (int j = 0; j <= n_clients; ++j) w.w[j] = weights[j];
  const int64_t nvec = n / (16 / sizeof(T));
  assimilate_kernel<T><<<grid_for(nvec), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const T*>(clients),
      static_cast<T*>(out), w, n_clients, nvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int adam_launch(const void* p, const void* g, const void* m, const void* v,
                void* po, void* mo, void* vo, const float* scal, int64_t n,
                void* stream) {
  const AdamScalars sc{scal[0], scal[1], scal[2], scal[3], scal[4],
                       scal[5], scal[6], scal[7], scal[8]};
  const int64_t nvec = n / 4;
  adam_kernel<T><<<grid_for(nvec), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<T*>(po), static_cast<float*>(mo), static_cast<float*>(vo),
      sc, nvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* vc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// s, c [n] -> out [n]; any n >= 1 (packs, then the ragged tail)
int vc_lerp_f32(const void* s, const void* c, void* out, float a, float oma,
                int64_t n, void* stream) {
  return lerp_launch<float>(s, c, out, a, oma, n, stream);
}

int vc_lerp_bf16(const void* s, const void* c, void* out, float a, float oma,
                 int64_t n, void* stream) {
  return lerp_launch<uint16_t>(s, c, out, a, oma, n, stream);
}

// s, c, g, b [n] -> out [n]; any n >= 1
int vc_dc_lerp_f32(const void* s, const void* c, const void* g, const void* b,
                   void* out, float a, float oma, float lam, int64_t n,
                   void* stream) {
  return dc_lerp_launch<float>(s, c, g, b, out, a, oma, lam, n, stream);
}

int vc_dc_lerp_bf16(const void* s, const void* c, const void* g,
                    const void* b, void* out, float a, float oma, float lam,
                    int64_t n, void* stream) {
  return dc_lerp_launch<uint16_t>(s, c, g, b, out, a, oma, lam, n, stream);
}

int vc_max_weights(void) { return kMaxWeights; }

int vc_assimilate_f32(const void* s, const void* clients, void* out,
                      const float* weights, int n_clients, int64_t n,
                      void* stream) {
  return assimilate_launch<float>(s, clients, out, weights, n_clients, n,
                                  stream);
}

int vc_assimilate_bf16(const void* s, const void* clients, void* out,
                       const float* weights, int n_clients, int64_t n,
                       void* stream) {
  return assimilate_launch<uint16_t>(s, clients, out, weights, n_clients, n,
                                     stream);
}

// scal = [lr, b1, 1-b1, b2, 1-b2, eps, lr*wd, c1, c2], each f32
int vc_adam_f32(const void* p, const void* g, const void* m, const void* v,
                void* po, void* mo, void* vo, const float* scal, int64_t n,
                void* stream) {
  return adam_launch<float>(p, g, m, v, po, mo, vo, scal, n, stream);
}

int vc_adam_bf16(const void* p, const void* g, const void* m, const void* v,
                 void* po, void* mo, void* vo, const float* scal, int64_t n,
                 void* stream) {
  return adam_launch<uint16_t>(p, g, m, v, po, mo, vo, scal, n, stream);
}

// center [n], replicas [n_replicas, n] -> center', replicas'
int vc_easgd_f32(const void* c, const void* x, void* co, void* xo, float beta,
                 int n_replicas, int64_t n, void* stream) {
  return easgd_launch<float>(c, x, co, xo, beta, n_replicas, n, stream);
}

int vc_easgd_bf16(const void* c, const void* x, void* co, void* xo,
                  float beta, int n_replicas, int64_t n, void* stream) {
  return easgd_launch<uint16_t>(c, x, co, xo, beta, n_replicas, n, stream);
}

}  // extern "C"
