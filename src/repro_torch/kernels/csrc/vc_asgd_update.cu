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
// each thread owns whole 16-byte vectors, loads and stores issued straight
// from registers, nothing staged in shared memory (no reuse to exploit).
// Eq. 2 and EASGD read the n client or replica rows in order inside the
// thread, so every output is one pass.  The flat bus is a multiple of
// 8192, so it has no tail; the lerps also serve the per-tensor entries
// (any shape), whose n % V elements after the last pack the first threads
// of block 0 take one each: no padded copies.  Eq. 1, Eq. 2 and Adam take
// a grid that covers the bus, a chunk a block, with evict-first loads and
// stores, EASGD the same grid with default caching (see each kernel's
// note); DC-ASGD a grid-stride loop over a grid of a few blocks per SM.
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

// fused Adam's scalars, each an f32, passed by value through the C entry
// (vc_asgd_update.py's AdamScalars has this layout)
struct AdamScalars {
  float lr, b1, omb1, b2, omb2, eps, lr_wd, c1, c2;
};

// Eq. 2's weights for 1 <= n_clients <= kFixedClients, passed by value
// (vc_asgd_update.py's FixedWeights has this layout; the unused tail is 0)
constexpr int kFixedClients = 8;
struct FixedWeights {
  float w[kFixedClients + 1];
};

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

// Eq. 1 (B1) as an unrolled streaming pass.
//
// What bounds it.  On the training loop's bus (the MLP's 16,384 f32
// elements, 196,608 bytes: 0.0000587 ms at 3.35 TB/s) the device work is
// the launch itself, a few microseconds; what a call costs there is its
// host path (the wrapper's checks, allocation, stream lookup and ctypes
// call: vc_asgd_update.py).  At bus scale (2^27 elements, 1.61 GB,
// 0.4808 ms) it is HBM bytes: 12 B an f32 element for 3 flops.
//
// What the design does.  Each thread issues kLerpUnroll independent
// 16-byte loads of each input before any arithmetic, with the
// evict-first hint on every load and store (each byte is touched once;
// the step's other kernels keep their L2 lines).  Each block takes one
// chunk of kLerpUnroll * kStreamThreads packs, a thread's packs a block's
// width apart (every load one coalesced warp access), and the grid covers
// the bus (grid.cuh stream_grid): no grid-stride loop.  The MLP bus's
// 4,096 f32 packs take 32 blocks on 32 SMs.  On the H100 at 2^27 the
// grid-stride loop this kernel had (a few blocks an SM) held HBM at
// 83-87% of the bound, Adam's at 84-86%; a grid that covers the bus holds
// 91-92% here and 88-91% in Adam (wrapper_cost.py, the two trees in
// turns), torch.lerp's and better than torch._fused_adam_'s 78-82%.  An
// unroll of 1, 2 or 4 made no difference once the grid covered the bus.
// Each pack is loaded, computed and stored under its own bound check (the
// last block's chunk runs out early): one code path.  A per-tensor call's
// n % V elements after the last pack go to the first threads of block 0,
// one each: no padded copies.
constexpr int kLerpUnroll = 2;

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
lerp_kernel(const T* __restrict__ s, const T* __restrict__ c,
            T* __restrict__ out, float a, float oma, int64_t n) {
  constexpr int V = 16 / sizeof(T), U = kLerpUnroll;
  using P = Pack<T, V>;
  const int64_t nvec = n / V;
  const P* sp = reinterpret_cast<const P*>(s);
  const P* cp = reinterpret_cast<const P*>(c);
  P* op = reinterpret_cast<P*>(out);
  // this thread's packs: i, i + kStreamThreads, ... (those below nvec)
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * U * kStreamThreads + threadIdx.x;
  if (i < nvec) {
    P sv[U], cv[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (i + j * kStreamThreads < nvec)
        sv[j] = load_stream(sp + i + j * kStreamThreads);
#pragma unroll
    for (int j = 0; j < U; ++j)
      if (i + j * kStreamThreads < nvec)
        cv[j] = load_stream(cp + i + j * kStreamThreads);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (i + j * kStreamThreads < nvec) {
        P ov;
#pragma unroll
        for (int k = 0; k < V; ++k)
          ov.v[k] = lerp1(a, oma, sv[j].v[k], cv[j].v[k]);
        store_stream(op + i + j * kStreamThreads, ov);
      }
    }
  }
  if (blockIdx.x == 0) {
    const int64_t t = nvec * V + threadIdx.x;
    if (t < n) out[t] = lerp1(a, oma, s[t], c[t]);
  }
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
  lerp_kernel<T><<<stream_grid(n / (16 / sizeof(T)), kLerpUnroll),
                   kStreamThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

// ---- Eq. 2 (B2): out = w0*s + sum_j w[j+1]*c_j, j in arrival order --------
//
// What bounds it.  On 4b's batch (four results on the MLP's 16,384-element
// f32 bus, 393,216 bytes: 0.000117 ms at 3.35 TB/s) a call costs its launch
// and its host path (vc_asgd_update.py), not device time.  At bus scale
// (2^27 elements, n = 4: 3.22 GB, 0.9616 ms) it is HBM bytes: 4 (n + 2) B
// an f32 element for 2n + 1 flops.
//
// What the design does.  As Eq. 1 (whose note has the measurements): a
// grid that covers the bus, one pack of each stream a thread, no
// grid-stride loop, every load and store evict-first (each byte is touched
// once).  The client count is a template parameter for 1 <= n <=
// kFixedClients (4b's results, the pod's islands and the tests' counts), so
// each thread issues its server pack and all n client packs, n + 1
// independent 16-byte loads, before the first multiply; the n + 1 weights
// ride by value in the kernel's parameter space (FixedWeights, 36 bytes).
// A larger count (up to kMaxWeights - 1) takes one generic instance on the
// same grid: a runtime loop over the clients, the weights in a 2,048-byte
// __grid_constant__ struct.  Each output is folded exactly as the plain
// version folds it, acc = w0*s, then acc = acc + w_{j+1}*c_j in arrival
// order, with separate _rn multiplies and adds.
template <typename T, int NC>
__global__ void __launch_bounds__(kStreamThreads)
assimilate_fixed_kernel(const T* __restrict__ s, const T* __restrict__ clients,
                        T* __restrict__ out, const FixedWeights w,
                        int64_t nvec) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kStreamThreads + threadIdx.x;
  if (i >= nvec) return;
  const P* cp = reinterpret_cast<const P*>(clients) + i;
  const P sv = load_stream(reinterpret_cast<const P*>(s) + i);
  P cv[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) cv[j] = load_stream(cp + j * nvec);
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = __fmul_rn(w.w[0], widen(sv.v[k]));
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(w.w[j + 1], widen(cv[j].v[k])));
  }
  P ov;
#pragma unroll
  for (int k = 0; k < V; ++k) ov.v[k] = narrow<T>(acc[k]);
  store_stream(reinterpret_cast<P*>(out) + i, ov);
}

template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
assimilate_kernel(const T* __restrict__ s, const T* __restrict__ clients,
                  T* __restrict__ out, const __grid_constant__ Weights w,
                  int n_clients, int64_t nvec) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kStreamThreads + threadIdx.x;
  if (i >= nvec) return;
  const P* cp = reinterpret_cast<const P*>(clients) + i;
  const P sv = load_stream(reinterpret_cast<const P*>(s) + i);
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = __fmul_rn(w.w[0], widen(sv.v[k]));
#pragma unroll 4
  for (int j = 0; j < n_clients; ++j) {
    const P cv = load_stream(cp + j * nvec);
    const float wj = w.w[j + 1];
#pragma unroll
    for (int k = 0; k < V; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(wj, widen(cv.v[k])));
  }
  P ov;
#pragma unroll
  for (int k = 0; k < V; ++k) ov.v[k] = narrow<T>(acc[k]);
  store_stream(reinterpret_cast<P*>(out) + i, ov);
}

// ---- fused Adam (B3) --------------------------------------------------------
//
// What bounds it.  It runs once per client step of the training loop, on
// the MLP's 16,384-element bus: 458,752 bytes, 0.000137 ms at 3.35 TB/s,
// so a call costs its launch and its host path (vc_asgd_update.py), not
// device time.  At bus scale (2^27, 3.76 GB, 1.1218 ms) it is HBM bytes:
// seven streams, 28 B an f32 element for 14 flops.
//
// What the design does.  As Eq. 1 (whose note has the measurements): a
// grid that covers the bus, no grid-stride loop, every load and store
// evict-first (seven streams of 28 B an element would otherwise flush the
// L2 lines the step's next kernels read).  Each thread takes one pack of
// each of p, g, m and v, four independent 16-byte loads before any
// arithmetic, and no second pack: at 2^27 a second one changed nothing,
// and on the MLP bus, where each thread's two IEEE divisions and square
// root a value run in series, it cost 0.5 us of a 2.0 us launch
// (wrapper_cost.py's graph-timed device us).  The scalars arrive by value
// in the kernel's parameter space.  The flat bus is a BLOCK multiple: no
// element tail.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
adam_kernel(const T* __restrict__ p, const float* __restrict__ g,
            const float* __restrict__ m, const float* __restrict__ v,
            T* __restrict__ po, float* __restrict__ mo, float* __restrict__ vo,
            const AdamScalars sc, int64_t nvec) {
  using PT = Pack<T, 4>;
  using PF = Pack<float, 4>;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kStreamThreads + threadIdx.x;
  if (i >= nvec) return;
  const PT pv = load_stream(reinterpret_cast<const PT*>(p) + i);
  const PF gv = load_stream(reinterpret_cast<const PF*>(g) + i);
  const PF mv = load_stream(reinterpret_cast<const PF*>(m) + i);
  const PF vv = load_stream(reinterpret_cast<const PF*>(v) + i);
  PT pn;
  PF mn, vn;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float ge = gv.v[e];
    // m' = b1*m + (1-b1)*g ; v' = b2*v + ((1-b2)*g)*g
    const float me = __fadd_rn(__fmul_rn(sc.b1, mv.v[e]),
                               __fmul_rn(sc.omb1, ge));
    const float ve = __fadd_rn(__fmul_rn(sc.b2, vv.v[e]),
                               __fmul_rn(__fmul_rn(sc.omb2, ge), ge));
    const float pe = widen(pv.v[e]);
    // step = (lr*(m'/c1)) / (sqrt(v'/c2) + eps) [+ (lr*wd)*p]
    float step = __fdiv_rn(__fmul_rn(sc.lr, __fdiv_rn(me, sc.c1)),
                           __fadd_rn(__fsqrt_rn(__fdiv_rn(ve, sc.c2)), sc.eps));
    if (sc.lr_wd != 0.0f) step = __fadd_rn(step, __fmul_rn(sc.lr_wd, pe));
    pn.v[e] = narrow<T>(__fsub_rn(pe, step));
    mn.v[e] = me;
    vn.v[e] = ve;
  }
  store_stream(reinterpret_cast<PT*>(po) + i, pn);
  store_stream(reinterpret_cast<PF*>(mo) + i, mn);
  store_stream(reinterpret_cast<PF*>(vo) + i, vn);
}

// ---- elastic EASGD round over the whole pod (B5) ----------------------------
// diff_j = x_j - c;  acc = ((0 + diff_0) + diff_1) + ...  (replica order,
// from zero, as the Pallas _easgd_kernel carries it);  c' = c + beta*acc;
// x_j' = x_j - beta*diff_j.  Separate f32 multiply and add, beta an f32.
//
// What bounds it.  On the pod baseline's bus (the MLP's 16,384 f32
// elements, 3 replicas: 524,288 bytes, 0.000157 ms at 3.35 TB/s) a call
// costs its launch and its host path (vc_asgd_update.py).  At bus scale
// (2^27, 3 replicas: 4.29 GB, 1.2821 ms) it is HBM bytes: 8 (n + 1) B an
// f32 element for 4n + 2 flops.
//
// What the design does.  As Eq. 2 (B2): a grid that covers the bus, one
// pack of the center and of each replica a thread (64 blocks on 64 SMs at
// the MLP bus), no grid-stride loop.  The replica count is a template
// parameter for 1 <= n <= kFixedReplicas, so each thread issues the
// center's pack and all n replica packs, n + 1 independent 16-byte loads,
// before the first subtraction; NR = 0 is the one generic instance for
// more replicas, on the same grid: a runtime loop that loads, updates and
// stores one replica at a time.  On the H100 this took the graph-timed
// call at the MLP bus from 1.9-2.1 us (grid_for's 16 blocks, a replica
// loop whose loads waited on each other) to 1.3-1.5, and 2^27 from 85-86%
// of the bound to 89-90%.  Loads and stores keep the default caching:
// evict-first ones (B2's) measured no different at the MLP bus and 2%
// slower at 2^27 (codec_variants.py, PERF.md, PR 24).
constexpr int kFixedReplicas = 8;

// replica pack xv moved toward the center cf; its diff added to acc
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> easgd_replica(const Pack<T, V>& xv,
                                                    const float (&cf)[V],
                                                    float beta,
                                                    float (&acc)[V]) {
  Pack<T, V> ov;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float xk = widen(xv.v[k]);
    const float d = __fsub_rn(xk, cf[k]);
    acc[k] = __fadd_rn(acc[k], d);
    ov.v[k] = narrow<T>(__fsub_rn(xk, __fmul_rn(beta, d)));
  }
  return ov;
}

template <typename T, int NR>
__global__ void __launch_bounds__(kStreamThreads)
easgd_kernel(const T* __restrict__ c, const T* __restrict__ x,
             T* __restrict__ co, T* __restrict__ xo, float beta,
             int n_replicas, int64_t nvec) {
  constexpr int V = 16 / sizeof(T);
  using P = Pack<T, V>;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kStreamThreads + threadIdx.x;
  if (i >= nvec) return;
  const P* xp = reinterpret_cast<const P*>(x) + i;
  P* xop = reinterpret_cast<P*>(xo) + i;
  const P cv = reinterpret_cast<const P*>(c)[i];
  float cf[V], acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    cf[k] = widen(cv.v[k]);
    acc[k] = 0.0f;
  }
  if constexpr (NR > 0) {
    P xv[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) xv[j] = xp[j * nvec];
#pragma unroll
    for (int j = 0; j < NR; ++j)
      xop[j * nvec] = easgd_replica(xv[j], cf, beta, acc);
  } else {
#pragma unroll 4
    for (int j = 0; j < n_replicas; ++j)
      xop[j * nvec] = easgd_replica(xp[j * nvec], cf, beta, acc);
  }
  P ov;
#pragma unroll
  for (int k = 0; k < V; ++k)
    ov.v[k] = narrow<T>(__fadd_rn(cf[k], __fmul_rn(beta, acc[k])));
  reinterpret_cast<P*>(co)[i] = ov;
}

template <typename T, int NR>
void easgd(const void* c, const void* x, void* co, void* xo, float beta,
           int n_replicas, int64_t nvec, cudaStream_t stream) {
  easgd_kernel<T, NR><<<stream_grid(nvec, 1), kStreamThreads, 0, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(x), static_cast<T*>(co),
      static_cast<T*>(xo), beta, n_replicas, nvec);
}

// n_replicas in 1..kFixedReplicas takes its own instance, any more the
// generic one
template <typename T>
int easgd_launch(const void* c, const void* x, void* co, void* xo,
                 float beta, int n_replicas, int64_t n, void* stream) {
  const int64_t nvec = n / (16 / sizeof(T));
  if (n_replicas < 1 || nvec < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = n_replicas;
  switch (n_replicas) {
    case 1: easgd<T, 1>(c, x, co, xo, beta, r, nvec, st); break;
    case 2: easgd<T, 2>(c, x, co, xo, beta, r, nvec, st); break;
    case 3: easgd<T, 3>(c, x, co, xo, beta, r, nvec, st); break;
    case 4: easgd<T, 4>(c, x, co, xo, beta, r, nvec, st); break;
    case 5: easgd<T, 5>(c, x, co, xo, beta, r, nvec, st); break;
    case 6: easgd<T, 6>(c, x, co, xo, beta, r, nvec, st); break;
    case 7: easgd<T, 7>(c, x, co, xo, beta, r, nvec, st); break;
    case 8: easgd<T, 8>(c, x, co, xo, beta, r, nvec, st); break;
    default: easgd<T, 0>(c, x, co, xo, beta, r, nvec, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
void assimilate_fixed(const void* s, const void* clients, void* out,
                      const FixedWeights& w, int64_t nvec,
                      cudaStream_t stream) {
  assimilate_fixed_kernel<T, NC><<<stream_grid(nvec, 1), kStreamThreads, 0,
                                   stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(clients),
      static_cast<T*>(out), w, nvec);
}

// n_clients in 1..kFixedClients, the weights by value
template <typename T>
int assimilate_fixed_launch(const void* s, const void* clients, void* out,
                            const FixedWeights& w, int n_clients, int64_t n,
                            void* stream) {
  const int64_t nvec = n / (16 / sizeof(T));
  if (nvec < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_clients) {
    case 1: assimilate_fixed<T, 1>(s, clients, out, w, nvec, st); break;
    case 2: assimilate_fixed<T, 2>(s, clients, out, w, nvec, st); break;
    case 3: assimilate_fixed<T, 3>(s, clients, out, w, nvec, st); break;
    case 4: assimilate_fixed<T, 4>(s, clients, out, w, nvec, st); break;
    case 5: assimilate_fixed<T, 5>(s, clients, out, w, nvec, st); break;
    case 6: assimilate_fixed<T, 6>(s, clients, out, w, nvec, st); break;
    case 7: assimilate_fixed<T, 7>(s, clients, out, w, nvec, st); break;
    case 8: assimilate_fixed<T, 8>(s, clients, out, w, nvec, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// any n_clients in 1..kMaxWeights-1, the weights from a host array
template <typename T>
int assimilate_launch(const void* s, const void* clients, void* out,
                      const float* weights, int n_clients, int64_t n,
                      void* stream) {
  const int64_t nvec = n / (16 / sizeof(T));
  if (n_clients < 1 || n_clients + 1 > kMaxWeights || nvec < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Weights w;
  for (int j = 0; j <= n_clients; ++j) w.w[j] = weights[j];
  assimilate_kernel<T><<<stream_grid(nvec, 1), kStreamThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const T*>(clients),
      static_cast<T*>(out), w, n_clients, nvec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int adam_launch(const void* p, const void* g, const void* m, const void* v,
                void* po, void* mo, void* vo, const AdamScalars& sc,
                int64_t n, void* stream) {
  if (n < 1 || n % 4) return static_cast<int>(cudaErrorInvalidValue);
  adam_kernel<T><<<stream_grid(n / 4, 1), kStreamThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<T*>(po), static_cast<float*>(mo), static_cast<float*>(vo),
      sc, n / 4);
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

int vc_fixed_clients(void) { return kFixedClients; }

// s [n], clients [n_clients, n] -> out [n]; n_clients in 1..8, the n_clients
// + 1 weights by value
int vc_assimilate_fixed_f32(const void* s, const void* clients, void* out,
                            FixedWeights w, int n_clients, int64_t n,
                            void* stream) {
  return assimilate_fixed_launch<float>(s, clients, out, w, n_clients, n,
                                        stream);
}

int vc_assimilate_fixed_bf16(const void* s, const void* clients, void* out,
                             FixedWeights w, int n_clients, int64_t n,
                             void* stream) {
  return assimilate_fixed_launch<uint16_t>(s, clients, out, w, n_clients, n,
                                           stream);
}

// the same for n_clients in 1..511, the weights from a host array
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

// p, g, m, v [n] -> po, mo, vo [n]; n a multiple of 4
int vc_adam_f32(const void* p, const void* g, const void* m, const void* v,
                void* po, void* mo, void* vo, AdamScalars sc, int64_t n,
                void* stream) {
  return adam_launch<float>(p, g, m, v, po, mo, vo, sc, n, stream);
}

int vc_adam_bf16(const void* p, const void* g, const void* m, const void* v,
                 void* po, void* mo, void* vo, AdamScalars sc, int64_t n,
                 void* stream) {
  return adam_launch<uint16_t>(p, g, m, v, po, mo, vo, sc, n, stream);
}

// center [n], replicas [n_replicas, n] -> center', replicas' over the
// whole 16-byte packs (the flat bus has no tail); any n_replicas >= 1,
// 1..8 each on its own instance
int vc_easgd_f32(const void* c, const void* x, void* co, void* xo, float beta,
                 int n_replicas, int64_t n, void* stream) {
  return easgd_launch<float>(c, x, co, xo, beta, n_replicas, n, stream);
}

int vc_easgd_bf16(const void* c, const void* x, void* co, void* xo,
                  float beta, int n_replicas, int64_t n, void* stream) {
  return easgd_launch<uint16_t>(c, x, co, xo, beta, n_replicas, n, stream);
}

}  // extern "C"
