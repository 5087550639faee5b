// Blocked online-softmax attention (flash) forward on Hopper's tensor
// cores: wgmma on TMA-fed bf16 tiles, head dim 128 (sm_90a).
// Replaces, for bf16 q / k / v at hd 128, the same Pallas kernel as the
// SIMT kernel of flash_attention.cu (which keeps f32 and the other head
// dims):
//
//   fa90_forward <- flash_attention (:78), _attn_kernel (:23)
//                   of src/repro/kernels/flash_attention.py
//
// q [b, h, sq, 128], k / v [b, kvh, skv, 128] bf16 -> o [b, h, sq, 128]
// bf16, every input given by its strides with a unit stride on hd (the
// model's [b, s, h, hd] projections are read in place), o a fresh
// [b, sq, h, hd] buffer.  Query head hi reads kv head hi / (h / kvh)
// (GQA without a K/V copy).  For query position i and key position j:
//
//   s   = (q_i . k_j) * scale                 f32, scale = 1/sqrt(hd)
//   s   = tanh(s / softcap) * softcap         when softcap is given
//   s   = -1e30 where causal and j > i, or a window is given and
//         j <= i - window                     (the Pallas kernel's mask)
//   o_i = sum_j exp(s - m) v_j / max(sum_j exp(s - m), 1e-30)
//
// with the running max m, the running sum l and the accumulator in f32,
// one kv tile at a time.  The max is taken over the unscaled scores and
// the scale is folded with log2(e) into one FMA before exp2
// (ex2.approx); tanh is 1 - 2 / (e^2x + 1) on ex2.  Masked keys and keys
// past skv (TMA zero-fills the ragged last tile) get -inf where the
// Pallas kernel writes -1e30: both weigh exactly 0 in every row that sees
// a key, and every stored row does (the wrapper refuses a window that
// leaves a row without one).  Query rows past sq are computed and not
// stored, so any sq and skv are taken.
//
// Numbers that differ from the Pallas kernel and from the SIMT kernel:
// P is rounded to bf16 before the P.V product (the tensor cores take
// bf16 operands; both other kernels keep p in f32); l sums the f32 P.
// Causal at hd 128, GQA 2-4, s = 300-2048, with v at N(0,1) and q, k at
// 0.5 N(0,1) (a flat softmax) or at 2 N(0,1) (peaked: the row max moves
// between tiles), that moves the output by at most 5e-3 before its bf16
// rounding and by at most one bf16 ulp of the output after it, so this
// kernel is held to its plain version within 5e-3 + 2^-7 |plain|
// (tests/test_torch_attention.py holds both on a CPU emulation of this
// arithmetic, and the emulation against the reference; the card tests
// and chip_smoke.py hold the kernel to that bound).
//
// Design (one CTA of 384 threads per (128-row query tile, b * h)):
// - warpgroups 0 and 1 are consumers that own 64 query rows each;
//   warpgroup 2 is the producer, whose first thread issues every TMA
//   load.  The role branch is on a warp-uniform index (a shuffle), with
//   setmaxnreg (producer 40, consumers 232) at the top of each role.
// - shared memory: Q 128 x 128 bf16 (32 KB); K and V in a ring of 2
//   stages of 128 keys x 128 (2 x 64 KB); 160 KB in all.  Each 128 x 128
//   tile is two boxes of 128 rows x 64 columns (128 bytes: the widest
//   box the 128-byte swizzle takes), swizzled by TMA.  Full barriers on
//   Q and on each stage's K and V (expect_tx), an empty barrier on each
//   stage (one arrival per consumer warp after its P.V product).
// - tensor maps: 4-D (hd, s, heads, b) over the tensors' own byte
//   strides, encoded on the host each call through the driver entry
//   point cuTensorMapEncodeTiled (nothing is linked), passed as
//   __grid_constant__ parameters.
// - S = Q.K^T: wgmma m64n128k16, A (Q) and B (K) from shared memory,
//   both K-major, 8 steps over hd.  O += P.V: wgmma m64n128k16, A = P
//   from registers (the S accumulator fragment is the A fragment of the
//   next product: each thread's two rows and column pairs line up), B =
//   V from shared memory, MN-major (transposed): the leading byte offset
//   steps between the two 64-column boxes, the stride byte offset
//   between 8-key groups.
// - online softmax on the accumulator fragment: a row lives in one quad
//   (2 shuffles); masks only on tiles cut by the diagonal, the window
//   edge or skv (a second copy of the loop), softcap a template
//   parameter, so the common tile's loop has no branch; l kept per
//   thread and reduced once at the end.
// - query tiles walk heaviest first (the bottom causal rows are
//   launched first, grid.y reversed); the kv tiles a query tile cannot
//   see (wholly above the diagonal, wholly before the window) are never
//   loaded, as the Pallas kernel skips its causal tiles (:31-36).
//
// Bound on the H100: 4 * hd FLOPs per visible (query, key) pair: for
// internlm2's prefill ([4,16/8,2048,128] bf16, causal) 68.7 GFLOP, 0.0695
// ms at the dense bf16 tensor-core peak (989 TFLOP/s), against 67 MB
// moved (0.020 ms): the products bound it.  This design feeds the tensor
// cores from a 2-stage TMA ring; the two consumer warpgroups overlap one
// another's softmax with their products only as the warp schedulers
// interleave them.  Measured on an H100 and left out: a third stage, a
// ping-pong barrier between the consumers (no gain either), and issuing
// the next S with this P.V (ptxas spilled and serialised every wgmma:
// the consumers' code stays at the entry budget of 168 registers; see
// PERF.md).
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError() (or kEncodeError + the
// CUresult when a tensor map cannot be encoded).

#include <initializer_list>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "smem.cuh"

namespace {

constexpr int kHD = 128;                 // the one head dim of this kernel
constexpr int kBM = 128;                 // query rows per CTA
constexpr int kBN = 128;                 // keys per kv tile
constexpr int kStages = 2;               // K / V ring depth
constexpr int kConsumers = 256;          // 2 consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // + the producer warpgroup
constexpr int kBoxCols = 64;             // hd columns per TMA box (128 B)
constexpr uint32_t kBoxBytes = 128 * kBoxCols * 2;   // 16 KB
constexpr uint32_t kTileBytes = 2 * kBoxBytes;       // 128 x 128 bf16
constexpr uint32_t kBarBytes = 8 * (1 + 3 * kStages);   // the mbarriers
constexpr uint32_t kSmemBytes =
    (1 + 2 * kStages) * kTileBytes + kBarBytes + 1024;   // + alignment
constexpr int kEncodeError = 1 << 20;    // + CUresult of a failed encode
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  void* o;
  int64_t ob, oh, os;                    // o's strides, elements
  int h, group, sq, skv, causal, window, n_qtiles;   // window <= 0: none
  float scale_log2;                      // scale * log2(e)
  float softcap_in, softcap;             // scale / softcap, softcap
};

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one 64-column x 128-row box of a 4-D (hd, s, heads, b) tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma fence / wait around it
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define FA_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define FA_OUT8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_OUT64                                                         \
  FA_OUT8(0), FA_OUT8(8), FA_OUT8(16), FA_OUT8(24), FA_OUT8(32),         \
      FA_OUT8(40), FA_OUT8(48), FA_OUT8(56)

// d (+)= A.B, m64n128k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_OUT64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A.B, m64n128k16, A (bf16 pairs) from registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_OUT64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (e^2x + 1), within ~1e-7 of tanhf (absolute)
__device__ __forceinline__ float tanh_ex2(float x) {
  return 1.0f - __fdividef(2.0f, ex2(x * (2.0f * kLog2e)) + 1.0f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the consumer's steps ------------------------------------------------
//
// Accumulator fragment of m64n128 (per thread of a warpgroup; warp w,
// lane = 4 g + t): element r holds row 16 w + g + 8 ((r >> 1) & 1) and
// column 8 (r >> 2) + 2 t + (r & 1).

// one thread's two rows: running max (of the unscaled scores) and
// partial sums
struct Rows {
  float m0, m1, l0, l1;
};

// S = Q.K^T over hd: 4 k-steps of 16 in each 64-column box (committed)
__device__ __forceinline__ void issue_scores(float (&s)[64], uint32_t sQw,
                                             uint32_t sKs) {
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss(s, desc_sw128(sQw + off, 16, 1024),
             desc_sw128(sKs + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P.V over the tile's keys: 8 k-steps of 16 keys (committed)
__device__ __forceinline__ void issue_pv(float (&o)[64],
                                         const uint32_t (&pa)[32],
                                         uint32_t sVs) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
             desc_sw128(sVs + kk * 16 * 128, kBoxBytes, 1024));
  wgmma_commit();
}

// the tile's scores -> p in place: y = s (or tanh(s scale / softcap)
// softcap), -inf where masked (kCut: a tile cut by the diagonal, the
// window edge or skv), p = 2^(y c - m c) with c = scale log2(e) (or
// log2(e)) as one FMA.  Updates the rows' max and sums and gives the
// factors a0, a1 that rescale their earlier sums.  A row that has seen
// no key yet keeps m = -inf: its p and factors are 0.
template <bool kCut, bool kSoftcap>
__device__ __forceinline__ void softmax_tile(float (&s)[64], const Params& P,
                                             int k0, int row0, int row1,
                                             int tq4, Rows& st, float& a0,
                                             float& a1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    float y = kSoftcap ? tanh_ex2(s[r] * P.softcap_in) * P.softcap : s[r];
    if (kCut) {
      const int kp = k0 + 8 * (r >> 2) + 2 * tq4 + (r & 1);
      const int qp = (r & 2) ? row1 : row0;
      if (kp >= P.skv || (P.causal && kp > qp) ||
          (P.window > 0 && kp <= qp - P.window))
        y = -INFINITY;
    }
    s[r] = y;
    if (r & 2) mx1 = fmaxf(mx1, y); else mx0 = fmaxf(mx0, y);
  }
  const float c = kSoftcap ? kLog2e : P.scale_log2;
  const float n0 = fmaxf(st.m0, quad_max(mx0));
  const float n1 = fmaxf(st.m1, quad_max(mx1));
  const float b0 = n0 == -INFINITY ? 0.0f : n0 * c;
  const float b1 = n1 == -INFINITY ? 0.0f : n1 * c;
  a0 = ex2(fmaf(st.m0, c, -b0));
  a1 = ex2(fmaf(st.m1, c, -b1));
  st.m0 = n0;
  st.m1 = n1;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    const float p = ex2(fmaf(s[r], c, (r & 2) ? -b1 : -b0));
    s[r] = p;
    if (r & 2) s1 += p; else s0 += p;
  }
  st.l0 = st.l0 * a0 + s0;
  st.l1 = st.l1 * a1 + s1;
}

// softmax_tile with the mask only where the tile is cut
template <bool kSoftcap>
__device__ __forceinline__ void softmax_any(float (&s)[64], const Params& P,
                                            int k0, int rows_lo, int row0,
                                            int row1, int tq4, Rows& st,
                                            float& a0, float& a1) {
  const bool cut = (P.causal && k0 + kBN - 1 > rows_lo) ||
                   (P.window > 0 && k0 <= rows_lo + 63 - P.window) ||
                   k0 + kBN > P.skv;
  if (cut)
    softmax_tile<true, kSoftcap>(s, P, k0, row0, row1, tq4, st, a0, a1);
  else
    softmax_tile<false, kSoftcap>(s, P, k0, row0, row1, tq4, st, a0, a1);
}

__device__ __forceinline__ void rescale(float (&o)[64], float a0, float a1) {
#pragma unroll
  for (int r = 0; r < 64; ++r) o[r] *= (r & 2) ? a1 : a0;
}

// P in bf16 pairs: the A fragment of P.V (pa[4 kk .. 4 kk + 3] hold keys
// 16 kk .. 16 kk + 15 of the thread's two rows)
__device__ __forceinline__ void pack_p(uint32_t (&pa)[32],
                                       const float (&s)[64]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
}

// ---- the kernel ----------------------------------------------------------

template <bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_sm90(__grid_constant__ const CUtensorMap tq,
              __grid_constant__ const CUtensorMap tk,
              __grid_constant__ const CUtensorMap tv, const Params P) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + kTileBytes;                 // stage s: + s * tile
  const uint32_t sV = sK + kStages * kTileBytes;
  const uint32_t bar = sV + kStages * kTileBytes;
  const uint32_t q_full = bar;
  auto k_full = [bar](int s) { return bar + 8u + 8u * s; };
  auto v_full = [bar](int s) { return bar + 8u + 8u * (kStages + s); };
  auto empty = [bar](int s) { return bar + 8u + 8u * (2 * kStages + s); };

  const int bi = blockIdx.x / P.h, hi = blockIdx.x % P.h;
  const int kvi = hi / P.group;
  const int q0 = (P.n_qtiles - 1 - static_cast<int>(blockIdx.y)) * kBM;
  // the kv tiles this query tile's rows can see: [t_lo, t_hi)
  const int q_last = min(q0 + kBM, P.sq) - 1;
  const int kv_hi = P.causal ? min(P.skv, q_last + 1) : P.skv;
  const int kv_lo = P.window > 0 ? max(0, q0 - P.window + 1) : 0;
  const int t_lo = kv_lo / kBN;
  const int n_tiles = max((kv_hi + kBN - 1) / kBN - t_lo, 0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);             // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, uniform across each warp as the compiler sees it
  // (one role per branch: setmaxnreg gives each its own register budget)
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == kConsumers / 128) {
    // ---- producer: its first thread issues every load ------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, kTileBytes);
      tma_load(sQ, &tq, q_full, 0, q0, hi, bi);
      tma_load(sQ + kBoxBytes, &tq, q_full, kBoxCols, q0, hi, bi);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        const int k0 = (t_lo + i) * kBN;
        const uint32_t dk = sK + s * kTileBytes, dv = sV + s * kTileBytes;
        mbar_expect_tx(k_full(s), kTileBytes);
        tma_load(dk, &tk, k_full(s), 0, k0, kvi, bi);
        tma_load(dk + kBoxBytes, &tk, k_full(s), kBoxCols, k0, kvi, bi);
        mbar_expect_tx(v_full(s), kTileBytes);
        tma_load(dv, &tv, v_full(s), 0, k0, kvi, bi);
        tma_load(dv + kBoxBytes, &tv, v_full(s), kBoxCols, k0, kvi, bi);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = wgi;                            // 0 or 1
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq4 = lane % 4;
    const int rows_lo = q0 + 64 * wg;              // this warpgroup's rows
    const int row0 = rows_lo + 16 * warp + g, row1 = row0 + 8;
    const uint32_t sQw = sQ + 64 * wg * 128;       // 64 rows x 128 bytes in

    float o[64], sacc[64];
    uint32_t pa[32];
#pragma unroll
    for (int r = 0; r < 64; ++r) o[r] = sacc[r] = 0.0f;
    Rows st = {-INFINITY, -INFINITY, 0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = (t_lo + i) * kBN;
      mbar_wait(k_full(s), parity);
      pin(sacc);
      wgmma_fence();
      issue_scores(sacc, sQw, sK + s * kTileBytes);
      wgmma_wait<0>();
      pin(sacc);
      float a0, a1;
      softmax_any<kSoftcap>(sacc, P, k0, rows_lo, row0, row1, tq4, st, a0,
                            a1);
      rescale(o, a0, a1);
      pack_p(pa, sacc);
      mbar_wait(v_full(s), parity);
      pin(o);
      wgmma_fence();
      issue_pv(o, pa, sV + s * kTileBytes);
      wgmma_wait<0>();
      pin(o);
      if (lane == 0) mbar_arrive(empty(s));
    }

    // o / max(l, 1e-30) in bf16; rows past sq are not stored
    const float d0 = 1.0f / fmaxf(quad_sum(st.l0), 1e-30f);
    const float d1 = 1.0f / fmaxf(quad_sum(st.l1), 1e-30f);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(P.o) + bi * P.ob +
                         hi * P.oh;
#pragma unroll
    for (int r = 0; r < 64; r += 2) {
      const int row = (r & 2) ? row1 : row0;
      if (row >= P.sq) continue;
      const float dn = (r & 2) ? d1 : d0;
      *reinterpret_cast<__nv_bfloat162*>(
          out + row * P.os + 8 * (r >> 2) + 2 * tq4) =
          __floats2bfloat162_rn(o[r] * dn, o[r + 1] * dn);
    }
  }
}

// ---- host side -----------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a bf16 tensor [batch, heads, rows, 128] given by its element strides
// (batch, head, row), as a 4-D map (hd, rows, heads, batch) of 64 x 128
// boxes with the 128-byte swizzle; rows past the end read as zeros
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch,
           int heads, int rows, const int64_t* strides) {
  const cuuint64_t dims[4] = {kHD, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {kBoxCols, 128, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, bytes, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

// the three maps of one call, q's, k's and v's
int encode_maps(CUtensorMap (&maps)[3], const void* q, const void* k,
                const void* v, const int64_t* strides, int b, int h, int kvh,
                int sq, int skv) {
  EncodeTiled fn;
  const cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  int rc = encode(fn, &maps[0], q, b, h, sq, strides);
  if (rc == 0) rc = encode(fn, &maps[1], k, b, kvh, skv, strides + 3);
  if (rc == 0) rc = encode(fn, &maps[2], v, b, kvh, skv, strides + 6);
  return rc;
}

}  // namespace

extern "C" {

const char* fa90_error_string(int code) {
  static char msg[96];
  if (code >= kEncodeError) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: 12 int64 in elements, (batch, head, seq) of q, k, v, o; every
// seq / head / batch stride of q, k, v a multiple of 8 elements (16
// bytes) and the bases 16-byte aligned (the wrapper checks).
int fa90_forward(const void* q, const void* k, const void* v, void* o,
                 const int64_t* strides, int b, int h, int kvh, int sq,
                 int skv, int causal, int window, float softcap, float scale,
                 void* stream) {
  static bool configured[kMaxDevices] = {};
  const cudaError_t err = once_a_device(configured, [] {
    for (auto kernel : {attn_fwd_sm90<false>, attn_fwd_sm90<true>}) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kSmemBytes));
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
  if (err != cudaSuccess) return err;
  CUtensorMap maps[3];
  const int rc = encode_maps(maps, q, k, v, strides, b, h, kvh, sq, skv);
  if (rc != 0) return rc;

  Params p;
  p.o = o;
  p.ob = strides[9];
  p.oh = strides[10];
  p.os = strides[11];
  p.h = h;
  p.group = h / kvh;
  p.sq = sq;
  p.skv = skv;
  p.causal = causal;
  p.window = window;
  p.n_qtiles = (sq + kBM - 1) / kBM;
  p.scale_log2 = scale * kLog2e;
  p.softcap_in = softcap > 0.0f ? scale / softcap : 0.0f;
  p.softcap = softcap;
  const dim3 grid(b * h, p.n_qtiles);
  auto kernel = softcap > 0.0f ? attn_fwd_sm90<true> : attn_fwd_sm90<false>;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

}  // extern "C"
