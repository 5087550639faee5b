// Blocked online-softmax attention (flash) forward on Hopper's tensor
// cores: wgmma on TMA-fed bf16 tiles, head dim 64, 80, 128 or 256
// (sm_90a).  Replaces, for bf16 q / k / v at those head dims, the same
// Pallas kernel as the SIMT kernel of flash_attention.cu (which keeps f32
// and hd 16 / 32):
//
//   fa90_forward <- flash_attention (:78), _attn_kernel (:23)
//                   of src/repro/kernels/flash_attention.py
//
// q [b, h, sq, hd], k / v [b, kvh, skv, hd] bf16 -> o [b, h, sq, hd]
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
// Under autograd the wrapper also hands a buffer for each row's base-2
// log-sum-exp of the scaled scores, lse_i = m_i c + log2(max(l_i,
// 1e-30)) with c = scale log2(e) ([b * h] rows of ``lse_ld`` f32), so
// that the backward (flash_attention_bwd_sm90.cu) takes P = 2^(s c -
// lse) without walking the keys again; serving passes a null pointer
// and nothing more is written.
//
// Numbers that differ from the Pallas kernel and from the SIMT kernel:
// P is rounded to bf16 before the P.V product (the tensor cores take
// bf16 operands; both other kernels keep p in f32); l sums the f32 P.
// Causal at hd 64, 80, 128 and 256, GQA 2-4, s = 300-2048, with v at
// N(0,1) and q, k at 0.5 N(0,1) (a flat softmax) or at 2 N(0,1) (peaked:
// the row max moves between tiles), that moves the output by at most 5e-3
// before its bf16 rounding and by at most one bf16 ulp of the output
// after it, so this kernel is held to its plain version within 5e-3 +
// 2^-7 |plain| at every head dim (tests/test_torch_attention.py holds
// each on a CPU emulation of this arithmetic, and the emulation against
// the reference; the card tests and chip_smoke.py hold the kernel to that
// bound).
//
// Design (one CTA of 384 threads per (128-row query tile, b * h); the
// geometry of each head dim in ``Geo``):
// - warpgroups 0 and 1 are consumers that own 64 query rows each;
//   warpgroup 2 is the producer, whose first thread issues every TMA
//   load.  The role branch is on a warp-uniform index (a shuffle), with
//   setmaxnreg (producer 40, consumers 232) at the top of each role.
// - shared memory: Q 128 x hd bf16; K and V in a ring of kv tiles of
//   kBN keys x hd.  Each tile is hd / 64 boxes of rows x 64 columns (128
//   bytes: the widest box the 128-byte swizzle takes), swizzled by TMA.
//   hd 128: 128-key tiles, 2 stages, 160 KB.  hd 64: a tile is one box
//   (16 KB), and the room goes to a 4-stage ring, 144 KB: two CTAs an SM
//   would need the consumers at 112 registers, below the 64 S + 32 O +
//   32 P values each holds, so the room buys loads further ahead
//   instead.  hd 256: 64-key tiles (S m64n64, O += P.V m64n256): a
//   consumer thread holds 128 O + 32 S + 16 P values (at 128 keys it
//   would hold 128 + 64 + 32, past its 232 registers); Q 64 KB + 2
//   stages x (K + V) 64 KB = 192 KB.  hd 80 runs the hd-128 geometry on
//   tensor maps whose inner dimension is 80: TMA zero-fills columns
//   80-127 of every Q, K and V box, so the scores stay exact (S's three
//   k-steps over the zero columns are skipped), O's columns 80-127 come
//   out 0 and are never stored, and the scale is 1/sqrt(80) from the
//   wrapper; P.V still runs m64n128 (an MN-major operand of 80 columns is
//   no whole number of 64-column swizzle atoms).  Full barriers on Q and
//   on each stage's K and V (expect_tx), an empty barrier on each stage
//   (one arrival per consumer warp after its P.V product).
// - tensor maps: 4-D (hd, s, heads, b) over the tensors' own byte
//   strides, encoded on the host each call through the driver entry
//   point cuTensorMapEncodeTiled (nothing is linked), passed as
//   __grid_constant__ parameters.
// - S = Q.K^T: wgmma m64n{kBN}k16, A (Q) and B (K) from shared memory,
//   both K-major, hd / 16 steps (4 in each box).  O += P.V: wgmma
//   m64n{hd}k16 (m64n64k16 to m64n256k16), A = P from registers (the S
//   accumulator fragment is the A fragment of the next product: each
//   thread's two rows and column pairs line up), B = V from shared
//   memory, MN-major (transposed): the leading byte offset steps between
//   64-column boxes, the stride byte offset between 8-key groups.
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
// Bound on the H100: 4 * hd FLOPs per visible (query, key) pair.
// internlm2's prefill ([4,16/8,2048,128] bf16, causal): 68.7 GFLOP,
// 0.0695 ms at the dense bf16 tensor-core peak (989 TFLOP/s), against
// 67 MB moved (0.020 ms).  granite's prefill ([4,16/8,2048,64]): 34.4
// GFLOP, 0.0348 ms, against 25 MB (0.0075 ms).  gemma3-4b's global
// layers ([4,8/4,2048,256]): 68.7 GFLOP, 0.0695 ms.  stablelm-3b's
// prefill ([4,32/32,2048,80]): 85.9 GFLOP, 0.0869 ms at hd 80, which
// this kernel runs as 2 x 80 + 2 x 128 = 416 of the 320 FLOPs a pair
// the bound counts (1.3x).  The products bound all four.  Measured on an
// H100 80GB HBM3 at 700 W (chip_smoke.py phase 6a; PERF.md's B13 row):
// 38.6% of the bound at hd 128, 28.8% at hd 64, 43-44% at hd 256 (0.154-
// 0.161 ms, SDPA 0.151) and 27.0% of the hd-80 bound at hd 80 (0.317-
// 0.322 ms, SDPA 0.254).
// This design feeds the tensor cores from a TMA ring; the two consumer
// warpgroups overlap one another's softmax with their products only as
// the warp schedulers interleave them; at hd 64 the softmax (the same
// per pair at either head dim) weighs twice as much against the
// products.  Measured on an H100 and left out at hd 128: a third stage,
// a ping-pong barrier between the consumers (no gain either), and
// issuing the next S with this P.V (ptxas spilled and serialised every
// wgmma; see PERF.md).
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

#include "sm90.cuh"
#include "smem.cuh"

namespace {

constexpr int kBM = 128;                 // query rows per CTA
constexpr int kConsumers = 256;          // 2 consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // + the producer warpgroup
constexpr int kBoxCols = 64;             // hd columns per TMA box (128 B)
constexpr uint32_t kQBox = kBM * 128;    // a Q box: 128 rows x 128 B

// the geometry of one head dim
template <int HD>
struct Geo {
  static_assert(HD == 64 || HD == 80 || HD == 128 || HD == 256,
                "wgmma route: hd 64, 80, 128 or 256");
  static constexpr int kPad = HD == 80 ? 128 : HD;     // columns a tile holds
  static constexpr int kBoxes = kPad / kBoxCols;        // boxes a tile
  static constexpr int kSteps = (HD + 15) / 16;         // S's k-steps
  static constexpr int kBN = HD == 256 ? 64 : 128;      // keys a kv tile
  static constexpr int kStages = HD == 64 ? 4 : 2;      // K / V ring depth
  static constexpr int kAcc = kPad / 2;                 // O values a thread
  static constexpr int kS = kBN / 2;                    // S values a thread
  static constexpr uint32_t kKBox = kBN * 128;          // a K or V box
  static constexpr uint32_t kQBytes = kBoxes * kQBox;
  static constexpr uint32_t kTileBytes = kBoxes * kKBox;
  static constexpr uint32_t kBarBytes = 8 * (1 + 3 * kStages);
  static constexpr uint32_t kSmemBytes = kQBytes + 2 * kStages * kTileBytes +
                                         kBarBytes + 1024;   // + alignment
  static_assert(kSmemBytes <= 227 * 1024, "one CTA an SM");
};

struct Params {
  void* o;
  float* lse;                            // null: not written
  int64_t ob, oh, os;                    // o's strides, elements
  int h, group, sq, skv, causal, window, n_qtiles;   // window <= 0: none
  int lse_ld;                            // lse's row stride, floats
  float scale_log2;                      // scale * log2(e)
  float softcap_in, softcap;             // scale / softcap, softcap
};

// tanh(x) = 1 - 2 / (e^2x + 1), within ~1e-7 of tanhf (absolute)
__device__ __forceinline__ float tanh_ex2(float x) {
  return 1.0f - __fdividef(2.0f, ex2(x * (2.0f * kLog2e)) + 1.0f);
}

// ---- the consumer's steps ------------------------------------------------

// one thread's two rows: running max (of the unscaled scores) and
// partial sums
struct Rows {
  float m0, m1, l0, l1;
};

// S = Q.K^T over hd: 4 k-steps of 16 in each 64-column box, none over
// the zero-filled columns past HD (committed)
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[Geo<HD>::kS],
                                             uint32_t sQw, uint32_t sKs) {
  using G = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(s, desc_sw128(sQw + (kk / 4) * kQBox + col, 16, 1024),
             desc_sw128(sKs + (kk / 4) * G::kKBox + col, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P.V over the tile's keys: kBN / 16 k-steps of 16 keys (committed)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[Geo<HD>::kAcc],
                                         const uint32_t (&pa)[Geo<HD>::kS / 2],
                                         uint32_t sVs) {
  using G = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < G::kBN / 16; ++kk)
    wgmma_rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
             desc_sw128(sVs + kk * 16 * 128, G::kKBox, 1024));
  wgmma_commit();
}

// the tile's scores -> p in place: y = s (or tanh(s scale / softcap)
// softcap), -inf where masked (kCut: a tile cut by the diagonal, the
// window edge or skv), p = 2^(y c - m c) with c = scale log2(e) (or
// log2(e)) as one FMA.  Updates the rows' max and sums and gives the
// factors a0, a1 that rescale their earlier sums.  A row that has seen
// no key yet keeps m = -inf: its p and factors are 0.
template <bool kCut, bool kSoftcap, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], const Params& P,
                                             int k0, int row0, int row1,
                                             int tq4, Rows& st, float& a0,
                                             float& a1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int r = 0; r < N; ++r) {
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
  for (int r = 0; r < N; ++r) {
    const float p = ex2(fmaf(s[r], c, (r & 2) ? -b1 : -b0));
    s[r] = p;
    if (r & 2) s1 += p; else s0 += p;
  }
  st.l0 = st.l0 * a0 + s0;
  st.l1 = st.l1 * a1 + s1;
}

// softmax_tile with the mask only where the tile is cut (a tile of 2 N
// keys)
template <bool kSoftcap, int N>
__device__ __forceinline__ void softmax_any(float (&s)[N], const Params& P,
                                            int k0, int rows_lo, int row0,
                                            int row1, int tq4, Rows& st,
                                            float& a0, float& a1) {
  const bool cut = (P.causal && k0 + 2 * N - 1 > rows_lo) ||
                   (P.window > 0 && k0 <= rows_lo + 63 - P.window) ||
                   k0 + 2 * N > P.skv;
  if (cut)
    softmax_tile<true, kSoftcap>(s, P, k0, row0, row1, tq4, st, a0, a1);
  else
    softmax_tile<false, kSoftcap>(s, P, k0, row0, row1, tq4, st, a0, a1);
}

template <int R>
__device__ __forceinline__ void rescale(float (&o)[R], float a0, float a1) {
#pragma unroll
  for (int r = 0; r < R; ++r) o[r] *= (r & 2) ? a1 : a0;
}

// P in bf16 pairs: the A fragment of P.V (pa[4 kk .. 4 kk + 3] hold keys
// 16 kk .. 16 kk + 15 of the thread's two rows)
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 2],
                                       const float (&s)[N]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
}

// ---- the kernel ----------------------------------------------------------

template <int HD, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_sm90(__grid_constant__ const CUtensorMap tq,
              __grid_constant__ const CUtensorMap tk,
              __grid_constant__ const CUtensorMap tv, const Params P) {
  using G = Geo<HD>;
  constexpr int kStages = G::kStages;
  constexpr int kBN = G::kBN;
  constexpr uint32_t kTileBytes = G::kTileBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + G::kQBytes;                 // stage s: + s * tile
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
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup index, uniform across each warp as the compiler sees it
  // (one role per branch: setmaxnreg gives each its own register budget)
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == kConsumers / 128) {
    // ---- producer: its first thread issues every load ------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, G::kQBytes);
      for (int c = 0; c < G::kBoxes; ++c)
        tma_load(sQ + c * kQBox, &tq, q_full, c * kBoxCols, q0, hi, bi);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        const int k0 = (t_lo + i) * kBN;
        const uint32_t dk = sK + s * kTileBytes, dv = sV + s * kTileBytes;
        mbar_expect_tx(k_full(s), kTileBytes);
        for (int c = 0; c < G::kBoxes; ++c)
          tma_load(dk + c * G::kKBox, &tk, k_full(s), c * kBoxCols, k0, kvi,
                   bi);
        mbar_expect_tx(v_full(s), kTileBytes);
        for (int c = 0; c < G::kBoxes; ++c)
          tma_load(dv + c * G::kKBox, &tv, v_full(s), c * kBoxCols, k0, kvi,
                   bi);
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

    float o[G::kAcc], sacc[G::kS];
    uint32_t pa[G::kS / 2];
#pragma unroll
    for (int r = 0; r < G::kAcc; ++r) o[r] = 0.0f;
#pragma unroll
    for (int r = 0; r < G::kS; ++r) sacc[r] = 0.0f;
    Rows st = {-INFINITY, -INFINITY, 0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = (t_lo + i) * kBN;
      mbar_wait(k_full(s), parity);
      pin(sacc);
      wgmma_fence();
      issue_scores<HD>(sacc, sQw, sK + s * kTileBytes);
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
      issue_pv<HD>(o, pa, sV + s * kTileBytes);
      wgmma_wait<0>();
      pin(o);
      if (lane == 0) mbar_arrive(empty(s));
    }

    // o / max(l, 1e-30) in bf16; rows past sq and columns past HD (hd
    // 80's zero-filled ones) are not stored
    const float l0 = fmaxf(quad_sum(st.l0), 1e-30f);
    const float l1 = fmaxf(quad_sum(st.l1), 1e-30f);
    const float d0 = 1.0f / l0, d1 = 1.0f / l1;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(P.o) + bi * P.ob +
                         hi * P.oh;
#pragma unroll
    for (int r = 0; r < G::kAcc; r += 2) {
      const int row = (r & 2) ? row1 : row0;
      if (8 * (r >> 2) >= HD || row >= P.sq) continue;
      const float dn = (r & 2) ? d1 : d0;
      *reinterpret_cast<__nv_bfloat162*>(
          out + row * P.os + 8 * (r >> 2) + 2 * tq4) =
          __floats2bfloat162_rn(o[r] * dn, o[r + 1] * dn);
    }
    if (P.lse != nullptr && tq4 == 0) {
      const float c = kSoftcap ? kLog2e : P.scale_log2;
      float* lse = P.lse + static_cast<int64_t>(blockIdx.x) * P.lse_ld;
      if (row0 < P.sq) lse[row0] = st.m0 * c + log2f(l0);
      if (row1 < P.sq) lse[row1] = st.m1 * c + log2f(l1);
    }
  }
}

// ---- host side -----------------------------------------------------------

// the three maps of one call: q's of 128-row boxes, k's and v's of
// ``kv_rows``-row boxes, 64 columns each
int encode_maps(CUtensorMap (&maps)[3], const void* q, const void* k,
                const void* v, const int64_t* strides, int hd, int b, int h,
                int kvh, int sq, int skv, int kv_rows) {
  EncodeTiled fn;
  const cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  int rc = encode(fn, &maps[0], q, hd, b, h, sq, strides, kBM);
  if (rc == 0)
    rc = encode(fn, &maps[1], k, hd, b, kvh, skv, strides + 3, kv_rows);
  if (rc == 0)
    rc = encode(fn, &maps[2], v, hd, b, kvh, skv, strides + 6, kv_rows);
  return rc;
}

template <int HD>
cudaError_t configure() {
  static bool configured[kMaxDevices] = {};
  return once_a_device(configured, [] {
    for (auto kernel : {attn_fwd_sm90<HD, false>, attn_fwd_sm90<HD, true>}) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(Geo<HD>::kSmemBytes));
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  });
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v,
              const int64_t* strides, int b, int kvh, const Params& p,
              cudaStream_t stream) {
  CUtensorMap maps[3];
  const int rc = encode_maps(maps, q, k, v, strides, HD, b, p.h, kvh, p.sq,
                             p.skv, Geo<HD>::kBN);
  if (rc != 0) return rc;
  const cudaError_t err = configure<HD>();
  if (err != cudaSuccess) return err;
  const int bh = b * p.h;
  const dim3 grid(bh, p.n_qtiles);
  auto kernel = p.softcap > 0.0f ? attn_fwd_sm90<HD, true>
                                 : attn_fwd_sm90<HD, false>;
  kernel<<<grid, kThreads, Geo<HD>::kSmemBytes, stream>>>(maps[0], maps[1],
                                                         maps[2], p);
  return cudaGetLastError();
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
// bytes) and the bases 16-byte aligned (the wrapper checks).  hd 64, 80,
// 128 or 256; anything else returns cudaErrorInvalidValue (the wrapper
// routes it to the SIMT kernel).  lse: null, or [b * h] rows of lse_ld
// f32.
int fa90_forward(const void* q, const void* k, const void* v, void* o,
                 float* lse, const int64_t* strides, int b, int h, int kvh,
                 int sq, int skv, int hd, int lse_ld, int causal, int window,
                 float softcap, float scale, void* stream) {
  Params p;
  p.o = o;
  p.lse = lse;
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
  p.lse_ld = lse_ld;
  p.scale_log2 = scale * kLog2e;
  p.softcap_in = softcap > 0.0f ? scale / softcap : 0.0f;
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_hd<64>(q, k, v, strides, b, kvh, p, s);
    case 80: return launch_hd<80>(q, k, v, strides, b, kvh, p, s);
    case 128: return launch_hd<128>(q, k, v, strides, b, kvh, p, s);
    case 256: return launch_hd<256>(q, k, v, strides, b, kvh, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
