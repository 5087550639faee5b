// Blocked attention backward (flash) on Hopper's tensor cores: wgmma on
// TMA-fed bf16 tiles, head dim 64, 80, 128 or 256 (sm_90a).  The route of
// B13's backward for bf16 at those head dims; f32 and hd 16 / 32 keep the
// SIMT kernel of flash_attention_bwd.cu, which computes the same
// function.  It replaces no Pallas kernel: the reference trains through
// the jnp blocked attention, which XLA differentiates:
//
//   fa90_backward <- jax.grad of blocked_attention (:186) of
//                    src/repro/models/layers.py
//
// q [b, h, sq, hd], k / v [b, kvh, skv, hd], o and dO [b, h, sq, hd]
// bf16 (any strides with a unit stride on hd that TMA can address), and
// the forward's base-2 log-sum-exp of each row, lse_i = m_i c +
// log2(l_i) with c = scale log2(e) (flash_attention_sm90.cu writes it
// under autograd) -> dq [b, h, sq, hd], dk / dv [b, kvh, skv, hd] bf16.
// Query head hi reads kv head hi / (h / kvh); dk and dv of a kv head sum
// its h / kvh query heads.  The mask is the forward's: key j is masked
// for query i when causal and j > i, or a window is given and j <= i -
// window; keys past skv and queries past sq weigh nothing.  With s =
// q_i . k_j (f32 products of the bf16 operands):
//
//   P_ij    = 2^(s c - lse_i)                 0 where masked
//   delta_i = sum_d dO_id o_id                f32 from the bf16 values
//   dS_ij   = P_ij (dO_i . v_j - delta_i)
//   dq_i    = scale sum_j dS_ij k_j    dk_j = scale sum_i dS_ij q_i
//   dv_j    = sum_i P_ij dO_i
//
// P and dS are rounded to bf16 for the products that take them from
// registers (dV, dQ, dK); every accumulator, lse and delta stay f32.
//
// Two kernels on one stream, no float atomics: every output element is
// written once by the one CTA that owns it, and every sum is walked in
// a fixed order, so a backward gives the same bits on every run (resume
// and the kill-and-restore checks compare bits).  FlashAttention-3's
// atomic dq accumulation is left out for that reason.
//
// - dq pass: one CTA per (128-row query tile, b * h), heaviest first.
//   Q and dO of the tile are resident; its consumers first compute
//   delta of their rows from o and dO (read from global memory, each
//   quad's four threads a quarter of hd, one quad reduction) and store
//   it for the second kernel.  Then it walks the kBN-key tiles the rows
//   can see (the forward's causal and window skips) through a TMA ring:
//   S = Q.K^T and dP = dO.V^T (wgmma m64n{kBN}k16, both operands K-major
//   in shared memory), P and dS on the accumulator fragment, dQ += dS.K
//   (wgmma m64n{hd}k16, dS in bf16 from registers, K MN-major: the
//   pattern of the forward's P.V).
// - dk / dv pass: one CTA per (tile of kKeys keys, b * kvh), K and V
//   resident.  For each query head of the GQA group in order, it walks
//   every kBN-row query tile that sees one of its keys (causal: from the
//   tile's first key; window: up to its last key + window - 1), with the
//   tile's lse and delta brought in by bulk copies: S^T = K.Q^T and
//   dP^T = V.dO^T (ss), P^T and dS^T, dV += P^T.dO and dK += dS^T.Q (rs,
//   dO and Q MN-major).  dK and dV stay in registers across the group,
//   so GQA's sum needs no atomics.
// - the geometry of each head dim (``Geo``).  hd 64 and 128: kBN = 64,
//   kKeys = 128, each consumer warpgroup owns 64 of the resident rows
//   at every column.  hd 80 runs the hd-128 geometry on tensor maps
//   whose inner dimension is 80: TMA zero-fills columns 80-127, so S and
//   dP are exact (their k-steps over the zero columns are skipped), the
//   padded columns of dQ, dK and dV come out 0 and are never stored.
//   hd 256: kBN = 32 (S, dP m64n32; the dq consumer holds 128 dQ + 16 S
//   + 16 dP + 8 dS values, its 128 x 256 Q and dO 128 KB and 3 stages
//   of K and V 96 KB: 225 KB, one CTA an SM); the dk / dv pass keeps 64
//   keys a CTA (kKeys = 64, kSplit = 2): dK + dV of 128 keys would be 256
//   f32 a consumer thread against a budget of 240, so the two consumer
//   warpgroups share the same 64 keys and split dK / dV along hd, 128
//   columns each (64 + 64 f32 a thread).  Each warpgroup computes the
//   whole S^T and dP^T of its keys (64 x 32 a tile) again rather than
//   sharing them through shared memory: no barrier between the
//   warpgroups and no swizzled stores of P^T / dS^T, at 1.5x the pass's
//   products (S^T and dP^T twice: 6 of a pair's hd-long products instead
//   of 4).
// - each CTA: two consumer warpgroups, each owning 64 of the 128
//   resident rows, and a producer warpgroup whose first thread issues
//   every load: 384 threads, with setmaxnreg (producer 24, consumers
//   240) at the top of each role, as the forward does: the dk / dv
//   consumers hold dK and dV, 64 + 64 f32 at hd 128, with S^T and dP^T,
//   32 + 32, past the 168 registers a thread of 384 gets at entry (a CTA
//   of 288 threads, two warpgroups and a producer warp, is allocated as
//   twelve warps all the same: 168 too, and spilled 896 bytes on an
//   H100).  A warpgroup skips the products of a tile whose every pair it
//   masks, and still frees the stage.
// - shared memory: boxes of 64 bf16 columns (128 bytes a row, 128-byte
//   swizzle), 64 rows in the resident tiles and kBN rows in the streamed
//   ones, a ring of 3 stages; at hd 128 (and 80) the dq pass takes 160
//   KB, the dk / dv pass 162 KB (one CTA an SM); at hd 64 half; at hd
//   256 225 KB and 161 KB.
//
// Bound on the H100: the backward needs five products a visible (query,
// key) pair — S, dP, dV, dQ, dK — 10 * hd FLOPs at the dense bf16
// tensor-core peak (989 TFLOP/s).  The two passes do seven (14 * hd: S
// and dP are computed in both), so this design's ceiling is 10 / 14 =
// ~71% of that bound; at hd 256 nine (the dk / dv pass's S^T and dP^T
// twice), 10 / 18 = ~56%; at hd 80 the two passes do S and dP twice
// over 80 columns and dV, dQ, dK over hd 128's padded 128: 2 x (4 x 80
// + 3 x 128) = 1,408 FLOPs a pair for the bound's 800, a ceiling of
// ~57%.  Measured on an H100 80GB HBM3 at 700 W, device time of one
// backward in a CUDA graph at the 4 x 2,048 causal prefill shapes
// (chip_smoke.py phase 14a; PERF.md's B13 backward row): 37-40% of the
// bound at hd 128 [4, 16/8, 2,048, 128], 26.8% at hd 256 [4, 8/4,
// 2,048, 256] (0.648 ms) and 27.1% at hd 80 [4, 32/32, 2,048, 80]
// (0.803 ms).
//
// Limits, from a CPU emulation of exactly this arithmetic (tests/
// test_torch_attention_bwd_wgmma.py: its passes' tile walks and sum
// order, hd 64, 80, 128 and 256, GQA 1-4, causal and windowed, flat and peaked
// scores; the emulation held to ref.attention_bwd and to jax.grad of the
// reference's blocked_attention): against ref.attention_bwd on the same
// o, every gradient within 2e-2 + 2e-2 |plain| (the emulation takes at
// most 0.76 of it), today's bf16 limit.  End to end, o from the bf16
// forward against the f32 autograd of the plain forward: within the same
// limit for q, k at up to N(0,1) (the card checks' draw; the emulation
// needs 0.012 + 2e-2 |plain|); a peaked softmax (q, k at 2 N(0,1)) needs
// 6e-2 + 2e-2 |plain| (0.046 measured), because where one key dominates
// dP - delta cancels and the bf16 rounding of the o that delta reads
// reaches dq and dk.  The card tests and chip_smoke.py hold the kernel
// to these limits.
//
// The entry point launches on the caller's stream, never synchronises,
// allocates nothing (the wrapper hands it lse and the delta scratch) and
// returns cudaGetLastError() (or kEncodeError + the CUresult when a
// tensor map cannot be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "sm90.cuh"
#include "smem.cuh"

namespace {

constexpr int kBM = 128;                 // resident rows a dq CTA
constexpr int kStages = 3;               // ring depth
constexpr int kConsumerWarps = 8;        // 2 consumer warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer's
constexpr uint32_t kBox = 64 * 128;      // 64 rows x 64 bf16 columns, 8 KB

template <int HD>
struct Geo {
  static_assert(HD == 64 || HD == 80 || HD == 128 || HD == 256,
                "wgmma route: hd 64, 80, 128 or 256");
  static constexpr int kPad = HD == 80 ? 128 : HD;     // columns a tile holds
  static constexpr int kBoxes = kPad / 64;              // boxes a tile row
  static constexpr int kSteps = (HD + 15) / 16;         // S's, dP's k-steps
  static constexpr int kBN = HD == 256 ? 32 : 64;       // rows a streamed tile
  static constexpr int kSplit = HD == 256 ? 2 : 1;      // dK / dV hd parts
  static constexpr int kKeys = kBM / kSplit;            // keys a dk / dv CTA
  static constexpr int kAcc = kPad / 2;                 // dQ values a thread
  static constexpr int kAccKV = kAcc / kSplit;          // dK, dV values
  static constexpr int kS = kBN / 2;                    // S, dP values
  static constexpr uint32_t kTBox = kBN * 128;          // a streamed box
  static constexpr uint32_t kTileBytes = kBoxes * kTBox;
  static constexpr uint32_t kResBytes = 2 * kBoxes * kBox;      // 128 rows
  static constexpr uint32_t kKvResBytes = kKeys / 64 * kBoxes * kBox;
  static constexpr uint32_t kRowStats = 2 * kBN * 4;   // lse and delta
  static constexpr uint32_t kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr uint32_t kDqSmem =
      2 * kResBytes + 2 * kStages * kTileBytes + kBarBytes + 1024;
  static constexpr uint32_t kDkvSmem = 2 * kKvResBytes +
                                       2 * kStages * kTileBytes +
                                       kStages * kRowStats + kBarBytes + 1024;
  static_assert(kDqSmem <= 227 * 1024 && kDkvSmem <= 227 * 1024,
                "one CTA an SM");
};

struct Params {
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;              // [b * h][ld]
  float* delta;                  // [b * h][ld], written by the dq pass
  int64_t ob, oh, os, db, dh, ds;
  int64_t gqb, gqh, gqs, gkb, gkh, gks, gvb, gvh, gvs;
  int h, kvh, group, sq, skv, causal, window, ld;   // window <= 0: none
  float scale, scale_log2;
};

__device__ __forceinline__ bool masked(const Params& P, int qp, int kp) {
  return kp >= P.skv || qp >= P.sq || (P.causal && kp > qp) ||
         (P.window > 0 && kp <= qp - P.window);
}

// this thread's quarter of dO_row . o_row (0 past sq): 16-byte loads
// where a quarter is a whole number of them, bf16 pairs at hd 80
template <int HD>
__device__ __forceinline__ float row_dot(const Params& P, int bi, int hi,
                                         int row, int part) {
  if (row >= P.sq) return 0.0f;
  if constexpr (HD % 32 != 0) {
    const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(P.o) + bi * P.ob + hi * P.oh +
        row * P.os + part * (HD / 4));
    const __nv_bfloat162* d = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(P.dout) + bi * P.db + hi * P.dh +
        row * P.ds + part * (HD / 4));
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const float2 x = __bfloat1622float2(o[i]);
      const float2 y = __bfloat1622float2(d[i]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
    return acc;
  }
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(P.o) +
                           bi * P.ob + hi * P.oh + row * P.os +
                           part * (HD / 4);
  const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(P.dout) +
                           bi * P.db + hi * P.dh + row * P.ds +
                           part * (HD / 4);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < HD / 4; i += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + i);
    const uint4 b = *reinterpret_cast<const uint4*>(d + i);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(a2[j]);
      const float2 y = __bfloat1622float2(b2[j]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  return acc;
}

// A (resident, K-major, 64 rows at ``a`` in boxes of kBox) times B^T (a
// streamed kBN-row tile at ``b``, K-major) over hd: m64n{kBN}, kSteps
// steps (none over hd 80's zero-filled columns)
template <int HD>
__device__ __forceinline__ void issue_ss(float (&d)[Geo<HD>::kS], uint32_t a,
                                         uint32_t b) {
  using G = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < G::kSteps; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(d, desc_sw128(a + (kk / 4) * kBox + col, 16, 1024),
             desc_sw128(b + (kk / 4) * G::kTBox + col, 16, 1024), kk > 0);
  }
}

// d += A.B over a streamed tile's kBN rows: A the bf16 pairs of an
// m64n{kBN} fragment, B the tile's columns from ``b`` on, MN-major;
// kBN / 16 steps of m64n{2 R}k16
template <int HD, int R>
__device__ __forceinline__ void issue_rs(float (&d)[R],
                                         const uint32_t (&a)[Geo<HD>::kS / 2],
                                         uint32_t b) {
  using G = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < G::kBN / 16; ++kk)
    wgmma_rs(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
             desc_sw128(b + kk * 16 * 128, G::kTBox, 1024));
}

// dq pass: the tile's dS in bf16 pairs from S and dP (rows = queries)
template <bool kCut, int N>
__device__ __forceinline__ void dq_tile(const float (&s)[N],
                                        const float (&dp)[N],
                                        uint32_t (&pa)[N / 2],
                                        const Params& P, int k0, int row0,
                                        int row1, int tq4, float lse0,
                                        float lse1, float dl0, float dl1) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    float d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * j + e;
      const bool second = r & 2;
      float p = ex2(fmaf(s[r], P.scale_log2, second ? -lse1 : -lse0));
      if (kCut && masked(P, second ? row1 : row0,
                         k0 + 8 * (r >> 2) + 2 * tq4 + (r & 1)))
        p = 0.0f;
      d[e] = p * (dp[r] - (second ? dl1 : dl0));
    }
    pa[j] = pack_bf16(d[0], d[1]);
  }
}

// dk / dv pass: the tile's P^T and dS^T in bf16 pairs from S^T and dP^T
// (rows = keys, columns = the tile's N queries, whose lse and delta are
// at ``sl`` and ``sl + N``)
template <bool kCut, int N>
__device__ __forceinline__ void dkv_tile(const float (&s)[N],
                                         const float (&dp)[N],
                                         uint32_t (&pp)[N / 2],
                                         uint32_t (&pd)[N / 2],
                                         const Params& P, const float* sl,
                                         int q0, int key0, int key1,
                                         int tq4) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int r = 2 * j, col = 8 * (r >> 2) + 2 * tq4;
    const int kp = (r & 2) ? key1 : key0;
    const float2 L = *reinterpret_cast<const float2*>(sl + col);
    const float2 D = *reinterpret_cast<const float2*>(sl + 2 * N + col);
    float p0 = ex2(fmaf(s[r], P.scale_log2, -L.x));
    float p1 = ex2(fmaf(s[r + 1], P.scale_log2, -L.y));
    float d0 = p0 * (dp[r] - D.x), d1 = p1 * (dp[r + 1] - D.y);
    if (kCut) {
      if (masked(P, q0 + col, kp)) p0 = d0 = 0.0f;
      if (masked(P, q0 + col + 1, kp)) p1 = d1 = 0.0f;
    }
    pp[j] = pack_bf16(p0, p1);
    pd[j] = pack_bf16(d0, d1);
  }
}

// store a warpgroup's m64n{2 R} accumulator times ``mul`` in bf16 at
// ``out`` (its first column): rows row0 / row1 (skipped at or past
// ``n``), row stride ``rs``, columns at or past ``cols`` (hd 80's
// zero-filled ones) skipped
template <int R, int kCols = 2 * R>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t rs,
                                           const float (&acc)[R], float mul,
                                           int row0, int row1, int n,
                                           int tq4) {
#pragma unroll
  for (int r = 0; r < R; r += 2) {
    const int row = (r & 2) ? row1 : row0;
    if (8 * (r >> 2) >= kCols || row >= n) continue;
    *reinterpret_cast<__nv_bfloat162*>(out + row * rs + 8 * (r >> 2) +
                                       2 * tq4) =
        __floats2bfloat162_rn(acc[r] * mul, acc[r + 1] * mul);
  }
}

// ---- the dq pass ------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_sm90(__grid_constant__ const CUtensorMap tq,
                 __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv,
                 __grid_constant__ const CUtensorMap tdo, const Params P) {
  using G = Geo<HD>;
  constexpr int kBN = G::kBN;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + G::kResBytes;
  const uint32_t sK = sDO + G::kResBytes;          // stage s: + s * tile
  const uint32_t sV = sK + kStages * G::kTileBytes;
  const uint32_t bar = sV + kStages * G::kTileBytes;
  const uint32_t q_full = bar;
  auto full = [bar](int s) { return bar + 8u + 8u * s; };
  auto empty = [bar](int s) { return bar + 8u + 8u * (kStages + s); };

  const int bh = blockIdx.x, bi = bh / P.h, hi = bh % P.h;
  const int kvi = hi / P.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  // the kBN-key tiles these rows can see: [t_lo, t_lo + n_tiles)
  const int q_last = min(q0 + kBM, P.sq) - 1;
  const int kv_hi = P.causal ? min(P.skv, q_last + 1) : P.skv;
  const int kv_lo = P.window > 0 ? max(0, q0 - P.window + 1) : 0;
  const int t_lo = kv_lo / kBN;
  const int n_tiles = max((kv_hi + kBN - 1) / kBN - t_lo, 0);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  if (warp >= kConsumerWarps) {
    // ---- producer: its first thread issues every load ------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_full, 2 * G::kResBytes);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < G::kBoxes; ++c) {
          const uint32_t off = (half * G::kBoxes + c) * kBox;
          tma_load(sQ + off, &tq, q_full, 64 * c, q0 + 64 * half, hi, bi);
          tma_load(sDO + off, &tdo, q_full, 64 * c, q0 + 64 * half, hi, bi);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        const int k0 = (t_lo + i) * kBN;
        mbar_expect_tx(full(s), 2 * G::kTileBytes);
        for (int c = 0; c < G::kBoxes; ++c) {
          const uint32_t off = s * G::kTileBytes + c * G::kTBox;
          tma_load(sK + off, &tk, full(s), 64 * c, k0, kvi, bi);
          tma_load(sV + off, &tv, full(s), 64 * c, k0, kvi, bi);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each --------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4, g = lane / 4, tq4 = lane % 4;
  const int rows_lo = q0 + 64 * wg;
  const int row0 = rows_lo + 16 * (warp % 4) + g, row1 = row0 + 8;
  const int64_t stat = static_cast<int64_t>(bh) * P.ld;
  // delta of the two rows, stored for the dk / dv pass
  const float dl0 = quad_sum(row_dot<HD>(P, bi, hi, row0, tq4));
  const float dl1 = quad_sum(row_dot<HD>(P, bi, hi, row1, tq4));
  if (tq4 == 0) {
    if (row0 < P.sq) P.delta[stat + row0] = dl0;
    if (row1 < P.sq) P.delta[stat + row1] = dl1;
  }
  const float lse0 = row0 < P.sq ? P.lse[stat + row0] : 0.0f;
  const float lse1 = row1 < P.sq ? P.lse[stat + row1] : 0.0f;

  float dq[G::kAcc], s[G::kS], dp[G::kS];
  uint32_t pa[G::kS / 2];
#pragma unroll
  for (int r = 0; r < G::kAcc; ++r) dq[r] = 0.0f;
  const uint32_t sQw = sQ + wg * G::kBoxes * kBox;
  const uint32_t sDOw = sDO + wg * G::kBoxes * kBox;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages;
    const int k0 = (t_lo + i) * kBN;
    // does any key of the tile reach one of this warpgroup's rows?
    const bool seen = rows_lo < P.sq && !(P.causal && k0 > rows_lo + 63) &&
                      !(P.window > 0 && k0 + kBN - 1 <= rows_lo - P.window);
    mbar_wait(full(st), (i / kStages) & 1);
    if (seen) {
      const uint32_t tK = sK + st * G::kTileBytes;
      const uint32_t tV = sV + st * G::kTileBytes;
      pin(s);
      pin(dp);
      wgmma_fence();
      issue_ss<HD>(s, sQw, tK);
      issue_ss<HD>(dp, sDOw, tV);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      const bool cut = (P.causal && k0 + kBN - 1 > rows_lo) ||
                       (P.window > 0 && k0 <= rows_lo + 63 - P.window) ||
                       k0 + kBN > P.skv;
      if (cut)
        dq_tile<true>(s, dp, pa, P, k0, row0, row1, tq4, lse0, lse1, dl0,
                      dl1);
      else
        dq_tile<false>(s, dp, pa, P, k0, row0, row1, tq4, lse0, lse1, dl0,
                       dl1);
      pin(dq);
      wgmma_fence();
      issue_rs<HD>(dq, pa, tK);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dq);
    }
    if (lane == 0) mbar_arrive(empty(st));
  }

  store_rows<G::kAcc, HD>(
      static_cast<__nv_bfloat16*>(P.dq) + bi * P.gqb + hi * P.gqh, P.gqs, dq,
      P.scale, row0, row1, P.sq, tq4);
}

// ---- the dk / dv pass -------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkv_sm90(__grid_constant__ const CUtensorMap tq,
                  __grid_constant__ const CUtensorMap tk,
                  __grid_constant__ const CUtensorMap tv,
                  __grid_constant__ const CUtensorMap tdo, const Params P) {
  using G = Geo<HD>;
  constexpr int kBN = G::kBN;
  constexpr uint32_t kRowStats = G::kRowStats;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + G::kKvResBytes;
  const uint32_t sQ = sV + G::kKvResBytes;         // stage s: + s * tile
  const uint32_t sDO = sQ + kStages * G::kTileBytes;
  const uint32_t sL = sDO + kStages * G::kTileBytes;   // + s * kRowStats
  const uint32_t bar = sL + kStages * kRowStats;
  const uint32_t kv_full = bar;
  auto full = [bar](int s) { return bar + 8u + 8u * s; };
  auto empty = [bar](int s) { return bar + 8u + 8u * (kStages + s); };

  const int bkv = blockIdx.x, bi = bkv / P.kvh, kvi = bkv % P.kvh;
  const int k0 = blockIdx.y * G::kKeys;
  // the kBN-row query tiles that see one of these keys, per query head
  const int k_last = min(k0 + G::kKeys, P.skv) - 1;
  const int q_lo = P.causal ? k0 : 0;
  const int q_hi = P.window > 0 ? min(P.sq, k_last + P.window) : P.sq;
  const int t_lo = q_lo / kBN;
  const int n_qt = max((q_hi + kBN - 1) / kBN - t_lo, 0);
  const int n_iter = P.group * n_qt;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  if (warp >= kConsumerWarps) {
    // ---- producer -------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(kv_full, 2 * G::kKvResBytes);
      for (int half = 0; half < G::kKeys / 64; ++half)
        for (int c = 0; c < G::kBoxes; ++c) {
          const uint32_t off = (half * G::kBoxes + c) * kBox;
          tma_load(sK + off, &tk, kv_full, 64 * c, k0 + 64 * half, kvi, bi);
          tma_load(sV + off, &tv, kv_full, 64 * c, k0 + 64 * half, kvi, bi);
        }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const int hi = kvi * P.group + it / n_qt;
        const int q0 = (t_lo + it % n_qt) * kBN;
        const int64_t row = (static_cast<int64_t>(bi) * P.h + hi) * P.ld + q0;
        mbar_expect_tx(full(s), 2 * G::kTileBytes + kRowStats);
        for (int c = 0; c < G::kBoxes; ++c) {
          const uint32_t off = s * G::kTileBytes + c * G::kTBox;
          tma_load(sQ + off, &tq, full(s), 64 * c, q0, hi, bi);
          tma_load(sDO + off, &tdo, full(s), 64 * c, q0, hi, bi);
        }
        bulk_load(sL + s * kRowStats, P.lse + row, kRowStats / 2, full(s));
        bulk_load(sL + s * kRowStats + kRowStats / 2, P.delta + row,
                  kRowStats / 2, full(s));
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each (kSplit 2: the same 64 keys,
  // half of hd each) ------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4, g = lane / 4, tq4 = lane % 4;
  const int kw = G::kSplit == 1 ? wg : 0;          // this warpgroup's keys
  const int keys_lo = k0 + 64 * kw;
  const int key0 = keys_lo + 16 * (warp % 4) + g, key1 = key0 + 8;
  const uint32_t sKw = sK + kw * G::kBoxes * kBox;
  const uint32_t sVw = sV + kw * G::kBoxes * kBox;
  // this warpgroup's columns of dK / dV: boxes [part, part + kBoxes /
  // kSplit) of a streamed tile
  const int part = G::kSplit == 1 ? 0 : wg * G::kBoxes / G::kSplit;
  const uint8_t* gsm = smem_raw + (sL - raw);      // generic address of sL

  float dk[G::kAccKV], dv[G::kAccKV], s[G::kS], dp[G::kS];
  uint32_t pp[G::kS / 2], pd[G::kS / 2];
#pragma unroll
  for (int r = 0; r < G::kAccKV; ++r) dk[r] = dv[r] = 0.0f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    const int q0 = (t_lo + it % n_qt) * kBN;
    // does any query of the tile see one of this warpgroup's keys?
    const bool seen = keys_lo < P.skv &&
                      !(P.causal && keys_lo > q0 + kBN - 1) &&
                      !(P.window > 0 && keys_lo + 63 <= q0 - P.window);
    mbar_wait(full(st), (it / kStages) & 1);
    if (seen) {
      const uint32_t tQ = sQ + st * G::kTileBytes;
      const uint32_t tDO = sDO + st * G::kTileBytes;
      const float* sl = reinterpret_cast<const float*>(gsm + st * kRowStats);
      pin(s);
      pin(dp);
      wgmma_fence();
      issue_ss<HD>(s, sKw, tQ);
      issue_ss<HD>(dp, sVw, tDO);
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);
      const bool cut = (P.causal && keys_lo + 63 > q0) ||
                       (P.window > 0 && keys_lo <= q0 + kBN - 1 - P.window) ||
                       keys_lo + 64 > P.skv || q0 + kBN > P.sq;
      if (cut)
        dkv_tile<true>(s, dp, pp, pd, P, sl, q0, key0, key1, tq4);
      else
        dkv_tile<false>(s, dp, pp, pd, P, sl, q0, key0, key1, tq4);
      pin(dv);
      pin(dk);
      wgmma_fence();
      issue_rs<HD>(dv, pp, tDO + part * G::kTBox);
      issue_rs<HD>(dk, pd, tQ + part * G::kTBox);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dv);
      pin(dk);
    }
    if (lane == 0) mbar_arrive(empty(st));
  }

  constexpr int kCols = HD / G::kSplit;            // real columns a part
  const int col0 = part * 64;
  store_rows<G::kAccKV, kCols>(
      static_cast<__nv_bfloat16*>(P.dk) + bi * P.gkb + kvi * P.gkh + col0,
      P.gks, dk, P.scale, key0, key1, P.skv, tq4);
  store_rows<G::kAccKV, kCols>(
      static_cast<__nv_bfloat16*>(P.dv) + bi * P.gvb + kvi * P.gvh + col0,
      P.gvs, dv, 1.0f, key0, key1, P.skv, tq4);
}

// ---- host side ---------------------------------------------------------------

// the four maps (q, k, v, dO) of one pass: boxes of ``q_rows`` rows for
// q and dO, ``kv_rows`` for k and v, 64 columns each
int encode_pass(CUtensorMap (&m)[4], const void* q, const void* k,
                const void* v, const void* dout, const int64_t* strides,
                int hd, int b, int h, int kvh, int sq, int skv, int q_rows,
                int kv_rows) {
  EncodeTiled fn;
  const cudaError_t err = encoder(&fn);
  if (err != cudaSuccess) return err;
  int rc = encode(fn, &m[0], q, hd, b, h, sq, strides, q_rows);
  if (rc == 0)
    rc = encode(fn, &m[1], k, hd, b, kvh, skv, strides + 3, kv_rows);
  if (rc == 0)
    rc = encode(fn, &m[2], v, hd, b, kvh, skv, strides + 6, kv_rows);
  if (rc == 0)
    rc = encode(fn, &m[3], dout, hd, b, h, sq, strides + 12, q_rows);
  return rc;
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* dout,
              const int64_t* strides, int b, const Params& p,
              cudaStream_t stream) {
  using G = Geo<HD>;
  // the dq pass streams K / V tiles of kBN rows under resident 64-row Q /
  // dO boxes, the dk / dv pass the other way round
  CUtensorMap mq[4], mkv[4];
  int rc = encode_pass(mq, q, k, v, dout, strides, HD, b, p.h, p.kvh, p.sq,
                       p.skv, 64, G::kBN);
  if (rc == 0 && G::kBN != 64)
    rc = encode_pass(mkv, q, k, v, dout, strides, HD, b, p.h, p.kvh, p.sq,
                     p.skv, G::kBN, 64);
  if (rc != 0) return rc;
  if (G::kBN == 64)                      // both passes' boxes are 64 rows
    for (int i = 0; i < 4; ++i) mkv[i] = mq[i];
  static bool configured[kMaxDevices] = {};
  cudaError_t err = once_a_device(configured, [] {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_bwd_dq_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::kDqSmem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        attn_bwd_dkv_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(G::kDkvSmem));
  });
  if (err != cudaSuccess) return err;
  const dim3 grid_dq(b * p.h, (p.sq + kBM - 1) / kBM);
  attn_bwd_dq_sm90<HD><<<grid_dq, kThreads, G::kDqSmem, stream>>>(
      mq[0], mq[1], mq[2], mq[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkv(b * p.kvh, (p.skv + G::kKeys - 1) / G::kKeys);
  attn_bwd_dkv_sm90<HD><<<grid_dkv, kThreads, G::kDkvSmem, stream>>>(
      mkv[0], mkv[1], mkv[2], mkv[3], p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fa90_bwd_error_string(int code) {
  static char msg[96];
  if (code >= kEncodeError) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// strides: 24 int64 in elements, (batch, head, seq) of q, k, v, o, dO,
// dq, dk, dv; q's, k's, v's, o's and dO's seq / head / batch strides
// multiples of 8 elements (16 bytes) and their bases 16-byte aligned (the
// wrapper checks).  lse and delta: [b * h] rows of ld f32 (ld a multiple
// of 128, 16-byte aligned bases).  hd 64, 80, 128 or 256; anything else
// returns cudaErrorInvalidValue (the wrapper routes it to the SIMT
// kernel).
int fa90_backward(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, void* dq, void* dk, void* dv,
                  const float* lse, float* delta, const int64_t* strides,
                  int b, int h, int kvh, int sq, int skv, int hd, int ld,
                  int causal, int window, float scale, void* stream) {
  Params p;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.delta = delta;
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
  p.ld = ld;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_hd<64>(q, k, v, dout, strides, b, p, s);
    case 80: return launch_hd<80>(q, k, v, dout, strides, b, p, s);
    case 128: return launch_hd<128>(q, k, v, dout, strides, b, p, s);
    case 256: return launch_hd<256>(q, k, v, dout, strides, b, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
