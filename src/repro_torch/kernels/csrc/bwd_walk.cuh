// What the backward kernels of B14 and B15 (wkv6_bwd.cu, mamba_scan_bwd.cu)
// share: cp.async staging, the split cluster barrier a chunk's partial
// sums cross, and the transposed butterfly that sums a lane's values over
// a run of lane bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cp.async of BYTES (4, 8 or 16) from src to shared dst
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(src), "n"(BYTES) : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The cluster barrier in two halves: arrive releases this thread's
// shared-memory writes to the cluster, wait acquires every CTA's that
// arrived.  Every thread of every CTA calls both, in turn.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The sums of N values a lane over the lanes that differ in bits BIT,
// 2 BIT, ... below END: while more than one value is left, a round
// halves them across lane xor BIT, each lane keeping the lower or the
// upper half by that bit (base gains the offset of the half kept); once
// one is left, a plain round.  Every sum is the pairwise tree over the
// lanes in lane order (a + b == b + a).
template <int N, int BIT, int END>
__device__ __forceinline__ void fold_rounds(float* x, int lane, int& base) {
  if constexpr (BIT < END) {
    if constexpr (N > 1) {
      constexpr int half = N / 2;
      const bool upper = lane & BIT;
#pragma unroll
      for (int m = 0; m < half; ++m) {
        const float send = upper ? x[m] : x[m + half];
        const float keep = upper ? x[m + half] : x[m];
        x[m] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
      }
      if (upper) base += half;
      fold_rounds<half, BIT * 2, END>(x, lane, base);
    } else {
      x[0] += __shfl_xor_sync(0xffffffffu, x[0], BIT);
      fold_rounds<1, BIT * 2, END>(x, lane, base);
    }
  }
}

// values left a lane after fold_rounds<N, BIT, END>
template <int N, int BIT, int END>
__host__ __device__ constexpr int fold_left() {
  if constexpr (BIT >= END || N == 1) return N;
  else return fold_left<N / 2, BIT * 2, END>();
}

// the lane bits of fold_rounds<N, BIT, END>'s plain rounds: a lane with
// any of them set holds another lane's copies
template <int N, int BIT, int END>
__host__ __device__ constexpr int fold_copies() {
  if constexpr (BIT >= END) return 0;
  else if constexpr (N > 1) return fold_copies<N / 2, BIT * 2, END>();
  else return BIT | fold_copies<1, BIT * 2, END>();
}

}  // namespace
