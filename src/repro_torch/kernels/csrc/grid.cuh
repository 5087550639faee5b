// Launch geometry shared by the port's elementwise kernels.
//
// grid_for: 256-thread blocks, and a grid-stride grid of at most 8 blocks
// per SM (enough to keep every SM's memory pipeline full without a tail
// of idle blocks).
//
// stream_grid: the streaming passes (Eq. 1, fused Adam).  A
// kStreamThreads-thread block takes one chunk of a few packs a thread,
// the grid covers the bus, and nothing loops: on the H100 this holds HBM
// at 88-92% of its rate at 2^27 elements where grid_for's grid-stride
// loop held 83-87% (vc_asgd_update.cu's Eq. 1 note).  64-thread blocks
// spread the MLP bus's 4,096 f32 packs over 32 SMs (64 for Adam's one
// pack a thread).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStreamThreads = 64;

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// blocks for n work items of one thread each, capped at 8 per SM
int grid_for(int64_t n) {
  int64_t want = (n + kThreads - 1) / kThreads;
  int64_t cap = static_cast<int64_t>(sm_count()) * 8;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

// blocks of a streaming pass over nvec packs, one chunk of unroll packs a
// thread each (at least one block)
inline int stream_grid(int64_t nvec, int unroll) {
  const int64_t chunk = static_cast<int64_t>(unroll) * kStreamThreads;
  const int64_t blocks = (nvec + chunk - 1) / chunk;
  return static_cast<int>(blocks > 0 ? blocks : 1);
}

}  // namespace
