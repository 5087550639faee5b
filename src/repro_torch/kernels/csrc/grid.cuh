// Launch geometry shared by the port's elementwise kernels: 256-thread
// blocks, and a grid-stride grid of at most 8 blocks per SM (enough to
// keep every SM's memory pipeline full without a tail of idle blocks).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// blocks for n work items of one thread each, capped at 8 per SM
int grid_for(int64_t n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int64_t want = (n + kThreads - 1) / kThreads;
  int64_t cap = static_cast<int64_t>(sms) * 8;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace
