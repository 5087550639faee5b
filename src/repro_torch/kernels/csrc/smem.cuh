// Dynamic shared memory above the default 48 KB a block.
//
// cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicSharedMemorySize,
// ...) holds for the current device only, so a kernel that needs more
// sets it once on each device it launches on.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;

// set() (the attribute calls of one launch site) the first time it is
// reached on the current device; done is the launch site's own static
// table (a device index past it sets the attribute on every call)
template <typename F>
cudaError_t once_a_device(bool (&done)[kMaxDevices], F set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev]) return cudaSuccess;
  err = set();
  if (err == cudaSuccess && known) done[dev] = true;
  return err;
}

}  // namespace
