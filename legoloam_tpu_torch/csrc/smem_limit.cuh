// One-time dynamic shared memory limits for the kernels of this directory.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

// Raise kernel `fn`'s dynamic shared memory limit on the current device to
// `bytes`, only when a launch needs more than was set there before.  The
// attribute is set once per (device, kernel) in a process: a launch that a
// CUDA graph captures sets nothing, since its warm-up at the same shapes
// already did.
inline cudaError_t raise_smem_limit(const void* fn, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> limits;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  int& have = limits[{dev, fn}];
  if (bytes <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}
