// The dynamic shared memory limit of a kernel, raised once per kernel and
// size.
//
// A block may use more than 48 KB of dynamic shared memory only after
// cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
// bytes). The limit belongs to the function, not to a launch, so it is set
// the first time a kernel needs more than it was given before, and never
// again: a launch path then makes no CUDA call but the launch. The
// serving engine captures the decode horizon's launches in a CUDA graph
// (src/repro_torch/serving/graphs.py) after a warm-up pass, so its captures
// hold launches alone, and eager callers save the call on every launch.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <unordered_map>

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;                                     // ctypes calls
  static std::unordered_map<const void*, size_t> raised;   // drop the GIL
  std::lock_guard<std::mutex> lock(mu);
  size_t& cur = raised[(const void*)kern];
  if (smem <= cur) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) cur = smem;
  return e;
}
