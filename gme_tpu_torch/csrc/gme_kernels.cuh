// Shared declarations of the port's hand-written Hopper kernels.
//
// Every kernel is reached through a plain C launcher: it takes device
// pointers, sizes and the caller's CUDA stream, launches without
// synchronising or allocating, and returns cudaGetLastError() so a refused
// launch is reported at once.  gme_tpu_torch/ops/cuda_kernels.py builds these
// sources with nvcc into one shared library and binds the launchers with
// ctypes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define GME_API extern "C" __attribute__((visibility("default")))

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
static inline cudaError_t gme_allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
