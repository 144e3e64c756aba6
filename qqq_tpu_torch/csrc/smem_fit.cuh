// The one place a kernel's block is held to the card's shared memory.
//
// An entry whose block size in shared memory depends on its arguments asks
// smem_fit before it launches; where the block would not fit it returns
// kSmemTooLarge, having launched nothing, and the Python wrapper
// (kernels/build.py:check) raises a ValueError that names the shape.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Not a cudaError_t: the entry refused a block too large for the card.
constexpr int kSmemTooLarge = -2;

// 0 when `dynamic_bytes` of dynamic shared memory plus the kernel's static
// shared memory fit in one block after opting in (and the opt-in is set),
// kSmemTooLarge when they do not, else the CUDA error of the query.
template <typename Kernel>
int smem_fit(Kernel kernel, size_t dynamic_bytes) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if (attr.sharedSizeBytes + dynamic_bytes > (size_t)limit)
    return kSmemTooLarge;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dynamic_bytes);
}
