// A kernel's cap on dynamic shared memory, raised once.  Above 48 KB a
// launch needs cudaFuncSetAttribute first, a host call that the scan
// wrappers paid on every call.  Each kernel instance keeps the cap it set
// on each device (caps, a static of its launcher) and raises it only for a
// larger size: once per instance, device and larger k.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kCapDevices = 16;

inline cudaError_t raise_smem_cap(const void* kernel, size_t bytes,
                                  size_t (&caps)[kCapDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kCapDevices && bytes <= caps[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev < kCapDevices) caps[dev] = bytes;
  return err;
}

}  // namespace
