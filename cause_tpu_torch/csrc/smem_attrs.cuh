// Shared-memory attributes of a kernel, set once per device and process
// instead of at every launch (each cudaFuncSetAttribute is a CUDA API call
// on the launch's host path).

#pragma once

#include <cuda_runtime.h>

#include <atomic>

#define CAUSE_MAX_DEVICES 64

// Let `kernel` take the whole carveout as shared memory and up to the
// card's opt-in limit of dynamic shared memory; `ready` is the kernel's
// own flag array. A launch asking for more than the limit still fails
// with its own error.
template <class F>
static cudaError_t smem_attrs_once(F kernel,
                                   std::atomic<bool> (&ready)[CAUSE_MAX_DEVICES]) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < CAUSE_MAX_DEVICES && ready[dev].load(std::memory_order_acquire))
        return cudaSuccess;
    int limit = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limit - (int)fa.sharedSizeBytes);
    if (e == cudaSuccess && dev < CAUSE_MAX_DEVICES)
        ready[dev].store(true, std::memory_order_release);
    return e;
}
