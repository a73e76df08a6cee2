// Building blocks of the fused token kernels K1, K2 and K4
// (befuse_k1.cu, befuse_k2.cu, befuse_k4.cu): the row's working area,
// block-wide scans and reductions, and the in-block row sort.
//
// Every kernel runs one CTA per replica row. Its [P] and [Kp] working
// arrays live in dynamic shared memory when they fit the block's limit
// (227 KB on the H100), else in a global-memory scratch row that the
// wrapper allocates (the doubled-budget retry of merge_wave reaches
// P = 8192). The code is the same either way: a base pointer and
// __syncthreads, which orders global writes within a block as it does
// shared ones.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

#define CAUSE_BF_BIG INT32_MAX
#define CAUSE_BF_MAX_THREADS 512
// bytes of the block's static shared memory (reduction slots) plus slack
#define CAUSE_BF_STATIC_BYTES 1024

// Threads per CTA for rows of width P: P / 8 (the register form of the
// row sort) up to 4096, whole warps below, 512 above.
static inline int bf_threads(int P) {
    if (P > CAUSE_SORT_REG_MAX) return CAUSE_BF_MAX_THREADS;
    const int t = P / CAUSE_SORT_RE;
    return t < 32 ? 32 : t;
}

// Sets *fits to whether `words` int32 of working area fit in one block's
// dynamic shared memory on the current device.
static inline cudaError_t bf_fits_smem(size_t words, int* fits) {
    int dev = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    *fits = e == cudaSuccess &&
            words * sizeof(int32_t) + CAUSE_BF_STATIC_BYTES <= (size_t)limit;
    return e;
}

// Int32 words of a sort area of width n with NK keys (room for either
// layout of the row sort).
__host__ __device__ __forceinline__ int bf_sort_words(int NK, int n) {
    return (NK + 1) * (n + (n >> 5));
}

// A row-sort area: NK key columns then the position column. The register
// form uses the padded layout (stride pad32(n), index pad32(i)), the
// plain form stride n and index i.
struct SortArea {
    int32_t* key;
    int32_t* pos;
    int n;
    int stride;
    bool reg;
    __device__ __forceinline__ int at(int i) const { return reg ? pad32(i) : i; }
    __device__ __forceinline__ int32_t* col(int q) const { return key + q * stride; }
};

// The area of width n at `base` for NK keys. The register form needs the
// block to be exactly n / 8 threads and the area in shared memory.
template <int NK>
__device__ __forceinline__ SortArea sort_area(int32_t* base, int n,
                                              bool in_smem) {
    SortArea s;
    s.reg = in_smem && n >= CAUSE_SORT_REG_MIN && n <= CAUSE_SORT_REG_MAX &&
            n == (int)blockDim.x * CAUSE_SORT_RE;
    s.stride = s.reg ? pad32(n) : n;
    s.key = base;
    s.pos = base + NK * s.stride;
    s.n = n;
    return s;
}

// Sort the area in place (filled and synchronised by the caller); ends
// with a block barrier.
template <int NK>
__device__ __forceinline__ void row_sort(const SortArea& s) {
    if (s.reg) {
        bitonic_reg_smem<NK>(s.key, s.pos, s.n);
    } else {
        bitonic_net(s.key, s.pos, NK, s.n);
    }
}

// ------------------------------------------------------------ scans

struct OpSum {
    static __device__ __forceinline__ int32_t id() { return 0; }
    // int32 wraparound, as the reference cumsum
    static __device__ __forceinline__ int32_t f(int32_t a, int32_t b) {
        return (int32_t)((uint32_t)a + (uint32_t)b);
    }
};

struct OpMax {
    static __device__ __forceinline__ int32_t id() { return INT32_MIN; }
    static __device__ __forceinline__ int32_t f(int32_t a, int32_t b) {
        return a > b ? a : b;
    }
};

// Inclusive scan of a[0, n) in place. Each warp scans one contiguous
// segment 32 elements at a time (shuffles, a running carry), then adds
// the earlier warps' totals. `red` holds >= 32 words of shared memory.
// Starts after, and ends with, a block barrier.
template <class Op>
__device__ __forceinline__ void block_scan(int32_t* a, int n, int32_t* red) {
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const int seg = (n + nw - 1) / nw;
    const int lo = min(n, w * seg);
    const int hi = min(n, lo + seg);
    int32_t carry = Op::id();
    for (int base = lo; base < hi; base += 32) {
        const int i = base + lane;
        int32_t x = i < hi ? a[i] : Op::id();
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x = Op::f(y, x);
        }
        x = Op::f(carry, x);
        if (i < hi) a[i] = x;
        carry = __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) red[w] = carry;
    __syncthreads();
    if (w > 0) {
        int32_t off = Op::id();
        for (int k = 0; k < w; ++k) off = Op::f(off, red[k]);
        for (int i = lo + lane; i < hi; i += 32) a[i] = Op::f(off, a[i]);
    }
    __syncthreads();
}

// Sum of one int32 per thread over the block (int32 wraparound), returned
// to every thread. Ends with a block barrier.
__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* red) {
    uint32_t x = (uint32_t)v;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = (int32_t)x;
    __syncthreads();
    uint32_t s = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) s += (uint32_t)red[k];
    __syncthreads();
    return (int32_t)s;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// Allow the kernel `bytes` of dynamic shared memory (above 48 KB a block
// needs the opt-in attribute).
template <class K>
static inline cudaError_t bf_smem_attr(K kernel, size_t bytes) {
    if (bytes > 48 * 1024) {
        return cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    }
    return cudaSuccess;
}
