// Building blocks of the fused token kernels K1, K2 and K4
// (befuse_k1.cu, befuse_k2.cu, befuse_k4.cu): the row's working area,
// block-wide scans and reductions, the in-block row sort of the network
// kernels, and the register-resident scans of the radix kernels.
//
// Every kernel runs one CTA per replica row, in one of two forms:
// - the radix form (256 <= P <= 8192: every width of the wave and its
//   doubled-budget retry) holds the row in registers, warp-striped as
//   radix.cuh's row sort wants it, and keeps only what other threads
//   gather in shared memory;
// - the network form (other widths) keeps its [P] and [Kp] working
//   arrays in dynamic shared memory when they fit the block's limit
//   (227 KB on the H100), else in a global-memory scratch row that the
//   wrapper allocates. The code is the same either way: a base pointer
//   and __syncthreads, which orders global writes within a block as it
//   does shared ones.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bitonic.cuh"
#include "radix.cuh"
#include "smem_attrs.cuh"

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

// Sets *fits to whether `bytes` of working area fit in one block's
// dynamic shared memory on the current device. The device's limit is
// queried once per device and process.
static inline cudaError_t bf_fits_smem(size_t bytes, int* fits) {
    static std::atomic<int> limits[CAUSE_MAX_DEVICES];  // 0: not read yet
    int dev = 0, limit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && dev < CAUSE_MAX_DEVICES)
        limit = limits[dev].load(std::memory_order_relaxed);
    if (e == cudaSuccess && limit == 0) {
        e = cudaDeviceGetAttribute(
            &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess && dev < CAUSE_MAX_DEVICES)
            limits[dev].store(limit, std::memory_order_relaxed);
    }
    *fits = e == cudaSuccess &&
            bytes + CAUSE_BF_STATIC_BYTES <= (size_t)limit;
    return e;
}

// The radix form's range of row widths (radix.cuh's, as B1's)
static inline bool bf_radix_width(int P) {
#ifdef CAUSE_FORCE_NETWORK
    (void)P;
    return false;  // a measurement build of the network form at every width
#else
    return P >= CAUSE_RADIX_MIN_P && P <= CAUSE_RADIX_MAX_P;
#endif
}

// CTAs of `kernel` an SM holds at `threads` and `smem` bytes, after the
// kernel's shared-memory attributes are set (-1: a CUDA error).
template <class F>
static inline int bf_ctas_per_sm(F kernel, int threads, size_t smem) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem) != cudaSuccess)
        return -1;
    return n;
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

// ------------------------------------------------- warp-striped rows
//
// A radix kernel holds its row of P = blockDim.x * IPT elements in
// registers, IPT a thread, in radix.cuh's arrangement: thread (warp w,
// lane l) holds elements (w * IPT + i) * 32 + l. A warp's loads of one
// item are 32 consecutive words, and the order (warp, item, lane) is the
// row's order, so a scan runs in registers: each item's 32 lanes by
// shuffles, the warp's items one after another with a carry, then one
// barrier for the earlier warps' totals.

#define CAUSE_FULL_MASK 0xffffffffu

// the row element of this thread's item i
template <int IPT>
__device__ __forceinline__ int ws_elem(int i) {
    return ((int)(threadIdx.x >> 5) * IPT + i) * 32 + (int)(threadIdx.x & 31);
}

// Exclusive scan of x over the warp's part of the row, in place; returns
// the warp's total (in every lane).
template <class Op, int IPT>
__device__ __forceinline__ int32_t ws_warp_scan(int32_t (&x)[IPT]) {
    const int lane = threadIdx.x & 31;
    int32_t carry = Op::id();
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        int32_t v = x[i];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int32_t y = __shfl_up_sync(CAUSE_FULL_MASK, v, d);
            if (lane >= d) v = Op::f(y, v);
        }
        int32_t ex = __shfl_up_sync(CAUSE_FULL_MASK, v, 1);
        if (lane == 0) ex = Op::id();
        x[i] = Op::f(carry, ex);
        carry = Op::f(carry, __shfl_sync(CAUSE_FULL_MASK, v, 31));
    }
    return carry;
}

// The warp's total into red[warp] (before a block barrier).
__device__ __forceinline__ void ws_publish(int32_t total, int32_t* red) {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = total;
}

// After the barrier: fold the earlier warps' totals into x; returns the
// block's total.
template <class Op, int IPT>
__device__ __forceinline__ int32_t ws_apply(int32_t (&x)[IPT],
                                            const int32_t* red) {
    const int w = threadIdx.x >> 5;
    const int W = blockDim.x >> 5;
    int32_t off = Op::id(), tot = Op::id();
    for (int k = 0; k < W; ++k) {
        if (k == w) off = tot;
        tot = Op::f(tot, red[k]);
    }
#pragma unroll
    for (int i = 0; i < IPT; ++i) x[i] = Op::f(off, x[i]);
    return tot;
}

// Exclusive block scan of the warp-striped row x in place (one barrier);
// returns the row's total. `red` holds 32 words no other scan in flight
// uses.
template <class Op, int IPT>
__device__ __forceinline__ int32_t ws_scan(int32_t (&x)[IPT], int32_t* red) {
    ws_publish(ws_warp_scan<Op, IPT>(x), red);
    __syncthreads();
    return ws_apply<Op, IPT>(x, red);
}

// ------------------------------------------- phase clocks (measurement)
//
// A build with -DCAUSE_PHASE_CLOCKS adds, per block, thread 0's clock64()
// cycles between block barriers to one of three sums: load, compute and
// store (0), scans (1), sorts (2). Each mark ends with a barrier of its
// own, so the build is slower than the kernel it measures and is only
// for splitting a kernel's time (chip_smoke.py --phases). Without the
// flag the marks compile to nothing.
#ifdef CAUSE_PHASE_CLOCKS
__device__ unsigned long long cause_phase_cycles[3];
#define BF_PHASE_START long long bf_phase_t0 = clock64();
#define BF_PHASE(k)                                                        \
    do {                                                                   \
        __syncthreads();                                                   \
        if (threadIdx.x == 0) {                                            \
            const long long bf_t = clock64();                              \
            atomicAdd(&cause_phase_cycles[k],                              \
                      (unsigned long long)(bf_t - bf_phase_t0));           \
            bf_phase_t0 = bf_t;                                            \
        }                                                                  \
    } while (0)
#define BF_PHASE_TAKE_FN                                                   \
    extern "C" int cause_phase_cycles_take(unsigned long long* out) {      \
        cudaError_t e = cudaMemcpyFromSymbol(out, cause_phase_cycles,      \
                                             sizeof(cause_phase_cycles));  \
        const unsigned long long zero[3] = {0, 0, 0};                      \
        if (e == cudaSuccess)                                              \
            e = cudaMemcpyToSymbol(cause_phase_cycles, zero, sizeof(zero));\
        return (int)e;                                                     \
    }
#else
#define BF_PHASE_START
#define BF_PHASE(k) \
    do {            \
    } while (0)
#define BF_PHASE_TAKE_FN
#endif
#define BF_LS 0
#define BF_SCAN 1
#define BF_SORT 2
