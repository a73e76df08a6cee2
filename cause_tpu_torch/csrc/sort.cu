// B1: stable lexicographic sort of int32 rows, one CTA per row.
//
// Replaces the Pallas kernel of cause_tpu/weaver/pallas_sort.py
// (`_kernel_body`, launched by the pallas_call at :140 and :157 behind
// `pallas_bitonic_sort`, :176). Contract, bit for bit: ascending
// lexicographic order over the first `num_keys` operands, ties broken by
// the original position, the remaining operands riding as payloads. Rows
// are padded to P = next_pow2(n) inside the kernel (keys INT32_MAX,
// positions n..P-1), so padding sorts after every real element even when
// real keys equal INT32_MAX, and only the first n outputs are written.
//
// What bounds it on the H100: the HBM traffic is one read and one write
// of every operand (2 * n_ops * B * n * 4 bytes), a fraction of a
// millisecond at the wave's shapes. A comparison network cannot get near
// it: the bitonic network is log2(P) * (log2(P) + 1) / 2 compare-exchange
// stages (78 at P = 4096) whatever the keys hold, each bound by how fast
// elements move between threads.
//
// What the design does about it:
// - The radix path (one or two keys, 256 <= P <= 8192: every site of the
//   wave, and the doubled-budget retry) sorts with radix.cuh: the keys
//   are range-compressed to the bits the row's data spans (at most 15
//   bits for a lane or base key, so two 8-bit digit passes), packed into
//   one composite, and sorted by stable LSD passes that rank digits with
//   warp ballots and scatter through shared memory. Stability replaces
//   the position key.
// - Only the keys (and positions) are sorted; each payload is staged in
//   shared memory once and gathered by final position (the Pallas kernel
//   moves every operand at every stage).
//
// The network path (more than two keys, or P outside the radix path's
// range) runs bitonic_net from bitonic.cuh in shared memory, ending a
// stage that stays inside a warp's 64-element chunk with a warp barrier
// instead of a block barrier. A row whose keys do not fit the 227 KB a
// block may use runs it on a global-memory scratch row that the caller
// allocates; __syncthreads orders global writes within the block just as
// it does shared ones. The choice is a static rule on (P, num_keys) in
// cause_sort_rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "radix.cuh"
#include "smem_attrs.cuh"

#define CAUSE_SORT_MAX_OPS 9
#define CAUSE_SORT_THREADS 512

struct SortArgs {
    const int32_t* in[CAUSE_SORT_MAX_OPS];
    int32_t* out[CAUSE_SORT_MAX_OPS];
};

__global__ void sort_rows_kernel(SortArgs args, int n_ops, int num_keys,
                                 int n, int P, int32_t* scratch) {
    extern __shared__ int32_t smem[];
    const int row = blockIdx.x;
    const size_t row_off = (size_t)row * (size_t)n;
    int32_t* buf = scratch
        ? scratch + (size_t)row * (size_t)(num_keys + 1) * P
        : smem;
    int32_t* pos = buf + (size_t)num_keys * P;

    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        for (int k = 0; k < num_keys; ++k) {
            buf[(size_t)k * P + i] =
                i < n ? args.in[k][row_off + i] : INT32_MAX;
        }
        pos[i] = i;
    }
    __syncthreads();

    bitonic_net(buf, pos, num_keys, P);

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int src = pos[i];
        for (int k = 0; k < num_keys; ++k) {
            args.out[k][row_off + i] = buf[(size_t)k * P + i];
        }
        for (int k = num_keys; k < n_ops; ++k) {
            args.out[k][row_off + i] = args.in[k][row_off + src];
        }
    }
}

// ------------------------------------------------------------- radix path

template <int NK, int IPT>
__global__ void __launch_bounds__(CAUSE_RADIX_THREADS, IPT == 8 ? 2 : 1)
sort_rows_radix_kernel(SortArgs args, int n_ops, int n) {
    extern __shared__ __align__(16) unsigned char radix_smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t row_off = (size_t)blockIdx.x * (size_t)n;

    // warp-striped, coalesced: element (warp * IPT + i) * 32 + lane
    int32_t k[NK][IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int p = (warp * IPT + i) * 32 + lane;
#pragma unroll
        for (int q = 0; q < NK; ++q)
            k[q][i] = p < n ? args.in[q][row_off + p] : INT32_MAX;
    }
    const RadixRow<NK> row = radix_sort_row<NK, IPT>(k, radix_smem);

    // Each payload is staged in shared memory over the composite keys and
    // gathered by final position (padding sorts last: pos(i) < n). A
    // payload's loads (IPT a thread, all in flight) are issued before the
    // previous operand's writes.
    int32_t v[IPT];
    auto load = [&](int q) {
#pragma unroll
        for (int j = 0; j < IPT; ++j) {
            const int i = threadIdx.x + j * blockDim.x;
            v[j] = i < n ? args.in[q][row_off + i] : 0;
        }
    };
    if (NK < n_ops) load(NK);
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
        const int i = threadIdx.x + j * blockDim.x;
        if (i < n) {
#pragma unroll
            for (int q = 0; q < NK; ++q)
                args.out[q][row_off + i] = row.key(q, i);
        }
    }
    int32_t* stage = (int32_t*)radix_smem;
    for (int q = NK; q < n_ops; ++q) {
        __syncthreads();  // the area's last readers are done
#pragma unroll
        for (int j = 0; j < IPT; ++j) stage[threadIdx.x + j * blockDim.x] = v[j];
        __syncthreads();
        if (q + 1 < n_ops) load(q + 1);
#pragma unroll
        for (int j = 0; j < IPT; ++j) {
            const int i = threadIdx.x + j * blockDim.x;
            if (i < n) args.out[q][row_off + i] = stage[row.pos(i)];
        }
    }
}

template <int NK, int IPT>
static cudaError_t launch_radix(const SortArgs& args, int n_ops, int B, int n,
                                int P, cudaStream_t stream) {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    auto kernel = sort_rows_radix_kernel<NK, IPT>;
    // as many rows an SM as the registers allow: the whole carveout
    const cudaError_t e = smem_attrs_once(kernel, ready);
    if (e != cudaSuccess) return e;
    kernel<<<B, P / IPT, radix_smem_bytes(NK, P, IPT), stream>>>(args, n_ops,
                                                                 n);
    return cudaGetLastError();
}

extern "C" {

// Largest dynamic shared memory a block may use on this card (bytes).
int cause_sort_smem_limit(void) {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return 0;
    return bytes;
}

// Sort B rows of n int32 elements. `ins`/`outs` are host arrays of n_ops
// device pointers to [B, n] contiguous tensors; an output must not alias
// an input. `scratch` is null (rows live in shared memory) or a device
// buffer of B * (num_keys + 1) * P int32. Returns the cudaError_t of the
// launch.
int cause_sort_rows(void* const* ins, void* const* outs, int n_ops,
                    int num_keys, int B, int n, void* scratch,
                    void* stream) {
    if (n_ops < 1 || n_ops > CAUSE_SORT_MAX_OPS || num_keys < 1 ||
        num_keys > n_ops || B < 0 || n < 0)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || n == 0) return (int)cudaSuccess;
    SortArgs args;
    for (int k = 0; k < CAUSE_SORT_MAX_OPS; ++k) {
        args.in[k] = k < n_ops ? (const int32_t*)ins[k] : nullptr;
        args.out[k] = k < n_ops ? (int32_t*)outs[k] : nullptr;
    }
    int P = 1;
    while (P < n) P <<= 1;
    if (!scratch && num_keys <= 2 && P >= CAUSE_RADIX_MIN_P &&
        P <= CAUSE_RADIX_MAX_P) {
        const cudaStream_t st = (cudaStream_t)stream;
        if (radix_ipt(P) == 8)
            return (int)(num_keys == 1
                ? launch_radix<1, 8>(args, n_ops, B, n, P, st)
                : launch_radix<2, 8>(args, n_ops, B, n, P, st));
        return (int)(num_keys == 1
            ? launch_radix<1, 16>(args, n_ops, B, n, P, st)
            : launch_radix<2, 16>(args, n_ops, B, n, P, st));
    }
    const size_t bytes =
        (size_t)(num_keys + 1) * (size_t)P * sizeof(int32_t);
    const size_t smem = scratch ? 0 : bytes;
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    const cudaError_t e = smem_attrs_once(sort_rows_kernel, ready);
    if (e != cudaSuccess) return (int)e;
    // whole warps: the warp-barrier stages rely on every lane arriving
    int threads = P / 2;
    if (threads > CAUSE_SORT_THREADS) threads = CAUSE_SORT_THREADS;
    if (threads < 32) threads = 32;
    sort_rows_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        args, n_ops, num_keys, n, P, (int32_t*)scratch);
    return (int)cudaGetLastError();
}

}  // extern "C"
