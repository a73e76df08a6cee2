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
// millisecond at the wave's shapes. The bitonic network itself is
// log2(P) * (log2(P) + 1) / 2 compare-exchange stages (78 at P = 4096),
// so the kernel is bound by how fast a stage can exchange elements
// between threads (shared-memory traffic and barriers), not by bytes
// from HBM.
//
// What the design does about it, in both paths:
// - Only the keys and the position key run through the network; the
//   payloads are gathered once at the end by the final positions (the
//   Pallas kernel moves every operand at every stage).
//
// The register path (one or two keys, 256 <= P <= 4096: every v5 site)
// keeps each thread's 8 consecutive elements in registers. A stage whose
// partner distance j is below 8 swaps within a thread; below 256 it
// swaps with a lane of the same warp by shuffles; only the 10 stages
// with j >= 256 (at P = 4096) go through shared memory, with one padding
// word per 32 so a warp's strided accesses hit 32 distinct banks.
//
// The shared path (any other row) runs the network in shared memory,
// ending a stage that stays inside a warp's 64-element chunk with a warp
// barrier instead of a block barrier. A row whose keys do not fit the
// 227 KB a block may use runs it on a global-memory scratch row that the
// caller allocates; __syncthreads orders global writes within the block
// just as it does shared ones.
//
// Both networks live in bitonic.cuh, which the fused token kernels
// (befuse_k1/k2/k4.cu) include for their in-block sorts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

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

// ---------------------------------------------------------- register path

template <int NK>
__global__ void __launch_bounds__(CAUSE_SORT_REG_MAX / CAUSE_SORT_RE)
sort_rows_reg_kernel(SortArgs args, int n_ops, int n, int P) {
    extern __shared__ int32_t smem[];
    const int Pp = pad32(P);
    int32_t* s_key = smem;                 // NK columns of Pp
    int32_t* s_pos = smem + (size_t)NK * Pp;
    const size_t row_off = (size_t)blockIdx.x * (size_t)n;

    // coalesced load into shared, then each thread takes its 8 elements
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
#pragma unroll
        for (int q = 0; q < NK; ++q) {
            s_key[q * Pp + pad32(i)] =
                i < n ? args.in[q][row_off + i] : INT32_MAX;
        }
        s_pos[pad32(i)] = i;
    }
    __syncthreads();
    bitonic_reg_smem<NK>(s_key, s_pos, P);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int src = s_pos[pad32(i)];
#pragma unroll
        for (int q = 0; q < NK; ++q)
            args.out[q][row_off + i] = s_key[q * Pp + pad32(i)];
        for (int q = NK; q < n_ops; ++q)
            args.out[q][row_off + i] = args.in[q][row_off + src];
    }
}

template <int NK>
static cudaError_t launch_reg(const SortArgs& args, int n_ops, int B, int n,
                              int P, cudaStream_t stream) {
    const size_t smem = (size_t)(NK + 1) * (size_t)(P + (P >> 5)) *
                        sizeof(int32_t);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            sort_rows_reg_kernel<NK>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    sort_rows_reg_kernel<NK><<<B, P / CAUSE_SORT_RE, smem, stream>>>(
        args, n_ops, n, P);
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
    if (!scratch && num_keys <= 2 && P >= CAUSE_SORT_REG_MIN &&
        P <= CAUSE_SORT_REG_MAX) {
        return (int)(num_keys == 1
            ? launch_reg<1>(args, n_ops, B, n, P, (cudaStream_t)stream)
            : launch_reg<2>(args, n_ops, B, n, P, (cudaStream_t)stream));
    }
    const size_t bytes =
        (size_t)(num_keys + 1) * (size_t)P * sizeof(int32_t);
    size_t smem = scratch ? 0 : bytes;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            sort_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // whole warps: the warp-barrier stages rely on every lane arriving
    int threads = P / 2;
    if (threads > CAUSE_SORT_THREADS) threads = CAUSE_SORT_THREADS;
    if (threads < 32) threads = 32;
    sort_rows_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        args, n_ops, num_keys, n, P, (int32_t*)scratch);
    return (int)cudaGetLastError();
}

}  // extern "C"
