// B1: stable lexicographic sort of int32 rows, in four forms.
//
// Replaces the Pallas kernel of cause_tpu/weaver/pallas_sort.py
// (`_kernel_body`, launched by the pallas_call at :140 and :157 behind
// `pallas_bitonic_sort`, :176). Contract, bit for bit: ascending
// lexicographic order over the first `num_keys` operands, ties broken by
// the original position, the remaining operands riding as payloads.
//
// What bounds it on the H100: the HBM traffic is one read and one write
// of every operand (2 * n_ops * B * n * 4 bytes), a fraction of a
// millisecond at the wave's shapes. A comparison network cannot get near
// it: the bitonic network is log2(P) * (log2(P) + 1) / 2 compare-exchange
// stages (78 at P = 4096) whatever the keys hold, each bound by how fast
// elements move between threads. A sort spread over several CTAs adds
// the passes' own traffic.
//
// The form is decided by the caller alone, by the rule of
// weaver/bitonic.py (`b1_form`, with the cluster's CTA width), and passed
// in as a form code: this file holds no copy of the rule and asks the
// card nothing at a call.
// - radix (one or two keys, 256 <= P <= 8192: every site of the wave,
//   and the doubled-budget retry), one CTA a row, radix.cuh: the keys are
//   range-compressed to the bits the row's data spans (at most 15 bits
//   for a lane or base key, so two 8-bit digit passes), packed into one
//   composite, and sorted by stable LSD passes that rank digits with warp
//   ballots and scatter through shared memory. Stability replaces the
//   position key. Only the keys (and positions) are sorted; each payload
//   is staged in shared memory once and gathered by final position (the
//   Pallas kernel moves every operand at every stage).
// - network (P < 256, or three or more keys up to 8192 that fit), one
//   CTA a row: bitonic_net from bitonic.cuh in shared memory, ending a
//   stage that stays inside a warp's 64-element chunk with a warp barrier
//   instead of a block barrier. Rows are padded to P inside the kernel
//   (keys INT32_MAX, positions n..P-1), so padding sorts after every real
//   element even when real keys equal INT32_MAX, and only the first n
//   outputs are written.
// - cluster (every other row a cluster of up to 16 CTAs holds: 131,072
//   lanes on an H100), radix_cluster.cuh: the same stable LSD radix idea
//   over a row held in the distributed shared memory of a thread-block
//   cluster, one launch, no scratch.
// - wide (rows past the cluster's reach), radix_wide.cuh: the same idea
//   over a row spread across (row, tile) CTAs of 4096 lanes, each digit
//   pass one launch through global memory (a tile's offsets from the
//   row's digit totals and a look-back over its earlier tiles), on
//   scratch the caller allocates (its size: wide_layout). The pass count
//   follows the data on the device; the host never reads it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "radix.cuh"
#include "radix_cluster.cuh"
#include "radix_wide.cuh"
#include "smem_attrs.cuh"

#define CAUSE_SORT_MAX_OPS 9
#define CAUSE_SORT_THREADS 512
// the form codes of cause_sort_rows (weaver/bitonic.py: B1_FORMS)
#define CAUSE_SORT_FORM_RADIX 0
#define CAUSE_SORT_FORM_NETWORK 1
#define CAUSE_SORT_FORM_CLUSTER 2
#define CAUSE_SORT_FORM_WIDE 3

struct SortArgs {
    const int32_t* in[CAUSE_SORT_MAX_OPS];
    int32_t* out[CAUSE_SORT_MAX_OPS];
};

__global__ void sort_rows_kernel(SortArgs args, int n_ops, int num_keys,
                                 int n, int P) {
    extern __shared__ int32_t buf[];
    const int row = blockIdx.x;
    const size_t row_off = (size_t)row * (size_t)n;
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

// ----------------------------------------------------------- cluster form

// The cluster form's CTA of L lanes: `threads` threads of `ipt` items.
template <int L>
struct ClusterCta {
    static constexpr int threads =
        L == 4096 ? CAUSE_CLUSTER_NARROW_THREADS : CAUSE_CLUSTER_THREADS;
    static constexpr int ipt = L / threads;
};

template <typename KT, int L>
static void (*cluster_kernel())(SortArgs, int, int, int) {
    return sort_rows_cluster<KT, ClusterCta<L>::ipt, ClusterCta<L>::threads,
                             SortArgs>;
}

// The cluster kernel's attributes, once per device and process: the
// shared memory (smem_attrs_once) and clusters past the portable 8 CTAs.
template <typename KT, int L>
static cudaError_t cluster_attrs_once() {
    static std::atomic<bool> smem_ready[CAUSE_MAX_DEVICES];
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    auto kernel = cluster_kernel<KT, L>();
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < CAUSE_MAX_DEVICES && ready[dev].load(std::memory_order_acquire))
        return cudaSuccess;
    e = smem_attrs_once(kernel, smem_ready);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess && dev < CAUSE_MAX_DEVICES)
        ready[dev].store(true, std::memory_order_release);
    return e;
}

static void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& at,
                           int C, int B, int threads, size_t smem,
                           cudaStream_t st) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3((unsigned)(C * B), 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    at.id = cudaLaunchAttributeClusterDimension;
    at.val.clusterDim.x = (unsigned)C;
    at.val.clusterDim.y = 1;
    at.val.clusterDim.z = 1;
    cfg.attrs = &at;
    cfg.numAttrs = 1;
}

template <typename KT, int L>
static cudaError_t launch_cluster(const SortArgs& args, int n_ops,
                                  int num_keys, int B, int n,
                                  cudaStream_t st) {
    const cudaError_t e = cluster_attrs_once<KT, L>();
    if (e != cudaSuccess) return e;
    constexpr int threads = ClusterCta<L>::threads;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute at;
    cluster_config(cfg, at, (n + L - 1) / L, B, threads,
                   cluster_smem_bytes(sizeof(KT), L, threads), st);
    return cudaLaunchKernelEx(&cfg, cluster_kernel<KT, L>(), args, n_ops,
                              num_keys, n);
}

// The largest cluster of the cluster form at L lanes a CTA that the card
// co-schedules (cudaOccupancyMaxActiveClusters >= 1), the smaller of its
// two word widths; 0 if none.
template <int L>
static int cluster_reach() {
    constexpr int threads = ClusterCta<L>::threads;
    int best = CAUSE_CLUSTER_MAX;
    for (int wide = 0; wide < 2; ++wide) {
        const void* kernel = wide ? (const void*)cluster_kernel<uint64_t, L>()
                                  : (const void*)cluster_kernel<uint32_t, L>();
        if ((wide ? cluster_attrs_once<uint64_t, L>()
                  : cluster_attrs_once<uint32_t, L>()) != cudaSuccess) {
            cudaGetLastError();
            return 0;
        }
        int C = best;
        for (; C >= 1; --C) {
            cudaLaunchConfig_t cfg;
            cudaLaunchAttribute at;
            cluster_config(cfg, at, C, 1, threads,
                           cluster_smem_bytes(wide ? 8 : 4, L, threads), 0);
            int active = 0;
            if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) !=
                cudaSuccess) {
                cudaGetLastError();  // a refused size is not a launch error
                continue;
            }
            if (active >= 1) break;
        }
        best = C;
    }
    return best;
}

// -------------------------------------------------------------- wide form

template <typename KT>
static cudaError_t launch_wide_scatter(const SortArgs& args,
                                       const WideBufs<KT>& w, int B, int n,
                                       int tiles, int g, int d,
                                       cudaStream_t st) {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    auto kernel = sort_rows_wide_scatter<KT, SortArgs>;
    const cudaError_t e = smem_attrs_once(kernel, ready);
    if (e != cudaSuccess) return e;
    kernel<<<(unsigned)(B * tiles), CAUSE_WIDE_THREADS,
             wide_scatter_smem(sizeof(KT)), st>>>(args, w, B, n, tiles, g, d);
    return cudaGetLastError();
}

// Every launch of one wide sort: the zeroing of the digit totals,
// look-back words and counters, ranges and plans, then per group its
// digit totals and the most digit passes a group may have (a pass beyond
// a row's plan returns at once), and the gather. No host sync.
template <typename KT>
static cudaError_t launch_wide(const SortArgs& args, int n_ops, int num_keys,
                               int B, int n, unsigned char* scratch,
                               cudaStream_t st) {
    const WideLayout L = wide_layout(B, n, num_keys);
    const size_t elems = (size_t)B * (size_t)n;
    WideBufs<KT> w;
    w.comp[0] = (KT*)(scratch + L.comp);
    w.comp[1] = w.comp[0] + elems;
    w.pos[0] = (int32_t*)(scratch + L.pos);
    w.pos[1] = w.pos[0] + elems;
    w.ghist = (uint32_t*)(scratch + L.ghist);
    w.status = (uint32_t*)(scratch + L.status);
    w.counter = (uint32_t*)(scratch + L.counter);
    w.done = (uint32_t*)(scratch + L.done);
    w.part = (int32_t*)(scratch + L.part);
    w.plan = (WidePlan*)(scratch + L.plan);
    const int tiles = wide_tiles(n);
    const unsigned grid = (unsigned)(B * tiles);
    cudaError_t e = cudaMemsetAsync(scratch + L.ghist, 0, L.part - L.ghist, st);
    if (e != cudaSuccess) return e;
    sort_rows_wide_ranges<KT><<<grid, CAUSE_WIDE_THREADS, 0, st>>>(
        args, w, num_keys, n, tiles);
    e = cudaGetLastError();
    for (int g = 0; g < wide_groups(num_keys) && e == cudaSuccess; ++g) {
        sort_rows_wide_digits<KT, SortArgs>
            <<<grid, CAUSE_WIDE_THREADS, 0, st>>>(args, w, B, n, tiles, g);
        e = cudaGetLastError();
        for (int d = 0; d < (int)sizeof(KT) && e == cudaSuccess; ++d)
            e = launch_wide_scatter<KT>(args, w, B, n, tiles, g, d, st);
    }
    if (e != cudaSuccess) return e;
    sort_rows_wide_gather<KT, SortArgs>
        <<<(unsigned)(n_ops * B * tiles), CAUSE_WIDE_THREADS, 0, st>>>(
            args, w, num_keys, B, n, tiles);
    return cudaGetLastError();
}

extern "C" {

#ifdef CAUSE_CLUSTER_CLOCKS
// The cluster form's phase cycles since the last call (radix_cluster.cuh),
// into out[0..CAUSE_CLUSTER_PHASES - 1]; zeroes them.
int cause_cluster_cycles_take(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, cause_cluster_cycles,
                                         sizeof(cause_cluster_cycles));
    const unsigned long long zero[CAUSE_CLUSTER_PHASES] = {};
    if (e == cudaSuccess)
        e = cudaMemcpyToSymbol(cause_cluster_cycles, zero, sizeof(zero));
    return (int)e;
}
#endif

// The current card's reach of the cluster form, the input of
// weaver/bitonic.py's rule: into out[0..1] the largest cluster the card
// co-schedules at 4096 and at 8192 lanes a CTA (0: none). Called once
// per device (bitonic.b1_limits). Returns the cudaError_t of the
// device query.
int cause_sort_cluster_reach(int* out) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    out[0] = cluster_reach<4096>();
    out[1] = cluster_reach<8192>();
    return (int)cudaSuccess;
}

// Bytes of scratch the wide form takes for B rows of n lanes and
// num_keys keys (wide_layout's total); 0 for arguments it does not take.
size_t cause_sort_wide_scratch_bytes(int B, int n, int num_keys) {
    if (B < 1 || n < 1 || num_keys < 1 || num_keys > CAUSE_SORT_MAX_OPS)
        return 0;
    return wide_layout(B, n, num_keys).total;
}

// Sort B rows of n int32 elements. `ins`/`outs` are host arrays of n_ops
// device pointers to [B, n] contiguous tensors; an output must not alias
// an input. `form` is the form weaver/bitonic.py's b1_form picked (its
// CAUSE_SORT_FORM_* code): radix, network, cluster (`lanes` a CTA: 4096
// or 8192, ceil(n / lanes) CTAs a cluster) or wide (`scratch` a device
// buffer of exactly cause_sort_wide_scratch_bytes(B, n, num_keys) bytes,
// `scratch_bytes`). `lanes` is 0 for the other forms; only the wide form
// takes scratch. Returns the
// cudaError_t of the launches, cudaErrorInvalidValue for arguments the
// form does not take.
int cause_sort_rows(void* const* ins, void* const* outs, int n_ops,
                    int num_keys, int B, int n, int form, int lanes,
                    void* scratch, size_t scratch_bytes, void* stream) {
    if (n_ops < 1 || n_ops > CAUSE_SORT_MAX_OPS || num_keys < 1 ||
        num_keys > n_ops || B < 0 || n < 0 || form < CAUSE_SORT_FORM_RADIX ||
        form > CAUSE_SORT_FORM_WIDE)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || n == 0) return (int)cudaSuccess;
    int P = 1;
    while (P < n) P <<= 1;
    const bool wide = form == CAUSE_SORT_FORM_WIDE;
    if (wide != (scratch != nullptr) ||
        (form == CAUSE_SORT_FORM_RADIX &&
         (num_keys > 2 || P < CAUSE_RADIX_MIN_P || P > CAUSE_RADIX_MAX_P)) ||
        (form == CAUSE_SORT_FORM_NETWORK && P > CAUSE_RADIX_MAX_P) ||
        (form == CAUSE_SORT_FORM_CLUSTER &&
         ((lanes != 4096 && lanes != 8192) ||
                       (n + lanes - 1) / lanes > CAUSE_CLUSTER_MAX ||
                       (long long)B * ((n + lanes - 1) / lanes) > INT32_MAX)) ||
        (form != CAUSE_SORT_FORM_CLUSTER && lanes != 0) ||
        (wide && (scratch_bytes !=
                      cause_sort_wide_scratch_bytes(B, n, num_keys) ||
                  (size_t)n_ops * B * wide_tiles(n) > (size_t)INT32_MAX ||
                  n > (int)CAUSE_WIDE_COUNT)))
        return (int)cudaErrorInvalidValue;
    SortArgs args;
    for (int k = 0; k < CAUSE_SORT_MAX_OPS; ++k) {
        args.in[k] = k < n_ops ? (const int32_t*)ins[k] : nullptr;
        args.out[k] = k < n_ops ? (int32_t*)outs[k] : nullptr;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    if (form == CAUSE_SORT_FORM_RADIX) {
        if (radix_ipt(P) == 8)
            return (int)(num_keys == 1
                ? launch_radix<1, 8>(args, n_ops, B, n, P, st)
                : launch_radix<2, 8>(args, n_ops, B, n, P, st));
        return (int)(num_keys == 1
            ? launch_radix<1, 16>(args, n_ops, B, n, P, st)
            : launch_radix<2, 16>(args, n_ops, B, n, P, st));
    }
    if (form == CAUSE_SORT_FORM_CLUSTER) {
        if (lanes == 4096)
            return (int)(num_keys == 1
                ? launch_cluster<uint32_t, 4096>(args, n_ops, num_keys, B, n, st)
                : launch_cluster<uint64_t, 4096>(args, n_ops, num_keys, B, n,
                                                 st));
        return (int)(num_keys == 1
            ? launch_cluster<uint32_t, 8192>(args, n_ops, num_keys, B, n, st)
            : launch_cluster<uint64_t, 8192>(args, n_ops, num_keys, B, n, st));
    }
    if (wide)
        return (int)(num_keys == 1
            ? launch_wide<uint32_t>(args, n_ops, num_keys, B, n,
                                    (unsigned char*)scratch, st)
            : launch_wide<uint64_t>(args, n_ops, num_keys, B, n,
                                    (unsigned char*)scratch, st));
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    const cudaError_t e = smem_attrs_once(sort_rows_kernel, ready);
    if (e != cudaSuccess) return (int)e;
    // whole warps: the warp-barrier stages rely on every lane arriving
    int threads = P / 2;
    if (threads > CAUSE_SORT_THREADS) threads = CAUSE_SORT_THREADS;
    if (threads < 32) threads = 32;
    sort_rows_kernel<<<B, threads,
                       (size_t)(num_keys + 1) * (size_t)P * sizeof(int32_t),
                       st>>>(args, n_ops, num_keys, n, P);
    return (int)cudaGetLastError();
}

}  // extern "C"
