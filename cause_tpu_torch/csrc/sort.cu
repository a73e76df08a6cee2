// B1: stable lexicographic sort of int32 rows, in three forms.
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
// the passes' own traffic: (composite + position) read and written once
// a digit pass.
//
// The form is a static rule on (P = next_pow2(n), num_keys) in
// cause_sort_rows, written once for the callers in weaver/bitonic.py
// (`b1_form`) and mirrored here:
// - radix (one or two keys, 256 <= P <= 8192: every site of the wave,
//   and the doubled-budget retry), one CTA a row, radix.cuh: the keys are
//   range-compressed to the bits the row's data spans (at most 15 bits
//   for a lane or base key, so two 8-bit digit passes), packed into one
//   composite, and sorted by stable LSD passes that rank digits with warp
//   ballots and scatter through shared memory. Stability replaces the
//   position key. Only the keys (and positions) are sorted; each payload
//   is staged in shared memory once and gathered by final position (the
//   Pallas kernel moves every operand at every stage).
// - wide (P > 8192, or keys and positions too large for the 227 KB of
//   shared memory a block may use), radix_wide.cuh: the same stable LSD
//   radix idea over a row spread across (row, tile) CTAs, each digit pass
//   one launch through global memory (a tile's offsets from the row's
//   digit totals and a look-back over its earlier tiles), on scratch the
//   caller allocates (its size: wide_layout). The pass count follows the
//   data on the device; the host never reads it.
// - network (P < 256, or three or more keys up to 8192 that fit), one
//   CTA a row: bitonic_net from bitonic.cuh in shared memory, ending a
//   stage that stays inside a warp's 64-element chunk with a warp barrier
//   instead of a block barrier. Rows are padded to P inside the kernel
//   (keys INT32_MAX, positions n..P-1), so padding sorts after every real
//   element even when real keys equal INT32_MAX, and only the first n
//   outputs are written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"
#include "radix.cuh"
#include "radix_wide.cuh"
#include "smem_attrs.cuh"

#define CAUSE_SORT_MAX_OPS 9
#define CAUSE_SORT_THREADS 512

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

// -------------------------------------------------------------- wide form

template <typename KT, int IPT>
static cudaError_t launch_wide_scatter(const SortArgs& args,
                                       const WideBufs<KT>& w, int B, int n,
                                       int tiles, int g, int d,
                                       cudaStream_t st) {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    auto kernel = sort_rows_wide_scatter<KT, IPT, SortArgs>;
    const cudaError_t e = smem_attrs_once(kernel, ready);
    if (e != cudaSuccess) return e;
    kernel<<<(unsigned)(B * tiles), CAUSE_WIDE_THREADS,
             wide_scatter_smem(sizeof(KT), IPT * CAUSE_WIDE_THREADS), st>>>(
        args, w, B, n, tiles, g, d);
    return cudaGetLastError();
}

// Every launch of one wide sort: the zeroing of the digit totals and
// look-back words, ranges, plans, then per group its digit totals and the
// most digit passes a group may have (a pass beyond a row's plan returns
// at once), and the gather. No host sync.
template <typename KT>
static cudaError_t launch_wide(const SortArgs& args, int n_ops, int num_keys,
                               int B, int n, int tile, unsigned char* scratch,
                               cudaStream_t st) {
    const WideLayout L = wide_layout(B, n, num_keys, tile);
    const size_t elems = (size_t)B * (size_t)n;
    WideBufs<KT> w;
    w.comp[0] = (KT*)(scratch + L.comp);
    w.comp[1] = w.comp[0] + elems;
    w.pos[0] = (int32_t*)(scratch + L.pos);
    w.pos[1] = w.pos[0] + elems;
    w.ghist = (uint32_t*)(scratch + L.ghist);
    w.status = (uint32_t*)(scratch + L.status);
    w.counter = (uint32_t*)(scratch + L.counter);
    w.part = (int32_t*)(scratch + L.part);
    w.plan = (WidePlan*)(scratch + L.plan);
    const int tiles = wide_tiles(n, tile);
    const unsigned grid = (unsigned)(B * tiles);
    cudaError_t e = cudaMemsetAsync(scratch + L.ghist, 0, L.part - L.ghist, st);
    if (e != cudaSuccess) return e;
    sort_rows_wide_ranges<<<grid, CAUSE_WIDE_THREADS, 0, st>>>(
        args, num_keys, n, tile, tiles, w.part);
    sort_rows_wide_plan<<<B, 32, 0, st>>>(w.part, w.plan, num_keys, tiles,
                                          8 * (int)sizeof(KT));
    e = cudaGetLastError();
    for (int g = 0; g < wide_groups(num_keys) && e == cudaSuccess; ++g) {
        sort_rows_wide_digits<KT, SortArgs>
            <<<grid, CAUSE_WIDE_THREADS, 0, st>>>(args, w, B, n, tile, tiles,
                                                   g);
        e = cudaGetLastError();
        for (int d = 0; d < (int)sizeof(KT) && e == cudaSuccess; ++d)
#ifdef CAUSE_WIDE_TILE
            e = launch_wide_scatter<KT, CAUSE_WIDE_TILE / CAUSE_WIDE_THREADS>(
                args, w, B, n, tiles, g, d, st);
#else
            e = tile == 1024
                ? launch_wide_scatter<KT, 4>(args, w, B, n, tiles, g, d, st)
                : launch_wide_scatter<KT, 16>(args, w, B, n, tiles, g, d, st);
#endif
    }
    if (e != cudaSuccess) return e;
    sort_rows_wide_gather<KT, SortArgs>
        <<<(unsigned)(n_ops * B * tiles), CAUSE_WIDE_THREADS, 0, st>>>(
            args, w, B, n, tile, tiles);
    return cudaGetLastError();
}

// Lanes a CTA of the wide form for B rows of n lanes on the current
// card: 4096 once the rows' tiles of 4096 cover half the card's SMs,
// else 1024; 0 if the card cannot be asked. Timed at the main path's
// wide shapes (chip_smoke.py --tiles, H100): at 32 CTAs of 4096 or
// fewer, 1024 lanes took 2-29% less time than 4096; at 128 or more,
// 4096 took 15-31% less than 1024 and 2-12% less than 2048; 2048 beat
// the better of the two by at most 7% at the path's shapes. A build
// with -DCAUSE_WIDE_TILE=T (1024, 2048 or 4096) takes T everywhere:
// that is how --tiles times the widths against each other.
static int wide_tile(int B, int n) {
#ifdef CAUSE_WIDE_TILE
    static_assert(CAUSE_WIDE_TILE == 1024 || CAUSE_WIDE_TILE == 2048 ||
                      CAUSE_WIDE_TILE == 4096,
                  "a wide tile is 1024, 2048 or 4096 lanes");
    (void)B;
    (void)n;
    return CAUSE_WIDE_TILE;
#else
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
        return 0;
    return 2LL * B * wide_tiles(n, 4096) >= sms ? 4096 : 1024;
#endif
}

// The form rule of weaver/bitonic.py's b1_form.
enum SortForm { FORM_RADIX, FORM_WIDE, FORM_NETWORK };

static SortForm sort_form(int n, int num_keys, int smem_limit) {
    int P = 1;
    while (P < n) P <<= 1;
    if (num_keys <= 2 && P >= CAUSE_RADIX_MIN_P && P <= CAUSE_RADIX_MAX_P)
        return FORM_RADIX;
    if (P > CAUSE_RADIX_MAX_P ||
        (size_t)(num_keys + 1) * (size_t)P * sizeof(int32_t) > (size_t)smem_limit)
        return FORM_WIDE;
    return FORM_NETWORK;
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

// Bytes of scratch cause_sort_rows takes for B rows of n lanes and
// num_keys keys on the current card: wide_layout's total at the tile
// wide_tile picks when the form is wide, else 0 (also when the card
// cannot be asked).
size_t cause_sort_wide_scratch_bytes(int B, int n, int num_keys) {
    if (B < 0 || n < 0 || num_keys < 1 || num_keys > CAUSE_SORT_MAX_OPS ||
        sort_form(n, num_keys, cause_sort_smem_limit()) != FORM_WIDE)
        return 0;
    const int tile = wide_tile(B, n);
    return tile ? wide_layout(B, n, num_keys, tile).total : 0;
}

// Sort B rows of n int32 elements. `ins`/`outs` are host arrays of n_ops
// device pointers to [B, n] contiguous tensors; an output must not alias
// an input. The wide form (sort_form) takes `scratch`, a device buffer of
// exactly cause_sort_wide_scratch_bytes(B, n, num_keys) bytes
// (`scratch_bytes`); the other forms take no scratch. Returns the
// cudaError_t of the launches, cudaErrorInvalidValue for arguments that
// do not match the form.
int cause_sort_rows(void* const* ins, void* const* outs, int n_ops,
                    int num_keys, int B, int n, void* scratch,
                    size_t scratch_bytes, void* stream) {
    if (n_ops < 1 || n_ops > CAUSE_SORT_MAX_OPS || num_keys < 1 ||
        num_keys > n_ops || B < 0 || n < 0)
        return (int)cudaErrorInvalidValue;
    if (B == 0 || n == 0) return (int)cudaSuccess;
    const SortForm form = sort_form(n, num_keys, cause_sort_smem_limit());
    const bool wide = form == FORM_WIDE;
    const int tile = wide ? wide_tile(B, n) : 0;
    if (wide != (scratch != nullptr) ||
        scratch_bytes != cause_sort_wide_scratch_bytes(B, n, num_keys) ||
        (wide && (tile == 0 ||
                  (size_t)n_ops * B * wide_tiles(n, tile) > (size_t)INT32_MAX ||
                  n > (int)CAUSE_WIDE_COUNT)))
        return (int)cudaErrorInvalidValue;
    SortArgs args;
    for (int k = 0; k < CAUSE_SORT_MAX_OPS; ++k) {
        args.in[k] = k < n_ops ? (const int32_t*)ins[k] : nullptr;
        args.out[k] = k < n_ops ? (int32_t*)outs[k] : nullptr;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    int P = 1;
    while (P < n) P <<= 1;
    if (form == FORM_RADIX) {
        if (radix_ipt(P) == 8)
            return (int)(num_keys == 1
                ? launch_radix<1, 8>(args, n_ops, B, n, P, st)
                : launch_radix<2, 8>(args, n_ops, B, n, P, st));
        return (int)(num_keys == 1
            ? launch_radix<1, 16>(args, n_ops, B, n, P, st)
            : launch_radix<2, 16>(args, n_ops, B, n, P, st));
    }
    if (wide)
        return (int)(num_keys == 1
            ? launch_wide<uint32_t>(args, n_ops, num_keys, B, n, tile,
                                    (unsigned char*)scratch, st)
            : launch_wide<uint64_t>(args, n_ops, num_keys, B, n, tile,
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
