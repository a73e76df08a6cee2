// The cluster form of B1 (csrc/sort.cu): a stable LSD radix sort of one
// row held whole in the distributed shared memory of a thread-block
// cluster, in one launch. It sorts every row the radix and network forms
// do not take, up to the lanes a cluster holds: C CTAs of L lanes each
// (L = 4096 or 8192, C = ceil(n / L) up to 16 where the card co-schedules
// such a cluster; 131,072 lanes on an H100 at L = 8192), the rows of
// 8,193 to 131,072 lanes of the tree, the ladder and the older
// generations, and the nine-key rows of P <= 8192 that the network cannot
// hold in one block's shared memory.
//
// Replaces, with the other forms of sort.cu, the Pallas kernel of
// cause_tpu/weaver/pallas_sort.py (`_kernel_body`, launched by the
// pallas_call at :140 and :157 behind `pallas_bitonic_sort`, :176), which
// keeps a whole row in VMEM for the same reason. The contract is B1's.
//
// What bounds it on the H100: bytes, if nothing else did: each operand
// read once and each output written once. The wide form moves every lane
// through device memory twice a digit pass, in 8 launches or more; here a
// pass moves it between SMs over the cluster's shared-memory network and
// the row touches device memory (or L2) only to read its keys and
// payloads and to write the result. What is left is the cluster's
// barriers (two a pass) and the stores to other SMs' shared memory.
//
// The design, one CTA (IPT items a thread: 256 threads of 16 items for
// L = 4096, 512 of 16 for L = 8192) a slice of the row, rank r of the
// cluster holding the row's lanes [r * L, (r + 1) * L):
// - Ranges and plan. Each CTA reduces its slice's per-key minimum,
//   largest key below INT32_MAX and whether INT32_MAX occurs, in its own
//   shared memory. After a cluster barrier one warp reads every rank's
//   and computes the same plan as the wide form (radix_wide.cuh's
//   wide_range and wide_groups_of: codes, groups of at most 32 or 64
//   bits, the row position packed into the word where it fits). Nothing
//   goes to device memory.
// - A digit pass. Each CTA ranks its items by digit with radix.cuh's
//   warp-ballot multisplit and publishes its 256 digit counts in its own
//   shared memory. After a cluster barrier each CTA reads every rank's
//   counts: a digit's offset is the row's count of lower digits, plus
//   the count of that digit in lower-ranked CTAs, plus the item's rank
//   within its CTA. That is stable and integer-exact, with no atomics
//   across CTAs and no look-back. Each item (its word, and its int32
//   position where the word does not carry it) is then stored straight
//   into the owning CTA's shared memory (rank dst / L, slot dst % L);
//   every CTA holds its items in registers by then, so one buffer
//   serves. A second cluster barrier ends the pass. A row does exactly
//   its plan's passes: the loop runs on the device.
// - Later groups compose their words from the raw keys, gathered by
//   position (a row's operands are 32-512 KB, in L2).
// - The end. Every payload is gathered by final position and written out
//   coalesced; the last group's keys are decoded from the words (code +
//   min), not gathered.
// - One launch, no scratch, no memset, no host sync.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_wide.cuh"

// threads a CTA of 8,192 and of 4,096 lanes, 16 items a thread (4,096
// lanes as 512 threads of 8 items, one CTA an SM, was slower at 1,024
// rows on an H100)
#define CAUSE_CLUSTER_THREADS 512
#define CAUSE_CLUSTER_NARROW_THREADS 256
#define CAUSE_CLUSTER_MAX 16  // CTAs a cluster, past 8 non-portable

// Dynamic shared memory of a CTA of `lanes` lanes and `threads` threads
// with words of comp_bytes: words and positions, the per-warp digit
// counters (uint16), the CTA's digit counts (published to the cluster),
// its digit offsets, the row's digit totals, the CTA's own offsets, and
// the staging area (words and positions again).
__host__ __device__ inline size_t cluster_smem_bytes(int comp_bytes,
                                                     int lanes, int threads) {
    return 2 * (size_t)lanes * (comp_bytes + 4) +
           (size_t)(threads / 32) * CAUSE_WIDE_BINS * 2 +
           4 * CAUSE_WIDE_BINS * 4;
}

// A build with -DCAUSE_CLUSTER_CLOCKS adds thread 0's clock64() cycles
// between the marks below to one of CAUSE_CLUSTER_PHASES sums, read by
// cause_cluster_cycles_take (chip_smoke.py --tiles): ranges and plan,
// loads (and composes), ranking, counts, the first cluster barrier, the
// offsets, the stage and the stores, the second cluster barrier, the
// final gather. Without the flag the marks compile to nothing.
#define CAUSE_CLUSTER_PHASES 9
#ifdef CAUSE_CLUSTER_CLOCKS
__device__ unsigned long long cause_cluster_cycles[CAUSE_CLUSTER_PHASES];
#define CL_START long long cl_t0 = clock64();
#define CL_MARK(k)                                                        \
    do {                                                                  \
        if (threadIdx.x == 0) {                                           \
            const long long cl_t = clock64();                             \
            atomicAdd(&cause_cluster_cycles[k],                           \
                      (unsigned long long)(cl_t - cl_t0));                \
            cl_t0 = cl_t;                                                 \
        }                                                                 \
    } while (0)
#else
#define CL_START
#define CL_MARK(k) \
    do {           \
    } while (0)
#endif

// One row a cluster of C = gridDim.x / B CTAs (the launch's cluster
// dimension), row blockIdx.x / C, rank blockIdx.x % C, THREADS threads
// of IPT items a CTA. KT is the word: uint32 for one key, uint64 for
// more. The launch bounds allow 128 registers a thread.
template <typename KT, int IPT, int THREADS, class Args>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
sort_rows_cluster(Args a, int n_ops, int num_keys, int n) {
    static_assert(THREADS >= CAUSE_WIDE_BINS, "a thread a digit");
    namespace cg = cooperative_groups;
    constexpr int WARPS = THREADS / 32;
    constexpr int L = IPT * THREADS;
    constexpr int BINS = CAUSE_WIDE_BINS;
    extern __shared__ __align__(16) unsigned char cluster_smem[];
    __shared__ int32_t s_red[WARPS][3];
    __shared__ int32_t s_rng[CAUSE_WIDE_MAX_KEYS * 3];
    __shared__ WidePlan s_plan;
    CL_START
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t lanes_below = (1u << lane) - 1u;
    const size_t off = (size_t)(blockIdx.x / C) * (size_t)n;
    const int t0 = r * L, valid = min(L, n - t0);
    KT* s_w = (KT*)cluster_smem;
    int32_t* s_p = (int32_t*)(s_w + L);
    uint16_t* s_hist = (uint16_t*)(s_p + L);
    uint32_t* s_cnt = (uint32_t*)(s_hist + WARPS * BINS);
    uint32_t* s_off = s_cnt + BINS;
    uint32_t* s_tot = s_off + BINS;
    uint32_t* s_loc = s_tot + BINS;
    KT* t_w = (KT*)(s_loc + BINS);  // the staging area (8-byte aligned)
    int32_t* t_p = (int32_t*)(t_w + L);
    uint16_t* hist = s_hist + warp * BINS;

    // ranges: this slice's, then the row's from every rank's
    wide_block_ranges<Args, WARPS, IPT>(a, num_keys, off + t0, valid, s_red,
                                        s_rng);
    cluster.sync();
    if (warp == 0) {  // lane rr reads rank rr's ranges (C <= 16 < 32)
        WidePlan pl;
        for (int q = 0; q < num_keys; ++q) {
            int32_t mn = INT32_MAX, mx = INT32_MIN;
            int any_max = 0;
            if (lane < C) {
                const int32_t* x = cluster.map_shared_rank(s_rng, lane) + q * 3;
                mn = x[0];
                mx = x[1];
                any_max = x[2];
            }
            mn = __reduce_min_sync(0xffffffffu, mn);
            mx = __reduce_max_sync(0xffffffffu, mx);
            any_max = __any_sync(0xffffffffu, any_max);
            wide_range(pl, q, mn, mx, any_max);
        }
        if (lane == 0) {
            wide_groups_of(pl, num_keys, 8 * (int)sizeof(KT), n);
            s_plan = pl;
        }
    }
    cluster.sync();  // every rank has read every rank's ranges
    CL_MARK(0);
    const WidePlan& pl = s_plan;

    KT c[IPT];
    int32_t p[IPT];
    uint32_t rank[IPT];
    for (int g = 0; g < pl.ngroups; ++g) {
        const bool packed = pl.packed[g];
        for (int d = 0; d < pl.passes[g]; ++d) {
            const int bit = wide_shift(pl, g) + 8 * d;
            // this CTA's items, warp-striped: thread (w, l) holds slots
            // (w * IPT + i) * 32 + l, so (warp, item, lane) is slot order
            if (d > 0) {
#pragma unroll
                for (int i = 0; i < IPT; ++i) {
                    const int e = (warp * IPT + i) * 32 + lane;
                    c[i] = e < valid ? s_w[e] : (KT)0;
                    p[i] = e < valid && !packed ? s_p[e] : 0;
                }
            } else {
#pragma unroll
                for (int i = 0; i < IPT; ++i) {
                    const int e = (warp * IPT + i) * 32 + lane;
                    p[i] = e >= valid ? 0
                           : g == 0   ? t0 + e
                           : pl.packed[g - 1] ? wide_word_pos(s_w[e], pl.pbits)
                                              : s_p[e];
                }
                wide_compose<KT, IPT>(a, pl, g, off, p, c);
            }
            CL_MARK(1);
            for (int b = lane; b < BINS / 2; b += 32)
                ((uint32_t*)hist)[b] = 0;
            __syncwarp();
            // rank of each item among the warp's items of its digit that
            // come before it; slots past the row rank last, under 255
#pragma unroll
            for (int i = 0; i < IPT; ++i) {
                const uint32_t dd = (warp * IPT + i) * 32 + lane < valid
                                        ? wide_digit(c[i], bit) : 255u;
                uint32_t peers = 0xffffffffu;
#pragma unroll
                for (int b = 0; b < 8; ++b) {
                    const bool on = (dd >> b) & 1u;
                    const uint32_t v = __ballot_sync(0xffffffffu, on);
                    peers &= on ? v : ~v;
                }
                const int leader = 31 - __clz(peers);
                uint32_t cnt = 0;
                if (lane == leader) {
                    cnt = hist[dd];
                    hist[dd] = (uint16_t)(cnt + __popc(peers));
                }
                rank[i] = __shfl_sync(0xffffffffu, cnt, leader) +
                          __popc(peers & lanes_below);
                __syncwarp();
            }
            __syncthreads();
            CL_MARK(2);
            // per digit: each warp's count becomes the count of the warps
            // before it; the CTA's count is published to the cluster
            if (threadIdx.x < BINS) {
                const int b = threadIdx.x;
                uint32_t cnt = 0;
                for (int v = 0; v < WARPS; ++v) {
                    const uint32_t k = s_hist[v * BINS + b];
                    s_hist[v * BINS + b] = (uint16_t)cnt;
                    cnt += k;
                }
                s_cnt[b] = cnt;
            }
            CL_MARK(3);
            cluster.sync();  // every rank's counts; every item in registers
            CL_MARK(4);
            if (threadIdx.x < BINS) {
                const int b = threadIdx.x;
                uint32_t v[CAUSE_CLUSTER_MAX];  // every rank's, loads in flight
#pragma unroll
                for (int rr = 0; rr < CAUSE_CLUSTER_MAX; ++rr)
                    v[rr] = rr < C ? cluster.map_shared_rank(s_cnt, rr)[b] : 0u;
                uint32_t tot = 0, below = 0;
#pragma unroll
                for (int rr = 0; rr < CAUSE_CLUSTER_MAX; ++rr) {
                    tot += v[rr];
                    below += rr < r ? v[rr] : 0u;
                }
                s_tot[b] = tot;
                s_off[b] = below;
                s_loc[b] = s_cnt[b];
            }
            __syncthreads();
            if (warp == 0) wide_scan256(s_tot, lane);  // the row's offsets
            if (warp == 1) wide_scan256(s_loc, lane);  // this CTA's offsets
            __syncthreads();
            CL_MARK(5);
            // staged in this CTA's sorted order (slots past the row land
            // past its items), then written out in that order: consecutive
            // threads store consecutive slots of a digit's run in its
            // owner's shared memory
            if (threadIdx.x < BINS)
                s_off[threadIdx.x] +=
                    s_tot[threadIdx.x] - s_loc[threadIdx.x];
#pragma unroll
            for (int i = 0; i < IPT; ++i) {
                const uint32_t dd = (warp * IPT + i) * 32 + lane < valid
                                        ? wide_digit(c[i], bit) : 255u;
                const uint32_t st =
                    s_loc[dd] + s_hist[warp * BINS + dd] + rank[i];
                t_w[st] = c[i];
                if (!packed) t_p[st] = p[i];
            }
            __syncthreads();
            for (int e = threadIdx.x; e < valid; e += THREADS) {
                const KT w = t_w[e];
                const uint32_t dst = s_off[wide_digit(w, bit)] + (uint32_t)e;
                const int owner = (int)(dst / L), slot = (int)(dst % L);
                cluster.map_shared_rank(s_w, owner)[slot] = w;
                if (!packed) cluster.map_shared_rank(s_p, owner)[slot] = t_p[e];
            }
            CL_MARK(6);
            cluster.sync();  // every item is in place
            CL_MARK(7);
        }
    }

    // the sorted row: lane t0 + e of the row is this CTA's slot e; a
    // thread's IPT slots' positions first, then each operand's IPT loads
    // in flight together
    const int g = wide_last_group(pl);
    const bool packed = pl.packed[g];
    int32_t src[IPT];
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
        const int e = threadIdx.x + j * THREADS;
        src[j] = e >= valid       ? 0
                 : pl.total == 0 ? t0 + e
                 : packed        ? wide_word_pos(s_w[e], pl.pbits)
                                 : s_p[e];
    }
    for (int k = 0; k < n_ops; ++k) {
        const int kind = wide_out_kind(pl, k, num_keys);
        const int32_t* in = a.in[k] + off;
        int32_t* out = a.out[k] + off + t0;
        int32_t v[IPT];
#pragma unroll
        for (int j = 0; j < IPT; ++j) {
            const int e = threadIdx.x + j * THREADS;
            v[j] = kind == 0   ? in[src[j]]
                   : kind == 1 ? wide_key_of(pl, g, k, s_w[e < valid ? e : 0])
                               : wide_decode(0u, pl.mn[k], pl.mx1[k]);
        }
#pragma unroll
        for (int j = 0; j < IPT; ++j) {
            const int e = threadIdx.x + j * THREADS;
            if (e < valid) out[e] = v[j];
        }
    }
    CL_MARK(8);
}
