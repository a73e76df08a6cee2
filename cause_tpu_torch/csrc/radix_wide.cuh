// The wide form of B1 (csrc/sort.cu): a stable LSD radix sort of rows
// spread over several CTAs, with passes through global memory. It sorts
// every row past 8,192 lanes (P = next_pow2(n) > 8192) and every row
// whose keys and positions would not fit the 227 KB of shared memory a
// block may use, in place of the bitonic network on a global scratch row
// (one CTA a row, log2 P (log2 P + 1) / 2 block-wide stages: 153 at
// P = 131,072, each a round trip through memory).
//
// Replaces, with the other two forms of sort.cu, the Pallas kernel of
// cause_tpu/weaver/pallas_sort.py (`_kernel_body`, launched by the
// pallas_call at :140 and :157 behind `pallas_bitonic_sort`, :176). The
// contract is B1's: ascending lexicographic order over the first
// `num_keys` operands, ties broken by the original position, the other
// operands riding as payloads.
//
// What bounds it on the H100: bytes. A digit pass reads the composite
// and the position of every element once and writes them once; a group
// of keys reads its keys once more to count its digits; the last launch
// reads every operand once (a gather by position) and writes every
// output once. At the v1 sort-join's rows (1,024 x 40,960, two keys:
// 8-byte composites) a pass moves 42M x 24 bytes = 1.0 GB, 0.3 ms at
// 3.35 TB/s.
//
// What the design does about it:
// - Ranges, on the device. Per key, a launch reduces each tile's min and
//   max and a second reduces the tiles of each row, so a key's code is
//   k - min (uint32, monotone and exact over the whole int32 range,
//   INT32_MAX included; no padding to P) and its bit length is that of
//   max - min. A row of equal keys has a key of no bits.
// - The codes of consecutive keys pack into one composite, least
//   significant key last, greedily from the last key while the bits fit
//   (32 for one key, 64 otherwise): a group. Groups sort least
//   significant first, each by ceil(bits / 8) stable 8-bit digit passes,
//   so most rows need one group and a few passes. The plan is per row
//   and lives on the device: the host never reads it back.
// - At a group's start one launch counts, per row, the digits of its
//   first pass; each pass counts the next one's as it writes its items
//   out (the totals do not depend on the order).
// - Each pass is then one launch over (row, tile) CTAs of T lanes
//   (T = 4096 where the rows have tiles enough, 1024 for a few rows:
//   sort.cu's wide_tile). A CTA takes its tile from a counter
//   in launch order, ranks its items stably (the warp-ballot multisplit
//   of radix.cuh, with int32 positions), publishes its digit counts, and
//   sums the counts of the row's earlier tiles by a decoupled look-back;
//   a digit's offset is the row's count of the digits below it plus the
//   earlier tiles' count of it, which is what makes the pass stable. It
//   stages its items in shared memory in sorted order and writes them
//   out coalesced. The counts are integers: the result does not depend
//   on the order the CTAs run in.
// - Only the composite and the int32 row position travel through the
//   passes. The first pass of a group composes its composite from the
//   raw keys (the row's own order for the first group, gathered by
//   position for a later one); the last launch gathers every operand,
//   keys included, by final position.
// - No host sync. The host launches the most passes the key count
//   allows (groups <= ceil(num_keys / 2), 4 passes a 32-bit group, 8 a
//   64-bit one); a pass beyond its row's plan returns at once. Pass p
//   (counted over the row's active passes) reads buffer p % 2 and writes
//   buffer (p + 1) % 2, so the final gather reads the positions of
//   buffer total % 2, or the identity when the row needed no pass.
//
// Scratch, allocated by the caller (wide_layout): two composite and two
// position buffers of B * n elements, the digit totals, one look-back
// word a (pass, row, tile, digit), the tile counters, the per-tile ranges
// and the per-row plans. At the largest row set, the v1 sort-join's
// 1,024 x 40,960 with two keys, that is 2 x 42M x (8 + 4) bytes =
// 1.01 GB of double buffers and 84 MB of look-back words (T = 4096).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CAUSE_WIDE_THREADS 256
#define CAUSE_WIDE_WARPS (CAUSE_WIDE_THREADS / 32)
#define CAUSE_WIDE_BINS 256
#define CAUSE_WIDE_MAX_KEYS 9
#define CAUSE_WIDE_MAX_GROUPS 5   // ceil(9 / 2): any two keys fit 64 bits
#define CAUSE_WIDE_ALIGN 256

// a scatter CTA handles one digit a thread
static_assert(CAUSE_WIDE_THREADS == CAUSE_WIDE_BINS, "one digit a thread");

// One row's plan: per key its minimum and bit length, per group (least
// significant first) its keys first..last, its passes and the passes of
// the groups before it, and the row's passes in all.
struct WidePlan {
    int32_t mn[CAUSE_WIDE_MAX_KEYS];
    int32_t bits[CAUSE_WIDE_MAX_KEYS];
    int32_t first[CAUSE_WIDE_MAX_GROUPS];
    int32_t last[CAUSE_WIDE_MAX_GROUPS];
    int32_t passes[CAUSE_WIDE_MAX_GROUPS];
    int32_t base[CAUSE_WIDE_MAX_GROUPS];
    int32_t ngroups;
    int32_t total;
};

static inline size_t wide_align(size_t b) {
    return (b + CAUSE_WIDE_ALIGN - 1) / CAUSE_WIDE_ALIGN * CAUSE_WIDE_ALIGN;
}

static inline int wide_tiles(int n, int tile) { return (n + tile - 1) / tile; }

// Bytes of composite a key count sorts with.
static inline int wide_comp_bytes(int num_keys) { return num_keys == 1 ? 4 : 8; }

// Groups the host launches for num_keys keys (the most a plan can have)
// and digit passes a group.
static inline int wide_groups(int num_keys) {
    return num_keys == 1 ? 1 : (num_keys + 1) / 2;
}

// The scratch regions, in order, each aligned: composites x 2, positions
// x 2; then the region zeroed at the start of every sort: the digit
// totals (uint32 [groups][B][digits][256]), the look-back words (uint32
// [groups * digits][B][tiles][256]) and the tile counters (uint32
// [groups * digits]); then the tile ranges (int32 [B][tiles][num_keys]
// [2]) and the plans ([B] WidePlan).
struct WideLayout {
    size_t comp, pos, ghist, status, counter, part, plan, total;
};

static inline WideLayout wide_layout(int B, int n, int num_keys, int tile) {
    const size_t elems = (size_t)B * (size_t)n;
    const size_t tiles = (size_t)wide_tiles(n, tile);
    const size_t cb = wide_comp_bytes(num_keys);
    const size_t slots = (size_t)wide_groups(num_keys) * cb;
    WideLayout L;
    L.comp = 0;
    L.pos = L.comp + wide_align(2 * elems * cb);
    L.ghist = L.pos + wide_align(2 * elems * 4);
    L.status = L.ghist + wide_align(slots * B * CAUSE_WIDE_BINS * 4);
    L.counter = L.status + wide_align(slots * B * tiles * CAUSE_WIDE_BINS * 4);
    L.part = L.counter + wide_align(slots * 4);
    L.plan = L.part + wide_align((size_t)B * tiles * num_keys * 2 * 4);
    L.total = L.plan + wide_align((size_t)B * sizeof(WidePlan));
    return L;
}

// The scratch regions, typed.
template <typename KT>
struct WideBufs {
    KT* comp[2];
    int32_t* pos[2];
    uint32_t* ghist;
    uint32_t* status;
    uint32_t* counter;
    int32_t* part;
    WidePlan* plan;
};

// ------------------------------------------------------------- ranges

// Each (row, tile) CTA: per key, the min and max over its lanes.
template <class Args>
__global__ void __launch_bounds__(CAUSE_WIDE_THREADS)
sort_rows_wide_ranges(Args a, int num_keys, int n, int tile, int tiles,
                      int32_t* part) {
    __shared__ int32_t s_red[CAUSE_WIDE_WARPS][2];
    const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t off = (size_t)row * n + (size_t)t * tile;
    const int valid = min(tile, n - t * tile);
    for (int q = 0; q < num_keys; ++q) {
        int32_t mn = INT32_MAX, mx = INT32_MIN;
        for (int e = threadIdx.x; e < valid; e += CAUSE_WIDE_THREADS) {
            const int32_t v = a.in[q][off + e];
            mn = min(mn, v);
            mx = max(mx, v);
        }
        mn = __reduce_min_sync(0xffffffffu, mn);
        mx = __reduce_max_sync(0xffffffffu, mx);
        if (lane == 0) {
            s_red[warp][0] = mn;
            s_red[warp][1] = mx;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int w = 1; w < CAUSE_WIDE_WARPS; ++w) {
                mn = min(mn, s_red[w][0]);
                mx = max(mx, s_red[w][1]);
            }
            int32_t* p = part + (((size_t)row * tiles + t) * num_keys + q) * 2;
            p[0] = mn;
            p[1] = mx;
        }
        __syncthreads();
    }
}

// One warp a row: reduce the tiles' ranges, then lane 0 plans the row:
// per key its bits, the greedy groups (each at most `limit` bits) and
// their passes.
__global__ void sort_rows_wide_plan(const int32_t* part, WidePlan* plan,
                                    int num_keys, int tiles, int limit) {
    const int row = blockIdx.x, lane = threadIdx.x;
    WidePlan pl;
    for (int q = 0; q < num_keys; ++q) {
        int32_t mn = INT32_MAX, mx = INT32_MIN;
        for (int t = lane; t < tiles; t += 32) {
            const int32_t* p = part + (((size_t)row * tiles + t) * num_keys + q) * 2;
            mn = min(mn, p[0]);
            mx = max(mx, p[1]);
        }
        mn = __reduce_min_sync(0xffffffffu, mn);
        mx = __reduce_max_sync(0xffffffffu, mx);
        const uint32_t top = (uint32_t)mx - (uint32_t)mn;
        pl.mn[q] = mn;
        pl.bits[q] = top ? 32 - __clz(top) : 0;
    }
    if (lane != 0) return;
    int g = 0, total = 0;
    for (int q = num_keys - 1; q >= 0; ++g) {
        pl.last[g] = q;
        int bits = 0;
        while (q >= 0 && bits + pl.bits[q] <= limit) bits += pl.bits[q--];
        pl.first[g] = q + 1;
        pl.passes[g] = (bits + 7) / 8;
        pl.base[g] = total;
        total += pl.passes[g];
    }
    pl.ngroups = g;
    pl.total = total;
    plan[row] = pl;
}

// ------------------------------------------------------------- a pass

// Pass d of group g of a row: active, and if so which passes of the row
// came before it (its buffer parity) and whether it composes.
struct WidePass {
    int pb;        // the row's active passes before this one
    bool compose;  // the group's first pass: composite from the keys
};

__device__ __forceinline__ bool wide_pass(const WidePlan* pl, int g, int d,
                                          WidePass& io) {
    if (g >= pl->ngroups || d >= pl->passes[g]) return false;
    io.pb = pl->base[g] + d;
    io.compose = d == 0;
    return true;
}

// Item i of the row (row offset off) as pass io sees it: composite c and
// row position p.
template <typename KT, class Args>
__device__ __forceinline__ void wide_item(const Args& a, const WideBufs<KT>& w,
                                          const WidePlan* pl, int g,
                                          const WidePass& io, size_t off,
                                          int i, KT& c, int32_t& p) {
    const int par = io.pb & 1;
    if (!io.compose) {
        c = w.comp[par][off + i];
        p = w.pos[par][off + i];
        return;
    }
    p = io.pb == 0 ? i : w.pos[par][off + i];
    uint64_t x = 0;
    for (int q = pl->first[g]; q <= pl->last[g]; ++q)
        x = (x << pl->bits[q]) |
            ((uint32_t)a.in[q][off + p] - (uint32_t)pl->mn[q]);
    c = (KT)x;
}

template <typename KT>
__device__ __forceinline__ uint32_t wide_digit(KT c, int d) {
    return (uint32_t)(c >> (8 * d)) & 255u;
}

// The row's digit totals of the first pass of group g, counted from the
// composites at the group's start: ghist[g][row][0][digit]. Each pass
// counts the next one's as it writes its items out.
template <typename KT, class Args>
__global__ void __launch_bounds__(CAUSE_WIDE_THREADS)
sort_rows_wide_digits(Args a, WideBufs<KT> w, int B, int n, int tile,
                      int tiles, int g) {
    __shared__ uint32_t s_cnt[CAUSE_WIDE_BINS];
    const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
    const WidePlan* pl = w.plan + row;
    WidePass io;
    if (!wide_pass(pl, g, 0, io)) return;
    const int lane = threadIdx.x & 31;
    const size_t off = (size_t)row * n;
    const int t0 = t * tile, valid = min(tile, n - t0);
    s_cnt[threadIdx.x] = 0;  // CAUSE_WIDE_THREADS == CAUSE_WIDE_BINS
    __syncthreads();
    for (int e0 = 0; e0 < valid; e0 += CAUSE_WIDE_THREADS) {
        const int e = e0 + threadIdx.x;
        uint32_t dg = CAUSE_WIDE_BINS;  // past the row: counted nowhere
        if (e < valid) {
            KT c;
            int32_t p;
            wide_item(a, w, pl, g, io, off, t0 + e, c, p);
            dg = wide_digit(c, 0);
        }
        // one shared add a digit a warp
        const uint32_t peers = __match_any_sync(0xffffffffu, dg);
        if (dg < CAUSE_WIDE_BINS && lane == __ffs(peers) - 1)
            atomicAdd(&s_cnt[dg], (uint32_t)__popc(peers));
    }
    __syncthreads();
    const uint32_t v = s_cnt[threadIdx.x];
    if (v)
        atomicAdd(w.ghist + ((size_t)g * B + row) * sizeof(KT) * CAUSE_WIDE_BINS +
                      threadIdx.x,
                  v);
}

// Exclusive scan of 256 counters in shared memory, one warp, 8 a lane.
__device__ __forceinline__ void wide_scan256(uint32_t* s, int lane) {
    uint32_t v[8];
    uint32_t run = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        v[e] = s[lane * 8 + e];
        run += v[e];
    }
    uint32_t incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
    }
    uint32_t ex = incl - run;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        s[lane * 8 + e] = ex;
        ex += v[e];
    }
}

// A tile's look-back word of one digit: a flag in the top two bits
// (0: not yet, AGG: this tile's count, PRE: the count of this tile and
// every earlier one) and the count below.
#define CAUSE_WIDE_AGG (1u << 30)
#define CAUSE_WIDE_PRE (2u << 30)
#define CAUSE_WIDE_COUNT (CAUSE_WIDE_AGG - 1u)
#define CAUSE_WIDE_SPINS (1 << 24)

// The count of digit b in the row's tiles before tile t: walk back over
// the earlier tiles' words, adding counts, until one holds a prefix.
// Every earlier tile's CTA took its id first, so it runs and publishes;
// a wait past CAUSE_WIDE_SPINS polls traps rather than hangs.
__device__ __forceinline__ uint32_t wide_look_back(const uint32_t* words,
                                                   int t, int b) {
    uint32_t excl = 0;
    int spins = 0;
    for (int u = t - 1; u >= 0;) {
        const uint32_t v =
            *(const volatile uint32_t*)(words + (size_t)u * CAUSE_WIDE_BINS + b);
        if (v == 0) {
            if (++spins > CAUSE_WIDE_SPINS) __trap();
            continue;
        }
        excl += v & CAUSE_WIDE_COUNT;
        if (v & CAUSE_WIDE_PRE) break;
        --u;
    }
    return excl;
}

// Shared memory of a scatter CTA: the tile's composites and positions in
// local sorted order, the per-warp digit counters, the tile's digit
// offsets, the row's digit offsets, the earlier tiles' counts and the
// tile's counts of the next pass's digits.
__host__ __device__ inline size_t wide_scatter_smem(int comp_bytes, int tile) {
    return (size_t)tile * (comp_bytes + 4) +
           (size_t)CAUSE_WIDE_WARPS * CAUSE_WIDE_BINS * 2 +
           4 * CAUSE_WIDE_BINS * 4;
}

// Pass d of group g, one launch: rank the tile's items stably by digit,
// find each digit's global offset, stage the items in shared memory in
// that order and write each to its offset: the offset of its digit in
// the row, plus the count of its digit in the row's earlier tiles (a
// decoupled look-back: tiles take their ids in launch order from a
// counter, publish their own counts at once and their prefixes after),
// plus its index among the tile's items of that digit. As it writes them
// out it counts their digits of the group's next pass into the row's
// totals for that pass.
// Items are warp-striped, IPT a thread: thread (warp w, lane l) holds
// lanes (w * IPT + i) * 32 + l of the tile, so the order (warp, item,
// lane) is the tile's order. Lanes past the row's end take digit 255 and
// rank after every real item, so they land past the tile's real items
// and are never written.
template <typename KT, int IPT, class Args>
__global__ void __launch_bounds__(CAUSE_WIDE_THREADS)
sort_rows_wide_scatter(Args a, WideBufs<KT> w, int B, int n, int tiles,
                       int g, int d) {
    extern __shared__ __align__(16) unsigned char wide_smem[];
    __shared__ int s_id;
    constexpr int tile = IPT * CAUSE_WIDE_THREADS;
    const int slot = g * (int)sizeof(KT) + d;
    if (threadIdx.x == 0) s_id = atomicAdd(w.counter + slot, 1);
    __syncthreads();
    const int row = s_id / tiles, t = s_id % tiles;
    const WidePlan* pl = w.plan + row;
    WidePass io;
    if (!wide_pass(pl, g, d, io)) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t lanes_below = (1u << lane) - 1u;
    const size_t off = (size_t)row * n;
    const int t0 = t * tile, valid = min(tile, n - t0);
    KT* s_c = (KT*)wide_smem;
    int32_t* s_p = (int32_t*)(s_c + tile);
    uint16_t* s_hist = (uint16_t*)(s_p + tile);
    uint32_t* s_loc = (uint32_t*)(s_hist + CAUSE_WIDE_WARPS * CAUSE_WIDE_BINS);
    uint32_t* s_dex = s_loc + CAUSE_WIDE_BINS;
    uint32_t* s_prev = s_dex + CAUSE_WIDE_BINS;
    uint32_t* s_next = s_prev + CAUSE_WIDE_BINS;
    uint16_t* hist = s_hist + warp * CAUSE_WIDE_BINS;
    const bool next = d + 1 < pl->passes[g];
    s_next[threadIdx.x] = 0;  // CAUSE_WIDE_THREADS == CAUSE_WIDE_BINS

    KT c[IPT];
    int32_t p[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int e = (warp * IPT + i) * 32 + lane;
        c[i] = 0;
        p[i] = 0;
        if (e < valid) wide_item(a, w, pl, g, io, off, t0 + e, c[i], p[i]);
    }
    // item i's digit, recomputed where needed (registers are the limit)
    auto digit = [&](int i) {
        return (warp * IPT + i) * 32 + lane < valid ? wide_digit(c[i], d)
                                                     : 255u;
    };
    for (int b = lane; b < CAUSE_WIDE_BINS / 2; b += 32)
        ((uint32_t*)hist)[b] = 0;
    __syncwarp();

    // rank of each item among the warp's items of the same digit that
    // come before it (earlier item, or same item, lower lane)
    uint32_t rank[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const uint32_t dd = digit(i);
        uint32_t peers = 0xffffffffu;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            const bool bit = (dd >> b) & 1u;
            const uint32_t v = __ballot_sync(0xffffffffu, bit);
            peers &= bit ? v : ~v;
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

    // per digit (one a thread): each warp's count becomes the count of
    // the warps before it; the tile's count is published for the later
    // tiles, the row's count is read
    const int b = threadIdx.x;  // CAUSE_WIDE_THREADS == CAUSE_WIDE_BINS
    uint32_t* words = w.status + ((size_t)slot * B + row) * tiles * CAUSE_WIDE_BINS;
    uint32_t cnt = 0;
    for (int v = 0; v < CAUSE_WIDE_WARPS; ++v) {
        const uint32_t k = s_hist[v * CAUSE_WIDE_BINS + b];
        s_hist[v * CAUSE_WIDE_BINS + b] = (uint16_t)cnt;
        cnt += k;
    }
    atomicExch(words + (size_t)t * CAUSE_WIDE_BINS + b,
               (t == 0 ? CAUSE_WIDE_PRE : CAUSE_WIDE_AGG) | cnt);
    s_loc[b] = cnt;
    s_dex[b] = w.ghist[(((size_t)g * B + row) * sizeof(KT) + d) *
                       CAUSE_WIDE_BINS + b];
    __syncthreads();
    if (warp == 0) wide_scan256(s_loc, lane);  // the tile's digit offsets
    if (warp == 1) wide_scan256(s_dex, lane);  // the row's digit offsets
    const uint32_t prev = wide_look_back(words, t, b);
    if (t > 0)
        atomicExch(words + (size_t)t * CAUSE_WIDE_BINS + b,
                   CAUSE_WIDE_PRE | (prev + cnt));
    s_prev[b] = prev;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const uint32_t dd = digit(i);
        const uint32_t s =
            s_loc[dd] + s_hist[warp * CAUSE_WIDE_BINS + dd] + rank[i];
        s_c[s] = c[i];
        s_p[s] = p[i];
    }
    __syncthreads();

    // coalesced: consecutive threads, consecutive offsets within a digit
    KT* out_c = w.comp[(io.pb + 1) & 1] + off;
    int32_t* out_p = w.pos[(io.pb + 1) & 1] + off;
    for (int e = threadIdx.x; e < valid; e += CAUSE_WIDE_THREADS) {
        const KT cc = s_c[e];
        const uint32_t k = wide_digit(cc, d);
        const uint32_t dst = s_dex[k] + s_prev[k] + (uint32_t)e - s_loc[k];
        out_c[dst] = cc;
        out_p[dst] = s_p[e];
        if (next) atomicAdd(&s_next[wide_digit(cc, d + 1)], 1u);
    }
    if (next) {
        __syncthreads();
        const uint32_t v = s_next[b];
        if (v)
            atomicAdd(w.ghist + (((size_t)g * B + row) * sizeof(KT) + d + 1) *
                                    CAUSE_WIDE_BINS + b,
                      v);
    }
}

// ------------------------------------------------------------- gather

// Every operand (keys included) gathered by the row's final positions:
// buffer total % 2, or the identity when the row needed no pass. One CTA
// a (operand, row, tile), operand-major, so the rows in flight are few
// enough that their operand stays in L2 while its tiles read it at
// random (all operands a CTA, some 200 rows of 7 x 80 KB were in flight:
// every read went to memory).
template <typename KT, class Args>
__global__ void __launch_bounds__(CAUSE_WIDE_THREADS)
sort_rows_wide_gather(Args a, WideBufs<KT> w, int B, int n, int tile,
                      int tiles) {
    constexpr int U = 4;  // lanes a thread, their loads in flight together
    const int k = blockIdx.x / (B * tiles), rt = blockIdx.x % (B * tiles);
    const int row = rt / tiles, t = rt % tiles;
    const int total = w.plan[row].total;
    const size_t off = (size_t)row * n;
    const int32_t* src = total ? w.pos[total & 1] + off : nullptr;
    const int32_t* in = a.in[k] + off;
    int32_t* out = a.out[k] + off;
    const int t0 = t * tile, valid = min(tile, n - t0);
    for (int e0 = threadIdx.x; e0 < valid; e0 += U * CAUSE_WIDE_THREADS) {
        int p[U];
        int32_t v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * CAUSE_WIDE_THREADS;
            p[u] = e < valid ? (src ? src[t0 + e] : t0 + e) : 0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (e0 + u * CAUSE_WIDE_THREADS < valid) v[u] = in[p[u]];
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (e0 + u * CAUSE_WIDE_THREADS < valid)
                out[t0 + e0 + u * CAUSE_WIDE_THREADS] = v[u];
    }
}
