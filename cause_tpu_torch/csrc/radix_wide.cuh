// The wide form of B1 (csrc/sort.cu): a stable LSD radix sort of rows
// spread over several CTAs, with passes through global memory. It sorts
// the rows the cluster form (radix_cluster.cuh) cannot hold: past the
// lanes a cluster of CTAs keeps in distributed shared memory (131,072 on
// an H100), the fleet row's 258,688 to 10,485,760 lanes.
//
// Replaces, with the other forms of sort.cu, the Pallas kernel of
// cause_tpu/weaver/pallas_sort.py (`_kernel_body`, launched by the
// pallas_call at :140 and :157 behind `pallas_bitonic_sort`, :176). The
// contract is B1's: ascending lexicographic order over the first
// `num_keys` operands, ties broken by the original position, the other
// operands riding as payloads.
//
// What bounds it on the H100: bytes. A digit pass reads the items of
// every lane once and writes them once; a group of keys reads its keys
// once more to count its digits; the last launch reads every payload
// once (a gather by position) and writes every output once.
//
// What the design does about it:
// - Ranges, on the device, as radix.cuh takes them. Per key, a launch
//   reduces each tile's minimum, its largest key below INT32_MAX and
//   whether INT32_MAX occurs, and the row's last tile to finish reduces
//   the row's tiles and plans the row. A key's code is k - min, with INT32_MAX coded just above the
//   largest other key (uint32, monotone and exact over the whole int32
//   range), so the INT32_MAX that pads id lanes costs no bits: the v4 id
//   sort's keys span about 14 and 24 bits, not 31 each. A row of equal keys
//   has a key of no bits.
// - The codes of consecutive keys pack into one composite, least
//   significant key last, greedily from the last key while the bits fit
//   (32 for one key, 64 otherwise): a group. Groups sort least
//   significant first, each by ceil(bits / 8) stable 8-bit digit passes.
//   The plan is per row and lives on the device: the host never reads it.
// - Where a group's bits and the bits of a row position (bit length of
//   n - 1) fit the word together, the word carries the position in its
//   low bits and the digits start above it: one 8-byte word travels a
//   pass, not a composite and a 4-byte position (16 bytes a lane a pass,
//   not 24). Stability keeps ties in row order all the same.
// - At a group's start one launch counts, per row, the digits of its
//   first pass; each pass counts the next one's as it writes its items
//   out (the totals do not depend on the order).
// - Each pass is then one launch over (row, tile) CTAs of
//   CAUSE_WIDE_TILE lanes; a CTA of a row the pass does not touch
//   leaves at once, the others take their tiles from their row's
//   counter in launch order. A CTA ranks its items stably (the
//   warp-ballot multisplit of radix.cuh, with int32 positions), publishes
//   its digit counts, and sums the counts of the row's earlier tiles by a
//   decoupled look-back; a digit's offset is the row's count of the
//   digits below it plus the earlier tiles' count of it, which is what
//   makes the pass stable. It stages its items in shared memory in sorted
//   order and writes them out coalesced. The counts are integers: the
//   result does not depend on the order the CTAs run in.
// - The first pass of a group composes its words from the raw keys (the
//   row's own order for the first group, gathered by position for a later
//   one), each key's loads for all of a thread's items in flight at once.
//   The last launch gathers every payload by final position and decodes
//   the keys of the last group from its words (code + min), so those
//   keys are not read again.
// - No host sync. The host launches the most passes the key count allows
//   (groups <= ceil(num_keys / 2), 4 passes a 32-bit group, 8 a 64-bit
//   one); a pass beyond its row's plan returns at once. Pass p (counted
//   over the row's active passes) reads buffer p % 2 and writes buffer
//   (p + 1) % 2, so the final gather reads buffer total % 2, or the
//   identity when the row needed no pass.
//
// Scratch, allocated by the caller (wide_layout): two word and two
// position buffers of B * n elements, the digit totals, one look-back
// word a (pass, row, tile, digit), the tile counters, the per-tile ranges
// and the per-row plans.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CAUSE_WIDE_THREADS 256
#define CAUSE_WIDE_WARPS (CAUSE_WIDE_THREADS / 32)
#define CAUSE_WIDE_BINS 256
#define CAUSE_WIDE_MAX_KEYS 9
#define CAUSE_WIDE_MAX_GROUPS 5   // ceil(9 / 2): any two keys fit 64 bits
#define CAUSE_WIDE_ALIGN 256
// a tile: items a thread, lanes a CTA (every row here spans 33 tiles or
// more, past the cluster form's 131,072 lanes)
#define CAUSE_WIDE_IPT 16
#define CAUSE_WIDE_TILE (CAUSE_WIDE_IPT * CAUSE_WIDE_THREADS)

// a scatter CTA handles one digit a thread
static_assert(CAUSE_WIDE_THREADS == CAUSE_WIDE_BINS, "one digit a thread");

// One row's plan: per key its minimum, the code point of INT32_MAX and
// its bit length; per group (least significant first) its keys
// first..last, its passes, the passes of the groups before it, whether
// its words carry the row position (then its digits start at bit
// pbits); the bits of a row position and the row's passes in all.
struct WidePlan {
    int32_t mn[CAUSE_WIDE_MAX_KEYS];
    int32_t mx1[CAUSE_WIDE_MAX_KEYS];
    int32_t bits[CAUSE_WIDE_MAX_KEYS];
    int32_t first[CAUSE_WIDE_MAX_GROUPS];
    int32_t last[CAUSE_WIDE_MAX_GROUPS];
    int32_t passes[CAUSE_WIDE_MAX_GROUPS];
    int32_t base[CAUSE_WIDE_MAX_GROUPS];
    int32_t packed[CAUSE_WIDE_MAX_GROUPS];
    int32_t pbits;
    int32_t ngroups;
    int32_t total;
};

static inline size_t wide_align(size_t b) {
    return (b + CAUSE_WIDE_ALIGN - 1) / CAUSE_WIDE_ALIGN * CAUSE_WIDE_ALIGN;
}

static inline int wide_tiles(int n) {
    return (n + CAUSE_WIDE_TILE - 1) / CAUSE_WIDE_TILE;
}

// Bytes of word a key count sorts with.
static inline int wide_comp_bytes(int num_keys) { return num_keys == 1 ? 4 : 8; }

// Groups the host launches for num_keys keys (the most a plan can have).
static inline int wide_groups(int num_keys) {
    return num_keys == 1 ? 1 : (num_keys + 1) / 2;
}

// The scratch regions, in order, each aligned: words x 2, positions x 2;
// then the region zeroed at the start of every sort: the digit totals
// (uint32 [groups][B][digits][256]), the look-back words (uint32
// [groups * digits][B][tiles][256]), the rows' tile counters (uint32
// [groups * digits][B]) and the rows' counts of tiles whose ranges are
// in (uint32 [B]); then the tile ranges (int32 [B][tiles][num_keys][3])
// and the plans ([B] WidePlan).
struct WideLayout {
    size_t comp, pos, ghist, status, counter, done, part, plan, total;
};

static inline WideLayout wide_layout(int B, int n, int num_keys) {
    const size_t elems = (size_t)B * (size_t)n;
    const size_t tiles = (size_t)wide_tiles(n);
    const size_t cb = wide_comp_bytes(num_keys);
    const size_t slots = (size_t)wide_groups(num_keys) * cb;
    WideLayout L;
    L.comp = 0;
    L.pos = L.comp + wide_align(2 * elems * cb);
    L.ghist = L.pos + wide_align(2 * elems * 4);
    L.status = L.ghist + wide_align(slots * B * CAUSE_WIDE_BINS * 4);
    L.counter = L.status + wide_align(slots * B * tiles * CAUSE_WIDE_BINS * 4);
    L.done = L.counter + wide_align(slots * B * 4);
    L.part = L.done + wide_align((size_t)B * 4);
    L.plan = L.part + wide_align((size_t)B * tiles * num_keys * 3 * 4);
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
    uint32_t* done;
    int32_t* part;
    WidePlan* plan;
};

// ------------------------------------------------------ codes and plans

// A key's code: k - mn, INT32_MAX at mx1 (radix.cuh's radix_code).
__device__ __forceinline__ uint32_t wide_code(int32_t k, int32_t mn,
                                              int32_t mx1) {
    return (uint32_t)(k == INT32_MAX ? mx1 : k) - (uint32_t)mn;
}

__device__ __forceinline__ int32_t wide_decode(uint32_t c, int32_t mn,
                                               int32_t mx1) {
    const int32_t v = (int32_t)(c + (uint32_t)mn);
    return v == mx1 ? INT32_MAX : v;
}

// Key q's range from its row's minimum, largest key below INT32_MAX
// (INT32_MIN if none) and whether INT32_MAX occurs.
__device__ __forceinline__ void wide_range(WidePlan& pl, int q, int32_t mn,
                                           int32_t mx, int any_max) {
    if (mx < mn) {  // every key is INT32_MAX: one code, no bits
        pl.mn[q] = INT32_MAX;
        pl.mx1[q] = INT32_MAX;
        pl.bits[q] = 0;
        return;
    }
    pl.mn[q] = mn;
    pl.mx1[q] = mx + 1;  // mx < INT32_MAX: no overflow
    const uint32_t top = (uint32_t)(any_max ? mx + 1 : mx) - (uint32_t)mn;
    pl.bits[q] = top ? 32 - __clz(top) : 0;
}

// The groups of a row of n lanes whose keys' ranges are in pl: greedy
// from the last key, each at most `limit` bits (the word's width).
__device__ __forceinline__ void wide_groups_of(WidePlan& pl, int num_keys,
                                               int limit, int n) {
    int pb = 0;
    while (pb < 31 && (1 << pb) < n) ++pb;
    pl.pbits = pb;
    int g = 0, total = 0;
    for (int q = num_keys - 1; q >= 0; ++g) {
        pl.last[g] = q;
        int bits = 0;
        while (q >= 0 && bits + pl.bits[q] <= limit) bits += pl.bits[q--];
        pl.first[g] = q + 1;
        pl.passes[g] = (bits + 7) / 8;
        pl.packed[g] = bits + pb <= limit;
        pl.base[g] = total;
        total += pl.passes[g];
    }
    pl.ngroups = g;
    pl.total = total;
}

// The bit a group's digits start at.
__device__ __forceinline__ int wide_shift(const WidePlan& pl, int g) {
    return pl.packed[g] ? pl.pbits : 0;
}

// The row position a packed word carries.
template <typename KT>
__device__ __forceinline__ int32_t wide_word_pos(KT w, int pbits) {
    return (int32_t)((uint64_t)w & ((1ull << pbits) - 1ull));
}

// Group g's words of the lanes at row positions p[0..IPT) (row offset
// off; a lane past the row passes position 0, a harmless read): each
// key's IPT loads are issued together before any is used.
template <typename KT, int IPT, class Args>
__device__ __forceinline__ void wide_compose(const Args& a, const WidePlan& pl,
                                             int g, size_t off,
                                             const int32_t (&p)[IPT],
                                             KT (&c)[IPT]) {
    for (int q = pl.first[g]; q <= pl.last[g]; ++q) {
        const int32_t* in = a.in[q] + off;
        int32_t k[IPT];
#pragma unroll
        for (int i = 0; i < IPT; ++i) k[i] = in[p[i]];
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            const KT code = (KT)wide_code(k[i], pl.mn[q], pl.mx1[q]);
            c[i] = q == pl.first[g] ? code : (KT)((c[i] << pl.bits[q]) | code);
        }
    }
    if (pl.packed[g]) {
#pragma unroll
        for (int i = 0; i < IPT; ++i)
            c[i] = (KT)((c[i] << pl.pbits) | (uint32_t)p[i]);
    }
}

// The group whose words a sorted row ends with: the last group with a
// pass (a group of no pass is the last one, its keys of no bits).
__device__ __forceinline__ int wide_last_group(const WidePlan& pl) {
    int g = pl.ngroups - 1;
    if (g > 0 && pl.passes[g] == 0) --g;
    return g;
}

// How the output of operand k is made: 0 gathered by position, 1
// decoded from the last group's word, 2 a key of no bits (its one value).
__device__ __forceinline__ int wide_out_kind(const WidePlan& pl, int k,
                                             int num_keys) {
    if (k >= num_keys) return 0;
    if (pl.bits[k] == 0) return 2;
    const int g = wide_last_group(pl);
    return pl.total && pl.first[g] <= k && k <= pl.last[g] ? 1 : 0;
}

// Key k (of group g) decoded from its word w.
template <typename KT>
__device__ __forceinline__ int32_t wide_key_of(const WidePlan& pl, int g,
                                               int k, KT w) {
    uint64_t c = (uint64_t)w;
    if (pl.packed[g]) c >>= pl.pbits;
    for (int q = pl.last[g]; q > k; --q) c >>= pl.bits[q];
    const uint32_t code = (uint32_t)(c & ((1ull << pl.bits[k]) - 1ull));
    return wide_decode(code, pl.mn[k], pl.mx1[k]);
}

template <typename KT>
__device__ __forceinline__ uint32_t wide_digit(KT c, int bit) {
    return (uint32_t)((uint64_t)c >> bit) & 255u;
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

// The range reduction of one block: per key, over the lanes [0, valid)
// of the slice at `off`, the minimum, the largest key below INT32_MAX and
// whether INT32_MAX occurs, left in out[q * 3 + 0..2] (shared or global)
// by thread 0; each thread's U loads of a round in flight together. Ends
// with a block barrier.
template <class Args, int WARPS, int U>
__device__ __forceinline__ void wide_block_ranges(const Args& a, int num_keys,
                                                  size_t off, int valid,
                                                  int32_t (*s_red)[3],
                                                  int32_t* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int q = 0; q < num_keys; ++q) {
        const int32_t* in = a.in[q] + off;
        int32_t mn = INT32_MAX, mx = INT32_MIN;
        int any_max = 0;
        for (int e0 = threadIdx.x; e0 < valid; e0 += U * WARPS * 32) {
            int32_t v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int e = e0 + u * WARPS * 32;
                v[u] = e < valid ? in[e] : INT32_MAX;
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                mn = min(mn, v[u]);
                if (v[u] != INT32_MAX) mx = max(mx, v[u]);
                else if (e0 + u * WARPS * 32 < valid) any_max = 1;
            }
        }
        mn = __reduce_min_sync(0xffffffffu, mn);
        mx = __reduce_max_sync(0xffffffffu, mx);
        any_max = __any_sync(0xffffffffu, any_max);
        if (lane == 0) {
            s_red[warp][0] = mn;
            s_red[warp][1] = mx;
            s_red[warp][2] = any_max;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int w = 1; w < WARPS; ++w) {
                mn = min(mn, s_red[w][0]);
                mx = max(mx, s_red[w][1]);
                any_max |= s_red[w][2];
            }
            out[q * 3 + 0] = mn;
            out[q * 3 + 1] = mx;
            out[q * 3 + 2] = any_max;
        }
        __syncthreads();
    }
}

// ------------------------------------------------------------- ranges

// Each (row, tile) CTA: per key, its lanes' range (wide_block_ranges);
// the row's last CTA to finish (a count of the row's tiles in `done`)
// then reduces the row's tiles' ranges and plans the row, thread 0
// planning: no launch of its own, and no CTA waits on another.
template <typename KT, class Args>
__global__ void __launch_bounds__(CAUSE_WIDE_THREADS)
sort_rows_wide_ranges(Args a, WideBufs<KT> w, int num_keys, int n,
                      int tiles) {
    constexpr int tile = CAUSE_WIDE_TILE;
    __shared__ int32_t s_red[CAUSE_WIDE_WARPS][3];
    __shared__ bool s_last;
    const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int32_t* part = w.part + (size_t)row * tiles * num_keys * 3;
    wide_block_ranges<Args, CAUSE_WIDE_WARPS, 16>(
        a, num_keys, (size_t)row * n + (size_t)t * tile,
        min(tile, n - t * tile), s_red,
        w.part + ((size_t)row * tiles + t) * num_keys * 3);
    if (threadIdx.x == 0) {
        __threadfence();  // this tile's ranges, before its count
        s_last = atomicAdd(w.done + row, 1u) == (unsigned)tiles - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();  // every tile's ranges are in
    WidePlan pl;
    for (int q = 0; q < num_keys; ++q) {
        int32_t mn = INT32_MAX, mx = INT32_MIN;
        int any_max = 0;
        for (int u = threadIdx.x; u < tiles; u += CAUSE_WIDE_THREADS) {
            const volatile int32_t* p = part + ((size_t)u * num_keys + q) * 3;
            mn = min(mn, p[0]);
            mx = max(mx, p[1]);
            any_max |= p[2];
        }
        mn = __reduce_min_sync(0xffffffffu, mn);
        mx = __reduce_max_sync(0xffffffffu, mx);
        any_max = __any_sync(0xffffffffu, any_max);
        if (lane == 0) {
            s_red[warp][0] = mn;
            s_red[warp][1] = mx;
            s_red[warp][2] = any_max;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int v = 1; v < CAUSE_WIDE_WARPS; ++v) {
                mn = min(mn, s_red[v][0]);
                mx = max(mx, s_red[v][1]);
                any_max |= s_red[v][2];
            }
            wide_range(pl, q, mn, mx, any_max);
        }
        __syncthreads();
    }
    if (threadIdx.x != 0) return;
    wide_groups_of(pl, num_keys, 8 * (int)sizeof(KT), n);
    w.plan[row] = pl;
}

// ------------------------------------------------------------- a pass

// Pass d of group g of a row: active, and if so which passes of the row
// came before it (its buffer parity) and whether it composes.
struct WidePass {
    int pb;        // the row's active passes before this one
    bool compose;  // the group's first pass: words from the keys
};

__device__ __forceinline__ bool wide_pass(const WidePlan* pl, int g, int d,
                                          WidePass& io) {
    if (g >= pl->ngroups || d >= pl->passes[g]) return false;
    io.pb = pl->base[g] + d;
    io.compose = d == 0;
    return true;
}

// A pass's items, IPT a thread at the tile's lanes t0 + e[i] (an item
// with e[i] >= valid lies past the row), as pass io of group g sees
// them: words c and row positions p (0 where the word carries it and the
// pass does not compose). A group's first pass composes its words: from
// the row's own order (the row's first pass) or from the positions the
// pass before left, the keys read by position.
template <typename KT, int IPT, class Args>
__device__ __forceinline__ void wide_items(const Args& a,
                                           const WideBufs<KT>& w,
                                           const WidePlan* pl, int g,
                                           const WidePass& io, size_t off,
                                           int t0, const int (&e)[IPT],
                                           int valid, KT (&c)[IPT],
                                           int32_t (&p)[IPT]) {
    const int par = io.pb & 1;
    const KT* src_c = w.comp[par] + off + t0;
    const int32_t* src_p = w.pos[par] + off + t0;
    if (!io.compose) {
        const bool packed = pl->packed[g];
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            c[i] = e[i] < valid ? src_c[e[i]] : (KT)0;
            p[i] = e[i] < valid && !packed ? src_p[e[i]] : 0;
        }
        return;
    }
    // a group with a pass has one before it unless it is the first
    const int from = io.pb == 0 ? 0 : pl->packed[g - 1] ? 1 : 2;
#pragma unroll
    for (int i = 0; i < IPT; ++i)
        p[i] = e[i] >= valid ? 0
               : from == 0   ? t0 + e[i]
               : from == 1   ? wide_word_pos(src_c[e[i]], pl->pbits)
                             : src_p[e[i]];
    wide_compose<KT, IPT>(a, *pl, g, off, p, c);
}

// The row's digit totals of the first pass of group g, counted from the
// words at the group's start: ghist[g][row][0][digit]. Each pass counts
// the next one's as it writes its items out.
template <typename KT, class Args>
__global__ void __launch_bounds__(CAUSE_WIDE_THREADS)
sort_rows_wide_digits(Args a, WideBufs<KT> w, int B, int n, int tiles,
                      int g) {
    constexpr int IPT = CAUSE_WIDE_IPT, tile = CAUSE_WIDE_TILE;
    __shared__ uint32_t s_cnt[CAUSE_WIDE_BINS];
    const int row = blockIdx.x / tiles, t = blockIdx.x % tiles;
    const WidePlan* pl = w.plan + row;
    WidePass io;
    if (!wide_pass(pl, g, 0, io)) return;
    const int lane = threadIdx.x & 31;
    const int shift = wide_shift(*pl, g);
    const size_t off = (size_t)row * n;
    const int t0 = t * tile, valid = min(tile, n - t0);
    s_cnt[threadIdx.x] = 0;  // CAUSE_WIDE_THREADS == CAUSE_WIDE_BINS
    __syncthreads();
    int e[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) e[i] = threadIdx.x + i * CAUSE_WIDE_THREADS;
    KT c[IPT];
    int32_t p[IPT];
    wide_items<KT, IPT>(a, w, pl, g, io, off, t0, e, valid, c, p);
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        // past the row: counted nowhere; one shared add a digit a warp
        const uint32_t dg =
            e[i] < valid ? wide_digit(c[i], shift) : CAUSE_WIDE_BINS;
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

// A tile's look-back word of one digit: a flag in the top two bits
// (0: not yet, AGG: this tile's count, PRE: the count of this tile and
// every earlier one) and the count below.
#define CAUSE_WIDE_AGG (1u << 30)
#define CAUSE_WIDE_PRE (2u << 30)
#define CAUSE_WIDE_COUNT (CAUSE_WIDE_AGG - 1u)
#define CAUSE_WIDE_SPINS (1 << 24)

#define CAUSE_WIDE_LOOK 16  // earlier tiles a look-back reads at once

// The count of digit b in the row's tiles before tile t: walk back over
// the earlier tiles' words, adding counts, until one holds a prefix.
// The words of CAUSE_WIDE_LOOK earlier tiles are read at once (their
// loads in flight together) and consumed in order, so a walk over many
// tiles that hold only their own counts costs one load latency every
// CAUSE_WIDE_LOOK tiles, not every tile; a word not yet written is read
// again. Every earlier tile's CTA took its id first, so it runs and
// publishes; a wait past CAUSE_WIDE_SPINS polls traps rather than hangs.
__device__ __forceinline__ uint32_t wide_look_back(const uint32_t* words,
                                                   int t, int b) {
    uint32_t excl = 0;
    int spins = 0;
    for (int u = t - 1; u >= 0;) {
        uint32_t v[CAUSE_WIDE_LOOK];
#pragma unroll
        for (int j = 0; j < CAUSE_WIDE_LOOK; ++j)
            v[j] = u - j >= 0 ? *(const volatile uint32_t*)(
                                    words + (size_t)(u - j) * CAUSE_WIDE_BINS + b)
                              : CAUSE_WIDE_PRE;  // before tile 0: nothing
#pragma unroll
        for (int j = 0; j < CAUSE_WIDE_LOOK; ++j) {
            if (v[j] == 0) break;  // not yet: read from here again
            excl += v[j] & CAUSE_WIDE_COUNT;
            if (v[j] & CAUSE_WIDE_PRE) return excl;
            --u;
        }
        if (++spins > CAUSE_WIDE_SPINS) __trap();
    }
    return excl;
}

// Shared memory of a scatter CTA: the tile's words and positions in
// local sorted order, the per-warp digit counters, the tile's digit
// offsets, the row's digit offsets, the earlier tiles' counts and the
// tile's counts of the next pass's digits.
__host__ __device__ inline size_t wide_scatter_smem(int comp_bytes) {
    return (size_t)CAUSE_WIDE_TILE * (comp_bytes + 4) +
           (size_t)CAUSE_WIDE_WARPS * CAUSE_WIDE_BINS * 2 +
           4 * CAUSE_WIDE_BINS * 4;
}

// One tile of pass d of group g: rank the tile's items stably by digit,
// find each digit's global offset, stage the items in shared memory in
// that order and write each to its offset: the offset of its digit in
// the row, plus the count of its digit in the row's earlier tiles (a
// decoupled look-back: a row's tiles take their ids in order, publish
// their own counts at once and their prefixes after), plus its index
// among the tile's items of that digit. As it writes them out it counts
// their digits of the group's next pass into the row's totals for that
// pass. A packed group's items are their words alone. Items are
// warp-striped, IPT = CAUSE_WIDE_IPT a thread: thread (warp w, lane l)
// holds lanes (w * IPT + i) * 32 + l of the tile, so the order (warp,
// item, lane) is the tile's order. Lanes past the row's end take digit 255 and rank after
// every real item, so they land past the tile's real items and are never
// written.
template <typename KT, class Args>
__device__ __forceinline__ void wide_scatter_tile(const Args& a,
                                                  const WideBufs<KT>& w,
                                                  int B, int n, int tiles,
                                                  int g, int d, int row,
                                                  int t, const WidePass& io) {
    extern __shared__ __align__(16) unsigned char wide_smem[];
    constexpr int IPT = CAUSE_WIDE_IPT, tile = CAUSE_WIDE_TILE;
    const int slot = g * (int)sizeof(KT) + d;
    const WidePlan* pl = w.plan + row;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint32_t lanes_below = (1u << lane) - 1u;
    const size_t off = (size_t)row * n;
    const int t0 = t * tile, valid = min(tile, n - t0);
    const bool packed = pl->packed[g];
    const int bit = wide_shift(*pl, g) + 8 * d;
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
    {
        int e[IPT];
#pragma unroll
        for (int i = 0; i < IPT; ++i) e[i] = (warp * IPT + i) * 32 + lane;
        wide_items<KT, IPT>(a, w, pl, g, io, off, t0, e, valid, c, p);
    }
    // item i's digit, recomputed where needed (registers are the limit)
    auto digit = [&](int i) {
        return (warp * IPT + i) * 32 + lane < valid ? wide_digit(c[i], bit)
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
        if (!packed) s_p[s] = p[i];
    }
    __syncthreads();

    // coalesced: consecutive threads, consecutive offsets within a digit
    KT* out_c = w.comp[(io.pb + 1) & 1] + off;
    int32_t* out_p = w.pos[(io.pb + 1) & 1] + off;
    for (int e = threadIdx.x; e < valid; e += CAUSE_WIDE_THREADS) {
        const KT cc = s_c[e];
        const uint32_t k = wide_digit(cc, bit);
        const uint32_t dst = s_dex[k] + s_prev[k] + (uint32_t)e - s_loc[k];
        out_c[dst] = cc;
        if (!packed) out_p[dst] = s_p[e];
        if (next) atomicAdd(&s_next[wide_digit(cc, bit + 8)], 1u);
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

// Pass d of group g, one launch of a CTA a (row, tile). A CTA of a row
// the pass does not touch leaves at once; the others take their tile ids
// from their row's counter in launch order, so a tile's earlier tiles
// have all been taken by running CTAs when it looks back. (One launch of
// as many CTAs as the card holds, each taking ids until none was left,
// made a pass beyond every row's plan nearly free at the fleet row's
// 2,560 tiles, but each pass it ran was slower on an H100.) The launch
// bounds keep two CTAs of 4096 lanes an SM (at most 128 registers a
// thread).
template <typename KT, class Args>
__global__ void __launch_bounds__(CAUSE_WIDE_THREADS, 2)
sort_rows_wide_scatter(Args a, WideBufs<KT> w, int B, int n, int tiles,
                       int g, int d) {
    __shared__ int s_id;
    const int row = blockIdx.x / tiles;
    WidePass io;
    if (!wide_pass(w.plan + row, g, d, io)) return;  // past the row's plan
    if (threadIdx.x == 0)
        s_id = atomicAdd(w.counter + ((size_t)g * sizeof(KT) + d) * B + row,
                         1u);
    __syncthreads();
    wide_scatter_tile<KT>(a, w, B, n, tiles, g, d, row, s_id, io);
}

// ------------------------------------------------------------- gather

// Every output by the row's final words (buffer total % 2, or the
// identity when the row needed no pass): a payload or a key of an
// earlier group gathered by position, a key of the last group decoded
// from the word, a key of no bits its one value. One CTA a (operand,
// row, tile), operand-major, so the rows in flight are few enough that
// their operand stays in L2 while its tiles read it at random (all
// operands a CTA, some 200 rows of 7 x 80 KB were in flight: every read
// went to memory; writing the outputs from the last pass instead, every
// operand read at once, was slower at the fleet row on an H100).
template <typename KT, class Args>
__global__ void __launch_bounds__(CAUSE_WIDE_THREADS)
sort_rows_wide_gather(Args a, WideBufs<KT> w, int num_keys, int B, int n,
                      int tiles) {
    constexpr int tile = CAUSE_WIDE_TILE;
    constexpr int U = 16;  // lanes a thread, their loads in flight together
    const int k = blockIdx.x / (B * tiles), rt = blockIdx.x % (B * tiles);
    const int row = rt / tiles, t = rt % tiles;
    const WidePlan& pl = w.plan[row];
    const int total = pl.total, g = wide_last_group(pl);
    const int kind = wide_out_kind(pl, k, num_keys);
    const bool packed = pl.packed[g];
    const size_t off = (size_t)row * n;
    const KT* wsrc = w.comp[total & 1] + off;
    const int32_t* psrc = w.pos[total & 1] + off;
    const int32_t* in = a.in[k] + off;
    int32_t* out = a.out[k] + off;
    const int t0 = t * tile, valid = min(tile, n - t0);
    if (kind == 2) {
        const int32_t v = wide_decode(0u, pl.mn[k], pl.mx1[k]);
        for (int e = threadIdx.x; e < valid; e += CAUSE_WIDE_THREADS)
            out[t0 + e] = v;
        return;
    }
    if (kind == 1) {
        for (int e = threadIdx.x; e < valid; e += CAUSE_WIDE_THREADS)
            out[t0 + e] = wide_key_of(pl, g, k, wsrc[t0 + e]);
        return;
    }
    for (int e0 = threadIdx.x; e0 < valid; e0 += U * CAUSE_WIDE_THREADS) {
        int p[U];
        int32_t v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = t0 + e0 + u * CAUSE_WIDE_THREADS;
            p[u] = e0 + u * CAUSE_WIDE_THREADS >= valid ? 0
                   : total == 0 ? e
                   : packed     ? wide_word_pos(wsrc[e], pl.pbits)
                                : psrc[e];
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
