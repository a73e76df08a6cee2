// The in-block radix row sort of B1 (csrc/sort.cu): a stable LSD radix
// sort of ONE row of P elements inside one CTA, over one or two int32
// keys compressed to the bits the row's data needs.
//
// Range compression, exact by construction. Per key the block reduces
// the minimum mn and the largest value mx that is not INT32_MAX, and maps
//   k' = (k == INT32_MAX ? mx + 1 : k) - mn   (as uint32).
// The map is monotone and keeps ties: no int32 lies between mx and
// INT32_MAX, so INT32_MAX (a real key or the padding of positions
// n..P-1) stays above every other key. A row whose keys are all
// INT32_MAX maps every key to 0. The codes of two keys pack into one
// composite (k0' << bits1) | k1', 32 bits wide when bits0 + bits1 <= 32,
// else 64; the row takes ceil(bits / 8) digit passes, decided from its
// own data (0 when every key is equal).
//
// Each pass is stable, so the original position breaks every tie, as the
// explicit position key of the bitonic network does; no position key is
// sorted. A pass ranks every item's 8-bit digit inside its warp (a
// ballot multisplit: eight ballots find the lanes holding the same digit,
// a per-warp counter in shared memory carries the count from one item to
// the next), scans the 256 digits x warps counters, and scatters
// (composite, position) through shared memory. Items live in registers,
// IPT per thread, warp-striped: thread (warp w, lane l) holds the
// elements (w * IPT + i) * 32 + l, so the order (warp, item, lane) is
// the row's order and a warp's loads are coalesced.
//
// The caller loads the raw keys in that arrangement (INT32_MAX past the
// row's end), calls radix_sort_row, and reads the sorted keys
// (RadixRow::key, decoded back to the original int32 values) and
// positions (RadixRow::pos) from shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CAUSE_RADIX_MIN_P 256     // one warp of 8 items
#define CAUSE_RADIX_MAX_P 8192
#define CAUSE_RADIX_THREADS 512   // P / IPT at most
#define CAUSE_RADIX_BINS 256

// Items per thread: 8 up to P = 4096, 16 at P = 8192 (512 threads).
static inline int radix_ipt(int P) { return P > 4096 ? 16 : 8; }

// Dynamic shared memory of a row of width P with NK keys and IPT items a
// thread: composite keys, positions (uint16), the per-warp digit
// counters (uint16), the digit offsets and the reduction partials. A
// caller whose two keys never need more than 32 composite bits passes
// wide = false (and sorts with radix_sort_row<2, IPT, false>).
__host__ __device__ inline size_t radix_smem_bytes(int NK, int P, int ipt,
                                                   bool wide = true) {
    const int W = P / ipt / 32;
    return (size_t)P * (NK == 2 && wide ? 8 : 4) + (size_t)P * 2 +
           (size_t)W * CAUSE_RADIX_BINS * 2 + CAUSE_RADIX_BINS * 4 +
           (size_t)W * 3 * NK * 4;
}

// A key's range: codes are k - mn, with mx1 = mx + 1 the code point of
// INT32_MAX; bits is the bit length of the largest code in the row.
struct RadixRange {
    int32_t mn;
    int32_t mx1;
    int bits;
};

__device__ __forceinline__ uint32_t radix_code(int32_t k, const RadixRange& r) {
    return (uint32_t)(k == INT32_MAX ? r.mx1 : k) - (uint32_t)r.mn;
}

__device__ __forceinline__ int32_t radix_decode(uint32_t c,
                                                const RadixRange& r) {
    const int32_t v = (int32_t)(c + (uint32_t)r.mn);
    return v == r.mx1 ? INT32_MAX : v;
}

// The sorted row in shared memory.
template <int NK>
struct RadixRow {
    RadixRange r[NK];
    int bits1;   // bit length of the last key's codes (NK == 2)
    bool wide;   // composites stored as uint64
    const void* keys;
    const uint16_t* positions;

    __device__ __forceinline__ int pos(int i) const { return positions[i]; }

    // the composite at sorted index i; the codes are injective, so two
    // elements have equal keys exactly when their composites are equal
    __device__ __forceinline__ uint64_t comp(int i) const {
        return wide ? ((const uint64_t*)keys)[i] : ((const uint32_t*)keys)[i];
    }

    // key q of composite c, as the original int32
    __device__ __forceinline__ int32_t decode(int q, uint64_t c) const {
        uint32_t code = (uint32_t)c;
        if (NK == 2)
            code = q == 0 ? (uint32_t)(c >> bits1)
                          : (uint32_t)(c & ((1ull << bits1) - 1));
        return radix_decode(code, r[q]);
    }

    // key q of the element at sorted index i, as the original int32
    __device__ __forceinline__ int32_t key(int q, int i) const {
        return decode(q, comp(i));
    }
};

// Per-key ranges of the row (block reduction; ends with a block barrier
// before the partials are read).
template <int NK, int IPT>
__device__ __forceinline__ void radix_ranges(const int32_t (&k)[NK][IPT],
                                             int32_t* s_red,
                                             RadixRange (&r)[NK]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int W = blockDim.x >> 5;
#pragma unroll
    for (int q = 0; q < NK; ++q) {
        int32_t mn = INT32_MAX, mx = INT32_MIN;
        int any_max = 0;
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            const int32_t v = k[q][i];
            mn = min(mn, v);
            if (v == INT32_MAX) any_max = 1;
            else mx = max(mx, v);
        }
        mn = __reduce_min_sync(0xffffffffu, mn);
        mx = __reduce_max_sync(0xffffffffu, mx);
        any_max = __any_sync(0xffffffffu, any_max);
        if (lane == 0) {
            s_red[(warp * NK + q) * 3 + 0] = mn;
            s_red[(warp * NK + q) * 3 + 1] = mx;
            s_red[(warp * NK + q) * 3 + 2] = any_max;
        }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NK; ++q) {
        int32_t mn = INT32_MAX, mx = INT32_MIN;
        int any_max = 0;
        for (int w = 0; w < W; ++w) {
            mn = min(mn, s_red[(w * NK + q) * 3 + 0]);
            mx = max(mx, s_red[(w * NK + q) * 3 + 1]);
            any_max |= s_red[(w * NK + q) * 3 + 2];
        }
        if (mx < mn) {
            // every key is INT32_MAX: one code, no bits
            r[q].mn = INT32_MAX;
            r[q].mx1 = INT32_MAX;
            r[q].bits = 0;
        } else {
            r[q].mn = mn;
            r[q].mx1 = mx + 1;  // mx < INT32_MAX: no overflow
            const uint32_t top =
                (uint32_t)(any_max ? mx + 1 : mx) - (uint32_t)mn;
            r[q].bits = top ? 32 - __clz(top) : 0;
        }
    }
}

// LSD passes over the low `bits` bits of the warp-striped composites
// `key` with their positions `pos`. On return s_key / s_pos hold the row
// in sorted order (identity when bits == 0), after a block barrier.
template <typename KT, int IPT>
__device__ __forceinline__ void radix_passes(KT (&key)[IPT],
                                             uint32_t (&pos)[IPT], int bits,
                                             KT* s_key, uint16_t* s_pos,
                                             uint16_t* s_hist,
                                             uint32_t* s_digit) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int W = blockDim.x >> 5;
    const uint32_t lanes_below = (1u << lane) - 1u;
    uint16_t* hist = s_hist + warp * CAUSE_RADIX_BINS;

    if (bits == 0) {
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            const int p = (warp * IPT + i) * 32 + lane;
            s_key[p] = key[i];
            s_pos[p] = (uint16_t)pos[i];
        }
        __syncthreads();
        return;
    }
    for (int shift = 0; shift < bits; shift += 8) {
        // this warp's digit counters (its scatter of the last pass read
        // them before the barrier that ended it)
        for (int d = lane; d < CAUSE_RADIX_BINS / 2; d += 32)
            ((uint32_t*)hist)[d] = 0;
        __syncwarp();

        // rank of each item among the warp's items of the same digit
        // that come before it (earlier item, or same item, lower lane)
        uint32_t rank[IPT];
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            const uint32_t d = (uint32_t)(key[i] >> shift) & 255u;
            uint32_t peers = 0xffffffffu;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const bool bit = (d >> b) & 1u;
                const uint32_t v = __ballot_sync(0xffffffffu, bit);
                peers &= bit ? v : ~v;
            }
            const int leader = 31 - __clz(peers);
            uint32_t c = 0;
            if (lane == leader) {
                c = hist[d];
                hist[d] = (uint16_t)(c + __popc(peers));
            }
            rank[i] = __shfl_sync(0xffffffffu, c, leader) +
                      __popc(peers & lanes_below);
            __syncwarp();
        }
        __syncthreads();

        // per digit: its total, and each warp's count turned into the
        // count of the warps before it
        for (int d = threadIdx.x; d < CAUSE_RADIX_BINS; d += blockDim.x) {
            uint32_t s = 0;
            for (int w = 0; w < W; ++w) {
                const uint32_t c = s_hist[w * CAUSE_RADIX_BINS + d];
                s_hist[w * CAUSE_RADIX_BINS + d] = (uint16_t)s;
                s += c;
            }
            s_digit[d] = s;
        }
        __syncthreads();
        // exclusive scan of the 256 digit totals, one warp, 8 a lane
        if (warp == 0) {
            uint32_t v[8];
            uint32_t run = 0;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                v[e] = s_digit[lane * 8 + e];
                run += v[e];
            }
            uint32_t incl = run;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
                if (lane >= o) incl += t;
            }
            uint32_t ex = incl - run;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                s_digit[lane * 8 + e] = ex;
                ex += v[e];
            }
        }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            const uint32_t d = (uint32_t)(key[i] >> shift) & 255u;
            const uint32_t dst =
                s_digit[d] + s_hist[warp * CAUSE_RADIX_BINS + d] + rank[i];
            s_key[dst] = key[i];
            s_pos[dst] = (uint16_t)pos[i];
        }
        __syncthreads();
        if (shift + 8 < bits) {
#pragma unroll
            for (int i = 0; i < IPT; ++i) {
                const int p = (warp * IPT + i) * 32 + lane;
                key[i] = s_key[p];
                pos[i] = s_pos[p];
            }
        }
    }
}

// Sort the row whose raw keys thread (w, l) holds in k[q][i] for element
// (w * IPT + i) * 32 + l, P = blockDim.x * IPT elements in all, NK <= 2.
// `smem` is radix_smem_bytes(NK, P, IPT, WIDE) bytes of shared memory,
// 8-byte aligned. WIDE = false drops the 64-bit composite path: the
// caller guarantees that the two keys' codes span at most 32 bits.
// Returns the sorted row (keys and positions in shared memory, after a
// block barrier).
template <int NK, int IPT, bool WIDE = true>
__device__ __forceinline__ RadixRow<NK> radix_sort_row(
    const int32_t (&k)[NK][IPT], unsigned char* smem) {
    const int P = blockDim.x * IPT;
    const int W = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned char* s_key = smem;
    uint16_t* s_pos =
        (uint16_t*)(smem + (size_t)P * (NK == 2 && WIDE ? 8 : 4));
    uint16_t* s_hist = s_pos + P;
    uint32_t* s_digit = (uint32_t*)(s_hist + W * CAUSE_RADIX_BINS);
    int32_t* s_red = (int32_t*)(s_digit + CAUSE_RADIX_BINS);

    RadixRow<NK> row;
    radix_ranges<NK, IPT>(k, s_red, row.r);
    row.bits1 = NK == 2 ? row.r[NK - 1].bits : 0;
    int bits = 0;
#pragma unroll
    for (int q = 0; q < NK; ++q) bits += row.r[q].bits;
    row.wide = WIDE && bits > 32;
    row.keys = s_key;
    row.positions = s_pos;

    uint32_t pos[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) pos[i] = (warp * IPT + i) * 32 + lane;
    if constexpr (NK == 2 && WIDE) {
        if (row.wide) {
            uint64_t key[IPT];
#pragma unroll
            for (int i = 0; i < IPT; ++i)
                key[i] = ((uint64_t)radix_code(k[0][i], row.r[0])
                          << row.bits1) |
                         radix_code(k[1][i], row.r[1]);
            radix_passes<uint64_t, IPT>(key, pos, bits, (uint64_t*)s_key,
                                        s_pos, s_hist, s_digit);
            return row;
        }
    }
    uint32_t key[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        uint64_t c = radix_code(k[0][i], row.r[0]);
        if constexpr (NK == 2)
            c = (c << row.bits1) | radix_code(k[1][i], row.r[1]);
        key[i] = (uint32_t)c;
    }
    radix_passes<uint32_t, IPT>(key, pos, bits, (uint32_t*)s_key, s_pos,
                                s_hist, s_digit);
    return row;
}
