// A1: the v5 wave's phase A after B1's segment sort, one CTA per row:
// twin groups, E1 overlaps and E2 stabs over the row's sorted segments.
//
// Replaces no Pallas kernel: in the JAX package phase A is XLA glue
// (cause_tpu/weaver/jaxw5.py, phase A); its PyTorch counterpart, a chain
// of some 80 ops a call, is weaver/segorder.py's seg_order_plain, the
// plain version. Contract, per row of S
// segments: s_mh/s_ml/s_src are B1's sort of (min id, segment) with
// invalid segments keyed (INT32_MAX, INT32_MAX); the sg_* tables are the
// marshal's, indexed by segment; hi/lo/cci/vc are the row's lanes. Out,
// per sorted position i: the sorted segment's valid flag, length (0 when
// invalid), first lane and special-tail flag; grp_start (not an exact
// dense twin of position i - 1), grp (the group ordinal: starts at or
// before i, less one); explode (E1: its id interval overlaps an earlier
// group's or the next group's; or E2: some valid head's cause stabs its
// group) and survive (valid, not exploded, not a dropped twin). Every
// output is what seg_order_plain gives, bit for bit, with the JAX index
// semantics gatherops.py documents (a gather counts negatives from the
// end and clamps).
//
// What bounds it on the H100: bytes, and the latency of dependent reads.
// Per segment it must read 3 sorted words, 8 table entries (5 int32, 3
// bool) through s_src, and 4 lanes (vc and cci at the segment's first
// lane, hi and lo at its head's cause), and write 17 bytes: 68 B, about
// 1.39 GB at pairs_random's 1,024 x 20,008 segments (0.42 ms at 3.35
// TB/s). The plain chain streams some 80 [B, S] tensors through device
// memory in 600-800 launches.
//
// The design:
// - one CTA walks its row; three passes, each a loop over the row:
//   1. tiles of NT segments: the gathers, the twin test against the
//      previous segment (a warp shuffle; a warp's first lane reads the
//      warp before's last from shared memory, the tile's first the last
//      tile's), and two block scans carried across tiles: the count of
//      group starts (grp) and the running lexicographic max of the
//      segments' (max hi, max lo) packed order-preservingly into int64
//      (what an earlier group reaches: E1's "before" test, made at each
//      group's start). Each start writes its group's entries: min key,
//      max key, its E1-before byte, a zero stab byte and its tail byte
//      (special tail and length > 1); it writes the E1-after byte of the
//      group before it (the previous segment is that group's last, and
//      twins share their interval), the row's last segment its own
//      group's (the next group is none: (INT32_MAX, INT32_MAX));
//   2. each valid segment with a cause searches the group mins for the
//      rightmost group whose min is at or below the cause (a binary
//      search: the mins ascend, since the segments are sorted and a
//      group's min is its start's) and marks that group stabbed when the
//      cause lies before its max, or at it with a special tail over more
//      than one lane;
//   3. explode = valid and any of the group's three bytes; survive.
// - the group table (mins, max keys, flag bytes) and the causes' keys
//   are global scratch the wrapper allocates, written and read by this
//   CTA alone: no second launch, no atomics, no host sync. A table in
//   shared memory would hold a row of up to 28,500 groups, but one CTA
//   an SM where two run (timed at pairs_random's rows: 2.53 ms against
//   2.06 with the table in L2, PERF.md), and not the fleet row's
//   226,808. So shared memory holds an index of the mins instead: after
//   pass 1 every k-th min, k = ceil(G / 4096) (the whole table where G
//   <= 4,096, so every pairs_full row), 32 KB at most. The search runs
//   over the index in shared memory, then over the k - 1 mins between
//   two samples in global memory: at most 12 steps in shared memory and
//   ceil(log2(k)) over one run of k adjacent words (k <= 5 at
//   pairs_random's rows, <= 56 at the fleet row's), where a search of the
//   whole table in L2 took 15-18 dependent reads.
// - each tile's sorted words for the next tile are loaded before the
//   tile's scans, so a tile starts with its first gathers.
// - tiles take 256 threads for rows up to 4,096 segments, so that a
//   1,024-row call of short rows is one wave of CTAs, else 1,024.
// The byte flags are plain stores: each byte has one writer, but the
// stab byte, whose writers all store 1.

#include <cuda_runtime.h>
#include <stdint.h>

#define CAUSE_A1_FULL 0xffffffffu
// the most group mins the shared index holds (8 B each)
#define CAUSE_A1_SAMPLES 4096
// rows of at most this many segments take the narrow tile
#define CAUSE_A1_NARROW_S 4096

typedef long long a1_i64;

#define CAUSE_A1_KEY_MAX 0x7fffffffffffffffLL
#define CAUSE_A1_KEY_MIN (-CAUSE_A1_KEY_MAX - 1)

// (hi, lo) as one int64 whose order is the pair's lexicographic order:
// hi * 2^32 + (lo + 2^31). (INT32_MAX, INT32_MAX) packs to INT64_MAX.
__device__ __forceinline__ a1_i64 a1_key(int32_t h, int32_t l) {
    return (a1_i64)h * 4294967296LL + ((a1_i64)l + 2147483648LL);
}

__device__ __forceinline__ int a1_clamp(int x, int n) {
    return x < 0 ? 0 : (x > n - 1 ? n - 1 : x);
}

// A gather index with the JAX semantics: negatives from the end, clamped.
__device__ __forceinline__ int a1_take(int x, int n) {
    return a1_clamp(x < 0 ? x + n : x, n);
}

__device__ __forceinline__ a1_i64 a1_max(a1_i64 a, a1_i64 b) {
    return a > b ? a : b;
}

// What the twin test compares of a segment and its predecessor; fl is
// the special-tail flag | (dense and valid) << 1.
struct A1Seg {
    int32_t mh, ml, Mh, Ml, len, hvc, vsum, chi, clo, fl;
};

__device__ __forceinline__ A1Seg a1_shfl_up(const A1Seg& s) {
    A1Seg p;
    p.mh = __shfl_up_sync(CAUSE_A1_FULL, s.mh, 1);
    p.ml = __shfl_up_sync(CAUSE_A1_FULL, s.ml, 1);
    p.Mh = __shfl_up_sync(CAUSE_A1_FULL, s.Mh, 1);
    p.Ml = __shfl_up_sync(CAUSE_A1_FULL, s.Ml, 1);
    p.len = __shfl_up_sync(CAUSE_A1_FULL, s.len, 1);
    p.hvc = __shfl_up_sync(CAUSE_A1_FULL, s.hvc, 1);
    p.vsum = __shfl_up_sync(CAUSE_A1_FULL, s.vsum, 1);
    p.chi = __shfl_up_sync(CAUSE_A1_FULL, s.chi, 1);
    p.clo = __shfl_up_sync(CAUSE_A1_FULL, s.clo, 1);
    p.fl = __shfl_up_sync(CAUSE_A1_FULL, s.fl, 1);
    return p;
}

// exact dense twins: the same interval, length, head class, tail flag,
// value sum and head cause, both dense and valid
__device__ __forceinline__ bool a1_twins(const A1Seg& s, const A1Seg& p) {
    return (s.fl & 2) && p.fl == s.fl && s.mh == p.mh && s.ml == p.ml &&
           s.Mh == p.Mh && s.Ml == p.Ml && s.len == p.len &&
           s.hvc == p.hvc && s.vsum == p.vsum && s.chi == p.chi &&
           s.clo == p.clo;
}

template <int NT>
struct A1Shared {
    A1Seg nb[NT / 32 + 1];   // [w + 1]: warp w's last; [0]: the last tile's
    int32_t wcnt[NT / 32];   // warps' counts of group starts
    a1_i64 wmax[NT / 32];    // warps' maxima of the max keys
};

struct A1Args {
    const int32_t *hi, *lo, *cci, *vc;                 // [B, N]
    const int32_t *s_mh, *s_ml, *s_src;                // [B, S], sorted
    const int32_t *sg_Mh, *sg_Ml, *sg_len, *sg_lane0, *sg_vsum;  // [B, S]
    const uint8_t *sg_dense, *sg_tsp, *sg_valid;       // [B, S], bool
    uint8_t *o_va, *o_tsp, *o_gs, *o_expl, *o_surv;    // [B, S], bool
    int32_t *o_len, *o_lane0, *o_grp;                  // [B, S]
    a1_i64 *qk, *gmax, *gmin;  // scratch [B, S]
    uint8_t* gfl;              // scratch [B, S, 4]
    int N, S;
};

template <int NT>
__global__ void __launch_bounds__(NT) seg_order_kernel(A1Args a) {
    // the index of the group mins: min(S, CAUSE_A1_SAMPLES) words
    extern __shared__ a1_i64 a1_index[];
    __shared__ A1Shared<NT> sh;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int N = a.N, S = a.S;
    const size_t rs = (size_t)blockIdx.x * S, rn = (size_t)blockIdx.x * N;
    const int32_t *hi = a.hi + rn, *lo = a.lo + rn, *cci = a.cci + rn,
                  *vc = a.vc + rn;
    const int32_t *s_mh = a.s_mh + rs, *s_ml = a.s_ml + rs,
                  *s_src = a.s_src + rs;
    const int32_t *sg_Mh = a.sg_Mh + rs, *sg_Ml = a.sg_Ml + rs,
                  *sg_len = a.sg_len + rs, *sg_lane0 = a.sg_lane0 + rs,
                  *sg_vsum = a.sg_vsum + rs;
    const uint8_t *sg_dense = a.sg_dense + rs, *sg_tsp = a.sg_tsp + rs,
                  *sg_valid = a.sg_valid + rs;
    uint8_t *o_va = a.o_va + rs, *o_tsp = a.o_tsp + rs, *o_gs = a.o_gs + rs,
            *o_expl = a.o_expl + rs, *o_surv = a.o_surv + rs;
    int32_t *o_len = a.o_len + rs, *o_lane0 = a.o_lane0 + rs,
            *o_grp = a.o_grp + rs;
    a1_i64 *qk = a.qk + rs, *gmax = a.gmax + rs, *gmin = a.gmin + rs;
    uint8_t* gfl = a.gfl + 4 * rs;
    const a1_i64 none_max = a1_key(-1, -1);  // a table's empty max

    // ---- pass 1: gathers, twins, groups, the group table, E1
    int carry_cnt = 0;                  // group starts before the tile
    a1_i64 carry_max = CAUSE_A1_KEY_MIN;  // max key before the tile
    // this tile's sorted words, loaded a tile ahead
    int n_src = 0, n_mh = 0, n_ml = 0;
    if (tid < S) {
        n_src = s_src[tid];
        n_mh = s_mh[tid];
        n_ml = s_ml[tid];
    }
    for (int t0 = 0; t0 < S; t0 += NT) {
        const int i = t0 + tid;
        const bool in = i < S;
        A1Seg s = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
        bool va = false, tsp = false, has_c = false;
        int lane0 = 0;
        const int src = a1_take(n_src, S);
        if (in) {
            s.mh = n_mh;
            s.ml = n_ml;
        }
        if (i + NT < S) {
            n_src = s_src[i + NT];
            n_mh = s_mh[i + NT];
            n_ml = s_ml[i + NT];
        }
        if (in) {
            s.Mh = sg_Mh[src];
            s.Ml = sg_Ml[src];
            va = sg_valid[src] != 0;
            s.len = va ? sg_len[src] : 0;
            lane0 = sg_lane0[src];
            const bool dense = sg_dense[src] != 0;
            tsp = sg_tsp[src] != 0;
            s.vsum = sg_vsum[src];
            const int l0 = a1_clamp(lane0, N);
            s.hvc = vc[l0];
            const int cl = cci[l0];
            has_c = va && cl >= 0;
            const int c = a1_clamp(cl, N);
            s.chi = has_c ? hi[c] : -1;
            s.clo = has_c ? lo[c] : -1;
            s.fl = (int)tsp | ((int)(dense && va) << 1);
        }
        if (lane == 31) sh.nb[warp + 1] = s;
        __syncthreads();
        A1Seg p = a1_shfl_up(s);
        if (lane == 0) p = sh.nb[warp];
        const bool start = in && !(i > 0 && a1_twins(s, p));
        const a1_i64 v = !in ? CAUSE_A1_KEY_MIN
                             : (va ? a1_key(s.Mh, s.Ml) : none_max);

        // block scans: starts (inclusive count) and max keys
        int c = start ? 1 : 0;
        a1_i64 m = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int yc = __shfl_up_sync(CAUSE_A1_FULL, c, d);
            const a1_i64 ym = __shfl_up_sync(CAUSE_A1_FULL, m, d);
            if (lane >= d) {
                c += yc;
                m = a1_max(m, ym);
            }
        }
        a1_i64 ex = __shfl_up_sync(CAUSE_A1_FULL, m, 1);
        if (lane == 0) ex = CAUSE_A1_KEY_MIN;
        if (lane == 31) {
            sh.wcnt[warp] = c;
            sh.wmax[warp] = m;
        }
        __syncthreads();
        int below_c = carry_cnt, tot_c = 0;
        a1_i64 below_m = carry_max, tot_m = CAUSE_A1_KEY_MIN;
#pragma unroll 4
        for (int w = 0; w < NT / 32; ++w) {
            const int wc = sh.wcnt[w];
            const a1_i64 wm = sh.wmax[w];
            if (w < warp) {
                below_c += wc;
                below_m = a1_max(below_m, wm);
            }
            tot_c += wc;
            tot_m = a1_max(tot_m, wm);
        }
        carry_cnt += tot_c;
        carry_max = a1_max(carry_max, tot_m);

        if (in) {
            const int grp = below_c + c - 1;
            o_va[i] = va;
            o_len[i] = s.len;
            o_lane0[i] = lane0;
            o_tsp[i] = tsp;
            o_grp[i] = grp;
            o_gs[i] = start;
            qk[i] = a1_key(s.chi, s.clo);
            o_expl[i] = has_c;  // read by pass 2, rewritten by pass 3
            if (start) {
                // what the groups before this one reach ((-1, -1) before
                // the first)
                const a1_i64 reach = i == 0 ? none_max : a1_max(below_m, ex);
                const a1_i64 mn = va ? a1_key(s.mh, s.ml) : CAUSE_A1_KEY_MAX;
                gmin[grp] = mn;
                gmax[grp] = va ? a1_key(s.Mh, s.Ml) : none_max;
                uint8_t* f = gfl + 4 * (size_t)grp;
                f[0] = va && mn <= reach;
                f[2] = 0;
                f[3] = tsp && s.len > 1;
                // the group before ends at i - 1: this group's min at or
                // below its max is an overlap
                if (i > 0) f[-3] = mn <= a1_key(p.Mh, p.Ml);
            }
            if (i == S - 1)
                gfl[4 * (size_t)grp + 1] =
                    a1_key(s.Mh, s.Ml) == CAUSE_A1_KEY_MAX;
        }
        // the tile's last segment precedes the next tile's first (every
        // read of nb[0] this tile came before the scan's barrier)
        if (tid == NT - 1) sh.nb[0] = s;
    }
    __syncthreads();

    // ---- the index: every k-th group min
    const int G = carry_cnt;
    const int k = (G + CAUSE_A1_SAMPLES - 1) / CAUSE_A1_SAMPLES;
    const int ns = (G + k - 1) / k;
    for (int j = tid; j < ns; j += NT) a1_index[j] = gmin[(size_t)j * k];
    __syncthreads();

    // ---- pass 2: E2, the head causes' stabs
    for (int i = tid; i < S; i += NT) {
        if (!o_expl[i]) continue;  // no head cause
        const a1_i64 q = qk[i];
        // (INT32_MAX, INT32_MAX) finds the row's last slot, which only a
        // row of S groups fills: elsewhere a (max, -1) slot stabs nothing
        if (q == CAUSE_A1_KEY_MAX && G < S) continue;
        // the count of samples at or below q, then of the mins between
        // the last such sample and the next: the count of group mins at
        // or below q, less one, is the rightmost group they allow
        int b = 0, n = ns;
        while (n > 0) {
            const int h = n >> 1;
            if (a1_index[b + h] <= q) {
                b += h + 1;
                n -= h + 1;
            } else {
                n = h;
            }
        }
        if (b == 0) continue;  // below every group min
        int base = (b - 1) * k + 1;
        n = min(b * k, G) - base;
        while (n > 0) {
            const int h = n >> 1;
            if (gmin[base + h] <= q) {
                base += h + 1;
                n -= h + 1;
            } else {
                n = h;
            }
        }
        const int pg = base - 1;
        const a1_i64 M = gmax[pg];
        if (q < M || (q == M && gfl[4 * (size_t)pg + 3]))
            gfl[4 * (size_t)pg + 2] = 1;
    }
    __syncthreads();

    // ---- pass 3: explode, survive
    for (int i = tid; i < S; i += NT) {
        const uint8_t* f = gfl + 4 * (size_t)o_grp[i];
        const bool ex = o_va[i] && (f[0] | f[1] | f[2]);
        o_expl[i] = ex;
        o_surv[i] = o_va[i] && !ex && o_gs[i];
    }
}

template <int NT>
static cudaError_t a1_launch(const A1Args& a, int B, cudaStream_t st) {
    const size_t dyn =
        8 * (size_t)(a.S < CAUSE_A1_SAMPLES ? a.S : CAUSE_A1_SAMPLES);
    seg_order_kernel<NT><<<B, NT, dyn, st>>>(a);
    return cudaGetLastError();
}

extern "C" {

// Bytes of the scratch one call of B rows of S segments takes: the
// causes' keys, the groups' mins and max keys (8 B a segment each) and
// the group flags (4 B).
long long cause_seg_order_scratch_bytes(int B, int S) {
    return (long long)B * S * 28;
}

// Phase A over B rows. hi, lo, cci, vc: [B, N] int32; s_mh, s_ml,
// s_src, sg_max_hi, sg_max_lo, sg_len, sg_lane0, sg_vsum: [B, S] int32;
// sg_dense, sg_tail_special, sg_valid: [B, S] bool; out: s_va, s_tsp,
// grp_start, explode, survive [B, S] bool, s_len, s_lane0, grp [B, S]
// int32; scratch: cause_seg_order_scratch_bytes(B, S) bytes, 8-byte
// aligned. All contiguous device tensors. Returns the cudaError_t of the
// launch.
int cause_seg_order(const void* hi, const void* lo, const void* cci,
                    const void* vc, const void* s_mh, const void* s_ml,
                    const void* s_src, const void* sg_max_hi,
                    const void* sg_max_lo, const void* sg_len,
                    const void* sg_lane0, const void* sg_dense,
                    const void* sg_tail_special, const void* sg_valid,
                    const void* sg_vsum, void* s_va, void* s_len,
                    void* s_lane0, void* s_tsp, void* grp, void* grp_start,
                    void* explode, void* survive, void* scratch, int B,
                    int N, int S, void* stream) {
    if (B < 0 || N < 1 || S < 1) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    A1Args a;
    a.hi = (const int32_t*)hi;
    a.lo = (const int32_t*)lo;
    a.cci = (const int32_t*)cci;
    a.vc = (const int32_t*)vc;
    a.s_mh = (const int32_t*)s_mh;
    a.s_ml = (const int32_t*)s_ml;
    a.s_src = (const int32_t*)s_src;
    a.sg_Mh = (const int32_t*)sg_max_hi;
    a.sg_Ml = (const int32_t*)sg_max_lo;
    a.sg_len = (const int32_t*)sg_len;
    a.sg_lane0 = (const int32_t*)sg_lane0;
    a.sg_vsum = (const int32_t*)sg_vsum;
    a.sg_dense = (const uint8_t*)sg_dense;
    a.sg_tsp = (const uint8_t*)sg_tail_special;
    a.sg_valid = (const uint8_t*)sg_valid;
    a.o_va = (uint8_t*)s_va;
    a.o_tsp = (uint8_t*)s_tsp;
    a.o_gs = (uint8_t*)grp_start;
    a.o_expl = (uint8_t*)explode;
    a.o_surv = (uint8_t*)survive;
    a.o_len = (int32_t*)s_len;
    a.o_lane0 = (int32_t*)s_lane0;
    a.o_grp = (int32_t*)grp;
    const size_t n = (size_t)B * S;
    a1_i64* words = (a1_i64*)scratch;
    a.qk = words;
    a.gmax = words + n;
    a.gmin = words + 2 * n;
    a.gfl = (uint8_t*)(words + 3 * n);
    a.N = N;
    a.S = S;
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(S <= CAUSE_A1_NARROW_S ? a1_launch<256>(a, B, st)
                                        : a1_launch<1024>(a, B, st));
}

}  // extern "C"
