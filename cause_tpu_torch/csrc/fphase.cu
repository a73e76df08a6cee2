// B3: the v5 F-phase lane expansion, one CTA of 256 threads per row,
// walking the row in tiles of 1024 lanes.
//
// Replaces the Pallas kernel of cause_tpu/weaver/pallas_fphase.py
// (`_kernel`, launched by the pallas_call at :211 behind
// `fphase_expand`, :241). Contract, per row: `lk`/`tb` are the
// lane-sorted kept-token lanes (N past the kept prefix) and their token
// bases, `cs`/`ce` the sorted surviving-segment coverage table (start
// ascending; sentinel entries start = N, end = 0), `vc`/`seg` the
// per-lane value class and segment ordinal, `fl` bit 0 = lane valid and
// bit 1 = killed from outside (token kills and the root lane). Out:
// rank[lane] = base of the last kept token at or before the lane plus
// the lane's offset from it (base 0 and lane 0 when there is none), for
// valid lanes that are covered or carry a token (else N); vis[lane] = the
// lane is a visible value. Inputs keep the invariants of
// pallas_fphase.py:14-26: kept-token lanes are distinct and ascending,
// coverage segments disjoint with ascending starts.
//
// What bounds it on the H100: bytes. Per row it reads lk, tb (U each),
// cs, ce (S each) and vc, seg, fl (N each) and writes rank (N int32)
// and vis (N bytes): 17N + 8U + 8S bytes, ~0.39 GB at the north-star
// wave (B = 1024, N = 20480, U = 4096, S = 512), ~0.12 ms at 3.35 TB/s.
//
// The row is one CTA, so where a tile's tokens and segments begin is
// carried from the tile before, not searched for in global memory:
// - tokens are consumed in order by a pointer that only moves forward:
//   a tile takes the next 256 tokens at the pointer, scatters each one
//   that falls in the tile into a 1024-slot shared table at lk - tile0
//   (its base, and a mark byte), and advances by the block's count of
//   them (warp ballots, one barrier; lanes are distinct, so at most 1024
//   tokens fall in a tile, and a tile with more than 256 loads again).
//   Coverage starts take the same path with their ends;
// - a max-scan over the marked slots (4 a thread in registers, a warp
//   shuffle scan, one barrier for the warps' maxima), seeded with the
//   carry, gives each lane its last token and last segment: the carry
//   is the last token before the tile (lane, base) and the end of the
//   last segment that starts before it, (0, 0) and 0 at the row's start;
// - nothing on a tile's path waits for a load issued in that tile: once
//   the pointers have moved, the next tile's vc, seg and fl (16 bytes a
//   thread and array when N % 4 == 0) and its first 256 tokens and
//   segments are copied into shared memory with cp.async while this
//   tile is scanned and written. Every thread copies and reads back
//   only its own words, so the copies need no barrier of their own;
// - the lanes are read once; rank goes out as int4 and vis as one 32-bit
//   word of four flags;
// - lane + 1's class and segment come from the thread's own next lane,
//   a shuffle, one word pair per warp in shared memory, and, for the
//   tile's last lane, the next tile's first lane: its thread holds its
//   flag word until that lane is staged (no second global read).
// The ragged last tile is masked, so N needs no multiple of anything.
// 1024 rows are one wave at 8 CTAs an SM (27 KB of shared memory each).
//
// That "row" form walks a row's tiles in turn, so a call with few wide
// rows leaves most SMs idle (10,240 tiles in one CTA at the fleet row).
// The "chunk" form gives each CTA a (row, chunk): a run of
// CAUSE_F_CHUNK_TILES tiles. Its start pointers are what the Pallas
// kernel computes per window (`tw0`, `sw0`): p0 = the count of kept
// tokens before the chunk's first lane and q0 the count of segment
// starts before it, found by a 256-ary search of the sorted lk and cs
// (a load a thread and a block count a round: three rounds for a
// million entries). The carry is seeded from them, (lk, tb)[p0 - 1] or
// (0, 0) and ce[q0 - 1] or 0, and the tile loop runs over the chunk
// alone. The chunk's last lane reads lane + 1's class and segment from
// global memory in place of the held word, so a kill across a chunk
// edge comes out as across a tile edge. The row form is the chunk form
// with one chunk a row. The caller picks the form (weaver/fphase.py's
// fphase_form).

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attrs.cuh"

#define CAUSE_F_THREADS 256
#define CAUSE_F_ITEMS 4
#define CAUSE_F_TILE (CAUSE_F_THREADS * CAUSE_F_ITEMS)
#define CAUSE_F_WARPS (CAUSE_F_THREADS / 32)
#define CAUSE_F_MIN_CTAS 8
#define CAUSE_F_FULL 0xffffffffu
// the chunk form's tiles a chunk (weaver/fphase.py's F_CHUNK_TILES; a
// -D build may set another, as chip_smoke.py --forms does)
#ifndef CAUSE_F_CHUNK_TILES
#define CAUSE_F_CHUNK_TILES 4
#endif

__device__ __forceinline__ void f_cp16(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void f_cp4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ bool f_hideish(int32_t v) {
    return v == 1 || v == 2;  // VCLASS_HIDE, VCLASS_H_HIDE
}

// The shared memory of one CTA.
struct FShared {
    int32_t lanes[3][CAUSE_F_TILE];      // vc, seg, fl of the next tile
    int32_t chunk[4][CAUSE_F_THREADS];   // lk, tb at p; cs, ce at q
    int32_t tbase[CAUSE_F_TILE];         // base of the token at a slot
    int32_t cend[CAUSE_F_TILE];          // end of the segment at a slot
    uint32_t tmark[CAUSE_F_THREADS];     // a byte a slot
    uint32_t cmark[CAUSE_F_THREADS];
    int32_t cnt[2][2][CAUSE_F_WARPS];    // chunk counts, by iteration parity
    int32_t wmax[2][CAUSE_F_WARPS];      // warps' slot maxima
    int32_t edge[2][CAUSE_F_WARPS];      // warps' first vc, seg
};

// Copy this thread's words of the tile at t0 (its four lanes of vc, seg
// and fl; lanes past N are left alone) and of the chunks at the pointers
// (token p + tid, segment q + tid, where in range) into shared memory.
template <bool VEC>
__device__ __forceinline__ void f_prefetch(FShared& sh, const int32_t* vc_r,
                                           const int32_t* seg_r,
                                           const int32_t* fl_r,
                                           const int32_t* lk_r,
                                           const int32_t* tb_r,
                                           const int32_t* cs_r,
                                           const int32_t* ce_r, int t0,
                                           int N, int p, int U, int q,
                                           int S) {
    const int tid = threadIdx.x;
    const int k0 = tid * CAUSE_F_ITEMS;
    const int l0 = t0 + k0;
    if (VEC) {
        if (l0 < N) {  // N % 4 == 0: all four lanes are in the row
            f_cp16(&sh.lanes[0][k0], vc_r + l0);
            f_cp16(&sh.lanes[1][k0], seg_r + l0);
            f_cp16(&sh.lanes[2][k0], fl_r + l0);
        }
    } else {
#pragma unroll
        for (int k = 0; k < CAUSE_F_ITEMS; ++k) {
            if (l0 + k < N) {
                f_cp4(&sh.lanes[0][k0 + k], vc_r + l0 + k);
                f_cp4(&sh.lanes[1][k0 + k], seg_r + l0 + k);
                f_cp4(&sh.lanes[2][k0 + k], fl_r + l0 + k);
            }
        }
    }
    if (p + tid < U) {
        f_cp4(&sh.chunk[0][tid], lk_r + p + tid);
        f_cp4(&sh.chunk[1][tid], tb_r + p + tid);
    }
    if (q + tid < S) {
        f_cp4(&sh.chunk[2][tid], cs_r + q + tid);
        f_cp4(&sh.chunk[3][tid], ce_r + q + tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Exclusive max-scan of x over the warp (-1 below lane 0); *incl gets
// the warp's inclusive maximum.
__device__ __forceinline__ int32_t f_warp_excl_max(int32_t x, int32_t* incl) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(CAUSE_F_FULL, x, d);
        if (lane >= d) x = x > y ? x : y;
    }
    *incl = __shfl_sync(CAUSE_F_FULL, x, 31);
    const int32_t ex = __shfl_up_sync(CAUSE_F_FULL, x, 1);
    return lane == 0 ? -1 : ex;
}

// the last of this thread's four slots that `marks` (a byte a slot)
// marks, else `below`
__device__ __forceinline__ int32_t f_last_mark(uint32_t marks, int k0,
                                               int32_t below) {
#pragma unroll
    for (int k = 0; k < CAUSE_F_ITEMS; ++k)
        if ((marks >> (8 * k)) & 0xffu) below = k0 + k;
    return below;
}

// The counts of entries below x in the ascending a[0, n) and c[0, m),
// by the whole block: each round samples 256 evenly spaced entries of
// what is left, and the block's count of those below x narrows it to
// one gap between samples.
__device__ __forceinline__ void f_count_below(const int32_t* a, int n,
                                              const int32_t* c, int m,
                                              int32_t x, int* pa, int* pc) {
    int lo_a = 0, hi_a = n, lo_c = 0, hi_c = m;
    while (lo_a < hi_a || lo_c < hi_c) {  // the same bounds in every thread
        const int sa = (hi_a - lo_a + CAUSE_F_THREADS - 1) / CAUSE_F_THREADS;
        const int sc = (hi_c - lo_c + CAUSE_F_THREADS - 1) / CAUSE_F_THREADS;
        const int ia = lo_a + (int)threadIdx.x * sa;
        const int ic = lo_c + (int)threadIdx.x * sc;
        const int na = __syncthreads_count(ia < hi_a && a[ia] < x);
        const int nc = __syncthreads_count(ic < hi_c && c[ic] < x);
        // the answer lies past the last sample below x, and at or before
        // the first sample that is not
        if (lo_a < hi_a) {
            const int top = min(lo_a + na * sa, hi_a);
            lo_a = na ? lo_a + (na - 1) * sa + 1 : lo_a;
            hi_a = na ? top : lo_a;
        }
        if (lo_c < hi_c) {
            const int top = min(lo_c + nc * sc, hi_c);
            lo_c = nc ? lo_c + (nc - 1) * sc + 1 : lo_c;
            hi_c = nc ? top : lo_c;
        }
    }
    *pa = lo_a;
    *pc = lo_c;
}

// CHUNKED: blockIdx.x = row * chunks + chunk, a chunk `chunk_tiles`
// tiles; else blockIdx.x is the row (the row form compiles as before)
template <bool VEC, bool CHUNKED>
__global__ void __launch_bounds__(CAUSE_F_THREADS, CAUSE_F_MIN_CTAS)
fphase_row_kernel(const int32_t* __restrict__ lk,
                  const int32_t* __restrict__ tb,
                  const int32_t* __restrict__ cs,
                  const int32_t* __restrict__ ce,
                  const int32_t* __restrict__ vc,
                  const int32_t* __restrict__ seg,
                  const int32_t* __restrict__ fl,
                  int32_t* __restrict__ rank, uint8_t* __restrict__ vis,
                  int N, int U, int S, int chunk_tiles, int chunks) {
    __shared__ __align__(16) FShared sh;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int k0 = tid * CAUSE_F_ITEMS;
    const int row = CHUNKED ? blockIdx.x / chunks : blockIdx.x;
    const int t_first =
        CHUNKED ? (blockIdx.x - row * chunks) * chunk_tiles : 0;
    const size_t rn = (size_t)row * (size_t)N;
    const int32_t* lk_r = lk + (size_t)row * U;
    const int32_t* tb_r = tb + (size_t)row * U;
    const int32_t* cs_r = cs + (size_t)row * S;
    const int32_t* ce_r = ce + (size_t)row * S;
    const int32_t* vc_r = vc + rn;
    const int32_t* seg_r = seg + rn;
    const int32_t* fl_r = fl + rn;

    sh.tmark[tid] = 0;
    sh.cmark[tid] = 0;
    int32_t carry_lane = 0, carry_base = 0, carry_end = 0;
    int p = 0, q = 0;  // the next token and the next coverage segment
    if (CHUNKED && t_first > 0) {
        // a later chunk: the pointers and the carry at its first lane
        f_count_below(lk_r, U, cs_r, S, t_first * CAUSE_F_TILE, &p, &q);
        if (p > 0) {
            carry_lane = lk_r[p - 1];
            carry_base = tb_r[p - 1];
        }
        if (q > 0) carry_end = ce_r[q - 1];
    }
    int par = 0;       // parity of the chunk iteration
    // the last thread's flag word of the tile before, held until the next
    // tile's first lane is known: the word, whether its last lane is
    // covered, and that lane's segment
    uint32_t held = 0;
    bool held_cov = false;
    int32_t held_seg = 0;
    const int T = (N + CAUSE_F_TILE - 1) / CAUSE_F_TILE;
    const int t_end = CHUNKED ? min(T, t_first + chunk_tiles) : T;
    f_prefetch<VEC>(sh, vc_r, seg_r, fl_r, lk_r, tb_r, cs_r, ce_r,
                    t_first * CAUSE_F_TILE, N, p, U, q, S);
    __syncthreads();  // the marks are clear before any thread sets one

    for (int t = t_first; t < t_end; ++t) {
        const int t0 = t * CAUSE_F_TILE;
        const int tend = min(t0 + CAUSE_F_TILE, N);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        const int4 v = *(const int4*)&sh.lanes[0][k0];
        const int4 sg = *(const int4*)&sh.lanes[1][k0];
        const int4 f = *(const int4*)&sh.lanes[2][k0];

        // tokens and segment starts in the tile, into their slots: the
        // first chunk of each from the prefetch, any further one loaded
        bool more_t = true, more_c = true;
        for (int it = 0; more_t || more_c; ++it) {
            bool in_t = false, in_c = false;
            if (more_t) {
                const int i = p + tid;
                int32_t l = INT32_MAX, b = 0;
                if (i < U) {
                    l = it == 0 ? sh.chunk[0][tid] : lk_r[i];
                    b = it == 0 ? sh.chunk[1][tid] : tb_r[i];
                }
                in_t = l < tend;
                if (in_t && l >= t0) {
                    sh.tbase[l - t0] = b;
                    ((uint8_t*)sh.tmark)[l - t0] = 1;
                }
            }
            if (more_c) {
                const int i = q + tid;
                int32_t s = INT32_MAX, e = 0;
                if (i < S) {
                    s = it == 0 ? sh.chunk[2][tid] : cs_r[i];
                    e = it == 0 ? sh.chunk[3][tid] : ce_r[i];
                }
                in_c = s < tend;
                if (in_c && s >= t0) {
                    sh.cend[s - t0] = e;
                    ((uint8_t*)sh.cmark)[s - t0] = 1;
                }
            }
            const unsigned bt = __ballot_sync(CAUSE_F_FULL, in_t);
            const unsigned bc = __ballot_sync(CAUSE_F_FULL, in_c);
            if (lane == 0) {
                sh.cnt[par][0][warp] = __popc(bt);
                sh.cnt[par][1][warp] = __popc(bc);
            }
            __syncthreads();
            int nt = 0, nc = 0;
#pragma unroll
            for (int w = 0; w < CAUSE_F_WARPS; ++w) {
                nt += sh.cnt[par][0][w];
                nc += sh.cnt[par][1][w];
            }
            par ^= 1;
            p += nt;
            q += nc;
            more_t = more_t && nt == CAUSE_F_THREADS;
            more_c = more_c && nc == CAUSE_F_THREADS;
        }
        // past a barrier, this thread's reads of its staged words are
        // done: stage the next tile and the chunks at the new pointers
        if (t + 1 < t_end)
            f_prefetch<VEC>(sh, vc_r, seg_r, fl_r, lk_r, tb_r, cs_r, ce_r,
                            t0 + CAUSE_F_TILE, N, p, U, q, S);

        // the scans of the slots
        const uint32_t tm = sh.tmark[tid], cm = sh.cmark[tid];
        sh.tmark[tid] = 0;
        sh.cmark[tid] = 0;
        int32_t wt, wc;
        const int32_t et = f_warp_excl_max(f_last_mark(tm, k0, -1), &wt);
        const int32_t ec = f_warp_excl_max(f_last_mark(cm, k0, -1), &wc);
        if (lane == 0) {
            sh.wmax[0][warp] = wt;
            sh.wmax[1][warp] = wc;
            sh.edge[0][warp] = v.x;
            sh.edge[1][warp] = sg.x;
        }
        __syncthreads();
        int32_t st = et, sc = ec, tot_t = -1, tot_c = -1;
#pragma unroll
        for (int w = 0; w < CAUSE_F_WARPS; ++w) {
            if (w < warp) {
                st = max(st, sh.wmax[0][w]);
                sc = max(sc, sh.wmax[1][w]);
            }
            tot_t = max(tot_t, sh.wmax[0][w]);
            tot_c = max(tot_c, sh.wmax[1][w]);
        }

        // the held word of the tile before: its last lane's next lane is
        // this tile's first
        if (tid == CAUSE_F_THREADS - 1 && t > t_first) {
            if (held_cov && held_seg >= 0 && sh.edge[1][0] == held_seg &&
                f_hideish(sh.edge[0][0]))
                held &= 0x00ffffffu;
            uint8_t* out = vis + rn + t0 - CAUSE_F_ITEMS;
            if (VEC) {
                *(uint32_t*)out = held;
            } else {
#pragma unroll
                for (int k = 0; k < CAUSE_F_ITEMS; ++k)
                    out[k] = (uint8_t)((held >> (8 * k)) & 1u);
            }
        }

        // lane + 1's class and segment; past the chunk's last lane, from
        // global memory (a chunk ends on a whole tile)
        const int32_t nv = __shfl_down_sync(CAUSE_F_FULL, v.x, 1);
        const int32_t ns = __shfl_down_sync(CAUSE_F_FULL, sg.x, 1);
        const bool last_w = warp == CAUSE_F_WARPS - 1;
        int32_t edge_v = 0, edge_s = -1;
        if (CHUNKED && tid == CAUSE_F_THREADS - 1 && t + 1 == t_end &&
            t_end < T) {
            edge_v = vc_r[t0 + CAUSE_F_TILE];
            edge_s = seg_r[t0 + CAUSE_F_TILE];
        }
        const int32_t vv[CAUSE_F_ITEMS + 1] = {
            v.x, v.y, v.z, v.w,
            lane < 31 ? nv : (last_w ? edge_v : sh.edge[0][warp + 1])};
        const int32_t ss[CAUSE_F_ITEMS + 1] = {
            sg.x, sg.y, sg.z, sg.w,
            lane < 31 ? ns : (last_w ? edge_s : sh.edge[1][warp + 1])};
        const int32_t ff[CAUSE_F_ITEMS] = {f.x, f.y, f.z, f.w};
        // the tile's last lane waits for the chunk's next tile (held
        // above)
        const bool holds = tid == CAUSE_F_THREADS - 1 && t + 1 < t_end;

        int32_t rk[CAUSE_F_ITEMS];
        uint32_t word = 0;
        bool cov_last = false;
#pragma unroll
        for (int k = 0; k < CAUSE_F_ITEMS; ++k) {
            const int ln = t0 + k0 + k;
            const bool has_tok = (tm >> (8 * k)) & 0xffu;
            if (has_tok) st = k0 + k;
            if ((cm >> (8 * k)) & 0xffu) sc = k0 + k;
            const int32_t lane_f = st >= 0 ? t0 + st : carry_lane;
            const int32_t base_f = st >= 0 ? sh.tbase[st] : carry_base;
            const int32_t end = sc >= 0 ? sh.cend[sc] : carry_end;
            const bool in_surv = end > ln;
            const bool valid = (ff[k] & 1) != 0;
            const bool killed_ext = (ff[k] & 2) != 0;
            rk[k] = (valid && (in_surv || has_tok)) ? base_f + (ln - lane_f) : N;
            const bool kill_in = in_surv && ln + 1 < N && ss[k] >= 0 &&
                                 ss[k + 1] == ss[k] && f_hideish(vv[k + 1]) &&
                                 !(holds && k == CAUSE_F_ITEMS - 1);
            const bool visible =
                valid && rk[k] < N && vv[k] == 0 && !killed_ext && !kill_in;
            word |= (visible ? 1u : 0u) << (8 * k);
            cov_last = in_surv;
        }
        if (holds) {
            held = word;
            held_cov = cov_last;
            held_seg = sg.w;
        }
        if (VEC) {
            if (t0 + k0 < N) {
                *(int4*)(rank + rn + t0 + k0) =
                    make_int4(rk[0], rk[1], rk[2], rk[3]);
                if (!holds) *(uint32_t*)(vis + rn + t0 + k0) = word;
            }
        } else {
#pragma unroll
            for (int k = 0; k < CAUSE_F_ITEMS; ++k) {
                const int ln = t0 + k0 + k;
                if (ln < N) rank[rn + ln] = rk[k];
                if (ln < N && !holds)
                    vis[rn + ln] = (uint8_t)((word >> (8 * k)) & 1u);
            }
        }

        // carry: the tile's last token and last segment
        if (tot_t >= 0) {
            carry_lane = t0 + tot_t;
            carry_base = sh.tbase[tot_t];
        }
        if (tot_c >= 0) carry_end = sh.cend[tot_c];
        __syncthreads();  // slot tables, maxima and edges are rewritten next
    }
}

// Let the kernel take the whole carveout as shared memory, which 8 CTAs
// an SM need (once per device and process).
template <bool VEC, bool CHUNKED>
static cudaError_t fphase_attrs() {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    auto kernel = fphase_row_kernel<VEC, CHUNKED>;
    return smem_attrs_once(kernel, ready);
}

template <bool VEC, bool CHUNKED>
static cudaError_t fphase_launch(const void* lk, const void* tb,
                                 const void* cs, const void* ce,
                                 const void* vc, const void* seg,
                                 const void* fl, void* rank, void* vis,
                                 int N, int U, int S, int chunk_tiles,
                                 int chunks, int grid, cudaStream_t st) {
    const cudaError_t e = fphase_attrs<VEC, CHUNKED>();
    if (e != cudaSuccess) return e;
    fphase_row_kernel<VEC, CHUNKED><<<grid, CAUSE_F_THREADS, 0, st>>>(
        (const int32_t*)lk, (const int32_t*)tb, (const int32_t*)cs,
        (const int32_t*)ce, (const int32_t*)vc, (const int32_t*)seg,
        (const int32_t*)fl, (int32_t*)rank, (uint8_t*)vis, N, U, S,
        chunk_tiles, chunks);
    return cudaGetLastError();
}

typedef cudaError_t (*FPhaseLaunch)(const void*, const void*, const void*,
                                    const void*, const void*, const void*,
                                    const void*, void*, void*, int, int, int,
                                    int, int, int, cudaStream_t);

extern "C" {

// CTAs of the kernel an SM holds (-1: a CUDA error).
int cause_fphase_ctas_per_sm(void) {
    int n = 0;
    if (fphase_attrs<true, false>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, fphase_row_kernel<true, false>, CAUSE_F_THREADS, 0) !=
            cudaSuccess)
        return -1;
    return n;
}

// Expand B rows. lk, tb: [B, U]; cs, ce: [B, S]; vc, seg, fl, rank,
// vis: [B, N]; all contiguous device tensors, int32 but for vis, which
// is a torch.bool (one byte per lane, 0 or 1). `chunked` picks the
// form: 0 the row form, 1 the chunk form (chunks of CAUSE_F_CHUNK_TILES
// tiles). Returns the cudaError_t of the launch.
int cause_fphase_expand(const void* lk, const void* tb, const void* cs,
                        const void* ce, const void* vc, const void* seg,
                        const void* fl, void* rank, void* vis, int B, int N,
                        int U, int S, int chunked, void* stream) {
    if (B < 0 || N < 0 || U < 1 || S < 1 || (chunked != 0 && chunked != 1))
        return (int)cudaErrorInvalidValue;
    if (B == 0 || N == 0) return (int)cudaSuccess;
    const int T = (N + CAUSE_F_TILE - 1) / CAUSE_F_TILE;
    const int chunk_tiles =
        chunked && CAUSE_F_CHUNK_TILES < T ? CAUSE_F_CHUNK_TILES : T;
    const int chunks = (T + chunk_tiles - 1) / chunk_tiles;
    if ((long long)B * chunks > INT32_MAX) return (int)cudaErrorInvalidValue;
    const int grid = B * chunks;
    // 16-byte lane copies and stores: every row starts 16-byte aligned
    const bool vec = N % 4 == 0 &&
                     ((uintptr_t)vc | (uintptr_t)seg | (uintptr_t)fl |
                      (uintptr_t)rank) % 16 == 0 &&
                     (uintptr_t)vis % 4 == 0;
    const cudaStream_t st = (cudaStream_t)stream;
    FPhaseLaunch launch = fphase_launch<false, false>;
    if (vec && chunks > 1) launch = fphase_launch<true, true>;
    else if (vec) launch = fphase_launch<true, false>;
    else if (chunks > 1) launch = fphase_launch<false, true>;
    return (int)launch(lk, tb, cs, ce, vc, seg, fl, rank, vis, N, U, S,
                       chunk_tiles, chunks, grid, st);
}

}  // extern "C"
