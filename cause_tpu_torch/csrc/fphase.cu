// B3: the v5 F-phase lane expansion, one CTA of 128 threads per
// (row, 128-lane tile).
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
// the lane's offset from it, for valid lanes that are covered or carry a
// token (else N); vis[lane] = the lane is a visible value.
//
// Kept tokens sit on distinct lanes, so a 128-lane tile meets at most
// 128 of them: the tile's fill is found in the 128-token window that
// starts at the first token at or after the tile start (the window
// starts of pallas_fphase.py:280-286, found here by a binary search over
// the row), with the token just before the window as the carry. The same
// holds for the disjoint coverage segments. The Pallas kernel's MXU
// identity "flips" worked around Mosaic layouts and have no counterpart
// here. The ragged last tile is masked, so N needs no 128 multiple.
//
// What bounds it on the H100: bytes. Per row it reads lk, tb (U each),
// cs, ce (S each) and vc, seg, fl (N each) and writes rank (N int32)
// and vis (N bytes): 17N + 8U + 8S bytes, ~0.39 GB at the north-star
// wave (B = 1024, N = 20480, U = 4096, S = 512), ~0.12 ms at 3.35 TB/s.
// The per-lane work is two 7-step binary searches in shared memory.
//
// What the design does about it: every lane is read and written once
// with coalesced 128-thread accesses; the token and segment windows are
// staged in shared memory once per tile and searched there; the
// visibility pass is fused into the same thread, which reads lane + 1's
// class and segment straight from global memory (an L1/L2 hit, also
// across the tile edge), so rank never makes a round trip through HBM.

#include <cuda_runtime.h>
#include <stdint.h>

#define CAUSE_TILE 128

__device__ __forceinline__ int lower_bound_i32(const int32_t* a, int n,
                                               int32_t x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// index of the last window entry <= x, or -1
__device__ __forceinline__ int last_le(const int32_t* w, int32_t x) {
    int lo = 0, hi = CAUSE_TILE;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (w[mid] <= x) lo = mid + 1; else hi = mid;
    }
    return lo - 1;
}

__global__ void fphase_kernel(const int32_t* __restrict__ lk,
                              const int32_t* __restrict__ tb,
                              const int32_t* __restrict__ cs,
                              const int32_t* __restrict__ ce,
                              const int32_t* __restrict__ vc,
                              const int32_t* __restrict__ seg,
                              const int32_t* __restrict__ fl,
                              int32_t* __restrict__ rank,
                              uint8_t* __restrict__ vis,
                              int N, int U, int S, int T) {
    __shared__ int32_t w_lk[CAUSE_TILE], w_tb[CAUSE_TILE];
    __shared__ int32_t w_cs[CAUSE_TILE], w_ce[CAUSE_TILE];
    __shared__ int c0[2];
    const long long bid = blockIdx.x;
    const int r = (int)(bid / T);
    const int t = (int)(bid % T);
    const int tile0 = t * CAUSE_TILE;
    const int32_t* lk_r = lk + (size_t)r * U;
    const int32_t* tb_r = tb + (size_t)r * U;
    const int32_t* cs_r = cs + (size_t)r * S;
    const int32_t* ce_r = ce + (size_t)r * S;
    const size_t row_n = (size_t)r * N;

    if (threadIdx.x == 0) c0[0] = lower_bound_i32(lk_r, U, tile0);
    if (threadIdx.x == 32) c0[1] = lower_bound_i32(cs_r, S, tile0);
    __syncthreads();
    const int c0t = c0[0];
    const int c0s = c0[1];
    int ws = c0t < U - CAUSE_TILE ? c0t : U - CAUSE_TILE;
    if (ws < 0) ws = 0;
    int ss = c0s < S - CAUSE_TILE ? c0s : S - CAUSE_TILE;
    if (ss < 0) ss = 0;
    const int j = threadIdx.x;
    w_lk[j] = ws + j < U ? lk_r[ws + j] : INT32_MAX;
    w_tb[j] = ws + j < U ? tb_r[ws + j] : 0;
    w_cs[j] = ss + j < S ? cs_r[ss + j] : INT32_MAX;
    w_ce[j] = ss + j < S ? ce_r[ss + j] : 0;
    __syncthreads();

    const int lane = tile0 + j;
    if (lane >= N) return;

    // token fill: the last kept token at or before this lane
    const int jm = last_le(w_lk, lane);
    const bool found = jm >= 0;
    const int32_t base_f = found ? w_tb[jm] : (c0t > 0 ? tb_r[c0t - 1] : 0);
    const int32_t lane_f = found ? w_lk[jm] : (c0t > 0 ? lk_r[c0t - 1] : 0);
    const bool has_tok = found && w_lk[jm] == lane;

    // coverage: the last surviving segment starting at or before the lane
    const int js = last_le(w_cs, lane);
    const int32_t end = js >= 0 ? w_ce[js] : (c0s > 0 ? ce_r[c0s - 1] : 0);
    const bool in_surv = end > lane;

    const int32_t f = fl[row_n + lane];
    const bool valid = (f & 1) != 0;
    const bool killed_ext = (f & 2) != 0;
    const int32_t rk = (valid && (in_surv || has_tok))
                           ? base_f + (lane - lane_f) : N;
    rank[row_n + lane] = rk;

    // visibility: own class, outside kills, and a tombstone in the next
    // lane of the same covered segment
    const int32_t v = vc[row_n + lane];
    bool kill_in = false;
    if (in_surv && lane + 1 < N) {
        const int32_t s0 = seg[row_n + lane];
        const int32_t s1 = seg[row_n + lane + 1];
        const int32_t v1 = vc[row_n + lane + 1];
        kill_in = s1 == s0 && s0 >= 0 && (v1 == 1 || v1 == 2);
    }
    vis[row_n + lane] =
        (valid && rk < N && v == 0 && !killed_ext && !kill_in) ? 1 : 0;
}

extern "C" {

// Expand B rows. lk, tb: [B, U]; cs, ce: [B, S]; vc, seg, fl, rank,
// vis: [B, N]; all contiguous device tensors, int32 but for vis, which
// is a torch.bool (one byte per lane, 0 or 1). Returns the
// cudaError_t of the launch.
int cause_fphase_expand(const void* lk, const void* tb, const void* cs,
                        const void* ce, const void* vc, const void* seg,
                        const void* fl, void* rank, void* vis, int B, int N,
                        int U, int S, void* stream) {
    if (B < 0 || N < 0 || U < 1 || S < 1) return (int)cudaErrorInvalidValue;
    if (B == 0 || N == 0) return (int)cudaSuccess;
    const int T = (N + CAUSE_TILE - 1) / CAUSE_TILE;
    const long long blocks = (long long)B * T;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fphase_kernel<<<(unsigned)blocks, CAUSE_TILE, 0, (cudaStream_t)stream>>>(
        (const int32_t*)lk, (const int32_t*)tb, (const int32_t*)cs,
        (const int32_t*)ce, (const int32_t*)vc, (const int32_t*)seg,
        (const int32_t*)fl, (int32_t*)rank, (uint8_t*)vis, N, U, S, T);
    return (int)cudaGetLastError();
}

}  // extern "C"
