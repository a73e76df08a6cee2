// K4: run-base expansion, token kills and the lane-sort handoff of the
// fused v5 token pipeline, one CTA per replica row.
//
// Replaces the Pallas kernel of cause_tpu/weaver/pallas_befuse.py
// (`_build_k4`, pallas_call at :656 behind `k4_rank_kills`, :712; the
// row is `row_k4`, :426). Contract, per row: each kept token's rank is
// its run's base (the B2 walk's output, read at its run id clamped to
// [0, Kp)) plus its weighted offset from the run head; in-run kills
// (a glued tombstone kills the previous kept token's tail lane); the
// preorder successor of each valid run (the run with the next larger
// base: a stable sort of the bases); tail kills (a successor head that
// is a tombstone caused by this run's tail token); and the lane sort
// (kept-token lane, N elsewhere; stable) that hands (lk, tb_l) to B3.
// Out: lk, tb_l, vict_inrun [P]; vict_tail [Kp]; scal = [root_val,
// overflow_k]. The run->token expansion reads base_run at the clamped
// run id, as row_k4's standalone form does; the Pallas kernel's window
// form differs from it only on overflow rows, whose values the
// reference leaves unspecified.
//
// What it keeps out of device memory: eleven inputs read once ([Kp] x 3,
// [P] x 8), four outputs written once (about 0.24 GB and 0.07 ms at the
// north star, B = 1024, P = Kp = 4096, at 3.35 TB/s). In truth it is
// bound by its two in-block sorts (the successor sort over Kp and the
// lane sort over P, 78 network stages each at 4096).
//
// What the design does about it (against the Pallas kernel's windowed
// one-hot expansion, one-hot gathers and inverse-sort rides):
// - base_ff / hw_ff are direct reads at run_id;
// - the successor is one 1-key sort over Kp (B1's network) and a scatter
//   (the sorted positions are a permutation), not a second sort;
// - the lane sort is one 1-key sort over P; tb_l is gathered by position;
// - the remaining gathers are row-local reads.
// Shared memory: three [P] arrays and one sort area (two padded columns
// of P), 83 KB at P = Kp = 4096; wider rows run on a global scratch row.

#include "befuse.cuh"

struct K4Args {
    const int32_t* base_run;
    const int32_t* hc;
    const int32_t* h_w;
    const int32_t* run_id;
    const int32_t* keep;
    const int32_t* sv_len;
    const int32_t* sv_vc;
    const int32_t* sv_lane;
    const int32_t* glued;
    const int32_t* prev_kept;
    const int32_t* cause_su;
    const int32_t* scal2;
    int32_t* lk;
    int32_t* tb_l;
    int32_t* vict_inrun;
    int32_t* vict_tail;
    int32_t* scal;
};

__host__ __device__ __forceinline__ int k4_words(int P) {
    return 3 * P + bf_sort_words(1, P);
}

__device__ __forceinline__ bool hideish(int32_t vc) {
    return vc == 1 || vc == 2;  // VCLASS_HIDE, VCLASS_H_HIDE
}

__global__ void __launch_bounds__(CAUSE_BF_MAX_THREADS)
k4_kernel(K4Args a, int P, int Kp, int U, int k_max, int N,
          int32_t* scratch, int in_smem) {
    extern __shared__ int32_t smem[];
    __shared__ int32_t red[32];
    const size_t row = (size_t)blockIdx.x * (size_t)P;
    const size_t krow = (size_t)blockIdx.x * (size_t)Kp;
    int32_t* ws = in_smem
        ? smem : scratch + (size_t)blockIdx.x * (size_t)k4_words(P);
    int32_t* wcum = ws;         // kept-length prefix sum
    int32_t* rank = wcum + P;   // rank_tok
    int32_t* succ = rank + P;   // succ_of [Kp]
    int32_t* area = succ + P;
    const int32_t n_runs = a.scal2[(size_t)blockIdx.x * 8 + 0];
    const int32_t sp_last = a.scal2[(size_t)blockIdx.x * 8 + 2];
    const int n_valid = n_runs < k_max ? n_runs : k_max;

    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        wcum[i] = a.keep[row + i] != 0 ? a.sv_len[row + i] : 0;
    }
    // the successor sort's keys: valid runs' bases, int32 max elsewhere
    const SortArea sk = sort_area<1>(area, Kp, in_smem);
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
        sk.col(0)[sk.at(k)] = k + 1 <= n_valid ? a.base_run[krow + k]
                                               : CAUSE_BF_BIG;
        sk.pos[sk.at(k)] = k;
    }
    __syncthreads();
    block_scan<OpSum>(wcum, P, red);

    // ranks and in-run kills
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const bool keep = a.keep[row + i] != 0;
        const int32_t len = a.sv_len[row + i];
        const int rid = clampi(a.run_id[row + i], 0, Kp - 1);
        const int32_t wstart = wcum[i] - (keep ? len : 0);
        rank[i] = keep ? a.base_run[krow + rid] + (wstart - a.h_w[krow + rid])
                       : N;
        int32_t vict = N;
        if (a.glued[row + i] != 0 && hideish(a.sv_vc[row + i])) {
            const int pk = clampi(a.prev_kept[row + i], 0, U - 1);
            vict = a.sv_lane[row + pk] + a.sv_len[row + pk] - 1;
        }
        a.vict_inrun[row + i] = vict;
    }
    row_sort<1>(sk);

    // successor of the run at sorted slot j is the run at slot j + 1
    for (int j = threadIdx.x; j < Kp; j += blockDim.x) {
        const bool nxt = j < Kp - 1 && sk.col(0)[sk.at(j + 1)] != CAUSE_BF_BIG;
        succ[sk.pos[sk.at(j)]] = nxt ? sk.pos[sk.at(j + 1)] : -1;
    }
    __syncthreads();

    // tail kills; then the lane sort's keys into the (free) sort area
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
        const bool r_valid = k + 1 <= n_valid;
        const int32_t succ_run = r_valid ? succ[k] : -1;
        const int s_c = clampi(
            succ_run >= 0 ? a.hc[krow + clampi(succ_run, 0, Kp - 1)] : 0, 0,
            U - 1);
        const bool s_is_hide = succ_run >= 0 && hideish(a.sv_vc[row + s_c]);
        const int32_t g_cause = a.cause_su[row + s_c];
        const int32_t nxt_head = a.hc[krow + (k + 1 < Kp ? k + 1 : 0)];
        const int32_t tail_tok =
            k + 1 == n_runs ? ((sp_last >> 1) > 0 ? (sp_last >> 1) : 0)
                            : a.prev_kept[row + clampi(nxt_head, 0, U - 1)];
        const bool kill = r_valid && s_is_hide && g_cause == tail_tok;
        int32_t vict = N;
        if (kill) {
            const int t = clampi(tail_tok, 0, U - 1);
            vict = a.sv_lane[row + t] + a.sv_len[row + t] - 1;
        }
        a.vict_tail[krow + k] = vict;
    }
    const SortArea sl = sort_area<1>(area, P, in_smem);
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const bool keep = a.keep[row + i] != 0;
        sl.col(0)[sl.at(i)] = keep && rank[i] < N ? a.sv_lane[row + i] : N;
        sl.pos[sl.at(i)] = i;
    }
    __syncthreads();
    row_sort<1>(sl);

    for (int j = threadIdx.x; j < P; j += blockDim.x) {
        a.lk[row + j] = sl.col(0)[sl.at(j)];
        a.tb_l[row + j] = rank[sl.pos[sl.at(j)]];
    }
    if (threadIdx.x < 8) {
        const int t = threadIdx.x;
        int32_t v = 0;
        if (t == 0) v = a.keep[row] != 0 ? a.sv_lane[row] : N;
        if (t == 1) v = n_runs > k_max ? 1 : 0;
        a.scal[(size_t)blockIdx.x * 8 + t] = v;
    }
}

extern "C" {

// Int32 words of global scratch per row (0: the row fits in shared
// memory; -1: a CUDA error).
int cause_k4_scratch_words(int P, int Kp) {
    (void)Kp;
    int fits = 0;
    if (bf_fits_smem((size_t)k4_words(P), &fits) != cudaSuccess) return -1;
    return fits ? 0 : k4_words(P);
}

// K4 over B rows: base_run, hc, h_w [B, Kp]; run_id, keep, sv_len, sv_vc,
// sv_lane, glued, prev_kept, cause_su [B, P]; scal2 [B, 8] (K2's scal);
// outputs lk, tb_l, vict_inrun [B, P], vict_tail [B, Kp], scal [B, 8];
// all contiguous int32 device tensors. P and Kp powers of two, k_max <=
// Kp <= P, 1 <= U <= P, N >= 1. scratch is null or B *
// cause_k4_scratch_words int32. Returns the cudaError_t of the launch.
int cause_k4_rank_kills(const void* base_run, const void* hc,
                        const void* h_w, const void* run_id,
                        const void* keep, const void* sv_len,
                        const void* sv_vc, const void* sv_lane,
                        const void* glued, const void* prev_kept,
                        const void* cause_su, const void* scal2, void* lk,
                        void* tb_l, void* vict_inrun, void* vict_tail,
                        void* scal, int B, int P, int Kp, int U, int k_max,
                        int N, void* scratch, void* stream) {
    if (B < 0 || P < 1 || (P & (P - 1)) || Kp < 1 || (Kp & (Kp - 1)) ||
        Kp > P || U < 1 || U > P || k_max < 1 || k_max > Kp || N < 1)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    int fits = 0;
    cudaError_t e = bf_fits_smem((size_t)k4_words(P), &fits);
    if (e != cudaSuccess) return (int)e;
    if (!fits && !scratch) return (int)cudaErrorInvalidValue;
    K4Args a = {(const int32_t*)base_run, (const int32_t*)hc,
                (const int32_t*)h_w, (const int32_t*)run_id,
                (const int32_t*)keep, (const int32_t*)sv_len,
                (const int32_t*)sv_vc, (const int32_t*)sv_lane,
                (const int32_t*)glued, (const int32_t*)prev_kept,
                (const int32_t*)cause_su, (const int32_t*)scal2,
                (int32_t*)lk, (int32_t*)tb_l, (int32_t*)vict_inrun,
                (int32_t*)vict_tail, (int32_t*)scal};
    const size_t smem = fits ? (size_t)k4_words(P) * sizeof(int32_t) : 0;
    e = bf_smem_attr(k4_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    k4_kernel<<<B, bf_threads(P), smem, (cudaStream_t)stream>>>(
        a, P, Kp, U, k_max, N, (int32_t*)scratch, fits);
    return (int)cudaGetLastError();
}

}  // extern "C"
