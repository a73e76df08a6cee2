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
// What bounds it on the H100: eleven inputs read once ([Kp] x 3, [P] x
// 8) and four outputs written once, about 0.24 GB and 0.07 ms at the
// north star (B = 1024, P = Kp = 4096) at 3.35 TB/s. Its two row sorts
// are what kept the first design (PR 2, the network form below) at 11x
// that bound: 78 bitonic stages each at 4096.
//
// The radix form (256 <= P <= 8192), against the Pallas kernel's
// windowed one-hot expansion, one-hot gathers and inverse-sort rides:
// - the row lives in registers, warp-striped (befuse.cuh); the
//   kept-length prefix is a register scan with one barrier;
// - base_ff / hw_ff are direct reads at run_id;
// - both sorts are radix.cuh's stable LSD sort on one key, whose keys
//   span 15 bits at the north star (lanes in [0, N], bases below N, and
//   INT32_MAX, which the range compression maps just above the largest
//   other key): two 8-bit passes each;
// - the lane sort comes first (its keys are in registers once the ranks
//   are), and tb_l is gathered from the ranks by sorted position;
// - the successor sort runs over P slots, its Kp keys padded with
//   INT32_MAX; it is stable, so its first Kp sorted slots are the
//   Kp-wide sort, and padding sorts after every real key; the successor
//   of each run is a scatter into the ranks' storage, dead by then.
// Shared memory: the ranks [P] and the radix area, 50 KB at
// P = Kp = 4096. Three 512-thread CTAs an SM: the launch bounds hold a
// thread to 40 registers, at the cost of a few spilled words (256
// threads of 16 items at 80 registers spilled more and ran 25% slower on
// an H100); P = 8192 fits too (91 KB).
//
// The network form (the PR-2 design, kept for P < 256 and P > 8192):
// three [P] arrays and a bitonic sort area in shared memory or, past the
// block's limit, a global scratch row; the successor and lane sorts run
// bitonic.cuh's networks.

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

__device__ __forceinline__ bool hideish(int32_t vc) {
    return vc == 1 || vc == 2;  // VCLASS_HIDE, VCLASS_H_HIDE
}

// The tail kill of valid run k whose successor run is succ_run (-1:
// none): the tail lane of the run's tail token, or N.
__device__ __forceinline__ int32_t k4_tail_kill(const K4Args& a, size_t row,
                                                size_t krow, int k,
                                                int32_t succ_run, int Kp,
                                                int U, int N, int32_t n_runs,
                                                int32_t sp_last) {
    if (succ_run < 0) return N;
    const int s_c = clampi(a.hc[krow + clampi(succ_run, 0, Kp - 1)], 0, U - 1);
    if (!hideish(a.sv_vc[row + s_c])) return N;
    const int32_t nxt_head = a.hc[krow + (k + 1 < Kp ? k + 1 : 0)];
    const int32_t tail_tok =
        k + 1 == n_runs ? ((sp_last >> 1) > 0 ? (sp_last >> 1) : 0)
                        : a.prev_kept[row + clampi(nxt_head, 0, U - 1)];
    if (a.cause_su[row + s_c] != tail_tok) return N;
    const int t = clampi(tail_tok, 0, U - 1);
    return a.sv_lane[row + t] + a.sv_len[row + t] - 1;
}

// ------------------------------------------------------------ radix form

// the radix area and the ranks [P]; items per thread as B1's radix path
// (radix_ipt: 8 up to P = 4096, 16 at 8192; P / IPT threads)
static inline size_t k4_radix_bytes(int P) {
    return (size_t)P * sizeof(int32_t) + radix_smem_bytes(1, P, radix_ipt(P));
}

template <int IPT, int MIN_CTAS>
__global__ void __launch_bounds__(CAUSE_RADIX_THREADS, MIN_CTAS)
k4_radix_kernel(K4Args a, int P, int Kp, int U, int k_max, int N) {
    extern __shared__ __align__(16) unsigned char k4_smem[];
    __shared__ int32_t red[32];
    unsigned char* area = k4_smem;
    int32_t* rank_s = (int32_t*)(k4_smem + radix_smem_bytes(1, P, IPT));
    int32_t* succ_s = rank_s;  // the ranks are dead once tb_l is out
    const size_t row = (size_t)blockIdx.x * (size_t)P;
    const size_t krow = (size_t)blockIdx.x * (size_t)Kp;
    const int32_t n_runs = a.scal2[(size_t)blockIdx.x * 8 + 0];
    const int32_t sp_last = a.scal2[(size_t)blockIdx.x * 8 + 2];
    const int n_valid = n_runs < k_max ? n_runs : k_max;
    BF_PHASE_START

    // weighted starts: an exclusive scan of the kept lengths
    int32_t ws[IPT];
    uint32_t kept = 0;  // bit i: item i is kept
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int e = ws_elem<IPT>(i);
        const bool keep = a.keep[row + e] != 0;
        kept |= keep ? 1u << i : 0u;
        ws[i] = keep ? a.sv_len[row + e] : 0;
    }
    BF_PHASE(BF_LS);
    ws_scan<OpSum, IPT>(ws, red);
    BF_PHASE(BF_SCAN);

    // ranks, in-run kills, and the lane sort's keys
    int32_t key[1][IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int e = ws_elem<IPT>(i);
        const bool keep = (kept >> i) & 1u;
        int32_t rank = N;
        if (keep) {
            const int rid = clampi(a.run_id[row + e], 0, Kp - 1);
            rank = a.base_run[krow + rid] + (ws[i] - a.h_w[krow + rid]);
        }
        rank_s[e] = rank;
        key[0][i] = keep && rank < N ? a.sv_lane[row + e] : N;
        int32_t vict = N;
        if (a.glued[row + e] != 0 && hideish(a.sv_vc[row + e])) {
            const int pk = clampi(a.prev_kept[row + e], 0, U - 1);
            vict = a.sv_lane[row + pk] + a.sv_len[row + pk] - 1;
        }
        a.vict_inrun[row + e] = vict;
    }
    BF_PHASE(BF_LS);
    {
        const RadixRow<1> lanes = radix_sort_row<1, IPT>(key, area);
        BF_PHASE(BF_SORT);
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
            const int j = ws_elem<IPT>(i);
            a.lk[row + j] = lanes.key(0, j);
            a.tb_l[row + j] = rank_s[lanes.pos(j)];
        }
    }
    if (threadIdx.x < 8) {
        const int t = threadIdx.x;
        int32_t v = 0;
        if (t == 0) v = a.keep[row] != 0 ? a.sv_lane[row] : N;
        if (t == 1) v = n_runs > k_max ? 1 : 0;
        a.scal[(size_t)blockIdx.x * 8 + t] = v;
    }

    // the successor sort: valid runs' bases, INT32_MAX for the other runs
    // and for the padding slots Kp..P-1. The sort's own barriers order
    // the reads of the lane sort's results above before its writes.
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int k = ws_elem<IPT>(i);
        key[0][i] = k < n_valid ? a.base_run[krow + k] : CAUSE_BF_BIG;
    }
    BF_PHASE(BF_LS);
    const RadixRow<1> bases = radix_sort_row<1, IPT>(key, area);
    BF_PHASE(BF_SORT);
    // the run at sorted slot j is followed by the run at slot j + 1
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int j = ws_elem<IPT>(i);
        if (j < Kp) {
            const bool nxt = j < Kp - 1 && bases.key(0, j + 1) != CAUSE_BF_BIG;
            succ_s[bases.pos(j)] = nxt ? bases.pos(j + 1) : -1;
        }
    }
    __syncthreads();

    // tail kills
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
        a.vict_tail[krow + k] =
            k < n_valid ? k4_tail_kill(a, row, krow, k, succ_s[k], Kp, U, N,
                                       n_runs, sp_last)
                        : N;
    }
    BF_PHASE(BF_LS);
}

// ---------------------------------------------------------- network form

__host__ __device__ __forceinline__ int k4_words(int P) {
    return 3 * P + bf_sort_words(1, P);
}

__global__ void __launch_bounds__(CAUSE_BF_MAX_THREADS)
k4_net_kernel(K4Args a, int P, int Kp, int U, int k_max, int N,
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
    BF_PHASE_START

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
    BF_PHASE(BF_LS);
    block_scan<OpSum>(wcum, P, red);
    BF_PHASE(BF_SCAN);

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
    BF_PHASE(BF_LS);
    row_sort<1>(sk);
    BF_PHASE(BF_SORT);

    // successor of the run at sorted slot j is the run at slot j + 1
    for (int j = threadIdx.x; j < Kp; j += blockDim.x) {
        const bool nxt = j < Kp - 1 && sk.col(0)[sk.at(j + 1)] != CAUSE_BF_BIG;
        succ[sk.pos[sk.at(j)]] = nxt ? sk.pos[sk.at(j + 1)] : -1;
    }
    __syncthreads();

    // tail kills; then the lane sort's keys into the (free) sort area
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
        a.vict_tail[krow + k] =
            k + 1 <= n_valid ? k4_tail_kill(a, row, krow, k, succ[k], Kp, U,
                                            N, n_runs, sp_last)
                             : N;
    }
    const SortArea sl = sort_area<1>(area, P, in_smem);
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const bool keep = a.keep[row + i] != 0;
        sl.col(0)[sl.at(i)] = keep && rank[i] < N ? a.sv_lane[row + i] : N;
        sl.pos[sl.at(i)] = i;
    }
    __syncthreads();
    BF_PHASE(BF_LS);
    row_sort<1>(sl);
    BF_PHASE(BF_SORT);

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
    BF_PHASE(BF_LS);
}

// -------------------------------------------------------------- launches

static cudaError_t k4_net_attrs() {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    return smem_attrs_once(k4_net_kernel, ready);
}

// Whether a row of width P takes the radix form on this device.
static cudaError_t k4_takes_radix(int P, bool* radix) {
    int fits = 0;
    *radix = false;
    if (!bf_radix_width(P)) return cudaSuccess;
    const cudaError_t e = bf_fits_smem(k4_radix_bytes(P), &fits);
    *radix = e == cudaSuccess && fits;
    return e;
}

// Launch the radix form (launch = true) or set its attributes and count
// the CTAs an SM holds (*ctas).
template <int IPT, int MIN_CTAS>
static cudaError_t k4_radix_run(bool launch, const K4Args& a, int B, int P,
                                int Kp, int U, int k_max, int N,
                                cudaStream_t stream, int* ctas) {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    auto kernel = k4_radix_kernel<IPT, MIN_CTAS>;
    const cudaError_t e = smem_attrs_once(kernel, ready);
    if (e != cudaSuccess) return e;
    if (!launch) {
        *ctas = bf_ctas_per_sm(kernel, P / IPT, k4_radix_bytes(P));
        return cudaSuccess;
    }
    kernel<<<B, P / IPT, k4_radix_bytes(P), stream>>>(a, P, Kp, U, k_max, N);
    return cudaGetLastError();
}

static cudaError_t k4_radix(bool launch, const K4Args& a, int B, int P,
                            int Kp, int U, int k_max, int N,
                            cudaStream_t stream, int* ctas) {
    if (radix_ipt(P) == 8)
        return k4_radix_run<8, 3>(launch, a, B, P, Kp, U, k_max, N, stream,
                                  ctas);
    return k4_radix_run<16, 1>(launch, a, B, P, Kp, U, k_max, N, stream, ctas);
}

extern "C" {

BF_PHASE_TAKE_FN

// Int32 words of global scratch per row (0: the row runs in shared
// memory; -1: a CUDA error).
int cause_k4_scratch_words(int P, int Kp) {
    (void)Kp;
    bool radix = false;
    int fits = 0;
    if (k4_takes_radix(P, &radix) != cudaSuccess) return -1;
    if (radix) return 0;
    if (bf_fits_smem((size_t)k4_words(P) * sizeof(int32_t), &fits) !=
        cudaSuccess)
        return -1;
    return fits ? 0 : k4_words(P);
}

// CTAs an SM holds of the form a row of width P takes (network != 0:
// of the network form at that width, shared memory or scratch as it
// would run); -1 on a CUDA error.
int cause_k4_ctas_per_sm(int P, int Kp, int network) {
    bool radix = false;
    if (k4_takes_radix(P, &radix) != cudaSuccess) return -1;
    if (radix && !network) {
        int ctas = -1;
        K4Args a = {};
        if (k4_radix(false, a, 0, P, Kp, 1, 1, 1, 0, &ctas) != cudaSuccess)
            return -1;
        return ctas;
    }
    int fits = 0;
    if (bf_fits_smem((size_t)k4_words(P) * sizeof(int32_t), &fits) !=
            cudaSuccess ||
        k4_net_attrs() != cudaSuccess)
        return -1;
    return bf_ctas_per_sm(k4_net_kernel, bf_threads(P),
                          fits ? (size_t)k4_words(P) * sizeof(int32_t) : 0);
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
    K4Args a = {(const int32_t*)base_run, (const int32_t*)hc,
                (const int32_t*)h_w, (const int32_t*)run_id,
                (const int32_t*)keep, (const int32_t*)sv_len,
                (const int32_t*)sv_vc, (const int32_t*)sv_lane,
                (const int32_t*)glued, (const int32_t*)prev_kept,
                (const int32_t*)cause_su, (const int32_t*)scal2,
                (int32_t*)lk, (int32_t*)tb_l, (int32_t*)vict_inrun,
                (int32_t*)vict_tail, (int32_t*)scal};
    const cudaStream_t st = (cudaStream_t)stream;
    bool radix = false;
    cudaError_t e = k4_takes_radix(P, &radix);
    if (e != cudaSuccess) return (int)e;
    if (radix)
        return (int)k4_radix(true, a, B, P, Kp, U, k_max, N, st, nullptr);
    int fits = 0;
    e = bf_fits_smem((size_t)k4_words(P) * sizeof(int32_t), &fits);
    if (e != cudaSuccess) return (int)e;
    if (!fits && !scratch) return (int)cudaErrorInvalidValue;
    e = k4_net_attrs();
    if (e != cudaSuccess) return (int)e;
    const size_t smem = fits ? (size_t)k4_words(P) * sizeof(int32_t) : 0;
    k4_net_kernel<<<B, bf_threads(P), smem, st>>>(
        a, P, Kp, U, k_max, N, (int32_t*)scratch, fits);
    return (int)cudaGetLastError();
}

}  // extern "C"
