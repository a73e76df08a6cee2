// K1: token sort, dedupe and cause/host redirection of the fused v5
// token pipeline, one CTA per replica row.
//
// Replaces the Pallas kernel of cause_tpu/weaver/pallas_befuse.py
// (`_build_k1`, pallas_call at :544 behind `k1_sort_redirect`, :694; the
// row is `row_k1`, :258). Contract, per row of P (a power of two) presort
// tokens: sort on (hi, lo) with the position as the last key (THE stable
// order); a token is kept unless it is padding (hi = lo = int32 max) or
// repeats the previous token's id; cause and host links (presort token
// ids, -1: none) are mapped through the inverse permutation and
// redirected to the kept head of their duplicate group (thead, a running
// max of kept positions); parent = cause for kept specials, else host;
// conflict = the duplicates whose class, length or redirected cause
// differ from the token before them. Out: sv_len, sv_vc, sv_tsp, sv_lane,
// keep, cause_su, parent_su, and scal = [conflict, 0, ...].
//
// What it keeps out of device memory: the eight inputs are read once and
// the eight outputs written once (16 words per token, about 0.27 GB and
// 0.08 ms at the north star, B = 1024, P = 4096, at 3.35 TB/s). In truth
// it is bound by the in-block sort: 78 network stages at P = 4096.
//
// What the design does about it (against the Pallas kernel, which rode
// all nine operands through its network and sorted a second time for
// the inverse):
// - only (hi, lo, position) go through the network (bitonic.cuh, B1's
//   register form at 256 <= P <= 4096); the six payloads are gathered
//   once by the final positions;
// - the inverse permutation is a scatter inv[src[i]] = i (src is a
//   permutation), not a second sort;
// - thead is a block max-scan, the redirections are shared-memory reads,
//   the conflict count one block reduction.
// Shared memory: the sort area (3 padded columns) plus five [P] arrays,
// 130 KB at P = 4096; wider rows run on a global scratch row.

#include "befuse.cuh"

struct K1Args {
    const int32_t* t_hi;
    const int32_t* t_lo;
    const int32_t* t_vc;
    const int32_t* t_len;
    const int32_t* t_tsp;
    const int32_t* t_lane;
    const int32_t* cu0m;
    const int32_t* hu0m;
    int32_t* sv_len;
    int32_t* sv_vc;
    int32_t* sv_tsp;
    int32_t* sv_lane;
    int32_t* keep;
    int32_t* cause_su;
    int32_t* parent_su;
    int32_t* scal;
};

__host__ __device__ __forceinline__ int k1_words(int P) {
    return bf_sort_words(2, P) + 5 * P;
}

__global__ void __launch_bounds__(CAUSE_BF_MAX_THREADS)
k1_kernel(K1Args a, int P, int U, int32_t* scratch, int in_smem) {
    extern __shared__ int32_t smem[];
    __shared__ int32_t red[32];
    const size_t row = (size_t)blockIdx.x * (size_t)P;
    int32_t* ws = in_smem ? smem
                          : scratch + (size_t)blockIdx.x * (size_t)k1_words(P);
    const SortArea s = sort_area<2>(ws, P, in_smem);
    int32_t* inv_t = ws + bf_sort_words(2, P);
    int32_t* thead = inv_t + P;
    int32_t* cause = thead + P;
    int32_t* s_vc = cause + P;
    int32_t* s_len = s_vc + P;
    int32_t* key_hi = s.col(0);
    int32_t* key_lo = s.col(1);

    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        key_hi[s.at(i)] = a.t_hi[row + i];
        key_lo[s.at(i)] = a.t_lo[row + i];
        s.pos[s.at(i)] = i;
    }
    __syncthreads();
    row_sort<2>(s);

    // payloads by position, the inverse scatter, dedupe
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int src = s.pos[s.at(i)];
        const int32_t h = key_hi[s.at(i)];
        const int32_t l = key_lo[s.at(i)];
        const bool tva = !(h == CAUSE_BF_BIG && l == CAUSE_BF_BIG);
        const bool sdup = i > 0 && tva && h == key_hi[s.at(i - 1)] &&
                          l == key_lo[s.at(i - 1)];
        const bool keep = tva && !sdup;
        const int32_t vc = a.t_vc[row + src];
        const int32_t len = a.t_len[row + src];
        a.sv_len[row + i] = len;
        a.sv_vc[row + i] = vc;
        a.sv_tsp[row + i] = a.t_tsp[row + src];
        a.sv_lane[row + i] = a.t_lane[row + src];
        a.keep[row + i] = keep ? 1 : 0;
        s_vc[i] = vc;
        s_len[i] = len;
        inv_t[src] = i;
        thead[i] = keep ? i : -1;
    }
    __syncthreads();
    block_scan<OpMax>(thead, P, red);

    // redirection to the kept head; thead[i] == i exactly where i is kept
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int src = s.pos[s.at(i)];
        const int32_t cu = a.cu0m[row + src];
        const int32_t hu = a.hu0m[row + src];
        const int32_t c =
            cu >= 0 ? thead[clampi(inv_t[clampi(cu, 0, U - 1)], 0, U - 1)] : 0;
        const int32_t hs =
            hu >= 0 ? thead[clampi(inv_t[clampi(hu, 0, U - 1)], 0, U - 1)] : 0;
        const bool special = thead[i] == i && s_vc[i] > 0;
        cause[i] = c;
        a.cause_su[row + i] = c;
        a.parent_su[row + i] = special ? c : hs;
    }
    __syncthreads();

    int32_t n_conf = 0;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        if (i == 0) continue;
        const int32_t h = key_hi[s.at(i)];
        const int32_t l = key_lo[s.at(i)];
        const bool tva = !(h == CAUSE_BF_BIG && l == CAUSE_BF_BIG);
        const bool sdup = tva && h == key_hi[s.at(i - 1)] &&
                          l == key_lo[s.at(i - 1)];
        if (sdup && (s_vc[i] != s_vc[i - 1] || cause[i] != cause[i - 1] ||
                     s_len[i] != s_len[i - 1]))
            ++n_conf;
    }
    n_conf = block_sum(n_conf, red);
    if (threadIdx.x < 8)
        a.scal[(size_t)blockIdx.x * 8 + threadIdx.x] = threadIdx.x == 0 ? n_conf : 0;
}

extern "C" {

// Int32 words of global scratch per row for rows of width P (0: the row
// fits in shared memory; -1: a CUDA error).
int cause_k1_scratch_words(int P) {
    int fits = 0;
    if (bf_fits_smem((size_t)k1_words(P) * sizeof(int32_t), &fits) !=
        cudaSuccess)
        return -1;
    return fits ? 0 : k1_words(P);
}

// K1 over B rows of P tokens (P a power of two, 1 <= U <= P). The eight
// inputs and seven [B, P] outputs are contiguous int32 device tensors,
// scal is [B, 8]; scratch is null or B * cause_k1_scratch_words(P) int32.
// Returns the cudaError_t of the launch.
int cause_k1_sort_redirect(const void* t_hi, const void* t_lo,
                           const void* t_vc, const void* t_len,
                           const void* t_tsp, const void* t_lane,
                           const void* cu0m, const void* hu0m, void* sv_len,
                           void* sv_vc, void* sv_tsp, void* sv_lane,
                           void* keep, void* cause_su, void* parent_su,
                           void* scal, int B, int P, int U, void* scratch,
                           void* stream) {
    if (B < 0 || P < 1 || (P & (P - 1)) || U < 1 || U > P)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    int fits = 0;
    cudaError_t e = bf_fits_smem((size_t)k1_words(P) * sizeof(int32_t), &fits);
    if (e != cudaSuccess) return (int)e;
    if (!fits && !scratch) return (int)cudaErrorInvalidValue;
    K1Args a = {(const int32_t*)t_hi, (const int32_t*)t_lo,
                (const int32_t*)t_vc, (const int32_t*)t_len,
                (const int32_t*)t_tsp, (const int32_t*)t_lane,
                (const int32_t*)cu0m, (const int32_t*)hu0m,
                (int32_t*)sv_len, (int32_t*)sv_vc, (int32_t*)sv_tsp,
                (int32_t*)sv_lane, (int32_t*)keep, (int32_t*)cause_su,
                (int32_t*)parent_su, (int32_t*)scal};
    const size_t smem = fits ? (size_t)k1_words(P) * sizeof(int32_t) : 0;
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    e = smem_attrs_once(k1_kernel, ready);
    if (e != cudaSuccess) return (int)e;
    k1_kernel<<<B, bf_threads(P), smem, (cudaStream_t)stream>>>(
        a, P, U, (int32_t*)scratch, fits);
    return (int)cudaGetLastError();
}

}  // extern "C"
