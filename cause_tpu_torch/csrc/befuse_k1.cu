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
// max of kept positions), both lookups clamped to U - 1; parent = cause
// for kept specials, else host; conflict = the duplicates whose class,
// length or redirected cause differ from the token before them. Out:
// sv_len, sv_vc, sv_tsp, sv_lane, keep, cause_su, parent_su, and
// scal = [conflict, 0, ...].
//
// What bounds it on the H100: the eight inputs are read once and the
// seven [P] outputs written once (15 words a token, about 0.25 GB and
// 0.075 ms at the north star, B = 1024, P = 4096, at 3.35 TB/s). Its
// first design (the network form below) sat 8x above that, on its
// in-block sort (78 bitonic stages at P = 4096) and one CTA an SM
// (130 KB of shared memory).
//
// The radix form (256 <= P <= 8192), against the Pallas kernel, which
// rode all nine operands through its network and sorted a second time
// for the inverse:
// - the row lives in registers, warp-striped (befuse.cuh), and is
//   sorted by radix.cuh's stable LSD sort on the (hi, lo) composite
//   (29-39 bits at the north star: four or five 8-bit passes). The range
//   map is injective, so "same id as the element before" is equality of
//   composites; stability supplies the position tie-break, so no
//   position key is sorted;
// - the six payloads are gathered once by sorted position and the five
//   [P] outputs of this pass written coalesced;
// - the inverse permutation is a scatter inv[src] = i into shared
//   memory; thead is a register max-scan (one barrier);
// - the conflict test reads the element before's class, length and
//   cause by shuffle within an item, from lane 31 of the item before,
//   and from one exchanged word triple per warp across warps;
// - only inv_t (uint16) and thead (int16), which other threads gather,
//   live in shared memory, in the sort's key area once every thread
//   holds its sorted element: 50 KB at P = 4096 (the radix area), so
//   several CTAs share an SM; P = 8192 fits too (92 KB).
//
// The network form (the first design, kept for P < 256 and P > 8192):
// only (hi, lo, position) go through bitonic.cuh's network; the six
// payloads are gathered once by the final positions; the sort area and
// five [P] arrays live in shared memory or, past the block's limit, a
// global scratch row.

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

// a link (presort token id, -1: none) redirected to its kept head
__device__ __forceinline__ int32_t k1_redirect(int32_t link,
                                               const uint16_t* inv_t,
                                               const int16_t* thead, int U) {
    return link >= 0
               ? thead[clampi(inv_t[clampi(link, 0, U - 1)], 0, U - 1)]
               : 0;
}

// ------------------------------------------------------------ radix form

static inline size_t k1_radix_bytes(int P) {
    return radix_smem_bytes(2, P, radix_ipt(P));
}

template <int IPT, int MIN_CTAS>
__global__ void __launch_bounds__(CAUSE_RADIX_THREADS, MIN_CTAS)
k1_radix_kernel(K1Args a, int P, int U) {
    extern __shared__ __align__(16) unsigned char k1_smem[];
    __shared__ int32_t red[32];
    __shared__ int32_t edge[3 * (CAUSE_RADIX_THREADS / 32)];
    // once every thread holds its sorted element, the sort's key area
    // (8P bytes) holds inv_t and thead
    uint16_t* inv_s = (uint16_t*)k1_smem;
    int16_t* thead_s = (int16_t*)(k1_smem + (size_t)P * sizeof(uint16_t));
    const size_t row = (size_t)blockIdx.x * (size_t)P;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    BF_PHASE_START

    int32_t key[2][IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int e = ws_elem<IPT>(i);
        key[0][i] = a.t_hi[row + e];
        key[1][i] = a.t_lo[row + e];
    }
    BF_PHASE(BF_LS);
    const RadixRow<2> s = radix_sort_row<2, IPT>(key, k1_smem);
    BF_PHASE(BF_SORT);

    // this thread's sorted elements: source position, kept, duplicate
    int32_t src[IPT];
    uint32_t keepm = 0, dupm = 0;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int j = ws_elem<IPT>(i);
        src[i] = s.pos(j);
        const uint64_t c = s.comp(j);
        const bool tva =
            !(s.decode(0, c) == CAUSE_BF_BIG && s.decode(1, c) == CAUSE_BF_BIG);
        const bool dup = j > 0 && tva && s.comp(j - 1) == c;
        keepm |= tva && !dup ? 1u << i : 0u;
        dupm |= dup ? 1u << i : 0u;
    }
    __syncthreads();  // the key area is free from here

    // payloads by position, the inverse scatter, thead
    int32_t vc[IPT], len[IPT], th[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int j = ws_elem<IPT>(i);
        const size_t sr = row + src[i];
        const bool keep = (keepm >> i) & 1u;
        vc[i] = a.t_vc[sr];
        len[i] = a.t_len[sr];
        a.sv_len[row + j] = len[i];
        a.sv_vc[row + j] = vc[i];
        a.sv_tsp[row + j] = a.t_tsp[sr];
        a.sv_lane[row + j] = a.t_lane[sr];
        a.keep[row + j] = keep ? 1 : 0;
        inv_s[src[i]] = (uint16_t)j;
        th[i] = keep ? j : -1;
    }
    BF_PHASE(BF_LS);
    ws_scan<OpMax, IPT>(th, red);
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int j = ws_elem<IPT>(i);
        const int32_t own = (keepm >> i) & 1u ? j : -1;
        thead_s[j] = (int16_t)(th[i] > own ? th[i] : own);  // inclusive
    }
    __syncthreads();
    BF_PHASE(BF_SCAN);

    // redirection to the kept head
    int32_t cause[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int j = ws_elem<IPT>(i);
        const size_t sr = row + src[i];
        const int32_t c = k1_redirect(a.cu0m[sr], inv_s, thead_s, U);
        const int32_t hs = k1_redirect(a.hu0m[sr], inv_s, thead_s, U);
        const bool special = ((keepm >> i) & 1u) && vc[i] > 0;
        a.cause_su[row + j] = c;
        a.parent_su[row + j] = special ? c : hs;
        cause[i] = c;
    }
    // the warp's last element, for the next warp's first
    if (lane == 31) {
        edge[3 * warp + 0] = vc[IPT - 1];
        edge[3 * warp + 1] = len[IPT - 1];
        edge[3 * warp + 2] = cause[IPT - 1];
    }
    __syncthreads();
    BF_PHASE(BF_LS);

    // conflicts: duplicates that differ from the element before
    int32_t n_conf = 0;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        int32_t pv = __shfl_up_sync(CAUSE_FULL_MASK, vc[i], 1);
        int32_t pl = __shfl_up_sync(CAUSE_FULL_MASK, len[i], 1);
        int32_t pc = __shfl_up_sync(CAUSE_FULL_MASK, cause[i], 1);
        if (i > 0) {
            const int32_t wv = __shfl_sync(CAUSE_FULL_MASK, vc[i - 1], 31);
            const int32_t wl = __shfl_sync(CAUSE_FULL_MASK, len[i - 1], 31);
            const int32_t wc = __shfl_sync(CAUSE_FULL_MASK, cause[i - 1], 31);
            if (lane == 0) {
                pv = wv;
                pl = wl;
                pc = wc;
            }
        } else if (lane == 0 && warp > 0) {
            pv = edge[3 * (warp - 1) + 0];
            pl = edge[3 * (warp - 1) + 1];
            pc = edge[3 * (warp - 1) + 2];
        }
        // a duplicate is never the row's first element
        if (((dupm >> i) & 1u) &&
            (vc[i] != pv || cause[i] != pc || len[i] != pl))
            ++n_conf;
    }
    n_conf = block_sum(n_conf, red);
    BF_PHASE(BF_SCAN);
    if (threadIdx.x < 8)
        a.scal[(size_t)blockIdx.x * 8 + threadIdx.x] =
            threadIdx.x == 0 ? n_conf : 0;
    BF_PHASE(BF_LS);
}

// ---------------------------------------------------------- network form

__host__ __device__ __forceinline__ int k1_words(int P) {
    return bf_sort_words(2, P) + 5 * P;
}

__global__ void __launch_bounds__(CAUSE_BF_MAX_THREADS)
k1_net_kernel(K1Args a, int P, int U, int32_t* scratch, int in_smem) {
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
    BF_PHASE_START

    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        key_hi[s.at(i)] = a.t_hi[row + i];
        key_lo[s.at(i)] = a.t_lo[row + i];
        s.pos[s.at(i)] = i;
    }
    __syncthreads();
    BF_PHASE(BF_LS);
    row_sort<2>(s);
    BF_PHASE(BF_SORT);

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
    BF_PHASE(BF_LS);
    block_scan<OpMax>(thead, P, red);
    BF_PHASE(BF_SCAN);

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
    BF_PHASE(BF_LS);

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
    BF_PHASE(BF_SCAN);
    if (threadIdx.x < 8)
        a.scal[(size_t)blockIdx.x * 8 + threadIdx.x] = threadIdx.x == 0 ? n_conf : 0;
    BF_PHASE(BF_LS);
}

// -------------------------------------------------------------- launches

static cudaError_t k1_net_attrs() {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    return smem_attrs_once(k1_net_kernel, ready);
}

// Whether a row of width P takes the radix form on this device.
static cudaError_t k1_takes_radix(int P, bool* radix) {
    int fits = 0;
    *radix = false;
    if (!bf_radix_width(P)) return cudaSuccess;
    const cudaError_t e = bf_fits_smem(k1_radix_bytes(P), &fits);
    *radix = e == cudaSuccess && fits;
    return e;
}

// Launch the radix form (launch = true) or set its attributes and count
// the CTAs an SM holds (*ctas).
template <int IPT, int MIN_CTAS>
static cudaError_t k1_radix_run(bool launch, const K1Args& a, int B, int P,
                                int U, cudaStream_t stream, int* ctas) {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    auto kernel = k1_radix_kernel<IPT, MIN_CTAS>;
    const cudaError_t e = smem_attrs_once(kernel, ready);
    if (e != cudaSuccess) return e;
    if (!launch) {
        *ctas = bf_ctas_per_sm(kernel, P / IPT, k1_radix_bytes(P));
        return cudaSuccess;
    }
    kernel<<<B, P / IPT, k1_radix_bytes(P), stream>>>(a, P, U);
    return cudaGetLastError();
}

static cudaError_t k1_radix(bool launch, const K1Args& a, int B, int P,
                            int U, cudaStream_t stream, int* ctas) {
    if (radix_ipt(P) == 8)
        return k1_radix_run<8, 2>(launch, a, B, P, U, stream, ctas);
    return k1_radix_run<16, 1>(launch, a, B, P, U, stream, ctas);
}

extern "C" {

BF_PHASE_TAKE_FN

// Int32 words of global scratch per row for rows of width P (0: the row
// runs in shared memory; -1: a CUDA error).
int cause_k1_scratch_words(int P) {
    bool radix = false;
    int fits = 0;
    if (k1_takes_radix(P, &radix) != cudaSuccess) return -1;
    if (radix) return 0;
    if (bf_fits_smem((size_t)k1_words(P) * sizeof(int32_t), &fits) !=
        cudaSuccess)
        return -1;
    return fits ? 0 : k1_words(P);
}

// CTAs an SM holds of the form a row of width P takes (network != 0:
// of the network form at that width, shared memory or scratch as it
// would run); -1 on a CUDA error.
int cause_k1_ctas_per_sm(int P, int network) {
    bool radix = false;
    if (k1_takes_radix(P, &radix) != cudaSuccess) return -1;
    if (radix && !network) {
        int ctas = -1;
        K1Args a = {};
        if (k1_radix(false, a, 0, P, 1, 0, &ctas) != cudaSuccess) return -1;
        return ctas;
    }
    int fits = 0;
    if (bf_fits_smem((size_t)k1_words(P) * sizeof(int32_t), &fits) !=
            cudaSuccess ||
        k1_net_attrs() != cudaSuccess)
        return -1;
    return bf_ctas_per_sm(k1_net_kernel, bf_threads(P),
                          fits ? (size_t)k1_words(P) * sizeof(int32_t) : 0);
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
    K1Args a = {(const int32_t*)t_hi, (const int32_t*)t_lo,
                (const int32_t*)t_vc, (const int32_t*)t_len,
                (const int32_t*)t_tsp, (const int32_t*)t_lane,
                (const int32_t*)cu0m, (const int32_t*)hu0m,
                (int32_t*)sv_len, (int32_t*)sv_vc, (int32_t*)sv_tsp,
                (int32_t*)sv_lane, (int32_t*)keep, (int32_t*)cause_su,
                (int32_t*)parent_su, (int32_t*)scal};
    const cudaStream_t st = (cudaStream_t)stream;
    bool radix = false;
    cudaError_t e = k1_takes_radix(P, &radix);
    if (e != cudaSuccess) return (int)e;
    if (radix) return (int)k1_radix(true, a, B, P, U, st, nullptr);
    int fits = 0;
    e = bf_fits_smem((size_t)k1_words(P) * sizeof(int32_t), &fits);
    if (e != cudaSuccess) return (int)e;
    if (!fits && !scratch) return (int)cudaErrorInvalidValue;
    e = k1_net_attrs();
    if (e != cudaSuccess) return (int)e;
    const size_t smem = fits ? (size_t)k1_words(P) * sizeof(int32_t) : 0;
    k1_net_kernel<<<B, bf_threads(P), smem, st>>>(a, P, U, (int32_t*)scratch,
                                                  fits);
    return (int)cudaGetLastError();
}

}  // extern "C"
