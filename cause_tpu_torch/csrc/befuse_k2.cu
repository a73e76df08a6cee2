// K2: run extraction and the contracted forest of the fused v5 token
// pipeline, one CTA per replica row.
//
// Replaces the Pallas kernel of cause_tpu/weaver/pallas_befuse.py
// (`_build_k2`, pallas_call at :580 behind `k2_runs`, :703; the row is
// `row_k2`, :303). Contract, per row of P sorted tokens (K1's outputs):
// weighted positions (wstart, a prefix sum of kept lengths); the previous
// kept token and its tail-special bit (a running max of 2i + tsp); the
// adjacency, host-case and irregular classes; contested parents (a count
// of irregular tokens per parent); glue and run starts; run ids (a
// prefix count of starts); the per-run head tables at width Kp (hc: the
// head token, h_w: its weighted position), run weights, parent runs, and
// the forest links fc / ns of the sibling order (parent, specials
// first, then descending head). Out: fc, ns, parent_up, run_w, hc, h_w
// [Kp]; run_id, glued, prev_kept [P]; scal = [n_runs, n_kept, sp_last].
//
// Positions past n_runs of the [Kp] tables are exact too: the reference
// compacts heads with a stable sort on (run id at starts, int32 max
// elsewhere), which lays the non-start tokens after the heads in index
// order. Here that order is a scatter at a scanned position (start:
// run_id; other: n_runs + i - rs_cum[i]), a permutation of [0, P), whose
// first Kp slots are written.
//
// What bounds it on the H100: six [P] inputs read once, three [P] and
// six [Kp] outputs written once, 15 words a token at Kp = P: about
// 0.25 GB and 0.08 ms at the north star (B = 1024, P = Kp = 4096) at
// 3.35 TB/s. The first design (PR 2, the network form below) sat 8x
// above it, on its sibling sort (78 bitonic stages at 4096), four block
// scans walked warp by warp through shared memory, and one CTA an SM
// (130 KB of shared memory).
//
// The radix form (256 <= P <= 8192), against the Pallas kernel's
// one-hot chunk histograms, compaction sort and inverse-sort rides:
// - the row lives in registers, warp-striped (befuse.cuh); wstart and
//   the previous kept token (sum and max) are scanned in one pass, then
//   the contested-previous max and the run starts, one barrier each;
// - contested parents are a shared-memory bitset set with atomicOr over
//   the reference's parent range [0, min(P, 128 * ceil(U / 128))): the
//   reference reads only whether a count is positive, and a bit is set
//   exactly in any order;
// - the head compaction is the scatter above, and it moves each head's
//   fields (token, weighted start, special bit, parent token) to its run
//   slot at once;
// - the sibling sort is radix.cuh's stable LSD sort on (packed, -hc)
//   with packed = parent * 2 + !special < 2P and -hc in (-P, 0], whose
//   codes span at most 29 bits with the padding's (26 at the north star:
//   four 8-bit passes), so its composites are 32-bit; the parent rides
//   in the key, so no payload moves. Its P - Kp padding slots hold
//   INT32_MAX in both keys and sort after every real slot (stable);
// - ns and fc are scatters: the sorted positions are a permutation, and
//   each parent has one first child.
// Every scatter index is below P or Kp by construction, overflow rows
// (n_runs > Kp) included. Shared memory: three [Kp] int32 tables, the
// run-id prefix [P] as uint16, the bitset and the radix area, 91 KB at
// P = Kp = 4096, so two 512-thread CTAs an SM (64 registers a thread);
// P = Kp = 8192 fits too (172 KB).
//
// The network form (the PR-2 design, kept for P < 256 and P > 8192):
// five [P] arrays and a bitonic sort area in shared memory or, past the
// block's limit, a global scratch row.

#include "befuse.cuh"

struct K2Args {
    const int32_t* sv_len;
    const int32_t* sv_vc;
    const int32_t* sv_tsp;
    const int32_t* keep;
    const int32_t* cause_su;
    const int32_t* parent_su;
    int32_t* fc;
    int32_t* ns;
    int32_t* parent_up;
    int32_t* run_w;
    int32_t* hc;
    int32_t* h_w;
    int32_t* run_id;
    int32_t* glued;
    int32_t* prev_kept;
    int32_t* scal;
};

// ------------------------------------------------------------ radix form

// the special bit of a head, kept beside its token in the hc table
#define K2_HEAD_SPECIAL (1 << 30)

static inline size_t k2_radix_area(int P) {
    return radix_smem_bytes(2, P, radix_ipt(P), false);
}

// the radix area, hc / h_w / parent-token tables [Kp], run-start counts
// [P] (uint16) and the contested bitset [P / 32]
static inline size_t k2_radix_bytes(int P, int Kp) {
    return k2_radix_area(P) + 3 * (size_t)Kp * sizeof(int32_t) +
           (size_t)P * sizeof(uint16_t) + (size_t)(P / 32) * sizeof(uint32_t);
}

template <int IPT, int MIN_CTAS>
__global__ void __launch_bounds__(CAUSE_RADIX_THREADS, MIN_CTAS)
k2_radix_kernel(K2Args a, int P, int Kp, int U, int k_max) {
    extern __shared__ __align__(16) unsigned char k2_smem[];
    __shared__ int32_t red[4 * 32];
    unsigned char* area = k2_smem;
    int32_t* hc_s = (int32_t*)(k2_smem + radix_smem_bytes(2, P, IPT, false));
    int32_t* hw_s = hc_s + Kp;    // heads' weighted starts; later fc
    int32_t* pt_s = hw_s + Kp;    // heads' parent tokens; later ns
    uint16_t* rs_s = (uint16_t*)(pt_s + Kp);  // inclusive run-start counts
    uint32_t* contested = (uint32_t*)(rs_s + P);
    const size_t row = (size_t)blockIdx.x * (size_t)P;
    const size_t krow = (size_t)blockIdx.x * (size_t)Kp;
    BF_PHASE_START

    // wstart and the previous kept token: exclusive sum and max scans
    for (int w = threadIdx.x; w < P / 32; w += blockDim.x) contested[w] = 0;
    int32_t ws[IPT], sp[IPT];
    uint32_t keepm = 0, specm = 0;  // bit i: item i kept / special
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int e = ws_elem<IPT>(i);
        const bool keep = a.keep[row + e] != 0;
        ws[i] = keep ? a.sv_len[row + e] : 0;
        sp[i] = keep ? 2 * e + (a.sv_tsp[row + e] != 0) : -1;
        keepm |= keep ? 1u << i : 0u;
        specm |= keep && a.sv_vc[row + e] > 0 ? 1u << i : 0u;
    }
    BF_PHASE(BF_LS);
    ws_publish(ws_warp_scan<OpSum, IPT>(ws), red);
    ws_publish(ws_warp_scan<OpMax, IPT>(sp), red + 32);
    __syncthreads();
    const int32_t n_kept = ws_apply<OpSum, IPT>(ws, red);
    const int32_t sp_last = ws_apply<OpMax, IPT>(sp, red + 32);
    BF_PHASE(BF_SCAN);

    // classes, prev_kept, each token's parent token, and the contested
    // bitset over the reference's parent range
    const int u_ceil = 128 * ((U + 127) / 128);
    const int lim = P < u_ceil ? P : u_ceil;
    int32_t ptok[IPT];
    uint32_t gluem = 0;  // adjacent and not host-case
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int e = ws_elem<IPT>(i);
        const bool keep = (keepm >> i) & 1u;
        const bool special = (specm >> i) & 1u;
        const bool rel = keep && e > 0;
        const int32_t prev_kept = sp[i] >= 0 ? (sp[i] >> 1) : -1;
        const bool prev_tsp = sp[i] >= 0 && (sp[i] & 1);
        const bool adj = rel && prev_kept >= 0 &&
                         a.cause_su[row + e] == prev_kept;
        const bool host_case = adj && !special && prev_tsp;
        a.prev_kept[row + e] = prev_kept;
        ptok[i] = adj ? prev_kept : -1;
        if (rel && (!adj || host_case)) {  // irregular
            const int32_t p = a.parent_su[row + e];
            ptok[i] = p;
            if (p >= 0 && p < lim)
                atomicOr(&contested[p >> 5], 1u << (p & 31));
        }
        gluem |= adj && !host_case ? 1u << i : 0u;
    }
    __syncthreads();
    BF_PHASE(BF_LS);

    // glue (unless the previous kept token is contested) and run starts
    int32_t ec[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int e = ws_elem<IPT>(i);
        ec[i] = (keepm >> i) & 1u
                    ? 2 * e + (int32_t)((contested[e >> 5] >> (e & 31)) & 1u)
                    : -1;
    }
    ws_scan<OpMax, IPT>(ec, red + 64);
    BF_PHASE(BF_SCAN);
    int32_t rs[IPT];
    uint32_t startm = 0;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int e = ws_elem<IPT>(i);
        const bool prev_contested = ec[i] >= 0 && (ec[i] & 1);
        const bool glued = ((gluem >> i) & 1u) && !prev_contested;
        const bool start = ((keepm >> i) & 1u) && !glued;
        a.glued[row + e] = glued ? 1 : 0;
        rs[i] = start ? 1 : 0;
        startm |= start ? 1u << i : 0u;
    }
    const int32_t n_runs = ws_scan<OpSum, IPT>(rs, red + 96);
    BF_PHASE(BF_SCAN);

    // run ids, and the head compaction: start -> run_id, other ->
    // n_runs + i - rs_cum[i], each head's fields moved to its slot
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int e = ws_elem<IPT>(i);
        const bool start = (startm >> i) & 1u;
        const int32_t r = rs[i] + (start ? 1 : 0);
        a.run_id[row + e] = r - 1;
        rs_s[e] = (uint16_t)r;
        const int32_t slot = start ? r - 1 : n_runs + e - r;
        if (slot < Kp) {
            hc_s[slot] = e | ((specm >> i) & 1u ? K2_HEAD_SPECIAL : 0);
            hw_s[slot] = ws[i];
            pt_s[slot] = ptok[i];
        }
    }
    __syncthreads();
    BF_PHASE(BF_LS);

    // per-run tables and the sibling-sort keys; slots Kp..P-1 pad
    const int n_valid = n_runs < k_max ? n_runs : k_max;
    int32_t key[2][IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int k = ws_elem<IPT>(i);
        key[0][i] = CAUSE_BF_BIG;
        key[1][i] = CAUSE_BF_BIG;
        if (k >= Kp) continue;
        const int32_t hv = hc_s[k];
        const int32_t h = hv & (K2_HEAD_SPECIAL - 1);
        const int32_t hw = hw_s[k];
        const bool r_valid = k < n_valid;
        // a valid run's head is kept: it is the root exactly at token 0
        const int32_t h_parent = r_valid && h != 0 ? pt_s[k] : -1;
        const int32_t parent_run =
            h_parent >= 0 ? (int32_t)rs_s[clampi(h_parent, 0, U - 1)] - 1
                          : -1;
        const int32_t nxt_w = hw_s[k + 1 < Kp ? k + 1 : 0];
        const int32_t rw =
            r_valid ? (k + 1 == n_runs ? n_kept - hw : nxt_w - hw) : 0;
        const bool has_parent = r_valid && parent_run >= 0;
        a.hc[krow + k] = h;
        a.h_w[krow + k] = hw;
        a.run_w[krow + k] = rw;
        a.parent_up[krow + k] = has_parent ? parent_run : -1;
        key[0][i] = (has_parent ? parent_run : k_max) * 2 +
                    ((hv & K2_HEAD_SPECIAL) ? 0 : 1);
        key[1][i] = -h;
    }
    BF_PHASE(BF_LS);
    const RadixRow<2> sib = radix_sort_row<2, IPT, false>(key, area);
    BF_PHASE(BF_SORT);

    // forest links: ns[sord[j]] = the next sibling, fc[parent] = the first
    int32_t* fc_s = hw_s;
    int32_t* ns_s = pt_s;
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) fc_s[k] = -1;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
        const int j = ws_elem<IPT>(i);
        if (j >= Kp) continue;
        const int32_t sord = sib.pos(j);
        const int32_t ps = sib.key(0, j) >> 1;
        const bool same_next = j < Kp - 1 && (sib.key(0, j + 1) >> 1) == ps;
        ns_s[sord] = same_next ? sib.pos(j + 1) : -1;
        const bool is_start = j == 0 || (sib.key(0, j - 1) >> 1) != ps;
        if (is_start && ps >= 0 && ps < k_max) fc_s[ps] = sord;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
        a.fc[krow + k] = fc_s[k];
        a.ns[krow + k] = ns_s[k];
    }
    if (threadIdx.x < 8) {
        const int t = threadIdx.x;
        a.scal[(size_t)blockIdx.x * 8 + t] =
            t == 0 ? n_runs : t == 1 ? n_kept : t == 2 ? sp_last : 0;
    }
    BF_PHASE(BF_LS);
}

// ---------------------------------------------------------- network form

// token class bits
#define K2_KEEP 1
#define K2_SPECIAL 2
#define K2_GLUE 4    // adjacent and not host-case
#define K2_IRREG 8
#define K2_START 16

__host__ __device__ __forceinline__ int k2_words(int P, int Kp) {
    return 5 * P + bf_sort_words(2, Kp);
}

__global__ void __launch_bounds__(CAUSE_BF_MAX_THREADS)
k2_net_kernel(K2Args a, int P, int Kp, int U, int k_max, int32_t* scratch,
          int in_smem) {
    extern __shared__ int32_t smem[];
    __shared__ int32_t red[32];
    const size_t row = (size_t)blockIdx.x * (size_t)P;
    const size_t krow = (size_t)blockIdx.x * (size_t)Kp;
    int32_t* ws = in_smem
        ? smem : scratch + (size_t)blockIdx.x * (size_t)k2_words(P, Kp);
    int32_t* cls = ws;            // class bits; later ns
    int32_t* wsum = cls + P;      // wcum -> wstart; later fc
    int32_t* sp = wsum + P;       // sp_pack (prev_kept of i is sp[i - 1])
    int32_t* ec = sp + P;         // contested counts -> ec_pack; later hc
    int32_t* rs = ec + P;         // rs_cum
    const SortArea s = sort_area<2>(rs + P, Kp, in_smem);
    BF_PHASE_START

    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const bool keep = a.keep[row + i] != 0;
        wsum[i] = keep ? a.sv_len[row + i] : 0;
        sp[i] = keep ? 2 * i + (a.sv_tsp[row + i] != 0) : -1;
        ec[i] = 0;
        cls[i] = (keep ? K2_KEEP : 0) |
                 (keep && a.sv_vc[row + i] > 0 ? K2_SPECIAL : 0);
    }
    __syncthreads();
    BF_PHASE(BF_LS);
    block_scan<OpSum>(wsum, P, red);
    block_scan<OpMax>(sp, P, red);
    const int32_t n_kept = wsum[P - 1];
    const int32_t sp_last = sp[P - 1];
    __syncthreads();
    BF_PHASE(BF_SCAN);

    // classes, prev_kept, and the contested histogram
    const int u_ceil = 128 * ((U + 127) / 128);
    const int lim = P < u_ceil ? P : u_ceil;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int c = cls[i];
        const bool keep = c & K2_KEEP;
        const bool special = c & K2_SPECIAL;
        const bool rel = keep && i > 0;
        const int32_t sp_prev = i > 0 ? sp[i - 1] : -1;
        const int32_t prev_kept = sp_prev >= 0 ? (sp_prev >> 1) : -1;
        const bool prev_tsp = sp_prev >= 0 && (sp_prev & 1);
        const bool adj = rel && a.cause_su[row + i] == prev_kept &&
                         prev_kept >= 0;
        const bool host_case = adj && !special && prev_tsp;
        const bool irregular = rel && (!adj || host_case);
        // glued unless the previous kept token is a contested parent
        cls[i] = c | (adj && !host_case ? K2_GLUE : 0) |
                 (irregular ? K2_IRREG : 0);
        a.prev_kept[row + i] = prev_kept;
        if (irregular) {
            const int32_t p = a.parent_su[row + i];
            if (p >= 0 && p < lim) atomicAdd(&ec[p], 1);
        }
        wsum[i] -= keep ? a.sv_len[row + i] : 0;  // wcum -> wstart
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        ec[i] = (cls[i] & K2_KEEP) ? 2 * i + (ec[i] > 0) : -1;
    }
    __syncthreads();
    BF_PHASE(BF_LS);
    block_scan<OpMax>(ec, P, red);
    BF_PHASE(BF_SCAN);

    // glue and run starts
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int c = cls[i];
        const int32_t ec_prev = i > 0 ? ec[i - 1] : -1;
        const bool prev_contested = ec_prev >= 0 && (ec_prev & 1);
        const bool glued = (c & K2_GLUE) && !prev_contested;
        const bool start = (c & K2_KEEP) && !glued;
        a.glued[row + i] = glued ? 1 : 0;
        rs[i] = start ? 1 : 0;
        cls[i] = c | (start ? K2_START : 0);
    }
    __syncthreads();
    BF_PHASE(BF_LS);
    block_scan<OpSum>(rs, P, red);
    const int32_t n_runs = rs[P - 1];
    BF_PHASE(BF_SCAN);

    // head compaction: start -> run_id, other -> n_runs + i - rs_cum[i]
    int32_t* hc = ec;
    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int32_t r = rs[i];
        a.run_id[row + i] = r - 1;
        const int32_t slot = (cls[i] & K2_START) ? r - 1 : n_runs + i - r;
        if (slot < Kp) hc[slot] = i;
    }
    __syncthreads();

    // per-run tables and the sibling-sort keys
    const int n_valid = n_runs < k_max ? n_runs : k_max;
    int32_t* key_packed = s.col(0);
    int32_t* key_neghc = s.col(1);
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
        const int h = hc[k];
        const int c = cls[h];
        const bool r_valid = k + 1 <= n_valid;
        const bool h_root = (c & K2_KEEP) && h == 0;
        // irregular: its parent; adjacent (then not host-case, which is
        // irregular): the previous kept token; else none
        const int32_t h_parent_tok =
            (c & K2_IRREG) ? a.parent_su[row + h]
                           : (c & K2_GLUE) ? sp[h - 1] >> 1 : -1;
        const int32_t h_parent = r_valid && !h_root ? h_parent_tok : -1;
        const int32_t parent_run =
            h_parent >= 0 ? rs[clampi(h_parent, 0, U - 1)] - 1 : -1;
        const int32_t hw = wsum[h];
        const int32_t nxt_w = wsum[hc[k + 1 < Kp ? k + 1 : 0]];
        const int32_t rw =
            r_valid ? (k + 1 == n_runs ? n_kept - hw : nxt_w - hw) : 0;
        const bool has_parent = r_valid && parent_run >= 0;
        const int32_t parent_sort = has_parent ? parent_run : k_max;
        a.hc[krow + k] = h;
        a.h_w[krow + k] = hw;
        a.run_w[krow + k] = rw;
        a.parent_up[krow + k] = has_parent ? parent_run : -1;
        key_packed[s.at(k)] = parent_sort * 2 + ((c & K2_SPECIAL) ? 0 : 1);
        key_neghc[s.at(k)] = -h;
        s.pos[s.at(k)] = k;
    }
    __syncthreads();
    int32_t* ns = cls;
    int32_t* fc = wsum;
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) fc[k] = -1;
    __syncthreads();
    BF_PHASE(BF_LS);
    row_sort<2>(s);
    BF_PHASE(BF_SORT);

    // forest links: ns[sord[j]] = the next sibling, fc[parent] = the first
    for (int j = threadIdx.x; j < Kp; j += blockDim.x) {
        const int32_t sord = s.pos[s.at(j)];
        const int32_t ps = key_packed[s.at(j)] >> 1;
        const bool same_next =
            j < Kp - 1 && (key_packed[s.at(j + 1)] >> 1) == ps;
        ns[sord] = same_next ? s.pos[s.at(j + 1)] : -1;
        const bool is_start = j == 0 || (key_packed[s.at(j - 1)] >> 1) != ps;
        if (is_start && ps >= 0 && ps < k_max) fc[ps] = sord;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
        a.fc[krow + k] = fc[k];
        a.ns[krow + k] = ns[k];
    }
    if (threadIdx.x < 8) {
        const int t = threadIdx.x;
        a.scal[(size_t)blockIdx.x * 8 + t] =
            t == 0 ? n_runs : t == 1 ? n_kept : t == 2 ? sp_last : 0;
    }
    BF_PHASE(BF_LS);
}

// -------------------------------------------------------------- launches

static cudaError_t k2_net_attrs() {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    return smem_attrs_once(k2_net_kernel, ready);
}

// Whether a row of width P takes the radix form on this device.
static cudaError_t k2_takes_radix(int P, int Kp, bool* radix) {
    int fits = 0;
    *radix = false;
    if (!bf_radix_width(P)) return cudaSuccess;
    const cudaError_t e = bf_fits_smem(k2_radix_bytes(P, Kp), &fits);
    *radix = e == cudaSuccess && fits;
    return e;
}

// Launch the radix form (launch = true) or set its attributes and count
// the CTAs an SM holds (*ctas).
template <int IPT, int MIN_CTAS>
static cudaError_t k2_radix_run(bool launch, const K2Args& a, int B, int P,
                                int Kp, int U, int k_max, cudaStream_t stream,
                                int* ctas) {
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    auto kernel = k2_radix_kernel<IPT, MIN_CTAS>;
    const cudaError_t e = smem_attrs_once(kernel, ready);
    if (e != cudaSuccess) return e;
    const size_t smem = k2_radix_bytes(P, Kp);
    if (!launch) {
        *ctas = bf_ctas_per_sm(kernel, P / IPT, smem);
        return cudaSuccess;
    }
    kernel<<<B, P / IPT, smem, stream>>>(a, P, Kp, U, k_max);
    return cudaGetLastError();
}

static cudaError_t k2_radix(bool launch, const K2Args& a, int B, int P,
                            int Kp, int U, int k_max, cudaStream_t stream,
                            int* ctas) {
    if (radix_ipt(P) == 8)
        return k2_radix_run<8, 2>(launch, a, B, P, Kp, U, k_max, stream, ctas);
    return k2_radix_run<16, 1>(launch, a, B, P, Kp, U, k_max, stream, ctas);
}

extern "C" {

BF_PHASE_TAKE_FN

// Int32 words of global scratch per row (0: the row runs in shared
// memory; -1: a CUDA error).
int cause_k2_scratch_words(int P, int Kp) {
    bool radix = false;
    int fits = 0;
    if (k2_takes_radix(P, Kp, &radix) != cudaSuccess) return -1;
    if (radix) return 0;
    if (bf_fits_smem((size_t)k2_words(P, Kp) * sizeof(int32_t), &fits) !=
        cudaSuccess)
        return -1;
    return fits ? 0 : k2_words(P, Kp);
}

// CTAs an SM holds of the form a row of width P takes (network != 0:
// of the network form at that width, shared memory or scratch as it
// would run); -1 on a CUDA error.
int cause_k2_ctas_per_sm(int P, int Kp, int network) {
    bool radix = false;
    if (k2_takes_radix(P, Kp, &radix) != cudaSuccess) return -1;
    if (radix && !network) {
        int ctas = -1;
        K2Args a = {};
        if (k2_radix(false, a, 0, P, Kp, 1, 1, 0, &ctas) != cudaSuccess)
            return -1;
        return ctas;
    }
    int fits = 0;
    if (bf_fits_smem((size_t)k2_words(P, Kp) * sizeof(int32_t), &fits) !=
            cudaSuccess ||
        k2_net_attrs() != cudaSuccess)
        return -1;
    return bf_ctas_per_sm(k2_net_kernel, bf_threads(P),
                          fits ? (size_t)k2_words(P, Kp) * sizeof(int32_t)
                               : 0);
}

// K2 over B rows: six [B, P] inputs, outputs fc, ns, parent_up, run_w,
// hc, h_w [B, Kp] and run_id, glued, prev_kept [B, P], scal [B, 8]; all
// contiguous int32 device tensors. P and Kp powers of two, k_max <= Kp
// <= P, 1 <= U <= P. scratch is null or B * cause_k2_scratch_words
// int32. Returns the cudaError_t of the launch.
int cause_k2_runs(const void* sv_len, const void* sv_vc, const void* sv_tsp,
                  const void* keep, const void* cause_su,
                  const void* parent_su, void* fc, void* ns, void* parent_up,
                  void* run_w, void* hc, void* h_w, void* run_id,
                  void* glued, void* prev_kept, void* scal, int B, int P,
                  int Kp, int U, int k_max, void* scratch, void* stream) {
    if (B < 0 || P < 1 || (P & (P - 1)) || Kp < 1 || (Kp & (Kp - 1)) ||
        Kp > P || U < 1 || U > P || k_max < 1 || k_max > Kp)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    K2Args a = {(const int32_t*)sv_len, (const int32_t*)sv_vc,
                (const int32_t*)sv_tsp, (const int32_t*)keep,
                (const int32_t*)cause_su, (const int32_t*)parent_su,
                (int32_t*)fc, (int32_t*)ns, (int32_t*)parent_up,
                (int32_t*)run_w, (int32_t*)hc, (int32_t*)h_w,
                (int32_t*)run_id, (int32_t*)glued, (int32_t*)prev_kept,
                (int32_t*)scal};
    const cudaStream_t st = (cudaStream_t)stream;
    bool radix = false;
    cudaError_t e = k2_takes_radix(P, Kp, &radix);
    if (e != cudaSuccess) return (int)e;
    if (radix) return (int)k2_radix(true, a, B, P, Kp, U, k_max, st, nullptr);
    int fits = 0;
    e = bf_fits_smem((size_t)k2_words(P, Kp) * sizeof(int32_t), &fits);
    if (e != cudaSuccess) return (int)e;
    if (!fits && !scratch) return (int)cudaErrorInvalidValue;
    e = k2_net_attrs();
    if (e != cudaSuccess) return (int)e;
    const size_t smem = fits ? (size_t)k2_words(P, Kp) * sizeof(int32_t) : 0;
    k2_net_kernel<<<B, bf_threads(P), smem, st>>>(
        a, P, Kp, U, k_max, (int32_t*)scratch, fits);
    return (int)cudaGetLastError();
}

}  // extern "C"
