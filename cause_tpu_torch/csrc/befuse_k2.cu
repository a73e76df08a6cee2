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
// What it keeps out of device memory: six [P] inputs read once, three
// [P] and six [Kp] outputs written once (15 words per token at Kp = P,
// about 0.25 GB and 0.08 ms at the north star, B = 1024, P = Kp = 4096,
// at 3.35 TB/s). In truth it is bound by the in-block sibling sort (78
// network stages at Kp = 4096) and the five block scans.
//
// What the design does about it (against the Pallas kernel's one-hot
// chunk histograms, compaction sort and inverse-sort rides):
// - wcum, sp_pack, ec_pack and rs_cum are block scans;
// - contested is a shared-memory atomicAdd histogram over the parent
//   index (exact for integers in any order), over the reference's range
//   [0, min(P, 128 * ceil(U / 128)));
// - the head compaction is the scatter above; every other head field is
//   read at hc;
// - the sibling sort (packed, -hc; position) is B1's network over Kp,
//   and the parent rides in the key (packed >> 1), so no payload moves;
// - ns and fc are scatters: the sorted positions are a permutation, and
//   each parent has one first child.
// Every scatter index is below P or Kp by construction, overflow rows
// (n_runs > Kp) included. Shared memory: five [P] arrays and the sort
// area, 130 KB at P = Kp = 4096; wider rows run on a global scratch row.

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
k2_kernel(K2Args a, int P, int Kp, int U, int k_max, int32_t* scratch,
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

    for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const bool keep = a.keep[row + i] != 0;
        wsum[i] = keep ? a.sv_len[row + i] : 0;
        sp[i] = keep ? 2 * i + (a.sv_tsp[row + i] != 0) : -1;
        ec[i] = 0;
        cls[i] = (keep ? K2_KEEP : 0) |
                 (keep && a.sv_vc[row + i] > 0 ? K2_SPECIAL : 0);
    }
    __syncthreads();
    block_scan<OpSum>(wsum, P, red);
    block_scan<OpMax>(sp, P, red);
    const int32_t n_kept = wsum[P - 1];
    const int32_t sp_last = sp[P - 1];
    __syncthreads();

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
    block_scan<OpMax>(ec, P, red);

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
    block_scan<OpSum>(rs, P, red);
    const int32_t n_runs = rs[P - 1];

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
    row_sort<2>(s);

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
}

extern "C" {

// Int32 words of global scratch per row (0: the row fits in shared
// memory; -1: a CUDA error).
int cause_k2_scratch_words(int P, int Kp) {
    int fits = 0;
    if (bf_fits_smem((size_t)k2_words(P, Kp), &fits) != cudaSuccess) return -1;
    return fits ? 0 : k2_words(P, Kp);
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
    int fits = 0;
    cudaError_t e = bf_fits_smem((size_t)k2_words(P, Kp), &fits);
    if (e != cudaSuccess) return (int)e;
    if (!fits && !scratch) return (int)cudaErrorInvalidValue;
    K2Args a = {(const int32_t*)sv_len, (const int32_t*)sv_vc,
                (const int32_t*)sv_tsp, (const int32_t*)keep,
                (const int32_t*)cause_su, (const int32_t*)parent_su,
                (int32_t*)fc, (int32_t*)ns, (int32_t*)parent_up,
                (int32_t*)run_w, (int32_t*)hc, (int32_t*)h_w,
                (int32_t*)run_id, (int32_t*)glued, (int32_t*)prev_kept,
                (int32_t*)scal};
    const size_t smem = fits ? (size_t)k2_words(P, Kp) * sizeof(int32_t) : 0;
    e = bf_smem_attr(k2_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    k2_kernel<<<B, bf_threads(P), smem, (cudaStream_t)stream>>>(
        a, P, Kp, U, k_max, (int32_t*)scratch, fits);
    return (int)cudaGetLastError();
}

}  // extern "C"
