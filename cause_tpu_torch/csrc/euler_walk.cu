// B2: weighted preorder base per run of each row's contracted forest, by
// list ranking of its Euler tour: one CTA per row, or (row, block) CTAs
// for rows too wide for shared memory (below).
//
// Replaces the Pallas kernel of cause_tpu/weaver/pallas_ops.py
// (`_walk_kernel`, launched by the pallas_call at :139 and :161 behind
// `euler_walk`, :184). Contract: for the [K] run tables of one row
// (first_child, next_sibling, parent with -1 at roots and invalid
// slots, run weights) write base[r] = the total weight of the runs
// visited before r in the preorder walk from run 0 that the Pallas
// automaton makes (visit: stamp, add the weight, descend to the first
// child; retreat: next sibling, else the parent; a link outside [0, K)
// ends the walk). Runs never reached keep the row's total weight, as
// jaxw._euler_rank gives them. Sums wrap as uint32, so they are
// associative and any order of summation gives the same bits.
//
// The walk is a list: the tour's 2K slots, d(i) = i (weight w[i]) and
// u(i) = K + i (weight 0), with successors
//   d(i) -> fc >= 0 ? d(fc) : u(i)
//   u(i) -> ns >= 0 ? d(ns) : parent >= 0 ? u(parent) : END,
// and base[i] is the weight of the slots before d(i) on the list from
// d(0).
//
// What bounds it on the H100: the bytes (5 x K x 4 B per row, 0.025 ms
// for the wave's 1024 rows at K = 4096) do not; a serial walk does, with
// one dependent shared-memory load per step (~8k steps a row). The
// design ranks the list with a ruling set (Helman-JaJa) in one CTA:
// 1. one slot in 32 is a splitter: slot s is splitter j = s * A mod M
//    (M = next_pow2(2K), A odd, about M / golden ratio: a bijection) when
//    j < M / 32, so slot 0 = d(0) is splitter 0.
//    Splitters at every 32nd slot INDEX would miss whole stretches
//    of a real tour: the wave's forests interleave two replicas' run
//    chains, one on even run ids and one on odd, and the odd chain's
//    2,000 slots hold no multiple of any power of two;
// 2. each thread walks from its splitter to the next splitter (or END,
//    or 2K steps on a cyclic row) and records the sublist's weight and
//    its next splitter;
// 3. one thread follows the splitter chain from splitter 0, giving each
//    splitter on it the weight before it (about 2K / 32 links);
// 4. each reached sublist is walked again, stamping its d-slots with the
//    weight before them. A slot no reached sublist visits is not on the
//    list from d(0) and keeps the row's total.
// A row's latency is its longest sublist twice plus the chain, instead
// of the whole tour. Walking the reached sublists again, instead of
// storing each slot's local prefix and owner in step 2, keeps every
// write to one sublist: no two reached sublists share a slot on an
// acyclic row, whatever the links' in-degree. Every loop is bounded, so
// a malformed (cyclic) row, whose values are unspecified, terminates.
//
// The successors (uint16), weights and bases of a row live in shared
// memory with the splitters' tables: 52 KB at K = 4096 (four rows an
// SM), 104 KB at K = 8192 (the doubled budget's rows stay there), 208 KB
// at K = 16384 (splitters one slot in 32).
//
// That "row" form fills the card when rows are many (the wave's 1,024).
// A row too wide for shared memory takes the "split" form, which also
// serves a call with few wide rows: there the row form would leave most
// SMs idle, and its one thread on the splitter chain would make 2K / 32
// dependent loads in turn (131,072 at the fleet row's K = 1,152,002).
// The split form spreads the same ruling set over (row, block) CTAs, its
// arrays in global scratch the wrapper allocates:
// a. links: the successors, and the row's total as a uint32 atomic sum
//    of the blocks' partials (wrapping: any order gives the same bits);
// b. sublists: step 2 above, a thread a splitter (picked by a hash that
//    mixes a slot's bits both ways, `split_hash`), every base set to
//    the total on the way;
// c. the splitter chain ranked by pointer jumping, ceil(log2(NS)) + 1
//    rounds of one launch each, nothing read back: each splitter keeps
//    the weight to its chain's end, its steps to the end and the
//    terminal (a splitter whose sublist ends the tour links to itself
//    and counts its own weight nowhere). A splitter is reached when its
//    terminal is splitter 0's and it is no farther from it (in-degree
//    at most one: both lie on one path); its prefix is splitter 0's
//    weight less its own;
// d. stamps: step 4 above, over CTAs.
// The caller picks the form (weaver/euler.py's walk_form: the row form
// wherever a row fits in shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_attrs.cuh"

#define CAUSE_WALK_THREADS 256
// one tour slot in 2^CAUSE_WALK_LOG_STRIDE is a splitter
#define CAUSE_WALK_LOG_STRIDE 5

// Int32 words of the row's int32 arrays: wgt[K], out[K], and per
// splitter sum, pref, next, reach.
__host__ __device__ inline size_t walk_words(int K, int NS) {
    return (size_t)2 * K + (size_t)4 * NS;
}

// Bytes of one row's area in shared memory, with uint16 successors.
static inline size_t walk_bytes(int K, int NS) {
    return walk_words(K, NS) * sizeof(int32_t) +
           (size_t)2 * K * sizeof(uint16_t);
}

// The splitters' hash: M = next_pow2(2K), A odd and about M / golden
// ratio; there are max(1, M / 32) splitter ids.
struct WalkHash {
    uint32_t mask;  // M - 1
    uint32_t a;
    uint32_t a_inv;  // A^-1 mod M
    int ns;
};

__host__ __device__ inline WalkHash walk_hash(int K) {
    uint32_t M = 1;
    while (M < 2u * (uint32_t)K) M <<= 1;
    WalkHash h;
    h.mask = M - 1;
    h.a = (uint32_t)(((uint64_t)M * 0x9E3779B9u) >> 32) | 1u;
    uint32_t x = h.a;  // Newton: x = A^-1 mod 2^32 after five steps
    for (int i = 0; i < 5; ++i) x *= 2u - h.a * x;
    h.a_inv = x;
    h.ns = (int)(M >> CAUSE_WALK_LOG_STRIDE) > 1
        ? (int)(M >> CAUSE_WALK_LOG_STRIDE) : 1;
    return h;
}

// The row form, a CTA a row. A successor >= 2K is END.
__global__ void __launch_bounds__(CAUSE_WALK_THREADS)
euler_walk_kernel(const int32_t* __restrict__ fc,
                  const int32_t* __restrict__ ns,
                  const int32_t* __restrict__ parent,
                  const int32_t* __restrict__ w, int32_t* __restrict__ base,
                  int K) {
    extern __shared__ __align__(16) int32_t walk_smem[];
    __shared__ uint32_t partial[CAUSE_WALK_THREADS / 32];
    const int two_k = 2 * K;
    const WalkHash hash = walk_hash(K);
    const int NS = hash.ns;
    // splitter id of slot s, or >= NS
    auto splitter = [&](int s) {
        return (int)(((uint32_t)s * hash.a) & hash.mask);
    };
    const size_t off = (size_t)blockIdx.x * (size_t)K;
    int32_t* wgt = walk_smem;
    int32_t* out = wgt + K;
    uint32_t* sum = (uint32_t*)(out + K);
    uint32_t* pref = sum + NS;
    int32_t* next = (int32_t*)(pref + NS);
    int32_t* reach = next + NS;
    uint16_t* succ = (uint16_t*)(reach + NS);

    // 1. the tour's successors, the weights, the row's total
    uint32_t acc = 0;
#pragma unroll 4
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
        const int f = fc[off + i], s = ns[off + i], p = parent[off + i];
        const int32_t wi = w[off + i];
        succ[i] = (uint16_t)(f < 0 ? K + i : f < K ? f : two_k);
        succ[K + i] = (uint16_t)(s >= 0 ? (s < K ? s : two_k)
                                        : (p >= 0 && p < K ? K + p : two_k));
        wgt[i] = wi;
        acc += (uint32_t)wi;
    }
    for (int d = 16; d > 0; d >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, d);
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
    __syncthreads();
    uint32_t total = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) total += partial[i];

    // 2. sublist weights and links; every base starts at the total
    for (int i = threadIdx.x; i < K; i += blockDim.x) out[i] = (int32_t)total;
    for (int j = threadIdx.x; j < NS; j += blockDim.x) {
        int cur = (int)(((uint32_t)j * hash.a_inv) & hash.mask), nxt = -1;
        uint32_t s = 0;
        // an id whose slot lies past the tour has an empty sublist
        for (int steps = 1; cur < two_k; ++steps) {
            if (cur < K) s += (uint32_t)wgt[cur];
            cur = (int)succ[cur];
            if (cur >= two_k) break;
            const int id = splitter(cur);
            if (id < NS) {
                nxt = id;
                break;
            }
            if (steps >= two_k) break;  // a cycle with no splitter on it
        }
        sum[j] = s;
        next[j] = nxt;
        reach[j] = 0;
    }
    __syncthreads();

    // 3. the splitter chain from d(0)
    if (threadIdx.x == 0) {
        uint32_t before = 0;
        int j = 0;
        for (int c = 0; c < NS && j >= 0; ++c) {
            pref[j] = before;
            reach[j] = 1;
            before += sum[j];
            j = next[j];
        }
    }
    __syncthreads();

    // 4. stamp the d-slots of the reached sublists
    for (int j = threadIdx.x; j < NS; j += blockDim.x) {
        if (!reach[j]) continue;
        int cur = (int)(((uint32_t)j * hash.a_inv) & hash.mask);
        uint32_t before = pref[j];
        for (int steps = 1;; ++steps) {
            if (cur < K) {
                out[cur] = (int32_t)before;
                before += (uint32_t)wgt[cur];
            }
            cur = (int)succ[cur];
            if (cur >= two_k || splitter(cur) < NS || steps >= two_k) break;
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < K; i += blockDim.x) base[off + i] = out[i];
}


// ------------------------------------------------------- the split form

// Rounds of pointer jumping that rank a chain of NS splitters.
static inline int walk_rounds(int NS) {
    int r = 0;
    while ((1 << r) < NS) ++r;
    return r + 1;
}

// The split form's splitters. The row form's hash multiplies, which
// carries a slot's low bits into its high ones but never the other way,
// so a tour that steps by a power of two passes long stretches of slots
// with no splitter: the fleet row's 1,024 replicas interleave their
// runs 1,024 ids apart, and at K = 1,025,536 one sublist held 2,667
// slots (chip_smoke.py phase 17). The split form mixes both ways, a
// bijection of [0, M): multiply by A, xor the top half of the bits into
// the bottom, multiply by C, again, multiply by A (its longest sublist
// there: about 360-430 slots, as for a random choice of one slot in 32).
struct SplitHash {
    uint32_t mask, a, a_inv, c, c_inv;
    int r;  // half the bits of M, rounded up: the xorshift is its own inverse
    int ns;
};

__host__ __device__ inline SplitHash split_hash(int K) {
    const WalkHash w = walk_hash(K);
    SplitHash h;
    h.mask = w.mask;
    h.a = w.a;
    h.a_inv = w.a_inv;
    h.ns = w.ns;
    int k = 0;
    while ((w.mask >> k) != 0) ++k;  // M = 2^k
    h.r = (k + 1) / 2;
    h.c = (0x85EBCA6Bu & w.mask) | 1u;
    uint32_t x = h.c;
    for (int i = 0; i < 5; ++i) x *= 2u - h.c * x;
    h.c_inv = x;
    return h;
}

// splitter id of slot s (a splitter when below NS), and its inverse
__device__ __forceinline__ int split_id(const SplitHash& h, int s) {
    uint32_t x = ((uint32_t)s * h.a) & h.mask;
    x ^= x >> h.r;
    x = (x * h.c) & h.mask;
    x ^= x >> h.r;
    return (int)((x * h.a) & h.mask);
}

__device__ __forceinline__ int split_slot(const SplitHash& h, int j) {
    uint32_t x = ((uint32_t)j * h.a_inv) & h.mask;
    x ^= x >> h.r;
    x = (x * h.c_inv) & h.mask;
    x ^= x >> h.r;
    return (int)((x * h.a_inv) & h.mask);
}

// A row's split-form arrays, in int32 words after the call's B totals:
// the tour's successors [2K], then weight to the end, steps to the end
// and the link of each splitter, two of each (the jumping's ping-pong).
__host__ __device__ inline size_t split_row_words(int K, int NS) {
    return (size_t)2 * K + (size_t)6 * NS;
}

__device__ __forceinline__ int32_t* split_succ(int32_t* scratch, int B,
                                               int row, int K, int NS) {
    return scratch + B + (size_t)row * split_row_words(K, NS);
}

// one of a row's two buffers of the jumping's state
struct SplitBuf {
    uint32_t* val;
    int32_t* dist;
    int32_t* nx;
};

__device__ __forceinline__ SplitBuf split_buf(int32_t* scratch, int B,
                                              int row, int K, int NS,
                                              int b) {
    int32_t* a = split_succ(scratch, B, row, K, NS) + 2 * (size_t)K +
                 (size_t)b * 3 * NS;
    return {(uint32_t*)a, a + NS, a + 2 * (size_t)NS};
}

// a. the tour's successors and the row's total (blockIdx.y is the row)
__global__ void __launch_bounds__(CAUSE_WALK_THREADS)
euler_walk_split_links(const int32_t* __restrict__ fc,
                       const int32_t* __restrict__ ns,
                       const int32_t* __restrict__ parent,
                       const int32_t* __restrict__ w, int B, int K,
                       int32_t* scratch) {
    __shared__ uint32_t partial[CAUSE_WALK_THREADS / 32];
    const int row = blockIdx.y, two_k = 2 * K;
    const size_t off = (size_t)row * K;
    int32_t* succ = split_succ(scratch, B, row, K, walk_hash(K).ns);
    uint32_t acc = 0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < K;
         i += gridDim.x * blockDim.x) {
        const int f = fc[off + i], s = ns[off + i], p = parent[off + i];
        succ[i] = f < 0 ? K + i : f < K ? f : two_k;
        succ[K + i] = s >= 0 ? (s < K ? s : two_k)
                             : (p >= 0 && p < K ? K + p : two_k);
        acc += (uint32_t)w[off + i];
    }
    for (int d = 16; d > 0; d >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, d);
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t sum = 0;
        for (int i = 0; i < CAUSE_WALK_THREADS / 32; ++i) sum += partial[i];
        atomicAdd((uint32_t*)scratch + row, sum);
    }
}

// b. each splitter's sublist: its weight and next splitter, as the
// jumping's first state; every base set to the row's total
__global__ void __launch_bounds__(CAUSE_WALK_THREADS)
euler_walk_split_sublists(const int32_t* __restrict__ w,
                          int32_t* __restrict__ base, int B, int K,
                          int32_t* scratch) {
    const int row = blockIdx.y, two_k = 2 * K;
    const size_t off = (size_t)row * K;
    const SplitHash hash = split_hash(K);
    const int NS = hash.ns;
    const int32_t* succ = split_succ(scratch, B, row, K, NS);
    const int32_t total = scratch[row];
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    for (int i = j; i < K; i += gridDim.x * blockDim.x) base[off + i] = total;
    if (j >= NS) return;
    int cur = split_slot(hash, j), nxt = -1;
    uint32_t s = 0;
    for (int steps = 1; cur < two_k; ++steps) {
        if (cur < K) s += (uint32_t)w[off + cur];
        cur = succ[cur];
        if (cur >= two_k) break;
        const int id = split_id(hash, cur);
        if (id < NS) {
            nxt = id;
            break;
        }
        if (steps >= two_k) break;  // a cycle with no splitter on it
    }
    const SplitBuf first = split_buf(scratch, B, row, K, NS, 0);
    first.val[j] = nxt >= 0 ? s : 0u;
    first.dist[j] = nxt >= 0 ? 1 : 0;
    first.nx[j] = nxt >= 0 ? nxt : j;
}

// c. one round of pointer jumping, buffer `src` into 1 - src
__global__ void __launch_bounds__(CAUSE_WALK_THREADS)
euler_walk_split_jump(int B, int K, int32_t* scratch, int src) {
    const int NS = walk_hash(K).ns;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= NS) return;
    const SplitBuf in = split_buf(scratch, B, blockIdx.y, K, NS, src);
    const SplitBuf out = split_buf(scratch, B, blockIdx.y, K, NS, 1 - src);
    const int n = in.nx[j];
    out.val[j] = in.val[j] + in.val[n];
    out.dist[j] = in.dist[j] + in.dist[n];
    out.nx[j] = in.nx[n];
}

// d. the reached sublists' d-slots stamped with the weight before them
__global__ void __launch_bounds__(CAUSE_WALK_THREADS)
euler_walk_split_stamp(const int32_t* __restrict__ w,
                       int32_t* __restrict__ base, int B, int K,
                       int32_t* scratch, int fin) {
    const int row = blockIdx.y, two_k = 2 * K;
    const size_t off = (size_t)row * K;
    const SplitHash hash = split_hash(K);
    const int NS = hash.ns;
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= NS) return;
    const int32_t* succ = split_succ(scratch, B, row, K, NS);
    const SplitBuf last = split_buf(scratch, B, row, K, NS, fin);
    if (last.nx[j] != last.nx[0] || last.dist[j] > last.dist[0]) return;
    uint32_t before = last.val[0] - last.val[j];
    int cur = split_slot(hash, j);
    for (int steps = 1;; ++steps) {
        if (cur < K) {
            base[off + cur] = (int32_t)before;
            before += (uint32_t)w[off + cur];
        }
        cur = succ[cur];
        if (cur >= two_k || split_id(hash, cur) < NS || steps >= two_k)
            break;
    }
}

static cudaError_t euler_walk_split(const int32_t* fc, const int32_t* ns,
                                    const int32_t* parent, const int32_t* w,
                                    int32_t* base, int B, int K,
                                    int32_t* scratch, cudaStream_t st) {
    const int NS = walk_hash(K).ns;
    const int per = CAUSE_WALK_THREADS;
    cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)B * sizeof(int32_t),
                                    st);
    if (e != cudaSuccess) return e;
    // a: four runs a thread; b-d: a splitter a thread
    const dim3 g_links((K + 4 * per - 1) / (4 * per), B);
    const dim3 g_ns((NS + per - 1) / per, B);
    euler_walk_split_links<<<g_links, per, 0, st>>>(fc, ns, parent, w, B, K,
                                                     scratch);
    euler_walk_split_sublists<<<g_ns, per, 0, st>>>(w, base, B, K, scratch);
    const int rounds = walk_rounds(NS);
    for (int r = 0; r < rounds; ++r)
        euler_walk_split_jump<<<g_ns, per, 0, st>>>(B, K, scratch, r & 1);
    euler_walk_split_stamp<<<g_ns, per, 0, st>>>(w, base, B, K, scratch,
                                                 rounds & 1);
    return cudaGetLastError();
}

extern "C" {

// Int32 words of global scratch the split form takes on B rows of K
// runs: B totals and B rows of split_row_words.
long long cause_euler_walk_scratch_words(int B, int K) {
    if (B < 1 || K < 1) return 0;
    return B + (long long)B * (long long)split_row_words(K, walk_hash(K).ns);
}

// Rank B forests of K runs. fc, ns, parent, w, base are [B, K]
// contiguous int32 device tensors; `split` picks the form: 0 the row
// form (2K <= 65535, a row in shared memory; a launch past the card's
// limit fails), 1 the split form, whose scratch holds
// cause_euler_walk_scratch_words(B, K) int32. Returns the cudaError_t of
// the launches.
int cause_euler_walk(const void* fc, const void* ns, const void* parent,
                     const void* w, void* base, int B, int K, int split,
                     void* scratch, void* stream) {
    if (B < 0 || K < 0) return (int)cudaErrorInvalidValue;
    if (B == 0 || K == 0) return (int)cudaSuccess;
    const cudaStream_t st = (cudaStream_t)stream;
    if (split == 1) {
        if (!scratch || B > 65535) return (int)cudaErrorInvalidValue;
        return (int)euler_walk_split(
            (const int32_t*)fc, (const int32_t*)ns, (const int32_t*)parent,
            (const int32_t*)w, (int32_t*)base, B, K, (int32_t*)scratch, st);
    }
    if (split != 0 || 2 * K > 65535) return (int)cudaErrorInvalidValue;
    // as many rows an SM as shared memory holds: the whole carveout
    static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
    const cudaError_t e = smem_attrs_once(euler_walk_kernel, ready);
    if (e != cudaSuccess) return (int)e;
    euler_walk_kernel<<<B, CAUSE_WALK_THREADS,
                        walk_bytes(K, walk_hash(K).ns), st>>>(
        (const int32_t*)fc, (const int32_t*)ns, (const int32_t*)parent,
        (const int32_t*)w, (int32_t*)base, K);
    return (int)cudaGetLastError();
}

}  // extern "C"
