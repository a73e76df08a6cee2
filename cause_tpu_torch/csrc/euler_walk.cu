// B2: weighted preorder base per run of each row's contracted forest, by
// list ranking of its Euler tour, one CTA per row.
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
// at K = 16384 (splitters one slot in 32). A row too wide for that runs
// the same code on a global scratch row the wrapper allocates, with
// int32 successors.

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

// Bytes of one row's area with successors of `succ_bytes` each.
static inline size_t walk_bytes(int K, int NS, size_t succ_bytes) {
    return walk_words(K, NS) * sizeof(int32_t) + (size_t)2 * K * succ_bytes;
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

// S: the successor type, uint16_t in shared memory, int32_t on a global
// scratch row. A successor >= 2K is END.
template <typename S>
__global__ void __launch_bounds__(CAUSE_WALK_THREADS)
euler_walk_kernel(const int32_t* __restrict__ fc,
                  const int32_t* __restrict__ ns,
                  const int32_t* __restrict__ parent,
                  const int32_t* __restrict__ w, int32_t* __restrict__ base,
                  int K, int32_t* scratch) {
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
    int32_t* area = scratch
        ? scratch + (size_t)blockIdx.x *
              (walk_words(K, NS) + (size_t)two_k)
        : walk_smem;
    int32_t* wgt = area;
    int32_t* out = wgt + K;
    uint32_t* sum = (uint32_t*)(out + K);
    uint32_t* pref = sum + NS;
    int32_t* next = (int32_t*)(pref + NS);
    int32_t* reach = next + NS;
    S* succ = (S*)(reach + NS);

    // 1. the tour's successors, the weights, the row's total
    uint32_t acc = 0;
#pragma unroll 4
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
        const int f = fc[off + i], s = ns[off + i], p = parent[off + i];
        const int32_t wi = w[off + i];
        succ[i] = (S)(f < 0 ? K + i : f < K ? f : two_k);
        succ[K + i] = (S)(s >= 0 ? (s < K ? s : two_k)
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

extern "C" {

// Int32 words of global scratch per row for rows of K runs: 0 when the
// row fits in shared memory (uint16 successors need 2K <= 65535), -1 if
// the device query fails.
int cause_euler_walk_scratch_words(int K) {
    if (K < 1) return 0;
    int dev = 0, limit = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return -1;
    const int NS = walk_hash(K).ns;
    // the block's static reduction buffer shares the limit
    const bool fits = 2 * K <= 65535 &&
                      walk_bytes(K, NS, sizeof(uint16_t)) +
                              CAUSE_WALK_THREADS / 32 * sizeof(uint32_t) <=
                          (size_t)limit;
    return fits ? 0 : (int)(walk_words(K, NS) + (size_t)2 * K);
}

// Rank B forests of K runs. fc, ns, parent, w, base are [B, K]
// contiguous int32 device tensors; scratch is null when
// cause_euler_walk_scratch_words(K) is 0, else B times that many int32.
// Returns the cudaError_t of the launch.
int cause_euler_walk(const void* fc, const void* ns, const void* parent,
                     const void* w, void* base, int B, int K, void* scratch,
                     void* stream) {
    if (B < 0 || K < 0 || (!scratch && 2 * K > 65535))
        return (int)cudaErrorInvalidValue;
    if (B == 0 || K == 0) return (int)cudaSuccess;
    const cudaStream_t st = (cudaStream_t)stream;
    if (!scratch) {
        // as many rows an SM as shared memory holds: the whole carveout
        static std::atomic<bool> ready[CAUSE_MAX_DEVICES];
        const cudaError_t e = smem_attrs_once(euler_walk_kernel<uint16_t>,
                                              ready);
        if (e != cudaSuccess) return (int)e;
        euler_walk_kernel<uint16_t>
            <<<B, CAUSE_WALK_THREADS,
               walk_bytes(K, walk_hash(K).ns, sizeof(uint16_t)), st>>>(
                (const int32_t*)fc, (const int32_t*)ns,
                (const int32_t*)parent, (const int32_t*)w, (int32_t*)base, K,
                nullptr);
    } else {
        euler_walk_kernel<int32_t><<<B, CAUSE_WALK_THREADS, 0, st>>>(
            (const int32_t*)fc, (const int32_t*)ns, (const int32_t*)parent,
            (const int32_t*)w, (int32_t*)base, K, (int32_t*)scratch);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
