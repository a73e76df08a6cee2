// B2: weighted preorder walk of each row's contracted forest, one CTA
// per row.
//
// Replaces the Pallas kernel of cause_tpu/weaver/pallas_ops.py
// (`_walk_kernel`, launched by the pallas_call at :139 and :161 behind
// `euler_walk`, :184). Contract: for the [K] run tables of one row
// (first_child, next_sibling, parent with -1 at roots and invalid
// slots, run weights) write base[r] = the total weight of the runs
// visited before r in a preorder walk from run 0. The automaton is the
// Pallas one, step for step: mode 0 visits `cur` (stamps its base, adds
// its weight, descends to the first child), mode 1 retreats (next
// sibling if any, else the parent), at most 3K + 4 steps, ending when
// the retreat climbs past the root. Runs never reached keep the row's
// total weight, as jaxw._euler_rank gives them.
//
// What bounds it on the H100: not bytes (5 x K x 4 B per row, 80 KB at
// K = 4096) and not operations, but the serial chain of about 3K
// dependent loads that one thread makes: every step's address is the
// previous step's load. At K = 4096 that is ~12k dependent
// shared-memory round trips of ~30 cycles each, tens of microseconds
// per row, however many SMs are free.
//
// What the design does about it: the four tables and the output live in
// shared memory (loaded cooperatively by the whole CTA, 80 KB at
// K = 4096, so the launcher raises the dynamic shared-memory limit), so
// each step of the chain costs a shared-memory latency instead of an
// L2/HBM one; and the rows run in parallel, one CTA each, across the
// 132 SMs. A row too wide for shared memory walks its tables in global
// memory instead.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void euler_walk_kernel(const int32_t* __restrict__ fc,
                                  const int32_t* __restrict__ ns,
                                  const int32_t* __restrict__ parent,
                                  const int32_t* __restrict__ w,
                                  int32_t* __restrict__ base, int K,
                                  int use_smem) {
    extern __shared__ int32_t smem[];
    __shared__ uint32_t partial[32];
    const size_t off = (size_t)blockIdx.x * (size_t)K;
    const int32_t* t_fc = fc + off;
    const int32_t* t_ns = ns + off;
    const int32_t* t_par = parent + off;
    const int32_t* t_w = w + off;
    int32_t* t_base = base + off;

    // total weight of the row (int32 wraparound, as the reference sum)
    uint32_t acc = 0;
    for (int i = threadIdx.x; i < K; i += blockDim.x) acc += (uint32_t)t_w[i];
    for (int d = 16; d > 0; d >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, d);
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        uint32_t s = 0;
        for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += partial[i];
        partial[0] = s;
    }
    __syncthreads();
    const int32_t total = (int32_t)partial[0];

    if (use_smem) {
        int32_t* s_fc = smem;
        int32_t* s_ns = smem + K;
        int32_t* s_par = smem + 2 * K;
        int32_t* s_w = smem + 3 * K;
        int32_t* s_base = smem + 4 * K;
        for (int i = threadIdx.x; i < K; i += blockDim.x) {
            s_fc[i] = t_fc[i];
            s_ns[i] = t_ns[i];
            s_par[i] = t_par[i];
            s_w[i] = t_w[i];
            s_base[i] = total;
        }
        t_fc = s_fc;
        t_ns = s_ns;
        t_par = s_par;
        t_w = s_w;
    } else {
        for (int i = threadIdx.x; i < K; i += blockDim.x) t_base[i] = total;
    }
    __syncthreads();
    int32_t* out = use_smem ? smem + 4 * K : t_base;

    if (threadIdx.x == 0) {
        int cur = 0;
        uint32_t pos = 0;
        int mode = 0;
        const long long max_steps = 3LL * K + 4;
        for (long long steps = 0; cur >= 0 && cur < K && steps < max_steps;
             ++steps) {
            const bool visit = mode == 0;
            if (visit) out[cur] = (int32_t)pos;
            const int child = t_fc[cur];
            const int sib = t_ns[cur];
            const int par = t_par[cur];
            if (visit) {
                pos += (uint32_t)t_w[cur];
                mode = child >= 0 ? 0 : 1;
                cur = child >= 0 ? child : cur;
            } else {
                mode = sib >= 0 ? 0 : 1;
                cur = sib >= 0 ? sib : par;
            }
        }
    }
    __syncthreads();

    if (use_smem) {
        for (int i = threadIdx.x; i < K; i += blockDim.x) t_base[i] = out[i];
    }
}

extern "C" {

// Walk B forests of K runs. All pointers are [B, K] contiguous int32
// device tensors. Returns the cudaError_t of the launch.
int cause_euler_walk(const void* fc, const void* ns, const void* parent,
                     const void* w, void* base, int B, int K,
                     void* stream) {
    if (B < 0 || K < 0) return (int)cudaErrorInvalidValue;
    if (B == 0 || K == 0) return (int)cudaSuccess;
    int dev = 0, smem_limit = 0;
    cudaError_t q = cudaGetDevice(&dev);
    if (q == cudaSuccess)
        q = cudaDeviceGetAttribute(
            &smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (q != cudaSuccess) return (int)q;
    const size_t bytes = (size_t)5 * (size_t)K * sizeof(int32_t);
    // the block's static reduction buffer shares the same limit
    const int use_smem = bytes + 32 * sizeof(uint32_t) <= (size_t)smem_limit;
    const size_t smem = use_smem ? bytes : 0;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            euler_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    euler_walk_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
        (const int32_t*)fc, (const int32_t*)ns, (const int32_t*)parent,
        (const int32_t*)w, (int32_t*)base, K, use_smem);
    return (int)cudaGetLastError();
}

}  // extern "C"
