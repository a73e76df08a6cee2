// The in-block bitonic row networks: the plain form is B1's network form
// (csrc/sort.cu: rows of P < 256, or of three or more keys that fit in
// shared memory); both forms serve the in-block sorts of the fused token
// kernels (befuse_k1/k2/k4.cu).
//
// Both forms sort P (a power of two) elements of ONE row inside one CTA,
// ascending and lexicographic over NK int32 keys with the element's
// position as the last key, so the order is THE stable order for every
// input (duplicate keys and int32-max sentinels included). The caller
// fills the keys and positions, synchronises the block, calls the
// network, and reads the sorted keys and positions (the permutation)
// back after it returns; every payload is then gathered by position.
//
// - bitonic_reg_smem: 8 consecutive elements per thread in registers.
//   Partners closer than 8 swap inside a thread, closer than 256 by warp
//   shuffles, and only the stages with j >= 256 go through shared memory.
//   Needs blockDim.x == P / 8, 256 <= P <= 4096, NK <= 2, and the columns
//   in shared memory in the padded layout pad32 (column stride
//   pad32(P)), so that a warp's strided accesses hit 32 distinct banks.
// - bitonic_net: the plain network, one pair per thread per stage, over
//   columns of stride P in shared OR global memory (a fused kernel's row
//   too wide for shared memory runs on a scratch row; __syncthreads
//   orders global writes within the block as it does shared ones). Any whole-warp
//   block size; a stage that stays inside a warp's 64-element chunk ends
//   with a warp barrier instead of a block barrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define CAUSE_SORT_RE 8           // elements per thread, register form
#define CAUSE_SORT_REG_MIN 256    // whole warps: P / 8 >= 32
#define CAUSE_SORT_REG_MAX 4096   // P / 8 <= 512 threads

template <int NK>
struct Elt {
    int32_t k[NK];
    int32_t p;
};

template <int NK>
__device__ __forceinline__ bool elt_less(const Elt<NK>& a, const Elt<NK>& b) {
#pragma unroll
    for (int q = 0; q < NK; ++q) {
        if (a.k[q] != b.k[q]) return a.k[q] < b.k[q];
    }
    return a.p < b.p;
}

// shared index with one padding word per 32: thread t's element
// 8t + e lands in bank (8t + t/4 + e) mod 32, distinct across a warp
__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

// partner e ^ J inside the thread (J < 8)
template <int NK, int J>
__device__ __forceinline__ void reg_stage(Elt<NK> (&v)[CAUSE_SORT_RE],
                                          int base, int k) {
#pragma unroll
    for (int e = 0; e < CAUSE_SORT_RE; ++e) {
        if ((e & J) == 0) {
            const bool asc = ((base + e) & k) == 0;
            if (elt_less(v[e + J], v[e]) == asc) {
                const Elt<NK> x = v[e];
                v[e] = v[e + J];
                v[e + J] = x;
            }
        }
    }
}

// keep the smaller of (own, other) where the pair sorts ascending and
// the own element is the lower one, or both flip; else the larger.
// Elements are distinct (the position key), so "not less" is "greater".
template <int NK>
__device__ __forceinline__ void keep_one(Elt<NK>& v, const Elt<NK>& o, int i,
                                       int j, int k) {
    const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
    if (elt_less(o, v) == keep_min) v = o;
}

// Register form. Keys in s_key (NK columns of stride pad32(P)), positions
// in s_pos, both at pad32(i); sorted in place. Ends with a block barrier.
template <int NK>
__device__ __forceinline__ void bitonic_reg_smem(int32_t* s_key,
                                                 int32_t* s_pos, int P) {
    const int Pp = pad32(P);
    const int base = threadIdx.x * CAUSE_SORT_RE;
    Elt<NK> v[CAUSE_SORT_RE];
#pragma unroll
    for (int e = 0; e < CAUSE_SORT_RE; ++e) {
#pragma unroll
        for (int q = 0; q < NK; ++q) v[e].k[q] = s_key[q * Pp + pad32(base + e)];
        v[e].p = s_pos[pad32(base + e)];
    }
    __syncthreads();

    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            if (j >= 32 * CAUSE_SORT_RE) {
                // partner in another warp: exchange through shared
#pragma unroll
                for (int e = 0; e < CAUSE_SORT_RE; ++e) {
#pragma unroll
                    for (int q = 0; q < NK; ++q)
                        s_key[q * Pp + pad32(base + e)] = v[e].k[q];
                    s_pos[pad32(base + e)] = v[e].p;
                }
                __syncthreads();
#pragma unroll
                for (int e = 0; e < CAUSE_SORT_RE; ++e) {
                    const int o_i = pad32((base + e) ^ j);
                    Elt<NK> o;
#pragma unroll
                    for (int q = 0; q < NK; ++q) o.k[q] = s_key[q * Pp + o_i];
                    o.p = s_pos[o_i];
                    keep_one(v[e], o, base + e, j, k);
                }
                __syncthreads();
            } else if (j >= CAUSE_SORT_RE) {
                // partner in lane threadIdx ^ (j / 8) of the same warp
                const int d = j / CAUSE_SORT_RE;
#pragma unroll
                for (int e = 0; e < CAUSE_SORT_RE; ++e) {
                    Elt<NK> o;
#pragma unroll
                    for (int q = 0; q < NK; ++q)
                        o.k[q] = __shfl_xor_sync(0xffffffffu, v[e].k[q], d);
                    o.p = __shfl_xor_sync(0xffffffffu, v[e].p, d);
                    keep_one(v[e], o, base + e, j, k);
                }
            } else if (j == 4) {
                reg_stage<NK, 4>(v, base, k);
            } else if (j == 2) {
                reg_stage<NK, 2>(v, base, k);
            } else {
                reg_stage<NK, 1>(v, base, k);
            }
        }
    }

#pragma unroll
    for (int e = 0; e < CAUSE_SORT_RE; ++e) {
#pragma unroll
        for (int q = 0; q < NK; ++q) s_key[q * Pp + pad32(base + e)] = v[e].k[q];
        s_pos[pad32(base + e)] = v[e].p;
    }
    __syncthreads();
}

// Plain form. Keys in buf (num_keys columns of stride P), positions in
// pos; sorted in place. Ends with a block barrier.
__device__ __forceinline__ void bitonic_net(int32_t* buf, int32_t* pos,
                                            int num_keys, int P) {
    const int half = P >> 1;
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = threadIdx.x; t < half; t += blockDim.x) {
                // pair t: lower element i (bit j clear) and its partner
                const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
                const int l = i + j;
                int c = 0;
                for (int q = 0; q < num_keys && c == 0; ++q) {
                    const int32_t a = buf[(size_t)q * P + i];
                    const int32_t b = buf[(size_t)q * P + l];
                    if (a != b) c = (a < b) ? -1 : 1;
                }
                const int32_t pi = pos[i];
                const int32_t pl = pos[l];
                if (c == 0) c = (pi < pl) ? -1 : 1;
                const bool asc = (i & k) == 0;
                if (asc ? (c > 0) : (c < 0)) {
                    for (int q = 0; q < num_keys; ++q) {
                        int32_t* col = buf + (size_t)q * P;
                        const int32_t x = col[i];
                        col[i] = col[l];
                        col[l] = x;
                    }
                    pos[i] = pl;
                    pos[l] = pi;
                }
            }
            // the next stage's partner distance: j / 2 within this
            // merge, else the first stage of the next one
            const int next_j = j > 1 ? (j >> 1) : k;
            if (j >= 64 || next_j >= 64) {
                __syncthreads();
            } else {
                __syncwarp();
            }
        }
    }
    __syncthreads();
}
