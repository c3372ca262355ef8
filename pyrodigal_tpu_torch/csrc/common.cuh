// Shared device helpers of the port's kernels.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

// pyrodigal_tpu._constants
#define OPER_DIST 60
#define MAX_OPP_OVLP 200

// dp_pallas.INT_NEG, NEGF / 2 and the "no candidate" key of the DP kernels
constexpr int INT_NEG = -(1 << 30);
constexpr float NEGF_HALF = -1e30f / 2.0f;
constexpr long long NO_KEY = INT64_MIN;

// Same-strand intergenic modifier (reference: _connection.h:52-78), in
// float32 with the operation order of pyrodigal_tpu.ops.dp_pallas._igm_same.
// The library is built with -fmad=false, so no multiply-add below is fused.
// `q60`, when given, holds (float)d / OPER_DIST for d = 0 .. OPER_DIST,
// the quotients an operon bonus can use (an operon has dist <= OPER_DIST),
// in place of the division: the same IEEE-rounded bits.
__device__ __forceinline__ float igm_same(int ndx1, int strand1, float rsc1,
                                          float usc1, int ndx2, float rsc2,
                                          float usc2, float st_wt,
                                          const float* q60 = nullptr) {
    int dist = abs(ndx1 - ndx2);
    bool overlap = ndx1 + 2 * strand1 >= ndx2;
    bool adjacent = (ndx1 + 2 == ndx2) || (ndx1 == ndx2 + 1);
    bool fwd = strand1 == 1;
    float r_n = fwd ? rsc2 : rsc1;
    float u_n = fwd ? usc2 : usc1;
    float rval = adjacent ? ((r_n < 0.0f ? -r_n : 0.0f)
                             + (u_n < 0.0f ? -u_n : 0.0f))
                          : 0.0f;
    bool far = dist > 3 * OPER_DIST;
    bool operon = ((dist <= OPER_DIST) && !overlap) || (dist * 4 < OPER_DIST);
    if (q60 != nullptr) {
        const float q = operon ? q60[dist] : 0.0f;
        const float bonus = (2.0f - q) * 0.15f * st_wt;
        return rval + (far ? -0.15f * st_wt : (operon ? bonus : 0.0f));
    }
    float bonus = (2.0f - (float)dist / (float)OPER_DIST) * 0.15f * st_wt;
    return rval + (far ? -0.15f * st_wt : (operon ? bonus : 0.0f));
}

// Fill q60 (OPER_DIST + 1 floats of shared memory) for igm_same; the
// caller syncs before the first use.
__device__ __forceinline__ void fill_q60(float* q60) {
    for (int d = threadIdx.x; d <= OPER_DIST; d += blockDim.x)
        q60[d] = (float)d / (float)OPER_DIST;
}

// Fixed-point quantisation, round half to even as jnp.round, except that
// a negative value never rounds to 0: a node's baseline is (0, no source)
// and the DP takes a tie by its source index, so a gene worth -0.0002 would
// otherwise enter the path that the exact engine refuses.
__device__ __forceinline__ int quant(float x, float fxs) {
    const int q = __float2int_rn(x * fxs);
    return (q == 0 && x < 0.0f) ? -1 : q;
}

// A DP candidate as one int64 key: the value in the high word, `low` (the
// source index, with more bits below it if the caller packs any) in the
// low word, so a max over keys is the lexicographic (value, low) max.
__device__ __forceinline__ long long pack(int value, unsigned low) {
    return (long long)value * 4294967296LL + (long long)low;
}

__device__ __forceinline__ int key_value(long long key) {
    return (int)(key >> 32);
}

// Triple-overlap term of a fwd-stop source for a rev-stop target
// (dp_pallas.py:223-236, 866-882): the best star value of the target's
// three frames, seeded at 0.0 with a strict `>`; returns the frame m (-1:
// none) and *val.  `left` = ndx[j] + 2, `bnd` = tbndx[j].
__device__ __forceinline__ int triple_overlap(int left, int tb_j, int bnd,
                                             const float* v3, const int* sv3,
                                             const int* nd3, float* val) {
    float bv = 0.0f;
    int bf = -1;
    for (int k = 0; k < 3; ++k) {
        int o = left - sv3[k] + 3;
        bool vald = o > 0 && o < MAX_OPP_OVLP && o < nd3[k] - left
                    && tb_j != -1 && o < sv3[k] - bnd - 2;
        if (vald && v3[k] > bv) {
            bv = v3[k];
            bf = k;
        }
    }
    *val = bv;
    return bf;
}

// Block-wide max of one int64 key per thread (a `pack` key); every thread
// gets it, after ONE __syncthreads.  Within a warp the max is two
// single-instruction reductions (the value word, then the low word among
// the lanes holding the largest value); across warps each warp leader
// writes its key to `red` (THREADS / 32 entries) and every thread reads
// them all.  `red` is still being read when this returns: the caller
// alternates between two buffers, so that the next call's writes land in
// the other one and the following call's writes come after the next
// call's barrier.
template <int THREADS>
__device__ __forceinline__ long long block_max(long long key,
                                               long long* red) {
    const int hv = (int)(key >> 32);
    const unsigned lv = (unsigned)(key & 0xffffffffLL);
    const int wh = __reduce_max_sync(0xffffffffu, hv);
    const unsigned wl = __reduce_max_sync(0xffffffffu, hv == wh ? lv : 0u);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = pack(wh, wl);
    __syncthreads();
    long long best = red[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w)
        best = red[w] > best ? red[w] : best;
    return best;
}

// Exclusive block-wide prefix sum of one packed count word per thread
// (several small counts in 16-bit fields, summed field by field: no field
// may pass 65,535 over the block); *total gets the block sum.  Ends with
// its shared buffer free for reuse.
template <int THREADS>
__device__ __forceinline__ unsigned long long block_exclusive_scan_u64(
        unsigned long long x, unsigned long long* total) {
    constexpr int WARPS = THREADS / 32;
    __shared__ unsigned long long warp_sums[WARPS];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    unsigned long long incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        unsigned long long y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    unsigned long long warp_off = 0, sum = 0;
    for (int w = 0; w < WARPS; ++w) {
        if (w < warp) warp_off += warp_sums[w];
        sum += warp_sums[w];
    }
    __syncthreads();
    *total = sum;
    return warp_off + (incl - x);
}

// Field f (16 bits) of a packed count word.
__device__ __forceinline__ int field16(unsigned long long x, int f) {
    return (int)((x >> (16 * f)) & 0xffffULL);
}
