// Shared machinery of the two phase prefix-sum kernels (dc_chain.cu,
// phase_cumsum.cu): out[b, p] = sum of v[b, q] over q <= p, q = p mod 3.
//
// A row is cut into tiles of TILE = 3,072 consecutive positions, a
// multiple of 3, so a position's phase is its offset in the tile mod 3.
// A block owns a chunk of `tpb` consecutive tiles of one row, and every
// launch runs two kernels, one block per (row, chunk) each (the grid's x
// axis is the row):
//
//   reduce  for c < chunks - 1, the chunk's three phase totals into
//           scratch[b, c, 0..2] (dc-chain's takes two rows a block);
//   scan    the sum of scratch[b, 0..c-1] as the chunk's carry, then its
//           tiles in order: load the tile into shared memory with
//           coalesced 16-byte loads, let each thread scan its 12
//           consecutive positions (4 a phase), scan the threads' three
//           phase totals across the block, write back, store coalesced,
//           and add the tile's totals to the carry.
//
// Both kernels load the next tile into registers before they work on
// the current one, so a block's loads overlap its scans and barriers.
// Every sum is a double (`acc_t`): the f32 inputs add in float64 (chunk
// totals, carries and the scratch too) and each output rounds to f32
// once, so the kernels give the plain twins' f64-then-rounded sums, not
// sums rounded at every add: a coding score is a difference of two prefix
// sums, and an f32 rounding there moved a node's score across one of the
// scoring's thresholds (cscore < 5) on the card where the twin and the
// exact engine did not.  The f64 adds are not free: on an H100 (700 W)
// dc-chain over the 2.56 Mbp genome's 16 bin rows went from 0.1014 to
// 0.1248 ms (51.2% to 41.6% of its byte bound) and phase-cumsum over a
// std launch's (128, 49,152) rows from 0.0273 to 0.0307 ms against the
// same kernels summing in f32.  Every sum has a fixed order (sequential
// chains, shuffle trees of fixed shape), so two calls on the same inputs
// give the same bits, and an output lies within one f32 ulp of the
// twin's (`star_cuda.round_once_bound`).

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>

namespace phase_scan {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 12;                 // consecutive positions a thread
constexpr int TILE = THREADS * ITEMS;     // 3,072 = 3 * 1,024
constexpr int SLOTS = TILE / 4 / THREADS;  // 16-byte slots a thread: 3
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_TILES_PER_BLOCK = 16;

// every sum of the two kernels: inputs and outputs stay float32
using acc_t = double;

static_assert(TILE % 3 == 0 && ITEMS % 3 == 0 && ITEMS % 4 == 0,
              "a tile and a thread's positions are whole triples and whole "
              "16-byte slots, so a position's phase is its index mod 3");

__host__ __device__ inline long long tiles_of(long long S) {
    return (S + TILE - 1) / TILE;
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Exclusive scan over the block of each thread's three phase totals `a`:
// `excl` gets the sum over lower threads, `total` the block's sum.  A
// Hillis-Steele shuffle scan in each warp (5 levels), then warp 0 scans
// the warp totals (3 levels).  Two barriers; `wsum` (3 WARPS sums) and
// `wofs` (3 WARPS + 3) are free again after the caller's next barrier.
__device__ __forceinline__ void block_scan3(const acc_t (&a)[3],
                                            acc_t (&excl)[3],
                                            acc_t (&total)[3], acc_t* wsum,
                                            acc_t* wofs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    acc_t inc[3], wex[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) inc[k] = a[k];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const acc_t y = __shfl_up_sync(FULL, inc[k], off);
            if (lane >= off) inc[k] += y;
        }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const acc_t y = __shfl_up_sync(FULL, inc[k], 1);
        wex[k] = lane == 0 ? 0.0 : y;
    }
    if (lane == 31)
#pragma unroll
        for (int k = 0; k < 3; ++k) wsum[warp * 3 + k] = inc[k];
    __syncthreads();
    if (warp == 0) {
        acc_t s[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) s[k] = lane < WARPS ? wsum[lane * 3 + k]
                                                        : 0.0;
#pragma unroll
        for (int off = 1; off < WARPS; off <<= 1)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const acc_t y = __shfl_up_sync(FULL, s[k], off);
                if (lane >= off) s[k] += y;
            }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const acc_t y = __shfl_up_sync(FULL, s[k], 1);
            if (lane < WARPS) wofs[lane * 3 + k] = lane == 0 ? 0.0 : y;
            if (lane == WARPS - 1) wofs[WARPS * 3 + k] = s[k];
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        excl[k] = wofs[warp * 3 + k] + wex[k];
        total[k] = wofs[WARPS * 3 + k];
    }
}


// Sum of N values over the block, in every thread: a shuffle-down tree
// in each warp (5 levels), then a pairwise tree over the WARPS warp
// totals (3 levels) that every thread computes alike.  `red` holds
// N * WARPS sums; it is free again after the caller's next barrier.
template <int N>
__device__ __forceinline__ void block_sum(acc_t (&a)[N], acc_t* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < N; ++k) a[k] += __shfl_down_sync(FULL, a[k], off);
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < N; ++k) red[warp * N + k] = a[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < N; ++k) {
        acc_t w[WARPS];
#pragma unroll
        for (int i = 0; i < WARPS; ++i) w[i] = red[i * N + k];
#pragma unroll
        for (int h = WARPS / 2; h > 0; h >>= 1)
#pragma unroll
            for (int i = 0; i < h; ++i) w[i] = w[2 * i] + w[2 * i + 1];
        a[k] = w[0];
    }
}

// Shared memory of a scan block besides its two tile buffers.
struct ScanSmem {
    acc_t wsum[3 * WARPS];
    acc_t wofs[3 * WARPS + 3];
    acc_t red[3 * WARPS];
};

// A kernel's source of values, `Src`: a row (or N rows, for reduce_chunk)
// that loads a whole tile as SLOTS 16-byte vectors a thread (slot
// t + k THREADS: positions 4 slot .. 4 slot + 3 of the tile), and
//   bool vec() const                    16-byte loads are aligned
//   void load(Vec (&v)[SLOTS], p0)      a whole tile's vectors
//   void put(float* buf, v)             their values into buf, in order
//   void add(acc_t (&acc)[N][3], v)     their values into the rotated
//                                       phase totals (see reduce_chunk)
//   void add_one(acc, m, p)             one value into acc[.][m], and
//   float value(p)                      one value: the 4-byte path

// Slot t + k THREADS of a tile, values v, into the rotated phase totals
// of thread t (see reduce_chunk).
__device__ __forceinline__ void add_slot(acc_t (&acc)[3], int k,
                                         const float4& v) {
    acc[k % 3] += v.x;
    acc[(k + 1) % 3] += v.y;
    acc[(k + 2) % 3] += v.z;
    acc[k % 3] += v.w;
}

// The phase totals of chunk c (tpb whole tiles) of N rows, in every
// thread: tot[3 n + phase].  acc[n][m] sums phase (t + m) mod 3 of thread
// t: slot t + k THREADS starts at phase (t + k) mod 3 and element
// t + q THREADS has phase (t + q) mod 3, so every value's accumulator is
// known at compile time; the totals are unrotated at the end, then
// summed over the block.  The next tile's vectors load while the current
// one is summed.
template <int N, class Src>
__device__ __forceinline__ void reduce_chunk(const Src& src, int c, int tpb,
                                             acc_t (&tot)[3 * N],
                                             acc_t* red) {
    static_assert(THREADS % 3 == 1, "slot t + k THREADS: phase (t + k) % 3");
    acc_t acc[N][3];
#pragma unroll
    for (int r = 0; r < N; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0;
    const long long t0 = (long long)c * tpb;
    if (src.vec()) {
        typename Src::Vec v[SLOTS], w[SLOTS];
        src.load(v, t0 * TILE);
        for (int i = 0; i < tpb; ++i) {
#pragma unroll
            for (int k = 0; k < SLOTS; ++k) w[k] = v[k];
            if (i + 1 < tpb) src.load(v, (t0 + i + 1) * TILE);
            src.add(acc, w);
        }
    } else {
        for (int i = 0; i < tpb; ++i) {
            const long long p0 = (t0 + i) * TILE;
#pragma unroll
            for (int q = 0; q < ITEMS; ++q)
                src.add_one(acc, q % 3, p0 + threadIdx.x + q * THREADS);
        }
    }
    const int rot = threadIdx.x % 3;
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
        for (int ph = 0; ph < 3; ++ph) {
            const int m = (ph - rot + 3) % 3;
            tot[3 * r + ph] = m == 0 ? acc[r][0]
                                     : (m == 1 ? acc[r][1] : acc[r][2]);
        }
    block_sum<3 * N>(tot, red);
}

// One tile of the scan pass.  `buf` (TILE floats, 16-byte aligned) holds
// the tile's values in order, zero past the row's end, and the caller has
// synchronised since writing it.  Each thread scans its ITEMS positions,
// the block scans the threads' phase totals, the results go back into
// `buf` (then a barrier), each rounded to f32 once, and are stored to
// `dst` (the tile's first output, n valid positions): float4 stores when
// the tile is whole and `dst` is 16-byte aligned, else coalesced scalar
// stores.  `carry` advances by the tile's totals.
__device__ __forceinline__ void scan_tile(float* buf, float* __restrict__ dst,
                                          int n, acc_t (&carry)[3],
                                          ScanSmem& sm) {
    float4* b4 = reinterpret_cast<float4*>(buf);
    acc_t loc[ITEMS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
        const float4 v = b4[threadIdx.x * SLOTS + s];
        loc[4 * s] = v.x;
        loc[4 * s + 1] = v.y;
        loc[4 * s + 2] = v.z;
        loc[4 * s + 3] = v.w;
    }
#pragma unroll
    for (int j = 3; j < ITEMS; ++j) loc[j] += loc[j - 3];
    const acc_t agg[3] = {loc[ITEMS - 3], loc[ITEMS - 2], loc[ITEMS - 1]};
    acc_t excl[3], total[3], base[3];
    block_scan3(agg, excl, total, sm.wsum, sm.wofs);
#pragma unroll
    for (int k = 0; k < 3; ++k) base[k] = carry[k] + excl[k];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
        b4[threadIdx.x * SLOTS + s] = make_float4(
            (float)(base[(4 * s) % 3] + loc[4 * s]),
            (float)(base[(4 * s + 1) % 3] + loc[4 * s + 1]),
            (float)(base[(4 * s + 2) % 3] + loc[4 * s + 2]),
            (float)(base[(4 * s + 3) % 3] + loc[4 * s + 3]));
#pragma unroll
    for (int k = 0; k < 3; ++k) carry[k] += total[k];
    __syncthreads();
    if (n == TILE && aligned16(dst)) {
        float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
            d4[threadIdx.x + s * THREADS] = b4[threadIdx.x + s * THREADS];
    } else {
        for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = buf[i];
    }
}

// The scan pass of chunk c of a row: its carry from the row's chunk
// totals `scr` (3 a chunk, float64), then its tiles in order, the next whole
// tile's vectors loaded while the current one is scanned.
template <class Src>
__device__ __forceinline__ void scan_chunk(const Src& src,
                                           const acc_t* __restrict__ scr,
                                           float* __restrict__ orow,
                                           long long S, int c, int tpb,
                                           float (*buf)[TILE],
                                           ScanSmem& sm) {
    acc_t carry[3] = {0.0, 0.0, 0.0};
    for (int i = threadIdx.x; i < c; i += THREADS)
#pragma unroll
        for (int k = 0; k < 3; ++k) carry[k] += scr[3 * i + k];
    block_sum<3>(carry, sm.red);
    const long long T = tiles_of(S);
    const long long t0 = (long long)c * tpb;
    const long long t1 = t0 + tpb < T ? t0 + tpb : T;
    const bool vec = src.vec();
    typename Src::Vec v[SLOTS];
    if (vec && (t0 + 1) * TILE <= S) src.load(v, t0 * TILE);
    int par = 0;
    for (long long t = t0; t < t1; ++t, par ^= 1) {
        const long long p0 = t * TILE;
        const int n = (int)min((long long)TILE, S - p0);
        float* bf = buf[par];
        if (vec && n == TILE) {
            src.put(bf, v);
            if (t + 1 < t1 && (t + 2) * TILE <= S) src.load(v, p0 + TILE);
        } else {
#pragma unroll
            for (int q = 0; q < ITEMS; ++q) {
                const int i = threadIdx.x + q * THREADS;
                bf[i] = i < n ? src.value(p0 + i) : 0.0f;
            }
        }
        __syncthreads();
        scan_tile(bf, orow + p0, n, carry, sm);
    }
}

// Checks shared by the two launchers; 0 when the launch is well formed.
inline int check_launch(int B, long long S, int tpb, long long* chunks) {
    if (B < 1 || S < 1 || tpb < 1 || tpb > MAX_TILES_PER_BLOCK)
        return (int)cudaErrorInvalidValue;
    *chunks = (tiles_of(S) + tpb - 1) / tpb;
    if (*chunks > 65535) return (int)cudaErrorInvalidValue;
    return 0;
}

}  // namespace phase_scan
