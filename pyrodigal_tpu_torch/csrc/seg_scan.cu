// seg_scan: the segmented running max of node scoring's passes 2 and 3
// (the ascending-coding penalty and the length factor; reference
// lib.pyx:2119-2239), one channel per codon phase.
//
// Replaces pyrodigal_tpu/ops/score_device.py::_seg_scan_incl (:347), with
// the _seg_scan and _sel_phase around it (:383, :411): an XLA blocked
// associative scan over (BT, n, 3), not a Pallas kernel.  It also
// replaces the library scans that stood in for it in this port
// (torch.cumsum and torch.cummax along axis 1 of (BT, n, 3) int64 keys,
// one thread per column).  For each row b, walk the nodes in order
// (reversed if `reverse`) with three running maxima seeded by init[b]: at
// node i of channel c = phase[i] (0, 1 or 2), a reset sets channel c to
// reset_val, else an elem takes max(channel c, values[b, i]), else
// nothing changes.  own[b, i] is channel c after node i (before it if
// `exclusive`); final[b] holds the three channels after the last node.
// The geometry rows (elem, reset, phase) are one row shared by every bin
// row (mega: row stride 0) or one row per bin row (std: row stride n).
//
// Bits.  A max is exact, so any tiling gives the plain twin's bits
// (star_cuda.seg_scan_plain).  A channel's running max is kept as the
// twin's order-preserving 32-bit key of the f32 value (star_cuda._ordered),
// so +0.0 ranks above -0.0 and NaNs rank where the twin ranks them; a
// channel that has seen no reset yields max(seed, running max) with
// torch.maximum's rule (NaN first, then fmaxf), as the twin computes it.
// Every walk position that is neither an elem nor a reset of a channel
// adds the twin's -3e38 filler to that channel, as the twin's scan does.
//
// What bounds it on the H100: bytes.  The genome's launch (BT 16, n
// 163,840, one shared geometry row) must read 10.5 MB of values and
// 1 MB of masks and phases, and write 10.5 MB: 6.6 us at 3.35 TB/s,
// against about 0.1 us for its 7.9 M channel maxima at the f32 rate.
//
// Design (simple first):
// - A tile is TILE = 2,304 consecutive walk positions of one row: 256
//   threads, 9 consecutive positions each.  One block per (tile, row),
//   so the genome's launch runs 72 x 16 = 1,152 blocks on the 132 SMs;
//   the tiling depends on n alone, not on the rows that share a launch.
// - Two kernels.  seg_scan_summary_kernel writes each tile's summary per
//   channel, (max since the tile's last reset, reset seen), to a (BT,
//   tiles, 3) scratch; seg_scan_kernel combines the summaries of the
//   tiles before its own into its carry, rescans its tile from that
//   carry, and writes `own` (and, in the row's last tile, `final`).
// - A tile is loaded coalesced (thread j at walk positions j + 256 k, a
//   descending address run on a reverse walk) into shared memory, where
//   each thread reads its 9 consecutive positions (a stride of 9 words:
//   no bank conflict).  The threads' summaries combine in a shuffle scan
//   across the block, in thread order.  Outputs go back through shared
//   memory and are stored coalesced.
// - The second pass reads the tile again, from L2 where the first pass
//   left it: 1.5x the bytes the bound counts.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 9;                  // consecutive positions a thread
constexpr int TILE = THREADS * ITEMS;     // 2,304 (star_cuda.SEG_TILE)
constexpr unsigned FULL = 0xffffffffu;
constexpr uint8_t PAD = 0xff;             // a walk position past the row
constexpr float NEGI = -3e38f;            // the twin's filler

static_assert(ITEMS % 2 == 1, "an odd stride: no shared-memory conflict");

// Order-preserving map of f32 bits to uint32 keys (star_cuda._ordered).
__device__ __forceinline__ unsigned ordered(float x) {
    const unsigned b = __float_as_uint(x);
    return b >= 0x80000000u ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float unordered(unsigned k) {
    return __uint_as_float(k >= 0x80000000u ? k & 0x7fffffffu : ~k);
}

// torch.maximum(a, b) on the card: a NaN operand first, then fmaxf.
__device__ __forceinline__ float torch_maximum(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return fmaxf(a, b);
}

// A run of walk positions: k[c] the largest key of channel c since the
// run's last reset of c (or over the whole run), bit c of r set when the
// run holds a reset of c.  The identity (no position) is all zero.
struct Seg {
    unsigned k[3];
    unsigned r;
};

__device__ __forceinline__ Seg identity() { return Seg{{0u, 0u, 0u}, 0u}; }

// The run a, then the run b.
__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
    Seg o;
#pragma unroll
    for (int c = 0; c < 3; ++c)
        o.k[c] = (b.r >> c) & 1u ? b.k[c] : max(a.k[c], b.k[c]);
    o.r = a.r | b.r;
    return o;
}

// s, then one walk position: code = phase | elem << 2 | reset << 3, or
// PAD.  A reset takes precedence over an elem, as in the twin.
__device__ __forceinline__ void step(Seg& s, uint8_t code, float v,
                                     unsigned kreset, unsigned kneg) {
    if (code == PAD) return;
    const unsigned p = code & 3u;
    const unsigned kv = code & 4u ? ordered(v) : kneg;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        if (p == (unsigned)c && (code & 8u)) {
            s.k[c] = kreset;
            s.r |= 1u << c;
        } else {
            s.k[c] = max(s.k[c], p == (unsigned)c ? kv : kneg);
        }
    }
}

// Channel p of the state s as the twin's inclusive scan gives it.
__device__ __forceinline__ float value(const Seg& s, unsigned p,
                                       const float (&seed)[3]) {
    const unsigned k = p == 0 ? s.k[0] : (p == 1 ? s.k[1] : s.k[2]);
    const float sd = p == 0 ? seed[0] : (p == 1 ? seed[1] : seed[2]);
    return (s.r >> p) & 1u ? unordered(k) : torch_maximum(sd, unordered(k));
}

__device__ __forceinline__ Seg shfl_up(const Seg& s, int off) {
    Seg o;
#pragma unroll
    for (int c = 0; c < 3; ++c) o.k[c] = __shfl_up_sync(FULL, s.k[c], off);
    o.r = __shfl_up_sync(FULL, s.r, off);
    return o;
}

// Scan over the block of one run per thread, in thread order: *excl gets
// the runs of the lower threads combined (the identity in thread 0); the
// block's total is returned to every thread.  A Hillis-Steele shuffle
// scan in each warp, then every thread combines the warp totals.  One
// barrier; `wtot` (WARPS runs) is free again after the caller's next
// barrier.
__device__ __forceinline__ Seg block_scan(const Seg& x, Seg* excl,
                                          Seg* wtot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    Seg inc = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const Seg y = shfl_up(inc, off);
        if (lane >= off) inc = combine(y, inc);
    }
    const Seg prev = shfl_up(inc, 1);
    if (lane == 31) wtot[warp] = inc;
    __syncthreads();
    Seg base = identity(), total = identity();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        if (w == warp) base = total;
        total = combine(total, wtot[w]);
    }
    *excl = lane == 0 ? base : combine(base, prev);
    return total;
}

// One row's operands.
struct Row {
    const float* v;           // values of the row
    const uint8_t* elem;      // its geometry row
    const uint8_t* reset;
    const int* phase;
    int n;
    bool reverse;

    __device__ __forceinline__ long long node(long long w) const {
        return reverse ? n - 1 - w : w;
    }
};

// Tile t of the row into shared memory, walk position w0 + q at q.
__device__ __forceinline__ void load_tile(const Row& row, int t, float* sv,
                                          uint8_t* sc) {
    const long long w0 = (long long)t * TILE;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int q = threadIdx.x + k * THREADS;
        const long long w = w0 + q;
        if (w < row.n) {
            const long long i = row.node(w);
            sv[q] = row.v[i];
            sc[q] = (uint8_t)(row.phase[i] | row.elem[i] << 2
                              | row.reset[i] << 3);
        } else {
            sc[q] = PAD;
        }
    }
}

__device__ __forceinline__ Row row_of(const float* values,
                                      const uint8_t* elem,
                                      const uint8_t* reset, const int* phase,
                                      int b, int n, int geo_stride,
                                      int reverse) {
    const long long g = (long long)b * geo_stride;
    return Row{values + (long long)b * n, elem + g, reset + g, phase + g, n,
               reverse != 0};
}

__global__ void __launch_bounds__(THREADS) seg_scan_summary_kernel(
        const float* __restrict__ values, const uint8_t* __restrict__ elem,
        const uint8_t* __restrict__ reset, const int* __restrict__ phase,
        unsigned long long* __restrict__ scratch, int n, int geo_stride,
        int tiles, float reset_val, int reverse) {
    __shared__ float sv[TILE];
    __shared__ uint8_t sc[TILE];
    __shared__ Seg wtot[WARPS];
    const int t = blockIdx.x, b = blockIdx.y;
    load_tile(row_of(values, elem, reset, phase, b, n, geo_stride, reverse),
              t, sv, sc);
    __syncthreads();
    const unsigned kreset = ordered(reset_val), kneg = ordered(NEGI);
    Seg s = identity();
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
        step(s, sc[threadIdx.x * ITEMS + q], sv[threadIdx.x * ITEMS + q],
             kreset, kneg);
    Seg excl;
    const Seg total = block_scan(s, &excl, wtot);
    if (threadIdx.x < 3) {
        const int c = threadIdx.x;
        scratch[((long long)b * tiles + t) * 3 + c] =
            (unsigned long long)((total.r >> c) & 1u) << 32 | total.k[c];
    }
}

__global__ void __launch_bounds__(THREADS) seg_scan_kernel(
        const float* __restrict__ values, const uint8_t* __restrict__ elem,
        const uint8_t* __restrict__ reset, const int* __restrict__ phase,
        const float* __restrict__ init, float* __restrict__ own,
        float* __restrict__ fin,
        const unsigned long long* __restrict__ scratch, int n,
        int geo_stride, int tiles, float reset_val, int reverse,
        int exclusive) {
    __shared__ float sv[TILE];
    __shared__ uint8_t sc[TILE];
    __shared__ Seg wtot[WARPS];
    const int t = blockIdx.x, b = blockIdx.y;
    const Row row = row_of(values, elem, reset, phase, b, n, geo_stride,
                           reverse);
    load_tile(row, t, sv, sc);

    // the carry: tiles 0 .. t-1 of the row, a run of consecutive tiles a
    // thread, combined in order across the block
    const unsigned long long* srow = scratch + (long long)b * tiles * 3;
    const int tid = threadIdx.x;
    const int per = (t + THREADS - 1) / THREADS;
    const int j1 = min((tid + 1) * per, t);
    Seg part = identity();
    for (int j = tid * per; j < j1; ++j) {
        Seg x;
        x.r = 0u;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const unsigned long long e = srow[3 * j + c];
            x.k[c] = (unsigned)e;
            x.r |= (unsigned)(e >> 32) << c;
        }
        part = combine(part, x);
    }
    Seg unused;
    const Seg carry = block_scan(part, &unused, wtot);
    __syncthreads();

    const unsigned kreset = ordered(reset_val), kneg = ordered(NEGI);
    const float seed[3] = {init[3 * b], init[3 * b + 1], init[3 * b + 2]};
    const int q0 = tid * ITEMS;
    float v[ITEMS];
    uint8_t code[ITEMS];
    Seg s = identity();
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
        v[q] = sv[q0 + q];
        code[q] = sc[q0 + q];
        step(s, code[q], v[q], kreset, kneg);
    }
    Seg excl;
    const Seg total = block_scan(s, &excl, wtot);
    Seg st = combine(carry, excl);
    const long long w0 = (long long)t * TILE + q0;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
        if (code[q] == PAD) continue;
        const unsigned p = code[q] & 3u;
        float out;
        if (exclusive) {
            out = w0 + q == 0 ? (p == 0 ? seed[0] : (p == 1 ? seed[1]
                                                             : seed[2]))
                              : value(st, p, seed);
            step(st, code[q], v[q], kreset, kneg);
        } else {
            step(st, code[q], v[q], kreset, kneg);
            out = value(st, p, seed);
        }
        sv[q0 + q] = out;
    }
    __syncthreads();
    float* orow = own + (long long)b * n;
    const long long wt = (long long)t * TILE;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int q = threadIdx.x + k * THREADS;
        if (wt + q < n) orow[row.node(wt + q)] = sv[q];
    }
    if (t == tiles - 1 && threadIdx.x == 0) {
        const Seg f = combine(carry, total);
#pragma unroll
        for (int c = 0; c < 3; ++c) fin[3 * b + c] = value(f, c, seed);
    }
}

}  // namespace

// values (BT, n) f32; elem, reset (R, n) bool and phase (R, n) int32 with
// R = 1 (geo_stride 0) or BT (geo_stride n); init (BT, 3) f32; own (BT, n)
// and fin (BT, 3) f32 out; scratch (BT, tiles, 3) uint64, tiles =
// ceil(n / 2,304).
extern "C" int seg_scan_launch(const float* values, const uint8_t* elem,
                               const uint8_t* reset, const int* phase,
                               const float* init, float* own, float* fin,
                               unsigned long long* scratch, int BT, int n,
                               int geo_stride, int tiles, float reset_val,
                               int reverse, int exclusive,
                               cudaStream_t stream) {
    if (BT < 1 || BT > 65535 || n < 1 || (geo_stride != 0 && geo_stride != n)
        || tiles != (n + TILE - 1) / TILE)
        return (int)cudaErrorInvalidValue;
    if (tiles > 1) {
        seg_scan_summary_kernel<<<dim3(tiles - 1, BT), THREADS, 0, stream>>>(
            values, elem, reset, phase, scratch, n, geo_stride, tiles,
            reset_val, reverse);
        const int err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    seg_scan_kernel<<<dim3(tiles, BT), THREADS, 0, stream>>>(
        values, elem, reset, phase, init, own, fin, scratch, n, geo_stride,
        tiles, reset_val, reverse, exclusive);
    return (int)cudaGetLastError();
}
