// seg_scan: the segmented running maxima of node scoring's passes 2 and 3
// (the ascending-coding penalty and the length factor; reference
// lib.pyx:2119-2239), one channel per codon phase, all four walks of a
// scoring launch in one launch.
//
// Replaces pyrodigal_tpu/ops/score_device.py::_seg_scan_incl (:347), with
// the _seg_scan and _sel_phase around it (:383, :411) and the chain of
// four scans that _score_items builds from them (:832-865): an XLA
// blocked associative scan over (BT, n, 3), not a Pallas kernel.
//
// The function (star_cuda.seg_scan_passes_plain).  For each row b, four
// walks over the nodes with three running maxima each, one per channel
// c = phase[i]: at node i a reset of the walk's strand sets channel c to
// reset_val, else an elem (a start of the walk's strand) takes
// max(channel c, value[b, i]), else nothing changes.  The walks:
//   f2  forward over cscore, seeded with `seed`, inclusive;
//   r2  reverse over cscore, seeded with `seed`, inclusive;
//   f3  forward over lfac_raw, seeded with r2's final channels, exclusive;
//   r3  reverse over lfac_raw, seeded with f3's final channels, exclusive.
// run2[b, i] is f2's channel at a forward node and r2's at a reverse one,
// run3[b, i] the same of f3 and r3 (the channel before the node, the seed
// at a walk's first node).  The geometry is one byte a node, code =
// phase | start << 2 | stop << 3 | fwd << 4, one row shared by every bin
// row (mega: row stride 0) or one row per bin row (std: row stride n).
//
// Bits.  A channel's running max is kept as the twin's order-preserving
// 32-bit key of the f32 value (star_cuda._ordered), so +0.0 ranks above
// -0.0 and NaNs rank where the twin ranks them; a channel that has seen no
// reset in its walk yields max(seed, running max) with torch.maximum's
// rule (NaN first, then fmaxf), as the twin computes it.  A walk's seed
// is the previous walk's final value in f32, never its keys: the twin
// takes `final` as a float and applies it with torch.maximum.  Every walk
// position that is neither an elem nor a reset of a channel adds the
// twin's -3e38 filler to that channel, as the twin's scan does.  A max is
// exact, so no tiling, look-back order or block count moves a bit.
//
// What bounds it on the H100.  Bytes, by the count: the genome's launch
// (BT 16, n 163,840, one shared geometry row) must read 21 MB of values
// and 0.16 MB of codes and write 21 MB, 12.6 us at 3.35 TB/s.  In practice
// the instructions: a walk position costs dozens of them to scan (three
// channels, each a mask, a select and a max) and more to emit, and a
// block's phases (load, scan, look-back, emit) each wait on the last, so
// the kernels run at a fifth of the byte bound (PERF.md).  The design
// keeps every position's work branch-free and every load in flight at
// once, and re-reads nothing from device memory.
//
// Design, two kernels behind one entry point:
// - seg_scan_rows_kernel, rows of at most ROW_LIMIT nodes (the std route's
//   3,072): one block a row.  The row's value keys and codes go to shared
//   memory once (10 bytes a node).  The forward half of the block walks
//   f2 and f3, the reverse half r2 and r3, each thread both walks of its
//   half over the same odd number of consecutive positions (no bank
//   conflict), so a code is decoded once for two walks.  Pass 1 leaves at each node of
//   the walks' own strand the node's channel of the thread-local states;
//   the halves scan their thread totals with shuffles and one barrier,
//   and every thread derives its walks' seeds from the half totals in
//   shared memory (r2's total gives f3's seed, f3's r3's), so the chain
//   costs no further barrier; pass 2 combines each node's local state
//   with its thread's prefix.  A walk reads and writes only its own
//   strand's nodes, so the outputs overwrite the keys in place and are
//   stored coalesced.  No carry, no scratch.
// - seg_scan_chain_kernel, longer rows (the mega route): a single-pass
//   decoupled look-back over tiles of TILE = 4,352 walk positions.  Each
//   row has four walks of ceil(n / TILE) tiles; blocks take tile ids from
//   an atomic counter, ordered by the tile's place in its chain (f2 and
//   r2 tiles, then f3, then r3) and then by row, so every tile a block
//   waits for holds a smaller id and is already running or done.  A tile
//   is read once (a whole tile with immediate offsets, the walk's last at
//   a clamped index with PAD codes past the row), scanned as the rows
//   kernel scans, publishes its aggregate per channel (a 64-bit word:
//   status, reset bit, key), looks back over its walk's earlier tiles
//   (one warp a channel, 32 tiles a step) to its exclusive prefix,
//   publishes its inclusive prefix, and only then waits for its seed:
//   f3's tiles for r2's final channels, r3's for f3's, each published by
//   the last tile of the walk before as one 64-bit word a channel.  The
//   seed enters only at output time, so a tile after a walk boundary
//   scans with the seed deferred.  The counter, the tile words and the
//   final words are a scratch the wrapper zeroes for every call (so a
//   CUDA graph replays the zeroing), never state of the module.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEGI = -3e38f;            // the twin's filler
constexpr unsigned PAD = 0x80u;           // a position past the row's end

// rows kernel: one block a row, half of it a direction; rows up to the
// std route's 3,072 nodes (star_cuda.SEG_ROW_LIMIT), a thread walking at
// most ROW_ITEMS positions (ceil(n / HALF), made odd)
constexpr int ROW_THREADS = 512;
constexpr int HALF = ROW_THREADS / 2;
constexpr int ROW_LIMIT = 3072;
constexpr int ROW_ITEMS = ROW_LIMIT / HALF + 1;

// chain kernel: a tile of TILE walk positions a block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 17;                 // consecutive positions a thread
constexpr int TILE = THREADS * ITEMS;     // 4,352 (star_cuda.SEG_TILE)

static_assert(ITEMS % 2 == 1 && ROW_ITEMS % 2 == 1,
              "an odd stride: no shared-memory conflict");
static_assert(ROW_LIMIT % ROW_THREADS == 0, "whole loads a thread");
static_assert(TILE > ROW_LIMIT, "rows of one tile take the rows kernel");

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
    const float m = fmaxf(a, b);
    return a != a ? a : (b != b ? b : m);
}

template <typename T>
__device__ __forceinline__ T pick(unsigned p, const T (&x)[3]) {
    return p == 0 ? x[0] : (p == 1 ? x[1] : x[2]);
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

// Whether a node's code, phase | start << 2 | stop << 3 | fwd << 4, is
// of the strand `strand` (1 forward, 0 reverse); PAD is of neither.
__device__ __forceinline__ bool own(unsigned code, unsigned strand) {
    return (code & (PAD | 16u)) == strand << 4;
}

// The code as a walk of that strand sees it: phase | elem << 2 | reset
// << 3, the start and stop bits kept only on the walk's own strand.
__device__ __forceinline__ unsigned walk_code(unsigned code,
                                              unsigned strand) {
    return own(code, strand) ? code & 15u : code & 3u;
}

// The filler a position adds to the channels it does not set: the twin's
// -3e38, or the identity's key 0 past the row (no effect).
__device__ __forceinline__ unsigned filler(unsigned code, unsigned kneg) {
    return code & PAD ? 0u : kneg;
}

// s, then one walk position of walk code wc whose value has key kv (used
// only at an elem) and whose filler is `fill` (`filler`).  A reset takes
// precedence over an elem, as in the twin.  Branch-free: channel p takes
// max(k & a, m) with a = 0 on a reset (the identity's key 0 is below every
// key) and m the reset's key, the value's or the filler; the other
// channels max(k, fill).
__device__ __forceinline__ void step(Seg& s, unsigned wc, unsigned kv,
                                     unsigned kreset, unsigned fill) {
    const unsigned p = wc & 3u;
    const unsigned rsm = 0u - ((wc >> 3) & 1u);
    const unsigned elm = 0u - ((wc >> 2) & 1u);
    const unsigned m = (kreset & rsm) | (((kv & elm) | (fill & ~elm)) & ~rsm);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const unsigned hm = p == (unsigned)c ? ~0u : 0u;
        s.k[c] = max(s.k[c] & ~(hm & rsm), (m & hm) | (fill & ~hm));
    }
    s.r |= (rsm & 1u) << p;
}

// Channel p of a state x (the walk before a thread's run, which has seen
// a position) followed by a thread-local state (lk, lr) of that channel,
// as the twin's scan gives it: torch.maximum(seed, .) where the walk has
// seen no reset of p.
__device__ __forceinline__ float finish(const Seg& x, unsigned lk,
                                        unsigned lr, unsigned p,
                                        const float (&seed)[3]) {
    const unsigned key = lr ? lk : max(pick(p, x.k), lk);
    const float v = unordered(key);
    return lr || ((x.r >> p) & 1u) ? v : torch_maximum(pick(p, seed), v);
}

__device__ __forceinline__ Seg shfl_up(const Seg& s, int off) {
    Seg o;
#pragma unroll
    for (int c = 0; c < 3; ++c) o.k[c] = __shfl_up_sync(FULL, s.k[c], off);
    o.r = __shfl_up_sync(FULL, s.r, off);
    return o;
}

// The inclusive shuffle scan of one run per thread over its warp, in lane
// order (Hillis-Steele): *prev gets the lanes below combined without the
// lane itself (garbage in lane 0); the warp's total goes to wtot[warp].
__device__ __forceinline__ void warp_scan(const Seg& x, Seg* prev,
                                          Seg* wtot) {
    const int lane = threadIdx.x & 31;
    Seg inc = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const Seg y = shfl_up(inc, off);
        if (lane >= off) inc = combine(y, inc);
    }
    *prev = shfl_up(inc, 1);
    if (lane == 31) wtot[threadIdx.x >> 5] = inc;
}

// After warp_scan and a barrier: the runs of the lower threads of the
// thread's group of GW consecutive warps combined (the identity in its
// first thread).
template <int GW>
__device__ __forceinline__ Seg group_excl(const Seg& prev, const Seg* wtot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int first = warp - warp % GW;
    Seg base = identity();
    for (int w = first; w < warp; ++w) base = combine(base, wtot[w]);
    return lane == 0 ? base : combine(base, prev);
}

// The total of the group of GW warps from warp `first` (after a barrier).
template <int GW>
__device__ __forceinline__ Seg group_total(const Seg* wtot, int first) {
    Seg total = identity();
#pragma unroll
    for (int w = 0; w < GW; ++w) total = combine(total, wtot[first + w]);
    return total;
}

// The three final channels of a walk whose whole run is `total`.
__device__ __forceinline__ void finals(const Seg& total,
                                       const float (&seed)[3],
                                       float (&fin)[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float v = unordered(total.k[c]);
        fin[c] = (total.r >> c) & 1u ? v : torch_maximum(seed[c], v);
    }
}

// ---------------------------------------------------------------------
// rows kernel
// ---------------------------------------------------------------------

// The block's halves walk a row in the two directions: the forward half
// f2 and f3, the reverse half r2 and r3, each thread both walks of its
// half over the same positions.  Pass 1 scans the thread's positions and
// leaves, at each node of its walks' own strand, the node's channel of
// the thread-local states (pass 2's after the node, pass 3's before it)
// in place of the values' keys, their reset bits in sr; pass 2 combines
// each with the thread's prefix into the output.  A walk reads and
// writes only its own strand's nodes, so the halves share no node.
__global__ void __launch_bounds__(ROW_THREADS) seg_scan_rows_kernel(
        const float* __restrict__ cscore, const float* __restrict__ lfac,
        const uint8_t* __restrict__ code, float* __restrict__ run2,
        float* __restrict__ run3, int n, int geo_stride, float reset_val,
        float seed0) {
    __shared__ unsigned s2[ROW_LIMIT];    // cscore's keys, then run2
    __shared__ unsigned s3[ROW_LIMIT];    // lfac_raw's keys, then run3
    __shared__ uint8_t sc[ROW_LIMIT];
    __shared__ uint8_t sr[ROW_LIMIT];     // the thread-local reset bits
    __shared__ Seg wtot2[ROW_THREADS / 32], wtot3[ROW_THREADS / 32];
    const long long row = (long long)blockIdx.x * n;
    const uint8_t* crow = code + (long long)blockIdx.x * geo_stride;
    // loads at a clamped index, no branch between them (what lands past
    // n is never read)
#pragma unroll
    for (int k = 0; k < ROW_LIMIT / ROW_THREADS; ++k) {
        const int q = threadIdx.x + k * ROW_THREADS, i = min(q, n - 1);
        s2[q] = ordered(cscore[row + i]);
        s3[q] = ordered(lfac[row + i]);
        sc[q] = crow[i];
    }
    __syncthreads();

    const bool forward = threadIdx.x < HALF;
    const unsigned strand = forward ? 1u : 0u;
    const int j = threadIdx.x % HALF;
    const unsigned kreset = ordered(reset_val), kneg = ordered(NEGI);
    const int items = ((n + HALF - 1) / HALF) | 1;
    const int w0 = min(j * items, n), w1 = min(w0 + items, n);
    Seg a2 = identity(), a3 = identity();
#pragma unroll
    for (int q = 0; q < ROW_ITEMS; ++q) {
        const int w = w0 + q;
        const int i = w < w1 ? (forward ? w : n - 1 - w) : 0;
        const unsigned cd = w < w1 ? sc[i] : PAD, p = cd & 3u;
        const bool mine = own(cd, strand);
        unsigned kv2 = 0u, kv3 = 0u;
        if (mine) {
            kv2 = s2[i];
            kv3 = s3[i];
        }
        const unsigned k3 = pick(p, a3.k), r3 = (a3.r >> p) & 1u;
        const unsigned wc = walk_code(cd, strand), fill = filler(cd, kneg);
        step(a2, wc, kv2, kreset, fill);
        step(a3, wc, kv3, kreset, fill);
        if (mine) {
            s2[i] = pick(p, a2.k);
            s3[i] = k3;
            sr[i] = (uint8_t)(((a2.r >> p) & 1u) | r3 << 1);
        }
    }
    Seg p2, p3;
    warp_scan(a2, &p2, wtot2);
    warp_scan(a3, &p3, wtot3);
    __syncthreads();
    constexpr int GW = HALF / 32;
    const Seg x2 = group_excl<GW>(p2, wtot2);
    const Seg x3 = group_excl<GW>(p3, wtot3);

    // seeds: f2 and r2 `seed0`; f3 r2's finals; r3 f3's finals
    const float s0[3] = {seed0, seed0, seed0};
    float fin2r[3], seed3[3];
    finals(group_total<GW>(wtot2, GW), s0, fin2r);
    finals(group_total<GW>(wtot3, 0), fin2r, seed3);
    if (forward) {
#pragma unroll
        for (int c = 0; c < 3; ++c) seed3[c] = fin2r[c];
    }

#pragma unroll
    for (int q = 0; q < ROW_ITEMS; ++q) {
        const int w = w0 + q;
        const int i = w < w1 ? (forward ? w : n - 1 - w) : 0;
        const unsigned cd = w < w1 ? sc[i] : PAD;
        if (own(cd, strand)) {
            const unsigned p = cd & 3u, r = sr[i];
            s2[i] = __float_as_uint(finish(x2, s2[i], r & 1u, p, s0));
            s3[i] = __float_as_uint(w == 0 ? pick(p, seed3)
                                           : finish(x3, s3[i], r >> 1, p,
                                                    seed3));
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ROW_LIMIT / ROW_THREADS; ++k) {
        const int i = threadIdx.x + k * ROW_THREADS;
        if (i < n) {
            run2[row + i] = __uint_as_float(s2[i]);
            run3[row + i] = __uint_as_float(s3[i]);
        }
    }
}

// ---------------------------------------------------------------------
// chain kernel
// ---------------------------------------------------------------------

// The tile words, one a (row, walk, tile, channel): status << 33 | reset
// bit << 32 | key, status AGGREGATE (the tile alone) or PREFIX (the walk
// up to and with the tile).  A final word, one a (row, r2 or f3,
// channel): 1 << 32 | the f32 bits.
constexpr unsigned long long AGGREGATE = 1ull, PREFIX = 2ull;

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
    atomicExch(p, v);
}

__device__ __forceinline__ unsigned long long peek(
        const unsigned long long* p) {
    return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ unsigned long long word(unsigned long long status,
                                                   unsigned r, unsigned k) {
    return status << 33 | (unsigned long long)(r & 1u) << 32 | k;
}

// Tile id -> (row, walk, tile within the walk): ids run over the tile's
// place in its row's chain j (f2 and r2 tiles 0 .. T-1 side by side, then
// f3's as T .. 2T-1, then r3's), then over rows.  Walks: 0 f2, 1 r2, 2
// f3, 3 r3.
__device__ __forceinline__ void tile_of(int id, int BT, int T, int* b,
                                        int* walk, int* t) {
    if (id < 2 * BT * T) {
        const int j = id / (2 * BT), r = id % (2 * BT);
        *b = r >> 1;
        *walk = r & 1;                        // f2 or r2
        *t = j;
    } else {
        const int id2 = id - 2 * BT * T;
        const int j = T + id2 / BT;
        *b = id2 % BT;
        *walk = j / T + 1;                    // f3 or r3
        *t = j % T;
    }
}

struct ChainShared {
    unsigned sv[TILE];      // the tile's keys, local states, then outputs
    uint8_t sc[TILE];       // its codes, then local reset bits in bit 5
    Seg wtot[WARPS];
    int id;
    unsigned pk[3], pr[3];
    float seed[3];
};

// One tile of one walk: t of row b, walk `walk` (FORWARD and EXCLUSIVE
// as it goes).
template <bool FORWARD, bool EXCLUSIVE>
__device__ __forceinline__ void chain_tile(
        ChainShared& sh, const float* __restrict__ vrow,
        const uint8_t* __restrict__ crow, float* __restrict__ orow,
        unsigned long long* tiles, unsigned long long* fins, int b, int walk,
        int t, int T, int n, float reset_val, float seed0) {
    // the tile: walk position t * TILE + q at q, node base +- q; no
    // branch between the loads (a whole tile at immediate offsets, the
    // walk's last at a clamped index with PAD codes past the row)
    const unsigned strand = FORWARD ? 1u : 0u;
    const int rem = n - t * TILE;             // positions left in the walk
    const long long base = FORWARD ? (long long)t * TILE
                                   : (long long)n - 1 - (long long)t * TILE;
    constexpr int STEP = FORWARD ? THREADS : -THREADS;
    const int lead = FORWARD ? (int)threadIdx.x : -(int)threadIdx.x;
    if (rem >= TILE) {                        // a whole tile
        const float* vb = vrow + base + lead;
        const uint8_t* cb = crow + base + lead;
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            sh.sv[threadIdx.x + k * THREADS] = ordered(vb[k * STEP]);
            sh.sc[threadIdx.x + k * THREADS] = cb[k * STEP];
        }
    } else {                                  // the walk's last tile
        const float* vb = vrow + base;
        const uint8_t* cb = crow + base;
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            const int q = threadIdx.x + k * THREADS, qi = min(q, rem - 1);
            sh.sv[q] = ordered(vb[FORWARD ? qi : -qi]);
            sh.sc[q] = q < rem ? cb[FORWARD ? qi : -qi] : (uint8_t)PAD;
        }
    }
    __syncthreads();

    // pass 1: the thread's positions; at its own strand's nodes, the
    // node's channel of the thread-local state (after it, or before it
    // if EXCLUSIVE) in place of its key, the reset bit in bit 5
    const unsigned kreset = ordered(reset_val), kneg = ordered(NEGI);
    const int q0 = threadIdx.x * ITEMS;
    Seg s = identity();
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
        const unsigned code = sh.sc[q0 + q], p = code & 3u;
        const unsigned kb = pick(p, s.k), rb = (s.r >> p) & 1u;
        step(s, walk_code(code, strand), sh.sv[q0 + q], kreset,
             filler(code, kneg));
        if (own(code, strand)) {
            sh.sv[q0 + q] = EXCLUSIVE ? kb : pick(p, s.k);
            sh.sc[q0 + q] = (uint8_t)(code | (EXCLUSIVE ? rb
                                                        : (s.r >> p) & 1u)
                                                 << 5);
        }
    }
    Seg prev;
    warp_scan(s, &prev, sh.wtot);
    __syncthreads();
    const Seg excl = group_excl<WARPS>(prev, sh.wtot);
    const Seg total = group_total<WARPS>(sh.wtot, 0);

    // publish the aggregate (the prefix itself in a walk's first tile)
    unsigned long long* mine = tiles + (((long long)b * 4 + walk) * T + t) * 3;
    if (threadIdx.x < 3) {
        const int c = threadIdx.x;
        publish(mine + c, word(t == 0 ? PREFIX : AGGREGATE, total.r >> c,
                               total.k[c]));
    }

    // look back, one warp a channel; then the seed
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < 3) {
        const int c = warp;
        unsigned pk = 0u, pr = 0u;            // the tiles before t
        for (int back = t - 1; back >= 0; back -= 32) {
            const int pt = back - lane;
            unsigned long long w = word(PREFIX, 0u, 0u);  // before the walk
            if (pt >= 0) {
                const unsigned long long* p = mine + (long long)(pt - t) * 3 + c;
                while (((w = peek(p)) >> 33) == 0) __nanosleep(32);
            }
            const unsigned done = __ballot_sync(FULL, (w >> 33) == PREFIX);
            const int last = __ffs(done) - 1;  // the nearest prefix's lane
            unsigned k = (unsigned)w, r = (unsigned)(w >> 32) & 1u;
            if (done != 0u && lane > last) k = r = 0u;
            // combine lanes in walk order (a higher lane is an earlier
            // tile): after the step of offset o, lane l holds lanes
            // l .. l + 2o - 1
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned k2 = __shfl_down_sync(FULL, k, o);
                const unsigned r2 = __shfl_down_sync(FULL, r, o);
                if (lane + o < 32) {
                    k = r ? k : max(k2, k);
                    r |= r2;
                }
            }
            k = __shfl_sync(FULL, k, 0);
            r = __shfl_sync(FULL, r, 0);
            pk = pr ? pk : max(k, pk);        // this window, then the later
            pr |= r;
            if (done != 0u) break;
        }
        if (lane == 0) {
            const unsigned tr = (total.r >> c) & 1u;
            const unsigned ik = tr ? total.k[c] : max(pk, total.k[c]);
            if (t > 0) publish(mine + c, word(PREFIX, pr | tr, ik));
            sh.pk[c] = pk;
            sh.pr[c] = pr;
            float sd = seed0;
            if (walk >= 2) {                  // f3: r2's finals; r3: f3's
                const unsigned long long* p =
                    fins + ((long long)b * 2 + walk - 2) * 3 + c;
                unsigned long long f;
                while (((f = peek(p)) >> 32) == 0) __nanosleep(32);
                sd = __uint_as_float((unsigned)f);
            }
            if (t == T - 1 && (walk == 1 || walk == 2)) {
                const float fin = (pr | tr) ? unordered(ik)
                                            : torch_maximum(sd, unordered(ik));
                publish(fins + ((long long)b * 2 + walk - 1) * 3 + c,
                        1ull << 32 | __float_as_uint(fin));
            }
            sh.seed[c] = sd;
        }
    }
    __syncthreads();

    // pass 2: each own node's output from its thread's prefix
    Seg x;
#pragma unroll
    for (int c = 0; c < 3; ++c) x.k[c] = sh.pk[c];
    x.r = sh.pr[0] | sh.pr[1] << 1 | sh.pr[2] << 2;
    x = combine(x, excl);
    const float seed[3] = {sh.seed[0], sh.seed[1], sh.seed[2]};
    const bool origin = EXCLUSIVE && t == 0 && threadIdx.x == 0;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
        const unsigned code = sh.sc[q0 + q];
        if (own(code, strand)) {
            const unsigned p = code & 3u;
            sh.sv[q0 + q] = __float_as_uint(
                origin && q == 0 ? pick(p, seed)
                                 : finish(x, sh.sv[q0 + q], (code >> 5) & 1u,
                                          p, seed));
        }
    }
    __syncthreads();
    float* ob = orow + base + lead;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int q = threadIdx.x + k * THREADS;
        if (own(sh.sc[q], strand)) ob[k * STEP] = __uint_as_float(sh.sv[q]);
    }
}

__global__ void __launch_bounds__(THREADS) seg_scan_chain_kernel(
        const float* __restrict__ cscore, const float* __restrict__ lfac,
        const uint8_t* __restrict__ code, float* __restrict__ run2,
        float* __restrict__ run3, unsigned long long* scratch, int BT, int n,
        int geo_stride, int T, float reset_val, float seed0) {
    __shared__ ChainShared sh;
    if (threadIdx.x == 0)
        sh.id = (int)atomicAdd((unsigned long long*)scratch, 1ull);
    __syncthreads();
    int b, walk, t;
    tile_of(sh.id, BT, T, &b, &walk, &t);
    unsigned long long* tiles = scratch + 1;
    unsigned long long* fins = tiles + (long long)BT * 4 * T * 3;
    const float* vrow = (walk < 2 ? cscore : lfac) + (long long)b * n;
    const uint8_t* crow = code + (long long)b * geo_stride;
    float* orow = (walk < 2 ? run2 : run3) + (long long)b * n;
    switch (walk) {
        case 0:
            chain_tile<true, false>(sh, vrow, crow, orow, tiles, fins, b, 0,
                                    t, T, n, reset_val, seed0);
            break;
        case 1:
            chain_tile<false, false>(sh, vrow, crow, orow, tiles, fins, b, 1,
                                     t, T, n, reset_val, seed0);
            break;
        case 2:
            chain_tile<true, true>(sh, vrow, crow, orow, tiles, fins, b, 2,
                                   t, T, n, reset_val, seed0);
            break;
        default:
            chain_tile<false, true>(sh, vrow, crow, orow, tiles, fins, b, 3,
                                    t, T, n, reset_val, seed0);
    }
}

}  // namespace

// cscore, lfac (BT, n) f32; code (R, n) uint8 with R = 1 (geo_stride 0)
// or BT (geo_stride n); run2, run3 (BT, n) f32 out.  Rows of at most
// ROW_LIMIT nodes: tiles 0 and no scratch.  Longer rows: tiles =
// ceil(n / TILE) and scratch a zeroed uint64 array of 1 + BT * 4 * tiles
// * 3 + BT * 2 * 3 words.
extern "C" int seg_scan_launch(const float* cscore, const float* lfac,
                               const uint8_t* code, float* run2, float* run3,
                               unsigned long long* scratch, int BT, int n,
                               int geo_stride, int tiles, float reset_val,
                               float seed, cudaStream_t stream) {
    if (BT < 1 || BT > 65535 || n < 1 || (geo_stride != 0 && geo_stride != n))
        return (int)cudaErrorInvalidValue;
    if (n <= ROW_LIMIT) {
        if (tiles != 0) return (int)cudaErrorInvalidValue;
        seg_scan_rows_kernel<<<BT, ROW_THREADS, 0, stream>>>(
            cscore, lfac, code, run2, run3, n, geo_stride, reset_val, seed);
    } else {
        if (tiles != (n + TILE - 1) / TILE || scratch == nullptr
            || 4LL * BT * tiles > 0x7fffffffLL)
            return (int)cudaErrorInvalidValue;
        seg_scan_chain_kernel<<<4 * BT * tiles, THREADS, 0, stream>>>(
            cscore, lfac, code, run2, run3, scratch, BT, n, geo_stride, tiles,
            reset_val, seed);
    }
    return (int)cudaGetLastError();
}
