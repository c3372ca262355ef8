// star: flag=1 overlapping-start sweep + the DP's star tables.
//
// Replaces pyrodigal_tpu/ops/star_pallas.py::_star_kernel (wrapper
// star_tables_mega) on the mega route; on the std route it replaces the
// XLA star sweep of score_device._score_items (score_device.py:1036-1106)
// and the table build in dp_pallas._dp_core's gather_near
// (dp_pallas.py:388-420).  The geometry rows (ndx, stop_val, kind4, edge)
// are one row shared by every bin row (mega: row stride 0) or one row per
// bin row, each its own contig (std: row stride NT).  For each (bin row b,
// stop node i) it replays the reference's overlapping-start scan
// (lib.pyx:2279-2329) in the kernel's exact order: forward stops walking
// j = i+3 .. i+3-relk+1, reverse stops walking j = i-3 .. i+relk-4, a
// strict `>` running max (seeded at -100) over cs[j] + igm, and one
// pointer per frame of ndx[j].  It then reads the pointed node and writes
// the four tables per frame: opv1 = cs[p] + igm(i -> p), val3 = cs[p] +
// igm(p -> i), t_sv = stop_val[p] (-1e9 without a pointer) and t_ndx =
// ndx[p].
//
// What bounds it on the H100: the stores, and the latency of each row's
// short chain of loads, sweep and stores.  At the genome's launch (16 bin
// rows x 163,840 nodes) it writes 157 MB (15 values a node and row) and
// reads 34 MB: 0.057 ms at 3.35 TB/s, where one fill_ of the 157 MB
// alone takes 0.050 ms on the card.  The sweep itself is short: a stop
// has about one candidate (a start of its strand within max_overlap bp
// whose own stop lies past this one), and 18% of the nodes are stops.
//
// The design:
// - A block takes a tile of blockDim.x consecutive nodes with a halo of
//   HALO = relk - 4 nodes on each side, so every candidate (fwd: j in
//   [i-28, i+3]; rev: j in [i-3, i+28]) and every pointed node lies in
//   shared memory.  Geometry and each row's cs/rsc/usc are copied in with
//   coalesced loads, masked at 0 and NT.
// - Every geometry test of the sweep (j in range, the candidate's kind and
//   strand, the max_overlap window, its stop past this one) depends on the
//   geometry row alone.  Each thread evaluates them once per geometry row
//   into a 32-bit mask, bit k = step k of its own population's walk
//   (`star_candidates_plain` is the same mask in PyTorch).  Over a shared
//   geometry row a block reuses the masks for a group of bin rows; with
//   one geometry row per bin row, each (row, tile) block builds its own.
//   Row groups are the grid's fastest dimension.
// - Per bin row, a stop walks the set bits of its mask in ascending order
//   (the 64-step loop's order, so the same candidate wins a tie), reading
//   its operands from shared memory; the operon quotient comes from the
//   q60 table (the same IEEE quotient as the division).  The next row's
//   cs/rsc/usc are loaded into registers while this row is walked and
//   stored, and land in the other of two shared buffers: one barrier a
//   row.  Thread t writes node t of each of the 15 output planes, a warp's
//   128 contiguous bytes a store, marked evict-first (`__stcs`).
// Measured on an H100 80GB HBM3 at 700 W (scripts/ab_star_kernel.py; the
// iterations in PERF.md): 128 nodes and 8 bin rows a block are about the
// fastest of 64-1,024 and 1-16 (more rows a block build masks less often
// but leave fewer blocks, and a one-wave split of every row was slower);
// row groups first in the grid took the per-row launch from 0.018 to
// 0.015 ms, evict-first stores from 0.015 to 0.012 ms, and neither moved
// the genome launch.  Tried and slower:
// the tile's stops compacted for the sweep with the results passed to the
// stores through shared memory, a branch-free unrolled mask loop, int4
// stores staged per warp, a three-stage cp.async pipeline (no gain), a
// register cap for more blocks an SM, and __launch_bounds__(512).
// The igm arithmetic is float32 in the JAX operation order, and the
// library is built with -fmad=false, so the strict `>` sees the
// reference's bits.

#include "common.cuh"

namespace {

constexpr int HALO = 28;       // relk - 4 at the largest relk the mask holds
constexpr int MAX_RELK = 32;   // one bit of a 32-bit mask per step
constexpr int MAX_TILE = 512;  // threads a block the launcher takes

__global__ void star_kernel(
    const int* __restrict__ ndx, const int* __restrict__ sv,
    const int* __restrict__ kind4, const int* __restrict__ edge,
    const float* __restrict__ cs, const float* __restrict__ rsc,
    const float* __restrict__ usc, const float* __restrict__ st_wt,
    int* __restrict__ sp_out, float* __restrict__ opv_out,
    float* __restrict__ val3_out, int* __restrict__ tsv_out,
    int* __restrict__ tnd_out, int B, int NT, int relk, int mo,
    int geo_stride, int rows_per_block) {
    extern __shared__ float smem[];
    __shared__ float q60[OPER_DIST + 1];
    const int T = blockDim.x;
    const int W = T + 2 * HALO;            // the tile and its halo
    const int t = threadIdx.x;
    float* fbuf = smem;                    // [2][3][W]: cs, rsc, usc
    int* ndx_s = reinterpret_cast<int*>(smem + 6 * W);
    int* sv_s = ndx_s + W;
    unsigned char* kind_s = reinterpret_cast<unsigned char*>(sv_s + W);

    const int tile0 = blockIdx.y * T;
    const int lo = tile0 - HALO;           // node of shared slot 0
    const int i = tile0 + t;
    const int si = HALO + t;               // this node's slot
    const bool live = i < NT;
    const int b0 = blockIdx.x * rows_per_block;
    const int b1 = min(B, b0 + rows_per_block);
    const long long plane = (long long)B * NT;
    // a thread copies slot t and, for t < 2 * HALO, slot T + t
    const int j0 = lo + t, j1 = lo + T + t;
    const bool in0 = j0 >= 0 && j0 < NT;
    const bool in1 = t < 2 * HALO && j1 < NT;
    fill_q60(q60);

    float pre[6];                          // the next row's cs/rsc/usc
    auto prefetch = [&](int b) {
        const long long row = (long long)b * NT;
        pre[0] = in0 ? cs[row + j0] : 0.0f;
        pre[1] = in0 ? rsc[row + j0] : 0.0f;
        pre[2] = in0 ? usc[row + j0] : 0.0f;
        pre[3] = in1 ? cs[row + j1] : 0.0f;
        pre[4] = in1 ? rsc[row + j1] : 0.0f;
        pre[5] = in1 ? usc[row + j1] : 0.0f;
    };
    prefetch(b0);

    unsigned mask = 0;
    int ndx_i = 0;
    bool edgeb = true, fstop = false;
    for (int b = b0; b < b1; ++b) {
        const bool new_geo = b == b0 || geo_stride != 0;
        if (new_geo) {
            const long long g = (long long)b * geo_stride;
            ndx_s[t] = in0 ? ndx[g + j0] : 0;
            sv_s[t] = in0 ? sv[g + j0] : 0;
            kind_s[t] = in0 ? (unsigned char)(kind4[g + j0] & 7) : 4;
            if (t < 2 * HALO) {
                ndx_s[T + t] = in1 ? ndx[g + j1] : 0;
                sv_s[T + t] = in1 ? sv[g + j1] : 0;
                kind_s[T + t] = in1 ? (unsigned char)(kind4[g + j1] & 7)
                                    : 4;
            }
            edgeb = live ? edge[g + i] != 0 : true;
        }
        float* buf = fbuf + ((b - b0) & 1) * 3 * W;
        buf[t] = pre[0];
        buf[W + t] = pre[1];
        buf[2 * W + t] = pre[2];
        if (t < 2 * HALO) {
            buf[T + t] = pre[3];
            buf[W + T + t] = pre[4];
            buf[2 * W + T + t] = pre[5];
        }
        __syncthreads();

        if (new_geo) {
            // the candidate mask: every geometry test of the sweep
            const int kind = kind_s[si];
            fstop = kind == 1 && !edgeb;
            const bool rstop = kind == 3 && !edgeb;
            ndx_i = ndx_s[si];
            mask = 0;
            if (fstop || rstop) {
                for (int k = 0; k < relk; ++k) {
                    const int d = fstop ? 3 - k : k - 3;
                    const int j = i + d;
                    if (j < 0 || j >= NT) continue;
                    const int s = si + d;
                    const int kind_j = kind_s[s];
                    if (kind_j == 4 || kind_j == 1 || kind_j == 3) continue;
                    const int ndx_j = ndx_s[s];
                    const int sv_j = sv_s[s];
                    const int str_j = kind_j < 2 ? 1 : -1;
                    const bool ok =
                        fstop ? (str_j == 1 && ndx_j <= ndx_i + 2
                                 && ndx_j + mo >= ndx_i && sv_j > ndx_i)
                              : (str_j == -1 && ndx_j >= ndx_i - 2
                                 && ndx_j - mo <= ndx_i && sv_j < ndx_i);
                    if (ok) mask |= 1u << k;
                }
            }
        }
        if (b + 1 < b1) prefetch(b + 1);

        const float* cs_s = buf;
        const float* rsc_s = buf + W;
        const float* usc_s = buf + 2 * W;
        const float stw = st_wt[b];
        const float rsc_i = rsc_s[si];
        const float usc_i = usc_s[si];

        // the sweep: the set bits in the 64-step loop's order
        int p0 = -1, p1 = -1, p2 = -1;
        float runmax = -100.0f;
        for (unsigned m = mask; m != 0; m &= m - 1) {
            const int k = __ffs(m) - 1;
            const int d = fstop ? 3 - k : k - 3;
            const int s = si + d;
            const int ndx_j = ndx_s[s];
            const float igm =
                fstop ? igm_same(ndx_i, 1, rsc_i, usc_i, ndx_j, rsc_s[s],
                                 usc_s[s], stw, q60)
                      : igm_same(ndx_j, -1, rsc_s[s], usc_s[s], ndx_i,
                                 rsc_i, usc_i, stw, q60);
            const float sc = cs_s[s] + igm;
            if (sc > runmax) {
                runmax = sc;
                const int f = ndx_j % 3;
                p0 = f == 0 ? i + d : p0;
                p1 = f == 1 ? i + d : p1;
                p2 = f == 2 ? i + d : p2;
            }
        }

        if (live) {
            const int strand = fstop ? 1 : -1;
            const long long o0 = (long long)b * NT + i;
#pragma unroll
            for (int f = 0; f < 3; ++f) {
                const long long o = f * plane + o0;
                const int q = f == 0 ? p0 : (f == 1 ? p1 : p2);
                __stcs(sp_out + o, q);
                if (q == -1) {
                    __stcs(opv_out + o, -1e30f);
                    __stcs(val3_out + o, -1e30f);
                    __stcs(tsv_out + o, -1000000000);
                    __stcs(tnd_out + o, 0);
                    continue;
                }
                const int sq = q - lo;
                const int gn = ndx_s[sq];
                const float gc = cs_s[sq];
                const float gr = rsc_s[sq];
                const float gu = usc_s[sq];
                const int gs = kind_s[sq] < 2 ? 1 : -1;
                __stcs(opv_out + o, gc + igm_same(ndx_i, strand, rsc_i,
                                                  usc_i, gn, gr, gu, stw,
                                                  q60));
                __stcs(val3_out + o, gc + igm_same(gn, gs, gr, gu, ndx_i,
                                                   rsc_i, usc_i, stw, q60));
                __stcs(tsv_out + o, sv_s[sq]);
                __stcs(tnd_out + o, gn);
            }
        }
        // per-row geometry: the next row overwrites it
        if (geo_stride != 0 && b + 1 < b1) __syncthreads();
    }
}

// Dynamic shared bytes of a block of `tile` threads: two buffers of
// cs/rsc/usc, and ndx, sv and kind, over the tile and its halo (at most
// 18,744 bytes, under the 48 KB a launch takes without opting in).
int smem_bytes(int tile) {
    const int W = tile + 2 * HALO;
    return W * (6 * 4 + 4 + 4 + 1);
}

}  // namespace

extern "C" int star_launch(const int* ndx, const int* sv, const int* kind4,
                           const int* edge, const float* cs, const float* rsc,
                           const float* usc, const float* st_wt, int* sp,
                           float* opv1, float* val3, int* t_sv, int* t_ndx,
                           int B, int NT, int relk, int mo, int geo_stride,
                           int tile, int rows_per_block,
                           cudaStream_t stream) {
    if (relk < 1 || relk > MAX_RELK || tile < 2 * HALO || tile > MAX_TILE
        || tile % 32 != 0 || rows_per_block < 1)
        return (int)cudaErrorInvalidValue;
    dim3 grid((B + rows_per_block - 1) / rows_per_block,
              (NT + tile - 1) / tile);
    star_kernel<<<grid, tile, smem_bytes(tile), stream>>>(
        ndx, sv, kind4, edge, cs, rsc, usc, st_wt, sp, opv1, val3, t_sv,
        t_ndx, B, NT, relk, mo, geo_stride, rows_per_block);
    return (int)cudaGetLastError();
}
