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
// (lib.pyx:2279-2329) in the kernel's exact order: t = 0 .. 2*relk-1,
// forward stops walking j = i+3 .. i+3-relk+1 then reverse stops walking
// j = i-3 .. i+relk-4, a strict `>` running max (seeded at -100) over
// cs[j] + igm, and one pointer per frame of ndx[j].  It then reads the
// pointed node directly and writes the four tables per frame: opv1 =
// cs[p] + igm(i -> p), val3 = cs[p] + igm(p -> i), t_sv = stop_val[p]
// (-1e9 without a pointer) and t_ndx = ndx[p].  A pointer lies within relk
// node indices of its stop, so gather_near's bound |p - i| <= relk + 4
// always holds.
//
// What bounds it on the H100: memory.  Each thread reads 2*relk = 64
// neighbours of three (B, NT) float rows and four geometry rows and writes
// 15 values (B = 16, NT = 163,840: 157 MB of outputs); neighbouring
// threads read neighbouring nodes, so the reads coalesce and the 64-fold
// reuse hits L1/L2.  The TPU kernel's halo'd VMEM windows and banded
// select loop (star_pallas.py:129-158) were a TPU device for the absence
// of a fast gather; a thread here just indexes the pointed node.
//
// Design: one thread per (row, node), no shared memory.  The igm
// arithmetic is float32 in the JAX operation order, and the library is
// built with -fmad=false, so the strict `>` sees the reference's bits.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void star_kernel(const int* __restrict__ ndx,
                            const int* __restrict__ sv,
                            const int* __restrict__ kind4,
                            const int* __restrict__ edge,
                            const float* __restrict__ cs,
                            const float* __restrict__ rsc,
                            const float* __restrict__ usc,
                            const float* __restrict__ st_wt,
                            int* __restrict__ sp_out,
                            float* __restrict__ opv_out,
                            float* __restrict__ val3_out,
                            int* __restrict__ tsv_out,
                            int* __restrict__ tnd_out,
                            int B, int NT, int relk, int mo,
                            int geo_stride) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const int b = blockIdx.y;
    if (i >= NT) return;
    const long long row = (long long)b * NT;
    const long long grow = (long long)b * geo_stride;  // this row's geometry
    ndx += grow;
    sv += grow;
    kind4 += grow;
    edge += grow;
    const long long plane = (long long)B * NT;
    const float stw = st_wt[b];

    const int kind = kind4[i] & 7;
    const bool edgeb = edge[i] != 0;
    const int strand = kind < 2 ? 1 : -1;
    const bool fstop = kind == 1 && !edgeb;
    const bool rstop = kind == 3 && !edgeb;
    const int ndx_i = ndx[i];
    const float rsc_i = rsc[row + i];
    const float usc_i = usc[row + i];

    int p[3] = {-1, -1, -1};
    if (fstop || rstop) {
        float runmax = -100.0f;
        for (int t = 0; t < 2 * relk; ++t) {
            const bool is_f = t < relk;
            if (is_f != fstop) continue;      // the other population's steps
            const int k = is_f ? t : t - relk;
            const int d = is_f ? 3 - k : k - 3;
            const int j = i + d;
            if (j < 0 || j >= NT) continue;
            const int kind_j = kind4[j] & 7;
            if (kind_j == 4 || kind_j == 1 || kind_j == 3) continue;
            const int ndx_j = ndx[j];
            const int sv_j = sv[j];
            const int str_j = kind_j < 2 ? 1 : -1;
            const float rsc_j = rsc[row + j];
            const float usc_j = usc[row + j];
            bool okd;
            float igm;
            if (is_f) {
                okd = str_j == 1 && ndx_j <= ndx_i + 2
                      && ndx_j + mo >= ndx_i && sv_j > ndx_i;
                igm = igm_same(ndx_i, strand, rsc_i, usc_i, ndx_j, rsc_j,
                               usc_j, stw);
            } else {
                okd = str_j == -1 && ndx_j >= ndx_i - 2
                      && ndx_j - mo <= ndx_i && sv_j < ndx_i;
                igm = igm_same(ndx_j, -1, rsc_j, usc_j, ndx_i, rsc_i, usc_i,
                               stw);
            }
            if (!okd) continue;
            const float sc = cs[row + j] + igm;
            if (sc > runmax) {
                runmax = sc;
                p[ndx_j % 3] = j;
            }
        }
    }

    for (int f = 0; f < 3; ++f) {
        const long long o = f * plane + row + i;
        const int q = p[f];
        sp_out[o] = q;
        if (q == -1) {
            opv_out[o] = -1e30f;
            val3_out[o] = -1e30f;
            tsv_out[o] = -1000000000;
            tnd_out[o] = 0;
            continue;
        }
        const int gn = ndx[q];
        const float gc = cs[row + q];
        const float gr = rsc[row + q];
        const float gu = usc[row + q];
        const int gs = (kind4[q] & 7) < 2 ? 1 : -1;
        opv_out[o] = gc + igm_same(ndx_i, strand, rsc_i, usc_i, gn, gr, gu,
                                   stw);
        val3_out[o] = gc + igm_same(gn, gs, gr, gu, ndx_i, rsc_i, usc_i,
                                    stw);
        tsv_out[o] = sv[q];
        tnd_out[o] = gn;
    }
}

}  // namespace

extern "C" int star_launch(const int* ndx, const int* sv, const int* kind4,
                           const int* edge, const float* cs, const float* rsc,
                           const float* usc, const float* st_wt, int* sp,
                           float* opv1, float* val3, int* t_sv, int* t_ndx,
                           int B, int NT, int relk, int mo, int geo_stride,
                           cudaStream_t stream) {
    dim3 grid((NT + THREADS - 1) / THREADS, B);
    star_kernel<<<grid, THREADS, 0, stream>>>(ndx, sv, kind4, edge, cs, rsc,
                                              usc, st_wt, sp, opv1, val3,
                                              t_sv, t_ndx, B, NT, relk, mo,
                                              geo_stride);
    return (int)cudaGetLastError();
}
