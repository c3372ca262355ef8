// std DP: the gene-path dynamic program for a mixed batch of work items,
// each row its own (contig, bin) with its own node geometry, in int32 fixed
// point (score * 2048).
//
// Replaces pyrodigal_tpu/ops/dp_pallas.py::_dp_kernel_b (launch
// _run_kernel_b, entry _dp_core).  Node i takes, over the sources j in
// [max(win_lo[i], i - 3 * 640), i) -- exactly the JAX kernel's window of at
// most FIXED_CHUNKS chunks of 640 -- the candidate of its target kind
// (dp_pallas.py:165-258: the six skip rules, the artifact rule, the four
// target cases, the triple-overlap frame loop), quantised as
// round(cand * 2048) and added to score[j].  Among equal totals the JAX
// kernel picks the largest lane of a chunk and keeps the nearest chunk
// (strict `>` across chunks), i.e. the largest j; the packed key
// (total, j, m + 1) below gives the same order, with the ovmark frame m in
// its two low bits.  A node commits when the best total is >= 0 (the score
// it holds before its own step) and writes score, traceb = j (a node index,
// not the JAX kernel's W-front-padded lane), ovmark = m and tbndx = ndx[j].
// Pads (kind 4) commit nothing and keep score 0, traceb -1, ovmark -1,
// tbndx 0.
//
// What bounds it on the H100: latency.  A row is a chain of up to 3,072
// dependent node steps; a step reads up to 1,920 window lanes of about ten
// operand rows from L1/L2 and ends in a block reduction.  A launch's
// operands (128 rows x 21 rows x 3,072 nodes) are ~35 MB and stay in the
// 50 MB L2.
//
// Design: one thread block per row (a std launch's 128 rows fill 128 of
// the 132 SMs; the mega DP runs 16).  The threads stride over the window,
// evaluate only the target's own kind (uniform per block and step), and
// reduce int64 keys with a block max; thread 0 commits, then all sync.
// The score, traceb and tbndx rows a later step reads live in global
// memory (read back through L1 after the __syncthreads); staging a row in
// shared memory is later work.  Float arithmetic is the JAX kernel's
// operation order, built with -fmad=false.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int W = 640;              // meta_tpu window
constexpr int CHUNKS = 3;           // dp_pallas.FIXED_CHUNKS
constexpr float FXS = 2048.0f;      // dp_pallas.FXS

// floor mod 3, as the JAX kernel's x - (x // 3) * 3
__device__ __forceinline__ int mod3(int x) {
    int m = x % 3;
    return m < 0 ? m + 3 : m;
}

__global__ void dp_std_kernel(
    const int* __restrict__ ndx, const int* __restrict__ sv,
    const int* __restrict__ kind4, const int* __restrict__ win_lo,
    const float* __restrict__ cs, const float* __restrict__ rsc,
    const float* __restrict__ usc,
    const float* __restrict__ opv1, const float* __restrict__ val3,
    const int* __restrict__ t_sv, const int* __restrict__ t_ndx,
    const float* __restrict__ st_wt,
    int* score, int* traceb, int* ovmark, int* tbndx, int BT, int n) {
    __shared__ long long red[WARPS];

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const long long row = (long long)b * n;
    const long long plane = (long long)BT * n;
    ndx += row;
    sv += row;
    kind4 += row;
    win_lo += row;
    cs += row;
    rsc += row;
    usc += row;
    score += row;
    traceb += row;
    ovmark += row;
    tbndx += row;
    const float stw = st_wt[b];
    const float igm_diff = -0.15f * stw;

    for (int i = tid; i < n; i += THREADS) {
        score[i] = 0;
        traceb[i] = -1;
        ovmark[i] = -1;
        tbndx[i] = 0;
    }
    __syncthreads();

    for (int i = 0; i < n; ++i) {
        const int i_kind = kind4[i];
        if (i_kind == 4) continue;                // uniform over the block
        const int i_ndx = ndx[i];
        const int i_sv = sv[i];
        const int i_fr = mod3(i_ndx);
        const bool i_is_stop = i_kind == 1 || i_kind == 3;
        const bool i_fwd = i_kind < 2;
        const float cs_i = cs[i];
        const float rsc_i = rsc[i];
        const float usc_i = usc[i];
        const float* opv_i = opv1 + i_fr * plane + row;   // kind 1: frame i_fr
        float v3[3];
        int sv3[3], nd3[3];
        if (i_kind == 3) {
            for (int k = 0; k < 3; ++k) {
                v3[k] = val3[k * plane + row + i];
                sv3[k] = t_sv[k * plane + row + i];
                nd3[k] = t_ndx[k * plane + row + i];
            }
        }
        const int lo = max(max(win_lo[i], i - CHUNKS * W), 0);
        long long key = NO_KEY;
        for (int j = lo + tid; j < i; j += THREADS) {
            const int kj = kind4[j];
            if (kj == 4) continue;
            const int nj = ndx[j];
            const int fr_j = mod3(nj);
            const bool f1_stop = kj == 1;
            const bool f1_start = kj == 0;
            const bool r1_stop = kj == 3;
            const bool r1_start = kj == 2;
            const bool n1_is_stop = f1_stop || r1_stop;
            const bool n1_fwd = kj < 2;
            const bool skip =
                (!n1_is_stop && !i_is_stop && n1_fwd == i_fwd)
                || (n1_fwd && !n1_is_stop && !i_fwd)
                || (!n1_fwd && n1_is_stop && i_fwd)
                || (!n1_fwd && !n1_is_stop && i_fwd && i_is_stop)
                || (n1_fwd == i_fwd && n1_fwd && !n1_is_stop && i_is_stop
                    && fr_j != i_fr)
                || (n1_fwd == i_fwd && !n1_fwd && n1_is_stop && !i_is_stop
                    && fr_j != i_fr);
            const int tb = traceb[j];
            if (skip || (tb == -1 && (f1_stop || r1_start))) continue;

            bool ok;
            float cand;
            int m = -1;
            if (i_kind == 0) {                    // fwd start
                ok = f1_stop ? nj + 2 < i_ndx : nj < i_ndx;
                cand = f1_stop ? igm_same(nj, 1, rsc[j], usc[j], i_ndx, rsc_i,
                                          usc_i, stw)
                               : igm_diff;
            } else if (i_kind == 1) {             // fwd stop
                ok = i_sv < nj;
                cand = f1_start ? cs[j] : opv_i[j];
            } else if (i_kind == 2) {             // rev start
                if (r1_stop) {
                    ok = sv[j] > i_ndx;
                    cand = cs_i + 0.0f * igm_diff;
                } else {
                    const int bnd = tb == -1 ? 0 : tbndx[j];
                    const int ovlp = (nj + 2) - (i_sv - 2) + 1;
                    ok = (i_sv - 2) < (nj + 2) && ovlp < MAX_OPP_OVLP
                         && (nj - i_sv) < (i_ndx - nj + 3)
                         && (nj - i_sv) < (i_sv - 3 - bnd);
                    cand = cs_i + igm_diff;
                }
            } else {                              // rev stop
                const int right = i_ndx - 2;
                if (f1_stop) {
                    const int left = nj + 2;
                    const int bnd = tb == -1 ? 0 : tbndx[j];
                    float bv;
                    m = triple_overlap(left, tb, bnd, v3, sv3, nd3, &bv);
                    ok = left < right;
                    cand = m != -1 ? bv : igm_diff;
                } else if (r1_start) {
                    ok = nj < right;
                    cand = igm_same(nj, -1, rsc[j], usc[j], i_ndx, rsc_i,
                                    usc_i, stw);
                } else {
                    ok = sv[j] > i_ndx;
                    cand = v3[fr_j];
                }
            }
            if (!ok || !(cand > NEGF_HALF)) continue;
            const int total = score[j] + quant(cand, FXS);
            const long long k = pack(total, ((unsigned)j << 2) | (m + 1));
            key = k > key ? k : key;
        }

        key = block_max<THREADS>(key, red);
        if (tid == 0 && key != NO_KEY) {
            const int best = key_value(key);
            if (best > INT_NEG / 2 && best >= 0) {
                const unsigned low = (unsigned)(key & 0xffffffffLL);
                const int j = (int)(low >> 2);
                score[i] = best;
                traceb[i] = j;
                ovmark[i] = (int)(low & 3) - 1;
                tbndx[i] = ndx[j];
            }
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int dp_std_launch(
    const int* ndx, const int* sv, const int* kind4, const int* win_lo,
    const float* cs, const float* rsc, const float* usc, const float* opv1,
    const float* val3, const int* t_sv, const int* t_ndx, const float* st_wt,
    int* score, int* traceb, int* ovmark, int* tbndx, int BT, int n,
    cudaStream_t stream) {
    dp_std_kernel<<<BT, THREADS, 0, stream>>>(
        ndx, sv, kind4, win_lo, cs, rsc, usc, opv1, val3, t_sv, t_ndx, st_wt,
        score, traceb, ovmark, tbndx, BT, n);
    return (int)cudaGetLastError();
}
