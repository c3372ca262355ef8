// mega DP: the gene-path dynamic program over one shared node geometry for
// B bin rows, in int32 fixed point.
//
// Replaces pyrodigal_tpu/ops/dp_pallas.py::_dp_kernel_mega (launch
// _run_kernel_mega, entry _dp_core_mega).  Each node i takes the
// lexicographic (value, source index) maximum over its predecessors --
// the reference's `>=` last-wins relaxation -- and commits when that value
// is >= 0.  The predecessor set per target kind is the JAX kernel's:
//   kind 0 (fwd start): rev starts in [max(floor((i-1024)/128)*128, win_lo),
//       i) with the flat -0.15*st_wt modifier, and the fwd stops of a
//       256-slot ring (pushed at each fwd stop) with j >= win_lo and
//       ndx_j + 2 < ndx_i, distance-only modifier;
//   kind 1 (fwd stop): the gene and operon registers of its frame;
//   kind 2 (rev start): the latest rev stop of its frame, and fwd stops in
//       the 384-node overlap window at ovlo[i], clamped to the JAX kernel's
//       scratch as it was for that tile;
//   kind 3 (rev stop): [max(i-1024, win_lo), i) with the triple-overlap
//       star terms.
// Pads (kind 4) are a suffix of each 2048-node tile and are skipped through
// the per-tile node counts; they keep score 0, traceb -1, ov -1, tbndx 0.
//
// What bounds it on the H100: latency.  Each row is a chain of NT
// dependent node steps (153 k for a 2.46 Mbp genome); a step reads at most
// ~1.2 k window lanes from L2/L1 and does a block reduction, so the time is
// NT times the step latency, and only B blocks run (one SM each).
//
// Design: one thread block per bin row; rows are independent.  For each
// node the threads evaluate that kind's candidate sources in parallel, each
// packs (value, j) into an int64 key, and a block max reduction picks the
// winner (the largest j among equal values, as the JAX kernel's
// pick-the-largest-lane rule).  Thread 0 commits and updates the nine
// class registers (gene, operon, latest rev stop, x 3 frames) and the
// fwd-stop ring, which live in shared memory; the score, traceb, ov and
// tbndx rows live in global memory and the window reads hit L1/L2.  Two
// __syncthreads per node.  Quantisation is round-half-even (__float2int_rn),
// as jnp.round.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int W = 1024;            // dp_pallas.W_MEGA
constexpr int TILE = 2048;         // dp_pallas.MEGA_TILE
constexpr int PREF = 4 * W;        // MEGA_CHUNKS * W_MEGA
constexpr int RING = 256;          // dp_pallas.MEGA_RING
constexpr int OVW = 384;           // kind-2 overlap window lanes

__global__ void dp_mega_kernel(
    const int* __restrict__ ndx, const int* __restrict__ sv,
    const int* __restrict__ kind4, const int* __restrict__ win_lo,
    const int* __restrict__ ovlo, const int* __restrict__ has_ov,
    const int* __restrict__ tile_nn,
    const float* __restrict__ cs, const float* __restrict__ rsc,
    const float* __restrict__ usc,
    const float* __restrict__ opv1, const float* __restrict__ val3,
    const int* __restrict__ t_sv, const int* __restrict__ t_ndx,
    const float* __restrict__ st_wt,
    int* score, int* traceb, int* ovmark, int* tbndx,
    int B, int NT, int fxs_i) {
    __shared__ long long red[WARPS];
    __shared__ int r_val[9], r_idx[9], r_sv[3];
    __shared__ int g_val[RING], g_j[RING], g_ndx[RING];
    __shared__ int g_pos;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const long long row = (long long)b * NT;
    const long long plane = (long long)B * NT;
    const float fxs = (float)fxs_i;
    const float stw = st_wt[b];
    const float igm_diff = -0.15f * stw;
    const int q_diff = quant(igm_diff, fxs);
    int* sc_row = score + row;
    int* tb_row = traceb + row;
    int* ov_row = ovmark + row;
    int* tn_row = tbndx + row;

    for (int i = tid; i < NT; i += THREADS) {
        sc_row[i] = 0;
        tb_row[i] = -1;
        ov_row[i] = -1;
        tn_row[i] = 0;
    }
    if (tid < 9) {
        r_val[tid] = INT_NEG;
        r_idx[tid] = -1;
    }
    if (tid < 3) r_sv[tid] = -1000000000;
    for (int s = tid; s < RING; s += THREADS) {
        g_val[s] = INT_NEG;
        g_j[s] = -1;
        g_ndx[s] = 0;
    }
    if (tid == 0) g_pos = 0;
    __syncthreads();

    const int n_tiles = NT / TILE;
    for (int t = 0; t < n_tiles; ++t) {
        const int base = t * TILE;
        const int end = base + tile_nn[t];
        for (int i = base; i < end; ++i) {
            int kind = kind4[i];
            if (kind > 3) kind = 3;        // lax.switch clamps its index
            const int i_ndx = ndx[i];
            const int i_sv = sv[i];
            const int i_fr = i_ndx % 3;
            const int wlo = win_lo[i];
            long long key = NO_KEY;

            if (kind == 0) {
                // rev starts: flat modifier over the JAX kernel's aligned
                // window [floor((i - W) / 128) * 128, i)
                int al = i - W;
                al = (al >= 0 ? al / 128 : -((-al + 127) / 128)) * 128;
                const int lo = max(max(al, wlo), 0);
                for (int j = lo + tid; j < i; j += THREADS) {
                    if (kind4[j] != 2 || ndx[j] >= i_ndx) continue;
                    if (tb_row[j] == -1) continue;
                    long long k = pack(sc_row[j] + q_diff, j);
                    key = k > key ? k : key;
                }
                // fwd stops: the ring
                for (int s = tid; s < RING; s += THREADS) {
                    const int rj = g_j[s];
                    const int rn = g_ndx[s];
                    if (rj == -1 || rj < wlo || rn + 2 >= i_ndx) continue;
                    const int dist = i_ndx - rn;
                    const bool far = dist > 3 * OPER_DIST;
                    const bool operon = dist <= OPER_DIST
                                        || dist * 4 < OPER_DIST;
                    const float bonus = (2.0f - (float)dist
                                         / (float)OPER_DIST) * 0.15f * stw;
                    const float igm = far ? -0.15f * stw
                                          : (operon ? bonus : 0.0f);
                    long long k = pack(g_val[s] + quant(igm, fxs), rj);
                    key = k > key ? k : key;
                }
            } else if (kind == 2) {
                const float cs_i = cs[row + i];
                if (tid == 0) {
                    const int rj = r_idx[6 + i_fr];
                    if (r_sv[i_fr] > i_ndx && rj >= wlo)
                        key = pack(r_val[6 + i_fr] + quant(cs_i, fxs), rj);
                }
                if (has_ov[i] != 0) {
                    // the JAX kernel's 384-lane window at ovlo[i], in its
                    // tile's scratch coordinates (front PREF nodes of
                    // lookback), translated back to node indices
                    const int olo_s = ovlo[i] - base + PREF;
                    int al_s = (max(olo_s, 0) / 128) * 128;
                    al_s = min(al_s, PREF + TILE - OVW);
                    const int al = al_s - PREF + base;
                    const int lo = max(max(max(al, ovlo[i]), wlo), 0);
                    const int hi = min(al + OVW, i);
                    const int q = quant(cs_i + igm_diff, fxs);
                    for (int j = lo + tid; j < hi; j += THREADS) {
                        if (kind4[j] != 1) continue;
                        const int tb = tb_row[j];
                        if (tb == -1) continue;
                        const int nj = ndx[j];
                        const int bnd = tn_row[j];
                        const int ovlp = (nj + 2) - (i_sv - 2) + 1;
                        if (!((i_sv - 2) < (nj + 2) && ovlp < MAX_OPP_OVLP
                              && (nj - i_sv) < (i_ndx - nj + 3)
                              && (nj - i_sv) < (i_sv - 3 - bnd)))
                            continue;
                        long long k = pack(sc_row[j] + q, j);
                        key = k > key ? k : key;
                    }
                }
            } else if (kind == 3) {
                const float rsc_i = rsc[row + i];
                const float usc_i = usc[row + i];
                float v3[3];
                int sv3[3], nd3[3];
                for (int k = 0; k < 3; ++k) {
                    v3[k] = val3[k * plane + row + i];
                    sv3[k] = t_sv[k * plane + row + i];
                    nd3[k] = t_ndx[k * plane + row + i];
                }
                const int right = i_ndx - 2;
                const int lo = max(max(i - W, wlo), 0);
                for (int j = lo + tid; j < i; j += THREADS) {
                    const int kj = kind4[j];
                    if (kj == 0 || kj == 4) continue;
                    const int nj = ndx[j];
                    const int tb = tb_row[j];
                    float sc;
                    if (kj == 1) {
                        const int left = nj + 2;
                        if (!(left < right) || tb == -1) continue;
                        float bv;
                        const int bf = triple_overlap(left, tb, tn_row[j], v3,
                                                      sv3, nd3, &bv);
                        sc = bf != -1 ? bv : igm_diff;
                    } else if (kj == 2) {
                        if (!(nj < right) || tb == -1) continue;
                        sc = igm_same(nj, -1, rsc[row + j], usc[row + j],
                                      i_ndx, rsc_i, usc_i, stw);
                    } else {
                        if (!(sv[j] > i_ndx)) continue;
                        sc = v3[nj % 3];
                    }
                    if (!(sc > NEGF_HALF)) continue;
                    long long k = pack(sc_row[j] + quant(sc, fxs), j);
                    key = k > key ? k : key;
                }
            } else if (tid == 0) {
                // kind 1: the frame's gene and operon registers
                const int gj = r_idx[i_fr];
                const int oj = r_idx[3 + i_fr];
                if (gj >= wlo) key = pack(r_val[i_fr], gj);
                if (oj >= wlo) {
                    long long k = pack(r_val[3 + i_fr], oj);
                    key = k > key ? k : key;
                }
            }

            key = block_max<THREADS>(key, red);
            if (tid == 0) {
                const bool live = key != NO_KEY && key_value(key) >= 0;
                const int best = live ? key_value(key) : 0;
                const int bj = live ? (int)(key & 0xffffffffLL) : -1;
                if (live) {
                    int bf = -1;
                    if (kind == 3 && kind4[bj] == 1) {
                        float unused;
                        float v3[3];
                        int sv3[3], nd3[3];
                        for (int k = 0; k < 3; ++k) {
                            v3[k] = val3[k * plane + row + i];
                            sv3[k] = t_sv[k * plane + row + i];
                            nd3[k] = t_ndx[k * plane + row + i];
                        }
                        bf = triple_overlap(ndx[bj] + 2, tb_row[bj],
                                            tn_row[bj], v3, sv3, nd3,
                                            &unused);
                    }
                    sc_row[i] = best;
                    tb_row[i] = bj;
                    ov_row[i] = bf;
                    tn_row[i] = ndx[bj];
                }
                // register upkeep: this node as a future source
                if (kind == 0) {
                    const int cand = best + quant(cs[row + i], fxs);
                    if (cand >= r_val[i_fr]) {
                        r_val[i_fr] = cand;
                        r_idx[i_fr] = i;
                    }
                } else if (kind == 1) {
                    const int slot = g_pos % RING;
                    g_j[slot] = i;
                    g_ndx[slot] = i_ndx;
                    g_val[slot] = live ? best : INT_NEG;
                    g_pos += 1;
                    r_val[i_fr] = INT_NEG;
                    r_idx[i_fr] = -1;
                    r_val[3 + i_fr] = INT_NEG;
                    r_idx[3 + i_fr] = -1;
                    for (int f2 = 0; f2 < 3; ++f2) {
                        const float opv = opv1[f2 * plane + row + i];
                        if (!live || !(opv > NEGF_HALF) || f2 == i_fr)
                            continue;
                        const int cand = best + quant(opv, fxs);
                        if (cand >= r_val[3 + f2]) {
                            r_val[3 + f2] = cand;
                            r_idx[3 + f2] = i;
                        }
                    }
                } else if (kind == 3) {
                    r_val[6 + i_fr] = best;
                    r_idx[6 + i_fr] = i;
                    r_sv[i_fr] = i_sv;
                }
            }
            __syncthreads();
        }
    }
}

}  // namespace

extern "C" int dp_mega_launch(
    const int* ndx, const int* sv, const int* kind4, const int* win_lo,
    const int* ovlo, const int* has_ov, const int* tile_nn, const float* cs,
    const float* rsc, const float* usc, const float* opv1, const float* val3,
    const int* t_sv, const int* t_ndx, const float* st_wt, int* score,
    int* traceb, int* ovmark, int* tbndx, int B, int NT, int fxs,
    cudaStream_t stream) {
    dp_mega_kernel<<<B, THREADS, 0, stream>>>(
        ndx, sv, kind4, win_lo, ovlo, has_ov, tile_nn, cs, rsc, usc, opv1,
        val3, t_sv, t_ndx, st_wt, score, traceb, ovmark, tbndx, B, NT, fxs);
    return (int)cudaGetLastError();
}
