// mega DP: the gene-path dynamic program over one shared node geometry for
// B bin rows, in int32 fixed point.
//
// Replaces pyrodigal_tpu/ops/dp_pallas.py::_dp_kernel_mega (launch
// _run_kernel_mega, entry _dp_core_mega).  Each node i takes the
// lexicographic (value, source index) maximum over its predecessors --
// the reference's `>=` last-wins relaxation -- and commits when that value
// is >= 0.  The predecessor set per target kind is the JAX kernel's:
//   kind 0 (fwd start): rev starts in [max(floor((i-1024)/128)*128, win_lo),
//       i) with the flat -0.15*st_wt modifier, and the fwd stops of its
//       256-slot ring with j >= win_lo and ndx_j + 2 < ndx_i, distance-only
//       modifier (the host checks that every fwd stop of [win_lo, i) is in
//       the ring, so these are simply the fwd stops of [win_lo, i));
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
// dependent node steps (153 k for a 2.46 Mbp genome), so the time is NT
// times the step latency; only B blocks run (one SM each).  The bytes
// (~0.2 GB) and operations are a millisecond or less.
//
// Design: one thread block per bin row, and everything a step reads in
// shared memory or registers.
// * Every source any target reads lies in [base - 4096, base + 2048) for
//   its tile base (4096 = the window extent the host allows, the overlap
//   window's scratch clamp).  A ring of three tiles (6,144 slots) holds
//   each node's static fields (ndx, kind, and per kind the one or two
//   words a source of that kind needs: rsc/usc bits of a rev start, the
//   stop_val of a rev stop) and its committed score, live flag and tbndx.
//   A tile's fields are loaded at the tile start, over the slots of the
//   tile three back.
// * Per source kind 1-3, a ring of node indices in order (compacted at the
//   tile start with a block scan).  A kind-0 or kind-3 target walks only
//   the lists of the kinds it can take, from its newest source down, the
//   lists side by side in one loop so that their shared-memory reads
//   overlap, and each thread stops a list at its first source below the
//   window: a step evaluates a few hundred lanes, not 1,024.
// * One barrier per node step.  block_max reduces in a warp with two
//   redux instructions and across warps through double-buffered slots, so
//   every thread sees the winning key.  The block's last thread then
//   commits (global output, the ring) and keeps the nine class registers
//   (gene, operon, latest rev stop, x 3 frames): its warp holds the
//   walks' oldest entries, which run out first.  Every thread keeps the
//   just-committed node (score, live, tbndx) in registers, and a lane
//   whose source is that node reads the registers, not the ring that the
//   committing thread may still be writing.  A source committed two steps back or more was written
//   before the last barrier.
// * A lane's operations are few: the operon bonus reads its quotient
//   dist / 60 from a table of the 61 it can take (the same bits) instead
//   of dividing.
// * The ovmark frame of a kind-3 target's fwd-stop source travels in the
//   key's low bits ((j << 2) | (m + 1)), so the commit recomputes nothing.
// * The target's operands (win_lo, stop_val, and per kind cs, the overlap
//   window, the star tables or opv1) are loaded one step ahead into
//   registers, while the current step runs.
// Float arithmetic is the JAX kernel's operation order, built with
// -fmad=false; quantisation is round-half-even (__float2int_rn), as
// jnp.round, but a negative value never rounds to 0 (common.cuh `quant`).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int W = 1024;            // dp_pallas.W_MEGA
constexpr int TILE = 2048;         // dp_pallas.MEGA_TILE
constexpr int PREF = 4 * W;        // MEGA_CHUNKS * W_MEGA
constexpr int OVW = 384;           // kind-2 overlap window lanes
constexpr int RING = 3 * TILE;     // node slots: tiles t-2, t-1, t
constexpr int LCAP = RING;         // list entries per source kind
constexpr int PER_THREAD = TILE / THREADS;
// the thread that commits and keeps the class registers: in the last
// warp, whose lanes are the walks' oldest entries and run out first
constexpr int CTID = THREADS - 1;
static_assert(PER_THREAD * THREADS == TILE, "a tile is PER_THREAD a thread");

constexpr size_t SMEM_BYTES =
    2 * WARPS * sizeof(long long)          // red, two buffers
    + 5 * RING * sizeof(int)               // ndx, a, b, score, tbndx
    + 3 * LCAP * sizeof(int)               // lists of kinds 1, 2, 3
    + 24 * sizeof(int)                     // class registers
    + 64 * sizeof(float)                   // q60
    + 2 * RING;                            // kind, live

// one list walk: the next entry index (ring position) and whether the
// walk goes on
struct Walk {
    int k, x;
    bool on;
    __device__ __forceinline__ void start(int cnt, int kmin, int tid) {
        k = cnt - 1 - tid;
        on = k >= kmin;
        x = on ? k % LCAP : 0;
    }
    __device__ __forceinline__ void next(int kmin) {
        k -= THREADS;
        x -= THREADS;
        if (x < 0) x += LCAP;
        on = on && k >= kmin;
    }
};

__device__ __forceinline__ void keep(long long* key, long long k) {
    *key = k > *key ? k : *key;
}

__global__ void __launch_bounds__(THREADS, 1) dp_mega_kernel(
    const int* __restrict__ ndx, const int* __restrict__ sv,
    const int* __restrict__ kind4, const int* __restrict__ win_lo,
    const int* __restrict__ ovlo, const int* __restrict__ has_ov,
    const int* __restrict__ tile_nn,
    const float* __restrict__ cs, const float* __restrict__ rsc,
    const float* __restrict__ usc,
    const float* __restrict__ opv1, const float* __restrict__ val3,
    const int* __restrict__ t_sv, const int* __restrict__ t_ndx,
    const float* __restrict__ st_wt,
    int* __restrict__ score, int* __restrict__ traceb,
    int* __restrict__ ovmark, int* __restrict__ tbndx,
    int B, int NT, int fxs_i) {
    extern __shared__ __align__(16) unsigned char smem[];
    long long* red = reinterpret_cast<long long*>(smem);
    int* s_ndx = reinterpret_cast<int*>(red + 2 * WARPS);
    int* s_a = s_ndx + RING;       // rev start: rsc bits; rev stop: stop_val
    int* s_b = s_a + RING;         // rev start: usc bits
    int* s_sc = s_b + RING;        // committed score (0 if none)
    int* s_tn = s_sc + RING;       // tbndx (0 if none)
    int* s_list = s_tn + RING;     // [3][LCAP]: kinds 1, 2, 3
    int* r_val = s_list + 3 * LCAP;   // class registers (CTID only)
    int* r_idx = r_val + 9;
    int* r_sv = r_idx + 9;
    float* q60 = reinterpret_cast<float*>(r_sv + 6);
    unsigned char* s_kind = reinterpret_cast<unsigned char*>(q60 + 64);
    unsigned char* s_live = s_kind + RING;

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
    const int* L1 = s_list;
    const int* L2 = s_list + LCAP;
    const int* L3 = s_list + 2 * LCAP;

    if (tid == CTID) {
        for (int k = 0; k < 9; ++k) {
            r_val[k] = INT_NEG;
            r_idx[k] = -1;
        }
        for (int k = 0; k < 3; ++k) r_sv[k] = -1000000000;
    }
    fill_q60(q60);

    // identical in every thread: list entries loaded, entries below the
    // current target, the oldest entry still held; the last committed node
    int ld1 = 0, ld2 = 0, ld3 = 0;
    int c1 = 0, c2 = 0, c3 = 0;
    int m1 = 0, m2 = 0, m3 = 0;
    int last_j = -1, last_sc = 0, last_tn = 0;
    bool last_live = false;
    int buf = 0;

    // the next target's operands
    int p_kind = 0, p_ndx = 0, p_wlo = 0, p_sv = 0, p_ovlo = 0, p_hov = 0;
    float p_cs = 0.0f;
    float p_v3[3] = {0.0f, 0.0f, 0.0f}, p_opv[3] = {0.0f, 0.0f, 0.0f};
    int p_sv3[3] = {0, 0, 0}, p_nd3[3] = {0, 0, 0};

    const int n_tiles = NT / TILE;
    for (int t = 0; t < n_tiles; ++t) {
        const int base = t * TILE;
        const int nn = tile_nn[t];
        const int end = base + nn;
        // slot of node j in [base - 2 * TILE, base + TILE): j mod RING
        const int s_off = 2 * TILE - base + ((t + 1) % 3) * TILE;
        auto slot = [&](int j) {
            const int x = j + s_off;
            return x >= RING ? x - RING : x;
        };
        // every operand, whatever the kind: no load waits on another
        auto prefetch = [&](int i) {
            const int si = slot(i);
            p_kind = s_kind[si];
            p_ndx = s_ndx[si];
            p_wlo = __ldg(win_lo + i);
            p_sv = __ldg(sv + i);
            p_cs = __ldg(cs + row + i);
            p_ovlo = __ldg(ovlo + i);
            p_hov = __ldg(has_ov + i);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                p_v3[k] = __ldg(val3 + k * plane + row + i);
                p_sv3[k] = __ldg(t_sv + k * plane + row + i);
                p_nd3[k] = __ldg(t_ndx + k * plane + row + i);
                p_opv[k] = __ldg(opv1 + k * plane + row + i);
            }
        };

        // -- tile load: static fields over the slots of tile t - 3, output
        // defaults, and the tile's sources of kinds 1-3 in order ---------
        int kd[PER_THREAD];
        unsigned long long cnt = 0;
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e) {
            const int k = tid * PER_THREAD + e;
            const int j = base + k;
            const int s = slot(j);
            kd[e] = k < nn ? kind4[j] : 4;
            s_kind[s] = (unsigned char)kd[e];
            s_live[s] = 0;
            s_ndx[s] = ndx[j];
            s_a[s] = kd[e] == 3 ? sv[j]
                     : (kd[e] == 2 ? __float_as_int(rsc[row + j]) : 0);
            s_b[s] = kd[e] == 2 ? __float_as_int(usc[row + j]) : 0;
            s_sc[s] = 0;
            s_tn[s] = 0;
            sc_row[j] = 0;
            tb_row[j] = -1;
            ov_row[j] = -1;
            tn_row[j] = 0;
            if (kd[e] >= 1 && kd[e] <= 3) cnt += 1ULL << (16 * (kd[e] - 1));
        }
        unsigned long long total;
        unsigned long long excl = block_exclusive_scan_u64<THREADS>(cnt,
                                                                    &total);
        int w1 = ld1 + field16(excl, 0);
        int w2 = ld2 + field16(excl, 1);
        int w3 = ld3 + field16(excl, 2);
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e) {
            const int j = base + tid * PER_THREAD + e;
            if (kd[e] == 1) s_list[(w1++) % LCAP] = j;
            else if (kd[e] == 2) s_list[LCAP + (w2++) % LCAP] = j;
            else if (kd[e] == 3) s_list[2 * LCAP + (w3++) % LCAP] = j;
        }
        ld1 += field16(total, 0);
        ld2 += field16(total, 1);
        ld3 += field16(total, 2);
        m1 = max(ld1 - LCAP, 0);
        m2 = max(ld2 - LCAP, 0);
        m3 = max(ld3 - LCAP, 0);
        __syncthreads();

        if (nn > 0) prefetch(base);
        for (int i = base; i < end; ++i) {
            const int si = slot(i);
            const int kind = p_kind;
            const int i_ndx = p_ndx;
            const int i_fr = i_ndx % 3;
            const int wlo = p_wlo;
            const int i_sv = p_sv;
            const float cs_i = p_cs;
            const int olo = p_ovlo;
            const int hov = p_hov;
            float v3[3], opv[3];
            int sv3[3], nd3[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                v3[k] = p_v3[k];
                sv3[k] = p_sv3[k];
                nd3[k] = p_nd3[k];
                opv[k] = p_opv[k];
            }
            if (i + 1 < end) prefetch(i + 1);

            // a committed source's score, live flag and tbndx
            auto fetch = [&](int j, int s, int* sc, int* tn) {
                if (j == last_j) {
                    *sc = last_sc;
                    *tn = last_tn;
                    return last_live;
                }
                *sc = s_sc[s];
                *tn = s_tn[s];
                return s_live[s] != 0;
            };

            long long key = NO_KEY;
            if (kind == 1) {
                // the frame's gene and operon registers
                if (tid == CTID) {
                    const int gj = r_idx[i_fr];
                    const int oj = r_idx[3 + i_fr];
                    if (gj >= wlo) key = pack(r_val[i_fr], (unsigned)gj << 2);
                    if (oj >= wlo)
                        keep(&key, pack(r_val[3 + i_fr], (unsigned)oj << 2));
                }
            } else if (kind == 2) {
                if (tid == CTID) {
                    const int rj = r_idx[6 + i_fr];
                    if (r_sv[i_fr] > i_ndx && rj >= wlo)
                        key = pack(r_val[6 + i_fr] + quant(cs_i, fxs),
                                   (unsigned)rj << 2);
                }
                if (hov != 0) {
                    // the JAX kernel's 384-lane window at ovlo[i], in its
                    // tile's scratch coordinates (front PREF nodes of
                    // lookback), translated back to node indices; two
                    // lanes a thread at a time
                    const int olo_s = olo - base + PREF;
                    int al_s = (max(olo_s, 0) / 128) * 128;
                    al_s = min(al_s, PREF + TILE - OVW);
                    const int al = al_s - PREF + base;
                    const int lo = max(max(max(al, olo), wlo), 0);
                    const int hi = min(al + OVW, i);
                    const int q = quant(cs_i + igm_diff, fxs);
                    auto ov_ok = [&](int nj, int bnd) {
                        const int ovlp = (nj + 2) - (i_sv - 2) + 1;
                        return (i_sv - 2) < (nj + 2) && ovlp < MAX_OPP_OVLP
                               && (nj - i_sv) < (i_ndx - nj + 3)
                               && (nj - i_sv) < (i_sv - 3 - bnd);
                    };
                    for (int ja = lo + tid; ja < hi; ja += 2 * THREADS) {
                        const int jb = ja + THREADS;
                        const bool ob = jb < hi;
                        const int sa = slot(ja), sb = slot(ob ? jb : i);
                        const bool ka = s_kind[sa] == 1;
                        const bool kb = ob && s_kind[sb] == 1;
                        const int na = s_ndx[sa], nb = s_ndx[sb];
                        int sca, bnda, scb, bndb;
                        const bool la = fetch(ja, sa, &sca, &bnda);
                        const bool lb = fetch(jb, sb, &scb, &bndb);
                        if (ka && la && ov_ok(na, bnda))
                            keep(&key, pack(sca + q, (unsigned)ja << 2));
                        if (kb && lb && ov_ok(nb, bndb))
                            keep(&key, pack(scb + q, (unsigned)jb << 2));
                    }
                }
            } else if (kind == 0) {
                // rev starts over the JAX kernel's aligned window
                // [floor((i - W) / 128) * 128, i), flat modifier; fwd stops
                // of [win_lo, i), distance-only modifier (a stop with no
                // committed path carries INT_NEG, as in the ring)
                int al = i - W;
                al = (al >= 0 ? al / 128 : -((-al + 127) / 128)) * 128;
                const int lo = max(max(al, wlo), 0);
                Walk w2, w1;
                w2.start(c2, m2, tid);
                w1.start(c1, m1, tid);
                while (w2.on || w1.on) {
                    const int j2 = w2.on ? L2[w2.x] : -1;
                    const int j1 = w1.on ? L1[w1.x] : -1;
                    const bool a2 = j2 >= lo, a1 = j1 >= wlo;
                    const int s2 = slot(a2 ? j2 : i), s1 = slot(a1 ? j1 : i);
                    const int n2 = s_ndx[s2], n1 = s_ndx[s1];
                    int sc2, tn2, sc1, tn1;
                    const bool l2 = fetch(j2, s2, &sc2, &tn2);
                    const bool l1 = fetch(j1, s1, &sc1, &tn1);
                    if (a2 && l2 && n2 < i_ndx)
                        keep(&key, pack(sc2 + q_diff, (unsigned)j2 << 2));
                    if (a1 && n1 + 2 < i_ndx) {
                        const int dist = i_ndx - n1;
                        const bool far = dist > 3 * OPER_DIST;
                        const bool operon = dist <= OPER_DIST
                                            || dist * 4 < OPER_DIST;
                        const float bonus = (2.0f - (operon ? q60[dist]
                                                     : 0.0f)) * 0.15f * stw;
                        const float igm = far ? -0.15f * stw
                                              : (operon ? bonus : 0.0f);
                        keep(&key, pack((l1 ? sc1 : INT_NEG)
                                        + quant(igm, fxs),
                                        (unsigned)j1 << 2));
                    }
                    w2.on = a2;
                    w1.on = a1;
                    w2.next(m2);
                    w1.next(m1);
                }
            } else {
                // kind 3: fwd stops (triple overlap), rev starts, rev stops
                // of [max(i - W, win_lo), i)
                const int right = i_ndx - 2;
                const int lo = max(max(i - W, wlo), 0);
                Walk w1, w2, w3;
                w1.start(c1, m1, tid);
                w2.start(c2, m2, tid);
                w3.start(c3, m3, tid);
                while (w1.on || w2.on || w3.on) {
                    const int j1 = w1.on ? L1[w1.x] : -1;
                    const int j2 = w2.on ? L2[w2.x] : -1;
                    const int j3 = w3.on ? L3[w3.x] : -1;
                    const bool a1 = j1 >= lo, a2 = j2 >= lo, a3 = j3 >= lo;
                    const int s1 = slot(a1 ? j1 : i), s2 = slot(a2 ? j2 : i);
                    const int s3 = slot(a3 ? j3 : i);
                    const int n1 = s_ndx[s1], n2 = s_ndx[s2], n3 = s_ndx[s3];
                    const int sv_3 = s_a[s3];
                    const float r2 = __int_as_float(s_a[s2]);
                    const float u2 = __int_as_float(s_b[s2]);
                    int sc1, tn1, sc2, tn2, sc3, tn3;
                    const bool l1 = fetch(j1, s1, &sc1, &tn1);
                    const bool l2 = fetch(j2, s2, &sc2, &tn2);
                    fetch(j3, s3, &sc3, &tn3);
                    const int left = n1 + 2;
                    if (a1 && l1 && left < right) {
                        float bv;
                        const int bf = triple_overlap(left, 0, tn1, v3, sv3,
                                                      nd3, &bv);
                        const float c = bf != -1 ? bv : igm_diff;
                        if (c > NEGF_HALF)
                            keep(&key, pack(sc1 + quant(c, fxs),
                                            ((unsigned)j1 << 2) | (bf + 1)));
                    }
                    if (a2 && l2 && n2 < right) {
                        // a rev-strand source reads its own rsc/usc only
                        const float c = igm_same(n2, -1, r2, u2, i_ndx, 0.0f,
                                                 0.0f, stw, q60);
                        if (c > NEGF_HALF)
                            keep(&key, pack(sc2 + quant(c, fxs),
                                            (unsigned)j2 << 2));
                    }
                    if (a3 && sv_3 > i_ndx) {
                        const float c = v3[n3 % 3];
                        if (c > NEGF_HALF)
                            keep(&key, pack(sc3 + quant(c, fxs),
                                            (unsigned)j3 << 2));
                    }
                    w1.on = a1;
                    w2.on = a2;
                    w3.on = a3;
                    w1.next(m1);
                    w2.next(m2);
                    w3.next(m3);
                }
            }

            key = block_max<THREADS>(key, red + buf * WARPS);
            buf ^= 1;
            const bool live = key != NO_KEY && key_value(key) >= 0;
            const int best = live ? key_value(key) : 0;
            const unsigned low = (unsigned)(key & 0xffffffffLL);
            const int bj = live ? (int)(low >> 2) : -1;
            const int btn = live ? s_ndx[slot(bj)] : 0;
            if (tid == CTID) {
                if (live) {
                    sc_row[i] = best;
                    tb_row[i] = bj;
                    ov_row[i] = (int)(low & 3) - 1;
                    tn_row[i] = btn;
                }
                s_sc[si] = best;
                s_tn[si] = btn;
                s_live[si] = live ? 1 : 0;
                // class-register upkeep: this node as a future source
                if (kind == 0) {
                    const int cand = best + quant(cs_i, fxs);
                    if (cand >= r_val[i_fr]) {
                        r_val[i_fr] = cand;
                        r_idx[i_fr] = i;
                    }
                } else if (kind == 1) {
                    r_val[i_fr] = INT_NEG;
                    r_idx[i_fr] = -1;
                    r_val[3 + i_fr] = INT_NEG;
                    r_idx[3 + i_fr] = -1;
#pragma unroll
                    for (int f2 = 0; f2 < 3; ++f2) {
                        if (!live || !(opv[f2] > NEGF_HALF) || f2 == i_fr)
                            continue;
                        const int cand = best + quant(opv[f2], fxs);
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
            last_j = i;
            last_sc = best;
            last_tn = btn;
            last_live = live;
            c1 += kind == 1;
            c2 += kind == 2;
            c3 += kind == 3;
        }
        // every thread has read the last step's winner (its tbndx lies in
        // a slot up to two tiles back) before the next tile load
        // overwrites those slots
        __syncthreads();
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
    cudaError_t err = cudaFuncSetAttribute(
        dp_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dp_mega_kernel<<<B, THREADS, SMEM_BYTES, stream>>>(
        ndx, sv, kind4, win_lo, ovlo, has_ov, tile_nn, cs, rsc, usc, opv1,
        val3, t_sv, t_ndx, st_wt, score, traceb, ovmark, tbndx, B, NT, fxs);
    return (int)cudaGetLastError();
}
