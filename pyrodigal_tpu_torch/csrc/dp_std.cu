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
// round(cand * 2048) (a negative value never to 0: common.cuh `quant`)
// and added to score[j].  Among equal totals the JAX
// kernel picks the largest lane of a chunk and keeps the nearest chunk
// (strict `>` across chunks), i.e. the largest j; the packed key
// (total, j, m + 1) below gives the same order, with the ovmark frame m in
// its two low bits.  A node commits when the best total is >= 0 (the score
// it holds before its own step) and writes score, traceb = j (a node index,
// not the JAX kernel's W-front-padded lane), ovmark = m and tbndx = ndx[j].
// Pads (kind 4) commit nothing and keep score 0, traceb -1, ovmark -1,
// tbndx 0.
//
// The skip rules leave each target kind a fixed set of source kinds and
// frames:
//   fwd start (0): fwd stops (artifact rule), rev starts (artifact rule);
//   fwd stop (1):  fwd starts of its frame, fwd stops (artifact rule);
//   rev start (2): fwd stops (artifact rule), rev stops of its frame;
//   rev stop (3):  fwd stops and rev starts (artifact rule), rev stops.
//
// What bounds it on the H100: latency.  A row is a chain of up to 3,072
// dependent node steps, each a window search and a block reduction; the
// bytes (~35 MB a launch) and operations are tens of microseconds.
//
// Design: one thread block per row (a std launch's 128 rows fill 128 of
// the 132 SMs), of 128 threads (on the H100 a step took longer with 64 or
// 256), and the whole row in shared memory.
// * At the start the block stages every node's ndx, kind and the words a
//   source of its kind needs (fwd start: cs; fwd stop: opv1 of the three
//   frames; rev start: rsc, usc; rev stop: stop_val), about 34 B a node,
//   and compacts the node indices into nine ordered lists: fwd starts by
//   frame, fwd stops, rev starts, rev stops by frame, all rev stops.
//   Commits write the score, live flag and tbndx to shared memory and the
//   output to global memory; nothing is read back from global memory.
// * A target walks only the lists of the kinds (and frames) its rules
//   admit, from its newest source down, two or three lists side by side
//   in one loop so that their shared-memory reads overlap, and each thread
//   stops a list at its first source below the window: no lane is spent
//   on a source the skip rules drop.
// * One barrier per node step (block_max with double-buffered slots: every
//   thread sees the winner); the last thread, whose warp holds the walks'
//   oldest entries, writes the commit, and every thread keeps the
//   just-committed node in registers for the next step, whose lanes may
//   read it before that shared-memory write is ordered by a barrier.
// * A lane's operations are few: the operon bonus reads its quotient
//   dist / 60 from a table of the 61 it can take (the same bits) instead
//   of dividing.
// * The target's own operands (win_lo, stop_val, cs, rsc, usc, star
//   tables) are loaded one step ahead into registers.
// Float arithmetic is the JAX kernel's operation order, built with
// -fmad=false.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int W = 640;              // meta_tpu window
constexpr int CHUNKS = 3;           // dp_pallas.FIXED_CHUNKS
constexpr float FXS = 2048.0f;      // dp_pallas.FXS
// source lists: fwd starts by frame (0-2), fwd stops (3), rev starts (4),
// rev stops by frame (5-7), all rev stops (8)
constexpr int NLIST = 9;
// shared bytes per node: ndx, three payload words, score, tbndx, two list
// entries (a rev stop is in two lists), kind, live
constexpr int NODE_BYTES = 8 * 4 + 2;
constexpr int FIXED_BYTES = 2 * WARPS * 8 + 64 * 4;   // red, q60

// floor mod 3, as the JAX kernel's x - (x // 3) * 3
__device__ __forceinline__ int mod3(int x) {
    int m = x % 3;
    return m < 0 ? m + 3 : m;
}

// the frame-wise list a node belongs to (-1: a pad); a rev stop is also
// in list 8
__device__ __forceinline__ int list_of(int kind, int fr) {
    return kind == 0 ? fr : kind == 1 ? 3 : kind == 2 ? 4
           : kind == 3 ? 5 + fr : -1;
}

__device__ __forceinline__ int pick(const int (&c)[NLIST], int q) {
    int v = c[0];
#pragma unroll
    for (int k = 1; k < NLIST; ++k) v = k == q ? c[k] : v;
    return v;
}

// one list walk from its newest entry below the target down: the entry
// index and whether the walk goes on
struct Walk {
    int k, first;
    bool on;
    __device__ __forceinline__ void start(int first_, int cnt, int tid) {
        first = first_;
        k = first + cnt - 1 - tid;
        on = k >= first;
    }
    __device__ __forceinline__ void next() {
        k -= THREADS;
        on = on && k >= first;
    }
};

__device__ __forceinline__ void offer(long long* key, int sc, float cand,
                                      int j, int m) {
    if (!(cand > NEGF_HALF)) return;
    const long long k = pack(sc + quant(cand, FXS),
                             ((unsigned)j << 2) | (m + 1));
    *key = k > *key ? k : *key;
}

__global__ void __launch_bounds__(THREADS, 1) dp_std_kernel(
    const int* __restrict__ ndx, const int* __restrict__ sv,
    const int* __restrict__ kind4, const int* __restrict__ win_lo,
    const float* __restrict__ cs, const float* __restrict__ rsc,
    const float* __restrict__ usc,
    const float* __restrict__ opv1, const float* __restrict__ val3,
    const int* __restrict__ t_sv, const int* __restrict__ t_ndx,
    const float* __restrict__ st_wt,
    int* __restrict__ score, int* __restrict__ traceb,
    int* __restrict__ ovmark, int* __restrict__ tbndx, int BT, int n) {
    extern __shared__ __align__(16) unsigned char smem[];
    long long* red = reinterpret_cast<long long*>(smem);
    float* q60 = reinterpret_cast<float*>(red + 2 * WARPS);
    int* s_ndx = reinterpret_cast<int*>(q60 + 64);
    int* s_pa = s_ndx + n;
    int* s_pb = s_pa + n;
    int* s_pc = s_pb + n;
    int* s_sc = s_pc + n;
    int* s_tn = s_sc + n;
    int* s_list = s_tn + n;        // 2n entries
    unsigned char* s_kind = reinterpret_cast<unsigned char*>(s_list + 2 * n);
    unsigned char* s_live = s_kind + n;

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

    // -- stage the row and the output defaults --------------------------
    fill_q60(q60);
    for (int i = tid; i < n; i += THREADS) {
        const int k = kind4[i];
        s_kind[i] = (unsigned char)k;
        s_live[i] = 0;
        s_ndx[i] = ndx[i];
        int pa = 0, pb = 0, pc = 0;
        if (k == 0) {
            pa = __float_as_int(cs[i]);
        } else if (k == 1) {
            pa = __float_as_int(opv1[row + i]);
            pb = __float_as_int(opv1[plane + row + i]);
            pc = __float_as_int(opv1[2 * plane + row + i]);
        } else if (k == 2) {
            pa = __float_as_int(rsc[i]);
            pb = __float_as_int(usc[i]);
        } else if (k == 3) {
            pa = sv[i];
        }
        s_pa[i] = pa;
        s_pb[i] = pb;
        s_pc[i] = pc;
        s_sc[i] = 0;
        s_tn[i] = 0;
        score[i] = 0;
        traceb[i] = -1;
        ovmark[i] = -1;
        tbndx[i] = 0;
    }

    // -- the source lists, each in node order: every thread counts a
    // contiguous chunk, packed block scans give its write offsets --------
    const int per = (n + THREADS - 1) / THREADS;
    const int c_lo = min(tid * per, n);
    const int c_hi = min(c_lo + per, n);
    unsigned long long cw[3] = {0, 0, 0};     // lists 0-3, 4-7, 8
    for (int i = c_lo; i < c_hi; ++i) {
        const int k = kind4[i];
        const int q = list_of(k, mod3(ndx[i]));
        if (q >= 0 && q < 4) cw[0] += 1ULL << (16 * q);
        else if (q >= 4) cw[1] += 1ULL << (16 * (q - 4));
        if (k == 3) cw[2] += 1ULL;
    }
    int off[NLIST], wpos[NLIST];
    {
        unsigned long long ex[3], tot[3];
#pragma unroll
        for (int w = 0; w < 3; ++w)
            ex[w] = block_exclusive_scan_u64<THREADS>(cw[w], &tot[w]);
        int acc = 0;
#pragma unroll
        for (int q = 0; q < NLIST; ++q) {
            off[q] = acc;
            wpos[q] = acc + field16(ex[q >> 2], q & 3);
            acc += field16(tot[q >> 2], q & 3);
        }
    }
    for (int i = c_lo; i < c_hi; ++i) {
        const int k = kind4[i];
        const int q = list_of(k, mod3(ndx[i]));
#pragma unroll
        for (int l = 0; l < NLIST - 1; ++l)
            if (l == q) s_list[wpos[l]++] = i;
        if (k == 3) s_list[wpos[8]++] = i;
    }
    __syncthreads();

    // identical in every thread: entries of each list below the current
    // target; the last committed node
    int cnt[NLIST];
#pragma unroll
    for (int q = 0; q < NLIST; ++q) cnt[q] = 0;
    int last_j = -1, last_sc = 0, last_tn = 0;
    bool last_live = false;
    int buf = 0;

    // the next target's operands
    int p_kind = 4, p_ndx = 0, p_wlo = 0, p_sv = 0;
    float p_cs = 0.0f, p_rsc = 0.0f, p_usc = 0.0f;
    float p_v3[3] = {0.0f, 0.0f, 0.0f};
    int p_sv3[3] = {0, 0, 0}, p_nd3[3] = {0, 0, 0};
    // every operand, whatever the kind: no load waits on another
    auto prefetch = [&](int i) {
        p_kind = s_kind[i];
        p_ndx = s_ndx[i];
        p_wlo = __ldg(win_lo + i);
        p_sv = __ldg(sv + i);
        p_rsc = __ldg(rsc + i);
        p_usc = __ldg(usc + i);
        p_cs = __ldg(cs + i);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            p_v3[k] = __ldg(val3 + k * plane + row + i);
            p_sv3[k] = __ldg(t_sv + k * plane + row + i);
            p_nd3[k] = __ldg(t_ndx + k * plane + row + i);
        }
    };
    // the next non-pad node at or after i (n if none)
    auto next_real = [&](int i) {
        while (i < n && s_kind[i] == 4) ++i;
        return i;
    };

    int i = next_real(0);
    if (i < n) prefetch(i);
    while (i < n) {
        const int i_kind = p_kind;
        const int i_ndx = p_ndx;
        const int i_fr = mod3(i_ndx);
        const int i_sv = p_sv;
        const int lo = max(max(p_wlo, i - CHUNKS * W), 0);
        const float cs_i = p_cs, rsc_i = p_rsc, usc_i = p_usc;
        float v3[3];
        int sv3[3], nd3[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            v3[k] = p_v3[k];
            sv3[k] = p_sv3[k];
            nd3[k] = p_nd3[k];
        }
        const int i_next = next_real(i + 1);
        if (i_next < n) prefetch(i_next);

        // a committed source's score, live flag and tbndx
        auto fetch = [&](int j, int* sc, int* tn) {
            if (j == last_j) {
                *sc = last_sc;
                *tn = last_tn;
                return last_live;
            }
            *sc = s_sc[j];
            *tn = s_tn[j];
            return s_live[j] != 0;
        };
        // the next entry of walk w, or -1 once it has passed below lo
        auto entry = [&](Walk& w) {
            const int j = w.on ? s_list[w.k] : -1;
            w.on = j >= lo;
            return w.on ? j : -1;
        };

        long long key = NO_KEY;
        // fwd stops (list 3) serve every target kind; the second (and
        // third) list depends on it: rev starts (0, 3), fwd starts of the
        // target's frame (1), rev stops of its frame (2), all rev stops (3)
        Walk w1, w2, w3;
        const int q2 = i_kind == 0 ? 4 : i_kind == 1 ? i_fr
                       : i_kind == 2 ? 5 + i_fr : 4;
        w1.start(off[3], cnt[3], tid);
        w2.start(pick(off, q2), pick(cnt, q2), tid);
        w3.start(off[8], cnt[8], tid);
        w3.on = w3.on && i_kind == 3;
        const int right = i_ndx - 2;
        while (w1.on || w2.on || w3.on) {
            const int j1 = entry(w1), j2 = entry(w2), j3 = entry(w3);
            const int s1 = max(j1, 0), s2 = max(j2, 0), s3 = max(j3, 0);
            const int n1 = s_ndx[s1], n2 = s_ndx[s2], n3 = s_ndx[s3];
            const int pa2 = s_pa[s2], pb2 = s_pb[s2], pc2 = s_pc[s2];
            const int pa1 = s_pa[s1], pb1 = s_pb[s1], pc1 = s_pc[s1];
            const int pa3 = s_pa[s3];
            int sc1, tn1, sc2, tn2, sc3, tn3;
            const bool l1 = fetch(s1, &sc1, &tn1);
            const bool l2 = fetch(s2, &sc2, &tn2);
            fetch(s3, &sc3, &tn3);
            if (i_kind == 0) {                    // fwd start
                if (j1 >= 0 && l1 && n1 + 2 < i_ndx)
                    offer(&key, sc1, igm_same(n1, 1, 0.0f, 0.0f, i_ndx,
                                              rsc_i, usc_i, stw, q60),
                          j1, -1);
                if (j2 >= 0 && l2 && n2 < i_ndx)  // rev starts
                    offer(&key, sc2, igm_diff, j2, -1);
            } else if (i_kind == 1) {             // fwd stop
                if (j1 >= 0 && l1 && i_sv < n1) {
                    const int p = i_fr == 0 ? pa1 : (i_fr == 1 ? pb1 : pc1);
                    offer(&key, sc1, __int_as_float(p), j1, -1);
                }
                if (j2 >= 0 && i_sv < n2)         // fwd starts, its frame
                    offer(&key, sc2, __int_as_float(pa2), j2, -1);
            } else if (i_kind == 2) {             // rev start
                if (j1 >= 0 && l1) {
                    const int ovlp = (n1 + 2) - (i_sv - 2) + 1;
                    if ((i_sv - 2) < (n1 + 2) && ovlp < MAX_OPP_OVLP
                        && (n1 - i_sv) < (i_ndx - n1 + 3)
                        && (n1 - i_sv) < (i_sv - 3 - tn1))
                        offer(&key, sc1, cs_i + igm_diff, j1, -1);
                }
                if (j2 >= 0 && pa2 > i_ndx)       // rev stops, its frame
                    offer(&key, sc2, cs_i + 0.0f * igm_diff, j2, -1);
            } else {                              // rev stop
                const int left = n1 + 2;
                if (j1 >= 0 && l1) {
                    float bv;
                    const int m = triple_overlap(left, 0, tn1, v3, sv3, nd3,
                                                 &bv);
                    if (left < right)
                        offer(&key, sc1, m != -1 ? bv : igm_diff, j1, m);
                }
                if (j2 >= 0 && l2 && n2 < right)  // rev starts
                    offer(&key, sc2, igm_same(n2, -1, __int_as_float(pa2),
                                              __int_as_float(pb2), i_ndx,
                                              rsc_i, usc_i, stw, q60),
                          j2, -1);
                if (j3 >= 0 && pa3 > i_ndx)       // rev stops
                    offer(&key, sc3, v3[mod3(n3)], j3, -1);
            }
            w1.next();
            w2.next();
            w3.next();
        }

        key = block_max<THREADS>(key, red + buf * WARPS);
        buf ^= 1;
        const int best = key_value(key);
        const bool live = key != NO_KEY && best > INT_NEG / 2 && best >= 0;
        const unsigned low = (unsigned)(key & 0xffffffffLL);
        const int j = (int)(low >> 2);
        const int btn = live ? s_ndx[j] : 0;
        if (tid == THREADS - 1 && live) {
            score[i] = best;
            traceb[i] = j;
            ovmark[i] = (int)(low & 3) - 1;
            tbndx[i] = btn;
            s_sc[i] = best;
            s_tn[i] = btn;
            s_live[i] = 1;
        }
        last_j = i;
        last_sc = live ? best : 0;
        last_tn = btn;
        last_live = live;
        const int q = list_of(i_kind, i_fr);
#pragma unroll
        for (int k = 0; k < NLIST - 1; ++k) cnt[k] += k == q;
        cnt[8] += i_kind == 3;
        i = i_next;
    }
}

}  // namespace

// shared memory a row of n nodes takes (the wrapper checks it against the
// device's limit)
extern "C" int dp_std_smem_bytes(int n) {
    return FIXED_BYTES + NODE_BYTES * n;
}

extern "C" int dp_std_launch(
    const int* ndx, const int* sv, const int* kind4, const int* win_lo,
    const float* cs, const float* rsc, const float* usc, const float* opv1,
    const float* val3, const int* t_sv, const int* t_ndx, const float* st_wt,
    int* score, int* traceb, int* ovmark, int* tbndx, int BT, int n,
    cudaStream_t stream) {
    const int bytes = dp_std_smem_bytes(n);
    cudaError_t err = cudaFuncSetAttribute(
        dp_std_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    dp_std_kernel<<<BT, THREADS, bytes, stream>>>(
        ndx, sv, kind4, win_lo, cs, rsc, usc, opv1, val3, t_sv, t_ndx, st_wt,
        score, traceb, ovmark, tbndx, BT, n);
    return (int)cudaGetLastError();
}
