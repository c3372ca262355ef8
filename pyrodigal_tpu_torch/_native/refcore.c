/* refcore.c — exact float64 reference engine for the Prodigal v2.6.3
 * gene-finding algorithm, operating on struct-of-arrays buffers owned by
 * Python (numpy).  This module plays the role of the exact "backend=None"
 * path of the reference (althonos/pyrodigal): every TPU/JAX kernel in
 * pyrodigal_tpu is differentially tested against it, and the CPU fallback
 * path of the framework uses it directly.
 *
 * Provenance: the algorithmic behaviour follows the published Prodigal
 * method as specified by the reference implementation (citations given per
 * function, file:line of /root/reference).  Because this module's purpose
 * is BIT-EXACT float64 equality with the reference, the arithmetic here
 * necessarily mirrors the reference's operation order and pass structure
 * closely (loop decomposition and much of the naming follow lib.pyx); the
 * memory layout is struct-of-arrays rather than the reference's
 * array-of-structs.  This file is the differential-test oracle and host
 * finishing path; the product compute path is the JAX/Pallas pipeline in
 * pyrodigal_tpu/ops/.
 *
 * Re-entrancy invariant: the scoring / DP / finishing entry points run
 * CONCURRENTLY on the runner's thread pool (each call on its own nodes_t
 * buffers), so they must stay free of mutable global state.  The only
 * statics are immutable lookup tables initialised before threads exist
 * (tests/test_meta.py::test_runner_thread_reentrancy exercises this).
 *
 * Build: gcc -O2 -fPIC -shared refcore.c -o librefcore.so -lm
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>
#include <math.h>

#if defined(__AVX512BW__) && defined(__AVX512VL__)
#include <immintrin.h>
#define RC_DP_AVX512 1
#endif

/* ---- constants (reference: src/Prodigal/node.h:30-38, dprog.h) ---------- */
#define MIN_GENE_DEF 90
#define MIN_EDGE_GENE_DEF 60
#define MAX_SAM_OVLP 60
#define OPER_DIST 60
#define EDGE_BONUS 0.74
#define EDGE_UPS (-1.00)
#define META_PEN 7.5
#define MAX_OPP_OVLP 200
#define MAX_NODE_DIST 500
#define GC_WINDOW 120

/* nucleotide digits (reference: _sequence.h:8-17) */
#define DA 0
#define DG 1
#define DC 2
#define DT 3
#define DN 6

/* node types */
#define TATG 0
#define TGTG 1
#define TTTG 2
#define TSTOP 3

static const uint8_t COMPL[7] = { DT, DC, DG, DA, DN, DN, DN };

/* ---- SoA node container -------------------------------------------------- */
typedef struct {
    int32_t  *ndx;
    int32_t  *stop_val;
    int8_t   *type;
    int8_t   *strand;       /* +1 / -1 */
    uint8_t  *edge;
    uint8_t  *elim;
    uint8_t  *gc_bias;
    int8_t   *ov_mark;
    uint8_t  *rbs0;
    uint8_t  *rbs1;
    uint16_t *mot_ndx;
    uint8_t  *mot_len;
    uint8_t  *mot_spacer;
    uint8_t  *mot_spacendx;
    double   *mot_score;
    double   *gc_score;     /* [nn][3] */
    float    *gc_cont;      /* float, as in the reference node struct */
    double   *cscore;
    double   *uscore;
    double   *tscore;
    double   *rscore;
    double   *sscore;
    double   *score;
    int32_t  *star_ptr;     /* [nn][3] */
    int32_t  *traceb;
    int32_t  *tracef;
    int32_t   nn;
    int32_t   capacity;
} nodes_t;

/* training model, binary-compatible with the Prodigal `-t` file on x86-64
 * (reference: prodigal/training.pxd:1-15; total size 558392 bytes) */
typedef struct {
    double gc;
    int    trans_table;
    double st_wt;
    double bias[3];
    double type_wt[3];
    int    uses_sd;
    double rbs_wt[28];
    double ups_comp[32][4];
    double mot_wt[4][4][4096];
    double no_mot;
    double gene_dc[4096];
} training_t;

/* ---- digit-space sequence predicates (reference: _sequence.h) ----------- */

static inline int is_a(const uint8_t *d, int slen, int i, int strand) {
    return (strand == 1) ? d[i] == DA : d[slen - 1 - i] == DT;
}
static inline int is_g(const uint8_t *d, int slen, int i, int strand) {
    return (strand == 1) ? d[i] == DG : d[slen - 1 - i] == DC;
}
static inline int is_t(const uint8_t *d, int slen, int i, int strand) {
    return (strand == 1) ? d[i] == DT : d[slen - 1 - i] == DA;
}
static inline int is_gc(const uint8_t *d, int slen, int i, int strand) {
    /* unknown bases count as GC, as in the reference (_sequence.h:35-43) */
    uint8_t n = (strand == 1) ? d[i] : d[slen - 1 - i];
    return (n != DA) && (n != DT);
}

static inline void codon(const uint8_t *d, int slen, int i, int strand,
                         uint8_t *x0, uint8_t *x1, uint8_t *x2) {
    if (strand == 1) { *x0 = d[i]; *x1 = d[i+1]; *x2 = d[i+2]; }
    else {
        *x0 = d[slen-1-i] ^ 3; *x1 = d[slen-2-i] ^ 3; *x2 = d[slen-3-i] ^ 3;
    }
}

/* stop-codon flags per translation table (reference: _sequence.h:117-157) */
static const uint8_t TAA_STOP[34] = {0,1,1,1,1,1,0,0,0,1,1,1,1,1,0,1,1,0,0,0,0,1,1,1,1,1,1,0,0,0,0,0,1,0};
static const uint8_t TAG_STOP[34] = {0,1,1,1,1,1,0,0,0,1,1,1,1,1,1,0,0,0,0,0,0,1,0,1,1,1,1,0,0,0,0,0,0,1};
static const uint8_t TGA_STOP[34] = {0,1,0,0,0,0,1,0,0,0,0,1,1,0,0,1,1,0,0,0,0,0,1,1,0,0,1,0,0,1,1,0,1,0};

static inline int is_stop(const uint8_t *d, int slen, int i, int tt, int strand) {
    uint8_t x0, x1, x2;
    codon(d, slen, i, strand, &x0, &x1, &x2);
    if (x0 == DT && x1 == DA && x2 == DG) return TAG_STOP[tt];
    if (x0 == DT && x1 == DG && x2 == DA) return TGA_STOP[tt];
    if (x0 == DT && x1 == DA && x2 == DA) return TAA_STOP[tt];
    if (tt == 2)  return (x0 == DA) && (x1 == DG) && ((x2 == DA) || (x2 == DG));
    if (tt == 22) return (x0 == DT) && (x1 == DC) && (x2 == DA);
    if (tt == 23) return (x0 == DT) && (x1 == DT) && (x2 == DA);
    return 0;
}

static inline int is_start(const uint8_t *d, int slen, int i, int tt, int strand) {
    uint8_t x0, x1, x2;
    codon(d, slen, i, strand, &x0, &x1, &x2);
    if ((x0 == DA) && (x1 == DT) && (x2 == DG)) return 1;
    if ((tt == 6) || (tt == 10) || (tt == 14) || (tt == 15) || (tt == 16) || (tt == 2))
        return 0;
    if ((x0 == DG) && (x1 == DT) && (x2 == DG))
        return !((tt == 1) || (tt == 3) || (tt == 12) || (tt == 2));
    if ((x0 == DT) && (x1 == DT) && (x2 == DG))
        return !((tt < 4) || (tt == 9) || ((tt >= 21) && (tt < 25)));
    return 0;
}

/* k-mer index, 2 bits per base, first base in the low bits
 * (reference: _sequence.h:207-220) */
static inline int mer_ndx(const uint8_t *d, int slen, int i, int len, int strand) {
    int j, ndx = 0;
    if (strand == 1) {
        for (j = 0; j < len; j++) ndx |= (d[i + j] & 3) << (2 * j);
    } else {
        for (j = 0; j < len; j++) ndx |= (COMPL[d[slen - 1 - i - j]] & 3) << (2 * j);
    }
    return ndx;
}

/* argmax of three ints; ties resolve exactly like the vendored max_fr
 * (reference: prodigal/sequence.pxd:48; Prodigal sequence.c) */
static inline int max_frame(int n1, int n2, int n3) {
    if (n1 > n2) { return (n1 > n3) ? 0 : 2; }
    else         { return (n2 > n3) ? 1 : 2; }
}

/* ---- max GC frame plot (reference: lib.pyx:724-768) --------------------- */
/* gp[i] in {0,1,2}: frame (position class mod 3) of maximal GC density in a
 * 120 bp window around i; constant over each codon triple. */
void rc_max_gc_frame_plot(const uint8_t *d, int slen, int8_t *gp) {
    int i, j, win;
    int *fwd = (int *)calloc((size_t)slen, sizeof(int));
    int *bwd = (int *)calloc((size_t)slen, sizeof(int));
    int *tot = (int *)calloc((size_t)slen, sizeof(int));
    if (!fwd || !bwd || !tot) { free(fwd); free(bwd); free(tot); return; }

    for (i = 0; i < (slen < 3 ? slen : 3); i++) {
        fwd[i] = is_gc(d, slen, i, 1);
        bwd[slen - i - 1] = is_gc(d, slen, i, -1);
    }
    for (i = 3; i < slen; i++) {
        fwd[i] = fwd[i - 3] + is_gc(d, slen, i, 1);
        bwd[slen - i - 1] = bwd[slen - i + 2] + is_gc(d, slen, i, -1);
    }
    for (i = 0; i < slen; i++) {
        tot[i] = fwd[i] + bwd[i] - is_gc(d, slen, i, 1);
        if (i >= GC_WINDOW / 2) tot[i] -= fwd[i - GC_WINDOW / 2];
        if (i + GC_WINDOW / 2 < slen) tot[i] -= bwd[i + GC_WINDOW / 2];
    }
    free(fwd); free(bwd);
    memset(gp, -1, (size_t)slen);
    for (i = 0; i + 2 < slen; i += 3) {
        win = max_frame(tot[i], tot[i + 1], tot[i + 2]);
        for (j = i; j < i + 3; j++) gp[j] = (int8_t)win;
    }
    free(tot);
}

/* ---- node extraction (reference: lib.pyx:1905-2117) --------------------- */

static inline int add_node(nodes_t *nd, int ndx, int type, int strand,
                           int stop_val, int edge) {
    int k = nd->nn;
    if (k >= nd->capacity) return -1;
    nd->ndx[k] = ndx;
    nd->type[k] = (int8_t)type;
    nd->strand[k] = (int8_t)strand;
    nd->stop_val[k] = stop_val;
    nd->edge[k] = (uint8_t)edge;
    nd->nn = k + 1;
    return k;
}

static inline int mask_intersects(const int32_t *mb, const int32_t *me, int mi,
                                  int begin, int end) {
    /* begin-inclusive / end-exclusive (reference: lib.pyx:336-341) */
    if (mi < 0) return 0;
    return mb[mi] < end && begin < me[mi];
}

/* Extract start/stop nodes in all six frames.  Returns the number of nodes,
 * or -1 if `capacity` was insufficient (the caller grows and retries). */
int rc_extract_nodes(const uint8_t *d, int slen, int tt, int closed,
                     int min_gene, int min_edge_gene,
                     const int32_t *mask_begin, const int32_t *mask_end, int nm,
                     nodes_t *nd) {
    int i, f;
    int last[3], min_dist[3], saw_start[3], mstack[3];
    int slmod = slen % 3;

    nd->nn = 0;
    if (slen < 3) return 0;

    /* --- forward strand: walk right-to-left, masks walked backwards ------ */
    for (f = 0; f < 3; f++) mstack[f] = nm - 1;
    for (i = 0; i < 3; i++) {
        last[(i + slmod) % 3] = slen + i;
        saw_start[i % 3] = 0;
        min_dist[i % 3] = min_edge_gene;
        if (!closed)
            while (last[(i + slmod) % 3] + 3 > slen) last[(i + slmod) % 3] -= 3;
    }
    for (i = slen - 3; i >= 0; i--) {
        f = i % 3;
        if (is_stop(d, slen, i, tt, 1)) {
            if (saw_start[f]) {
                if (add_node(nd, last[f], TSTOP, 1, i,
                             !is_stop(d, slen, last[f], tt, 1)) < 0) return -1;
            }
            min_dist[f] = min_gene;
            last[f] = i;
            saw_start[f] = 0;
            continue;
        }
        if (last[f] >= slen) continue;
        /* advance (backwards) to the mask whose span could cover the ORF */
        while (mstack[f] >= 0 && last[f] < mask_begin[mstack[f]]) mstack[f]--;
        if (mask_intersects(mask_begin, mask_end, mstack[f], i, last[f]))
            continue;
        if (last[f] - i + 3 >= min_dist[f] && is_start(d, slen, i, tt, 1)) {
            int ty = is_a(d, slen, i, 1) ? TATG
                   : is_t(d, slen, i, 1) ? TTTG : TGTG;
            saw_start[f] = 1;
            if (add_node(nd, i, ty, 1, last[f], 0) < 0) return -1;
        } else if (i <= 2 && !closed && last[f] - i > min_edge_gene) {
            saw_start[f] = 1;
            if (add_node(nd, i, TATG, 1, last[f], 1) < 0) return -1;
        }
    }
    for (i = 0; i < 3; i++) {
        if (saw_start[i % 3]) {
            if (add_node(nd, last[i % 3], TSTOP, 1, i - 6,
                         !is_stop(d, slen, last[i % 3], tt, 1)) < 0) return -1;
        }
    }

    /* --- reverse strand: indices are in reverse-complement coordinates --- */
    for (f = 0; f < 3; f++) mstack[f] = (nm > 0) ? 0 : -1;
    for (i = 0; i < 3; i++) {
        last[(i + slmod) % 3] = slen + i;
        saw_start[i % 3] = 0;
        min_dist[i % 3] = min_edge_gene;
        if (!closed)
            while (last[(i + slmod) % 3] + 3 > slen) last[(i + slmod) % 3] -= 3;
    }
    for (i = slen - 3; i >= 0; i--) {
        f = i % 3;
        if (is_stop(d, slen, i, tt, -1)) {
            if (saw_start[f]) {
                if (add_node(nd, slen - last[f] - 1, TSTOP, -1, slen - i - 1,
                             !is_stop(d, slen, last[f], tt, -1)) < 0) return -1;
            }
            min_dist[f] = min_gene;
            last[f] = i;
            saw_start[f] = 0;
            continue;
        }
        if (last[f] >= slen) continue;
        /* masks walked forward in forward-strand coordinates */
        while (mstack[f] >= 0 && mstack[f] < nm &&
               slen - last[f] - 1 > mask_end[mstack[f]])
            mstack[f] = (mstack[f] + 1 < nm) ? mstack[f] + 1 : -1;
        if (mstack[f] >= 0 &&
            mask_intersects(mask_begin, mask_end, mstack[f],
                            slen - last[f] - 1, slen - i - 1))
            continue;
        if (last[f] - i + 3 >= min_dist[f] && is_start(d, slen, i, tt, -1)) {
            int ty = is_a(d, slen, i, -1) ? TATG
                   : is_g(d, slen, i, -1) ? TGTG : TTTG;
            saw_start[f] = 1;
            if (add_node(nd, slen - i - 1, ty, -1, slen - last[f] - 1, 0) < 0)
                return -1;
        } else if (i <= 2 && !closed && last[f] - i > min_edge_gene) {
            saw_start[f] = 1;
            if (add_node(nd, slen - i - 1, TATG, -1, slen - last[f] - 1, 1) < 0)
                return -1;
        }
    }
    for (i = 0; i < 3; i++) {
        if (saw_start[i % 3]) {
            if (add_node(nd, slen - last[i % 3] - 1, TSTOP, -1, slen - i + 5,
                         !is_stop(d, slen, last[i % 3], tt, -1)) < 0) return -1;
        }
    }
    return nd->nn;
}

/* ---- node score reset (reference: Prodigal node.c reset_node_scores) ---- */
void rc_reset_node_scores(nodes_t *nd) {
    int i, j;
    for (i = 0; i < nd->nn; i++) {
        for (j = 0; j < 3; j++) {
            nd->star_ptr[i * 3 + j] = 0;
            nd->gc_score[i * 3 + j] = 0.0;
        }
        nd->rbs0[i] = nd->rbs1[i] = 0;
        nd->score[i] = nd->cscore[i] = nd->sscore[i] = 0.0;
        nd->rscore[i] = nd->tscore[i] = nd->uscore[i] = 0.0;
        nd->mot_ndx[i] = 0; nd->mot_len[i] = 0;
        nd->mot_spacer[i] = 0; nd->mot_spacendx[i] = 0;
        nd->mot_score[i] = 0.0;
        nd->traceb[i] = -1; nd->tracef[i] = -1;
        nd->ov_mark[i] = -1;
        nd->elim[i] = 0;
        nd->gc_bias[i] = 0;
        nd->gc_cont[i] = 0.0f;
    }
}

/* ---- per-node ORF GC content (reference: lib.pyx:1846-1896) ------------- */
void rc_calc_orf_gc(const uint8_t *d, int slen, nodes_t *nd) {
    int i, j, k, phase;
    int last[3];
    double gc[3], gsize;

    gc[0] = gc[1] = gc[2] = 0.0;
    for (i = nd->nn - 1; i >= 0; i--) {
        if (nd->strand[i] != 1) continue;
        phase = nd->ndx[i] % 3;
        if (nd->type[i] == TSTOP) {
            last[phase] = j = nd->ndx[i];
            gc[phase] = 0.0;
            for (k = j; k < j + 3; k++)
                if (k >= 0 && k < slen) gc[phase] += is_gc(d, slen, k, 1);
        } else {
            for (j = last[phase] - 3; j >= nd->ndx[i]; j -= 3)
                for (k = j; k < j + 3; k++)
                    if (k >= 0 && k < slen) gc[phase] += is_gc(d, slen, k, 1);
            gsize = fabs((double)(nd->stop_val[i] - nd->ndx[i])) + 3.0;
            nd->gc_cont[i] = (float)(gc[phase] / gsize);
            last[phase] = nd->ndx[i];
        }
    }
    gc[0] = gc[1] = gc[2] = 0.0;
    for (i = 0; i < nd->nn; i++) {
        if (nd->strand[i] != -1) continue;
        phase = nd->ndx[i] % 3;
        if (nd->type[i] == TSTOP) {
            last[phase] = j = nd->ndx[i];
            gc[phase] = 0.0;
            for (k = j; k > j - 3; k--)
                if (k >= 0 && k < slen) gc[phase] += is_gc(d, slen, k, 1);
        } else {
            for (j = last[phase] + 3; j <= nd->ndx[i]; j += 3)
                for (k = j; k < j + 3; k++)
                    if (k >= 0 && k < slen) gc[phase] += is_gc(d, slen, k, 1);
            gsize = fabs((double)(nd->stop_val[i] - nd->ndx[i])) + 3.0;
            nd->gc_cont[i] = (float)(gc[phase] / gsize);
            last[phase] = nd->ndx[i];
        }
    }
}

/* ---- hexamer coding score (reference: lib.pyx:2119-2239) ---------------- */
void rc_raw_coding_score(const uint8_t *d, int slen, nodes_t *nd,
                         const training_t *tinf) {
    double score[3], lfac, lfac_min, lfac_max, no_stop, gsize, tmp;
    int64_t last[3];
    int phase;
    int64_t i, j;
    int64_t nn = nd->nn;

    if (tinf->trans_table != 11) {
        no_stop  = ((1 - tinf->gc) * (1 - tinf->gc) * tinf->gc) / 8.0;
        no_stop += ((1 - tinf->gc) * (1 - tinf->gc) * (1 - tinf->gc)) / 8.0;
        no_stop  = 1 - no_stop;
    } else {
        no_stop  = ((1 - tinf->gc) * (1 - tinf->gc) * tinf->gc) / 4.0;
        no_stop += ((1 - tinf->gc) * (1 - tinf->gc) * (1 - tinf->gc)) / 8.0;
        no_stop  = 1 - no_stop;
    }
    lfac_max = log((1 - pow(no_stop, 1000.0)) / pow(no_stop, 1000.0));
    lfac_min = log((1 - pow(no_stop, 80.0)) / pow(no_stop, 80.0));

    /* pass 1: cumulative hexamer log-likelihood start->stop */
    score[0] = score[1] = score[2] = 0.0;
    for (i = nn - 1; i >= 0; i--) {
        if (nd->strand[i] != 1) continue;
        phase = nd->ndx[i] % 3;
        if (nd->type[i] == TSTOP) {
            last[phase] = nd->ndx[i];
            score[phase] = 0.0;
        } else {
            for (j = last[phase] - 3; j >= nd->ndx[i]; j -= 3)
                score[phase] += tinf->gene_dc[mer_ndx(d, slen, (int)j, 6, 1)];
            nd->cscore[i] = score[phase];
            last[phase] = nd->ndx[i];
        }
    }
    score[0] = score[1] = score[2] = 0.0;
    for (i = 0; i < nn; i++) {
        if (nd->strand[i] != -1) continue;
        phase = nd->ndx[i] % 3;
        if (nd->type[i] == TSTOP) {
            last[phase] = nd->ndx[i];
            score[phase] = 0.0;
        } else {
            for (j = last[phase] + 3; j <= nd->ndx[i]; j += 3)
                score[phase] += tinf->gene_dc[mer_ndx(d, slen, slen - 1 - (int)j, 6, -1)];
            nd->cscore[i] = score[phase];
            last[phase] = nd->ndx[i];
        }
    }

    /* pass 2: penalise starts with ascending coding to their left */
    score[0] = score[1] = score[2] = -10000.0;
    for (i = 0; i < nn; i++) {
        if (nd->strand[i] != 1) continue;
        phase = nd->ndx[i] % 3;
        if (nd->type[i] == TSTOP) score[phase] = -10000.0;
        else if (nd->cscore[i] > score[phase]) score[phase] = nd->cscore[i];
        else nd->cscore[i] -= score[phase] - nd->cscore[i];
    }
    score[0] = score[1] = score[2] = -10000.0;
    for (i = nn - 1; i >= 0; i--) {
        if (nd->strand[i] != -1) continue;
        phase = nd->ndx[i] % 3;
        if (nd->type[i] == TSTOP) score[phase] = -10000.0;
        else if (nd->cscore[i] > score[phase]) score[phase] = nd->cscore[i];
        else nd->cscore[i] -= (score[phase] - nd->cscore[i]);
    }

    /* pass 3: length factor */
    for (i = 0; i < nn; i++) {
        if (nd->strand[i] != 1) continue;
        phase = nd->ndx[i] % 3;
        if (nd->type[i] == TSTOP) score[phase] = -10000.0;
        else {
            gsize = (((double)nd->stop_val[i] - nd->ndx[i]) + 3.0) / 3.0;
            if (gsize > 1000.0) {
                lfac = (lfac_max - lfac_min) * (gsize - 80) / 920.0;
            } else {
                tmp = pow(no_stop, gsize);
                lfac = log((1 - tmp) / tmp) - lfac_min;
            }
            if (lfac > score[phase]) score[phase] = lfac;
            else lfac -= fmax(fmin(score[phase] - lfac, lfac), 0);
            if (lfac > 3.0 && nd->cscore[i] < 0.5 * lfac) nd->cscore[i] = 0.5 * lfac;
            nd->cscore[i] += lfac;
        }
    }
    for (i = nn - 1; i >= 0; i--) {
        if (nd->strand[i] != -1) continue;
        phase = nd->ndx[i] % 3;
        if (nd->type[i] == TSTOP) score[phase] = -10000.0;
        else {
            gsize = (((double)nd->ndx[i] - nd->stop_val[i]) + 3.0) / 3.0;
            if (gsize > 1000.0) {
                lfac = (lfac_max - lfac_min) * (gsize - 80) / 920.0;
            } else {
                tmp = pow(no_stop, gsize);
                lfac = log((1 - tmp) / tmp) - lfac_min;
            }
            if (lfac > score[phase]) score[phase] = lfac;
            else lfac -= fmax(fmin(score[phase] - lfac, lfac), 0);
            if (lfac > 3.0 && nd->cscore[i] < 0.5 * lfac) nd->cscore[i] = 0.5 * lfac;
            nd->cscore[i] += lfac;
        }
    }
}

/* ---- Shine-Dalgarno scorers (reference: lib.pyx:791-979) ---------------- */

int rc_shine_dalgarno_exact(const uint8_t *d, int slen, int pos, int start,
                            const double *rbs_wt, int strand) {
    int i, j, k, rdis, limit, max_val, cur_val = 0, cur_ctr, dis_flag;
    int match[6] = { -10, -10, -10, -10, -10, -10 };

    limit = start - 4 - pos;
    if (limit > 6) limit = 6;

    for (i = 0; i < limit; i++) {
        if (pos + i >= 0 && pos + i < slen) {
            if (i % 3 == 0) { if (is_a(d, slen, pos + i, strand)) match[i] = 2; }
            else            { if (is_g(d, slen, pos + i, strand)) match[i] = 3; }
        }
    }

    max_val = 0;
    for (i = limit; i >= 3; i--) {
        for (j = 0; j <= limit - i; j++) {
            cur_ctr = -2;
            for (k = j; k < j + i; k++) cur_ctr += match[k];
            if (cur_ctr < 6) continue;
            rdis = start - (pos + j + i);
            if      (rdis < 5)  dis_flag = (i < 5) ? 2 : 1;
            else if (rdis < 11) dis_flag = 0;
            else if (rdis < 13) dis_flag = (i < 5) ? 1 : 2;
            else if (rdis < 16) dis_flag = 3;
            else continue;
            switch (cur_ctr) {
                case 6:  cur_val = (int[]){13, 6, 1, 2}[dis_flag]; break;
                case 8:  cur_val = (int[]){15, 12, 11, 3}[dis_flag]; break;
                case 9:  cur_val = (int[]){16, 12, 11, 3}[dis_flag]; break;
                case 11: cur_val = (int[]){22, 21, 20, 10}[dis_flag]; break;
                case 12: cur_val = (int[]){24, 23, 20, 10}[dis_flag]; break;
                case 14: cur_val = (int[]){27, 26, 25, 10}[dis_flag]; break;
                default: cur_val = 0; break;
            }
            if (rbs_wt[cur_val] < rbs_wt[max_val]) continue;
            if (rbs_wt[cur_val] == rbs_wt[max_val] && cur_val < max_val) continue;
            max_val = cur_val;
        }
    }
    return max_val;
}

int rc_shine_dalgarno_mm(const uint8_t *d, int slen, int pos, int start,
                         const double *rbs_wt, int strand) {
    int i, j, k, mism, rdis, limit, max_val, cur_val = 0, cur_ctr, dis_flag;
    int match[6];

    limit = start - 4 - pos;
    if (limit > 6) limit = 6;

    for (i = 0; i < 6; i++) match[i] = -10;
    for (i = 0; i < limit; i++) {
        if (pos + i >= 0 && pos + i < slen) {
            if (i % 3 == 0) match[i] = is_a(d, slen, pos + i, strand) ? 2 : -3;
            else            match[i] = is_g(d, slen, pos + i, strand) ? 3 : -2;
        } else {
            match[i] = (i % 3 == 0) ? -3 : -2;
        }
    }

    max_val = 0;
    for (i = limit; i >= 5; i--) {
        for (j = 0; j <= limit - i; j++) {
            cur_ctr = -2;
            mism = 0;
            for (k = j; k < j + i; k++) {
                cur_ctr += match[k];
                if (match[k] < 0) {
                    mism += 1;
                    if (k <= j + 1 || k >= j + i - 2) cur_ctr -= 10;
                }
            }
            if (mism != 1 || cur_ctr < 6) continue;
            rdis = start - (pos + j + i);
            if      (rdis < 5)  dis_flag = 1;
            else if (rdis < 11) dis_flag = 0;
            else if (rdis < 13) dis_flag = 2;
            else if (rdis < 16) dis_flag = 3;
            else continue;
            switch (cur_ctr) {
                case 6: cur_val = (int[]){9, 5, 4, 2}[dis_flag]; break;
                case 7: cur_val = (int[]){14, 8, 7, 2}[dis_flag]; break;
                case 9: cur_val = (int[]){19, 18, 17, 3}[dis_flag]; break;
                default: continue;
            }
            if (rbs_wt[cur_val] < rbs_wt[max_val]) continue;
            if (rbs_wt[cur_val] == rbs_wt[max_val] && cur_val < max_val) continue;
            max_val = cur_val;
        }
    }
    return max_val;
}

/* ---- RBS scan over [start-20, start-5) (reference: lib.pyx:2241-2277) ---
 *
 * LUT formulation: the shine-dalgarno matchers depend only on A/G
 * membership of the 6 bases at the scan position and on the distance
 * start-pos in [6, 20], so both are tabulated once at library load as
 * (15, 4096) candidate-bit masks over the window's 6-mer code (2 bits per
 * base).  Any base that is neither A nor G — C, T, N, or a position
 * outside the sequence — behaves identically inside the matchers (exact:
 * match stays -10; mm: counted as a mismatch base), so all of them fold
 * to the C code.  Per node the scan is 15 rolling-code LUT ORs and one
 * weight-argmax per position; the per-position selection rule (higher
 * weight, ties to the higher index, baseline index 0) is
 * order-independent, so it equals the scanners' running maximum, and the
 * cross-position reduction is the reference's max over returned INDICES
 * (lib.pyx:2262-2274). */
static int32_t SD_EX_LUT[15][4096];
static int32_t SD_MM_LUT[15][4096];

static int32_t sd_exact_cand_mask(const uint8_t *d, int slen, int pos,
                                  int start, int strand);
static int32_t sd_mm_cand_mask(const uint8_t *d, int slen, int pos,
                               int start, int strand);

__attribute__((constructor))
static void sd_luts_init(void) {
    uint8_t buf[6];
    int sp, code, j;
    for (sp = 6; sp <= 20; sp++) {
        for (code = 0; code < 4096; code++) {
            for (j = 0; j < 6; j++) buf[j] = (uint8_t)((code >> (2 * j)) & 3);
            SD_EX_LUT[sp - 6][code] = sd_exact_cand_mask(buf, 6, 0, sp, 1);
            SD_MM_LUT[sp - 6][code] = sd_mm_cand_mask(buf, 6, 0, sp, 1);
        }
    }
}

/* argmax over the candidate set encoded in `mask` (plus the index-0
 * baseline) by (rbs weight, then larger index) — the fixed point of the
 * reference's running-max update rule. */
static inline int sd_pick(int32_t mask, const double *wt) {
    int best = 0, v;
    double bw = wt[0];
    while (mask) {
        v = __builtin_ctz((unsigned)mask);
        mask &= mask - 1;
        if (wt[v] > bw || (wt[v] == bw && v > best)) { bw = wt[v]; best = v; }
    }
    return best;
}

void rc_rbs_score(const uint8_t *d, int slen, nodes_t *nd, const training_t *tinf) {
    int i, p, q;
    uint32_t code, b;
    for (i = 0; i < nd->nn; i++) {
        if (nd->type[i] == TSTOP || nd->edge[i]) continue;
        int r0 = 0, r1 = 0, s0, s1;
        if (nd->strand[i] == 1) {
            const int j0 = nd->ndx[i] - 20;
            code = 0;
            for (p = 0; p < 6; p++) {
                q = j0 + p;
                b = (q < 0 || q >= slen) ? 2u : (d[q] < 4 ? d[q] : 2u);
                code |= b << (2 * p);
            }
            for (p = 0; p < 15; p++) {           /* j = j0 + p, sp = 20 - p */
                if (j0 + p >= 0) {
                    s0 = sd_pick(SD_EX_LUT[14 - p][code], tinf->rbs_wt);
                    s1 = sd_pick(SD_MM_LUT[14 - p][code], tinf->rbs_wt);
                    if (s0 > r0) r0 = s0;
                    if (s1 > r1) r1 = s1;
                }
                q = j0 + p + 6;
                b = (q < 0 || q >= slen) ? 2u : (d[q] < 4 ? d[q] : 2u);
                code = (code >> 2) | (b << 10);
            }
        } else {
            /* logical position j reads physical slen-1-j-k complemented */
            const int j0 = slen - nd->ndx[i] - 21;
            code = 0;
            for (p = 0; p < 6; p++) {
                q = j0 + p;
                b = (q < 0 || q >= slen) ? 2u : COMPL[d[slen - 1 - q]];
                if (b > 3) b = 2u;
                code |= b << (2 * p);
            }
            for (p = 0; p < 15; p++) {
                if (j0 + p < slen) {
                    s0 = sd_pick(SD_EX_LUT[14 - p][code], tinf->rbs_wt);
                    s1 = sd_pick(SD_MM_LUT[14 - p][code], tinf->rbs_wt);
                    if (s0 > r0) r0 = s0;
                    if (s1 > r1) r1 = s1;
                }
                q = j0 + p + 6;
                b = (q < 0 || q >= slen) ? 2u : COMPL[d[slen - 1 - q]];
                if (b > 3) b = 2u;
                code = (code >> 2) | (b << 10);
            }
        }
        nd->rbs0[i] = (uint8_t)r0;
        nd->rbs1[i] = (uint8_t)r1;
    }
}

/* ---- upstream motif search, non-SD mode (reference: lib.pyx:1556-1616) -- */
static void find_best_upstream_motif(nodes_t *nd, int n, const uint8_t *d,
                                     int slen, const training_t *tinf, int stage) {
    int i, j, start, spacendx, index;
    int max_spacer = 0, max_spacendx = 0, max_len = 0, max_ndx = 0;
    double max_sc = -100.0, score;

    if (nd->type[n] == TSTOP || nd->edge[n]) return;
    start = (nd->strand[n] == 1) ? nd->ndx[n] : slen - 1 - nd->ndx[n];

    for (i = 3; i >= 0; i--) {
        for (j = start - 18 - i; j < start - 5 - i; j++) {
            if (j < 0) continue;
            if      (j <= start - 16 - i) spacendx = 3;
            else if (j <= start - 14 - i) spacendx = 2;
            else if (j >= start - 7 - i)  spacendx = 1;
            else                          spacendx = 0;
            index = mer_ndx(d, slen, j, i + 3, nd->strand[n]);
            score = tinf->mot_wt[i][spacendx][index];
            if (score > max_sc) {
                max_sc = score;
                max_spacendx = spacendx;
                max_spacer = start - j - i - 3;
                max_ndx = index;
                max_len = i + 3;
            }
        }
    }

    if (stage == 2 && (max_sc == -4.0 || max_sc < tinf->no_mot + 0.69)) {
        nd->mot_ndx[n] = 0; nd->mot_len[n] = 0;
        nd->mot_spacendx[n] = 0; nd->mot_spacer[n] = 0;
        nd->mot_score[n] = tinf->no_mot;
    } else {
        nd->mot_ndx[n] = (uint16_t)max_ndx; nd->mot_len[n] = (uint8_t)max_len;
        nd->mot_spacendx[n] = (uint8_t)max_spacendx;
        nd->mot_spacer[n] = (uint8_t)max_spacer;
        nd->mot_score[n] = max_sc;
    }
}

/* ---- upstream composition score (reference: lib.pyx:1618-1650) ---------- */
static void score_upstream_composition(nodes_t *nd, int n, const uint8_t *d,
                                       int slen, const training_t *tinf) {
    int i, start, mer, strand, count = 0;
    double uscore = 0.0;

    if (nd->strand[n] == 1) { start = nd->ndx[n]; strand = 1; }
    else { start = slen - 1 - nd->ndx[n]; strand = -1; }

    for (i = 1; i < 3; i++) {
        if (i > start) break;
        mer = mer_ndx(d, slen, start - i, 1, strand);
        uscore += 0.4 * tinf->st_wt * tinf->ups_comp[count][mer];
        count++;
    }
    for (i = 15; i < 45; i++) {
        if (i > start) break;
        mer = mer_ndx(d, slen, start - i, 1, strand);
        uscore += 0.4 * tinf->st_wt * tinf->ups_comp[count][mer];
        count++;
    }
    nd->uscore[n] = uscore;
}

/* ---- start-node scoring (reference: lib.pyx:2331-2487) ------------------ */
/* Includes the hyattpd/Prodigal#88 upstream patch carried by the reference. */
void rc_score_nodes(const uint8_t *d, int slen, nodes_t *nd,
                    const training_t *tinf, int closed, int is_meta) {
    int64_t i, j;
    int64_t nn = nd->nn;
    int64_t orf_length;
    double negf, posf, rbs1, rbs2, sd_score, edge_gene, min_meta_len;

    rc_calc_orf_gc(d, slen, nd);
    rc_raw_coding_score(d, slen, nd, tinf);

    if (tinf->uses_sd) {
        rc_rbs_score(d, slen, nd, tinf);
    } else {
        for (i = 0; i < nn; i++) {
            if (nd->type[i] == TSTOP || nd->edge[i]) continue;
            find_best_upstream_motif(nd, (int)i, d, slen, tinf, 2);
        }
    }

    for (i = 0; i < nn; i++) {
        if (nd->type[i] == TSTOP) continue;

        if (nd->ndx[i] > nd->stop_val[i])
            orf_length = nd->ndx[i] - nd->stop_val[i];
        else
            orf_length = nd->stop_val[i] - nd->ndx[i];

        edge_gene = 0;
        if (nd->edge[i]) edge_gene += 1;
        if ((nd->strand[i] == 1 && !is_stop(d, slen, nd->stop_val[i], tinf->trans_table, 1))
            || (nd->strand[i] == -1 && !is_stop(d, slen, slen - 1 - nd->stop_val[i], tinf->trans_table, -1)))
            edge_gene += 1;

        if (nd->edge[i]) {
            nd->tscore[i] = EDGE_BONUS * tinf->st_wt / edge_gene;
            nd->uscore[i] = 0.0;
            nd->rscore[i] = 0.0;
        } else {
            nd->tscore[i] = tinf->type_wt[(int)nd->type[i]] * tinf->st_wt;

            rbs1 = tinf->rbs_wt[nd->rbs0[i]];
            rbs2 = tinf->rbs_wt[nd->rbs1[i]];
            sd_score = fmax(rbs1, rbs2) * tinf->st_wt;
            if (tinf->uses_sd) {
                nd->rscore[i] = sd_score;
            } else {
                nd->rscore[i] = tinf->st_wt * nd->mot_score[i];
                if (nd->rscore[i] < sd_score && tinf->no_mot > -0.5)
                    nd->rscore[i] = sd_score;
            }

            score_upstream_composition(nd, (int)i, d, slen, tinf);

            if (!closed && nd->ndx[i] <= 2 && nd->strand[i] == 1) {
                nd->uscore[i] += EDGE_UPS * tinf->st_wt;
            } else if (!closed && nd->ndx[i] >= slen - 3 && nd->strand[i] == -1) {
                nd->uscore[i] += EDGE_UPS * tinf->st_wt;
            } else if (i < 500 && nd->strand[i] == 1) {
                for (j = i - 1; j >= 0; j--) {
                    if (nd->edge[j] && nd->stop_val[i] == nd->stop_val[j]) {
                        nd->uscore[i] += EDGE_UPS * tinf->st_wt;
                        break;
                    }
                }
            } else if (i + 500 >= nn && nd->strand[i] == -1) {
                for (j = i + 1; j < nn; j++) {
                    if (nd->edge[j] && nd->stop_val[i] == nd->stop_val[j]) {
                        nd->uscore[i] += EDGE_UPS * tinf->st_wt;
                        break;
                    }
                }
            }
        }

        if (!closed && !nd->edge[i]
            && ((nd->ndx[i] <= 2 && nd->strand[i] == 1)
                || (nd->ndx[i] >= slen - 3 && nd->strand[i] == -1))) {
            edge_gene += 1;
            nd->edge[i] = 1;
            nd->tscore[i] = 0.0;
            nd->uscore[i] = EDGE_BONUS * tinf->st_wt / edge_gene;
            nd->rscore[i] = 0.0;
        }

        if (!nd->edge[i] && edge_gene == 1)
            nd->uscore[i] -= 0.5 * EDGE_BONUS * tinf->st_wt;

        if (edge_gene == 0 && orf_length < 250) {
            negf = 250.0 / (float)orf_length;
            posf = (float)orf_length / 250.0;
            nd->rscore[i] *= (nd->rscore[i] < 0) ? negf : posf;
            nd->uscore[i] *= (nd->uscore[i] < 0) ? negf : posf;
            nd->tscore[i] *= (nd->tscore[i] < 0) ? negf : posf;
        }

        if (is_meta && slen < 3000 && edge_gene == 0
            && (nd->cscore[i] < 5.0 || orf_length < 120)) {
            nd->cscore[i] -= META_PEN * fmax(0, (3000.0 - slen) / 2700.0);
        }

        nd->sscore[i] = nd->tscore[i] + nd->rscore[i] + nd->uscore[i];

        if (nd->cscore[i] < 0.0) {
            if (edge_gene > 0 && !nd->edge[i]) {
                if (!is_meta || slen > 1500) nd->sscore[i] -= tinf->st_wt;
                else nd->sscore[i] -= 10.31 - 0.004 * slen;
            } else if (is_meta && slen < 3000 && nd->edge[i]) {
                min_meta_len = sqrt((double)slen) * 5.0;
                if (orf_length >= min_meta_len) {
                    if (nd->cscore[i] >= 0) nd->cscore[i] = -1.0;
                    nd->sscore[i] = 0.0;
                    nd->uscore[i] = 0.0;
                }
            } else {
                nd->sscore[i] -= 0.5;
            }
        } else if (is_meta && nd->cscore[i] < 5.0 && orf_length < 120
                   && nd->sscore[i] < 0.0) {
            nd->sscore[i] -= tinf->st_wt;
        }
    }
}

/* ---- intergenic modifiers (reference: _connection.h:43-91) -------------- */

static inline double igm_diff(double start_weight) {
    return -0.15 * start_weight;
}

static inline double igm_same(const nodes_t *nd, int n1, int n2, double sw) {
    int dist = abs(nd->ndx[n1] - nd->ndx[n2]);
    int overlap = nd->ndx[n1] + 2 * nd->strand[n1] >= nd->ndx[n2];
    double rval = 0.0;

    if ((nd->ndx[n1] + 2 == nd->ndx[n2]) || (nd->ndx[n1] == nd->ndx[n2] + 1)) {
        if (nd->strand[n1] == 1) {
            if (nd->rscore[n2] < 0) rval -= nd->rscore[n2];
            if (nd->uscore[n2] < 0) rval -= nd->uscore[n2];
        } else {
            if (nd->rscore[n1] < 0) rval -= nd->rscore[n1];
            if (nd->uscore[n1] < 0) rval -= nd->uscore[n1];
        }
    }
    if (dist > 3 * OPER_DIST) {
        rval -= 0.15 * sw;
    } else if (((dist <= OPER_DIST) && !overlap) || (dist * 4 < OPER_DIST)) {
        rval += (2.0 - ((double)dist / OPER_DIST)) * 0.15 * sw;
    }
    return rval;
}

static inline double igm(const nodes_t *nd, int n1, int n2, double sw) {
    if (nd->strand[n1] == nd->strand[n2]) return igm_same(nd, n1, n2, sw);
    return igm_diff(sw);
}

/* ---- overlapping start bookkeeping (reference: lib.pyx:2279-2329) ------- */
void rc_record_overlapping_starts(nodes_t *nd, const training_t *tinf,
                                  int flag, int max_sam_overlap) {
    int i, j;
    double sc, max_sc;
    int nn = nd->nn;

    for (i = 0; i < nn; i++) {
        for (j = 0; j < 3; j++) nd->star_ptr[i * 3 + j] = -1;
        if (nd->type[i] != TSTOP || nd->edge[i] == 1) continue;
        if (nd->strand[i] == 1) {
            max_sc = -100;
            for (j = i + 3; j >= 0; j--) {
                if (j >= nn || nd->ndx[j] > nd->ndx[i] + 2) continue;
                if (nd->ndx[j] + max_sam_overlap < nd->ndx[i]) break;
                if (nd->strand[j] == 1 && nd->type[j] != TSTOP) {
                    if (nd->stop_val[j] <= nd->ndx[i]) continue;
                    if (flag == 0 && nd->star_ptr[i * 3 + nd->ndx[j] % 3] == -1) {
                        nd->star_ptr[i * 3 + nd->ndx[j] % 3] = j;
                    } else if (flag == 1) {
                        sc = nd->cscore[j] + nd->sscore[j]
                           + igm_same(nd, i, j, tinf->st_wt);
                        if (sc > max_sc) {
                            nd->star_ptr[i * 3 + nd->ndx[j] % 3] = j;
                            max_sc = sc;
                        }
                    }
                }
            }
        } else {
            max_sc = -100;
            for (j = i - 3; j < nn; j++) {
                if (j < 0 || nd->ndx[j] < nd->ndx[i] - 2) continue;
                if (nd->ndx[j] - max_sam_overlap > nd->ndx[i]) break;
                if (nd->strand[j] == -1 && nd->type[j] != TSTOP) {
                    if (nd->stop_val[j] >= nd->ndx[i]) continue;
                    if (flag == 0 && nd->star_ptr[i * 3 + nd->ndx[j] % 3] == -1) {
                        nd->star_ptr[i * 3 + nd->ndx[j] % 3] = j;
                    } else if (flag == 1) {
                        sc = nd->cscore[j] + nd->sscore[j]
                           + igm_same(nd, j, i, tinf->st_wt);
                        if (sc > max_sc) {
                            nd->star_ptr[i * 3 + nd->ndx[j] % 3] = j;
                            max_sc = sc;
                        }
                    }
                }
            }
        }
    }
}

/* ---- connection scoring (reference: _connection.h:94-408) ---------------
 * Four cases keyed on the (strand, type) of the *target* node n2; the skip
 * predicate reproduces the reference's pre-filter rules
 * (reference: impl/generic.h:13-37). */

static inline int skip_connection(const nodes_t *nd, int j, int i) {
    int t1 = nd->type[j], t2 = nd->type[i];
    int s1 = nd->strand[j], s2 = nd->strand[i];
    int f1 = nd->ndx[j] % 3, f2 = nd->ndx[i] % 3;
    return (t1 != TSTOP && t2 != TSTOP && s1 == s2)
        || (s1 == 1 && t1 != TSTOP && s2 != 1)
        || (s1 != 1 && t1 == TSTOP && s2 == 1)
        || (s1 != 1 && t1 != TSTOP && s2 == 1 && t2 == TSTOP)
        || (s1 == s2 && s1 == 1 && t1 != TSTOP && t2 == TSTOP && f1 != f2)
        || (s1 == s2 && s1 != 1 && t1 == TSTOP && t2 != TSTOP && f1 != f2);
}

static inline int edge_artifact(const nodes_t *nd, int n1) {
    if (nd->traceb[n1] != -1) return 0;
    if (nd->strand[n1] == 1 && nd->type[n1] == TSTOP) return 1;
    if (nd->strand[n1] != 1 && nd->type[n1] != TSTOP) return 1;
    return 0;
}

/* Candidate update rule.  The reference relaxes with `>=` over a single
 * ascending scan of the sources, so the final (score, traceb, ov_mark)
 * triple is the lexicographic maximum of (value, source index) over all
 * candidates plus the (0.0, -1) baseline.  Writing the rule that way makes
 * it order-independent, which lets the driver below visit source classes
 * out of order (deque queries, bounded scans) and still land on the exact
 * reference fixed point. */
static inline void relax(nodes_t *nd, int n1, int n2, double score, int maxfr) {
    double v = nd->score[n1] + score;
    if (v > nd->score[n2] || (v == nd->score[n2] && n1 > nd->traceb[n2])) {
        nd->score[n2] = v;
        nd->traceb[n2] = n1;
        nd->ov_mark[n2] = (int8_t)maxfr;
    }
}

static void conn_forward_start(nodes_t *nd, int n1, int n2,
                               const training_t *tinf, int final) {
    int left = nd->ndx[n1], right = nd->ndx[n2];
    double score = 0.0, scr_mod = 0.0;

    if (edge_artifact(nd, n1)) return;

    if (nd->strand[n1] == 1 && nd->type[n1] == TSTOP) {
        /* 3'fwd -> 5'fwd: intergenic */
        left += 2;
        if (left >= right) return;
        if (final) score = igm_same(nd, n1, n2, tinf->st_wt);
    } else if (nd->strand[n1] != 1 && nd->type[n1] != TSTOP) {
        /* 5'rev -> 5'fwd: intergenic */
        if (left >= right) return;
        if (final) score = igm_diff(tinf->st_wt);
    }
    if (!final) score = ((double)(right - left + 1)) * scr_mod;
    relax(nd, n1, n2, score, -1);
}

static void conn_forward_stop(nodes_t *nd, int n1, int n2,
                              const training_t *tinf, int final) {
    int n3;
    int left = nd->ndx[n1], right = nd->ndx[n2];
    double score = 0.0, scr_mod = 0.0;

    if (edge_artifact(nd, n1)) return;

    if (nd->strand[n1] == 1 && nd->type[n1] != TSTOP) {
        /* 5'fwd -> 3'fwd: a gene */
        if (nd->stop_val[n2] >= nd->ndx[n1]) return;
        right += 2;
        if (final) score = nd->cscore[n1] + nd->sscore[n1];
        else scr_mod = tinf->bias[0] * nd->gc_score[n1 * 3]
                     + tinf->bias[1] * nd->gc_score[n1 * 3 + 1]
                     + tinf->bias[2] * nd->gc_score[n1 * 3 + 2];
    } else if (nd->strand[n1] == 1 && nd->type[n1] == TSTOP) {
        /* 3'fwd -> 3'fwd: operon, via recorded overlapping start */
        if (nd->stop_val[n2] >= nd->ndx[n1]) return;
        if (nd->star_ptr[n1 * 3 + nd->ndx[n2] % 3] == -1) return;
        n3 = nd->star_ptr[n1 * 3 + nd->ndx[n2] % 3];
        left = nd->ndx[n3];
        right += 2;
        if (final) score = nd->cscore[n3] + nd->sscore[n3] + igm(nd, n1, n3, tinf->st_wt);
        else scr_mod = tinf->bias[0] * nd->gc_score[n3 * 3]
                     + tinf->bias[1] * nd->gc_score[n3 * 3 + 1]
                     + tinf->bias[2] * nd->gc_score[n3 * 3 + 2];
    }
    if (!final) score = ((double)(right - left + 1)) * scr_mod;
    relax(nd, n1, n2, score, -1);
}

static void conn_backward_start(nodes_t *nd, int n1, int n2,
                                const training_t *tinf, int final) {
    int bnd, ovlp = 0;
    int left = nd->ndx[n1], right = nd->ndx[n2];
    double score = 0.0, scr_mod = 0.0;

    if (edge_artifact(nd, n1)) return;

    if (nd->strand[n1] == -1 && nd->type[n1] == TSTOP) {
        /* 3'rev -> 5'rev: a gene */
        if (nd->stop_val[n1] <= nd->ndx[n2]) return;
        left -= 2;
        if (final) score = nd->cscore[n2] + nd->sscore[n2];
        else scr_mod = tinf->bias[0] * nd->gc_score[n2 * 3]
                     + tinf->bias[1] * nd->gc_score[n2 * 3 + 1]
                     + tinf->bias[2] * nd->gc_score[n2 * 3 + 2];
    } else if (nd->strand[n1] == 1 && nd->type[n1] == TSTOP) {
        /* 3'fwd -> 5'rev: overlapping opposite-strand 3' ends */
        if (nd->stop_val[n2] - 2 >= nd->ndx[n1] + 2) return;
        ovlp = (nd->ndx[n1] + 2) - (nd->stop_val[n2] - 2) + 1;
        if (ovlp >= MAX_OPP_OVLP) return;
        if ((nd->ndx[n1] - nd->stop_val[n2]) >= (nd->ndx[n2] - nd->ndx[n1] + 3)) return;
        bnd = (nd->traceb[n1] == -1) ? 0 : nd->ndx[nd->traceb[n1]];
        if ((nd->ndx[n1] - nd->stop_val[n2]) >= (nd->stop_val[n2] - 3 - bnd)) return;
        left = nd->stop_val[n2] - 2;
        if (final) score = nd->cscore[n2] + nd->sscore[n2] + igm_diff(tinf->st_wt);
        else scr_mod = tinf->bias[0] * nd->gc_score[n2 * 3]
                     + tinf->bias[1] * nd->gc_score[n2 * 3 + 1]
                     + tinf->bias[2] * nd->gc_score[n2 * 3 + 2];
    }
    if (!final) score = ((double)(right - left + 1 - ovlp * 2)) * scr_mod;
    relax(nd, n1, n2, score, -1);
}

static void conn_backward_stop(nodes_t *nd, int n1, int n2,
                               const training_t *tinf, int final) {
    int i, n3, ovlp = 0, maxfr = -1;
    int left = nd->ndx[n1], right = nd->ndx[n2];
    double maxval, curval;
    double score = 0.0, scr_mod = 0.0;

    if (edge_artifact(nd, n1)) return;

    if (nd->strand[n1] == 1 && nd->type[n1] == TSTOP) {
        /* 3'fwd -> 3'rev: intergenic, with possible f-r-r triple overlap */
        left += 2;
        right -= 2;
        if (left >= right) return;
        maxfr = -1;
        maxval = 0.0;
        for (i = 0; i < 3; i++) {
            if (nd->star_ptr[n2 * 3 + i] == -1) continue;
            n3 = nd->star_ptr[n2 * 3 + i];
            ovlp = left - nd->stop_val[n3] + 3;
            if (ovlp <= 0 || ovlp >= MAX_OPP_OVLP) continue;
            if (ovlp >= nd->ndx[n3] - left) continue;
            if (nd->traceb[n1] == -1) continue;
            if (ovlp >= nd->stop_val[n3] - nd->ndx[nd->traceb[n1]] - 2) continue;
            curval = nd->cscore[n3] + nd->sscore[n3] + igm(nd, n3, n2, tinf->st_wt);
            if ((final && curval > maxval)
                || (!final && tinf->bias[0] * nd->gc_score[n3 * 3]
                            + tinf->bias[1] * nd->gc_score[n3 * 3 + 1]
                            + tinf->bias[2] * nd->gc_score[n3 * 3 + 2] > maxval)) {
                maxfr = i;
                maxval = curval;
            }
        }
        if (maxfr != -1) {
            n3 = nd->star_ptr[n2 * 3 + maxfr];
            if (final) score = nd->cscore[n3] + nd->sscore[n3] + igm(nd, n3, n2, tinf->st_wt);
            else scr_mod = tinf->bias[0] * nd->gc_score[n3 * 3]
                         + tinf->bias[1] * nd->gc_score[n3 * 3 + 1]
                         + tinf->bias[2] * nd->gc_score[n3 * 3 + 2];
        } else if (final) {
            score = igm_diff(tinf->st_wt);
        }
    } else if (nd->strand[n1] != 1 && nd->type[n1] != TSTOP) {
        /* 5'rev -> 3'rev: intergenic */
        right -= 2;
        if (left >= right) return;
        if (final) score = igm_same(nd, n1, n2, tinf->st_wt);
    } else if (nd->strand[n1] != 1 && nd->type[n1] == TSTOP) {
        /* 3'rev -> 3'rev: operon, via recorded overlapping start */
        if (nd->stop_val[n1] <= nd->ndx[n2]) return;
        if (nd->star_ptr[n2 * 3 + nd->ndx[n1] % 3] == -1) return;
        n3 = nd->star_ptr[n2 * 3 + nd->ndx[n1] % 3];
        left -= 2;
        right = nd->ndx[n3];
        if (final) score = nd->cscore[n3] + nd->sscore[n3] + igm(nd, n3, n2, tinf->st_wt);
        else scr_mod = tinf->bias[0] * nd->gc_score[n3 * 3]
                     + tinf->bias[1] * nd->gc_score[n3 * 3 + 1]
                     + tinf->bias[2] * nd->gc_score[n3 * 3 + 2];
    }
    if (!final) score = ((double)(right - left + 1 - ovlp * 2)) * scr_mod;
    relax(nd, n1, n2, score, maxfr);
}

/* ---- the dynamic program (reference: lib.pyx:1205-1311) ----------------- */

/* Sliding-window running-max deque over finalized node scores: indices in
 * [head, tail) with strictly decreasing scores front to back; pushes pop
 * equal-or-smaller scores so the LARGEST index is kept among ties, matching
 * the reference's >=-relax rule under ascending scans (see `relax`). */
typedef struct { int32_t *buf; int head, tail; } maxdq_t;

static inline void dq_push(maxdq_t *q, const double *sc, int j) {
    while (q->tail > q->head && sc[q->buf[q->tail - 1]] <= sc[j]) q->tail--;
    q->buf[q->tail++] = (int32_t)j;
}

static inline void dq_evict(maxdq_t *q, int minj) {
    while (q->head < q->tail && q->buf[q->head] < minj) q->head++;
}

int rc_dp_finish(nodes_t *nd);

int rc_dynamic_programming(nodes_t *nd, const training_t *tinf, int final) {
    int i, j, min, kind, f2, kj, fj;
    int nn = nd->nn;
    uint16_t tab[4][3];
    uint16_t m;
    uint8_t *key;

    if (nn == 0) return -1;

    for (i = 0; i < nn; i++) {
        nd->score[i] = 0;
        nd->traceb[i] = -1;
        nd->tracef[i] = -1;
    }

    /* Pre-filter (role of the reference's SIMD skippable kernels,
     * impl/template.h): fold each node's (kind, frame) into a 4-bit key
     * once, and the 6 invalidity rules for a target (kind_i, frame_i)
     * into a 16-bit mask — the inner loop tests one bit per candidate
     * instead of re-evaluating the rule chain. */
    key = (uint8_t *)malloc((size_t)nn);
    if (!key) return -1;
    for (i = 0; i < nn; i++)
        key[i] = (uint8_t)((2 * (nd->strand[i] != 1)
                            + (nd->type[i] == TSTOP)) * 4
                           + nd->ndx[i] % 3);
    for (kind = 0; kind < 4; kind++) {
        int t2s = kind & 1, s2f = kind < 2;
        for (f2 = 0; f2 < 3; f2++) {
            m = 0;
            for (kj = 0; kj < 4; kj++) {
                int t1s = kj & 1, s1f = kj < 2;
                for (fj = 0; fj < 3; fj++) {
                    int skip =
                        (!t1s && !t2s && s1f == s2f)
                        || (s1f && !t1s && !s2f)
                        || (!s1f && t1s && s2f)
                        || (!s1f && !t1s && s2f && t2s)
                        || (s1f == s2f && s1f && !t1s && t2s && fj != f2)
                        || (s1f == s2f && !s1f && t1s && !t2s && fj != f2);
                    if (skip) m |= (uint16_t)(1u << (kj * 4 + fj));
                }
            }
            tab[kind][f2] = m;
        }
    }

    /* ---- driver -----------------------------------------------------------
     * The naive reference driver tests every (source, target) pair in the
     * ~1000-node window.  This driver computes the same fixed point (see
     * `relax`) with the work split by source class:
     *
     *   - "far" sources (ndx gap > 3*OPER_DIST): every igm-style class
     *     contributes score[j] + C with the SAME constant C = -0.15*st_wt
     *     (final) or 0 (initial) — igm_diff and the far branch of igm_same
     *     coincide — so the class maximum is a sliding-window running max,
     *     kept in monotone deques (rev starts + fwd stops for fwd-start
     *     targets; rev starts for rev-stop targets).
     *   - fwd-stop targets: both conn_forward_stop cases require
     *     ndx[j] > stop_val[i]; binary-search the scan start.
     *   - rev-start targets: fwd-stop sources require
     *     ndx[j] > stop_val[i] - 4 and rev-stop sources require
     *     stop_val[j] > ndx[i]; both tested branchlessly (AVX-512 when
     *     available) before any call.
     *   - remaining near/bounded survivors go through the unchanged
     *     conn_* kernels.                                              */
    int32_t *dqb = (int32_t *)malloc(2 * (size_t)nn * sizeof(int32_t));
    if (!dqb) { free(key); return -1; }
    maxdq_t d0 = { dqb, 0, 0 };            /* fwd-start targets' far max */
    maxdq_t d3 = { dqb + nn, 0, 0 };       /* rev-stop targets' far max */
    int pfar = 0;
    const double igc = final ? (-0.15 * tinf->st_wt) : 0.0;

#ifdef RC_DP_AVX512
    /* byte LUT per (kind, frame): 0xFF where the source key is skipped;
     * vpshufb over 64 keys at a time turns the per-candidate bit test
     * into one shuffle + one zero-test mask. */
    __m128i skiplut[4][3];
    for (kind = 0; kind < 4; kind++) {
        for (f2 = 0; f2 < 3; f2++) {
            uint8_t b[16];
            for (kj = 0; kj < 16; kj++)
                b[kj] = (uint8_t)(((tab[kind][f2] >> kj) & 1) ? 0xFF : 0);
            skiplut[kind][f2] = _mm_loadu_si128((const __m128i *)b);
        }
    }
#endif

    for (i = 0; i < nn; i++) {
        min = (i < MAX_NODE_DIST) ? 0 : i - MAX_NODE_DIST;
        if (nd->strand[i] == -1 && nd->type[i] != TSTOP
            && nd->ndx[min] > nd->stop_val[i]) {
            while (min > 0 && nd->ndx[min] != nd->stop_val[i]) min--;
        } else if (nd->strand[i] == 1 && nd->type[i] == TSTOP
                   && nd->ndx[min] > nd->stop_val[i]) {
            while (min > 0 && nd->ndx[min] != nd->stop_val[i]) min--;
        }
        min = (min < MAX_NODE_DIST) ? 0 : min - MAX_NODE_DIST;

        /* advance the far boundary: sources with ndx < ndx[i]-180 join
         * their class deque once finalized (edge artifacts excluded) */
        {
            const int32_t thr = nd->ndx[i] - 3 * OPER_DIST;
            while (pfar < i && nd->ndx[pfar] < thr) {
                if (nd->traceb[pfar] != -1) {
                    const int kk = key[pfar] >> 2;
                    if (kk == 2) {                     /* rev start */
                        dq_push(&d0, nd->score, pfar);
                        dq_push(&d3, nd->score, pfar);
                    } else if (kk == 1) {              /* fwd stop */
                        dq_push(&d0, nd->score, pfar);
                    }
                }
                pfar++;
            }
        }

        kind = key[i] >> 2;
        m = tab[kind][key[i] & 3];

        if (kind == 0) {                       /* fwd start target */
            dq_evict(&d0, min);
            if (d0.head < d0.tail)
                relax(nd, d0.buf[d0.head], i, igc, -1);
            j = (pfar > min) ? pfar : min;
            for (; j < i; j++)
                if (!((m >> key[j]) & 1))
                    conn_forward_start(nd, j, i, tinf, final);
        } else if (kind == 1) {                /* fwd stop target */
            /* both conn_forward_stop cases require ndx[j] > stop_val[i] */
            int a = min, b2 = i, mid;
            const int32_t sv = nd->stop_val[i];
            while (a < b2) {
                mid = (a + b2) >> 1;
                if (nd->ndx[mid] > sv) b2 = mid; else a = mid + 1;
            }
            for (j = a; j < i; j++)
                if (!((m >> key[j]) & 1))
                    conn_forward_stop(nd, j, i, tinf, final);
        } else if (kind == 2) {                /* rev start target */
            const int32_t ndx_i = nd->ndx[i];
            const int32_t svm4 = nd->stop_val[i] - 4;
            j = min;
#ifdef RC_DP_AVX512
            {
                const __m512i lut = _mm512_broadcast_i32x4(skiplut[2][key[i] & 3]);
                const __m512i vnd = _mm512_set1_epi32(ndx_i);
                const __m512i vsv = _mm512_set1_epi32(svm4);
                for (; j + 64 <= i; j += 64) {
                    const __m512i kv = _mm512_loadu_si512((const void *)(key + j));
                    const __m512i sk = _mm512_shuffle_epi8(lut, kv);
                    uint64_t surv = _mm512_testn_epi8_mask(sk, sk);
                    if (!surv) continue;
                    /* rev-stop sources: stop_val[j] > ndx[i];
                     * fwd-stop sources: ndx[j] > stop_val[i]-4 */
                    const uint64_t is_rstop =
                        _mm512_cmpge_epu8_mask(kv, _mm512_set1_epi8(12)) & surv;
                    uint64_t csv = 0, cnd = 0;
                    int c;
                    for (c = 0; c < 4; c++) {
                        csv |= (uint64_t)_mm512_cmpgt_epi32_mask(
                            _mm512_loadu_si512((const void *)(nd->stop_val + j + 16 * c)),
                            vnd) << (16 * c);
                        cnd |= (uint64_t)_mm512_cmpgt_epi32_mask(
                            _mm512_loadu_si512((const void *)(nd->ndx + j + 16 * c)),
                            vsv) << (16 * c);
                    }
                    surv = (is_rstop & csv) | ((surv & ~is_rstop) & cnd);
                    while (surv) {
                        const int t = (int)__builtin_ctzll(surv);
                        surv &= surv - 1;
                        conn_backward_start(nd, j + t, i, tinf, final);
                    }
                }
            }
#endif
            for (; j < i; j++) {
                if ((m >> key[j]) & 1) continue;
                if ((key[j] >> 2) == 3) {      /* rev stop */
                    if (nd->stop_val[j] <= ndx_i) continue;
                } else {                       /* fwd stop */
                    if (nd->ndx[j] <= svm4) continue;
                }
                conn_backward_start(nd, j, i, tinf, final);
            }
        } else {                               /* rev stop target */
            const int32_t ndx_i = nd->ndx[i];
            const int32_t near_thr = ndx_i - 3 * OPER_DIST - 1;
            dq_evict(&d3, min);
            if (d3.head < d3.tail)
                relax(nd, d3.buf[d3.head], i, igc, -1);
            j = min;
#ifdef RC_DP_AVX512
            {
                const __m512i lut = _mm512_broadcast_i32x4(skiplut[3][key[i] & 3]);
                const __m512i vnd = _mm512_set1_epi32(ndx_i);
                const __m512i vnear = _mm512_set1_epi32(near_thr);
                for (; j + 64 <= i; j += 64) {
                    const __m512i kv = _mm512_loadu_si512((const void *)(key + j));
                    const __m512i sk = _mm512_shuffle_epi8(lut, kv);
                    uint64_t surv = _mm512_testn_epi8_mask(sk, sk);
                    if (!surv) continue;
                    /* fwd stops: unconditional; rev stops: stop_val[j] >
                     * ndx[i]; rev starts: near region only (far ones are
                     * covered by the d3 deque) */
                    const uint64_t is_rstop =
                        _mm512_cmpge_epu8_mask(kv, _mm512_set1_epi8(12)) & surv;
                    const uint64_t is_rstart =
                        _mm512_cmpge_epu8_mask(kv, _mm512_set1_epi8(8)) & surv
                        & ~is_rstop;
                    const uint64_t is_fstop = surv & ~is_rstop & ~is_rstart;
                    uint64_t csv = 0, cnr = 0;
                    int c;
                    for (c = 0; c < 4; c++) {
                        csv |= (uint64_t)_mm512_cmpgt_epi32_mask(
                            _mm512_loadu_si512((const void *)(nd->stop_val + j + 16 * c)),
                            vnd) << (16 * c);
                        cnr |= (uint64_t)_mm512_cmpgt_epi32_mask(
                            _mm512_loadu_si512((const void *)(nd->ndx + j + 16 * c)),
                            vnear) << (16 * c);
                    }
                    surv = is_fstop | (is_rstop & csv) | (is_rstart & cnr);
                    while (surv) {
                        const int t = (int)__builtin_ctzll(surv);
                        surv &= surv - 1;
                        conn_backward_stop(nd, j + t, i, tinf, final);
                    }
                }
            }
#endif
            for (; j < i; j++) {
                if ((m >> key[j]) & 1) continue;
                const int kk = key[j] >> 2;
                if (kk == 3) {                 /* rev stop */
                    if (nd->stop_val[j] <= ndx_i) continue;
                } else if (kk == 2) {          /* rev start: near only */
                    if (nd->ndx[j] <= near_thr) continue;
                }
                conn_backward_stop(nd, j, i, tinf, final);
            }
        }
    }

    free(dqb);
    free(key);
    return rc_dp_finish(nd);
}

/* post-scan tail of the DP: terminal argmax, overlap disentangling and
 * forward pointers; shared by the C loop above and the JAX/TPU scan path
 * (which computes score/traceb/ov_mark on device and finishes here). */
int rc_dp_finish(nodes_t *nd) {
    int i, path, nxt, tmp;
    int nn = nd->nn;
    int max_ndx = -1;
    double max_sc = -1.0;

    /* best terminal node */
    for (i = nn - 1; i >= 0; i--) {
        if (nd->strand[i] == 1 && nd->type[i] != TSTOP) continue;
        if (nd->strand[i] == -1 && nd->type[i] == TSTOP) continue;
        if (nd->score[i] > max_sc) {
            max_sc = nd->score[i];
            max_ndx = i;
        }
    }
    if (max_ndx < 0) return -1;

    /* untangle triple overlaps (reference: lib.pyx:1258-1271) */
    path = max_ndx;
    while (nd->traceb[path] != -1) {
        nxt = nd->traceb[path];
        if (nd->strand[path] == -1 && nd->type[path] == TSTOP
            && nd->strand[nxt] == 1 && nd->type[nxt] == TSTOP
            && nd->ov_mark[path] != -1 && nd->ndx[path] > nd->ndx[nxt]) {
            tmp = nd->star_ptr[path * 3 + nd->ov_mark[path]];
            i = tmp;
            while (nd->ndx[i] != nd->stop_val[tmp]) i--;
            nd->traceb[path] = tmp;
            nd->traceb[tmp] = i;
            nd->ov_mark[i] = -1;
            nd->traceb[i] = nxt;
        }
        path = nd->traceb[path];
    }

    /* untangle simple overlaps (reference: lib.pyx:1274-1289) */
    path = max_ndx;
    while (nd->traceb[path] != -1) {
        nxt = nd->traceb[path];
        if (nd->strand[path] == -1 && nd->type[path] != TSTOP
            && nd->strand[nxt] == 1 && nd->type[nxt] == TSTOP) {
            i = path;
            while (nd->ndx[i] != nd->stop_val[path]) i--;
            nd->traceb[path] = i;
            nd->traceb[i] = nxt;
        }
        if (nd->strand[path] == 1 && nd->type[path] == TSTOP
            && nd->strand[nxt] == 1 && nd->type[nxt] == TSTOP) {
            nd->traceb[path] = nd->star_ptr[nxt * 3 + nd->ndx[path] % 3];
            nd->traceb[nd->traceb[path]] = nxt;
        }
        if (nd->strand[path] == -1 && nd->type[path] == TSTOP
            && nd->strand[nxt] == -1 && nd->type[nxt] == TSTOP) {
            nd->traceb[path] = nd->star_ptr[path * 3 + nd->ndx[nxt] % 3];
            nd->traceb[nd->traceb[path]] = nxt;
        }
        path = nd->traceb[path];
    }

    /* forward pointers (reference: lib.pyx:1291-1295) */
    path = max_ndx;
    while (nd->traceb[path] != -1) {
        nd->tracef[nd->traceb[path]] = path;
        path = nd->traceb[path];
    }

    return (nd->traceb[max_ndx] == -1) ? -1 : max_ndx;
}

/* ---- bad-gene elimination (Prodigal v2.6.3 dprog.c semantics) -----------
 * Reconstructed from spec (the vendored source is absent from the reference
 * snapshot, see reference SURVEY); behaviour validated against the golden
 * outputs: first sweep folds the intergenic modifier of each path junction
 * into the sscore of the gene's scoring node, second sweep marks genes whose
 * final (cscore + sscore) is negative for elimination. */
void rc_eliminate_bad_genes(nodes_t *nd, int ipath, const training_t *tinf) {
    int path, nxt;

    if (ipath == -1) return;
    path = ipath;
    while (nd->traceb[path] != -1) path = nd->traceb[path];

    /* sweep 1: apply intergenic modifiers along the path */
    while (nd->tracef[path] != -1) {
        if (nd->strand[path] == 1 && nd->type[path] == TSTOP)
            nd->sscore[nd->tracef[path]] += igm(nd, path, nd->tracef[path], tinf->st_wt);
        if (nd->strand[path] == -1 && nd->type[path] != TSTOP)
            nd->sscore[path] += igm(nd, path, nd->tracef[path], tinf->st_wt);
        path = nd->tracef[path];
    }

    /* sweep 2: eliminate genes with negative total score */
    path = ipath;
    while (nd->traceb[path] != -1) path = nd->traceb[path];
    while (nd->tracef[path] != -1) {
        nxt = nd->tracef[path];
        if (nd->strand[path] == 1 && nd->type[path] != TSTOP
            && nd->strand[nxt] == 1 && nd->type[nxt] == TSTOP
            && nd->cscore[path] + nd->sscore[path] < 0.0) {
            nd->elim[path] = 1;
            nd->elim[nxt] = 1;
        }
        if (nd->strand[path] == -1 && nd->type[path] == TSTOP
            && nd->strand[nxt] == -1 && nd->type[nxt] != TSTOP
            && nd->cscore[nxt] + nd->sscore[nxt] < 0.0) {
            nd->elim[path] = 1;
            nd->elim[nxt] = 1;
        }
        path = nxt;
    }
}

/* ---- gene extraction from the path (reference: lib.pyx:3231-3270) ------- */
int rc_extract_genes(nodes_t *nd, int ipath, int32_t *g_begin, int32_t *g_end,
                     int32_t *g_start_ndx, int32_t *g_stop_ndx, int cap) {
    int path = ipath, ng = 0;
    int begin = 0, end = 0, start_ndx = 0, stop_ndx = 0;

    if (path == -1) return 0;
    while (nd->traceb[path] != -1) path = nd->traceb[path];
    while (path != -1) {
        if (nd->elim[path] == 1) {
            /* skipped */
        } else if (nd->strand[path] == 1) {
            if (nd->type[path] != TSTOP) {
                begin = nd->ndx[path] + 1;
                start_ndx = path;
            } else {
                end = nd->ndx[path] + 3;
                stop_ndx = path;
                if (ng >= cap) return -1;
                g_begin[ng] = begin; g_end[ng] = end;
                g_start_ndx[ng] = start_ndx; g_stop_ndx[ng] = stop_ndx;
                ng++;
            }
        } else {
            if (nd->type[path] != TSTOP) {
                end = nd->ndx[path] + 1;
                start_ndx = path;
                if (ng >= cap) return -1;
                g_begin[ng] = begin; g_end[ng] = end;
                g_start_ndx[ng] = start_ndx; g_stop_ndx[ng] = stop_ndx;
                ng++;
            } else {
                begin = nd->ndx[path] - 1;
                stop_ndx = path;
            }
        }
        path = nd->tracef[path];
    }
    return ng;
}

/* ---- final start adjustment (reference: lib.pyx:3272-3401) -------------- */
void rc_tweak_final_starts(nodes_t *nd, int ng, int32_t *g_begin, int32_t *g_end,
                           int32_t *g_start_ndx, int32_t *g_stop_ndx,
                           const training_t *tinf, int max_sam_overlap) {
    int i, j, ndx, mndx;
    int maxndx[2];
    double sc, tigm, local_igm;
    double maxsc[2], maxigm[2];
    int nn = nd->nn;

    for (i = 0; i < ng; i++) {
        ndx = g_start_ndx[i];
        sc = nd->sscore[ndx] + nd->cscore[ndx];
        local_igm = 0.0;

        if (i > 0 && nd->strand[ndx] == 1 && nd->strand[g_start_ndx[i-1]] == 1)
            local_igm = igm_same(nd, g_stop_ndx[i-1], ndx, tinf->st_wt);
        if (i > 0 && nd->strand[ndx] == 1 && nd->strand[g_start_ndx[i-1]] == -1)
            local_igm = igm_diff(tinf->st_wt);
        if (i < ng-1 && nd->strand[ndx] == -1 && nd->strand[g_start_ndx[i+1]] == 1)
            local_igm = igm_diff(tinf->st_wt);
        if (i < ng-1 && nd->strand[ndx] == -1 && nd->strand[g_start_ndx[i+1]] == -1)
            local_igm = igm_same(nd, ndx, g_stop_ndx[i+1], tinf->st_wt);

        /* find the #2 / #3 scoring starts sharing this stop */
        maxndx[0] = maxndx[1] = -1;
        maxsc[0] = maxsc[1] = 0;
        maxigm[0] = maxigm[1] = 0;
        for (j = ndx - 100; j < ndx + 100; j++) {
            if (j < 0 || j >= nn || j == ndx) continue;
            if (nd->type[j] == TSTOP || nd->stop_val[j] != nd->stop_val[ndx])
                continue;
            tigm = 0.0;
            if (i > 0 && nd->strand[j] == 1 && nd->strand[g_start_ndx[i-1]] == 1) {
                if (nd->ndx[g_stop_ndx[i-1]] - nd->ndx[j] > max_sam_overlap) continue;
                tigm = igm_same(nd, g_stop_ndx[i-1], j, tinf->st_wt);
            }
            if (i > 0 && nd->strand[j] == 1 && nd->strand[g_start_ndx[i-1]] == -1) {
                if (nd->ndx[g_start_ndx[i-1]] - nd->ndx[j] >= 0) continue;
                tigm = igm_diff(tinf->st_wt);
            }
            if (i < ng-1 && nd->strand[j] == -1 && nd->strand[g_start_ndx[i+1]] == 1) {
                if (nd->ndx[j] - nd->ndx[g_start_ndx[i+1]] >= 0) continue;
                tigm = igm_diff(tinf->st_wt);
            }
            if (i < ng-1 && nd->strand[j] == -1 && nd->strand[g_start_ndx[i+1]] == -1) {
                if (nd->ndx[j] - nd->ndx[g_stop_ndx[i+1]] > max_sam_overlap) continue;
                tigm = igm_same(nd, j, g_stop_ndx[i+1], tinf->st_wt);
            }

            if (maxndx[0] == -1) {
                maxndx[0] = j;
                maxsc[0] = nd->cscore[j] + nd->sscore[j];
                maxigm[0] = tigm;
            } else if (nd->cscore[j] + nd->sscore[j] + tigm > maxsc[0]) {
                maxndx[1] = maxndx[0];
                maxsc[1] = maxsc[0];
                maxigm[1] = maxigm[0];
                maxndx[0] = j;
                maxsc[0] = nd->cscore[j] + nd->sscore[j];
                maxigm[0] = tigm;
            } else if (maxndx[1] == -1
                       || nd->cscore[j] + nd->sscore[j] + tigm > maxsc[1]) {
                maxndx[1] = j;
                maxsc[1] = nd->cscore[j] + nd->sscore[j];
                maxigm[1] = tigm;
            }
        }

        for (j = 0; j < 2; j++) {
            mndx = maxndx[j];
            if (mndx == -1) continue;
            if (nd->tscore[mndx] < nd->tscore[ndx]
                && maxsc[j] - nd->tscore[mndx] >= sc - nd->tscore[ndx] + tinf->st_wt
                && nd->rscore[mndx] > nd->rscore[ndx]
                && nd->uscore[mndx] > nd->uscore[ndx]
                && nd->cscore[mndx] > nd->cscore[ndx]
                && abs(nd->ndx[mndx] - nd->ndx[ndx]) > 15) {
                maxsc[j] += nd->tscore[ndx] - nd->tscore[mndx];
            } else if (abs(nd->ndx[mndx] - nd->ndx[ndx]) <= 15
                       && nd->rscore[mndx] + nd->tscore[mndx]
                          > nd->rscore[ndx] + nd->tscore[ndx]
                       && nd->edge[ndx] == 0 && nd->edge[mndx] == 0) {
                if (nd->cscore[ndx] > nd->cscore[mndx])
                    maxsc[j] += nd->cscore[ndx] - nd->cscore[mndx];
                if (nd->uscore[ndx] > nd->uscore[mndx])
                    maxsc[j] += nd->uscore[ndx] - nd->uscore[mndx];
                if (local_igm > maxigm[j])
                    maxsc[j] += local_igm - maxigm[j];
            } else {
                maxsc[j] = -1000.0;
            }
        }

        mndx = -1;
        for (j = 0; j < 2; j++) {
            if (maxndx[j] == -1) continue;
            if (mndx == -1 && maxsc[j] + maxigm[j] > sc + local_igm) mndx = j;
            else if (mndx >= 0 && maxsc[j] + maxigm[j] > maxsc[mndx] + maxigm[mndx]) mndx = j;
        }
        if (mndx != -1 && nd->strand[maxndx[mndx]] == 1) {
            g_start_ndx[i] = maxndx[mndx];
            g_begin[i] = nd->ndx[maxndx[mndx]] + 1;
        } else if (mndx != -1 && nd->strand[maxndx[mndx]] == -1) {
            g_start_ndx[i] = maxndx[mndx];
            g_end[i] = nd->ndx[maxndx[mndx]] + 1;
        }
    }
}

/* ---- prediction confidence (Prodigal gene.c semantics) ------------------
 * Reconstructed from spec; validated against golden GFF `conf=` values:
 * logistic in score/start_weight, hard 99.99 ceiling above 41, floor 50. */
double rc_calculate_confidence(double score, double start_weight) {
    double conf;
    if (score / start_weight < 41) {
        conf = exp(score / start_weight);
        conf = conf / (conf + 1);
    } else {
        conf = 0.9999;
    }
    if (conf <= 0.50) conf = 0.50;
    return conf * 100.0;
}

/* ---- GC frame bias recording (Prodigal v2.6.3 node.c semantics) ---------
 * Reconstructed from spec (vendored source absent from the reference
 * snapshot); per-node gc_score[j] is the per-codon fraction of the ORF whose
 * max-GC frame (from the 120bp frame plot) lies j positions downstream of
 * the node's own frame, scaled to sum to 3; tinf->bias accumulates the
 * dominant-frame codon counts over all start nodes, scaled to sum to 3.
 * Validated against the reference oracle values
 * (test_gene_finder.py:337-345 and the golden training files). */
/* Debug/fitting export: the per-start-node relative-frame winner counts
 * exactly as rc_record_gc_bias computes them (cnt[3] + max_frame winner),
 * so aggregation hypotheses can be fitted against the oracle bias without
 * re-deriving the geometry (scripts/fit_gc_bias*.py). */
void rc_gc_bias_counts(const int8_t *gp, int slen, nodes_t *nd,
                       double *out_cnt, int32_t *out_mfr) {
    int i, j, k, lo, hi, fr;
    double cnt[3];
    for (i = 0; i < nd->nn; i++) {
        out_mfr[i] = -1;
        out_cnt[i * 3] = out_cnt[i * 3 + 1] = out_cnt[i * 3 + 2] = 0.0;
        if (nd->type[i] == TSTOP) continue;
        cnt[0] = cnt[1] = cnt[2] = 0.0;
        fr = nd->ndx[i] % 3;
        if (nd->strand[i] == 1) {
            lo = nd->ndx[i];
            hi = nd->stop_val[i] + 1;
            if (lo < 0) lo = 0;
            if (hi > slen) hi = slen;
            for (j = lo; j < hi; j++) {
                k = gp[j];
                if (k >= 0) cnt[(k - fr + 3) % 3] += 1.0;
            }
        } else {
            lo = nd->stop_val[i];
            hi = nd->ndx[i] + 1;
            if (lo < 0) lo = 0;
            if (hi > slen) hi = slen;
            for (j = lo; j < hi; j++) {
                k = gp[j];
                if (k >= 0) cnt[(fr - k + 3) % 3] += 1.0;
            }
        }
        for (j = 0; j < 3; j++) out_cnt[i * 3 + j] = cnt[j];
        out_mfr[i] = max_frame((int)cnt[0], (int)cnt[1], (int)cnt[2]);
    }
}

void rc_record_gc_bias(const int8_t *gp, int slen, nodes_t *nd, training_t *tinf) {
    int i, j, k, lo, hi, fr, mfr;
    double cnt[3], len, tot;
    double frames[3] = { 0.0, 0.0, 0.0 };

    /* Per node: count, per nucleotide of the ORF (start codon through stop
     * codon start), how often the plot's max-GC frame lands 0/1/2 codon
     * positions downstream of the node's own frame.  Fitted against the
     * reference oracle (SRR492066 bias matches to ~3e-4 relative; frame-0
     * component to 8 significant digits — remaining deviation is a known
     * open item, see KNOWN_GAPS.md). */
    for (i = 0; i < nd->nn; i++) {
        if (nd->type[i] == TSTOP) continue;
        cnt[0] = cnt[1] = cnt[2] = 0.0;
        fr = nd->ndx[i] % 3;
        if (nd->strand[i] == 1) {
            lo = nd->ndx[i];
            hi = nd->stop_val[i] + 1;
            if (lo < 0) lo = 0;
            if (hi > slen) hi = slen;
            for (j = lo; j < hi; j++) {
                k = gp[j];
                if (k >= 0) cnt[(k - fr + 3) % 3] += 1.0;
            }
        } else {
            lo = nd->stop_val[i];
            hi = nd->ndx[i] + 1;
            if (lo < 0) lo = 0;
            if (hi > slen) hi = slen;
            for (j = lo; j < hi; j++) {
                k = gp[j];
                if (k >= 0) cnt[(fr - k + 3) % 3] += 1.0;
            }
        }
        len = cnt[0] + cnt[1] + cnt[2];
        mfr = max_frame((int)cnt[0], (int)cnt[1], (int)cnt[2]);
        nd->gc_bias[i] = (uint8_t)mfr;
        if (len > 0) {
            for (j = 0; j < 3; j++) nd->gc_score[i * 3 + j] = cnt[j] * 3.0 / len;
        } else {
            for (j = 0; j < 3; j++) nd->gc_score[i * 3 + j] = 0.0;
        }
        frames[mfr] += cnt[mfr];
    }

    tot = frames[0] + frames[1] + frames[2];
    if (tot > 0)
        for (i = 0; i < 3; i++) tinf->bias[i] = frames[i] * 3.0 / tot;
}

/* ---- dicodon statistics (reference: lib.pyx:4284-4358) ------------------ */
/* Variant taking PRECOMPUTED background hexamer counts — the distributed
 * trainer psum-merges these over a device mesh (parallel/train.py); the
 * counts are bit-identical to the scalar scan below, so the resulting
 * gene_dc is too. */
/* log-ratio finalization shared by the host walk and the mesh-sharded
 * device tallies (parallel/train.py): gene_dc from raw background + gene
 * hexamer counts, exactly as the tail of calc_dicodon_gene
 * (reference: lib.pyx:4340-4358). */
void rc_dicodon_finalize(training_t *tinf, const int64_t *bg_counts,
                         const int64_t *gene_counts) {
    int i;
    int64_t glob, gglob;
    double prob, bg[4096];

    glob = 0;
    for (i = 0; i < 4096; i++) glob += bg_counts[i];
    for (i = 0; i < 4096; i++)
        bg[i] = ((double)bg_counts[i]) / ((double)glob);
    gglob = 0;
    for (i = 0; i < 4096; i++) gglob += gene_counts[i];
    for (i = 0; i < 4096; i++) {
        prob = ((double)gene_counts[i]) / ((double)gglob);
        if (prob == 0 && bg[i] != 0) tinf->gene_dc[i] = -5.0;
        else if (bg[i] == 0) tinf->gene_dc[i] = 0.0;
        else tinf->gene_dc[i] = log(prob / bg[i]);
        if (tinf->gene_dc[i] > 5.0) tinf->gene_dc[i] = 5.0;
        else if (tinf->gene_dc[i] < -5.0) tinf->gene_dc[i] = -5.0;
    }
}

void rc_calc_dicodon_gene_bg(training_t *tinf, const uint8_t *d, int slen,
                             nodes_t *nd, int ipath,
                             const int64_t *bg_counts) {
    int i, in_gene = 0, path = ipath, left = -1, right = -1;
    int64_t glob;
    int counts[4096];
    double prob, bg[4096];

    glob = 0;
    for (i = 0; i < 4096; i++) glob += bg_counts[i];
    for (i = 0; i < 4096; i++)
        bg[i] = ((double)bg_counts[i]) / ((double)glob);

    glob = 0;
    memset(counts, 0, sizeof(counts));
    while (path != -1) {
        if (nd->strand[path] == 1) {
            if (nd->type[path] == TSTOP) {
                in_gene = 1;
                right = nd->ndx[path] + 2;
            } else if (in_gene == 1) {
                left = nd->ndx[path];
                for (i = left; i < right - 5; i += 3) {
                    counts[mer_ndx(d, slen, i, 6, 1)] += 1;
                    glob += 1;
                }
                in_gene = 0;
            }
        } else {
            if (nd->type[path] != TSTOP) {
                in_gene = -1;
                left = slen - nd->ndx[path] - 1;
            } else if (in_gene == -1) {
                right = slen - nd->ndx[path] + 1;
                for (i = left; i < right - 5; i += 3) {
                    counts[mer_ndx(d, slen, i, 6, -1)] += 1;
                    glob += 1;
                }
                in_gene = 0;
            }
        }
        path = nd->traceb[path];
    }

    for (i = 0; i < 4096; i++) {
        prob = ((double)counts[i]) / ((double)glob);
        if (prob == 0 && bg[i] != 0) tinf->gene_dc[i] = -5.0;
        else if (bg[i] == 0) tinf->gene_dc[i] = 0.0;
        else tinf->gene_dc[i] = log(prob / bg[i]);
        if (tinf->gene_dc[i] > 5.0) tinf->gene_dc[i] = 5.0;
        else if (tinf->gene_dc[i] < -5.0) tinf->gene_dc[i] = -5.0;
    }
}

void rc_calc_dicodon_gene(training_t *tinf, const uint8_t *d, int slen,
                          nodes_t *nd, int ipath) {
    int i, in_gene = 0, path = ipath, left = -1, right = -1;
    int64_t glob;
    int counts[4096];
    double prob, bg[4096];

    glob = 0;
    memset(counts, 0, sizeof(counts));
    for (i = 0; i < slen - 5; i++) {
        counts[mer_ndx(d, slen, i, 6, 1)] += 1;
        counts[mer_ndx(d, slen, i, 6, -1)] += 1;
        glob += 2;
    }
    for (i = 0; i < 4096; i++) bg[i] = ((double)counts[i]) / ((double)glob);

    glob = 0;
    memset(counts, 0, sizeof(counts));
    while (path != -1) {
        if (nd->strand[path] == 1) {
            if (nd->type[path] == TSTOP) {
                in_gene = 1;
                right = nd->ndx[path] + 2;
            } else if (in_gene == 1) {
                left = nd->ndx[path];
                for (i = left; i < right - 5; i += 3) {
                    counts[mer_ndx(d, slen, i, 6, 1)] += 1;
                    glob += 1;
                }
                in_gene = 0;
            }
        } else {
            if (nd->type[path] != TSTOP) {
                in_gene = -1;
                left = slen - nd->ndx[path] - 1;
            } else if (in_gene == -1) {
                right = slen - nd->ndx[path] + 1;
                for (i = left; i < right - 5; i += 3) {
                    counts[mer_ndx(d, slen, i, 6, -1)] += 1;
                    glob += 1;
                }
                in_gene = 0;
            }
        }
        path = nd->traceb[path];
    }

    for (i = 0; i < 4096; i++) {
        prob = ((double)counts[i]) / ((double)glob);
        if (prob == 0 && bg[i] != 0) tinf->gene_dc[i] = -5.0;
        else if (bg[i] == 0) tinf->gene_dc[i] = 0.0;
        else tinf->gene_dc[i] = log(prob / bg[i]);
        if (tinf->gene_dc[i] > 5.0) tinf->gene_dc[i] = 5.0;
        else if (tinf->gene_dc[i] < -5.0) tinf->gene_dc[i] = -5.0;
    }
}

/* ---- upstream composition counting (reference: lib.pyx:4360-4389) ------- */
static void count_upstream_composition(training_t *tinf, const uint8_t *d,
                                       int slen, int pos, int strand) {
    int i = 0, j;
    if (strand == 1) {
        for (j = 1; j < 3; j++) {
            if (pos >= j) tinf->ups_comp[i][d[pos - j] & 3] += 1;
            i++;
        }
        for (j = 15; j < 45; j++) {
            if (pos >= j) tinf->ups_comp[i][d[pos - j] & 3] += 1;
            i++;
        }
    } else {
        for (j = 1; j < 3; j++) {
            if (pos + j < slen) tinf->ups_comp[i][COMPL[d[pos + j]] & 3] += 1;
            i++;
        }
        for (j = 15; j < 45; j++) {
            if (pos + j < slen) tinf->ups_comp[i][COMPL[d[pos + j]] & 3] += 1;
            i++;
        }
    }
}

/* ---- motif counting for non-SD training (reference: lib.pyx:4226-4282) -- */
static void update_motif_counts(double mcnt[4][4][4096], double *zero,
                                const uint8_t *d, int slen, nodes_t *nd,
                                int n, int stage) {
    int i, j, k, mer, start, spacendx;

    if (nd->type[n] == TSTOP || nd->edge[n] == 1) return;
    if (nd->mot_len[n] == 0) { zero[0] += 1.0; return; }

    start = (nd->strand[n] == 1) ? nd->ndx[n] : slen - 1 - nd->ndx[n];

    if (stage == 0) {
        for (i = 3; i >= 0; i--) {
            for (j = start - 18 - i; j < start - 5 - i; j++) {
                if (j < 0) continue;
                mer = mer_ndx(d, slen, j, i + 3, nd->strand[n]);
                for (k = 0; k < 4; k++) mcnt[i][k][mer] += 1.0;
            }
        }
    } else if (stage == 1) {
        mcnt[nd->mot_len[n] - 3][nd->mot_spacendx[n]][nd->mot_ndx[n]] += 1.0;
        for (i = 0; i < nd->mot_len[n] - 3; i++) {
            for (j = start - nd->mot_spacer[n] - nd->mot_len[n];
                 j < start - nd->mot_spacer[n] - i - 2; j++) {
                if (j < 0) continue;
                if      (j <= start - 16 - i) spacendx = 3;
                else if (j <= start - 14 - i) spacendx = 2;
                else if (j >= start - 7 - i)  spacendx = 1;
                else                          spacendx = 0;
                mer = mer_ndx(d, slen, j, i + 3, nd->strand[n]);
                mcnt[i][spacendx][mer] += 1.0;
            }
        }
    } else if (stage == 2) {
        mcnt[nd->mot_len[n] - 3][nd->mot_spacendx[n]][nd->mot_ndx[n]] += 1.0;
    }
}

/* ---- motif coverage map (Prodigal v2.6.3 node.c semantics) --------------
 * Reconstructed from spec: a 3-mer motif is "good" if it was counted in at
 * least 20% of the genes in any spacer bin; a longer motif additionally
 * requires both of its (n-1)-mer sub-motifs to be good. */
/* variant/thresh are threaded through as arguments (no mutable globals —
 * the entry points run concurrently on the runner's thread pool); the
 * production choice is variant 2, thresh 0.20. */
void rc_build_coverage_map(double real[4][4][4096], int good[4][4][4096],
                           double ng, int BCM_VARIANT, double thresh) {
    int i, j, l, size, pre, suf, any;

    memset(good, 0, 4 * 4 * 4096 * sizeof(int));
    for (i = 0; i < 64; i++) {
        any = 0;
        if (BCM_VARIANT == 1) {
            for (j = 0; j < 4; j++)
                good[0][j][i] = (real[0][j][i] / ng >= thresh);
            continue;
        }
        for (j = 0; j < 4; j++)
            if (real[0][j][i] / ng >= thresh) any = 1;
        if (any)
            for (j = 0; j < 4; j++) good[0][j][i] = 1;
    }
    for (l = 1; l < 4; l++) {
        size = 1 << (2 * (l + 3));
        for (i = 0; i < size; i++) {
            if (BCM_VARIANT >= 7) {
                /* sliding-3-mer family: a (l+3)-mer is good when all of
                 * its l+1 constituent 3-mers are good (any-spacer), with
                 * an own-count requirement per variant */
                int w, allw = 1, own = 0;
                for (w = 0; w <= l; w++)
                    if (!good[0][0][(i >> (2 * w)) & 63]) allw = 0;
                for (j = 0; j < 4; j++)
                    if (real[l][j][i] / ng >= thresh) own = 1;
                if (!allw) continue;
                if (BCM_VARIANT == 7 && !own) continue;
                if (BCM_VARIANT == 9 && l == 1 && !own) continue;
                for (j = 0; j < 4; j++) good[l][j][i] = 1;
                continue;
            }
            pre = i & ((1 << (2 * (l + 2))) - 1);
            suf = i >> 2;
            if (BCM_VARIANT == 1) {
                for (j = 0; j < 4; j++)
                    good[l][j][i] = (good[l-1][j][pre] && good[l-1][j][suf]
                                     && real[l][j][i] / ng >= thresh);
                continue;
            }
            any = 0;
            for (j = 0; j < 4; j++)
                if (real[l][j][i] / ng >= thresh) any = 1;
            if (BCM_VARIANT == 0) {
                if (!good[l - 1][0][pre] || !good[l - 1][0][suf]) continue;
                if (!any) continue;
            } else if (BCM_VARIANT == 2) {
                if (!good[l - 1][0][pre] || !good[l - 1][0][suf]) continue;
            } else if (BCM_VARIANT == 3) {
                if (!any) continue;
            } else if (BCM_VARIANT == 4) {
                if (!any && !(good[l - 1][0][pre] && good[l - 1][0][suf])) continue;
            } else if (BCM_VARIANT == 5) {
                int own = 0;
                for (j = 0; j < 4; j++) if (real[l][j][i] > 0.0) own = 1;
                if (!own || !good[l - 1][0][pre] || !good[l - 1][0][suf]) continue;
            } else if (BCM_VARIANT == 6) {
                if (!any) continue;
                if (!good[l - 1][0][pre] && !good[l - 1][0][suf]) continue;
            }
            for (j = 0; j < 4; j++) good[l][j][i] = 1;
        }
    }
}

/* ---- SD usage decision (Prodigal v2.6.3 node.c semantics) ---------------
 * Reconstructed from spec; consistent with all golden training files. */
void rc_determine_sd_usage(training_t *tinf) {
    tinf->uses_sd = 1;
    if (tinf->rbs_wt[0] >= 0.0) tinf->uses_sd = 0;
    if (tinf->rbs_wt[16] < 1.0 && tinf->rbs_wt[13] < 1.0 && tinf->rbs_wt[15] < 1.0
        && (tinf->rbs_wt[0] >= -0.5
            || (tinf->rbs_wt[22] < 2.0 && tinf->rbs_wt[24] < 2.0
                && tinf->rbs_wt[27] < 2.0)))
        tinf->uses_sd = 0;
}

/* shared tail of both trainers: upstream composition -> log scores
 * (reference: lib.pyx:4570-4599) */
static void ups_comp_to_log(training_t *tinf) {
    int i, j;
    double sum;
    for (i = 0; i < 32; i++) {
        sum = 0.0;
        for (j = 0; j < 4; j++) sum += tinf->ups_comp[i][j];
        if (sum == 0.0) {
            for (j = 0; j < 4; j++) tinf->ups_comp[i][j] = 0.0;
        } else {
            for (j = 0; j < 4; j++) {
                tinf->ups_comp[i][j] /= sum;
                if (tinf->gc <= 0.1) {
                    if (j == 0 || j == 3)
                        tinf->ups_comp[i][j] = log(tinf->ups_comp[i][j] * 2.0 / 0.90);
                    else
                        tinf->ups_comp[i][j] = log(tinf->ups_comp[i][j] * 2.0 / 0.10);
                } else if (tinf->gc >= 0.9) {
                    if (j == 0 || j == 3)
                        tinf->ups_comp[i][j] = log(tinf->ups_comp[i][j] * 2.0 / 0.10);
                    else
                        tinf->ups_comp[i][j] = log(tinf->ups_comp[i][j] * 2.0 / 0.90);
                } else {
                    if (j == 0 || j == 3)
                        tinf->ups_comp[i][j] = log(tinf->ups_comp[i][j] * 2.0 / (1.0 - tinf->gc));
                    else
                        tinf->ups_comp[i][j] = log(tinf->ups_comp[i][j] * 2.0 / tinf->gc);
                }
                if (tinf->ups_comp[i][j] > 4.0) tinf->ups_comp[i][j] = 4.0;
                if (tinf->ups_comp[i][j] < -4.0) tinf->ups_comp[i][j] = -4.0;
            }
        }
    }
}

/* pick the better of the two SD detections for a node
 * (reference: lib.pyx:4443-4450) */
static inline int best_rbs(const training_t *tinf, const nodes_t *nd, int j) {
    if (tinf->rbs_wt[nd->rbs0[j]] > tinf->rbs_wt[nd->rbs1[j]] + 1.0 || nd->rbs1[j] == 0)
        return nd->rbs0[j];
    if (tinf->rbs_wt[nd->rbs0[j]] < tinf->rbs_wt[nd->rbs1[j]] - 1.0 || nd->rbs0[j] == 0)
        return nd->rbs1[j];
    return (nd->rbs0[j] > nd->rbs1[j]) ? nd->rbs0[j] : nd->rbs1[j];
}

/* ---- SD start training, 10 iterations (reference: lib.pyx:4391-4599) ---- */
void rc_train_starts_sd(const uint8_t *d, int slen, nodes_t *nd, training_t *tinf) {
    int phase, max_rb;
    int rbs[3], type[3], bndx[3];
    double sum, best[3], tbg[3], treal[3];
    double rbg[28], rreal[28];
    double sthresh = 35.0;
    double wt = tinf->st_wt;
    int64_t i, j;
    int64_t nn = nd->nn;

    for (j = 0; j < 3; j++) tinf->type_wt[j] = 0.0;
    for (j = 0; j < 28; j++) tinf->rbs_wt[j] = 0.0;
    for (i = 0; i < 32; i++)
        for (j = 0; j < 4; j++) tinf->ups_comp[i][j] = 0.0;

    for (i = 0; i < 3; i++) tbg[i] = 0.0;
    for (i = 0; i < nn; i++) {
        if (nd->type[i] == TSTOP) continue;
        tbg[(int)nd->type[i]] += 1.0;
    }
    sum = 0.0;
    for (i = 0; i < 3; i++) sum += tbg[i];
    for (i = 0; i < 3; i++) tbg[i] /= sum;

    for (i = 0; i < 10; i++) {
        /* RBS motif background */
        for (j = 0; j < 28; j++) rbg[j] = 0.0;
        for (j = 0; j < nn; j++) {
            if (nd->type[j] == TSTOP || nd->edge[j]) continue;
            max_rb = best_rbs(tinf, nd, (int)j);
            rbg[max_rb] += 1.0;
        }
        sum = 0.0;
        for (j = 0; j < 28; j++) sum += rbg[j];
        for (j = 0; j < 28; j++) rbg[j] /= sum;

        for (j = 0; j < 28; j++) rreal[j] = 0.0;
        for (j = 0; j < 3; j++) treal[j] = 0.0;

        /* forward strand pass */
        for (j = 0; j < 3; j++) { best[j] = 0.0; bndx[j] = -1; rbs[j] = 0; type[j] = 0; }
        for (j = 0; j < nn; j++) {
            if (nd->type[j] != TSTOP && nd->edge[j]) continue;
            if (nd->strand[j] != 1) continue;
            phase = nd->ndx[j] % 3;
            if (nd->type[j] == TSTOP) {
                if (bndx[phase] >= 0 && best[phase] >= sthresh
                    && nd->ndx[bndx[phase]] % 3 == phase) {
                    rreal[rbs[phase]] += 1.0;
                    treal[type[phase]] += 1.0;
                    if (i == 9)
                        count_upstream_composition(tinf, d, slen, nd->ndx[bndx[phase]], 1);
                }
                best[phase] = 0.0; bndx[phase] = -1; rbs[phase] = 0; type[phase] = 0;
            } else {
                max_rb = best_rbs(tinf, nd, (int)j);
                if (nd->cscore[j] + wt * tinf->rbs_wt[max_rb]
                    + wt * tinf->type_wt[(int)nd->type[j]] >= best[phase]) {
                    best[phase] = nd->cscore[j] + wt * tinf->rbs_wt[max_rb]
                                + wt * tinf->type_wt[(int)nd->type[j]];
                    bndx[phase] = (int)j;
                    type[phase] = nd->type[j];
                    rbs[phase] = max_rb;
                }
            }
        }

        /* reverse strand pass */
        for (j = 0; j < 3; j++) { best[j] = 0.0; bndx[j] = -1; rbs[j] = 0; type[j] = 0; }
        for (j = nn - 1; j >= 0; j--) {
            if (nd->type[j] != TSTOP && nd->edge[j]) continue;
            if (nd->strand[j] != -1) continue;
            phase = nd->ndx[j] % 3;
            if (nd->type[j] == TSTOP) {
                if (bndx[phase] >= 0 && best[phase] >= sthresh
                    && nd->ndx[bndx[phase]] % 3 == phase) {
                    rreal[rbs[phase]] += 1.0;
                    treal[type[phase]] += 1.0;
                    if (i == 9)
                        count_upstream_composition(tinf, d, slen, nd->ndx[bndx[phase]], -1);
                }
                best[phase] = 0.0; bndx[phase] = -1; rbs[phase] = 0; type[phase] = 0;
            } else {
                max_rb = best_rbs(tinf, nd, (int)j);
                if (nd->cscore[j] + wt * tinf->rbs_wt[max_rb]
                    + wt * tinf->type_wt[(int)nd->type[j]] >= best[phase]) {
                    best[phase] = nd->cscore[j] + wt * tinf->rbs_wt[max_rb]
                                + wt * tinf->type_wt[(int)nd->type[j]];
                    bndx[phase] = (int)j;
                    type[phase] = nd->type[j];
                    rbs[phase] = max_rb;
                }
            }
        }

        /* update RBS weights */
        sum = 0.0;
        for (j = 0; j < 28; j++) sum += rreal[j];
        if (sum == 0.0) {
            for (j = 0; j < 28; j++) tinf->rbs_wt[j] = 0.0;
        } else {
            for (j = 0; j < 28; j++) {
                rreal[j] /= sum;
                if (rbg[j] != 0) tinf->rbs_wt[j] = log(rreal[j] / rbg[j]);
                else tinf->rbs_wt[j] = -4.0;
                if (tinf->rbs_wt[j] > 4.0) tinf->rbs_wt[j] = 4.0;
                else if (tinf->rbs_wt[j] < -4.0) tinf->rbs_wt[j] = -4.0;
            }
        }

        /* update type weights */
        sum = 0.0;
        for (j = 0; j < 3; j++) sum += treal[j];
        if (sum == 0.0) {
            for (j = 0; j < 3; j++) tinf->type_wt[j] = 0.0;
        } else {
            for (j = 0; j < 3; j++) {
                treal[j] /= sum;
                if (tbg[j] != 0) tinf->type_wt[j] = log(treal[j] / tbg[j]);
                else tinf->type_wt[j] = -4.0;
                if (tinf->type_wt[j] > 4.0) tinf->type_wt[j] = 4.0;
                else if (tinf->type_wt[j] < -4.0) tinf->type_wt[j] = -4.0;
            }
        }
        if (sum * 2000.0 <= (double)nn) sthresh /= 2.0;
    }

    ups_comp_to_log(tinf);
}

/* ---- non-SD start training, 20 iterations (reference: lib.pyx:4601-4824) */
void rc_train_starts_nonsd(const uint8_t *d, int slen, nodes_t *nd, training_t *tinf) {
    int j, k, l, fr, stage;
    int bndx[3];
    double sum, ngenes, zbg, zreal;
    double best[3], tbg[3], treal[3];
    double sthresh = 35.0;
    double wt = tinf->st_wt;
    int nn = nd->nn;
    int i;

    /* large tables on the heap (per call: training may be invoked from
     * multiple threads; no mutable statics — see re-entrancy invariant) */
    int (*mgood)[4][4096] = malloc(sizeof(int[4][4][4096]));
    double (*mbg)[4][4096] = malloc(sizeof(double[4][4][4096]));
    double (*mreal)[4][4096] = malloc(sizeof(double[4][4][4096]));
    if (!mgood || !mbg || !mreal) {
        free(mgood); free(mbg); free(mreal);
        return;
    }

    for (i = 0; i < 32; i++)
        for (j = 0; j < 4; j++) tinf->ups_comp[i][j] = 0.0;

    for (i = 0; i < 3; i++) { tinf->type_wt[i] = 0.0; tbg[i] = 0.0; }
    for (i = 0; i < nn; i++) {
        if (nd->type[i] == TSTOP) continue;
        tbg[(int)nd->type[i]] += 1.0;
    }
    sum = 0.0;
    for (i = 0; i < 3; i++) sum += tbg[i];
    for (i = 0; i < 3; i++) tbg[i] /= sum;

    for (i = 0; i < 20; i++) {
        stage = (i < 4) ? 0 : (i < 12) ? 1 : 2;

        /* motif background */
        memset(mbg, 0, sizeof(double[4][4][4096]));
        zbg = 0.0;
        for (j = 0; j < nn; j++) {
            if (nd->type[j] == TSTOP || nd->edge[j]) continue;
            find_best_upstream_motif(nd, j, d, slen, tinf, stage);
            update_motif_counts(mbg, &zbg, d, slen, nd, j, stage);
        }
        sum = 0.0;
        for (j = 0; j < 4; j++)
            for (k = 0; k < 4; k++)
                for (l = 0; l < 4096; l++) sum += mbg[j][k][l];
        sum += zbg;
        for (j = 0; j < 4; j++)
            for (k = 0; k < 4; k++)
                for (l = 0; l < 4096; l++) mbg[j][k][l] /= sum;
        zbg /= sum;

        memset(mreal, 0, sizeof(double[4][4][4096]));
        zreal = 0.0;
        for (j = 0; j < 3; j++) treal[j] = 0.0;
        ngenes = 0.0;

        /* forward strand pass */
        for (j = 0; j < 3; j++) { best[j] = 0.0; bndx[j] = -1; }
        for (j = 0; j < nn; j++) {
            if (nd->type[j] != TSTOP && nd->edge[j]) continue;
            if (nd->strand[j] != 1) continue;
            fr = nd->ndx[j] % 3;
            if (nd->type[j] == TSTOP) {
                if (bndx[fr] >= 0 && best[fr] >= sthresh) {
                    ngenes += 1.0;
                    treal[(int)nd->type[bndx[fr]]] += 1.0;
                    update_motif_counts(mreal, &zreal, d, slen, nd, bndx[fr], stage);
                    if (i == 19)
                        count_upstream_composition(tinf, d, slen, nd->ndx[bndx[fr]], 1);
                }
                best[fr] = 0.0;
                bndx[fr] = -1;
            } else {
                if (nd->cscore[j] + wt * nd->mot_score[j]
                    + wt * tinf->type_wt[(int)nd->type[j]] >= best[fr]) {
                    best[fr] = nd->cscore[j] + wt * nd->mot_score[j]
                             + wt * tinf->type_wt[(int)nd->type[j]];
                    bndx[fr] = j;
                }
            }
        }

        /* reverse strand pass */
        for (j = 0; j < 3; j++) { best[j] = 0.0; bndx[j] = -1; }
        for (j = nn - 1; j >= 0; j--) {
            if (nd->type[j] != TSTOP && nd->edge[j]) continue;
            if (nd->strand[j] != -1) continue;
            fr = nd->ndx[j] % 3;
            if (nd->type[j] == TSTOP) {
                if (bndx[fr] >= 0 && best[fr] >= sthresh) {
                    ngenes += 1.0;
                    treal[(int)nd->type[bndx[fr]]] += 1.0;
                    update_motif_counts(mreal, &zreal, d, slen, nd, bndx[fr], stage);
                    if (i == 19)
                        count_upstream_composition(tinf, d, slen, nd->ndx[bndx[fr]], -1);
                }
                best[fr] = 0.0;
                bndx[fr] = -1;
            } else {
                if (nd->cscore[j] + wt * nd->mot_score[j]
                    + wt * tinf->type_wt[(int)nd->type[j]] >= best[fr]) {
                    best[fr] = nd->cscore[j] + wt * nd->mot_score[j]
                             + wt * tinf->type_wt[(int)nd->type[j]];
                    bndx[fr] = j;
                }
            }
        }

        /* update type and motif log-likelihood weights */
        if (stage < 2)
            rc_build_coverage_map(mreal, mgood, ngenes, 2, 0.20);
        sum = 0.0;
        for (j = 0; j < 4; j++)
            for (k = 0; k < 4; k++)
                for (l = 0; l < 4096; l++) sum += mreal[j][k][l];
        sum += zreal;
        if (sum == 0.0) {
            memset(tinf->mot_wt, 0, sizeof(tinf->mot_wt));
            tinf->no_mot = 0.0;
        } else {
            for (j = 0; j < 4; j++)
                for (k = 0; k < 4; k++)
                    for (l = 0; l < 4096; l++) {
                        if (mgood[j][k][l] == 0) {
                            zreal += mreal[j][k][l];
                            zbg += mreal[j][k][l];
                            mreal[j][k][l] = 0.0;
                            mbg[j][k][l] = 0.0;
                        }
                        mreal[j][k][l] /= sum;
                        if (mbg[j][k][l] != 0)
                            tinf->mot_wt[j][k][l] = log(mreal[j][k][l] / mbg[j][k][l]);
                        else
                            tinf->mot_wt[j][k][l] = -4.0;
                        if (tinf->mot_wt[j][k][l] > 4.0) tinf->mot_wt[j][k][l] = 4.0;
                        else if (tinf->mot_wt[j][k][l] < -4.0) tinf->mot_wt[j][k][l] = -4.0;
                    }
        }
        zreal /= sum;
        if (zbg != 0) tinf->no_mot = log(zreal / zbg);
        else tinf->no_mot = -4.0;
        if (tinf->no_mot > 4.0) tinf->no_mot = 4.0;
        else if (tinf->no_mot < -4.0) tinf->no_mot = -4.0;

        sum = 0.0;
        for (j = 0; j < 3; j++) sum += treal[j];
        if (sum == 0.0) {
            for (j = 0; j < 3; j++) tinf->type_wt[j] = 0.0;
        } else {
            for (j = 0; j < 3; j++) {
                treal[j] /= sum;
                if (tbg[j] != 0) tinf->type_wt[j] = log(treal[j] / tbg[j]);
                else tinf->type_wt[j] = -4.0;
                if (tinf->type_wt[j] > 4.0) tinf->type_wt[j] = 4.0;
                else if (tinf->type_wt[j] < -4.0) tinf->type_wt[j] = -4.0;
            }
        }
        if (sum * 2000.0 <= nn) sthresh /= 2.0;
    }

    ups_comp_to_log(tinf);
    free(mgood);
    free(mbg);
    free(mreal);
}

/* ==========================================================================
 * Bin-independent precompute for the device (TPU) scoring pipeline.
 *
 * Meta mode scores every candidate model (bin) over the same node geometry;
 * everything below depends only on (sequence, translation table, geometry),
 * so it is computed ONCE per contig and shipped to the device, where the
 * per-bin scoring (reference: lib.pyx:2331-2487) becomes pure gathers and
 * elementwise selects over these index tensors.
 * ========================================================================== */

/* -- SD candidate masks ----------------------------------------------------
 * The Shine-Dalgarno scorers (reference: lib.pyx:791-979) pick, at one
 * window position, the motif index maximising (rbs_wt[v], v) over the
 * candidates their loops enumerate.  The candidate SET is sequence-only;
 * record it as a 28-bit mask per (node, window position) so the device can
 * replay the lexicographic argmax under any bin's rbs_wt. */

static int32_t sd_exact_cand_mask(const uint8_t *d, int slen, int pos,
                                  int start, int strand) {
    int i, j, k, rdis, limit, cur_val, cur_ctr, dis_flag;
    int match[6] = { -10, -10, -10, -10, -10, -10 };
    int32_t mask = 0;

    limit = start - 4 - pos;
    if (limit > 6) limit = 6;

    for (i = 0; i < limit; i++) {
        if (pos + i >= 0 && pos + i < slen) {
            if (i % 3 == 0) { if (is_a(d, slen, pos + i, strand)) match[i] = 2; }
            else            { if (is_g(d, slen, pos + i, strand)) match[i] = 3; }
        }
    }
    for (i = limit; i >= 3; i--) {
        for (j = 0; j <= limit - i; j++) {
            cur_ctr = -2;
            for (k = j; k < j + i; k++) cur_ctr += match[k];
            if (cur_ctr < 6) continue;
            rdis = start - (pos + j + i);
            if      (rdis < 5)  dis_flag = (i < 5) ? 2 : 1;
            else if (rdis < 11) dis_flag = 0;
            else if (rdis < 13) dis_flag = (i < 5) ? 1 : 2;
            else if (rdis < 16) dis_flag = 3;
            else continue;
            switch (cur_ctr) {
                case 6:  cur_val = (int[]){13, 6, 1, 2}[dis_flag]; break;
                case 8:  cur_val = (int[]){15, 12, 11, 3}[dis_flag]; break;
                case 9:  cur_val = (int[]){16, 12, 11, 3}[dis_flag]; break;
                case 11: cur_val = (int[]){22, 21, 20, 10}[dis_flag]; break;
                case 12: cur_val = (int[]){24, 23, 20, 10}[dis_flag]; break;
                case 14: cur_val = (int[]){27, 26, 25, 10}[dis_flag]; break;
                default: cur_val = 0; break;
            }
            mask |= (int32_t)1 << cur_val;
        }
    }
    return mask;
}

static int32_t sd_mm_cand_mask(const uint8_t *d, int slen, int pos,
                               int start, int strand) {
    int i, j, k, mism, rdis, limit, cur_val, cur_ctr, dis_flag;
    int match[6];
    int32_t mask = 0;

    limit = start - 4 - pos;
    if (limit > 6) limit = 6;

    for (i = 0; i < 6; i++) match[i] = -10;
    for (i = 0; i < limit; i++) {
        if (pos + i >= 0 && pos + i < slen) {
            if (i % 3 == 0) match[i] = is_a(d, slen, pos + i, strand) ? 2 : -3;
            else            match[i] = is_g(d, slen, pos + i, strand) ? 3 : -2;
        } else {
            match[i] = (i % 3 == 0) ? -3 : -2;
        }
    }
    for (i = limit; i >= 5; i--) {
        for (j = 0; j <= limit - i; j++) {
            cur_ctr = -2;
            mism = 0;
            for (k = j; k < j + i; k++) {
                cur_ctr += match[k];
                if (match[k] < 0) {
                    mism += 1;
                    if (k <= j + 1 || k >= j + i - 2) cur_ctr -= 10;
                }
            }
            if (mism != 1 || cur_ctr < 6) continue;
            rdis = start - (pos + j + i);
            if      (rdis < 5)  dis_flag = 1;
            else if (rdis < 11) dis_flag = 0;
            else if (rdis < 13) dis_flag = 2;
            else if (rdis < 16) dis_flag = 3;
            else continue;
            switch (cur_ctr) {
                case 6: cur_val = (int[]){9, 5, 4, 2}[dis_flag]; break;
                case 7: cur_val = (int[]){14, 8, 7, 2}[dis_flag]; break;
                case 9: cur_val = (int[]){19, 18, 17, 3}[dis_flag]; break;
                default: continue;
            }
            mask |= (int32_t)1 << cur_val;
        }
    }
    return mask;
}

/* exact_mask/mm_mask: nn*15 int32, window position p maps to the scan
 * position of rc_rbs_score (reference: lib.pyx:2241-2277); positions
 * outside the sequence carry mask 0 (they are skipped by the scan). */
void rc_rbs_candidates(const uint8_t *d, int slen, const nodes_t *nd,
                       int32_t *exact_mask, int32_t *mm_mask) {
    int i, j, p;
    for (i = 0; i < nd->nn; i++) {
        for (p = 0; p < 15; p++)
            exact_mask[i * 15 + p] = mm_mask[i * 15 + p] = 0;
        if (nd->type[i] == TSTOP || nd->edge[i]) continue;
        if (nd->strand[i] == 1) {
            for (p = 0, j = nd->ndx[i] - 20; j < nd->ndx[i] - 5; j++, p++) {
                if (j < 0) continue;
                exact_mask[i * 15 + p] =
                    sd_exact_cand_mask(d, slen, j, nd->ndx[i], 1);
                mm_mask[i * 15 + p] =
                    sd_mm_cand_mask(d, slen, j, nd->ndx[i], 1);
            }
        } else {
            int start = slen - 1 - nd->ndx[i];
            for (p = 0, j = slen - nd->ndx[i] - 21;
                 j < slen - nd->ndx[i] - 6; j++, p++) {
                if (j >= slen) continue;
                exact_mask[i * 15 + p] =
                    sd_exact_cand_mask(d, slen, j, start, -1);
                mm_mask[i * 15 + p] = sd_mm_cand_mask(d, slen, j, start, -1);
            }
        }
    }
}

/* -- upstream composition mers ---------------------------------------------
 * mers: nn*32 int8, slot order of score_upstream_composition
 * (reference: lib.pyx:1618-1650): slots 0-1 = positions -1,-2; slots 2-31 =
 * positions -15..-44; -1 where the position falls off the sequence. */
void rc_ups_mers(const uint8_t *d, int slen, const nodes_t *nd, int8_t *mers) {
    int i, k, start, strand, count;
    for (i = 0; i < nd->nn; i++) {
        for (k = 0; k < 32; k++) mers[i * 32 + k] = -1;
        if (nd->type[i] == TSTOP) continue;
        if (nd->strand[i] == 1) { start = nd->ndx[i]; strand = 1; }
        else { start = slen - 1 - nd->ndx[i]; strand = -1; }
        count = 0;
        for (k = 1; k < 3; k++) {
            if (k > start) break;
            mers[i * 32 + count] =
                (int8_t)mer_ndx(d, slen, start - k, 1, strand);
            count++;
        }
        count = 2;
        for (k = 15; k < 45; k++) {
            if (k > start) break;
            mers[i * 32 + count] =
                (int8_t)mer_ndx(d, slen, start - k, 1, strand);
            count++;
        }
    }
}

/* -- upstream motif candidates (non-SD bins) --------------------------------
 * midx: nn*52 int32 = flat mot_wt index (len_i*16384 + spacendx*4096 + mer)
 * per candidate, in the exact scan order of find_best_upstream_motif
 * (reference: lib.pyx:1556-1616): i = 3..0 (motif length 6..3), j ascending
 * over the 13 window positions; -1 where j < 0 or for stop/edge nodes. */
void rc_motif_candidates(const uint8_t *d, int slen, const nodes_t *nd,
                         int32_t *midx) {
    int n, i, j, s, start, spacendx, index;
    for (n = 0; n < nd->nn; n++) {
        for (s = 0; s < 52; s++) midx[n * 52 + s] = -1;
        if (nd->type[n] == TSTOP || nd->edge[n]) continue;
        start = (nd->strand[n] == 1) ? nd->ndx[n] : slen - 1 - nd->ndx[n];
        for (i = 3; i >= 0; i--) {
            for (j = start - 18 - i, s = 0; j < start - 5 - i; j++, s++) {
                if (j < 0) continue;
                if      (j <= start - 16 - i) spacendx = 3;
                else if (j <= start - 14 - i) spacendx = 2;
                else if (j >= start - 7 - i)  spacendx = 1;
                else                          spacendx = 0;
                index = mer_ndx(d, slen, j, i + 3, nd->strand[n]);
                midx[n * 52 + (3 - i) * 13 + s] =
                    i * 16384 + spacendx * 4096 + index;
            }
        }
    }
}

/* -- SD candidate-mask lookup tables -----------------------------------------
 * The mask functions above depend only on the 6 bases at the scan position
 * (A/G membership — hence only on the 6-mer code, with N folding to C like
 * mer_ndx does) and on the distance start-pos in [6, 20].  Tabulate both
 * masks as (15, 4096) tables so the device derives every node's candidate
 * masks from the on-device 6-mer code arrays with two gathers. */
void rc_sd_cand_luts(int32_t *ex, int32_t *mm) {
    memcpy(ex, SD_EX_LUT, sizeof(SD_EX_LUT));
    memcpy(mm, SD_MM_LUT, sizeof(SD_MM_LUT));
}

/* -- star-pointer candidate lists -------------------------------------------
 * For every stop node, the start nodes its flag=1 overlapping-start scan
 * (reference: lib.pyx:2279-2329) would visit, in exact scan order.  The
 * conditions are geometry-only; the device replays the global-running-max
 * selection with per-bin scores.  Returns the largest candidate count seen
 * (callers fall back to the host path when it exceeds K). */
int rc_star_candidates(const nodes_t *nd, int max_sam_overlap, int K,
                       int32_t *cands) {
    int i, j, k, maxk = 0;
    int nn = nd->nn;
    for (i = 0; i < nn; i++) {
        for (k = 0; k < K; k++) cands[i * K + k] = -1;
        if (nd->type[i] != TSTOP || nd->edge[i] == 1) continue;
        k = 0;
        if (nd->strand[i] == 1) {
            for (j = i + 3; j >= 0; j--) {
                if (j >= nn || nd->ndx[j] > nd->ndx[i] + 2) continue;
                if (nd->ndx[j] + max_sam_overlap < nd->ndx[i]) break;
                if (nd->strand[j] == 1 && nd->type[j] != TSTOP) {
                    if (nd->stop_val[j] <= nd->ndx[i]) continue;
                    if (k < K) cands[i * K + k] = j;
                    k++;
                }
            }
        } else {
            for (j = i - 3; j < nn; j++) {
                if (j < 0 || nd->ndx[j] < nd->ndx[i] - 2) continue;
                if (nd->ndx[j] - max_sam_overlap > nd->ndx[i]) break;
                if (nd->strand[j] == -1 && nd->type[j] != TSTOP) {
                    if (nd->stop_val[j] >= nd->ndx[i]) continue;
                    if (k < K) cands[i * K + k] = j;
                    k++;
                }
            }
        }
        if (k > maxk) maxk = k;
    }
    return maxk;
}

/* -- real-stop flags --------------------------------------------------------
 * Whether each node's stop codon is a real stop under the translation
 * table (the edge_gene test of rc_score_nodes). */
void rc_stop_real(const uint8_t *d, int slen, const nodes_t *nd, int tt,
                  uint8_t *out) {
    int i;
    for (i = 0; i < nd->nn; i++) {
        if (nd->strand[i] == 1)
            out[i] = (uint8_t)is_stop(d, slen, nd->stop_val[i], tt, 1);
        else
            out[i] = (uint8_t)is_stop(d, slen, slen - 1 - nd->stop_val[i],
                                      tt, -1);
    }
}

/* -- edge-upstream penalty flags --------------------------------------------
 * Which start nodes receive the EDGE_UPS upstream penalty in
 * rc_score_nodes.  The forward scan can observe edge flags already mutated
 * for earlier nodes in the same scoring pass (near-boundary starts are
 * promoted to edge), so the mutation is simulated here in scan order. */
void rc_edge_ups_flags(const nodes_t *nd, int slen, int closed,
                       uint8_t *flags) {
    int i, j;
    int nn = nd->nn;
    uint8_t *eff = (uint8_t *)malloc((size_t)(nn > 0 ? nn : 1));
    if (!eff) return;
    for (i = 0; i < nn; i++) eff[i] = nd->edge[i];

    for (i = 0; i < nn; i++) {
        flags[i] = 0;
        if (nd->type[i] == TSTOP) continue;
        if (nd->edge[i]) { /* edge starts skip the uscore block entirely */
            /* still apply the mutation bookkeeping order: none needed */
        } else if (!closed && nd->ndx[i] <= 2 && nd->strand[i] == 1) {
            flags[i] = 1;
        } else if (!closed && nd->ndx[i] >= slen - 3 && nd->strand[i] == -1) {
            flags[i] = 1;
        } else if (i < 500 && nd->strand[i] == 1) {
            for (j = i - 1; j >= 0; j--) {
                if (eff[j] && nd->stop_val[i] == nd->stop_val[j]) {
                    flags[i] = 1;
                    break;
                }
            }
        } else if (i + 500 >= nn && nd->strand[i] == -1) {
            for (j = i + 1; j < nn; j++) {
                /* forward in index order: mutations have not yet applied */
                if (nd->edge[j] && nd->stop_val[i] == nd->stop_val[j]) {
                    flags[i] = 1;
                    break;
                }
            }
        }
        /* simulate the near-boundary edge promotion for later scans */
        if (!closed && !nd->edge[i]
            && ((nd->ndx[i] <= 2 && nd->strand[i] == 1)
                || (nd->ndx[i] >= slen - 3 && nd->strand[i] == -1)))
            eff[i] = 1;
    }
    free(eff);
}

/* ---- one bin's exact re-run, in two calls (meta-mode finishing) ---------
 * A node block holds a nodes_t's arrays for nn nodes in one allocation, in
 * the struct's field order, each array on an 8-byte boundary
 * (rc_node_block_layout).  rc_run_bin and rc_finish_bin only compose the
 * entry points above, in the order the chain of `Nodes` and `Genes`
 * methods calls them, so their nodes and genes are that chain's; from
 * Python each is one foreign call, which holds no interpreter lock. */
#define RC_NODE_ARRAYS(X)                                                    \
    X(ndx, 1) X(stop_val, 1) X(type, 1) X(strand, 1) X(edge, 1) X(elim, 1)  \
    X(gc_bias, 1) X(ov_mark, 1) X(rbs0, 1) X(rbs1, 1) X(mot_ndx, 1)         \
    X(mot_len, 1) X(mot_spacer, 1) X(mot_spacendx, 1) X(mot_score, 1)       \
    X(gc_score, 3) X(gc_cont, 1) X(cscore, 1) X(uscore, 1) X(tscore, 1)     \
    X(rscore, 1) X(sscore, 1) X(score, 1) X(star_ptr, 3) X(traceb, 1)       \
    X(tracef, 1)

/* The block's byte offset of each array, in field order, then its size,
 * into `off` (27 entries) when it is not NULL; returns the size. */
int64_t rc_node_block_layout(int nn, int64_t *off) {
    int64_t o = 0;
    int k = 0;
#define X(f, w)                                                              \
    if (off) off[k] = o;                                                     \
    k++;                                                                     \
    o += ((int64_t)nn * (w) * (int64_t)sizeof(*((nodes_t *)0)->f) + 7)      \
         & ~(int64_t)7;
    RC_NODE_ARRAYS(X)
#undef X
    if (off) off[k] = o;
    return o;
}

static void bind_block(nodes_t *nd, uint8_t *block, int nn) {
    int64_t off[32];
    int k = 0;
    rc_node_block_layout(nn, off);
#define X(f, w) nd->f = (void *)(block + off[k++]);
    RC_NODE_ARRAYS(X)
#undef X
    nd->nn = nd->capacity = nn;
}

static void copy_nodes(nodes_t *dst, const nodes_t *src) {
    size_t n = (size_t)src->nn;
#define X(f, w) memcpy(dst->f, src->f, n * (w) * sizeof(*src->f));
    RC_NODE_ARRAYS(X)
#undef X
}

/* One bin from prep's nodes `src` (read only): copy them into the block
 * `work`, reset, score (meta), record the overlapping starts, copy the
 * scored nodes into the block `snap` (the per-gene scores the writers
 * print), then the final DP on `work`.  Both blocks hold src->nn nodes.
 * Returns the path's end, or -1 without one; its score into *path_score. */
int rc_run_bin(const nodes_t *src, uint8_t *work, uint8_t *snap,
               const uint8_t *d, int slen, const training_t *tinf,
               int closed, int max_sam_overlap, double *path_score) {
    nodes_t w, s;
    int ipath;

    *path_score = 0.0;
    if (src->nn == 0) return -1;
    bind_block(&w, work, src->nn);
    bind_block(&s, snap, src->nn);
    copy_nodes(&w, src);
    rc_reset_node_scores(&w);
    rc_score_nodes(d, slen, &w, tinf, closed, 1);
    rc_record_overlapping_starts(&w, tinf, 1, max_sam_overlap);
    copy_nodes(&s, &w);
    ipath = rc_dynamic_programming(&w, tinf, 1);
    if (ipath >= 0) *path_score = w.score[ipath];
    return ipath;
}

/* The winner's genes from its `work` block after rc_run_bin: eliminate the
 * path's bad genes, extract the genes into the caller's arrays of `cap`
 * entries, tweak their starts.  A path holds fewer genes than nodes, so
 * `cap` >= nn always suffices; with less it returns -nn and touches
 * nothing.  Returns the gene count. */
int rc_finish_bin(uint8_t *work, int nn, int ipath, const training_t *tinf,
                  int max_sam_overlap, int32_t *g_begin, int32_t *g_end,
                  int32_t *g_start_ndx, int32_t *g_stop_ndx, int cap) {
    nodes_t w;
    int ng;

    if (cap < nn) return -nn;
    bind_block(&w, work, nn);
    if (nn > 0) rc_eliminate_bad_genes(&w, ipath, tinf);
    ng = rc_extract_genes(&w, ipath, g_begin, g_end, g_start_ndx, g_stop_ndx,
                          cap);
    if (ng < 0) return ng;
    rc_tweak_final_starts(&w, ng, g_begin, g_end, g_start_ndx, g_stop_ndx,
                          tinf, max_sam_overlap);
    return ng;
}
