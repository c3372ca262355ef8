"""Prodigal's meta mode in plain NumPy, for the best path score of every
(contig, candidate bin): the number that the port's device launches
compute in float32 and the benchmark holds them to.

Written from Prodigal v2.6.3's algorithm as pyrodigal runs it (node.c,
dprog.c, sequence.c; Hyatt et al. 2010, BMC Bioinformatics 11:119):

* nodes: every start and stop codon of every open reading frame on both
  strands (`extract_nodes`), sorted by position, forward strand first;
* node scores: the hexamer coding score with its length factor, the
  start's type, its ribosome binding site (Shine-Dalgarno motifs, or the
  bin's upstream motifs) and upstream composition, and the edge and
  short-contig rules of meta mode (`score_nodes`);
* the overlapping starts each stop can take (`overlapping_starts`);
* the final dynamic programme over the nodes (`_dp`, `meta_run`), in
  which each node takes the best connection from the nodes of its
  window; `writer.py` reads the chosen bin's genes from it.

It shares no code with the port or with its exact C engine: every rule
is evaluated here as array arithmetic in float64, all candidate bins of
a contig at once.  It supports the configuration's options only: open
ends (`closed=False`), no masking, `min_gene`, `min_edge_gene` and
`max_overlap` as given.
"""

import math

import numpy as np

A, G, C, T, N = 0, 1, 2, 3, 6
ATG, GTG, TTG, STOP = 0, 1, 2, 3
EDGE_BONUS, EDGE_UPS, META_PEN = 0.74, -1.00, 7.5
OPER_DIST, MAX_OPP_OVLP, MAX_NODE_DIST = 60, 200, 500

_DIGITS = np.full(256, N, np.uint8)
for _letters, _d in ((b"Aa", A), (b"Gg", G), (b"Cc", C), (b"Tt", T)):
    for _c in _letters:
        _DIGITS[_c] = _d
_COMPL = np.full(256, N, np.uint8)
_COMPL[[A, G, C, T]] = [T, C, G, A]

# stop codons TAA, TAG, TGA by translation table (NCBI genetic codes)
_TAA = [0, 1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 0, 0, 0, 0, 1, 1,
        1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0]
_TAG = [0, 1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0,
        1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1]
_TGA = [0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 1,
        1, 0, 0, 1, 0, 0, 1, 1, 0, 1, 0]

# the training struct's fields: (name, byte offset, dtype, shape)
_FIELDS = (("gc", 0, "<f8", ()), ("tt", 8, "<i4", ()),
           ("st_wt", 16, "<f8", ()), ("bias", 24, "<f8", (3,)),
           ("type_wt", 48, "<f8", (3,)), ("uses_sd", 72, "<i4", ()),
           ("rbs_wt", 80, "<f8", (28,)), ("ups_comp", 304, "<f8", (32, 4)),
           ("mot_wt", 1328, "<f8", (4, 4, 4096)),
           ("no_mot", 525616, "<f8", ()), ("gene_dc", 525624, "<f8", (4096,)))
STRUCT_SIZE = 558392


class Bin:
    """One model: the fields of Prodigal's training struct, read from its
    raw bytes."""

    def __init__(self, raw, description=""):
        raw = bytes(raw)
        if len(raw) != STRUCT_SIZE:
            raise ValueError(f"a training struct has {STRUCT_SIZE} bytes, "
                             f"not {len(raw)}")
        for name, off, dtype, shape in _FIELDS:
            count = int(np.prod(shape)) if shape else 1
            a = np.frombuffer(raw, dtype, count, off).reshape(shape)
            setattr(self, name, a.item() if shape == () else a.copy())
        self.uses_sd = bool(self.uses_sd)
        self.description = description


def load_bins(path):
    """The bins of an `.npz` with `descriptions` and raw `structs`."""
    with np.load(path, allow_pickle=False) as z:
        return [Bin(s.tobytes(), str(d))
                for d, s in zip(z["descriptions"], z["structs"])]


def digits(seq):
    """A str of bases as digits A0 G1 C2 T3, anything else N6."""
    return _DIGITS[np.frombuffer(seq.encode("ascii", "replace"), np.uint8)]


def gc_share(d):
    return float(np.count_nonzero((d == G) | (d == C))) / len(d) \
        if len(d) else 0.0


def candidates(gc, bins):
    """Bins whose GC lies in the contig's window, in order."""
    low = min(0.65, 0.88495 * gc - 0.0102337)
    high = max(0.35, 0.86596 * gc + 0.1131991)
    return [i for i, b in enumerate(bins) if low <= b.gc <= high]


# -- nodes ----------------------------------------------------------------

def _codon_flags(s, tt):
    """(stop, start, first base) at each position 0..len(s)-3 of a
    strand read 5' to 3'."""
    x0, x1, x2 = s[:-2], s[1:-1], s[2:]
    t0 = x0 == T
    stop = ((t0 & (x1 == A) & (x2 == G) & bool(_TAG[tt]))
            | (t0 & (x1 == G) & (x2 == A) & bool(_TGA[tt]))
            | (t0 & (x1 == A) & (x2 == A) & bool(_TAA[tt])))
    if tt == 2:
        stop |= (x0 == A) & (x1 == G) & ((x2 == A) | (x2 == G))
    elif tt == 22:
        stop |= t0 & (x1 == C) & (x2 == A)
    elif tt == 23:
        stop |= t0 & (x1 == T) & (x2 == A)
    tg = (x1 == T) & (x2 == G)
    start = (x0 == A) & tg
    if tt not in (6, 10, 14, 15, 16, 2):
        if tt not in (1, 3, 12):
            start |= (x0 == G) & tg
        if not (tt < 4 or tt == 9 or 21 <= tt < 25):
            start |= t0 & tg
    return stop, start, x0


def _strand_nodes(s, tt, min_gene, min_edge_gene):
    """Nodes of one strand in its own 5'->3' coordinates: (pos, type,
    stop_val, edge) lists.  A start's stop_val is its reading frame's
    downstream stop (or the last codon, where the frame runs off the
    end); a stop's, the frame's upstream stop (or f - 6 at the start)."""
    slen = len(s)
    out = ([], [], [], [])
    if slen < 3:
        return out
    stop, start, first = _codon_flags(s, tt)
    for f in range(3):
        pos = np.arange(f, slen - 2, 3)
        if not len(pos):
            continue
        st, sa = stop[pos], start[pos]
        stops = pos[st]
        last0 = int(pos[-1])
        k = np.searchsorted(stops, pos, side="right")
        real = k < len(stops)
        down = np.where(real, stops[np.minimum(k, max(len(stops) - 1, 0))]
                        if len(stops) else 0, last0)
        mind = np.where(real, min_gene, min_edge_gene)
        reg = ~st & sa & (down - pos + 3 >= mind)
        edge = (pos == f) & ~st & ~reg & (down - pos > min_edge_gene)
        is_start = reg | edge
        sp = pos[is_start]
        b = first[sp]
        out[0].append(sp)
        out[1].append(np.where(edge[is_start], ATG,
                               np.where(b == A, ATG,
                                        np.where(b == T, TTG, GTG))))
        out[2].append(down[is_start])
        out[3].append(edge[is_start].astype(np.uint8))
        orfs = np.unique(k[is_start])
        sndx = np.where(orfs < len(stops),
                        stops[np.minimum(orfs, max(len(stops) - 1, 0))]
                        if len(stops) else 0, last0)
        up = np.where(orfs > 0, stops[np.maximum(orfs - 1, 0)]
                      if len(stops) else 0, f - 6)
        out[0].append(sndx)
        out[1].append(np.full(len(orfs), STOP))
        out[2].append(up)
        out[3].append((orfs >= len(stops)).astype(np.uint8))
    return out


class Nodes:
    """The nodes of a contig for one translation table, sorted by
    position, forward strand first: arrays `ndx`, `typ`, `strand`,
    `stop_val`, `edge`."""

    def __init__(self, d, tt, min_gene, min_edge_gene):
        slen = len(d)
        rc = _COMPL[d[::-1]]
        parts = []
        for strand, s in ((1, d), (-1, rc)):
            p, ty, sv, ed = (np.concatenate(x).astype(np.int64) if x
                             else np.zeros(0, np.int64)
                             for x in _strand_nodes(s, tt, min_gene,
                                                    min_edge_gene))
            if strand == -1:
                p, sv = slen - 1 - p, slen - 1 - sv
            parts.append((p, ty, np.full(len(p), strand), sv, ed))
        ndx, typ, strand, sv, edge = (np.concatenate(x) for x in zip(*parts))
        order = np.lexsort((-strand, ndx))
        self.ndx = ndx[order]
        self.typ = typ[order]
        self.strand = strand[order]
        self.stop_val = sv[order]
        self.edge = edge[order].astype(bool)
        self.n = len(self.ndx)
        self.slen = slen
        self.tt = tt


# -- node scores ----------------------------------------------------------

def _mers(s, k):
    """The k-mer index at each position of a strand (2 bits a base, the
    first base lowest; N counts as C), for positions 0..len-k."""
    b = (s & 3).astype(np.int64)
    m = len(s) - k + 1
    if m <= 0:
        return np.zeros(0, np.int64)
    idx = np.zeros(m, np.int64)
    for j in range(k):
        idx |= b[j:j + m] << (2 * j)
    return idx


def _sd_tables():
    """For each spacing 6..20 (start - scan position) and each 6-mer code
    of the scan window (2 bits a base; anything not A or G read as C),
    the Shine-Dalgarno motif classes found, as bit masks over the 28
    classes: (exact (15, 4096), one mismatch (15, 4096))."""
    codes = np.arange(4096)
    base = [(codes >> (2 * j)) & 3 for j in range(6)]
    ex = np.zeros((15, 4096), np.int64)
    mm = np.zeros((15, 4096), np.int64)
    ex_val = {6: (13, 6, 1, 2), 8: (15, 12, 11, 3), 9: (16, 12, 11, 3),
              11: (22, 21, 20, 10), 12: (24, 23, 20, 10),
              14: (27, 26, 25, 10)}
    mm_val = {6: (9, 5, 4, 2), 7: (14, 8, 7, 2), 9: (19, 18, 17, 3)}
    for sp in range(6, 21):
        limit = min(sp - 4, 6)
        mex = [np.where(base[i] == (A if i % 3 == 0 else G),
                        2 if i % 3 == 0 else 3, -10) if i < limit
               else np.full(4096, -10) for i in range(6)]
        mmm = [np.where(base[i] == (A if i % 3 == 0 else G),
                        2 if i % 3 == 0 else 3,
                        -3 if i % 3 == 0 else -2) if i < limit
               else np.full(4096, -10) for i in range(6)]
        for ln in range(limit, 2, -1):
            for j in range(0, limit - ln + 1):
                ctr = -2 + sum(mex[k] for k in range(j, j + ln))
                rdis = sp - (j + ln)
                if rdis < 5:
                    flag = 2 if ln < 5 else 1
                elif rdis < 11:
                    flag = 0
                elif rdis < 13:
                    flag = 1 if ln < 5 else 2
                elif rdis < 16:
                    flag = 3
                else:
                    continue
                val = np.zeros(4096, np.int64)
                for c, v in ex_val.items():
                    val[ctr == c] = v[flag]
                ex[sp - 6] |= np.where(ctr >= 6, 1 << val, 0)
        for ln in range(limit, 4, -1):
            for j in range(0, limit - ln + 1):
                ctr = np.full(4096, -2)
                mism = np.zeros(4096, np.int64)
                for k in range(j, j + ln):
                    ctr = ctr + mmm[k]
                    bad = mmm[k] < 0
                    mism += bad
                    if k <= j + 1 or k >= j + ln - 2:
                        ctr = ctr - 10 * bad
                rdis = sp - (j + ln)
                if rdis < 5:
                    flag = 1
                elif rdis < 11:
                    flag = 0
                elif rdis < 13:
                    flag = 2
                elif rdis < 16:
                    flag = 3
                else:
                    continue
                ok = (mism == 1) & (ctr >= 6)
                for c, v in mm_val.items():
                    mm[sp - 6] |= np.where(ok & (ctr == c), 1 << v[flag], 0)
    return ex, mm


_SD = None
_PICKS = {}


def _sd_pick(masks, wt):
    """The class each mask picks: the highest weight, ties to the higher
    class, class 0 (no motif) if nothing beats it."""
    best = np.zeros(masks.shape, np.int64)
    bw = np.full(masks.shape, wt[0])
    for v in range(1, 28):
        has = (masks >> v) & 1 == 1
        better = has & ((wt[v] > bw) | ((wt[v] == bw) & (v > best)))
        best = np.where(better, v, best)
        bw = np.where(better, wt[v], bw)
    return best


def _rbs_codes(s, pos, strand):
    """The scan windows of starts at strand positions `pos`: (codes (15,
    m), used (15, m)) for the scan positions pos-20 .. pos-6, each the
    6-mer code of its window (anything not A or G, or off the contig,
    read as C)."""
    slen = len(s)
    b = np.where(s < 4, s, 2).astype(np.int64)
    codes = np.zeros((15, len(pos)), np.int64)
    used = np.zeros((15, len(pos)), bool)
    for p in range(15):
        j = pos - 20 + p
        for k in range(6):
            q = j + k
            inside = (q >= 0) & (q < slen)
            codes[p] |= np.where(inside, b[np.clip(q, 0, slen - 1)], 2) \
                << (2 * k)
        used[p] = (j >= 0) if strand == 1 else (j < slen)
    return codes, used


def _rbs(codes, used, wt):
    """(exact, mismatch) motif classes of starts: the largest class
    picked over their scan positions."""
    global _SD
    if _SD is None:
        _SD = _sd_tables()
    key = wt.tobytes()
    if key not in _PICKS:
        _PICKS[key] = (_sd_pick(_SD[0], wt)[::-1], _sd_pick(_SD[1], wt)[::-1])
    pick_ex, pick_mm = _PICKS[key]
    rows = np.arange(15)[:, None]
    r0 = np.where(used, pick_ex[rows, codes], 0).max(0, initial=0)
    r1 = np.where(used, pick_mm[rows, codes], 0).max(0, initial=0)
    return r0, r1


def _motif(s, pos, bn):
    """The best upstream motif of starts at strand positions `pos` (non-SD
    bins), the first best in scan order: (score, k-mer index, length,
    spacer), or the bin's no-motif score and zeros where none is good."""
    slen = len(s)
    b = (s & 3).astype(np.int64)
    best = np.full(len(pos), -100.0)
    m_idx = np.zeros(len(pos), np.int64)
    m_len = np.zeros(len(pos), np.int64)
    m_sp = np.zeros(len(pos), np.int64)
    for i in range(3, -1, -1):
        ln = i + 3
        for off in range(18 + i, 5 + i, -1):
            j = pos - off
            ok = j >= 0
            jj = np.clip(j, 0, slen - ln)
            idx = np.zeros(len(pos), np.int64)
            for k in range(ln):
                idx |= b[jj + k] << (2 * k)
            if off >= 16 + i:
                spn = 3
            elif off >= 14 + i:
                spn = 2
            elif off <= 7 + i:
                spn = 1
            else:
                spn = 0
            sc = bn.mot_wt[i, spn][idx]
            up = ok & (sc > best)
            best = np.where(up, sc, best)
            m_idx = np.where(up, idx, m_idx)
            m_len = np.where(up, ln, m_len)
            m_sp = np.where(up, off - ln, m_sp)
    weak = (best == -4.0) | (best < bn.no_mot + 0.69)
    return (np.where(weak, bn.no_mot, best), np.where(weak, 0, m_idx),
            np.where(weak, 0, m_len), np.where(weak, 0, m_sp))


_UPS_OFFSETS = np.array([1, 2] + list(range(15, 45)))


def _upstream_mers(s, pos):
    """The bases upstream of starts at strand positions pos: (mers (32,
    m), used (32, m))."""
    b = (s & 3).astype(np.int64)
    q = pos[None, :] - _UPS_OFFSETS[:, None]
    return b[np.clip(q, 0, len(s) - 1)], _UPS_OFFSETS[:, None] <= pos[None, :]


def _upstream(mers, used, bn):
    """The upstream composition score, summed in Prodigal's order."""
    terms = np.where(used, 0.4 * bn.st_wt
                     * bn.ups_comp[np.arange(32)[:, None], mers], 0.0)
    return np.cumsum(terms, 0)[-1] if len(terms) else np.zeros(0)


class Scores:
    """Node scores under each candidate bin, (B, n) arrays: `cs` coding,
    `ss` start, `rs` RBS, `us` upstream, and `sw` (B,) start weights."""


def _orf_groups(nd):
    """For each strand: its start nodes grouped by reading frame, each
    group in 5'->3' order (longest gene first), as (node indices, group
    id, rank within group)."""
    out = []
    for strand in (1, -1):
        sel = np.flatnonzero((nd.strand == strand) & (nd.typ != STOP))
        key = nd.stop_val[sel]
        order = np.lexsort((nd.ndx[sel] * strand, key))
        sel = sel[order]
        key = key[order]
        new = np.r_[True, key[1:] != key[:-1]] if len(sel) else \
            np.zeros(0, bool)
        gid = np.cumsum(new) - 1
        first = np.flatnonzero(new)
        rank = np.arange(len(sel)) - first[gid] if len(sel) else \
            np.zeros(0, np.int64)
        out.append((sel, gid, rank))
    return out


def _excl_running_max(vals, rank, init):
    """Per group (rows in group order, `rank` 0 at each group's first),
    the maximum of `init` and the values before each row: (B, m)."""
    out = np.full(vals.shape, init)
    if not vals.shape[1]:
        return out
    for r in range(1, int(rank.max()) + 1):
        at = np.flatnonzero(rank == r)
        out[:, at] = np.maximum(out[:, at - 1], vals[:, at - 1])
    return out


def score_nodes(d, nd, bins, is_meta=True):
    """Prodigal's node scores for every node under each bin of `bins`."""
    slen = nd.slen
    B, n = len(bins), nd.n
    sc = Scores()
    sc.sw = np.array([b.st_wt for b in bins])
    cs = np.zeros((B, n))
    rs = np.zeros((B, n))
    ts = np.zeros((B, n))
    us = np.zeros((B, n))
    rc = _COMPL[d[::-1]]
    strands = {1: d, -1: rc}
    spos = np.where(nd.strand == 1, nd.ndx, slen - 1 - nd.ndx)
    svpos = np.where(nd.strand == 1, nd.stop_val, slen - 1 - nd.stop_val)
    groups = _orf_groups(nd)

    # coding: the hexamer sum from the start to its stop, each frame's
    # cumulative sum read at both ends
    for (sel, gid, rank), strand in zip(groups, (1, -1)):
        s = strands[strand]
        mers = _mers(s, 6)
        p, q = spos[sel], svpos[sel]
        for f in range(3):
            tr = mers[f::3]
            at = np.flatnonzero(p % 3 == f)
            for bi, bn in enumerate(bins):
                cum = np.r_[0.0, np.cumsum(bn.gene_dc[tr])]
                cs[bi, sel[at]] = cum[q[at] // 3] - cum[p[at] // 3]
        # each start loses what a longer start before it in the frame
        # scores above it
        v = cs[:, sel]
        m = _excl_running_max(v, rank, -10000.0)
        cs[:, sel] = np.where(v > m, v, v - (m - v))

    # the length factor
    gcs = np.array([b.gc for b in bins])
    tts = np.array([b.tt for b in bins])
    no_stop = 1 - np.where(tts != 11,
                           ((1 - gcs) * (1 - gcs) * gcs) / 8.0
                           + ((1 - gcs) * (1 - gcs) * (1 - gcs)) / 8.0,
                           ((1 - gcs) * (1 - gcs) * gcs) / 4.0
                           + ((1 - gcs) * (1 - gcs) * (1 - gcs)) / 8.0)
    lmax = np.log((1 - no_stop ** 1000.0) / no_stop ** 1000.0)
    lmin = np.log((1 - no_stop ** 80.0) / no_stop ** 80.0)
    for (sel, gid, rank), strand in zip(groups, (1, -1)):
        if strand == 1:
            gsize = ((nd.stop_val[sel] - nd.ndx[sel]).astype(float) + 3.0) / 3.0
        else:
            gsize = ((nd.ndx[sel] - nd.stop_val[sel]).astype(float) + 3.0) / 3.0
        tmp = no_stop[:, None] ** gsize[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            short = np.log((1 - tmp) / tmp) - lmin[:, None]
        lfac = np.where(gsize[None, :] > 1000.0,
                        (lmax - lmin)[:, None] * (gsize[None, :] - 80) / 920.0,
                        short)
        m = _excl_running_max(lfac, rank, -10000.0)
        lfac = np.where(lfac > m, lfac,
                        lfac - np.maximum(np.minimum(m - lfac, lfac), 0))
        c = cs[:, sel]
        c = np.where((lfac > 3.0) & (c < 0.5 * lfac), 0.5 * lfac, c)
        cs[:, sel] = c + lfac

    start = nd.typ != STOP
    si = np.flatnonzero(start)
    plain = si[~nd.edge[si]]
    orf_len = np.abs(nd.ndx - nd.stop_val)
    is_fwd = nd.strand == 1

    # the start's stop: a real stop codon, or the contig's end
    edge_gene = nd.edge.astype(np.int64).copy()
    for strand in (1, -1):
        s = strands[strand]
        sel = si[nd.strand[si] == strand]
        stop_flags = _codon_flags(s, nd.tt)[0]
        q = svpos[sel]
        real = np.zeros(len(sel), bool)
        inside = (q >= 0) & (q <= len(s) - 3)
        real[inside] = stop_flags[q[inside]]
        edge_gene[sel] += ~real

    # type, RBS and upstream scores of the starts that are not edges
    windows = {}
    for strand in (1, -1):
        at = np.flatnonzero(nd.strand[plain] == strand)
        pos = spos[plain[at]]
        windows[strand] = (at, pos, _rbs_codes(strands[strand], pos, strand),
                           _upstream_mers(strands[strand], pos))
    # what the writers report of each start: RBS classes and motif
    sc.rbs = np.zeros((2, B, n), np.int64)
    sc.mot = np.zeros((4, B, n))            # score, k-mer, length, spacer
    for bi, bn in enumerate(bins):
        ts[bi, plain] = bn.type_wt[nd.typ[plain]] * bn.st_wt
        rsd = np.zeros(len(plain))
        mot = np.zeros(len(plain))
        upv = np.zeros(len(plain))
        for strand, (at, pos, rbs_w, ups_w) in windows.items():
            if bn.uses_sd:
                r0, r1 = _rbs(*rbs_w, bn.rbs_wt)
                rsd[at] = np.maximum(bn.rbs_wt[r0], bn.rbs_wt[r1]) * bn.st_wt
                sc.rbs[:, bi, plain[at]] = r0, r1
            else:
                # the Shine-Dalgarno classes stay at 0 in non-SD bins
                rsd[at] = bn.rbs_wt[0] * bn.st_wt
                found = _motif(strands[strand], pos, bn)
                mot[at] = found[0]
                sc.mot[:, bi, plain[at]] = found
            upv[at] = _upstream(*ups_w, bn)
        if bn.uses_sd:
            rs[bi, plain] = rsd
        else:
            r = bn.st_wt * mot
            rs[bi, plain] = np.where((r < rsd) & (bn.no_mot > -0.5), rsd, r)
        us[bi, plain] = upv
    for bi, bn in enumerate(bins):
        e = si[nd.edge[si]]
        ts[bi, e] = EDGE_BONUS * bn.st_wt / edge_gene[e]

    # the upstream penalty: a start at the contig's first or last codon,
    # or one near either end whose frame also holds an edge node (nodes
    # before it counted as edges once converted below)
    at_end = start & (((nd.ndx <= 2) & is_fwd) | ((nd.ndx >= slen - 3)
                                                  & ~is_fwd))
    conv = at_end & ~nd.edge
    edge_now = nd.edge | conv
    ups_pen = np.zeros(n, bool)
    near = plain[~at_end[plain] & ((plain < 500) | (plain + 500 >= n))]
    for i in near.tolist():
        if i < 500 and is_fwd[i]:
            hit = edge_now[:i] & (nd.stop_val[:i] == nd.stop_val[i])
        elif i + 500 >= n and not is_fwd[i]:
            hit = nd.edge[i + 1:] & (nd.stop_val[i + 1:] == nd.stop_val[i])
        else:
            continue
        ups_pen[i] = bool(hit.any())
    pen_at = np.flatnonzero(conv | ups_pen)
    us[:, pen_at] += EDGE_UPS * sc.sw[:, None]

    # starts at the contig's first or last codon become edge genes
    cv = np.flatnonzero(conv)
    edge_gene[cv] += 1
    ts[:, cv] = 0.0
    rs[:, cv] = 0.0
    us[:, cv] = EDGE_BONUS * sc.sw[:, None] / edge_gene[cv][None, :]
    edge = edge_now

    half = si[~edge[si] & (edge_gene[si] == 1)]
    us[:, half] -= 0.5 * EDGE_BONUS * sc.sw[:, None]

    short = si[(edge_gene[si] == 0) & (orf_len[si] < 250)]
    ln = orf_len[short].astype(np.float32).astype(float)
    negf, posf = 250.0 / ln, ln / 250.0
    for a in (rs, us, ts):
        v = a[:, short]
        a[:, short] = v * np.where(v < 0, negf, posf)

    if is_meta and slen < 3000:
        m = si[edge_gene[si] == 0]
        pen = META_PEN * max(0.0, (3000.0 - slen) / 2700.0)
        hit = (cs[:, m] < 5.0) | (orf_len[m] < 120)[None, :]
        cs[:, m] = np.where(hit, cs[:, m] - pen, cs[:, m])

    ss = np.zeros((B, n))
    ss[:, si] = ts[:, si] + rs[:, si] + us[:, si]

    c, s_ = cs[:, si], ss[:, si]
    u = us[:, si]
    eg, ed, ol = edge_gene[si], edge[si], orf_len[si]
    neg = c < 0.0
    case1 = neg & ((eg > 0) & ~ed)[None, :]
    if not is_meta or slen > 1500:
        s_ = np.where(case1, s_ - sc.sw[:, None], s_)
    else:
        s_ = np.where(case1, s_ - (10.31 - 0.004 * slen), s_)
    case2 = neg & ~case1 & (is_meta and slen < 3000) & ed[None, :]
    long_enough = (ol >= math.sqrt(slen) * 5.0)[None, :]
    s_ = np.where(case2 & long_enough, 0.0, s_)
    u = np.where(case2 & long_enough, 0.0, u)
    case3 = neg & ~case1 & ~case2
    s_ = np.where(case3, s_ - 0.5, s_)
    case4 = ~neg & is_meta & (c < 5.0) & (ol < 120)[None, :] & (s_ < 0.0)
    s_ = np.where(case4, s_ - sc.sw[:, None], s_)
    cs[:, si], ss[:, si], us[:, si] = c, s_, u

    sc.cs, sc.ss, sc.rs, sc.us, sc.ts = cs, ss, rs, us, ts
    sc.edge = edge
    return sc


# -- connections ----------------------------------------------------------

def _igm_same(nd, sc, b, n1, n2):
    """The intergenic modifier between same-strand nodes n1 and n2 under
    bins `b` (arrays broadcast together)."""
    d1, d2 = nd.ndx[n1], nd.ndx[n2]
    sw = sc.sw[b]
    dist = np.abs(d1 - d2)
    overlap = d1 + 2 * nd.strand[n1] >= d2
    abut = (d1 + 2 == d2) | (d1 == d2 + 1)
    own = np.where(nd.strand[n1] == 1, n2, n1)
    r, u = sc.rs[b, own], sc.us[b, own]
    rval = np.where(abut & (r < 0), 0.0 - r, 0.0)
    rval = np.where(abut & (u < 0), rval - u, rval)
    far = dist > 3 * OPER_DIST
    near = ((dist <= OPER_DIST) & ~overlap) | (dist * 4 < OPER_DIST)
    rval = np.where(far, rval - 0.15 * sw,
                    np.where(near, rval + (2.0 - dist / OPER_DIST) * 0.15 * sw,
                             rval))
    return rval


def _igm_coef(dist):
    """The intergenic modifier over the start weight, for same-strand
    nodes that neither abut nor overlap."""
    return np.where(dist > 3 * OPER_DIST, -0.15,
                    np.where((dist <= OPER_DIST) | (dist * 4 < OPER_DIST),
                             (2.0 - dist / OPER_DIST) * 0.15, 0.0))


def overlapping_starts(nd, sc, max_overlap):
    """For each stop and reading frame, the start of a gene that may
    overlap the stop's gene by up to `max_overlap` bp: the start scanned
    last among those that raised the stop's running best score, (B, n,
    3), -1 for none."""
    B, n = sc.cs.shape
    star = np.full((B, n, 3), -1, np.int64)
    ndx = nd.ndx
    for strand in (1, -1):
        stops = np.flatnonzero((nd.typ == STOP) & (nd.strand == strand)
                               & ~nd.edge)
        if not len(stops):
            continue
        if strand == 1:
            hi = np.minimum(stops + 3, n - 1)
            lo = np.searchsorted(ndx, ndx[stops] - max_overlap, "left")
            width = int(np.max(hi - lo + 1, initial=0))
            if width <= 0:
                continue
            # scanned from stop + 3 downwards
            js = hi[:, None] - np.arange(width)[None, :]
            ok = js >= lo[:, None]
        else:
            lo = np.maximum(stops - 3, 0)
            hi = np.searchsorted(ndx, ndx[stops] + max_overlap, "right") - 1
            width = int(np.max(hi - lo + 1, initial=0))
            if width <= 0:
                continue
            js = lo[:, None] + np.arange(width)[None, :]
            ok = js <= hi[:, None]
        js = np.clip(js, 0, n - 1)
        i = stops[:, None]
        if strand == 1:
            ok &= ndx[js] <= ndx[i] + 2
            ok &= (nd.strand[js] == 1) & (nd.typ[js] != STOP)
            ok &= nd.stop_val[js] > ndx[i]
        else:
            ok &= ndx[js] >= ndx[i] - 2
            ok &= (nd.strand[js] == -1) & (nd.typ[js] != STOP)
            ok &= nd.stop_val[js] < ndx[i]
        for b in range(B):
            if strand == 1:
                g = _igm_same(nd, sc, b, np.broadcast_to(i, js.shape), js)
            else:
                g = _igm_same(nd, sc, b, js, np.broadcast_to(i, js.shape))
            v = np.where(ok, sc.cs[b, js] + sc.ss[b, js] + g, -np.inf)
            prev = np.maximum.accumulate(
                np.concatenate([np.full((len(stops), 1), -100.0),
                                v[:, :-1]], 1), axis=1)
            raised = ok & (v > prev)
            frame = ndx[js] % 3
            for f in range(3):
                hit = raised & (frame == f)
                any_ = hit.any(1)
                last = width - 1 - np.argmax(hit[:, ::-1], 1)
                star[b, stops[any_], f] = js[any_, last[any_]]
    return star


# -- the dynamic programme ------------------------------------------------

def _windows(nd):
    """The first node each node's connections may come from."""
    n, ndx, sv = nd.n, nd.ndx, nd.stop_val
    idx = np.arange(n)
    lo = np.maximum(idx - MAX_NODE_DIST, 0)
    # a gene may start farther back than the window: reach its stop
    giant = (((nd.strand == -1) & (nd.typ != STOP))
             | ((nd.strand == 1) & (nd.typ == STOP))) & (ndx[lo] > sv)
    for i in np.flatnonzero(giant).tolist():
        m = int(lo[i])
        while m > 0 and ndx[m] != sv[i]:
            m -= 1
        lo[i] = m
    return np.where(lo < MAX_NODE_DIST, 0, lo - MAX_NODE_DIST)


def _ragged(starts, ends):
    """For windows [starts[t], ends[t]): (owner t, node j) of every node
    in them, window by window."""
    lens = np.maximum(ends - starts, 0)
    owner = np.repeat(np.arange(len(starts)), lens)
    off = np.cumsum(lens) - lens
    j = starts[owner] + np.arange(int(lens.sum())) - off[owner]
    return owner, j


def _lists(owner, count):
    """Offsets of each owner's entries in an owner-sorted list."""
    return np.r_[0, np.cumsum(np.bincount(owner, minlength=count))]


def _suffix_max(v, j0):
    """Per row, the maximum of v[:, a:] for every a and the largest
    column holding it, columns numbered from j0."""
    B, m = v.shape
    mx = np.maximum.accumulate(v[:, ::-1], 1)[:, ::-1]
    # the maximum at a is held last where its run of equal maxima ends
    end = np.ones((B, m), bool)
    end[:, :-1] = mx[:, :-1] != mx[:, 1:]
    pos = np.where(end, np.arange(m), m)
    at = np.minimum.accumulate(pos[:, ::-1], 1)[:, ::-1]
    return mx, at + j0


def _best_end(nd, S):
    """Per bin, the node the best path ends at: the highest-scoring
    forward stop or reverse start, the last in order on a tie."""
    term = np.flatnonzero(((nd.strand == 1) & (nd.typ == STOP))
                          | ((nd.strand == -1) & (nd.typ != STOP)))
    if not len(term):
        return np.full(S.shape[0], -1)
    st = S[:, term]
    top = st.max(1)
    return term[len(term) - 1 - np.argmax((st == top[:, None])[:, ::-1], 1)]


def _dp(nd, sc, star):
    """The final dynamic programme: per bin and node, the best score S of a
    path ending there, its previous node TB (-1 for none) and the frame of
    the overlapping start it used (OV, -1 for none).

    Each node i takes the best of 0 and S[j] + w(j, i) over the nodes j
    of its window that may connect to it, ties to the larger j.  Sources
    more than 3 * OPER_DIST bp before a start or a reverse stop all
    connect with w = -0.15 * start weight; their maximum is kept as a
    sliding window (ties to the larger j at equal S[j]).  Every
    other connection is listed and weighed one by one."""
    B, n = sc.cs.shape
    ndx, sv, typ, strand = nd.ndx, nd.stop_val, nd.typ, nd.strand
    frame = ndx % 3
    kind = 2 * (strand != 1) + (typ == STOP)
    idx = np.arange(n)
    lo = _windows(nd)
    cs, ss, sw = sc.cs, sc.ss, sc.sw
    bi = np.arange(B)[:, None]
    neg = -0.15 * sw
    cls = {k: np.flatnonzero(kind == k) for k in range(4)}

    # far sources of starts (kind 0) and reverse stops (kind 3)
    pf = np.searchsorted(ndx, ndx - 3 * OPER_DIST, "left")
    far_end = np.where((kind == 0) | (kind == 3), np.minimum(pf, idx), lo)
    near = np.maximum(lo, far_end)

    # listed sources: (target, source, weight (B,)); "dyn" ones are
    # weighed again in the loop against the traceback of the source
    tg, sj, wt = [], [], []
    # kinds 0 and 3: the near window
    t0 = np.flatnonzero((kind == 0) | (kind == 3))
    o, j = _ragged(near[t0], t0)
    i = t0[o]
    kj, ki = kind[j], kind[i]
    dist = ndx[i] - ndx[j]
    keep = (((kj == 1) & (ki == 0) & (ndx[j] + 2 < ndx[i]))
            | ((kj == 2) & (ki == 0) & (ndx[j] < ndx[i]))
            | ((kj == 1) & (ki == 3) & (ndx[j] + 2 < ndx[i] - 2))
            | ((kj == 2) & (ki == 3) & (ndx[j] < ndx[i] - 2)))
    i, j, kj, dist = i[keep], j[keep], kj[keep], dist[keep]
    # opposite strands (a reverse start before a forward start, a forward
    # stop before a reverse stop) take igm_diff = -0.15 * start weight
    coef = np.where(((kj == 2) & (kind[i] == 0)) | ((kj == 1) & (kind[i] == 3)),
                    -0.15, _igm_coef(dist))
    tg.append(i)
    sj.append(j)
    wt.append(coef[None, :] * sw[:, None])
    # kind 1: the starts of its frame and the stops in its reading frame
    t1 = cls[1]
    lo1 = np.maximum(lo[t1], np.searchsorted(ndx, sv[t1], "right"))
    o, j = _ragged(lo1, t1)
    i = t1[o]
    kj = kind[j]
    keep = ((kj == 0) & (frame[j] == frame[i])) | (kj == 1)
    i, j, kj = i[keep], j[keep], kj[keep]
    n3 = star[:, j, frame[i]]
    n3c = np.maximum(n3, 0)
    via = cs[bi, n3c] + ss[bi, n3c] + _igm_same(nd, sc, bi, j[None, :], n3c)
    via = np.where(n3 != -1, via, -np.inf)
    tg.append(i)
    sj.append(j)
    wt.append(np.where((kj == 0)[None, :], cs[:, j] + ss[:, j], via))
    # kind 2: the stop of its own reading frame
    t2 = cls[2]
    r3 = cls[3]
    at = np.searchsorted(ndx[r3], sv[t2])
    ok = at < len(r3)
    own = np.full(len(t2), -1)
    own[ok] = r3[at[ok]]
    ok &= (own >= 0) & (ndx[np.maximum(own, 0)] == sv[t2])
    ok &= (own >= lo[t2]) & (sv[np.maximum(own, 0)] > ndx[t2])
    tg.append(t2[ok])
    sj.append(own[ok])
    wt.append(cs[:, t2[ok]] + ss[:, t2[ok]])
    # kind 3: reverse stops whose frame runs past it
    t3 = cls[3]
    n3 = star[:, t3, :]                               # (B, m, 3)
    n3c = np.maximum(n3, 0)
    g = _igm_same(nd, sc, bi[:, :, None], n3c, t3[None, :, None])
    best3 = np.where(n3 != -1, cs[bi[:, :, None], n3c]
                     + ss[bi[:, :, None], n3c] + g, -np.inf)
    for f in range(3):
        rf = cls[3][frame[cls[3]] == f]
        if not len(rf):
            continue
        at = np.searchsorted(ndx[rf], ndx[t3], "left") - 1
        ok = at >= 0
        j = np.where(ok, rf[np.maximum(at, 0)], 0)
        ok &= (sv[j] > ndx[t3]) & (j >= lo[t3]) & (j < t3)
        tg.append(t3[ok])
        sj.append(j[ok])
        wt.append(best3[:, ok, f])
    tg = np.concatenate(tg)
    sj = np.concatenate(sj)
    wt = np.concatenate(wt, 1)
    order = np.lexsort((sj, tg))
    tg, sj, wt = tg[order], sj[order], wt[:, order]
    off = _lists(tg, n)

    # forward stops near a reverse start's stop (kind 2), weighed with the
    # traceback of the stop
    fs = cls[1]
    a = np.searchsorted(ndx[fs], sv[t2] - 4, "right")
    b_ = np.searchsorted(ndx[fs], sv[t2] + MAX_OPP_OVLP - 5, "left")
    o, q = _ragged(a, b_)
    i2, j2 = t2[o], fs[q]
    keep = ((j2 >= lo[i2]) & (j2 < i2)
            & (ndx[j2] - sv[i2] < ndx[i2] - ndx[j2] + 3))
    i2, j2 = i2[keep], j2[keep]
    off2 = _lists(i2, n)
    # forward stops a reverse stop's overlapping starts reach (kind 3)
    spans = []
    for f in range(3):
        m3 = n3[:, :, f]
        for bb in range(B):
            v3 = m3[bb]
            okv = v3 != -1
            a = np.searchsorted(ndx[fs], np.where(okv, sv[np.maximum(v3, 0)]
                                                  - 5, 0), "right")
            b_ = np.searchsorted(ndx[fs], np.where(okv, sv[np.maximum(v3, 0)]
                                                   + MAX_OPP_OVLP - 5, 0),
                                 "left")
            o, q = _ragged(np.where(okv, a, 0), np.where(okv, b_, 0))
            spans.append((t3[o], fs[q]))
    i3 = np.concatenate([x for x, _ in spans])
    j3 = np.concatenate([y for _, y in spans])
    keep = (j3 >= lo[i3]) & (j3 < i3) & (ndx[j3] + 2 < ndx[i3] - 2)
    pair = np.unique(np.stack([i3[keep], j3[keep]]), axis=1)
    i3, j3 = pair[0], pair[1]
    off3 = _lists(i3, n)
    slot3 = np.full(n, -1)
    slot3[t3] = np.arange(len(t3))

    farc = (kind == 1) | (kind == 2)
    S = np.zeros((B, n))
    # S where a node may be a source: a forward stop or reverse start
    # with no traceback is an edge artifact and connects to nothing
    SM = np.where(farc, -np.inf, 0.0)[None, :].repeat(B, 0)
    SF = np.full((B, n), -np.inf)
    TB = np.full((B, n), -1, np.int64)
    OV = np.full((B, n), -1, np.int64)
    lo_l, fe_l, kind_l = lo.tolist(), far_end.tolist(), kind.tolist()
    off_l, off2_l, off3_l = off.tolist(), off2.tolist(), off3.tolist()

    b0 = np.arange(B)

    def last_max(v, js):
        """(max of each row, the largest source holding it, its column);
        js (m,) ascending or (B, m)."""
        m = v.shape[1]
        at = m - 1 - v[:, ::-1].argmax(1)
        jb = js[at] if js.ndim == 1 else js[b0, at]
        return v[b0, at], jb, at

    farc_l = farc.tolist()
    pushed = f0 = f1 = 0
    fmx = np.full((B, 1), -np.inf)
    fjx = np.full((B, 1), -1)
    bmax = np.full(B, -np.inf)
    bj = np.full(B, -1)
    for i in range(n):
        tops, jbs, ovs = [], [], []
        a, fe = lo_l[i], fe_l[i]
        if fe > a:
            # the far window [a, fe) as a queue of two stacks: a front
            # block of suffix maxima, and the running maximum of the
            # sources pushed behind it since
            while pushed < fe:
                if farc_l[pushed]:
                    v = SF[:, pushed]
                    up = v >= bmax
                    bmax = np.where(up, v, bmax)
                    bj = np.where(up, pushed, bj)
                pushed += 1
            if a >= f1:
                fmx, fjx = _suffix_max(SF[:, f1:pushed], f1)
                f0, f1 = f1, pushed
                bmax = np.full(B, -np.inf)
                bj = np.full(B, -1)
            t, jb = fmx[:, a - f0], fjx[:, a - f0]
            up = bmax >= t
            tops.append(np.where(up, bmax, t) + neg)
            jbs.append(np.where(up, bj, jb))
            ovs.append(None)
        o0, o1 = off_l[i], off_l[i + 1]
        if o1 > o0:
            jj = sj[o0:o1]
            t, jb, _at = last_max(SM[:, jj] + wt[:, o0:o1], jj)
            tops.append(t)
            jbs.append(jb)
            ovs.append(None)
        k = kind_l[i]
        if k == 2:
            o0, o1 = off2_l[i], off2_l[i + 1]
            if o1 > o0:
                jj = j2[o0:o1]
                bnd = ndx[np.maximum(TB[:, jj], 0)]
                x = ndx[jj] - sv[i]
                v = SM[:, jj] + (cs[:, i] + ss[:, i] + neg)[:, None]
                t, jb, _at = last_max(
                    np.where(x < sv[i] - 3 - bnd, v, -np.inf), jj)
                tops.append(t)
                jbs.append(jb)
                ovs.append(None)
        elif k == 3:
            o0, o1 = off3_l[i], off3_l[i + 1]
            if o1 > o0:
                jj = j3[o0:o1]
                btb = ndx[np.maximum(TB[:, jj], 0)]
                left = ndx[jj] + 2
                sl = slot3[i]
                score = np.repeat(neg[:, None], len(jj), 1)
                topv = np.zeros(score.shape)
                frsel = np.full(score.shape, -1)
                for fr in range(3):
                    m = star[:, i, fr][:, None]
                    mc = np.maximum(m, 0)
                    ovlp = left[None, :] - sv[mc] + 3
                    ok = ((m != -1) & (ovlp > 0) & (ovlp < MAX_OPP_OVLP)
                          & (ovlp < ndx[mc] - left[None, :])
                          & (ovlp < sv[mc] - btb - 2))
                    cur = best3[:, sl, fr][:, None]
                    take = ok & (cur > topv)
                    topv = np.where(take, cur, topv)
                    score = np.where(take, cur, score)
                    frsel = np.where(take, fr, frsel)
                t, jb, at = last_max(SM[:, jj] + score, jj)
                tops.append(t)
                jbs.append(jb)
                ovs.append(frsel[b0, at])
        if not tops:
            continue
        top, jbest, ov = tops[0], jbs[0], ovs[0]
        for t, jb, o in zip(tops[1:], jbs[1:], ovs[1:]):
            up = (t > top) | ((t == top) & (jb > jbest))
            top = np.where(up, t, top)
            jbest = np.where(up, jb, jbest)
            if o is not None or ov is not None:
                ov = np.where(up, -1 if o is None else o,
                              -1 if ov is None else ov)
        take = top >= 0.0
        s_i = np.where(take, top, 0.0)
        tb_i = np.where(take, jbest, -1)
        S[:, i] = s_i
        TB[:, i] = tb_i
        if ov is not None:
            OV[:, i] = np.where(take, ov, -1)
        if k == 1 or k == 2:
            sm = np.where(take, top, -np.inf)
            SM[:, i] = sm
            SF[:, i] = sm
        else:
            SM[:, i] = s_i

    return S, TB, OV


def meta_best(seq, bins, opts, precision="f64"):
    """{bin: the best path score, or None without a path} for the
    candidate bins of contig `seq` (a str); with `precision="bf16"`, the
    node scores rounded to bfloat16 before the overlapping starts and
    the dynamic programme."""
    return meta_run(seq, bins, opts, precision)[0]


def meta_run(seq, bins, opts, precision="f64"):
    """(meta_best's scores, the winner): the bin Prodigal's sweep chooses
    (the highest score, the first in order on a tie) with what its genes
    are read from, `Winner`, or None where no bin has a path."""
    if opts["closed"] or opts["mask"]:
        raise ValueError("the plain reference takes open ends, no masks")
    d = digits(seq)
    cands = candidates(gc_share(d), bins)
    out, win = {}, None
    for tt in sorted({bins[b].tt for b in cands}):
        group = [b for b in cands if bins[b].tt == tt]
        nd = Nodes(d, tt, opts["min_gene"], opts["min_edge_gene"])
        sc = score_nodes(d, nd, [bins[b] for b in group])
        if precision == "bf16":
            for name in ("cs", "ss", "rs", "us"):
                setattr(sc, name, round_bf16(getattr(sc, name)))
        elif precision != "f64":
            raise ValueError(f"unknown precision {precision!r}")
        star = overlapping_starts(nd, sc, opts["max_overlap"])
        S, TB, OV = _dp(nd, sc, star) if nd.n else (None, None, None)
        for k, b in enumerate(group):
            score = None
            if nd.n:
                end = int(_best_end(nd, S[k:k + 1])[0])
                if end >= 0 and TB[k, end] != -1:
                    score = float(S[k, end])
            out[b] = score
            if score is not None and (win is None or score > win.score
                                      or (score == win.score
                                          and b < win.bin)):
                win = Winner(b, score, d, nd, sc, k, star[k], S[k], TB[k],
                             OV[k])
    return {b: out[b] for b in cands}, win


class Winner:
    """The chosen bin's nodes, node scores (a one-bin `Scores`),
    overlapping starts and dynamic programme."""

    def __init__(self, b, score, d, nd, sc, k, star, S, TB, OV):
        self.bin, self.score, self.d, self.nd = b, score, d, nd
        one = Scores()
        for name in ("cs", "ss", "rs", "us", "ts", "sw"):
            setattr(one, name, getattr(sc, name)[k:k + 1])
        one.rbs, one.mot = sc.rbs[:, k:k + 1], sc.mot[:, k:k + 1]
        one.edge = sc.edge
        self.sc, self.star, self.S, self.TB, self.OV = one, star, S, TB, OV


def round_bf16(a):
    """float64 values rounded to the nearest bfloat16 (ties to even)."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)
