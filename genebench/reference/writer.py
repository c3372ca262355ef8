"""Prodigal's gene calls for the bin a contig's scores choose, and the
three files a user writes of them (GFF, protein FASTA, nucleotide
FASTA), in plain NumPy and Python on top of `plain.py`.

From the winning bin's dynamic programme: the path's traceback with its
overlaps untangled, the elimination of genes that score below zero, the
genes along the path, the final choice of each gene's start among the
starts sharing its stop, and the fields the writers print (Prodigal
v2.6.3 as pyrodigal runs and writes it).  Shares no code with the port
or its C engine.
"""

import math

import numpy as np

from . import plain

STOP, OPER = plain.STOP, plain.OPER_DIST
TYPE_NAMES = ("ATG", "GTG", "TTG", "Edge")
RBS_MOTIF = (
    None, "GGA/GAG/AGG", "3Base/5BMM", "4Base/6BMM", "AGxAG", "AGxAG",
    "GGA/GAG/AGG", "GGxGG", "GGxGG", "AGxAG", "AGGAG(G)/GGAGG",
    "AGGA/GGAG/GAGG", "AGGA/GGAG/GAGG", "GGA/GAG/AGG", "GGxGG",
    "AGGA", "GGAG/GAGG", "AGxAGG/AGGxGG", "AGxAGG/AGGxGG",
    "AGxAGG/AGGxGG", "AGGAG/GGAGG", "AGGAG", "AGGAG", "GGAGG",
    "GGAGG", "AGGAGG", "AGGAGG", "AGGAGG")
RBS_SPACER = (
    None, "3-4bp", "13-15bp", "13-15bp", "11-12bp", "3-4bp",
    "11-12bp", "11-12bp", "3-4bp", "5-10bp", "13-15bp", "3-4bp",
    "11-12bp", "5-10bp", "5-10bp", "5-10bp", "5-10bp", "11-12bp",
    "3-4bp", "5-10bp", "11-12bp", "3-4bp", "5-10bp", "3-4bp",
    "5-10bp", "11-12bp", "3-4bp", "5-10bp")
# NCBI genetic codes, codons in TCAG order (first base slowest)
_CODES = {
    11: "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
    4: "FFLLSSSSYY**CCWWLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG",
}
_TCAG = {plain.T: 0, plain.C: 1, plain.A: 2, plain.G: 3}
LETTERS = np.frombuffer(b"AGCTNNN", np.uint8)


def _code(tt):
    """Amino acids by codon (x0, x1, x2) in digits, (4, 4, 4) bytes."""
    if tt not in _CODES:
        raise ValueError(f"no genetic code for translation table {tt}")
    out = np.zeros((4, 4, 4), np.uint8)
    for a in range(4):
        for b in range(4):
            for c in range(4):
                k = 16 * _TCAG[a] + 4 * _TCAG[b] + _TCAG[c]
                out[a, b, c] = ord(_CODES[tt][k])
    return out


def _igm(nd, sc, n1, n2):
    """The intergenic modifier between nodes n1 and n2 (bin 0)."""
    if nd.strand[n1] == nd.strand[n2]:
        return float(plain._igm_same(nd, sc, 0, np.array(n1),
                                     np.array(n2)))
    return -0.15 * float(sc.sw[0])


def _untangle(nd, star, S, TB, OV):
    """The node the best path ends at, and the path's back and forward
    links with its overlaps untangled; (-1, ...) without a gene."""
    TB, OV = TB.copy(), OV.copy()
    TF = np.full(nd.n, -1)
    end = int(plain._best_end(nd, S[None, :])[0])
    if end < 0:
        return -1, TB, TF
    ndx, sv, typ, strand = nd.ndx, nd.stop_val, nd.typ, nd.strand
    path = end
    while TB[path] != -1:
        nxt = TB[path]
        if (strand[path] == -1 and typ[path] == STOP and strand[nxt] == 1
                and typ[nxt] == STOP and OV[path] != -1
                and ndx[path] > ndx[nxt]):
            tmp = star[path, OV[path]]
            i = tmp
            while ndx[i] != sv[tmp]:
                i -= 1
            TB[path] = tmp
            TB[tmp] = i
            OV[i] = -1
            TB[i] = nxt
        path = TB[path]
    path = end
    while TB[path] != -1:
        nxt = TB[path]
        if (strand[path] == -1 and typ[path] != STOP and strand[nxt] == 1
                and typ[nxt] == STOP):
            i = path
            while ndx[i] != sv[path]:
                i -= 1
            TB[path] = i
            TB[i] = nxt
        if (strand[path] == 1 and typ[path] == STOP and strand[nxt] == 1
                and typ[nxt] == STOP):
            TB[path] = star[nxt, ndx[path] % 3]
            TB[TB[path]] = nxt
        if (strand[path] == -1 and typ[path] == STOP and strand[nxt] == -1
                and typ[nxt] == STOP):
            TB[path] = star[path, ndx[nxt] % 3]
            TB[TB[path]] = nxt
        path = TB[path]
    path = end
    while TB[path] != -1:
        TF[TB[path]] = path
        path = TB[path]
    return (end if TB[end] != -1 else -1), TB, TF


def _genes(nd, sc, star, S, TB, OV, max_overlap):
    """The genes of the best path: [(begin, end, start node, stop
    node)], 1-based and end-inclusive."""
    end, TB, TF = _untangle(nd, star, S, TB, OV)
    if end < 0:
        return []
    typ, strand = nd.typ, nd.strand
    cs, ss = sc.cs[0], sc.ss[0].copy()
    elim = np.zeros(nd.n, bool)
    first = end
    while TB[first] != -1:
        first = TB[first]
    # the intergenic modifier of each junction joins the gene's start
    path = first
    while TF[path] != -1:
        if strand[path] == 1 and typ[path] == STOP:
            ss[TF[path]] += _igm(nd, sc, path, TF[path])
        if strand[path] == -1 and typ[path] != STOP:
            ss[path] += _igm(nd, sc, path, TF[path])
        path = TF[path]
    # genes whose score is below zero go
    path = first
    while TF[path] != -1:
        nxt = TF[path]
        if (strand[path] == 1 and typ[path] != STOP and strand[nxt] == 1
                and typ[nxt] == STOP and cs[path] + ss[path] < 0.0):
            elim[path] = elim[nxt] = True
        if (strand[path] == -1 and typ[path] == STOP and strand[nxt] == -1
                and typ[nxt] != STOP and cs[nxt] + ss[nxt] < 0.0):
            elim[path] = elim[nxt] = True
        path = nxt
    genes = []
    begin = stop = start = 0
    path = first
    while path != -1:
        if not elim[path]:
            if strand[path] == 1 and typ[path] != STOP:
                begin, start = int(nd.ndx[path]) + 1, path
            elif strand[path] == 1:
                genes.append([begin, int(nd.ndx[path]) + 3, start, path])
            elif typ[path] != STOP:
                genes.append([begin, int(nd.ndx[path]) + 1, path, stop])
            else:
                begin, stop = int(nd.ndx[path]) - 1, path
        path = TF[path]
    _final_starts(nd, sc, ss, genes, max_overlap)
    return genes


def _final_starts(nd, sc, ss, genes, max_overlap):
    """Moves a gene's start to one of the two next best starts sharing
    its stop where their type, RBS, upstream and coding scores say so."""
    ndx, sv, typ, strand = nd.ndx, nd.stop_val, nd.typ, nd.strand
    cs, ts, rs, us = sc.cs[0], sc.ts[0], sc.rs[0], sc.us[0]
    edge, sw, n, ng = sc.edge, float(sc.sw[0]), nd.n, len(genes)
    for gi, g in enumerate(genes):
        s0 = g[2]
        total = ss[s0] + cs[s0]
        prev = genes[gi - 1] if gi > 0 else None
        nxt = genes[gi + 1] if gi < ng - 1 else None
        local = 0.0
        if prev and strand[s0] == 1 and strand[prev[2]] == 1:
            local = _igm(nd, sc, prev[3], s0)
        if prev and strand[s0] == 1 and strand[prev[2]] == -1:
            local = -0.15 * sw
        if nxt and strand[s0] == -1 and strand[nxt[2]] == 1:
            local = -0.15 * sw
        if nxt and strand[s0] == -1 and strand[nxt[2]] == -1:
            local = _igm(nd, sc, s0, nxt[3])
        best = [[-1, 0.0, 0.0], [-1, 0.0, 0.0]]     # node, score, igm
        for j in range(s0 - 100, s0 + 100):
            if j < 0 or j >= n or j == s0:
                continue
            if typ[j] == STOP or sv[j] != sv[s0]:
                continue
            t = 0.0
            if prev and strand[j] == 1 and strand[prev[2]] == 1:
                if ndx[prev[3]] - ndx[j] > max_overlap:
                    continue
                t = _igm(nd, sc, prev[3], j)
            if prev and strand[j] == 1 and strand[prev[2]] == -1:
                if ndx[prev[2]] - ndx[j] >= 0:
                    continue
                t = -0.15 * sw
            if nxt and strand[j] == -1 and strand[nxt[2]] == 1:
                if ndx[j] - ndx[nxt[2]] >= 0:
                    continue
                t = -0.15 * sw
            if nxt and strand[j] == -1 and strand[nxt[2]] == -1:
                if ndx[j] - ndx[nxt[3]] > max_overlap:
                    continue
                t = _igm(nd, sc, j, nxt[3])
            here = cs[j] + ss[j]
            if best[0][0] == -1:
                best[0] = [j, here, t]
            elif here + t > best[0][1]:
                best[1] = best[0]
                best[0] = [j, here, t]
            elif best[1][0] == -1 or here + t > best[1][1]:
                best[1] = [j, here, t]
        for b in best:
            m = b[0]
            if m == -1:
                continue
            if (ts[m] < ts[s0] and b[1] - ts[m] >= total - ts[s0] + sw
                    and rs[m] > rs[s0] and us[m] > us[s0]
                    and cs[m] > cs[s0] and abs(ndx[m] - ndx[s0]) > 15):
                b[1] += ts[s0] - ts[m]
            elif (abs(ndx[m] - ndx[s0]) <= 15
                  and rs[m] + ts[m] > rs[s0] + ts[s0]
                  and not edge[s0] and not edge[m]):
                if cs[s0] > cs[m]:
                    b[1] += cs[s0] - cs[m]
                if us[s0] > us[m]:
                    b[1] += us[s0] - us[m]
                if local > b[2]:
                    b[1] += local - b[2]
            else:
                b[1] = -1000.0
        pick = -1
        for k in range(2):
            if best[k][0] == -1:
                continue
            if pick == -1 and best[k][1] + best[k][2] > total + local:
                pick = k
            elif pick >= 0 and (best[k][1] + best[k][2]
                                > best[pick][1] + best[pick][2]):
                pick = k
        if pick != -1:
            m = best[pick][0]
            g[2] = m
            if strand[m] == 1:
                g[0] = int(ndx[m]) + 1
            else:
                g[1] = int(ndx[m]) + 1


def _gc_content(cum, nd, i):
    """The GC share of start node i's gene, stop codon included, as a
    float32; `cum` counts G, C and unknown bases cumulatively."""
    slen = len(cum) - 1
    x, s = int(nd.ndx[i]), int(nd.stop_val[i])
    if nd.strand[i] == 1:
        count = cum[min(s + 3, slen)] - cum[max(x, 0)]
    else:
        count = (cum[max(s + 1, 0)] - cum[max(s - 2, 0)]
                 + cum[min(x + 3, slen)] - cum[min(max(s + 3, 0), slen)])
    size = abs(s - x) + 3.0
    return float(np.float32(count / size))


def _mer_text(length, index):
    return "".join("AGCT"[(index >> (2 * k)) & 3] for k in range(length))


def _rbs_fields(sc, bn, i):
    r0, r1 = int(sc.rbs[0, 0, i]), int(sc.rbs[1, 0, i])
    w0, w1 = bn.rbs_wt[r0] * bn.st_wt, bn.rbs_wt[r1] * bn.st_wt
    if bn.uses_sd:
        k = r0 if w0 > w1 else r1
        return RBS_MOTIF[k], RBS_SPACER[k]
    score, index, length, spacer = sc.mot[:, 0, i]
    if bn.no_mot > -0.5 and w0 > w1 and w0 > score * bn.st_wt:
        return RBS_MOTIF[r0], RBS_SPACER[r0]
    if bn.no_mot > -0.5 and w1 >= w0 and w1 > score * bn.st_wt:
        return RBS_MOTIF[r1], RBS_SPACER[r1]
    if length == 0:
        return None, None
    return _mer_text(int(length), int(index)), f"{int(spacer)}bp"


def _confidence(score, st_wt):
    if score / st_wt < 41:
        conf = math.exp(score / st_wt)
        conf = conf / (conf + 1)
    else:
        conf = 0.9999
    return max(conf, 0.50) * 100.0


def _protein(d, rc, code, g, strand, start_edge, tt):
    """The gene's translation: stops as '*', unknown codons as 'X', the
    first codon as 'M' where it is a start and the gene has its start."""
    s = d if strand == 1 else rc
    lo = g[0] - 1 if strand == 1 else len(d) - g[1]
    cod = s[lo:lo + g[1] - g[0] + 1].reshape(-1, 3)
    known = (cod <= 3).all(1)
    c = np.where(known[:, None], cod, 0)
    aa = np.where(known, code[c[:, 0], c[:, 1], c[:, 2]], ord("X"))
    stop, start, _x = plain._codon_flags(cod.reshape(-1), tt)
    stop, start = stop[::3], start[::3]
    aa = np.where(known & stop, ord("*"), aa)
    if not start_edge and len(aa) and known[0] and not stop[0] and start[0]:
        aa[0] = ord("M")
    return aa.astype(np.uint8).tobytes().decode("ascii")


def _wrap(text, width):
    return "".join(text[k:k + width] + "\n"
                   for k in range(0, len(text), width))


def texts(name, seqlen, winner, bins, opts, num_seq):
    """The contig's GFF, protein FASTA and nucleotide FASTA, for the bin
    `plain.meta_run` chose (`winner`, None where no bin has a path)."""
    bn = bins[winner.bin if winner is not None else 5]
    head = (f"##gff-version  3\n"
            f"# Sequence Data: seqnum={num_seq};seqlen={seqlen};"
            f'seqhdr="{name}"\n'
            f"# Model Data: version=pyrodigal_tpu.v0;run_type=Metagenomic;"
            f'model="{bn.description}";gc_cont={bn.gc * 100:.2f};'
            f"transl_table={bn.tt};uses_sd={int(bn.uses_sd)}\n")
    if winner is None:
        return head, "", ""
    d, nd, sc = winner.d, winner.nd, winner.sc
    genes = _genes(nd, sc, winner.star, winner.S, winner.TB, winner.OV,
                   opts["max_overlap"])
    rc = plain._COMPL[d[::-1]]
    code = _code(bn.tt)
    gff, faa, fna = [head], [], []
    edge = sc.edge
    cum = np.r_[0, np.cumsum((d != plain.A) & (d != plain.T))]
    for k, (begin, end, s0, s1) in enumerate(genes):
        strand = int(nd.strand[s0])
        pb = bool(edge[s0] if strand == 1 else edge[s1])
        pe = bool(edge[s1] if strand == 1 else edge[s0])
        stype = TYPE_NAMES[3 if edge[s0] else int(nd.typ[s0])]
        motif, spacer = _rbs_fields(sc, bn, s0)
        gc = _gc_content(cum, nd, s0)
        fields = (f"partial={int(pb)}{int(pe)};start_type={stype};"
                  f"rbs_motif={motif};rbs_spacer={spacer};gc_cont={gc:.3f}")
        c, s = float(sc.cs[0, s0]), float(sc.ss[0, s0])
        gff.append(
            f"{name}\tpyrodigal_tpu_v0\tCDS\t{begin}\t{end}\t{s + c:.1f}\t"
            f"{'+' if strand > 0 else '-'}\t0\tID={name}_{k + 1};{fields};"
            f"conf={_confidence(c + s, bn.st_wt):.2f};score={c + s:.2f};"
            f"cscore={c:.2f};sscore={s:.2f};rscore={sc.rs[0, s0]:.2f};"
            f"uscore={sc.us[0, s0]:.2f};tscore={sc.ts[0, s0]:.2f};\n")
        title = (f">{name}_{k + 1} # {begin} # {end} # {strand} # "
                 f"ID={num_seq}_{k + 1};{fields}\n")
        faa.append(title + _wrap(_protein(d, rc, code, (begin, end),
                                          strand, edge[s0], bn.tt), 60))
        bases = d[begin - 1:end] if strand == 1 else rc[len(d) - end:
                                                          len(d) - begin + 1]
        fna.append(title + _wrap(LETTERS[bases].tobytes().decode(), 70))
    return "".join(gff), "".join(faa), "".join(fna)
