"""Per-bin node scoring in PyTorch, and the two launches built on it.

Port of `pyrodigal_tpu.ops.score_device`: the 6-mer codes, SD / upstream /
motif candidates, the coding, length, RBS, upstream and start scores
(reference: lib.pyx:2119-2487) of every node under every row's bin.  Two
geometry layouts, as in the reference: the mega route's one shared
geometry (a single contig, or several laid end to end by
`pack_geometries_multi`) with the candidate bins as rows, and the std
route's G stacked geometries (`pack_geometries`) with one work item
(contig, bin) per row, picked by `gidx`.  The TPU devices of the reference
(one-hot matrix-unit lookups, masked-roll window gathers, the geometry
byte-packing for a slow link) become plain gathers; the dc prefix sums
run in the dc-chain kernel (shared geometry) or the phase-cumsum kernel
(per-row geometry), and the blocked associative scans of passes 2 and 3
in one launch of the seg-scan kernel (`star_cuda.seg_scan_passes`).

The numpy geometry helpers are copies of the reference's: the reference
modules import jax at the top, and this package must not.

Numerics are float32; the exact float64 C engine re-scores the winning
bins on the host, so emitted genes do not depend on the f32 scores.
"""

import ctypes

import numpy as np
import torch

from .. import _native, tracing
from .._constants import MAX_NODE_DIST, STOP
from . import dp_cuda, star_cuda
from .dp_cuda import _fdiv

EDGE_BONUS = 0.74
EDGE_UPS = -1.0
META_PEN = 7.5

F32 = torch.float32


# --------------------------------------------------------------------------
# per-bin tables
# --------------------------------------------------------------------------

def _sd_luts():
    """The SD scanners' candidate-set masks, tabulated over (distance,
    6-mer) -- see rc_sd_cand_luts (reference: lib.pyx:791-979)."""
    ex = np.zeros((15, 4096), np.int32)
    mm = np.zeros((15, 4096), np.int32)
    _native.lib.rc_sd_cand_luts(_native.i32(ex), _native.i32(mm))
    return ex.reshape(-1), mm.reshape(-1)


TABLE_NAMES = ("gene_dc", "rbs_wt", "ups_comp", "type_wt", "mot_wt",
               "st_wt", "no_mot", "uses_sd", "log_no_stop", "lfac_min",
               "lfac_max", "sd_ex", "sd_mm", "sd_wi")


def _table_arrays(metagenomic_bins):
    """The stacked per-bin tables as numpy arrays, in `TABLE_NAMES` order
    (the order of the reference's `BinTables.as_tuple`)."""
    tis = [b.training_info for b in metagenomic_bins]
    nb = len(tis)
    gene_dc = np.zeros((nb, 4096), np.float32)
    rbs_wt = np.zeros((nb, 28), np.float32)
    ups_comp = np.zeros((nb, 128), np.float32)
    type_wt = np.zeros((nb, 3), np.float32)
    mot_wt = np.zeros((nb, 65536), np.float32)
    st_wt = np.zeros(nb, np.float32)
    no_mot = np.zeros(nb, np.float32)
    uses_sd = np.zeros(nb, np.int32)
    log_no_stop = np.zeros(nb, np.float32)
    lfac_min = np.zeros(nb, np.float32)
    lfac_max = np.zeros(nb, np.float32)
    for k, ti in enumerate(tis):
        gene_dc[k] = ti.coding_statistics
        rbs_wt[k] = ti.rbs_weights_array
        ups_comp[k] = np.asarray(ti.upstream_compositions,
                                 np.float64).reshape(-1)
        type_wt[k] = ti.type_weights
        mot_wt[k] = np.asarray(ti.motif_weights, np.float64).reshape(-1)
        st_wt[k] = ti.start_weight
        no_mot[k] = ti.missing_motif_weight
        uses_sd[k] = int(ti.uses_sd)
        gc = float(ti.gc)
        # (reference: lib.pyx:2131-2147)
        if ti.translation_table != 11:
            ns = ((1 - gc) ** 2 * gc) / 8.0 + ((1 - gc) ** 3) / 8.0
        else:
            ns = ((1 - gc) ** 2 * gc) / 4.0 + ((1 - gc) ** 3) / 8.0
        ns = 1.0 - ns
        log_no_stop[k] = np.log(ns)
        lfac_max[k] = np.log((1 - ns ** 1000.0) / ns ** 1000.0)
        lfac_min[k] = np.log((1 - ns ** 80.0) / ns ** 80.0)
    sd_ex, sd_mm = _sd_luts()
    # per-bin SD winner tables: wi[bin, p, code] = the index the SD scanner
    # at window position p returns for 6-mer `code` under this bin's
    # weights (per-position lex argmax by (weight, index)).  Rows are in
    # window-position order (row p = distance 20-p); the exact and
    # 1-mismatch winners are packed into one f32 cell as ex * 32 + mm.
    wi = np.zeros((2, nb, 15, 4096), np.float32)
    for which, masks in enumerate((sd_ex, sd_mm)):
        mm2 = masks.reshape(15, 4096)[::-1]
        for k in range(nb):
            wt = rbs_wt[k]
            best = np.zeros(mm2.shape, np.int32)
            bw = np.full(mm2.shape, wt[0], np.float32)
            for v in range(1, 28):
                bit = (mm2 >> v) & 1
                upd = (bit != 0) & ((wt[v] > bw)
                                    | ((wt[v] == bw) & (v > best)))
                bw = np.where(upd, wt[v], bw)
                best = np.where(upd, v, best)
            wi[which, k] = best
    sd_wi = wi[0] * 32.0 + wi[1]
    return (gene_dc, rbs_wt, ups_comp, type_wt, mot_wt, st_wt, no_mot,
            uses_sd, log_no_stop, lfac_min, lfac_max, sd_ex, sd_mm, sd_wi)


class BinTables:
    """Stacked per-bin training tables, resident on one torch device."""

    def __init__(self, metagenomic_bins, device="cpu", *, arrays=None):
        if arrays is None:
            arrays = _table_arrays(metagenomic_bins)
        arrays = tuple(np.asarray(a) for a in arrays)
        if len(arrays) != len(TABLE_NAMES):
            raise ValueError(f"expected {len(TABLE_NAMES)} tables, "
                             f"got {len(arrays)}")
        self.device = torch.device(device)
        for name, a in zip(TABLE_NAMES, arrays):
            setattr(self, name, torch.from_numpy(np.array(a)).to(
                self.device))
        self.nb = arrays[0].shape[0]
        self.uses_sd_np = arrays[TABLE_NAMES.index("uses_sd")].copy()
        self.any_nonsd = bool((self.uses_sd_np == 0).any())

    @classmethod
    def from_numpy(cls, arrays, device="cpu"):
        """Tables from numpy arrays in `as_tuple` order -- e.g. the
        reference's `tuple(np.asarray(a) for a in tables.as_tuple())` --
        so both packages score with identical tables."""
        return cls(None, device, arrays=arrays)

    def as_tuple(self):
        return tuple(getattr(self, name) for name in TABLE_NAMES)


# --------------------------------------------------------------------------
# host-side geometry (numpy; copies of the reference's helpers)
# --------------------------------------------------------------------------

def window_starts(ndx, stop_val, typ, strand):
    """Each node's DP window start (reference: lib.pyx:1221-1233, with the
    giant-ORF extension); copy of `dp_jax.window_starts`."""
    nn = len(ndx)
    idx = np.arange(nn)
    min0 = np.maximum(idx - MAX_NODE_DIST, 0)
    ext = (
        ((strand == -1) & (typ != STOP)) | ((strand == 1) & (typ == STOP))
    ) & (ndx[min0] > stop_val)
    # the largest index whose ndx equals stop_val (the paired stop)
    pos = np.searchsorted(ndx, stop_val, side="right") - 1
    matched = (pos >= 0) & (ndx[np.clip(pos, 0, nn - 1)] == stop_val)
    target = np.where(matched, np.clip(pos, 0, nn - 1), 0)
    m = np.where(ext, target, min0)
    return np.maximum(m - MAX_NODE_DIST, 0).astype(np.int32)


def prepare_geometry(seq, nodes, tt, closed, max_overlap, relk):
    """Bin-independent host tensors for one (contig, translation table).

    `star_overflow` is set when some stop's star-candidate scan spans more
    than `relk` node indices (reference scan bounds: lib.pyx:2279-2329)."""
    nn = nodes.length
    slen = seq.slen
    s = nodes._struct()
    lib = _native.lib

    stop_real = np.zeros(nn, np.uint8)
    lib.rc_stop_real(_native.u8(seq.digits), slen, ctypes.byref(s), tt,
                     _native.u8(stop_real))
    euf = np.zeros(nn, np.uint8)
    lib.rc_edge_ups_flags(ctypes.byref(s), slen, int(closed),
                          _native.u8(euf))

    ndx = nodes.ndx[:nn]
    typ = nodes.type[:nn]
    strand = nodes.strand[:nn]
    edge = nodes.edge[:nn]

    win_lo = window_starts(
        ndx.astype(np.int64), nodes.stop_val[:nn].astype(np.int64),
        typ, strand).astype(np.int32)

    # star-candidate scan span (node indices)
    idx = np.arange(nn)
    span = 0
    fstop = (typ == STOP) & (strand == 1) & (edge == 0)
    rstop = (typ == STOP) & (strand == -1) & (edge == 0)
    if fstop.any():
        jmin = np.searchsorted(ndx, ndx[fstop] - max_overlap, side="left")
        span = max(span, int((idx[fstop] + 3 - jmin).max()) + 1)
    if rstop.any():
        jmax = np.searchsorted(ndx, ndx[rstop] + max_overlap,
                               side="right") - 1
        span = max(span, int((jmax - idx[rstop] + 3).max()) + 1)

    return {
        "nn": nn, "slen": slen, "tt": tt,
        "ndx": ndx.astype(np.int32),
        "stop_val": nodes.stop_val[:nn].astype(np.int32),
        "win_lo": win_lo,
        "typ": typ.astype(np.int8),
        "strand": strand.astype(np.int8),
        "edge": edge.astype(np.int8),
        "stop_real": stop_real.astype(np.int8),
        "euf": euf.astype(np.int8),
        "digits": seq.digits,
        "star_overflow": span > relk,
    }


GEO_I32 = ("ndx", "stop_val", "win_lo")
GEO_I8 = ("typ", "strand", "edge", "stop_real", "euf", "valid")


def pack_geometries(geoms, G, n, S):
    """Stack geometry dicts into fixed-shape arrays for one launch."""
    out = {
        "n32": np.zeros((len(GEO_I32), G, n), np.int32),
        "n8": np.zeros((len(GEO_I8), G, n), np.int8),
        "digits": np.zeros((G, S), np.uint8),
        "slen": np.zeros(G, np.int32),
    }
    out["n8"][1] = 1          # strand pad
    for gi, gd in enumerate(geoms):
        nn = gd["nn"]
        for fi, f in enumerate(GEO_I32):
            out["n32"][fi, gi, :nn] = gd[f]
        out["n32"][2, gi, nn:] = np.arange(nn, n)        # win_lo pad
        for fi, f in enumerate(GEO_I8[:-1]):
            out["n8"][fi, gi, :nn] = gd[f]
        out["n8"][5, gi, :nn] = 1                        # valid
        out["digits"][gi, :gd["slen"]] = gd["digits"]
        out["slen"][gi] = gd["slen"]
    return out


def pack_geometries_multi(geoms, NT, SB, CP, tile):
    """Lay several contig geometries end to end into ONE geometry (G = 1):
    node ranges are padded to `tile` multiples and sequence ranges to
    384-byte regions with a >= 384-zero gap, so no scoring window, star
    candidate or intergenic test reaches across contigs.  Interior node
    pads are kind-4 sentinels with monotonic duplicate ndx.  Extra rows:
    "loc"/"lslen" (local coordinate and contig length per node),
    "blo"/"bhi" (contig sequence bounds) and "nbound" (CP+1 node-range
    offsets)."""
    C2 = len(geoms)
    assert C2 <= CP
    out = {
        "n32": np.zeros((len(GEO_I32), 1, NT), np.int32),
        "n8": np.zeros((len(GEO_I8), 1, NT), np.int8),
        "digits": np.zeros((1, SB), np.uint8),
        "slen": np.zeros(1, np.int32),
        "loc": np.zeros((1, NT), np.int32),
        "lslen": np.zeros((1, NT), np.int32),
        "blo": np.zeros(CP, np.int32),
        "bhi": np.zeros(CP, np.int32),
        "nbound": np.zeros(CP + 1, np.int32),
    }
    out["n8"][1] = 1          # strand pad
    nb = sb = 0
    last_ndx = 0
    for k, gd in enumerate(geoms):
        nn = gd["nn"]
        sl = slice(nb, nb + nn)
        out["n32"][0, 0, sl] = gd["ndx"] + sb
        out["n32"][1, 0, sl] = gd["stop_val"] + sb
        out["n32"][2, 0, sl] = gd["win_lo"] + nb
        for fi, f in enumerate(GEO_I8[:-1]):
            out["n8"][fi, 0, sl] = gd[f]
        out["n8"][5, 0, sl] = 1                        # valid
        out["digits"][0, sb:sb + gd["slen"]] = gd["digits"]
        out["loc"][0, sl] = gd["ndx"]
        out["lslen"][0, sl] = gd["slen"]
        out["blo"][k] = sb
        out["bhi"][k] = sb + gd["slen"]
        out["nbound"][k] = nb
        last_ndx = (int(gd["ndx"][nn - 1]) + sb) if nn else last_ndx
        nreg = -(-nn // tile) * tile
        pad = slice(nb + nn, nb + nreg)
        out["n32"][0, 0, pad] = last_ndx               # monotonic dup
        out["n32"][2, 0, pad] = np.arange(nb + nn, nb + nreg)
        nb += nreg
        sb += (gd["slen"] + 383) // 384 * 384 + 384
    out["n32"][0, 0, nb:] = last_ndx
    out["n32"][2, 0, nb:] = np.arange(nb, NT)
    out["nbound"][C2:] = nb
    out["slen"][0] = sb
    assert nb <= NT and sb <= SB
    return out


def to_device(packed, device):
    """A packed geometry dict (numpy) as torch tensors on `device` (copies
    from pageable memory: a CUDA stream synchronisation each)."""
    with tracing.span("launch.wait"):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in packed.items()}


# --------------------------------------------------------------------------
# scoring
# --------------------------------------------------------------------------

def _take(table, idx):
    """``table[b, idx[b, k]]`` for a (BT, K) table and (R, n) indices,
    R = 1 (shared by every row) or BT."""
    if idx.shape[0] == 1:
        return table[:, idx[0].long()]
    return table.gather(1, idx.long())


def _derive_m6(geo):
    """6-mer code rows (G, S) from the digit sequences, with mer_ndx
    semantics (N folds to C; reference: _sequence.h mer_ndx); m6r is zero
    past each geometry's own sequence.  No score reads that zero: the dc
    prefix sums difference only positions inside a contig, and the RBS
    scan reads a rev 6-mer past the end as `_derive_candidates` builds
    it; the zero keeps the packed prefix sums' rounding as it was."""
    d = geo["digits"].to(torch.int32)
    S = d.shape[1]
    b = d & 3
    bc = torch.where(d < 4, 3 - b, 2)
    bp = torch.nn.functional.pad(b, (0, 6))
    bcp = torch.nn.functional.pad(bc, (6, 0))
    m6f = sum(bp[:, k:k + S] << (2 * k) for k in range(6))
    m6r = sum(bcp[:, 6 - k:6 - k + S] << (2 * k) for k in range(6))
    pos = torch.arange(S, device=d.device)
    if "blo" in geo:
        # packed geometry: zero m6r outside every contig's [blo, bhi)
        inc = torch.zeros(S, dtype=torch.bool, device=d.device)
        with tracing.span("launch.wait"):
            bounds = list(zip(geo["blo"].tolist(), geo["bhi"].tolist()))
        for lo, hi in bounds:
            inc[lo:hi] = True
        m6r = torch.where(inc, m6r, 0)
    else:
        m6r = torch.where(pos < geo["slen"][:, None], m6r, 0)
    return m6f.to(torch.int32), m6r.to(torch.int32)


def _window(m6, start, L):
    """``out[g, k, w] = m6[g, start[g, k] + w]`` for w < L, 0 outside
    [0, S)."""
    G, S = m6.shape
    idx = start.long()[..., None] + torch.arange(L, device=m6.device)
    ok = (idx >= 0) & (idx < S)
    got = m6.gather(1, idx.clamp(0, S - 1).reshape(G, -1))
    return torch.where(ok, got.reshape(idx.shape), 0)


def _motif_slots():
    """Motif-candidate slot constants (reference: lib.pyx:1556-1616 scan
    order: motif length 6..3 = i 3..0, then 13 window positions)."""
    o = np.zeros(52, np.int32)
    sp = np.zeros(52, np.int32)
    ln = np.zeros(52, np.int32)
    for i in range(3, -1, -1):
        for s in range(13):
            off = s - 18 - i
            if off <= -16 - i:
                spc = 3
            elif off <= -14 - i:
                spc = 2
            elif off >= -7 - i:
                spc = 1
            else:
                spc = 0
            slot = (3 - i) * 13 + s
            o[slot], sp[slot], ln[slot] = off, spc, i
    return o, sp, ln


_MOT_O, _MOT_SP, _MOT_LEN = _motif_slots()


def _derive_candidates(geo, m6f, m6r, has_nonsd):
    """Per-geometry candidate tensors: SD codes (G, n, 15) and validity,
    upstream-composition cells (G, n, 32) and validity, motif candidates
    (G, n, 52) or None.  Every candidate is a constant offset from the
    node, so each node reads two 6-mer-code windows: [ndx-48, ndx+3) of m6f
    and [ndx+1, ndx+49) of m6r."""
    ndx = geo["n32"][0]                                # (G, n)
    n8 = geo["n8"].to(torch.int32)
    fwd = (n8[1] == 1)[..., None]
    is_start = (n8[0] != STOP)[..., None]
    not_edge = (n8[2] == 0)[..., None]
    dev = ndx.device
    # validity uses local (per-contig) coordinates
    if "loc" in geo:
        loc = geo["loc"][..., None]
        lsl = geo["lslen"][..., None]
    else:
        loc = ndx[..., None]
        lsl = geo["slen"][:, None, None]
    Wf = _window(m6f, ndx - 48, 51)
    Wr = _window(m6r, ndx + 1, 48)

    # SD: window position p reads the 6-mer at ndx-20+p (fwd; lane 28+p of
    # Wf) / ndx+20-p (rev; lane 19-p of Wr)
    p = torch.arange(15, device=dev)
    idx = torch.where(fwd, loc - 20 + p, loc + 20 - p)
    ok = (idx >= 0) & is_start & not_edge
    code = torch.where(fwd, Wf[..., 28:43], Wr[..., 5:20].flip(-1))
    # a rev 6-mer that reaches past the contig's 3' end, where m6r is zero:
    # the exact engine reads every base there as C (code 2, refcore.c
    # rc_rbs_score), and the 6-mer's bases inside the contig are the low
    # ones of the contig's last 6-mer (a fwd 6-mer never gets there)
    past = (idx + 1 - lsl).clamp(0, 6)
    last = _window(m6r, ndx - loc[..., 0] + lsl[..., 0] - 1, 1)
    code = torch.where(past > 0, (2730 & ((1 << 2 * past) - 1))
                       | ((last << 2 * past) & 4095), code)

    # upstream-composition mers: slots 0-1 = -1,-2; 2-31 = -15..-44
    with tracing.span("launch.wait"):
        ks = torch.tensor([1, 2] + list(range(15, 45)), dtype=torch.int32,
                          device=dev)
    start_coord = torch.where(fwd, loc, lsl - 1 - loc)
    uok = (ks <= start_coord) & is_start
    umer_f = torch.cat([Wf[..., 46:48].flip(-1), Wf[..., 4:34].flip(-1)], -1)
    umer_r = torch.cat([Wr[..., 0:2], Wr[..., 14:44]], -1)
    umer = torch.where(fwd, umer_f, umer_r) & 3
    ups_flat = torch.where(
        uok, torch.arange(32, device=dev) * 4 + umer, 0)

    mot = None
    if has_nonsd:
        with tracing.span("launch.wait"):
            o, mot_len, mot_sp = (torch.from_numpy(a).to(dev)
                                  for a in (_MOT_O, _MOT_LEN, _MOT_SP))
        mok = (start_coord + o >= 0) & is_start & not_edge
        mers = []
        for i in range(3, -1, -1):
            mf = Wf[..., 30 - i:43 - i]
            mr = Wr[..., 5 + i:18 + i].flip(-1)
            mers.append(torch.where(fwd, mf, mr) & ((1 << (2 * (i + 3))) - 1))
        mmer = torch.cat(mers, -1)
        mot = torch.where(
            mok,
            mot_len * 16384 + mot_sp * 4096 + mmer,
            -1)
    return code, ok, ups_flat, uok, mot


def _score_items(tables, geo, bin_idx, gidx=None, *, is_meta, closed,
                 has_nonsd):
    """cscore / sscore / rscore / uscore of every node under every row
    (reference: lib.pyx:2119-2487); `score_device._score_items` with
    skip_star=True.  Without `gidx` every row shares the one geometry of
    `geo` (mega route); with `gidx` (BT,) row b reads geometry gidx[b] of
    the G stacked in `geo` (std route).

    Returns the geometry rows (R, n) -- ndx, stop_val, typ, strand,
    win_lo, valid, edge; R = 1 shared, else BT -- the (BT, n) scores
    cscore, ssc, rsc, usc, and st_wt of the rows (BT,)."""
    (gene_dc, rbs_wt, ups_comp, type_wt, mot_wt, st_wt_t, no_mot_t,
     uses_sd_t, log_ns_t, lfmin_t, lfmax_t, _sd_ex, _sd_mm,
     sd_wi) = tables

    def rows(a):
        """(G, ...) per-geometry values as (R, ...) rows."""
        return a if gidx is None else a[gidx]

    ndx, stop_val, win_lo = (rows(geo["n32"][k]) for k in range(3))
    n8 = geo["n8"].to(torch.int32)
    typ, strand, edge, stop_real, euf, valid = (rows(n8[k])
                                                for k in range(6))
    BT = bin_idx.shape[0]
    n = ndx.shape[1]
    dev = ndx.device

    m6f, m6r = _derive_m6(geo)
    g_code, g_ok, g_ups_flat, g_uok, g_mot = _derive_candidates(
        geo, m6f, m6r, has_nonsd)

    stw = st_wt_t[bin_idx][:, None]                    # (BT, 1)
    if "loc" in geo:
        loc = geo["loc"]
        slen = geo["lslen"]
    else:
        loc = ndx
        slen = rows(geo["slen"])[:, None]
    slen_f = slen.float()
    start = (typ != STOP) & (valid != 0)
    stop = (typ == STOP) & (valid != 0)
    fwd = strand == 1
    phase = ndx % 3
    edgeb = edge != 0

    # ---- cscore pass 1: hexamer sums as phase-wise prefix differences ----
    dcrow = gene_dc[bin_idx].contiguous()              # (BT, 4096)
    S = m6f.shape[1]
    if m6f.shape[0] == 1:
        # one code row for every row: the fused lookup + prefix sum
        Cf = star_cuda.dc_phase_cumsum(dcrow, m6f[0])
        Cr = star_cuda.dc_phase_cumsum(dcrow, m6r[0])
    else:
        Cf = star_cuda.phase_cumsum(_take(dcrow, rows(m6f)))
        Cr = star_cuda.phase_cumsum(_take(dcrow, rows(m6r)))

    def pref(C, j):
        return torch.where(j >= 0, _take(C, j.clamp(0, S - 1)), 0.0)

    cs1_f = pref(Cf, stop_val - 3) - pref(Cf, ndx - 3)
    cs1_r = pref(Cr, ndx) - pref(Cr, stop_val)
    cscore = torch.where(start, torch.where(fwd, cs1_f, cs1_r), 0.0)
    del Cf, Cr

    # ---- passes 2 and 3: ascending-coding penalty and length factor,
    # segmented running maxima, one channel per phase; pass 3 carries
    # pass 2's scan state, as the reference keeps one running score[3]
    # (lib.pyx:2119-2239): one launch of the seg-scan kernel ------------
    log_ns = log_ns_t[bin_idx][:, None]
    lfmin = lfmin_t[bin_idx][:, None]
    lfmax = lfmax_t[bin_idx][:, None]
    orf_len = (ndx - stop_val).abs()
    gsize = _fdiv(orf_len.float() + 3.0, 3.0)
    tmp = torch.exp(gsize * log_ns)
    lfac_raw = torch.where(
        gsize > 1000.0,
        _fdiv((lfmax - lfmin) * (gsize - 80.0), 920.0),
        torch.log1p(-tmp) - gsize * log_ns - lfmin)
    run2, run3 = star_cuda.seg_scan_passes(
        cscore, lfac_raw, star_cuda.seg_code(phase, start, stop, fwd))
    cscore = torch.where(start, 2.0 * cscore - run2, cscore)
    lfac = torch.where(
        lfac_raw > run3, lfac_raw,
        lfac_raw - torch.clamp(torch.minimum(run3 - lfac_raw, lfac_raw),
                               min=0.0))
    cfix = torch.where((lfac > 3.0) & (cscore < 0.5 * lfac), 0.5 * lfac,
                       cscore)
    cscore = torch.where(start, cfix + lfac, cscore)

    # ---- RBS / SD score: per window position, the per-bin winner-index
    # pair (exact / 1-mismatch, packed ex * 32 + mm) and the index max
    # over positions (reference: lib.pyx:2241-2277) ----------------------
    rbs_row = rbs_wt[bin_idx]                          # (BT, 28)
    wi_row = sd_wi[bin_idx]                            # (BT, 15, 4096)
    rbs0 = torch.zeros((BT, n), dtype=torch.int64, device=dev)
    rbs1 = torch.zeros((BT, n), dtype=torch.int64, device=dev)
    for p in range(15):
        vp = _take(wi_row[:, p], rows(g_code[..., p])).long()  # (BT, n)
        okp = rows(g_ok[..., p])
        rbs0 = torch.maximum(rbs0, torch.where(okp, vp >> 5, 0))
        rbs1 = torch.maximum(rbs1, torch.where(okp, vp & 31, 0))
    w0 = rbs_row.gather(1, rbs0)
    w1 = rbs_row.gather(1, rbs1)
    sd_score = torch.maximum(w0, w1) * stw

    if has_nonsd:
        mer = g_mot & 4095
        mrow16 = mot_wt[bin_idx].reshape(BT, 16, 4096)
        best = torch.full((BT, n), -100.0, dtype=F32, device=dev)
        for s in range(52):
            ls = int(_MOT_LEN[s]) * 4 + int(_MOT_SP[s])
            vals = _take(mrow16[:, ls], rows(mer[..., s]))
            best = torch.maximum(
                best, torch.where(rows(g_mot[..., s]) >= 0, vals, -100.0))
        no_mot = no_mot_t[bin_idx][:, None]
        mot_sc = torch.where((best == -4.0) | (best < no_mot + 0.69),
                             no_mot, best)
        r_nonsd = stw * mot_sc
        # non-SD mode never runs the SD scan, so its fallback compares
        # against rbs_wt[0] (rbs0 = rbs1 = 0 in the reference)
        sd0 = (rbs_row[:, 0:1] * stw).expand_as(r_nonsd)
        r_nonsd = torch.where((r_nonsd < sd0) & (no_mot > -0.5),
                              sd0, r_nonsd)
        rscore = torch.where(uses_sd_t[bin_idx][:, None] != 0,
                             sd_score, r_nonsd)
    else:
        rscore = sd_score

    # ---- upstream composition: per-node cell counts of each geometry
    # against the bins' ups_comp rows (f64 accumulation: counts are small
    # integers).  Shared geometry: the rows' own bins, (BT, n).  Per-row
    # geometry: every (geometry, bin) pair, of which each row picks its
    # own (score_device.py:946-966) ----------------------------------------
    G, NB = g_ups_flat.shape[0], ups_comp.shape[0]
    counts = torch.zeros((G, n, 128), dtype=torch.float64, device=dev)
    counts.scatter_add_(2, g_ups_flat.long(), g_uok.double())
    if gidx is None:
        u_all = (ups_comp[bin_idx].double() @ counts[0].T).float()
    else:
        u_all = torch.einsum("gnc,bc->gbn", counts, ups_comp.double()) \
            .reshape(G * NB, n)[gidx * NB + bin_idx].float()
    u_base = u_all * (0.4 * stw)

    # ---- start score assembly (reference: lib.pyx:2331-2487) -------------
    edge0 = edge + (1 - stop_real)
    tw = type_wt[bin_idx]                              # (BT, 3)
    tw_n = tw.gather(1, typ.clamp(0, 2).long().expand(BT, n))
    tsc = torch.where(edgeb, EDGE_BONUS * stw / edge0.float(), tw_n * stw)
    rsc = torch.where(edgeb, 0.0, rscore)
    usc = torch.where(edgeb, 0.0, u_base + torch.where(
        euf != 0, EDGE_UPS * stw, 0.0))
    mut = ((not closed) & ~edgeb & start
           & (((loc <= 2) & fwd) | ((loc >= slen - 3) & ~fwd)))
    edge_gene = edge0 + mut.to(torch.int32)
    egf = edge_gene.float()
    tsc = torch.where(mut, 0.0, tsc)
    usc = torch.where(mut, EDGE_BONUS * stw / torch.clamp(egf, min=1.0),
                      usc)
    rsc = torch.where(mut, 0.0, rsc)
    edge_eff = edgeb | mut
    usc = usc - torch.where(~edge_eff & (edge_gene == 1),
                            0.5 * EDGE_BONUS * stw, 0.0)
    small = (edge_gene == 0) & (orf_len < 250)
    negf = _fdiv(250.0, torch.clamp(orf_len.float(), min=1.0))
    posf = _fdiv(orf_len.float(), 250.0)

    def scale(x):
        return torch.where(small, x * torch.where(x < 0, negf, posf), x)

    tsc, rsc, usc = scale(tsc), scale(rsc), scale(usc)
    if is_meta:
        pen = (slen < 3000) & (edge_gene == 0) & ((cscore < 5.0)
                                                  | (orf_len < 120))
        cscore = torch.where(
            start & pen,
            cscore - META_PEN * torch.clamp(
                _fdiv(3000.0 - slen_f, 2700.0), min=0.0),
            cscore)
    ssc = tsc + rsc + usc
    csneg = cscore < 0.0
    b1 = csneg & (edge_gene > 0) & ~edge_eff
    if is_meta:
        pen1 = torch.where(slen > 1500, stw, 10.31 - 0.004 * slen_f)
    else:
        pen1 = stw
    ssc = torch.where(b1, ssc - pen1, ssc)
    if is_meta:
        b2 = csneg & ~b1 & (slen < 3000) & edge_eff
        kill = b2 & (orf_len.float() >= torch.sqrt(slen_f) * 5.0)
        ssc = torch.where(kill, 0.0, ssc)
        usc = torch.where(kill, 0.0, usc)
        b3 = csneg & ~b1 & ~b2
    else:
        b3 = csneg & ~b1
    ssc = torch.where(b3, ssc - 0.5, ssc)
    if is_meta:
        b4 = ~csneg & (cscore < 5.0) & (orf_len < 120) & (ssc < 0.0)
        ssc = torch.where(b4, ssc - stw, ssc)

    # stops carry no start scores
    rsc = torch.where(start, rsc, 0.0)
    usc = torch.where(start, usc, 0.0)
    ssc = torch.where(start, ssc, 0.0)
    cscore = torch.where(valid != 0, cscore, 0.0)
    return (ndx, stop_val, typ, strand, win_lo, valid, edge,
            cscore, ssc, rsc, usc, stw[:, 0])


def score_only(tables, geo, bin_idx, gidx=None, *, is_meta, closed,
               has_nonsd):
    """Scoring without the DP, laid out as the reference's
    `score_device.score_only` with geometry rows broadcast to (BT, n):
    (ndx, stop_val, typ, strand, win_lo, valid, cscore, ssc, rsc, usc,
    edge, st_wt).  The reference returns its XLA star pointers where this
    returns `edge`: here the star kernel computes them."""
    (ndx, stop_val, typ, strand, win_lo, valid, edge,
     cscore, ssc, rsc, usc, stw) = _score_items(
        tables, geo, bin_idx, gidx, is_meta=is_meta, closed=closed,
        has_nonsd=has_nonsd)
    BT = bin_idx.shape[0]
    rows = [a.expand(BT, -1) for a in (ndx, stop_val, typ, strand, win_lo,
                                       valid)]
    return (*rows, cscore, ssc, rsc, usc, edge.expand(BT, -1), stw)


def score_dp_launch(tables, geo, bin_idx, gidx, *, closed, has_nonsd, relk,
                    max_overlap):
    """One std launch: BT work items, row b the (contig, bin) pair of
    geometry gidx[b] of `pack_geometries` and bin bin_idx[b]: scoring, the
    star kernel over per-row geometry, the std DP kernel.  Returns the
    best terminal path score per row, (BT,) f32 (the reference's
    `pack_winners`, without the bitcast; padded rows give values the
    caller ignores)."""
    with tracing.span("launch.score"):
        (ndx, stop_val, typ, strand, win_lo, valid, edge,
         cscore, ssc, rsc, usc, stw) = _score_items(
            tables, geo, bin_idx, gidx, is_meta=True, closed=closed,
            has_nonsd=has_nonsd)
    cs = (cscore + ssc).contiguous()
    rsc = rsc.contiguous()
    usc = usc.contiguous()
    stw = stw.contiguous()
    kind4 = dp_cuda.kind4_of(typ, strand, valid)
    _sp, *tables = star_cuda.star_tables(
        ndx.contiguous(), stop_val.contiguous(), kind4, edge.contiguous(),
        cs, rsc, usc, stw, relk, max_overlap)
    *_, best = dp_cuda._dp_core(ndx, stop_val, typ, strand, win_lo, valid,
                                cs, rsc, usc, tables, stw)
    return best


def score_dp_launch_mega(tables, geo, bin_idx, *, closed, has_nonsd, relk,
                         max_overlap, fxs=dp_cuda.FXS):
    """One mega launch: one contig, or a pack of contigs laid end to end
    (geo from `pack_geometries_multi`), with the candidate-bin union as
    rows: scoring, the star kernel, the mega DP kernel.

    Returns the best terminal path score per row, (BT,) f32, or per
    contig of a pack, (CP, BT) f32 (padded rows and slots give values the
    caller ignores)."""
    with tracing.span("launch.score"):
        (ndx, stop_val, typ, strand, win_lo, valid, edge,
         cscore, ssc, rsc, usc, stw) = _score_items(
            tables, geo, bin_idx, is_meta=True, closed=closed,
            has_nonsd=has_nonsd)
    ndx, stop_val, typ, strand, win_lo, valid, edge = (
        a[0] for a in (ndx, stop_val, typ, strand, win_lo, valid, edge))
    geometry = dp_cuda.mega_geometry(ndx, stop_val, typ, strand, valid,
                                     monotonic_ndx="loc" in geo)
    cs = (cscore + ssc).contiguous()
    rsc = rsc.contiguous()
    usc = usc.contiguous()
    stw = stw.contiguous()
    _sp, *tables = star_cuda.star_tables(
        ndx[None].contiguous(), stop_val[None].contiguous(),
        geometry[0][None], edge[None].contiguous(), cs, rsc, usc, stw, relk,
        max_overlap)
    *_, best = dp_cuda._dp_core_mega(
        ndx, stop_val, win_lo, geometry, cs, rsc, usc, stw, tables,
        fxs=fxs, node_bounds=geo.get("nbound"))
    return best
