"""Phase prefix sums, the scoring scan and the star sweep: CUDA kernels
and plain twins.

Port of `pyrodigal_tpu.ops.star_pallas` (`dc_phase_cumsum`,
`phase_cumsum`, `star_tables_mega`), of the scoring passes' segmented
running maxima (`score_device._seg_scan`, an XLA scan, four a scoring
launch: one launch of `seg_scan_passes`) and of the std
route's XLA star sweep (`score_device._score_items`).  Each wrapper
launches its kernel from `csrc/dc_chain.cu`, `csrc/phase_cumsum.cu`,
`csrc/seg_scan.cu` or `csrc/star.cu` for CUDA tensors, under the
tensors' device and on its current stream, and runs the plain PyTorch
version for CPU tensors; `LAUNCHES` counts kernel launches.
"""

import numpy as np
import torch

from .. import _build
from .dp_cuda import _igm_same as igm_same, NEG

LAUNCHES = _build.LaunchCounts("dc_chain", "phase_cumsum", "star",
                               "seg_scan")

T_SV_NONE = -(10 ** 9)


def _check(t, dtype, shape, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------------
# the two phase prefix-sum kernels' launch shape and rounding bound
# (csrc/phase_scan.cuh)
# --------------------------------------------------------------------------

TILE = 3072                 # positions a block scans at once
THREADS = 256
TARGET_CHUNKS = 64          # chunks a row aims at: 1,024 blocks at 16 rows
MIN_TILES_PER_BLOCK = 2
MAX_TILES_PER_BLOCK = 16
U = 2.0 ** -24              # f32 unit roundoff


def _chunking(S):
    """(tiles per block, chunks per row) of a prefix-sum launch over rows
    of S positions: as few tiles a block as give about TARGET_CHUNKS
    chunks a row, but at least MIN_TILES_PER_BLOCK.  It depends on S
    alone, so a row's sums add in one order whatever rows share its
    launch: a launch split over a mesh gives the unsharded launch's bits.
    The constants come from `scripts/sweep_prefix_chunking.py`, over
    the shapes the runner launches (PERF.md §6)."""
    T = -(-S // TILE)
    tpb = min(MAX_TILES_PER_BLOCK, T,
              max(MIN_TILES_PER_BLOCK, -(-T // TARGET_CHUNKS)))
    return tpb, -(-T // tpb)


def round_once_bound(x_abs, ref):
    """How far a prefix-sum kernel's f32 output may lie from the plain
    twin's (`ref`, the f64 sum rounded once): the kernels add in f64 too
    (in the order of their tiles, block scans and carries;
    csrc/phase_scan.cuh) and round each output once, so the two lie
    within one f32 ulp, 2u |ref| (1 + 2u), plus the two f64 sums' own
    error, at most 2^-52 x S x (the phase prefix sum of |x|, `x_abs`
    (B, S)).  Float64, (B, S).  Prefix sums added in f32 lie outside it."""
    cabs = phase_cumsum_plain(x_abs.double(), rounded=False)
    return (2.0 * U * (1.0 + 2.0 * U) * ref.double().abs()
            + 2.0 ** -52 * x_abs.shape[1] * cabs)


# --------------------------------------------------------------------------
# dc-chain: per-bin hexamer lookup + per-phase prefix sum
# --------------------------------------------------------------------------

def dc_phase_cumsum_plain(table, codes):
    """`out[b, p]` = sum of `table[b, codes[q]]` over q <= p, q = p mod 3.

    Accumulates in float64 and rounds once, so this is the correctly
    rounded prefix sum up to f64 error."""
    return phase_cumsum_plain(table[:, codes.long()])


def dc_phase_cumsum(table, codes):
    """Cf/Cr of the mega route: (B, 4096) f32 table, (S,) int32 codes
    shared by every row -> (B, S) f32."""
    if not table.is_cuda:
        return dc_phase_cumsum_plain(table, codes)
    B = table.shape[0]
    S = codes.shape[0]
    _check(table, torch.float32, (B, 4096), "table")
    _check(codes, torch.int32, (S,), "codes")
    if codes.device != table.device:
        raise ValueError("codes and table on different devices")
    tpb, chunks = _chunking(S)
    dev = table.device
    lib = _build.lib()
    with torch.cuda.device(dev):
        out = torch.empty((B, S), dtype=torch.float32, device=dev)
        scratch = torch.empty((B, chunks, 3), dtype=torch.float64,
                              device=dev)
        stream = _stream(dev)
        _build.check(lib.dc_chain_launch(
            table.data_ptr(), codes.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, S, tpb, stream), "dc_chain")
    LAUNCHES.bump("dc_chain", dev, stream)
    return out


# --------------------------------------------------------------------------
# phase cumsum: per-phase prefix sum of values already looked up
# --------------------------------------------------------------------------

def phase_cumsum_plain(x, rounded=True):
    """`out[b, p]` = sum of `x[b, q]` over q <= p, q = p mod 3, summed in
    float64 and rounded once (left in float64 if not `rounded`)."""
    B, S = x.shape
    pad = (-S) % 3
    xp = torch.nn.functional.pad(x.double(), (0, pad)).reshape(B, -1, 3)
    out = xp.cumsum(1).reshape(B, -1)[:, :S]
    return out.float() if rounded else out


def phase_cumsum(x):
    """Cf/Cr of the std route: (B, S) f32, each row its own looked-up dc
    scores -> (B, S) f32."""
    if not x.is_cuda:
        return phase_cumsum_plain(x)
    B, S = x.shape
    _check(x, torch.float32, (B, S), "x")
    tpb, chunks = _chunking(S)
    dev = x.device
    lib = _build.lib()
    with torch.cuda.device(dev):
        out = torch.empty_like(x)
        scratch = torch.empty((B, chunks, 3), dtype=torch.float64,
                              device=dev)
        stream = _stream(dev)
        _build.check(lib.phase_cumsum_launch(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, S, tpb,
            stream), "phase_cumsum")
    LAUNCHES.bump("phase_cumsum", dev, stream)
    return out


# --------------------------------------------------------------------------
# the scoring passes' segmented running maxima (csrc/seg_scan.cu)
# --------------------------------------------------------------------------

SEG_ROW_LIMIT = 3072  # nodes a row the seg-scan takes in one block
SEG_TILE = 4352       # walk positions a tile of its look-back over longer rows
SEG_SEED = -1e4       # pass 2's seed (the reference's score[3] start)
_MASK32 = 0xFFFFFFFF


def _ordered(x):
    """Order-preserving map of f32 values to int64 keys in [0, 2^32)."""
    b = x.view(torch.int32).long() & _MASK32
    return torch.where(b >= 2 ** 31, _MASK32 - b, b + 2 ** 31)


def _unordered(k):
    """Inverse of `_ordered`."""
    b = torch.where(k >= 2 ** 31, k - 2 ** 31, _MASK32 - k)
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def seg_scan_keys(values, elem, reset, phase, reset_val, reverse):
    """The plain twin's (BT, n, 3) int64 scan keys, segment id << 32 |
    `_ordered` value, in walk order (reversed if `reverse`), and the
    (BT, n, 3) reset counts: a cummax of the keys along the walk is the
    running max of each segment.  Arguments as `seg_scan_plain`'s."""
    ph = torch.nn.functional.one_hot(phase.long(), 3).bool()   # (R, n, 3)
    is_elem = elem[..., None] & ph
    is_reset = reset[..., None] & ph
    BT, n = values.shape
    NEGI = np.float32(-3e38)
    m = torch.where(is_reset, np.float32(reset_val),
                    torch.where(is_elem, values[..., None].expand(BT, n, 3),
                                NEGI))
    r = is_reset.expand_as(m)
    if reverse:
        m = m.flip(1)
        r = r.flip(1)
    seg = r.long().cumsum(1)
    return (seg << 32) | _ordered(m), seg


def seg_scan_plain(values, elem, reset, phase, reset_val, init, reverse,
                   exclusive):
    """Segmented running max along the nodes, one channel per phase: one
    walk of `seg_scan_passes_plain`.

    values (BT, n) f32; elem, reset (R, n) bool and phase (R, n) int in
    {0, 1, 2}, R = 1 (one geometry row for every row) or BT; init (BT, 3)
    f32, the state before the walk (after the nodes, if `reverse`).  At
    node i of channel c = phase[i] a reset sets channel c to reset_val,
    an elem takes max(channel c, values[b, i]).  Returns (own, final):
    own (BT, n) f32, each node's own channel after it (before it, if
    `exclusive`); final (BT, 3) f32, the channels after the walk.

    A cummax over int64 keys (segment id << 32 | order-preserving f32
    bits) is exact: the segment id dominates, so the running max restarts
    at each reset."""
    BT, n = values.shape
    keys, seg = seg_scan_keys(values, elem, reset, phase, reset_val,
                              reverse)
    ms = _unordered(torch.cummax(keys, 1).values & _MASK32)
    seed = init[:, None, :]
    incl = torch.where(seg > 0, ms, torch.maximum(seed, ms))
    scan = torch.cat([seed, incl[:, :-1]], 1) if exclusive else incl
    final = incl[:, -1]
    if reverse:
        scan = scan.flip(1)
    own = scan.gather(2, phase.long()[..., None].expand(BT, -1, 1))[..., 0]
    return own, final


def seg_code(phase, start, stop, fwd):
    """The seg-scan's geometry byte a node, (R, n) uint8: phase | start
    << 2 | stop << 3 | fwd << 4, from (R, n) int phase in {0, 1, 2} and
    bool start, stop and fwd."""
    return (phase + 4 * start + 8 * stop + 16 * fwd).to(torch.uint8)


def seg_scan_passes_plain(cscore, lfac_raw, code, reset_val=-1e4):
    """Scoring passes 2 and 3 as four `seg_scan_plain` calls: forward and
    reverse over cscore seeded with SEG_SEED (inclusive), then forward
    over lfac_raw seeded with the reverse pass-2 walk's final channels
    and reverse seeded with the forward pass-3 walk's (exclusive), as
    the reference keeps one running score[3] (lib.pyx:2119-2239).  cscore,
    lfac_raw (BT, n) f32; code (R, n) uint8 (`seg_code`), R = 1 or BT.
    Returns (run2, run3), (BT, n) f32: each node's own channel from the
    walk of its strand."""
    phase = (code & 3).to(torch.int32)
    start, stop, fwd = (((code >> s) & 1).bool() for s in (2, 3, 4))
    seed = torch.full((cscore.shape[0], 3), SEG_SEED, dtype=torch.float32,
                      device=cscore.device)
    start_f, start_r = start & fwd, start & ~fwd
    stop_f, stop_r = stop & fwd, stop & ~fwd
    run2_f, _ = seg_scan_plain(cscore, start_f, stop_f, phase, reset_val,
                               seed, False, False)
    run2_r, fin2r = seg_scan_plain(cscore, start_r, stop_r, phase, reset_val,
                                   seed, True, False)
    run3_f, fin3f = seg_scan_plain(lfac_raw, start_f, stop_f, phase,
                                   reset_val, fin2r, False, True)
    run3_r, _ = seg_scan_plain(lfac_raw, start_r, stop_r, phase, reset_val,
                               fin3f, True, True)
    return torch.where(fwd, run2_f, run2_r), torch.where(fwd, run3_f, run3_r)


def seg_scan_passes(cscore, lfac_raw, code, reset_val=-1e4):
    """Scoring passes 2 and 3 in one launch of the seg-scan kernel
    (`seg_scan_passes_plain`'s arguments and results; on the card all
    contiguous, code uint8).  Rows of at most SEG_ROW_LIMIT nodes take a
    block each; longer rows a decoupled look-back over tiles of SEG_TILE
    positions, on a scratch zeroed for this call.  Bit-equal to the twin
    whatever the tiling: a max is exact."""
    if not cscore.is_cuda:
        return seg_scan_passes_plain(cscore, lfac_raw, code, reset_val)
    BT, n = cscore.shape
    R = code.shape[0]
    if R not in (1, BT) or n < 1 or BT > 65535:
        raise ValueError(f"seg_scan_passes: {R} geometry rows for "
                         f"({BT}, {n})")
    _check(cscore, torch.float32, (BT, n), "cscore")
    _check(lfac_raw, torch.float32, (BT, n), "lfac_raw")
    _check(code, torch.uint8, (R, n), "code")
    dev = cscore.device
    if lfac_raw.device != dev or code.device != dev:
        raise ValueError("seg_scan_passes: operands on different devices")
    tiles = 0 if n <= SEG_ROW_LIMIT else -(-n // SEG_TILE)
    lib = _build.lib()
    with torch.cuda.device(dev):
        run2 = torch.empty_like(cscore)
        run3 = torch.empty_like(cscore)
        # tile counter, (BT, 4, tiles, 3) tile words, (BT, 2, 3) finals
        scratch = (torch.zeros(1 + BT * 4 * tiles * 3 + BT * 6,
                               dtype=torch.int64, device=dev)
                   if tiles else None)
        stream = _stream(dev)
        _build.check(lib.seg_scan_launch(
            cscore.data_ptr(), lfac_raw.data_ptr(), code.data_ptr(),
            run2.data_ptr(), run3.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), BT, n,
            0 if R == 1 else n, tiles, float(reset_val), SEG_SEED, stream),
            "seg_scan")
    LAUNCHES.bump("seg_scan", dev, stream)
    return run2, run3


# --------------------------------------------------------------------------
# star sweep + star tables
# --------------------------------------------------------------------------

STAR_TILE = 128       # nodes a block of the star kernel takes (csrc/star.cu)
STAR_ROWS = 8         # bin rows a block sweeps over one shared geometry row
STAR_MAX_RELK = 32    # steps the kernel's 32-bit candidate mask holds


def _star_rows(B, R):
    """Bin rows a block of the star kernel takes: up to STAR_ROWS over a
    shared geometry row (R = 1: its candidate masks built once for all of
    them), one where each row has its own geometry."""
    return min(B, STAR_ROWS) if R == 1 else 1


def _shifted(a, d):
    """a[..., i + d] at column i (zero outside; masked by j bounds)."""
    NT = a.shape[-1]
    out = torch.zeros_like(a)
    if d >= 0:
        out[..., :NT - d] = a[..., d:]
    else:
        out[..., -d:] = a[..., :NT + d]
    return out


def star_candidates_plain(ndx, stop_val, kind4, edge, relk, max_overlap):
    """The star kernel's candidate masks: (R, NT) int64 from (R, NT)
    geometry rows, bit k set where step k of the node's own walk (a
    forward stop's j = i + 3 - k, a reverse stop's j = i - 3 + k) passes
    every geometry test of the sweep -- j in range, a start of the stop's
    strand, within max_overlap bp, whose own stop lies past this one.
    Non-stops and edge stops get 0.  Walking the set bits in ascending
    order with cs[j] + igm is the sweep of `star_tables_plain`."""
    if not 1 <= relk <= STAR_MAX_RELK:
        raise ValueError(f"relk {relk} outside [1, {STAR_MAX_RELK}]")
    NT = ndx.shape[-1]
    kind = kind4 & 7
    edgeb = edge != 0
    fstop = (kind == 1) & ~edgeb
    rstop = (kind == 3) & ~edgeb
    iidx = torch.arange(NT, device=ndx.device)
    mo = max_overlap
    mask = torch.zeros(ndx.shape, dtype=torch.int64, device=ndx.device)
    for k in range(relk):
        bits = torch.zeros(ndx.shape, dtype=torch.bool, device=ndx.device)
        # step k of a forward stop's walk, then of a reverse stop's
        for d, stop, fwd in ((3 - k, fstop, True), (k - 3, rstop, False)):
            j = iidx + d
            ndx_j, kind_j, sv_j = (_shifted(a, d) for a in (ndx, kind,
                                                            stop_val))
            strj = torch.where(kind_j < 2, 1, -1)
            if fwd:
                okd = ((strj == 1) & (ndx_j <= ndx + 2)
                       & (ndx_j + mo >= ndx) & (sv_j > ndx))
            else:
                okd = ((strj == -1) & (ndx_j >= ndx - 2)
                       & (ndx_j - mo <= ndx) & (sv_j < ndx))
            bits |= (stop & (j >= 0) & (j < NT) & (kind_j != 4)
                     & (kind_j != 1) & (kind_j != 3) & okd)
        mask |= bits.to(torch.int64) << k
    return mask


def star_tables_plain(ndx, stop_val, kind4, edge, cs, rsc, usc, st_wt,
                      relk, max_overlap):
    """Plain version of `star_tables`: the same sweep, vectorised over
    (row, node), one step per shift; geometry rows broadcast."""
    B, NT = cs.shape
    dev = cs.device
    sv, kind = stop_val, kind4 & 7
    edgeb = edge != 0
    strand = torch.where(kind < 2, 1, -1).to(torch.int32)
    fstop = (kind == 1) & ~edgeb
    rstop = (kind == 3) & ~edgeb
    stw = st_wt[:, None]
    iidx = torch.arange(NT, device=dev)

    runmax = torch.full((B, NT), -100.0, dtype=torch.float32, device=dev)
    ptr = [torch.full((B, NT), -1, dtype=torch.int32, device=dev)
           for _ in range(3)]
    mo = max_overlap
    for t in range(2 * relk):
        is_f = t < relk
        k = t if is_f else t - relk
        d = (3 - k) if is_f else (k - 3)
        j = iidx + d
        ndx_j = _shifted(ndx, d)
        kind_j = _shifted(kind, d)
        sv_j = _shifted(sv, d)
        sc_j, rsc_j, usc_j = (_shifted(a, d) for a in (cs, rsc, usc))
        strj = torch.where(kind_j < 2, 1, -1)
        if is_f:
            okd = (fstop & (strj == 1) & (ndx_j <= ndx + 2)
                   & (ndx_j + mo >= ndx) & (sv_j > ndx))
            igm = igm_same(ndx, strand, rsc, usc, ndx_j, rsc_j, usc_j, stw)
        else:
            okd = (rstop & (strj == -1) & (ndx_j >= ndx - 2)
                   & (ndx_j - mo <= ndx) & (sv_j < ndx))
            igm = igm_same(ndx_j, -1, rsc_j, usc_j, ndx, rsc, usc, stw)
        ok = ((j >= 0) & (j < NT) & (kind_j != 4) & (kind_j != 1)
              & (kind_j != 3) & okd)
        sc = sc_j + igm
        upd = ok & (sc > runmax)
        phj = ndx_j % 3
        for f in range(3):
            ptr[f] = torch.where(upd & (phj == f), j.to(torch.int32), ptr[f])
        runmax = torch.where(upd, sc, runmax)

    sp = torch.stack(ptr)                                  # (3, B, NT)

    def at(a, q):
        return a.expand(B, -1).gather(1, q)

    opv1, val3, t_sv, t_ndx = [], [], [], []
    for f in range(3):
        okm = sp[f] != -1
        q = sp[f].clamp(min=0).long()
        gn = at(ndx, q)
        gc, gr, gu = (at(a, q) for a in (cs, rsc, usc))
        gs = torch.where(at(kind, q) < 2, 1, -1)
        neg = torch.full_like(gc, NEG)
        opv1.append(torch.where(okm, gc + igm_same(
            ndx, strand, rsc, usc, gn, gr, gu, stw), neg))
        val3.append(torch.where(okm, gc + igm_same(
            gn, gs, gr, gu, ndx, rsc, usc, stw), neg))
        t_sv.append(torch.where(okm, at(sv, q), T_SV_NONE).to(torch.int32))
        t_ndx.append(torch.where(okm, gn, 0).to(torch.int32))
    return (sp, torch.stack(opv1), torch.stack(val3), torch.stack(t_sv),
            torch.stack(t_ndx))


def star_tables(ndx, stop_val, kind4, edge, cs, rsc, usc, st_wt, relk,
                max_overlap):
    """Star sweep + tables.

    ndx/stop_val/kind4/edge: int32 geometry rows, (1, NT) shared by every
    bin row (mega route) or (B, NT), one per row (std route); cs (= cscore
    + sscore), rsc, usc: (B, NT) f32; st_wt: (B,) f32.  Returns star_ptr,
    opv1, val3, t_sv, t_ndx, each stacked over the three frames as
    (3, B, NT) -- the JAX wrapper's lists, stacked.  A block of the kernel
    takes a tile of STAR_TILE nodes and `_star_rows` bin rows; relk is at
    most STAR_MAX_RELK."""
    if not cs.is_cuda:
        return star_tables_plain(ndx, stop_val, kind4, edge, cs, rsc, usc,
                                 st_wt, relk, max_overlap)
    B, NT = cs.shape
    R = ndx.shape[0]
    if R not in (1, B):
        raise ValueError(f"star_tables: {R} geometry rows for {B} rows")
    if not 1 <= relk <= STAR_MAX_RELK:
        raise ValueError(f"star_tables: relk {relk} outside "
                         f"[1, {STAR_MAX_RELK}]")
    for t, name in ((ndx, "ndx"), (stop_val, "stop_val"), (kind4, "kind4"),
                    (edge, "edge")):
        _check(t, torch.int32, (R, NT), name)
    for t, name in ((cs, "cs"), (rsc, "rsc"), (usc, "usc")):
        _check(t, torch.float32, (B, NT), name)
    _check(st_wt, torch.float32, (B,), "st_wt")
    dev = cs.device
    if any(t.device != dev for t in (ndx, stop_val, kind4, edge, rsc, usc,
                                     st_wt)):
        raise ValueError("star_tables: operands on different devices")
    lib = _build.lib()
    with torch.cuda.device(dev):
        sp = torch.empty((3, B, NT), dtype=torch.int32, device=dev)
        opv1 = torch.empty((3, B, NT), dtype=torch.float32, device=dev)
        val3 = torch.empty((3, B, NT), dtype=torch.float32, device=dev)
        t_sv = torch.empty((3, B, NT), dtype=torch.int32, device=dev)
        t_ndx = torch.empty((3, B, NT), dtype=torch.int32, device=dev)
        stream = _stream(dev)
        _build.check(lib.star_launch(
            ndx.data_ptr(), stop_val.data_ptr(), kind4.data_ptr(),
            edge.data_ptr(), cs.data_ptr(), rsc.data_ptr(), usc.data_ptr(),
            st_wt.data_ptr(), sp.data_ptr(), opv1.data_ptr(),
            val3.data_ptr(), t_sv.data_ptr(), t_ndx.data_ptr(), B, NT, relk,
            max_overlap, 0 if R == 1 else NT, STAR_TILE, _star_rows(B, R),
            stream), "star")
    LAUNCHES.bump("star", dev, stream)
    return sp, opv1, val3, t_sv, t_ndx
