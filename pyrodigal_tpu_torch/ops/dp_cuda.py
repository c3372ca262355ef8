"""The gene-path DP: CUDA kernels, plain twins and their entries.

Port of `pyrodigal_tpu.ops.dp_pallas`: the mega half (`_dp_kernel_mega`,
`_run_kernel_mega`, `_dp_core_mega`) and the std half (`_dp_kernel_b`,
`_run_kernel_b`, `_dp_core`).  `mega_dp` / `std_dp` launch
`csrc/dp_mega.cu` / `csrc/dp_std.cu` for CUDA tensors and run
`mega_dp_plain` / `std_dp_plain` for CPU tensors; a launch runs under its
tensors' device and on its current stream, and `LAUNCHES` counts them.

Path scores accumulate in int32 fixed point (score * fxs), so every
accumulation is exact and the reference's `>=` last-wins relaxation is an
integer compare (see dp_pallas.FXS).  Candidate selection is the
lexicographic (value, source index) maximum.
"""

import numpy as np
import torch

from .. import _build, tracing
from .._constants import MAX_OPP_OVLP, OPER_DIST, STOP

LAUNCHES = _build.LaunchCounts("dp_mega", "dp_std")

NEG = -1e30
NEGF_HALF = float(np.float32(-1e30)) / 2
FXS = 2048
INT_NEG = -(2 ** 30)

W_MEGA = 1024
MEGA_CHUNKS = 4                    # 4 * 1024 = 4096 node lookback
MEGA_TILE = 2048
# fwd-stop ring capacity for fwd-start targets: must cover every fwd stop
# in any [win_lo(i), i) window (host-checked in meta_cuda._mega_ok)
MEGA_RING = 256
OVW = 384                          # kind-2 overlap-window lanes
PREF = MEGA_CHUNKS * W_MEGA

# std route: sources of node i lie in [max(win_lo[i], i - STD_SPAN), i),
# the JAX kernel's FIXED_CHUNKS windows of 640 (the host route sends a
# geometry whose window reaches further down the mega route)
W_STD = 640
FIXED_CHUNKS = 3
STD_SPAN = FIXED_CHUNKS * W_STD


def _fdiv(a, c):
    """IEEE float32 a / c with a python constant on either side.  PyTorch
    computes `number / tensor` as `tensor.reciprocal() * number`, and on
    CUDA `tensor / number` as a multiply by the number's reciprocal; both
    move last bits against the reference.  Dividing by a tensor on the
    same device does not.  (The constant's copy to a card synchronises
    the stream: a `launch.wait` span there.)"""
    if isinstance(a, (int, float)):
        with _wait_on(c.device):
            a = torch.tensor(a, dtype=torch.float32, device=c.device)
    else:
        with _wait_on(a.device):
            c = torch.tensor(c, dtype=torch.float32, device=a.device)
    return a / c


def _wait_on(device):
    """A `launch.wait` span for a host sync on a card; none on the CPU,
    where the plain versions call `_fdiv` node by node."""
    return tracing.span("launch.wait") if device.type == "cuda" \
        else tracing.OFF


def _igm_same(ndx1, strand1, rsc1, usc1, ndx2, rsc2, usc2, st_wt):
    """Same-strand intergenic modifier (reference: _connection.h:52-78),
    f32 in the operation order of `dp_pallas._igm_same`."""
    dev = rsc1.device
    strand1 = torch.as_tensor(strand1, device=dev)
    ndx1 = torch.as_tensor(ndx1, device=dev)
    dist = (ndx1 - ndx2).abs()
    overlap = ndx1 + 2 * strand1 >= ndx2
    adjacent = (ndx1 + 2 == ndx2) | (ndx1 == ndx2 + 1)
    fwd = strand1 == 1
    r_n = torch.where(fwd, rsc2, rsc1)
    u_n = torch.where(fwd, usc2, usc1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rval = torch.where(
        adjacent,
        torch.where(r_n < 0, -r_n, zero) + torch.where(u_n < 0, -u_n, zero),
        zero)
    far = dist > 3 * OPER_DIST
    operon = ((dist <= OPER_DIST) & ~overlap) | (dist * 4 < OPER_DIST)
    bonus = (2.0 - _fdiv(dist.float(), OPER_DIST)) * 0.15 * st_wt
    return rval + torch.where(far, -0.15 * st_wt,
                              torch.where(operon, bonus, zero))


def _quant(x, fxs):
    """Round half to even, as jnp.round, except that a negative value
    never rounds to 0 but to -1 (csrc/common.cuh `quant`): a node's
    baseline is (0, no source) and a tie goes to the source, so a gene
    worth less than 0 in f32 must not tie with it."""
    q = torch.round(x * fxs).to(torch.int32)
    return torch.where((q == 0) & (x < 0), -1, q).to(torch.int32)


def kind4_of(typ, strand, valid):
    """Node kind: 0 fwd start, 1 fwd stop, 2 rev start, 3 rev stop, 4 pad
    (dp_pallas._dp_core)."""
    kind = 2 * (strand != 1).to(torch.int32) + (typ == STOP).to(torch.int32)
    return torch.where(valid != 0, kind, 4).to(torch.int32)


# --------------------------------------------------------------------------
# the DP: plain version
# --------------------------------------------------------------------------

def mega_dp_plain(ndx, stop_val, kind4, win_lo, ovlo, has_ov, tile_nn,
                  cs, rsc, usc, opv1, val3, t_sv, t_ndx, st_wt, fxs):
    """Plain version of `mega_dp`: loops over nodes in order, vectorised
    over bin rows and window lanes.  Geometry-only conditions are
    evaluated on host copies of the geometry rows."""
    dev = cs.device
    B, NT = cs.shape
    i32 = torch.int32
    h_ndx, h_sv, h_k4, h_wlo, h_ovlo, h_hov, h_nn = (
        a.cpu().numpy().astype(np.int64)
        for a in (ndx, stop_val, kind4, win_lo, ovlo, has_ov, tile_nn))

    score = torch.zeros((B, NT), dtype=i32, device=dev)
    traceb = torch.full((B, NT), -1, dtype=i32, device=dev)
    ovmark = torch.full((B, NT), -1, dtype=i32, device=dev)
    tbndx = torch.zeros((B, NT), dtype=i32, device=dev)
    r_val = torch.full((B, 9), INT_NEG, dtype=i32, device=dev)
    r_idx = torch.full((B, 9), -1, dtype=i32, device=dev)
    r_sv = [-(10 ** 9)] * 3
    g_val = torch.full((B, MEGA_RING), INT_NEG, dtype=i32, device=dev)
    g_j = np.full(MEGA_RING, -1, np.int64)
    g_ndx = np.zeros(MEGA_RING, np.int64)
    g_pos = 0

    stw = st_wt[:, None]
    igm_diff = -0.15 * st_wt                             # (B,)
    q_diff = _quant(igm_diff, fxs)

    def dev_idx(js):
        return torch.from_numpy(js).to(dev)

    for t in range(NT // MEGA_TILE):
        base = t * MEGA_TILE
        for i in range(base, base + int(h_nn[t])):
            kind = min(int(h_k4[i]), 3)
            i_ndx = int(h_ndx[i])
            i_sv = int(h_sv[i])
            i_fr = i_ndx % 3
            wlo = int(h_wlo[i])
            # candidates: (value (B, J) int32, valid (B, J), j, m (B, J))
            cands = []

            if kind == 0:
                al = (i - W_MEGA) // 128 * 128
                js = np.arange(max(al, wlo, 0), i)
                js = js[(h_k4[js] == 2) & (h_ndx[js] < i_ndx)]
                if len(js):
                    jt = dev_idx(js)
                    cands.append((score[:, jt] + q_diff[:, None],
                                  traceb[:, jt] != -1, jt, None))
                slots = np.nonzero((g_j != -1) & (g_j >= wlo)
                                   & (g_ndx + 2 < i_ndx))[0]
                if len(slots):
                    dist = i_ndx - g_ndx[slots]
                    dist_t = dev_idx(dist)
                    far = dev_idx(dist > 3 * OPER_DIST)
                    operon = dev_idx((dist <= OPER_DIST)
                                     | (dist * 4 < OPER_DIST))
                    bonus = (2.0 - _fdiv(dist_t.float(), OPER_DIST)) * 0.15 * stw
                    igm = torch.where(far, -0.15 * stw,
                                      torch.where(operon, bonus, 0.0))
                    val = g_val[:, dev_idx(slots)] + _quant(igm, fxs)
                    cands.append((val, torch.ones_like(val, dtype=torch.bool),
                                  dev_idx(g_j[slots]), None))

            elif kind == 1:
                lanes = [i_fr, 3 + i_fr]
                jr = r_idx[:, lanes]
                cands.append((r_val[:, lanes], jr >= wlo, jr, None))

            elif kind == 2:
                lane = 6 + i_fr
                cs_i = cs[:, i]
                jr = r_idx[:, lane:lane + 1]
                val = r_val[:, lane:lane + 1] + _quant(cs_i, fxs)[:, None]
                cands.append((val, (jr >= wlo) & (r_sv[i_fr] > i_ndx), jr,
                              None))
                if h_hov[i]:
                    olo_s = int(h_ovlo[i]) - base + PREF
                    al_s = min(max(olo_s, 0) // 128 * 128,
                               PREF + MEGA_TILE - OVW)
                    al = al_s - PREF + base
                    js = np.arange(max(al, int(h_ovlo[i]), wlo, 0),
                                   min(al + OVW, i))
                    nj = h_ndx[js]
                    ovlp = (nj + 2) - (i_sv - 2) + 1
                    js = js[(h_k4[js] == 1) & ((i_sv - 2) < (nj + 2))
                            & (ovlp < MAX_OPP_OVLP)
                            & ((nj - i_sv) < (i_ndx - nj + 3))]
                    if len(js):
                        jt = dev_idx(js)
                        tb = traceb[:, jt]
                        bnd = torch.where(tb == -1, 0, tbndx[:, jt])
                        ok = (tb != -1) & ((ndx[jt] - i_sv)[None]
                                           < (i_sv - 3 - bnd))
                        q = _quant(cs_i + igm_diff, fxs)
                        cands.append((score[:, jt] + q[:, None], ok, jt,
                                      None))

            else:
                js = np.arange(max(i - W_MEGA, wlo, 0), i)
                kj = h_k4[js]
                nj = h_ndx[js]
                right = i_ndx - 2
                js = js[((kj == 1) & (nj + 2 < right))
                        | ((kj == 2) & (nj < right))
                        | ((kj == 3) & (h_sv[js] > i_ndx))]
                if len(js):
                    jt = dev_idx(js)
                    kjt = kind4[jt]
                    f1, r1s = kjt == 1, kjt == 2
                    nj = ndx[jt]
                    tb = traceb[:, jt]
                    artifact = (tb == -1) & (f1 | r1s)
                    bnd = torch.where(tb == -1, 0, tbndx[:, jt])
                    left = (nj + 2)[None]
                    v3i, sv3i, nd3i = (a[:, :, i] for a in (val3, t_sv,
                                                              t_ndx))
                    bv = torch.zeros(tb.shape, dtype=torch.float32,
                                     device=dev)
                    bf = torch.full(tb.shape, -1, dtype=i32, device=dev)
                    for k in range(3):
                        o = left - sv3i[k][:, None] + 3
                        vald = ((o > 0) & (o < MAX_OPP_OVLP)
                                & (o < nd3i[k][:, None] - left) & (tb != -1)
                                & (o < sv3i[k][:, None] - bnd - 2))
                        better = vald & (v3i[k][:, None] > bv)
                        bv = torch.where(better, v3i[k][:, None], bv)
                        bf = torch.where(better, k, bf)
                    f_sc = torch.where(bf != -1, bv, igm_diff[:, None])
                    igm_j_i = _igm_same(nj, -1, rsc[:, jt], usc[:, jt],
                                        i_ndx, rsc[:, i:i + 1],
                                        usc[:, i:i + 1], stw)
                    v3j = v3i[(nj % 3).long()].T
                    sc = torch.where(f1, f_sc, torch.where(r1s, igm_j_i, v3j))
                    ok = ~artifact & (sc > NEGF_HALF)
                    val = score[:, jt] + _quant(torch.where(ok, sc, 0.0), fxs)
                    cands.append((val, ok, jt,
                                  torch.where(f1, bf, -1)))

            # lexicographic (value, j) max over every candidate
            if cands:
                keys, ms = [], []
                for val, ok, j, m in cands:
                    k = val.long() * 2 ** 32 + j.long()
                    keys.append(torch.where(ok, k, torch.iinfo(torch.int64)
                                            .min))
                    ms.append(m if m is not None
                              else torch.full_like(val, -1))
                key, arg = torch.cat(keys, 1).max(1)
                m_best = torch.cat(ms, 1).gather(1, arg[:, None])[:, 0]
                live = key >= 0
                best = torch.where(live, key >> 32, 0).to(i32)
                bj = torch.where(live, key & 0xFFFFFFFF, -1)
            else:
                live = torch.zeros(B, dtype=torch.bool, device=dev)
                best = torch.zeros(B, dtype=i32, device=dev)
                bj = torch.full((B,), -1, dtype=torch.int64, device=dev)
                m_best = torch.full((B,), -1, dtype=i32, device=dev)

            score[:, i] = best
            traceb[:, i] = bj.to(i32)
            ovmark[:, i] = torch.where(live, m_best, -1)
            tbndx[:, i] = torch.where(live, ndx[bj.clamp(min=0)], 0)

            # register upkeep: this node as a future source (best is the
            # committed score, 0 where nothing was committed)
            if kind == 0:
                cand = best + _quant(cs[:, i], fxs)
                m = cand >= r_val[:, i_fr]
                r_val[:, i_fr] = torch.where(m, cand, r_val[:, i_fr])
                r_idx[:, i_fr] = torch.where(m, i, r_idx[:, i_fr])
            elif kind == 1:
                slot = g_pos % MEGA_RING
                g_j[slot] = i
                g_ndx[slot] = i_ndx
                g_val[:, slot] = torch.where(live, best, INT_NEG)
                g_pos += 1
                for lane in (i_fr, 3 + i_fr):
                    r_val[:, lane] = INT_NEG
                    r_idx[:, lane] = -1
                for f2 in range(3):
                    if f2 == i_fr:
                        continue
                    opv = opv1[f2, :, i]
                    okv = live & (opv > NEGF_HALF)
                    cand = best + _quant(torch.where(okv, opv, 0.0), fxs)
                    m = okv & (cand >= r_val[:, 3 + f2])
                    r_val[:, 3 + f2] = torch.where(m, cand, r_val[:, 3 + f2])
                    r_idx[:, 3 + f2] = torch.where(m, i, r_idx[:, 3 + f2])
            elif kind == 3:
                r_val[:, 6 + i_fr] = best
                r_idx[:, 6 + i_fr] = i
                r_sv[i_fr] = i_sv
    return score, traceb, ovmark, tbndx


# --------------------------------------------------------------------------
# the DP: kernel wrapper
# --------------------------------------------------------------------------

def mega_dp(ndx, stop_val, kind4, win_lo, ovlo, has_ov, tile_nn,
            cs, rsc, usc, opv1, val3, t_sv, t_ndx, st_wt, fxs):
    """Mega DP over one shared geometry for B bin rows.

    Geometry rows ndx/stop_val/kind4/win_lo/ovlo/has_ov: (NT,) int32;
    tile_nn: (NT / MEGA_TILE,) int32 real-node counts (real nodes are a
    prefix of each tile); cs/rsc/usc: (B, NT) f32; star tables opv1/val3
    (f32) and t_sv/t_ndx (int32): (3, B, NT); st_wt: (B,) f32; fxs: the
    fixed-point scale.  Returns score (fixed point), traceb, ovmark and
    tbndx, each (B, NT) int32, tracebacks as node indices."""
    if not cs.is_cuda:
        return mega_dp_plain(ndx, stop_val, kind4, win_lo, ovlo, has_ov,
                             tile_nn, cs, rsc, usc, opv1, val3, t_sv, t_ndx,
                             st_wt, fxs)
    B, NT = cs.shape
    if NT % MEGA_TILE:
        raise ValueError(f"NT={NT} is not a multiple of {MEGA_TILE}")
    dev = cs.device
    shapes = (
        [(a, torch.int32, (NT,), n) for a, n in (
            (ndx, "ndx"), (stop_val, "stop_val"), (kind4, "kind4"),
            (win_lo, "win_lo"), (ovlo, "ovlo"), (has_ov, "has_ov"))]
        + [(tile_nn, torch.int32, (NT // MEGA_TILE,), "tile_nn")]
        + [(a, torch.float32, (B, NT), n) for a, n in (
            (cs, "cs"), (rsc, "rsc"), (usc, "usc"))]
        + [(opv1, torch.float32, (3, B, NT), "opv1"),
           (val3, torch.float32, (3, B, NT), "val3"),
           (t_sv, torch.int32, (3, B, NT), "t_sv"),
           (t_ndx, torch.int32, (3, B, NT), "t_ndx"),
           (st_wt, torch.float32, (B,), "st_wt")])
    for a, dtype, shape, name in shapes:
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name}: not contiguous on {dev}")
    if fxs not in (FXS, FXS // 2):
        raise ValueError(f"fxs={fxs}: expected {FXS} or {FXS // 2}")
    lib = _build.lib()
    # the kernel's shared-memory attribute is set on the current device
    with torch.cuda.device(dev):
        out = [torch.empty((B, NT), dtype=torch.int32, device=dev)
               for _ in range(4)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.dp_mega_launch(
            *(a.data_ptr() for a in (ndx, stop_val, kind4, win_lo, ovlo,
                                     has_ov, tile_nn, cs, rsc, usc, opv1,
                                     val3, t_sv, t_ndx, st_wt)),
            *(o.data_ptr() for o in out), B, NT, fxs, stream), "dp_mega")
    LAUNCHES.bump("dp_mega", dev, stream)
    return tuple(out)


# --------------------------------------------------------------------------
# entry: geometry derivations + DP + per-contig terminal maxima
# --------------------------------------------------------------------------

def mega_geometry(ndx, stop_val, typ, strand, valid, monotonic_ndx):
    """The DP kernel's geometry operands from (NT,) geometry rows:
    kind4, the per-tile real-node counts, the kind-2 overlap-window
    offsets `ovlo` (first node with ndx >= stop_val-3) and flags `has_ov`
    (a fwd stop lies in (stop_val-4, stop_val+195)), and `dens_ok`, False
    when some 200-bp span holds more nodes than the 384-lane window
    covers.  Packed geometries (`monotonic_ndx`) carry monotonic
    duplicate ndx in their pads; single ones sort their pads last."""
    NT = ndx.shape[0]
    dev = ndx.device
    is_valid = valid != 0
    kind4 = kind4_of(typ, strand, valid)
    tile_nn = is_valid.reshape(NT // MEGA_TILE, MEGA_TILE).sum(
        1).to(torch.int32)
    with tracing.span("launch.wait"):
        big = torch.tensor(2 ** 30, dtype=torch.int32, device=dev)
    sort_key = ndx if monotonic_ndx else torch.where(is_valid, ndx, big)
    ovlo = torch.searchsorted(sort_key, stop_val - 3).to(torch.int32)
    fs_sorted = torch.sort(torch.where(kind4 == 1, ndx, big)).values
    lo_cnt = torch.searchsorted(fs_sorted, stop_val - 3)
    hi_cnt = torch.searchsorted(fs_sorted, stop_val + 195)
    has_ov = (hi_cnt > lo_cnt).to(torch.int32)
    hi_all = torch.searchsorted(sort_key, stop_val + 195)
    vcum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      is_valid.long().cumsum(0)])
    dens_ok = torch.all(torch.where(
        (kind4 == 2) & (has_ov != 0),
        vcum[hi_all] - vcum[ovlo.long()], 0) <= 250)
    return kind4, tile_nn, ovlo, has_ov, dens_ok


def _dp_core_mega(ndx, stop_val, win_lo, geometry, cs, rsc, usc, st_wt,
                  tables, fxs=FXS, node_bounds=None):
    """`dp_pallas._dp_core_mega` with the geometry operands
    (`mega_geometry`, whose kind4 the star kernel reads too) and the star
    tables given (the star kernel always builds them on this route).

    ndx/stop_val/win_lo: (NT,) geometry rows shared by every bin row;
    cs/rsc/usc (B, NT); tables = (opv1, val3, t_sv, t_ndx), each
    (3, B, NT).  Returns (score f32, traceb, ovmark, tbndx, best): best is
    the best terminal path score per row, (B,), or per contig of a packed
    launch, (C2, B), with `node_bounds` ((C2+1,) node offsets).  A
    geometry that breaks the 384-lane overlap-window bound (see
    meta_cuda._mega_ok) gives NaN best scores."""
    ndx, stop_val, win_lo = (a.to(torch.int32).contiguous()
                             for a in (ndx, stop_val, win_lo))
    NT = ndx.shape[0]
    dev = cs.device
    kind4, tile_nn, ovlo, has_ov, dens_ok = geometry
    opv1, val3, t_sv, t_ndx = tables
    score_fx, traceb, ovmark, tbndx = mega_dp(
        ndx, stop_val, kind4, win_lo, ovlo, has_ov, tile_nn,
        cs, rsc, usc, opv1, val3, t_sv, t_ndx, st_wt, fxs)
    score = score_fx.float() * (1.0 / fxs)
    terminal = (kind4 == 1) | (kind4 == 2)
    tscore = torch.where(terminal, score, -1.0)
    tscore = torch.where(dens_ok, tscore, float("nan"))
    if node_bounds is None:
        best = tscore.max(1).values
    else:
        with tracing.span("launch.wait"):
            nb = np.asarray(node_bounds.cpu() if torch.is_tensor(node_bounds)
                            else node_bounds)
        iidx = torch.arange(NT, device=dev)
        best = torch.stack([
            torch.where((iidx >= int(nb[c])) & (iidx < int(nb[c + 1])),
                        tscore, -1.0).max(1).values
            for c in range(len(nb) - 1)])
    return score, traceb, ovmark, tbndx, best


# --------------------------------------------------------------------------
# the std route: per-row geometry (each row one (contig, bin))
# --------------------------------------------------------------------------

def std_dp_plain(ndx, stop_val, kind4, win_lo, cs, rsc, usc, opv1, val3,
                 t_sv, t_ndx, st_wt):
    """Plain version of `std_dp`: `dp_pallas._dp_kernel_b` step by step,
    vectorised over rows and window lanes, every rule in the JAX kernel's
    form and float32 operation order."""
    dev = cs.device
    BT, n = cs.shape
    i32 = torch.int32
    score = torch.zeros((BT, n), dtype=i32, device=dev)
    traceb = torch.full((BT, n), -1, dtype=i32, device=dev)
    ovmark = torch.full((BT, n), -1, dtype=i32, device=dev)
    tbndx = torch.zeros((BT, n), dtype=i32, device=dev)
    h_valid = kind4.cpu().numpy() != 4
    h_ext = np.where(h_valid, np.arange(n) - win_lo.cpu().numpy(), 0)
    stw = st_wt[:, None]
    igm_diff = -0.15 * stw
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    key_none = torch.iinfo(torch.int64).min

    for i in np.nonzero(h_valid.any(0))[0]:
        i = int(i)
        L = min(i, STD_SPAN, int(h_ext[:, i].max()))
        if L <= 0:
            continue                         # no source can reach node i
        js = torch.arange(i - L, i, device=dev)
        i_ndx, i_sv, i_kind, wlo, cs_i, rsc_i, usc_i = (
            a[:, i:i + 1] for a in (ndx, stop_val, kind4, win_lo, cs, rsc,
                                    usc))
        i_valid = i_kind != 4
        i_fr = i_ndx % 3
        i_is_stop = (i_kind == 1) | (i_kind == 3)
        i_fwd = i_kind < 2
        v3, sv3, nd3 = (a[:, :, i:i + 1] for a in (val3, t_sv, t_ndx))
        (n1_ndx, n1_sv, n1_kind, n1_cs, n1_rsc, n1_usc, n1_score, n1_tb,
         n1_tbndx) = (a[:, js] for a in (ndx, stop_val, kind4, cs, rsc, usc,
                                          score, traceb, tbndx))
        n1_fr = n1_ndx % 3
        okm = (js >= wlo) & (js >= i - STD_SPAN) & (n1_kind != 4) & i_valid

        f1_stop = n1_kind == 1
        f1_start = n1_kind == 0
        r1_stop = n1_kind == 3
        r1_start = n1_kind == 2
        n1_is_stop = f1_stop | r1_stop
        n1_fwd = n1_kind < 2
        n1_strand = torch.where(n1_fwd, 1, -1)
        skip = ((~n1_is_stop & ~i_is_stop & (n1_fwd == i_fwd))
                | (n1_fwd & ~n1_is_stop & ~i_fwd)
                | (~n1_fwd & n1_is_stop & i_fwd)
                | (~n1_fwd & ~n1_is_stop & i_fwd & i_is_stop)
                | ((n1_fwd == i_fwd) & n1_fwd & ~n1_is_stop & i_is_stop
                   & (n1_fr != i_fr))
                | ((n1_fwd == i_fwd) & ~n1_fwd & n1_is_stop & ~i_is_stop
                   & (n1_fr != i_fr)))
        artifact = (n1_tb == -1) & (f1_stop | r1_start)
        okm = okm & ~skip & ~artifact
        igm_j_i = _igm_same(n1_ndx, n1_strand, n1_rsc, n1_usc, i_ndx, rsc_i,
                            usc_i, stw)

        # case 0: i fwd start
        ok0 = ((f1_stop & ((n1_ndx + 2) < i_ndx))
               | (~f1_stop & (n1_ndx < i_ndx)))
        sc0 = torch.where(f1_stop, igm_j_i, igm_diff)
        # case 1: i fwd stop
        opv = opv1[:, :, js].gather(0, i_fr.long()[None].expand(
            1, BT, L))[0]
        ok1 = i_sv < n1_ndx
        sc1 = torch.where(f1_start, n1_cs, opv)
        # case 2: i rev start
        bnd = torch.where(n1_tb == -1, 0, n1_tbndx)
        ovlp = (n1_ndx + 2) - (i_sv - 2) + 1
        ov_ok = (((i_sv - 2) < (n1_ndx + 2)) & (ovlp < MAX_OPP_OVLP)
                 & ((n1_ndx - i_sv) < (i_ndx - n1_ndx + 3))
                 & ((n1_ndx - i_sv) < (i_sv - 3 - bnd)))
        ok2 = (r1_stop & (n1_sv > i_ndx)) | (~r1_stop & ov_ok)
        sc2 = torch.where(r1_stop, cs_i + 0 * igm_diff, cs_i + igm_diff)
        # case 3: i rev stop (triple-overlap frame loop, bv seeded at 0.0)
        left = n1_ndx + 2
        right = i_ndx - 2
        bv = torch.zeros((BT, L), dtype=torch.float32, device=dev)
        bf = torch.full((BT, L), -1, dtype=i32, device=dev)
        for k in range(3):
            o = left - sv3[k] + 3
            vald = ((o > 0) & (o < MAX_OPP_OVLP) & (o < nd3[k] - left)
                    & (n1_tb != -1) & (o < sv3[k] - bnd - 2))
            better = vald & (v3[k] > bv)
            bv = torch.where(better, v3[k], bv)
            bf = torch.where(better, k, bf)
        f_sc = torch.where(bf != -1, bv, igm_diff)
        v3j = torch.where(n1_fr == 0, v3[0],
                          torch.where(n1_fr == 1, v3[1], v3[2]))
        sc3 = torch.where(f1_stop, f_sc, torch.where(r1_start, igm_j_i, v3j))
        ok3 = ((f1_stop & (left < right)) | (r1_start & (n1_ndx < right))
               | (~f1_stop & ~r1_start & (n1_sv > i_ndx)))
        m3 = torch.where(f1_stop, bf, -1)

        cand = torch.where(
            i_kind == 0, torch.where(okm & ok0, sc0, neg),
            torch.where(
                i_kind == 1, torch.where(okm & ok1, sc1, neg),
                torch.where(i_kind == 2, torch.where(okm & ok2, sc2, neg),
                            torch.where(okm & ok3, sc3, neg))))
        m = torch.where(i_kind == 3, m3, -1)
        ok_cand = cand > NEGF_HALF
        candq = _quant(torch.where(ok_cand, cand, 0.0), FXS)
        total = (n1_score + candq).long()
        # lexicographic (total, j, m) max: the JAX kernel's largest lane
        # among equal totals, nearest chunk first
        key = torch.where(ok_cand, total * 2 ** 32 + (js * 4 + m + 1),
                          key_none).max(1).values
        live = key != key_none
        best = (key >> 32).to(i32)
        low = key & 0xFFFFFFFF
        do = live & (best > INT_NEG // 2) & (best >= 0) & i_valid[:, 0]
        bj = (low >> 2).to(i32)
        score[:, i] = torch.where(do, best, score[:, i])
        traceb[:, i] = torch.where(do, bj, traceb[:, i])
        ovmark[:, i] = torch.where(do, (low & 3).to(i32) - 1, ovmark[:, i])
        tbndx[:, i] = torch.where(
            do, ndx.gather(1, bj.clamp(min=0).long()[:, None])[:, 0],
            tbndx[:, i])
    return score, traceb, ovmark, tbndx


def std_dp(ndx, stop_val, kind4, win_lo, cs, rsc, usc, opv1, val3, t_sv,
           t_ndx, st_wt):
    """Std DP over BT rows, each with its own geometry.

    Geometry rows ndx/stop_val/kind4/win_lo and scores cs/rsc/usc: (BT, n)
    int32 / f32; star tables opv1/val3 (f32) and t_sv/t_ndx (int32):
    (3, BT, n); st_wt: (BT,) f32.  Returns score (fixed point, scale FXS),
    traceb, ovmark and tbndx, each (BT, n) int32, tracebacks as node
    indices.  Raises when a valid node's window reaches further back than
    STD_SPAN nodes: the host route sends such geometries to the mega
    route."""
    BT, n = cs.shape
    ext = torch.where(kind4 != 4, torch.arange(n, device=kind4.device)
                      - win_lo, 0)
    with tracing.span("launch.wait"):
        reach = int(ext.max()) if BT and n else 0
    if reach > STD_SPAN:
        raise ValueError(f"std_dp: a window reaches {reach} nodes "
                         f"back, past {STD_SPAN}")
    if not cs.is_cuda:
        return std_dp_plain(ndx, stop_val, kind4, win_lo, cs, rsc, usc,
                            opv1, val3, t_sv, t_ndx, st_wt)
    dev = cs.device
    shapes = (
        [(a, torch.int32, (BT, n), name) for a, name in (
            (ndx, "ndx"), (stop_val, "stop_val"), (kind4, "kind4"),
            (win_lo, "win_lo"))]
        + [(a, torch.float32, (BT, n), name) for a, name in (
            (cs, "cs"), (rsc, "rsc"), (usc, "usc"))]
        + [(opv1, torch.float32, (3, BT, n), "opv1"),
           (val3, torch.float32, (3, BT, n), "val3"),
           (t_sv, torch.int32, (3, BT, n), "t_sv"),
           (t_ndx, torch.int32, (3, BT, n), "t_ndx"),
           (st_wt, torch.float32, (BT,), "st_wt")])
    for a, dtype, shape, name in shapes:
        if a.dtype != dtype or tuple(a.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
        if not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name}: not contiguous on {dev}")
    lib = _build.lib()
    # the kernel stages a whole row in shared memory (the launch fails on
    # a row past the device's limit; this names the cause)
    smem = lib.dp_std_smem_bytes(n)
    limit = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", smem)
    if smem > limit:
        raise ValueError(f"std_dp: a row of {n} nodes needs {smem} B of "
                         f"shared memory, past the device's {limit} B")
    # the kernel's shared-memory attribute is set on the current device
    with torch.cuda.device(dev):
        out = [torch.empty((BT, n), dtype=torch.int32, device=dev)
               for _ in range(4)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib.dp_std_launch(
            *(a.data_ptr() for a in (ndx, stop_val, kind4, win_lo, cs, rsc,
                                     usc, opv1, val3, t_sv, t_ndx, st_wt)),
            *(o.data_ptr() for o in out), BT, n, stream), "dp_std")
    LAUNCHES.bump("dp_std", dev, stream)
    return tuple(out)


def _dp_core(ndx, stop_val, typ, strand, win_lo, valid, cs, rsc, usc, tables,
             st_wt):
    """`dp_pallas._dp_core` with the star tables given (the star kernel
    builds them on this route, in place of gather_near).

    Geometry rows ndx/stop_val/typ/strand/win_lo/valid and scores
    cs/rsc/usc: (BT, n), one row per work item; tables = (opv1, val3,
    t_sv, t_ndx), each (3, BT, n); st_wt (BT,).  Returns (score f32,
    traceb, ovmark, tbndx, best): tracebacks are node indices (the JAX
    kernel's lanes less its front pad W), and best is the best terminal
    path score per row, the max over valid kind-1 and kind-2 nodes, else
    -1.0."""
    ndx, stop_val, win_lo = (a.to(torch.int32).contiguous()
                             for a in (ndx, stop_val, win_lo))
    kind4 = kind4_of(typ, strand, valid)
    score_fx, traceb, ovmark, tbndx = std_dp(
        ndx, stop_val, kind4, win_lo, cs, rsc, usc, *tables, st_wt)
    score = score_fx.float() * (1.0 / FXS)
    terminal = (kind4 == 1) | (kind4 == 2)
    best = torch.where(terminal, score, -1.0).max(1).values
    return score, traceb, ovmark, tbndx, best
