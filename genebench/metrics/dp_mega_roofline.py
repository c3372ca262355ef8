"""The mega DP kernel (`csrc/dp_mega.cu`) against its roofline over the
profiled stretch: the least time the card could take for the launches'
work, over the kernel's device time in the trace, in %.

The work is the problem's, counted from the operands each launch passed
to `dp_cuda.mega_dp` (the harness records them at the wrapper): every
input byte read once and every output byte written once (score, traceb,
ovmark, tbndx: 4 int32 a bin row and node), and 8 float32 operations
for each candidate source the DP's rules admit to a node (a modifier, a
quantised add, a compare), summed over the real nodes and bin rows: the
same count `chip_smoke.py` uses, so a rewritten kernel is held to it."""

import numpy as np

from genebench.peaks import bound_seconds

KERNEL = "dp_mega_kernel"
LANE_OPS = 8
# mega_dp(ndx, stop_val, kind4, win_lo, ovlo, has_ov, tile_nn, cs, rsc,
#         usc, opv1, val3, t_sv, t_ndx, st_wt, fxs)
NDX, KIND4, WIN_LO, OVLO, HAS_OV, TILE_NN, CS = 0, 2, 3, 4, 5, 6, 7


def _prefix(mask):
    """Counts of `mask` in [0, x) for x = 0 .. len, along the last axis."""
    z = np.zeros(mask.shape[:-1] + (1,), np.int64)
    return np.concatenate([z, np.cumsum(mask, -1)], -1)


def lanes(kind4, ndx, win_lo, ovlo, has_ov, tile_nn):
    """Candidate sources the mega DP's rules admit, summed over the real
    nodes of one geometry row: kind 0 the rev starts of its aligned
    window and the fwd stops of [win_lo, i); kind 1 its two registers;
    kind 2 its register and the fwd stops of its overlap window; kind 3
    the kind 1-3 nodes of its window."""
    k4, wlo, olo, hov = (np.asarray(a, np.int64)
                         for a in (kind4, win_lo, ovlo, has_ov))
    nn = np.asarray(tile_nn)
    T = len(k4) // len(nn)
    i = np.concatenate([np.arange(t * T, t * T + n) for t, n in
                        enumerate(nn)] + [np.zeros(0, int)]).astype(np.int64)
    P = [_prefix(k4 == k) for k in (1, 2, 3)]
    k, w = k4[i], wlo[i]
    al = (i - 1024) // 128 * 128
    lo0 = np.maximum(np.maximum(al, w), 0)
    lo3 = np.maximum(np.maximum(i - 1024, w), 0)
    base = i // T * T
    al_s = np.minimum(np.maximum(olo[i] - base + 4 * 1024, 0) // 128 * 128,
                      4 * 1024 + T - 384)
    al2 = al_s - 4 * 1024 + base
    lo2 = np.maximum(np.maximum(np.maximum(al2, olo[i]), w), 0)
    hi2 = np.maximum(np.minimum(al2 + 384, i), lo2)
    n = np.select(
        [k == 0, k == 1, k == 2, k == 3],
        [P[1][i] - P[1][lo0] + P[0][i] - P[0][w], np.full_like(i, 2),
         1 + np.where(hov[i] != 0, P[0][hi2] - P[0][lo2], 0),
         sum(p[i] - p[lo3] for p in P)])
    return int(n.sum())


def launch_bound(ops):
    """Seconds of the roofline for one launch's recorded operands."""
    B, NT = ops[CS][0]
    in_bytes = sum(o[1] for o in ops if isinstance(o, tuple))
    out_bytes = 4 * B * NT * 4
    rows = [ops[j][2].cpu().numpy() for j in
            (KIND4, NDX, WIN_LO, OVLO, HAS_OV, TILE_NN)]
    return bound_seconds(in_bytes + out_bytes, B * lanes(*rows) * LANE_OPS)


def read(run):
    t = run.trace
    launches = [ops for k, ops in run.dp_launches if k == "dp_mega"]
    if t is None or not launches or not t.kernel_count(KERNEL):
        return None
    if t.kernel_count(KERNEL) != len(launches):
        raise RuntimeError(f"{t.kernel_count(KERNEL)} {KERNEL} kernels in "
                           f"the trace, {len(launches)} launches recorded")
    return 100.0 * sum(map(launch_bound, launches)) \
        / t.kernel_seconds(KERNEL)
