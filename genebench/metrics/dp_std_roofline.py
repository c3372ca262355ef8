"""The std DP kernel (`csrc/dp_std.cu`) against its roofline over the
profiled stretch: the least time the card could take for the std
launches' work, over the kernel's device time in the trace, in %.

The work is the problem's, counted from the operands each launch passed
to `dp_cuda.std_dp` (the harness records them at the wrapper): every
input byte read once and every output byte written once (score, traceb,
ovmark, tbndx: 4 int32 a row and node), and 8 float32 operations for
each candidate source the DP's rules admit to a node, summed over every
row's valid nodes, as `dp_mega_roofline` counts them for the mega DP and
`chip_smoke.py` for this kernel."""

import numpy as np

from genebench.peaks import bound_seconds

KERNEL = "dp_std_kernel"
LANE_OPS = 8
# the std DP reads back at most this many nodes (dp_cuda.STD_SPAN)
SPAN = 3 * 640
# std_dp(ndx, stop_val, kind4, win_lo, cs, rsc, usc, opv1, val3, t_sv,
#        t_ndx, st_wt)
NDX, KIND4, WIN_LO, CS = 0, 2, 3, 4


def _prefix(mask):
    """Counts of `mask` in [0, x) for x = 0 .. len, along the last axis."""
    z = np.zeros(mask.shape[:-1] + (1,), np.int64)
    return np.concatenate([z, np.cumsum(mask, -1)], -1)


def lanes(kind4, ndx, win_lo):
    """Candidate sources the std DP's rules admit, summed over the valid
    nodes of every row, each node's window [max(win_lo, i - SPAN), i):
    a fwd start the fwd stops and rev starts, a fwd stop the fwd starts
    of its frame and the fwd stops, a rev start the fwd stops and the rev
    stops of its frame, a rev stop the nodes of kinds 1-3."""
    k4, nd, wlo = (np.asarray(a, np.int64) for a in (kind4, ndx, win_lo))
    BT, n = k4.shape
    fr = nd % 3
    i = np.arange(n)[None].repeat(BT, 0)
    lo = np.minimum(np.maximum(np.maximum(wlo, i - SPAN), 0), i)
    rows = np.arange(BT)[:, None]

    def cnt(mask):
        P = _prefix(mask)
        return P[rows, i] - P[rows, lo]

    k1, k2, k3 = cnt(k4 == 1), cnt(k4 == 2), cnt(k4 == 3)
    k0f = sum(np.where(fr == f, cnt((k4 == 0) & (fr == f)), 0)
              for f in range(3))
    k3f = sum(np.where(fr == f, cnt((k4 == 3) & (fr == f)), 0)
              for f in range(3))
    n_src = np.select([k4 == 0, k4 == 1, k4 == 2, k4 == 3],
                      [k1 + k2, k0f + k1, k1 + k3f, k1 + k2 + k3])
    return int(n_src.sum())


def launch_bound(ops):
    """Seconds of the roofline for one launch's recorded operands."""
    BT, n = ops[CS][0]
    in_bytes = sum(o[1] for o in ops if isinstance(o, tuple))
    out_bytes = 4 * BT * n * 4
    rows = [ops[j][2].cpu().numpy() for j in (KIND4, NDX, WIN_LO)]
    return bound_seconds(in_bytes + out_bytes, lanes(*rows) * LANE_OPS)


def read(run):
    t = run.trace
    launches = [ops for k, ops in run.dp_launches if k == "dp_std"]
    if t is None or not launches or not t.kernel_count(KERNEL):
        return None
    if t.kernel_count(KERNEL) != len(launches):
        raise RuntimeError(f"{t.kernel_count(KERNEL)} {KERNEL} kernels in "
                           f"the trace, {len(launches)} launches recorded")
    return 100.0 * sum(map(launch_bound, launches)) \
        / t.kernel_seconds(KERNEL)
