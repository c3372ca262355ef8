#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pyrodigal_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line:

1. build: compile the five CUDA kernels from `pyrodigal_tpu_torch/csrc`
   (one nvcc per source, in parallel; seconds, and registers / shared
   memory / spills of every entry function);
2. kernels: each kernel against its plain PyTorch version on the card, at
   its path's shapes, timed with CUDA events, beside its bound (bytes over
   the HBM rate or operations over the f32 rate, the larger) and, for
   phase-cumsum, `torch.cumsum` of the same function.  The two prefix
   sums are held to their sum-order bound (`star_cuda.sum_order_bound`),
   checked bit-identical across two calls, and timed as the mean of 10
   calls in one CUDA graph.  Star's pointers and integer tables are held
   exactly equal to its twin's, its float tables within rtol 1e-6 (and
   reported bit-equal or not); it is timed in a CUDA graph, as a bare C
   launch and through its wrapper on the stream, and its stops'
   candidates are counted (`star_cuda.star_candidates_plain`).  Mega
   route: dc-chain (both code rows) and star on the 2.46 Mbp genome, both
   also timed at the bench pass's other mega launches; the mega DP timed
   there and held exactly equal to its twin on the 100 kb contig and on a
   geometry with no valid node.  Std route, on the first std launch of
   the short-contig set (128 rows, 49,152 bp, 3,072 nodes): phase-cumsum
   (both code rows), star with one geometry row per bin row, and the std
   DP, also exactly equal with 16 rows emptied and on a launch of 40 kb
   genome slices whose windows reach 3 chunks of 640;
3. end to end, `pyrodigal_tpu_torch.GeneFinder(meta=True,
   backend="cuda").find_genes_batch`, each path with the launch counters
   set to 0 just before it and read just after:
   a. the mega route on the four bench contigs: output bytes (GFF,
      nucleotide and protein FASTA) held against the exact C engine, the
      launch counters, Mbp/s of a first and a warm call, the host prep's
      time alone, and the drift of the device's per-(contig, bin) best
      path scores against the exact engine's;
   b. the std route on the short-contig set: the genome cut end to end
      into ~500 contigs of lognormal length (median 3 kb), plus KK037166
      whole, in one call: bytes against the exact C engine for every
      contig, route counts (no "c"), launch counters, Mbp/s and contigs/s
      of a first and a warm call, and the drift of a std launch's best
      scores on 20 contigs;
   c. single mode, `pyrodigal_tpu_torch.GeneFinder(backend="cuda")`:
      trained on the genome (timed; the exact C engine, as in the
      reference), then `find_genes` on the genome (the mega route) and
      `find_genes_batch` on the short-contig set (the std route), each
      with the launch counters set to 0 just before it and read just
      after: GFF, nucleotide and protein FASTA and start-score bytes
      against the exact C engine's single mode for every contig, Mbp/s
      of a first and a warm call beside refcore's single-mode wall time
      on the same input (one thread and eight), each stage alone (host
      prep, the launches, exact finishing), and the device's one-row
      best scores of the first call against the exact engine's, failing
      beyond a tenth of the winner margin (`CudaMetaRunner._margin`);
      then every kernel of the genome's (8, 163,840) mega launch and of
      the short set's first std launch (16 rows) against its plain twin
      on the same inputs, within the phase 2 tolerances (the mega DP's
      twin on a CPU copy);
4. the CLI on the card: `python -m pyrodigal_tpu_torch -i <genome> -o
   -a -d -s` with the default backend against `--backend refcore`, the
   same on the short-contig set (one launch a contig), and with `-p
   meta` on MIIJ01000039: every output's bytes equal, both exit codes
   0.

Then one JSON line of kernel records, the card's name and power limit,
and, last, the result line.  Exits non-zero, with no result line, when
no CUDA device is present or any phase fails.  Imports neither jax nor
the JAX package.
"""

import concurrent.futures
import io
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
GENOME = "GCF_001457455.1_NCTC11397_genomic.fna.gz"
CONTIGS = [                                   # bench.py WORKLOAD
    GENOME,
    "MIIJ01000039.fna.gz",
    "GCF_001457455.1_NCTC11397_genomic_100kb.fna.gz",
    "SRR492066.fna.gz",
]
SHORT_EXTRA = "KK037166.fna.gz"               # a 20 kb contig, whole
U = 2.0 ** -24                                # f32 unit roundoff
KERNELS = ("dc_chain", "phase_cumsum", "star", "dp_mega", "dp_std")
# every entry function of csrc/*.cu: each kernel's own, and the chunk-total
# passes of the two prefix sums
ENTRIES = tuple(f"{k}_kernel" for k in KERNELS) + (
    "dc_chain_reduce_kernel", "phase_cumsum_reduce_kernel")
MEGA_KERNELS = ("dc_chain", "star", "dp_mega")
STD_KERNELS = ("phase_cumsum", "star", "dp_std")
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BPS = 3.35e12
F32_OPS = 67e12
# operations per candidate a kernel evaluates (a modifier, a quantised
# add, a compare): an estimate read off the kernels' inner loops
LANE_OPS = 8


def _time_ms(fn, reps):
    """Mean device milliseconds per call of fn, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _graph_ms(fn, reps):
    """Mean device milliseconds per call of fn: `reps` calls captured in
    one CUDA graph after a warm-up call, one warm replay, then one timed
    replay (no host launch time between the calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / reps


def _launch_ms(fn_name, tensors, dims, reps):
    """Mean device milliseconds of a kernel's bare C launch (its wrapper's
    checks and allocations left out: the std DP's wrapper synchronises to
    check the windows), on preallocated outputs, after one warm-up."""
    import torch

    from pyrodigal_tpu_torch import _build

    fn = getattr(_build.lib(), fn_name)
    outs = [torch.empty(dims[:2], dtype=torch.int32, device="cuda:0")
            for _ in range(4)]

    def launch():
        _build.check(fn(*(t.data_ptr() for t in tensors),
                        *(o.data_ptr() for o in outs), *dims,
                        torch.cuda.current_stream().cuda_stream), fn_name)

    return _time_ms(launch, reps)


def _star_check(label, got, ref):
    """Star outputs against the plain twin's: pointers and integer tables
    exactly equal, float tables within rtol 1e-6; returns (max abs float
    error, whether the float tables are bit-equal)."""
    import torch

    for name, a, b in zip(("star_ptr", "opv1", "val3", "t_sv", "t_ndx"),
                          got, ref):
        if a.dtype == torch.int32:
            if not torch.equal(a, b):
                raise AssertionError(f"{label} {name}: integers differ")
        elif not torch.allclose(a, b, rtol=1e-6, atol=1e-5):
            raise AssertionError(f"{label} {name}: beyond rtol 1e-6")
    floats = [(a, b) for a, b in zip(got, ref) if a.dtype == torch.float32]
    return (max(float((a - b).abs().max()) for a, b in floats),
            all(torch.equal(a, b) for a, b in floats))


def _star_timed(args):
    """The star kernel on `args` (star_tables' arguments): the mean of 10
    calls in one CUDA graph (`ms`), of 10 bare C launches on preallocated
    outputs (`ms_launch`), and of 10 wrapper calls on the stream
    (`ms_stream`: host launch cost included)."""
    import torch

    from pyrodigal_tpu_torch import _build
    from pyrodigal_tpu_torch.ops import star_cuda

    B, NT = args[4].shape
    R = args[0].shape[0]
    outs = [torch.empty((3, B, NT), dtype=dt, device=args[4].device)
            for dt in (torch.int32, torch.float32, torch.float32,
                       torch.int32, torch.int32)]
    fn = _build.lib().star_launch

    def launch():
        _build.check(fn(*(a.data_ptr() for a in args[:8]),
                        *(o.data_ptr() for o in outs), B, NT, args[8],
                        args[9], 0 if R == 1 else NT, star_cuda.STAR_TILE,
                        star_cuda._star_rows(B, R),
                        torch.cuda.current_stream().cuda_stream), "star")

    return {"ms": _graph_ms(lambda: star_cuda.star_tables(*args), 10),
            "ms_launch": _time_ms(launch, 10),
            "ms_stream": _time_ms(lambda: star_cuda.star_tables(*args), 10)}


def _star_work(args, got):
    """What the star kernel's run on `args` needs: the candidates each
    stop walks (`star_candidates_plain`: mean and most per stop over the
    geometry rows), and its bound: the bytes it reads and writes, or
    LANE_OPS a candidate and bin row, the larger."""
    from pyrodigal_tpu_torch.ops import star_cuda

    ndx, sv, kind4, edge = args[:4]
    B = args[4].shape[0]
    masks = star_cuda.star_candidates_plain(ndx, sv, kind4, edge, args[8],
                                            args[9])
    k = kind4 & 7
    stops = ((k == 1) | (k == 3)) & (edge == 0)
    count = sum((masks >> b) & 1 for b in range(args[8]))[stops]
    rows = B // ndx.shape[0]            # bin rows a geometry row serves
    n_cand = int(count.sum()) * rows
    return {"stops": int(stops.sum()),
            "candidates_per_stop_mean": float(count.double().mean()),
            "candidates_per_stop_max": int(count.max()),
            "bound": _bound(_nbytes(*args[:8]), _nbytes(*got),
                            n_cand * LANE_OPS)}


def _records(path):
    from pyrodigal_tpu_torch.fasta import parse

    return list(parse(os.path.join(DATA, path)))


def short_contigs():
    """The short-contig set, [(name, sequence)]: the 2,463,666 bp genome
    cut end to end into contigs whose lengths are lognormal (median
    3,000 bp, sigma 1.0; numpy seed 0) clipped to [500, 49,152] -- the
    shape of a metagenome assembly's short contigs -- then KK037166
    whole."""
    import numpy as np

    rec = _records(GENOME)[0]
    rng = np.random.default_rng(0)
    out, pos = [], 0
    while pos < len(rec.seq):
        n = int(np.clip(rng.lognormal(math.log(3000.0), 1.0), 500, 49152))
        out.append((f"{rec.id}_{pos + 1}", rec.seq[pos:pos + n]))
        pos += n
    out += [(r.id, r.seq) for r in _records(SHORT_EXTRA)]
    return out


def _bound_check(name, got, ref, x_abs):
    """A prefix sum against its plain (f64, rounded once) twin, within the
    kernel's sum-order bound (`star_cuda.sum_order_bound`: its depth
    times u times the prefix sum of |x|, plus the twin's rounding);
    returns (max abs err, worst ratio of error to bound)."""
    from pyrodigal_tpu_torch.ops import star_cuda

    err = (got.double() - ref.double()).abs()
    bound = star_cuda.sum_order_bound(x_abs, ref)
    if not bool((err <= bound).all()):
        raise AssertionError(
            f"{name} deviates beyond its sum-order bound: max "
            f"{float(err.max())}, worst ratio {float((err / bound).max())}")
    return float(err.max()), float((err / bound).max())


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(in_bytes, out_bytes, ops):
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over HBM_BPS and the
    operations over F32_OPS; returns (ms, "bytes" or "operations")."""
    t_bytes = (in_bytes + out_bytes) / HBM_BPS * 1e3
    t_ops = ops / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(name, source, replaces, shape, err, ms, plain_ms, bound,
            library_ms=None, **extra):
    bound_ms, bound_by = bound
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "roofline_share": bound_ms / ms, "shape": shape, **extra}


def _prefix(mask):
    """Counts of `mask` in [0, x) for x = 0 .. len, along the last axis."""
    import numpy as np

    z = np.zeros(mask.shape[:-1] + (1,), np.int64)
    return np.concatenate([z, np.cumsum(mask, -1)], -1)


def _mega_lanes(kind4, ndx, win_lo, ovlo, has_ov, tile_nn):
    """Candidate sources the mega DP's rules admit, summed over the real
    nodes of one geometry row (the JAX kernel's windows, data-dependent):
    kind 0 the rev starts of its aligned window and the fwd stops of
    [win_lo, i); kind 1 its two registers; kind 2 its register and the
    fwd stops of its overlap window; kind 3 the kind 1-3 nodes of its
    window."""
    import numpy as np

    k4, nd, wlo, olo, hov = (a.cpu().numpy().astype(np.int64)
                             for a in (kind4, ndx, win_lo, ovlo, has_ov))
    nn = tile_nn.cpu().numpy()
    T = len(k4) // len(nn)
    i = np.concatenate([np.arange(t * T, t * T + n) for t, n in
                        enumerate(nn)]).astype(np.int64)
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
    lanes = np.select(
        [k == 0, k == 1, k == 2, k == 3],
        [P[1][i] - P[1][lo0] + P[0][i] - P[0][w], np.full_like(i, 2),
         1 + np.where(hov[i] != 0, P[0][hi2] - P[0][lo2], 0),
         sum(p[i] - p[lo3] for p in P)])
    return int(lanes.sum())


def _std_lanes(kind4, ndx, win_lo):
    """Candidate sources the std DP's rules admit, summed over the valid
    nodes of every row: fwd start the fwd stops and rev starts of its
    window, fwd stop the fwd starts of its frame and the fwd stops, rev
    start the fwd stops and the rev stops of its frame, rev stop the
    nodes of kinds 1-3."""
    import numpy as np

    k4, nd, wlo = (a.cpu().numpy().astype(np.int64)
                   for a in (kind4, ndx, win_lo))
    BT, n = k4.shape
    fr = nd % 3
    i = np.arange(n)[None].repeat(BT, 0)
    lo = np.maximum(np.maximum(wlo, i - 3 * 640), 0)
    rows = np.arange(BT)[:, None]

    def cnt(mask):
        P = _prefix(mask)
        return np.maximum(P[rows, i] - P[rows, np.minimum(lo, i)], 0)

    k1, k2 = cnt(k4 == 1), cnt(k4 == 2)
    k0f = sum(np.where(fr == f, cnt((k4 == 0) & (fr == f)), 0)
              for f in range(3))
    k3f = sum(np.where(fr == f, cnt((k4 == 3) & (fr == f)), 0)
              for f in range(3))
    lanes = np.select([k4 == 0, k4 == 1, k4 == 2, k4 == 3],
                      [k1 + k2, k0f + k1, k1 + k3f, k1 + k2 + cnt(k4 == 3)])
    return int(lanes.sum())


def _prepared(runner, seq_str, tt_rows=16):
    """Host prep of one contig as the runner does it: the packed geometry
    (on the device) and the bin rows of its translation table 11."""
    import numpy as np
    import torch

    from pyrodigal_tpu_torch.sequence import Sequence
    from pyrodigal_tpu_torch.ops import dp_cuda, score_device as sd

    seq = Sequence(seq_str)
    cand, geoms, _nbt, route = runner._prepare_contig(seq)
    assert route == "mega", route
    rows = [b for b in cand
            if runner.bins[b].training_info.translation_table == 11]
    g = geoms[11]
    T = dp_cuda.MEGA_TILE
    NT = next(b for b in runner.MEGA_NT if b >= -(-g["nn"] // T) * T)
    SB = next(b for b in runner.MEGA_SB
              if b >= (g["slen"] + 383) // 384 * 384 + 384)
    packed = sd.pack_geometries_multi([g], NT, SB, 1, T)
    bin_idx = np.full(tt_rows, rows[0], np.int64)
    bin_idx[:len(rows)] = rows
    dev = runner.device
    return (sd.to_device(packed, dev), torch.from_numpy(bin_idx).to(dev),
            g, NT, SB)


def _scores(runner, geo, bin_idx):
    from pyrodigal_tpu_torch.ops import score_device as sd

    return sd._score_items(runner.tables.as_tuple(), geo, bin_idx,
                           is_meta=True, closed=False,
                           has_nonsd=runner.tables.any_nonsd)


def _mega_star_args(runner, geo, bin_idx):
    """star_tables' arguments for one mega launch, as
    `score_device.score_dp_launch_mega` builds them (scoring on the
    card)."""
    from pyrodigal_tpu_torch.ops import dp_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import RELK

    (ndx, stop_val, typ, strand, _win_lo, valid, edge,
     cscore, ssc, rsc, usc, stw) = _scores(runner, geo, bin_idx)
    kind4 = dp_cuda.mega_geometry(ndx[0], stop_val[0], typ[0], strand[0],
                                  valid[0], "loc" in geo)[0]
    return (ndx.contiguous(), stop_val.contiguous(), kind4[None],
            edge.contiguous(), (cscore + ssc).contiguous(),
            rsc.contiguous(), usc.contiguous(), stw.contiguous(), RELK,
            runner.max_overlap)


def _mega_dp_args(runner, seq_str):
    """The mega DP's operands for one contig, as its launch builds them
    (scoring and the star kernel on the card)."""
    from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import RELK

    geo, bin_idx, _g, NT, _SB = _prepared(runner, seq_str)
    (ndx, stop_val, typ, strand, win_lo, valid, edge,
     cscore, ssc, rsc, usc, stw) = _scores(runner, geo, bin_idx)
    ndx, stop_val, typ, strand, win_lo, valid, edge = (
        x[0].contiguous() for x in (ndx, stop_val, typ, strand, win_lo,
                                    valid, edge))
    kind4, tile_nn, ovlo, has_ov, _ok = dp_cuda.mega_geometry(
        ndx, stop_val, typ, strand, valid, True)
    cs = (cscore + ssc).contiguous()
    rsc, usc, stw = (a.contiguous() for a in (rsc, usc, stw))
    tables = star_cuda.star_tables(
        ndx[None], stop_val[None], kind4[None], edge[None], cs, rsc, usc,
        stw, RELK, runner.max_overlap)[1:]
    return (ndx, stop_val, kind4, win_lo, ovlo, has_ov, tile_nn, cs, rsc,
            usc, *tables, stw, dp_cuda.FXS)


def _dp_equal(name, got, ref):
    """All four DP outputs exactly equal; returns the max abs difference
    (0)."""
    import torch

    err = 0
    for field, a, b in zip(("score", "traceb", "ovmark", "tbndx"), got, ref):
        err = max(err, int((a - b).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {field}: {int((a != b).sum())} "
                                 f"entries differ")
    return err


def _plain_timed(fn, *args):
    """One host-timed call of a plain twin, on the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _entry_name(mangled):
    """The entry function of ENTRIES a (mangled) ptxas name denotes, or
    None: `<length><name>` in an Itanium-mangled name."""
    return next((n for n in ENTRIES
                 if mangled == n or f"{len(n)}{n}" in mangled), None)


def phase_build():
    from pyrodigal_tpu_torch import _build

    # build from the sources in this checkout, never a cached library
    if os.path.exists(_build.LIB_PATH):
        os.remove(_build.LIB_PATH)
    _build.lib()
    info = _build.BUILD_INFO
    kernels = {}
    current = None
    for line in info["ptxas"].splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            current = _entry_name(m.group(1))
            continue
        if current is None:
            continue
        rec = kernels.setdefault(current, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            rec["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            rec["smem"] = int(m.group(1)) if m else 0
    if {k for k, v in kernels.items() if "regs" in v} != set(ENTRIES):
        raise RuntimeError(f"ptxas report incomplete: {kernels}\n"
                           f"{info['ptxas'][-3000:]}")
    print(f"phase 1 build: nvcc {info['seconds']:.1f} s; "
          + "; ".join(f"{k}: {v['regs']} regs, {v['smem']} B smem, "
                      f"{v.get('spill', 0)} B spill"
                      for k, v in sorted(kernels.items())), flush=True)


def _prefix_kernel_record(kernel, cases, fn, plain, x_abs, bound):
    """A phase prefix-sum kernel on its path's operands: each case
    (label, args) against the plain twin within the sum-order bound and
    twice bit-identical; then the last case timed: the mean of 10 calls
    in one CUDA graph (`ms`) and on the stream through the wrapper
    (`ms_stream`: host launches included), the plain twin over 3
    calls."""
    import torch

    err, ratio = 0.0, 0.0
    for label, args in cases:
        got = fn(*args)
        ref = plain(*args)
        e, r = _bound_check(f"{kernel} ({label})", got, ref, x_abs(*args))
        err, ratio = max(err, e), max(ratio, r)
        if not torch.equal(got, fn(*args)):
            raise AssertionError(f"{kernel} ({label}): two calls differ")
        del got, ref
    args = cases[-1][1]
    bound_ms, bound_by = bound(*args)
    return {"err": err, "ratio": ratio, "ms": _graph_ms(lambda: fn(*args), 10),
            "ms_stream": _time_ms(lambda: fn(*args), 10),
            "plain_ms": _time_ms(lambda: plain(*args), 3),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _later_mega_launches(runner):
    """The bench pass's mega launches after the first (the genome alone),
    packed as `find_genes_batch` packs them (`_group_mega`, then
    `_sweep_mega_multi`'s buckets): [(geometry on the device, bin rows)]."""
    import numpy as np
    import torch

    from pyrodigal_tpu_torch.sequence import Sequence
    from pyrodigal_tpu_torch.ops import dp_cuda, score_device as sd

    items = []
    for ci, rec in enumerate(r for name in CONTIGS for r in _records(name)):
        cand, geoms, _nbt, route = runner._prepare_contig(Sequence(rec.seq))
        assert route == "mega", route
        by_tt = {}
        for b in cand:
            by_tt.setdefault(runner.bins[b].training_info.translation_table,
                             []).append(b)
        items += [{"ci": ci, "g": geoms[tt], "rows": bs}
                  for tt, bs in by_tt.items()]
    out = []
    for gr in runner._group_mega(items)[1:]:
        its = gr["items"]
        nb, sb = (sum(r) for r in zip(*(runner._mega_regions(it["g"])
                                        for it in its)))
        NT = next(b for b in runner.MEGA_NT if b >= nb)
        SB = next(b for b in runner.MEGA_SB if b >= sb)
        CP = next(c for c in runner.MEGA_CP if c >= len(its))
        rows = sorted({b for it in its for b in it["rows"]})
        B = next(b for b in runner.MEGA_ROWB if b >= len(rows))
        bin_idx = np.full(B, rows[0], np.int64)
        bin_idx[:len(rows)] = rows
        packed = sd.pack_geometries_multi([it["g"] for it in its], NT, SB,
                                          CP, dp_cuda.MEGA_TILE)
        out.append((sd.to_device(packed, runner.device),
                    torch.from_numpy(bin_idx).to(runner.device)))
    return out


def phase_kernels(runner):
    """The mega route's kernels against their plain versions on the card:
    dc-chain and star on the genome; the mega DP exactly equal on the
    100 kb contig (4 real tiles, so the kernel's three-tile ring wraps)
    and on a geometry with no valid node, timed at the genome's shape."""
    import torch

    from pyrodigal_tpu_torch.ops import dp_cuda, score_device as sd
    from pyrodigal_tpu_torch.ops import star_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import RELK

    out = []
    genome = _records(GENOME)[0].seq
    geo, bin_idx, g, NT, SB = _prepared(runner, genome)
    B = bin_idx.shape[0]
    assert (B, NT, SB) == (16, 163840, 2555904), (B, NT, SB)

    # -- dc-chain at (16, 2.56 M) on the genome's codes, both strands, then
    # timed at the shapes of the bench pass's other mega launches ---------
    table = runner.tables.gene_dc[bin_idx].contiguous()
    dc = _prefix_kernel_record(
        "dc_chain", [(strand, (table, m6[0])) for strand, m6 in
                     zip(("m6f", "m6r"), sd._derive_m6(geo))],
        star_cuda.dc_phase_cumsum, star_cuda.dc_phase_cumsum_plain,
        lambda t, c: t[:, c.long()].abs(),
        lambda t, c: _bound(_nbytes(t, c), t.shape[0] * c.shape[0] * 4,
                            t.shape[0] * c.shape[0]))
    later, later_launches = [], _later_mega_launches(runner)
    for lgeo, lbins in later_launches:
        ltable = runner.tables.gene_dc[lbins].contiguous()
        lcodes = sd._derive_m6(lgeo)[0][0]
        later.append({
            "shape": [ltable.shape[0], lcodes.shape[0]],
            "ms": _graph_ms(lambda: star_cuda.dc_phase_cumsum(ltable, lcodes),
                            10),
            "bound_ms": _bound(_nbytes(ltable, lcodes),
                               ltable.shape[0] * lcodes.shape[0] * 4,
                               ltable.shape[0] * lcodes.shape[0])[0]})
        del ltable, lcodes
    # two calls a launch (Cf, Cr)
    per_pass = 2 * (dc["ms"] + sum(x["ms"] for x in later))
    bound_pass = 2 * (dc["bound_ms"] + sum(x["bound_ms"] for x in later))
    out.append(_record(
        "dc_chain", "pyrodigal_tpu_torch/csrc/dc_chain.cu",
        "pyrodigal_tpu/ops/star_pallas.py:293", [B, SB], dc["err"],
        dc["ms"], dc["plain_ms"], (dc["bound_ms"], dc["bound_by"]),
        bound_ratio=dc["ratio"], ms_stream=dc["ms_stream"],
        bit_identical=True, later_launches=later,
        ms_bench_pass=per_pass, bound_ms_bench_pass=bound_pass))

    # -- star at (16, 163,840) from the genome's scores -------------------
    (ndx, stop_val, typ, strand, win_lo, valid, edge,
     cscore, ssc, rsc, usc, stw) = _scores(runner, geo, bin_idx)
    geometry = dp_cuda.mega_geometry(ndx[0], stop_val[0], typ[0], strand[0],
                                     valid[0], True)
    cs = (cscore + ssc).contiguous()
    args = (ndx.contiguous(), stop_val.contiguous(), geometry[0][None],
            edge.contiguous(), cs, rsc.contiguous(), usc.contiguous(),
            stw.contiguous(), RELK, runner.max_overlap)
    got = star_cuda.star_tables(*args)
    ref = star_cuda.star_tables_plain(*args)
    star_err, star_bits = _star_check("star", got, ref)
    del ref
    star = _star_timed(args)
    plain_ms = _time_ms(lambda: star_cuda.star_tables_plain(*args), 3)
    work = _star_work(args, got)
    # the bench pass's later mega launches: timed in a CUDA graph
    star_later = []
    for lgeo, lbins in later_launches:
        largs = _mega_star_args(runner, lgeo, lbins)
        lgot = star_cuda.star_tables(*largs)
        star_later.append({
            "shape": list(largs[4].shape),
            "ms": _graph_ms(lambda: star_cuda.star_tables(*largs), 10),
            "bound_ms": _star_work(largs, lgot)["bound"][0]})
        del largs, lgot
    del later_launches
    star_pass = star["ms"] + sum(x["ms"] for x in star_later)
    star_bound_pass = work["bound"][0] + sum(x["bound_ms"]
                                             for x in star_later)
    out.append(_record(
        "star", "pyrodigal_tpu_torch/csrc/star.cu",
        "pyrodigal_tpu/ops/star_pallas.py:40", [B, NT], star_err,
        star["ms"], plain_ms, work["bound"],
        ms_launch=star["ms_launch"], ms_stream=star["ms_stream"],
        float_bit_equal=star_bits, stops=work["stops"],
        candidates_per_stop_mean=work["candidates_per_stop_mean"],
        candidates_per_stop_max=work["candidates_per_stop_max"],
        later_launches=star_later, ms_bench_pass=star_pass,
        bound_ms_bench_pass=star_bound_pass))

    # the DP at the genome's shape: timed, and its µs per node step
    genome_dp = (ndx[0].contiguous(), stop_val[0].contiguous(), geometry[0],
                 win_lo[0].contiguous(), geometry[2], geometry[3],
                 geometry[1], cs, rsc.contiguous(), usc.contiguous(),
                 *got[1:], stw.contiguous(), dp_cuda.FXS)
    dp_genome_ms = _launch_ms("dp_mega_launch", genome_dp[:-1],
                              (B, NT, genome_dp[-1]), 10)
    steps_genome = int(geometry[1].sum())
    bound_genome = _bound(_nbytes(*genome_dp[:-1]), 4 * B * NT * 4,
                          B * _mega_lanes(*(genome_dp[k] for k in (2, 0, 3, 4, 5, 6)))
                          * LANE_OPS)
    del genome_dp, got, args, cs, cscore, ssc, rsc, usc

    # -- mega DP on the 100 kb contig (NT = 16,384), then on a geometry
    # with no valid node; all four outputs exactly equal ------------------
    a = _mega_dp_args(runner, _records(CONTIGS[2])[0].seq)
    B, NT = a[7].shape
    assert NT == 16384 and int(a[6].sum()) > 3 * dp_cuda.MEGA_TILE, NT
    got = dp_cuda.mega_dp(*a)
    ref, plain_ms = _plain_timed(dp_cuda.mega_dp_plain, *a)
    dp_err = _dp_equal("mega DP (100 kb)", got, ref)
    empty = list(a)
    empty[6] = torch.zeros_like(a[6])
    _dp_equal("mega DP (no valid node)", dp_cuda.mega_dp(*empty),
              dp_cuda.mega_dp_plain(*empty))
    ms = _launch_ms("dp_mega_launch", a[:-1], (B, NT, a[-1]), 10)
    steps = int(a[6].sum())
    out.append(_record(
        "dp_mega", "pyrodigal_tpu_torch/csrc/dp_mega.cu",
        "pyrodigal_tpu/ops/dp_pallas.py:470", [B, NT], float(dp_err), ms,
        plain_ms, _bound(_nbytes(*a[:-1]), 4 * B * NT * 4,
                         B * _mega_lanes(*(a[k] for k in (2, 0, 3, 4, 5, 6)))
                         * LANE_OPS),
        us_per_step=ms * 1e3 / steps, ms_genome=dp_genome_ms,
        shape_genome=[16, 163840], steps_genome=steps_genome,
        us_per_step_genome=dp_genome_ms * 1e3 / steps_genome,
        bound_ms_genome=bound_genome[0]))
    print("phase 2 kernels, mega route: " + "; ".join(
        f"{k['name']} {k['shape']}: kernel {k['ms']:.4f} ms, plain "
        f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms "
        f"({k['bound_by']}), max abs err {k['max_abs_err']:.3g}"
        for k in out) + f"; dp_mega at [16, 163840]: {dp_genome_ms:.2f} ms "
        f"= {dp_genome_ms * 1e3 / steps_genome:.3f} us per node step "
        f"({steps_genome} steps); dp_mega equal on 100 kb "
        f"({steps} steps) and on a geometry with no valid node; star: "
        f"graph {star['ms']:.4f} ms, bare launch {star['ms_launch']:.4f} "
        f"ms, wrapper on the stream {star['ms_stream']:.4f} ms, float "
        f"tables bit-equal to plain: {star_bits}, {work['stops']} stops, "
        f"candidates per stop mean {work['candidates_per_stop_mean']:.3f} "
        f"max {work['candidates_per_stop_max']}, at the later mega "
        f"launches " + ", ".join(
            f"{x['shape']} {x['ms']:.4f} ms (bound {x['bound_ms']:.4f})"
            for x in star_later) + f", {star_pass:.4f} ms a bench pass "
        f"(bound {star_bound_pass:.4f}); dc_chain "
        f"bit-identical across two calls, stream-timed {dc['ms_stream']:.4f} "
        f"ms, at the later mega launches " + ", ".join(
            f"{x['shape']} {x['ms']:.4f} ms (bound {x['bound_ms']:.4f})"
            for x in later) + f", {per_pass:.4f} ms a bench pass (bound "
        f"{bound_pass:.4f}); prefix kernels the mean of 10 calls in a CUDA "
        f"graph", flush=True)
    return out


def _first_std_launch(runner, contigs):
    """The first std launch of `contigs` as find_genes_batch packs it:
    (work, geoms)."""
    from pyrodigal_tpu_torch.sequence import Sequence

    items = []
    for ci, (_name, s) in enumerate(contigs):
        cand, geoms, _nbt, route = runner._prepare_contig(Sequence(s))
        if route == "std" and cand:
            items.append((ci, cand, geoms))
        launches = runner._pack_std(items)
        if len(launches) > 1:
            return launches[0]["work"], launches[0]["geoms"]
    raise AssertionError("the short-contig set fits one std launch")


def _std_dp_args(runner, work, geoms):
    """The std DP's operands for one std launch, as it builds them
    (scoring and the star kernel on the card), and the launch's inputs:
    (dargs, geo, bin_idx, gidx, star args, star tables)."""
    from pyrodigal_tpu_torch.ops import dp_cuda, score_device as sd
    from pyrodigal_tpu_torch.ops import star_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import RELK

    geo, bin_idx, gidx, nonsd = runner._std_inputs(work, geoms)
    (ndx, stop_val, typ, strand, win_lo, valid, edge,
     cscore, ssc, rsc, usc, stw) = sd._score_items(
        runner.tables.as_tuple(), geo, bin_idx, gidx, is_meta=True,
        closed=False, has_nonsd=nonsd)
    kind4 = dp_cuda.kind4_of(typ, strand, valid)
    cs = (cscore + ssc).contiguous()
    rsc, usc, stw = (a.contiguous() for a in (rsc, usc, stw))
    sargs = (ndx.contiguous(), stop_val.contiguous(), kind4,
             edge.contiguous(), cs, rsc, usc, stw, RELK, runner.max_overlap)
    tables = star_cuda.star_tables(*sargs)
    dargs = (sargs[0], sargs[1], kind4, win_lo.contiguous(), cs, rsc, usc,
             *tables[1:], stw)
    return dargs, geo, bin_idx, gidx, sargs, tables


def phase_kernels_std(runner, contigs):
    """The std route's kernels against their plain versions on the card,
    on the first std launch of the short-contig set; the std DP also on a
    launch of four 40 kb genome slices with win_lo lowered so that rows
    reach 3 chunks of 640, and on the first launch with 16 rows emptied
    (no valid node)."""
    import torch

    from pyrodigal_tpu_torch.ops import dp_cuda, score_device as sd
    from pyrodigal_tpu_torch.ops import star_cuda
    from pyrodigal_tpu_torch.sequence import Sequence

    work, geoms = _first_std_launch(runner, contigs)
    dargs, geo, bin_idx, gidx, sargs, tables = _std_dp_args(runner, work,
                                                            geoms)
    BT, S, n = (bin_idx.shape[0], geo["digits"].shape[1],
                geo["n32"].shape[2])
    out = []

    # -- phase cumsum on each row's looked-up dc scores, both strands;
    # PyTorch's own scan of the same function beside it ------------------
    table = runner.tables.gene_dc[bin_idx].contiguous()
    xs = [(strand, (table.gather(1, m6[gidx].long()).contiguous(),))
          for strand, m6 in zip(("m6f", "m6r"), sd._derive_m6(geo))]
    pc = _prefix_kernel_record(
        "phase_cumsum", xs, star_cuda.phase_cumsum,
        star_cuda.phase_cumsum_plain, lambda x: x.abs(),
        lambda x: _bound(_nbytes(x), _nbytes(x), x.numel()))
    x = xs[-1][1][0]
    library_ms = _time_ms(lambda: torch.cumsum(x.view(BT, S // 3, 3), 1), 3)
    out.append(_record(
        "phase_cumsum", "pyrodigal_tpu_torch/csrc/phase_cumsum.cu",
        "pyrodigal_tpu/ops/star_pallas.py:229", [BT, S], pc["err"],
        pc["ms"], pc["plain_ms"], (pc["bound_ms"], pc["bound_by"]),
        library_ms=library_ms, bound_ratio=pc["ratio"],
        ms_stream=pc["ms_stream"], bit_identical=True))
    del xs, x

    # -- star with one geometry row per bin row --------------------------
    got = tables
    star_err, star_bits = _star_check("per-row star", got,
                                      star_cuda.star_tables_plain(*sargs))
    if int((got[0] != -1).sum()) == 0:
        raise AssertionError("per-row star: no pointer set")
    timed = _star_timed(sargs)
    star_plain_ms = _time_ms(lambda: star_cuda.star_tables_plain(*sargs), 3)
    swork = _star_work(sargs, got)
    kind4 = dargs[2]
    star = {"max_abs_err_per_row": star_err, "ms_per_row": timed["ms"],
            "ms_launch_per_row": timed["ms_launch"],
            "ms_stream_per_row": timed["ms_stream"],
            "plain_ms_per_row": star_plain_ms, "shape_per_row": [BT, n],
            "bound_ms_per_row": swork["bound"][0],
            "bound_by_per_row": swork["bound"][1],
            "float_bit_equal_per_row": star_bits,
            "stops_per_row": swork["stops"],
            "candidates_per_stop_mean_per_row":
                swork["candidates_per_stop_mean"],
            "candidates_per_stop_max_per_row":
                swork["candidates_per_stop_max"]}

    # -- the std DP: all four outputs exactly equal -----------------------
    got = dp_cuda.std_dp(*dargs)
    ref, plain_ms = _plain_timed(dp_cuda.std_dp_plain, *dargs)
    _dp_equal("std DP (first launch)", got, ref)
    if int((got[1] != -1).sum()) < BT * 100:
        raise AssertionError("std DP: too few committed nodes")
    ms = _launch_ms("dp_std_launch", dargs, (BT, n), 10)
    steps = int((kind4 != 4).sum(1).max())
    # 16 rows with no valid node
    empty = list(dargs)
    empty[2] = kind4.clone()
    empty[2][::8] = 4
    _dp_equal("std DP (empty rows)", dp_cuda.std_dp(*empty),
              dp_cuda.std_dp_plain(*empty))
    # rows that reach 3 chunks: four 40 kb genome slices, win_lo lowered to
    # i - 1,900 (the DP is defined for any win_lo <= i)
    genome = _records(GENOME)[0].seq
    items = []
    for k in range(16):
        cand, gs, _nbt, route = runner._prepare_contig(
            Sequence(genome[k * 40000:(k + 1) * 40000]))
        if route == "std" and len(items) < 4:
            items.append((k, cand, gs))
    (launch,) = runner._pack_std(items)
    deep = list(_std_dp_args(runner, launch["work"], launch["geoms"])[0])
    nn_deep = int((deep[2] != 4).sum(1).max())
    assert nn_deep > 2 * 640, nn_deep
    deep[3] = torch.clamp(torch.arange(deep[3].shape[1], device=deep[3].device,
                                       dtype=torch.int32) - 1900,
                          min=0)[None].expand_as(deep[3]).contiguous()
    ref_deep, plain_deep_ms = _plain_timed(dp_cuda.std_dp_plain, *deep)
    _dp_equal("std DP (3 chunks)", dp_cuda.std_dp(*deep), ref_deep)
    deep_ms = _launch_ms("dp_std_launch", deep, tuple(deep[4].shape), 10)
    out.append(_record(
        "dp_std", "pyrodigal_tpu_torch/csrc/dp_std.cu",
        "pyrodigal_tpu/ops/dp_pallas.py:76", [BT, n], 0.0, ms, plain_ms,
        _bound(_nbytes(*dargs), 4 * BT * n * 4,
               _std_lanes(kind4, dargs[0], dargs[3]) * LANE_OPS),
        nodes_max=steps, us_per_step=ms * 1e3 / steps,
        ms_3chunks=deep_ms, plain_ms_3chunks=plain_deep_ms,
        shape_3chunks=list(deep[4].shape), nodes_max_3chunks=nn_deep))
    print(f"phase 2 kernels, std route (first std launch: {len(work)} work "
          f"items, {len(geoms)} geometries, BT {BT}, S {S}, n {n}): "
          + "; ".join(f"{k['name']} {k['shape']}: kernel {k['ms']:.4f} ms, "
                      f"plain {k['plain_ms']:.3f} ms, bound "
                      f"{k['bound_ms']:.4f} ms ({k['bound_by']}), max abs "
                      f"err {k['max_abs_err']:.3g}" for k in out)
          + f"; phase_cumsum bit-identical across two calls, stream-timed "
          f"{pc['ms_stream']:.4f} ms; torch.cumsum of the same function "
          f"{library_ms:.3f} ms"
          f"; dp_std {ms * 1e3 / steps:.3f} us per node step ({steps} "
          f"steps), equal with 16 rows emptied, and on a 3-chunk launch "
          f"{list(deep[4].shape)} ({nn_deep} nodes, win_lo = i - 1900): "
          f"kernel {deep_ms:.3f} ms, plain {plain_deep_ms:.1f} ms"
          f"; per-row star {star['shape_per_row']}: graph "
          f"{timed['ms']:.4f} ms, bare launch {timed['ms_launch']:.4f} ms, "
          f"wrapper on the stream {timed['ms_stream']:.4f} ms, plain "
          f"{star_plain_ms:.3f} ms, bound {swork['bound'][0]:.4f} ms, max abs "
          f"err {star_err:.3g}, float tables bit-equal to plain: "
          f"{star_bits}, {swork['stops']} stops, candidates per stop mean "
          f"{swork['candidates_per_stop_mean']:.3f} max "
          f"{swork['candidates_per_stop_max']}; kernels the mean of 10 calls, plain "
          f"phase-cumsum, star and torch.cumsum of 3, the plain DPs one "
          f"host-timed call", flush=True)
    return out, star


def _outputs(genes, name, scores=False):
    """GFF, nucleotide and protein FASTA bytes, and with `scores` the
    start-score table's."""
    streams = []
    writers = [genes.write_gff, genes.write_genes, genes.write_translations]
    for write in writers + [genes.write_scores] * scores:
        f = io.StringIO()
        write(f, name)
        streams.append(f.getvalue().encode())
    return streams


def _refcore(seqs):
    """The exact C engine's genes for every contig, numbered as one call
    of a fresh GeneFinder numbers them (num_seq 1, 2, ...), on 8
    threads."""
    import pyrodigal_tpu_torch

    def one(i):
        finder = pyrodigal_tpu_torch.GeneFinder(meta=True,
                                                backend="refcore")
        finder._num_seq = i + 1
        return finder.find_genes(seqs[i])

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        return list(ex.map(one, range(len(seqs))))


def _zero_counts():
    from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda

    for counts in (star_cuda.LAUNCHES, dp_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _counts():
    from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda

    return {**star_cuda.LAUNCHES, **dp_cuda.LAUNCHES}


def _timed_call(fn, *args):
    """(result, host seconds) of one call, synchronised on both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _bytes_equal(named, got, ref, scores):
    for (name, _s), a, b in zip(named, got, ref):
        kinds = ("GFF", "FNA", "FAA", "scores")
        for kind, x, y in zip(kinds, _outputs(a, name, scores),
                              _outputs(b, name, scores)):
            if x != y:
                raise AssertionError(f"{name}: {kind} bytes differ from "
                                     f"refcore")


def _drive(named, kernels):
    """One path end to end: a fresh GeneFinder(meta=True, backend="cuda")
    on [(name, sequence)], the launch counters set to 0 just before its
    first call and read just after; then a warm call, the host prep alone,
    and the bytes of every contig against the exact C engine.  Fails when
    a kernel of `kernels` was not launched or a contig took "c"."""
    import torch

    import pyrodigal_tpu_torch
    from pyrodigal_tpu_torch.sequence import Sequence

    seqs = [s for _n, s in named]
    finder = pyrodigal_tpu_torch.GeneFinder(meta=True, backend="cuda")
    runner = finder._get_meta_runner()
    _zero_counts()
    got, wall = _timed_call(finder.find_genes_batch, seqs)
    launches = _counts()
    routes = dict(runner.route_counts)

    t0 = time.perf_counter()
    finder.find_genes_batch(seqs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    list(runner.pool.map(runner._prepare_contig, map(Sequence, seqs)))
    prep = time.perf_counter() - t0

    t0 = time.perf_counter()
    ref = _refcore(seqs)
    ref_s = time.perf_counter() - t0
    _bytes_equal(named, got, ref, scores=False)
    if min(launches[k] for k in kernels) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if routes["c"]:
        raise AssertionError(f"contigs took the C fallback: {routes}")
    return {"runner": runner, "bp": sum(len(s) for s in seqs),
            "genes": sum(len(g) for g in got), "wall": wall, "warm": warm,
            "prep": prep, "refcore_s": ref_s, "launches": launches,
            "routes": routes}


def _exact_score(runner, seq, nodes_by_tt, b):
    nodes = runner._score_winner(seq, nodes_by_tt, b)
    ip = nodes.dynamic_programming(runner.bins[b].training_info, final=True)
    return float(nodes.score[ip]) if nodes.length > 0 and ip >= 0 else None


def phase_end_to_end_mega():
    """Phase 3a: the four bench contigs, all on the mega route."""
    from pyrodigal_tpu_torch.sequence import Sequence

    recs = [r for name in CONTIGS for r in _records(name)]
    r = _drive([(rec.id, rec.seq) for rec in recs], MEGA_KERNELS)
    runner = r["runner"]
    # per-(contig, bin) device best scores against the exact engine's
    drift = 0.0
    for rec in recs[2:]:
        seq = Sequence(rec.seq)
        cand, geoms, nodes_by_tt, _route = runner._prepare_contig(seq)
        by_tt = {}
        for b in cand:
            by_tt.setdefault(runner.bins[b].training_info.translation_table,
                             []).append(b)
        for tt, rows in by_tt.items():
            bests, brows, _CP, _B = runner._sweep_mega_multi(
                [{"ci": 0, "g": geoms[tt], "rows": rows}])
            pos = {b: i for i, b in enumerate(brows)}
            for b in rows:
                exact = _exact_score(runner, seq, nodes_by_tt, b)
                if exact is None:
                    continue
                dev = float(bests[0, pos[b]])
                drift = max(drift, abs(dev - exact) / max(abs(exact), 1.0))
    print(f"phase 3a end to end, mega route: {len(recs)} contigs, "
          f"{r['bp']} bp, {r['genes']} genes in {r['wall']:.3f} s = "
          f"{r['bp'] / r['wall'] / 1e6:.4f} Mbp/s (first call); warm call "
          f"{r['warm']:.3f} s = {r['bp'] / r['warm'] / 1e6:.4f} Mbp/s; host "
          f"prep alone on the same pool {r['prep']:.3f} s; GFF/FNA/FAA bytes "
          f"equal to refcore (refcore {r['refcore_s']:.1f} s on 8 threads); "
          f"launches {r['launches']}; routes {r['routes']}; max relative "
          f"drift of device best scores vs exact (100 kb, 80 kb): "
          f"{drift:.3g}", flush=True)
    runner.close()
    return r["launches"]


def phase_end_to_end_std(contigs):
    """Phase 3b: the short-contig set, the std route."""
    from pyrodigal_tpu_torch.sequence import Sequence

    r = _drive(contigs, STD_KERNELS)
    runner = r["runner"]
    if r["routes"]["std"] <= 0:
        raise AssertionError(f"no contig took the std route: {r['routes']}")
    # per-(contig, bin) best scores of std launches against the exact
    # engine's, on the first 20 std-route contigs with candidate bins
    items, seqs, maps = [], {}, {}
    for ci, (_name, s) in enumerate(contigs):
        seq = Sequence(s)
        cand, geoms, nodes_by_tt, route = runner._prepare_contig(seq)
        if route == "std" and cand:
            items.append((ci, cand, geoms))
            seqs[ci], maps[ci] = seq, nodes_by_tt
        if len(items) == 20:
            break
    drift, drift_abs, n_cmp = 0.0, 0.0, 0
    for L in runner._pack_std(items):
        bests = runner._sweep_std(L["work"], L["geoms"])
        for k, (ci, b, _key) in enumerate(L["work"]):
            exact = _exact_score(runner, seqs[ci], maps[ci], b)
            if exact is None:
                continue
            diff = abs(float(bests[k]) - exact)
            drift = max(drift, diff / max(abs(exact), 1.0))
            drift_abs = max(drift_abs, diff)
            n_cmp += 1
    n = len(contigs)
    print(f"phase 3b end to end, std route: {n} contigs, {r['bp']} bp, "
          f"{r['genes']} genes in {r['wall']:.3f} s = "
          f"{r['bp'] / r['wall'] / 1e6:.4f} Mbp/s, {n / r['wall']:.1f} "
          f"contigs/s (first call); warm call {r['warm']:.3f} s = "
          f"{r['bp'] / r['warm'] / 1e6:.4f} Mbp/s, {n / r['warm']:.1f} "
          f"contigs/s; host prep alone on the same pool {r['prep']:.3f} s; "
          f"GFF/FNA/FAA bytes equal to refcore for every contig (refcore "
          f"{r['refcore_s']:.1f} s on 8 threads); routes {r['routes']}; "
          f"std launches {r['launches']['dp_std']}; launches "
          f"{r['launches']}; max relative drift of std-launch best scores "
          f"vs exact ({n_cmp} (contig, bin) pairs of 20 contigs): "
          f"{drift:.3g} (max abs {drift_abs:.3g})", flush=True)
    runner.close()
    return r["launches"]


def _refcore_single(tinf, seqs, num_seq, threads):
    """The exact C engine's single mode on `seqs`, numbered from
    `num_seq` as one finder's calls number them, on `threads` threads;
    returns (genes, wall seconds)."""
    import pyrodigal_tpu_torch

    def one(i):
        finder = pyrodigal_tpu_torch.GeneFinder(training_info=tinf,
                                                backend="refcore")
        finder._num_seq = num_seq + i
        return finder.find_genes(seqs[i])

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        out = list(ex.map(one, range(len(seqs))))
    return out, time.perf_counter() - t0


def _single_stages(runner, seqs, route):
    """Each stage of a single-mode call alone, on the runner's pools: the
    host prep of every contig, the device launches one after another (the
    genome's mega launch, or the std launches of the std-route contigs),
    and the exact engine's finishing of every contig.  Returns (prep s,
    launches s, launches, finishing s, the launches' work: [(sweep,
    args)])."""
    import torch

    from pyrodigal_tpu_torch.sequence import Sequence

    contigs = [Sequence(s) for s in seqs]
    preps, prep_s = _timed_call(
        lambda: list(runner.pool.map(runner._prepare_contig, contigs)))
    if route == "mega":
        _c, geoms, _nbt, _r = preps[0]
        work = [(runner._sweep_mega_multi,
                 ([{"ci": 0, "g": next(iter(geoms.values())),
                    "rows": [0]}],))]
    else:
        work = [(runner._sweep_std, (L["work"], L["geoms"]))
                for L in runner._pack_std(
                    [(ci, p[0], p[1]) for ci, p in enumerate(preps)
                     if p[3] == "std"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for sweep, args in work:
        sweep(*args)
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0

    def finish(ci):
        return runner._produce_single(contigs[ci], 1, preps[ci][2])

    _f, finish_s = _timed_call(
        lambda: list(runner.pool.map(finish, range(len(contigs)))))
    return prep_s, launch_s, len(work), finish_s, work


# kernel -> (module, wrapper, plain twin)
WRAPPERS = {
    "dc_chain": ("star_cuda", "dc_phase_cumsum", "dc_phase_cumsum_plain"),
    "phase_cumsum": ("star_cuda", "phase_cumsum", "phase_cumsum_plain"),
    "star": ("star_cuda", "star_tables", "star_tables_plain"),
    "dp_mega": ("dp_cuda", "mega_dp", "mega_dp_plain"),
    "dp_std": ("dp_cuda", "std_dp", "std_dp_plain"),
}


def _captured(fn, *args):
    """fn(*args) with every kernel wrapper recording its calls; returns
    [(kernel, arguments, output)] in call order."""
    from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda

    mods = {"star_cuda": star_cuda, "dp_cuda": dp_cuda}
    calls, saved = [], []
    for name, (mod, wrapper, _plain) in WRAPPERS.items():
        orig = getattr(mods[mod], wrapper)
        saved.append((mods[mod], wrapper, orig))

        def record(*a, _orig=orig, _name=name):
            out = _orig(*a)
            calls.append((_name, a, out))
            return out

        setattr(mods[mod], wrapper, record)
    try:
        fn(*args)
    finally:
        for mod, wrapper, orig in saved:
            setattr(mod, wrapper, orig)
    return calls


def _single_kernel_checks(label, sweep, args):
    """Every kernel call of one single-mode launch against its plain twin
    on the same inputs: the prefix sums within their sum-order bound,
    star's pointers and integer tables exact and its floats within rtol
    1e-6, the DPs' four outputs exactly equal.  The mega DP's twin runs on
    a CPU copy of the inputs, as the CPU tests run it (on the card it
    would take minutes at the genome's 153 k node steps).  Returns
    {kernel: (max abs err, shape)}."""
    import torch

    from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda

    mods = {"star_cuda": star_cuda, "dp_cuda": dp_cuda}
    out = {}
    for name, a, got in _captured(sweep, *args):
        plain = getattr(mods[WRAPPERS[name][0]], WRAPPERS[name][2])
        tag = f"single mode, {label}: {name}"
        if name == "dc_chain":
            err, _r = _bound_check(tag, got, plain(*a),
                                   a[0][:, a[1].long()].abs())
            shape = [a[0].shape[0], a[1].shape[0]]
        elif name == "phase_cumsum":
            err, _r = _bound_check(tag, got, plain(*a), a[0].abs())
            shape = list(a[0].shape)
        elif name == "star":
            err, _bits = _star_check(tag, got, plain(*a))
            shape = list(a[4].shape)
        else:
            if name == "dp_mega":
                ref = plain(*(x.cpu() if torch.is_tensor(x) else x
                              for x in a))
                got = tuple(x.cpu() for x in got)
            else:
                ref = plain(*a)
            err = float(_dp_equal(tag, got, ref))
            shape = list(a[7].shape if name == "dp_mega" else a[4].shape)
        e0, shapes = out.get(name, (0.0, []))
        out[name] = (max(e0, err), shapes + [shape])
    return out


def phase_single(contigs):
    """Phase 3c: single mode on the card, trained on the genome; the
    genome alone (mega route), then the short-contig set in one call
    (std route).  Each call's launches record their one-row best scores
    against the exact engine's (`CudaMetaRunner.single_drift`); the run
    fails beyond a tenth of the winner margin.  Then every kernel of the
    genome's (8, 163,840) mega launch and of the short set's first std
    launch (16 rows, one contig each) against its plain twin."""
    import pyrodigal_tpu_torch

    rec = _records(GENOME)[0]
    finder = pyrodigal_tpu_torch.GeneFinder(backend="cuda")
    tinf, train_s = _timed_call(finder.train, rec.seq)
    out = {}
    paths = (("genome", [(rec.id, rec.seq)], MEGA_KERNELS, "mega"),
             ("short set", contigs, STD_KERNELS, "std"))
    num_seq = 1
    for label, named, kernels, route in paths:
        seqs = [s for _n, s in named]

        def call():
            if len(seqs) == 1:
                return [finder.find_genes(seqs[0])]
            return finder.find_genes_batch(seqs)

        if finder._single_runner is not None:
            finder._single_runner.single_drift.update(
                pairs=0, margin_ratio=0.0, relative=0.0)
        _zero_counts()
        got, wall = _timed_call(call)
        launches = _counts()
        runner = finder._single_runner
        routes = dict(runner.route_counts)
        drift = dict(runner.single_drift)
        if min(launches[k] for k in kernels) <= 0:
            raise AssertionError(f"single mode, {label}: a kernel was not "
                                 f"launched: {launches}")
        if routes["c"] or routes[route] <= 0:
            raise AssertionError(f"single mode, {label}: routes {routes}")
        if [g._num_seq for g in got] != list(range(num_seq,
                                                   num_seq + len(seqs))):
            raise AssertionError(f"single mode, {label}: numbering")
        if drift["pairs"] <= 0 or drift["margin_ratio"] > 1.0:
            raise AssertionError(f"single mode, {label}: device best scores "
                                 f"beyond a tenth of the winner margin: "
                                 f"{drift}")
        _warm, warm = _timed_call(call)
        ref, ref_1 = _refcore_single(tinf, seqs, num_seq, 1)
        _ref, ref_8 = _refcore_single(tinf, seqs, num_seq, 8)
        _bytes_equal(named, got, ref, scores=True)
        num_seq += 2 * len(seqs)
        for k in routes:
            runner.route_counts[k] = 0
        prep_s, launch_s, n_launch, finish_s, work = \
            _single_stages(runner, seqs, route)
        checks = _single_kernel_checks(label, *work[0])
        if set(checks) != set(kernels):
            raise AssertionError(f"single mode, {label}: kernels checked "
                                 f"{sorted(checks)}")
        out[label] = {"launches": launches, "routes": routes,
                      "bp": sum(len(s) for s in seqs),
                      "genes": sum(len(g) for g in got), "wall": wall,
                      "warm": warm, "refcore_1": ref_1, "refcore_8": ref_8,
                      "prep": prep_s, "launch": launch_s,
                      "n_launch": n_launch, "finish": finish_s,
                      "drift": drift, "checks": checks}
    print(f"phase 3c single mode: trained on the genome in {train_s:.3f} s "
          f"(uses_sd {bool(tinf.uses_sd)}); " + "; ".join(
              f"{label}: {r['bp']} bp, {r['genes']} genes, first call "
              f"{r['wall']:.3f} s = {r['bp'] / r['wall'] / 1e6:.4f} Mbp/s, "
              f"warm {r['warm']:.3f} s = {r['bp'] / r['warm'] / 1e6:.4f} "
              f"Mbp/s; refcore single mode {r['refcore_1']:.3f} s on one "
              f"thread = {r['bp'] / r['refcore_1'] / 1e6:.4f} Mbp/s, "
              f"{r['refcore_8']:.3f} s on 8; stages alone: host prep "
              f"{r['prep']:.3f} s on the pool, {r['n_launch']} {route} "
              f"launch(es) {r['launch']:.3f} s one after another, exact "
              f"finishing {r['finish']:.3f} s on the pool; routes "
              f"{r['routes']}; launches {r['launches']}; one-row device "
              f"best scores vs exact ({r['drift']['pairs']} contigs, first "
              f"call): worst |diff| / (0.1 x margin) "
              f"{r['drift']['margin_ratio']:.3g} (limit 1), max relative "
              f"{r['drift']['relative']:.3g}; kernels against their plain "
              f"twins on the first launch's inputs: " + ", ".join(
                  f"{k} {v[1][0]} max abs err {v[0]:.3g}"
                  for k, v in sorted(r["checks"].items()))
              for (label, _n, _k, route), r in zip(paths, out.values()))
          + "; GFF/FNA/FAA and start-score bytes equal to refcore single "
          "mode for every contig", flush=True)
    finder._single_runner.close()
    return out["genome"], out["short set"]


def phase_cli(contigs):
    """Phase 4: the port's CLI on the card, the default backend against
    `--backend refcore`: single mode on the genome and on the short-contig
    set (one `find_genes` call, and so one launch, a contig), meta mode on
    MIIJ01000039; every output file byte-equal."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=ROOT)
    report = []
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        short = os.path.join(tmp, "short.fna")
        with open(short, "w") as f:
            f.writelines(f">{name}\n{seq}\n" for name, seq in contigs)
        cases = (("single", os.path.join(DATA, GENOME)),
                 ("single", short),
                 ("meta", os.path.join(DATA, "MIIJ01000039.fna.gz")))
        for case, (mode, path) in enumerate(cases):
            files = {}
            for backend in ("cuda", "refcore"):
                d = os.path.join(tmp, f"{case}-{backend}")
                os.makedirs(d)
                outs = [os.path.join(d, f) for f in
                        ("out.gff", "prot.faa", "nuc.fna", "starts.tsv")]
                argv = [sys.executable, "-m", "pyrodigal_tpu_torch",
                        "-i", path, "-p", mode,
                        "-o", outs[0], "-a", outs[1], "-d", outs[2],
                        "-s", outs[3]]
                if backend == "refcore":
                    argv += ["--backend", "refcore"]
                t0 = time.perf_counter()
                r = subprocess.run(argv, env=env, cwd=tmp,
                                   capture_output=True, text=True)
                wall = time.perf_counter() - t0
                if r.returncode != 0:
                    raise AssertionError(
                        f"CLI {mode} {path} {backend}: exit {r.returncode}: "
                        f"{r.stderr[-2000:]}")
                files[backend] = []
                for out in outs:
                    with open(out, "rb") as f:
                        files[backend].append(f.read())
                report.append(f"{mode} {os.path.basename(path)} {backend} "
                              f"{wall:.2f} s")
            if files["cuda"] != files["refcore"]:
                raise AssertionError(f"CLI {mode} {path}: bytes differ")
            if not files["cuda"][1]:
                raise AssertionError(f"CLI {mode} {path}: no protein "
                                     f"written")
    print("phase 4 CLI (python -m pyrodigal_tpu_torch -o -a -d -s, "
          "default backend against --backend refcore): rc 0 and every "
          "output's bytes equal; wall, process start and kernel load "
          "included: " + ", ".join(report), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pyrodigal_tpu_torch import METAGENOMIC_BINS
    from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner

    phase_build()
    contigs = short_contigs()
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0")
    kernels = phase_kernels(runner)
    std_kernels, star_per_row = phase_kernels_std(runner, contigs)
    runner.close()
    kernels += std_kernels
    next(k for k in kernels if k["name"] == "star").update(star_per_row)
    kernels.sort(key=lambda k: KERNELS.index(k["name"]))
    torch.cuda.empty_cache()
    mega = phase_end_to_end_mega()
    std = phase_end_to_end_std(contigs)
    single_genome, single_short = phase_single(contigs)
    phase_cli(contigs)
    for k in kernels:
        name = k["name"]
        k["launches"] = (mega[name] + std[name]
                         + single_genome["launches"][name]
                         + single_short["launches"][name])
        k["launches_bench_set"] = mega[name]
        k["launches_short_set"] = std[name]
        for label, r in (("genome", single_genome),
                         ("short_set", single_short)):
            k[f"launches_single_{label}"] = r["launches"][name]
            if name in r["checks"]:
                err, shapes = r["checks"][name]
                k[f"max_abs_err_single_{label}"] = err
                k[f"shape_single_{label}"] = shapes[0]
    for mod in ("jax", "pyrodigal_tpu"):
        if mod in sys.modules:
            raise RuntimeError(f"{mod} was imported: the port stands alone")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
