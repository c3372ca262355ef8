#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pyrodigal_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line:

1. build: compile the five CUDA kernels from `pyrodigal_tpu_torch/csrc`
   (one nvcc per source, in parallel; seconds, and registers / shared
   memory / spills per kernel);
2. kernels: each kernel against its plain PyTorch version on the card, at
   its path's shapes, timed with CUDA events.  Mega route: dc-chain (both
   code rows) and star on the 2.46 Mbp genome, the mega DP on the 100 kb
   contig.  Std route, on the first std launch of the short-contig set
   (128 rows, 49,152 bp, 3,072 nodes): phase-cumsum (both code rows), star
   with one geometry row per bin row, and the std DP;
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
      scores on 20 contigs.

Then one JSON line of kernel records, the card's name and power limit,
and, last, the result line.  Exits non-zero, with no result line, when
no CUDA device is present or any phase fails.  Imports no jax.
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
MEGA_KERNELS = ("dc_chain", "star", "dp_mega")
STD_KERNELS = ("phase_cumsum", "star", "dp_std")


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


def _records(path):
    from pyrodigal_tpu.fasta import parse

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


def _bound_check(name, got, ref, x_abs, depth):
    """A prefix sum against its plain (f64, rounded once) twin, within the
    kernel's summation depth times u times the prefix sum of |x|, plus
    the plain version's final rounding; returns (max abs err, worst ratio
    of error to bound)."""
    import torch

    B, S = x_abs.shape
    pad = (-S) % 3
    cabs = torch.nn.functional.pad(x_abs.double(), (0, pad)) \
        .reshape(B, -1, 3).cumsum(1).reshape(B, -1)[:, :S]
    err = (got.double() - ref.double()).abs()
    bound = depth * U * cabs + U * ref.double().abs()
    if not bool((err <= bound).all()):
        raise AssertionError(
            f"{name} deviates beyond its sum-order bound: max "
            f"{float(err.max())}, worst ratio {float((err / bound).max())}")
    return float(err.max()), float((err / bound).max())


def _prepared(runner, seq_str, tt_rows=16):
    """Host prep of one contig as the runner does it: the packed geometry
    (on the device) and the bin rows of its translation table 11."""
    import numpy as np
    import torch

    from pyrodigal_tpu.sequence import Sequence
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


def phase_build():
    from pyrodigal_tpu_torch import _build

    # build from the sources in this checkout, never a cached library
    if os.path.exists(_build.LIB_PATH):
        os.remove(_build.LIB_PATH)
    _build.lib()
    info = _build.BUILD_INFO
    names = tuple(f"{k}_kernel" for k in KERNELS)
    kernels = {}
    current = None
    for line in info["ptxas"].splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            current = next((k for k in names if k in m.group(1)), None)
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
    if set(k for k, v in kernels.items() if "regs" in v) != set(names):
        raise RuntimeError(f"ptxas report incomplete: {kernels}\n"
                           f"{info['ptxas'][-3000:]}")
    print(f"phase 1 build: nvcc {info['seconds']:.1f} s; "
          + "; ".join(f"{k}: {v['regs']} regs, {v['smem']} B smem, "
                      f"{v.get('spill', 0)} B spill"
                      for k, v in sorted(kernels.items())), flush=True)


def phase_kernels(runner):
    """Each kernel against its plain version on the card."""
    import numpy as np
    import torch

    from pyrodigal_tpu_torch.ops import dp_cuda, score_device as sd
    from pyrodigal_tpu_torch.ops import star_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import RELK

    out = []
    genome = _records(GENOME)[0].seq
    geo, bin_idx, g, NT, SB = _prepared(runner, genome)
    B = bin_idx.shape[0]
    assert (B, NT, SB) == (16, 163840, 2555904), (B, NT, SB)

    # -- dc-chain at (16, 2.56 M) on the genome's codes, both strands -----
    table = runner.tables.gene_dc[bin_idx].contiguous()
    # the kernel's summation depth: items per thread + block scan + one
    # carry add per chunk
    depth = 4 + 8 + math.ceil(SB / 3 / 1024) + 1
    dc_err, dc_ratio = 0.0, 0.0
    for strand, m6 in zip(("m6f", "m6r"), sd._derive_m6(geo)):
        codes = m6[0]
        got = star_cuda.dc_phase_cumsum(table, codes)
        ref = star_cuda.dc_phase_cumsum_plain(table, codes)
        err, ratio = _bound_check(f"dc_chain ({strand})", got, ref,
                                  table[:, codes.long()].abs(), depth)
        dc_err, dc_ratio = max(dc_err, err), max(dc_ratio, ratio)
        del got, ref
    ms = _time_ms(lambda: star_cuda.dc_phase_cumsum(table, codes), 10)
    plain_ms = _time_ms(lambda: star_cuda.dc_phase_cumsum_plain(table, codes),
                        3)
    out.append({"name": "dc_chain", "route": "cuda",
                "source": "pyrodigal_tpu_torch/csrc/dc_chain.cu",
                "replaces": "pyrodigal_tpu/ops/star_pallas.py:293",
                "max_abs_err": dc_err, "ms": ms,
                "plain_ms": plain_ms, "shape": [B, SB],
                "bound_ratio": dc_ratio})

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
    for name, a, b in zip(("star_ptr", "opv1", "val3", "t_sv", "t_ndx"),
                          got, ref):
        if a.dtype == torch.int32:
            if not torch.equal(a, b):
                raise AssertionError(f"star {name}: integers differ")
        elif not torch.allclose(a, b, rtol=1e-6, atol=1e-5):
            raise AssertionError(f"star {name}: beyond rtol 1e-6")
    star_err = max(float((a - b).abs().max()) for a, b in zip(got, ref)
                   if a.dtype == torch.float32)
    ms = _time_ms(lambda: star_cuda.star_tables(*args), 10)
    plain_ms = _time_ms(lambda: star_cuda.star_tables_plain(*args), 3)
    out.append({"name": "star", "route": "cuda",
                "source": "pyrodigal_tpu_torch/csrc/star.cu",
                "replaces": "pyrodigal_tpu/ops/star_pallas.py:40",
                "max_abs_err": star_err, "ms": ms, "plain_ms": plain_ms,
                "shape": [B, NT]})

    # the DP kernel alone at the genome's shape (no plain run there)
    def dp_args(ndx, stop_val, win_lo, geometry, cs, rsc, usc, stw, tables):
        kind4, tile_nn, ovlo, has_ov, _ok = geometry
        return (ndx, stop_val, kind4, win_lo.contiguous(), ovlo, has_ov,
                tile_nn, cs, rsc.contiguous(), usc.contiguous(), *tables,
                stw, dp_cuda.FXS)

    genome_dp = dp_args(ndx[0], stop_val[0], win_lo[0], geometry, cs, rsc,
                        usc, stw, got[1:])
    dp_genome_ms = _time_ms(lambda: dp_cuda.mega_dp(*genome_dp), 10)
    del genome_dp, got, ref, args, cs, cscore, ssc, rsc, usc

    # -- mega DP on the 100 kb contig (NT = 16,384) ------------------------
    c100 = _records(CONTIGS[2])[0].seq
    geo, bin_idx, g, NT, SB = _prepared(runner, c100)
    assert NT == 16384, NT
    (ndx, stop_val, typ, strand, win_lo, valid, edge,
     cscore, ssc, rsc, usc, stw) = _scores(runner, geo, bin_idx)
    ndx, stop_val, typ, strand, win_lo, valid, edge = (
        x[0] for x in (ndx, stop_val, typ, strand, win_lo, valid, edge))
    geometry = dp_cuda.mega_geometry(ndx, stop_val, typ, strand, valid, True)
    cs = (cscore + ssc).contiguous()
    tables = star_cuda.star_tables(
        ndx[None].contiguous(), stop_val[None].contiguous(),
        geometry[0][None], edge[None].contiguous(), cs, rsc.contiguous(),
        usc.contiguous(), stw.contiguous(), RELK, runner.max_overlap)[1:]
    a = dp_args(ndx, stop_val, win_lo, geometry, cs, rsc, usc, stw, tables)
    got = dp_cuda.mega_dp(*a)
    t0 = time.perf_counter()
    ref = dp_cuda.mega_dp_plain(*a)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    dp_err = 0
    for name, x, y in zip(("score", "traceb", "ovmark", "tbndx"), got, ref):
        dp_err = max(dp_err, int((x - y).abs().max()))
        if not torch.equal(x, y):
            n_bad = int((x != y).sum())
            raise AssertionError(f"mega DP {name}: {n_bad} entries differ")
    ms = _time_ms(lambda: dp_cuda.mega_dp(*a), 10)
    out.append({"name": "dp_mega", "route": "cuda",
                "source": "pyrodigal_tpu_torch/csrc/dp_mega.cu",
                "replaces": "pyrodigal_tpu/ops/dp_pallas.py:470",
                "max_abs_err": float(dp_err), "ms": ms, "plain_ms": plain_ms,
                "shape": [int(bin_idx.shape[0]), NT],
                "ms_genome": dp_genome_ms, "shape_genome": [16, 163840]})
    print("phase 2 kernels, mega route: " + "; ".join(
        f"{k['name']} {k['shape']}: kernel {k['ms']:.3f} ms, plain "
        f"{k['plain_ms']:.3f} ms, max abs err {k['max_abs_err']:.3g}"
        for k in out) + f"; dp_mega at [16, 163840]: {dp_genome_ms:.1f} ms",
        flush=True)
    return out


def _first_std_launch(runner, contigs):
    """The first std launch of `contigs` as find_genes_batch packs it:
    (work, geoms)."""
    from pyrodigal_tpu.sequence import Sequence

    items = []
    for ci, (_name, s) in enumerate(contigs):
        cand, geoms, _nbt, route = runner._prepare_contig(Sequence(s))
        if route == "std" and cand:
            items.append((ci, cand, geoms))
        launches = runner._pack_std(items)
        if len(launches) > 1:
            return launches[0]["work"], launches[0]["geoms"]
    raise AssertionError("the short-contig set fits one std launch")


def phase_kernels_std(runner, contigs):
    """The std route's kernels against their plain versions on the card,
    on the first std launch of the short-contig set."""
    import torch

    from pyrodigal_tpu_torch.ops import dp_cuda, score_device as sd
    from pyrodigal_tpu_torch.ops import star_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import RELK

    work, geoms = _first_std_launch(runner, contigs)
    geo, bin_idx, gidx, nonsd = runner._std_inputs(work, geoms)
    BT, S, n = (bin_idx.shape[0], geo["digits"].shape[1],
                geo["n32"].shape[2])
    out = []

    # -- phase cumsum on each row's looked-up dc scores, both strands ----
    table = runner.tables.gene_dc[bin_idx].contiguous()
    depth = 4 + 8 + math.ceil(S / 3 / 1024) + 1
    pc_err, pc_ratio = 0.0, 0.0
    for strand, m6 in zip(("m6f", "m6r"), sd._derive_m6(geo)):
        x = table.gather(1, m6[gidx].long()).contiguous()
        got = star_cuda.phase_cumsum(x)
        ref = star_cuda.phase_cumsum_plain(x)
        err, ratio = _bound_check(f"phase_cumsum ({strand})", got, ref,
                                  x.abs(), depth)
        pc_err, pc_ratio = max(pc_err, err), max(pc_ratio, ratio)
    ms = _time_ms(lambda: star_cuda.phase_cumsum(x), 10)
    plain_ms = _time_ms(lambda: star_cuda.phase_cumsum_plain(x), 3)
    out.append({"name": "phase_cumsum", "route": "cuda",
                "source": "pyrodigal_tpu_torch/csrc/phase_cumsum.cu",
                "replaces": "pyrodigal_tpu/ops/star_pallas.py:229",
                "max_abs_err": pc_err, "ms": ms, "plain_ms": plain_ms,
                "shape": [BT, S], "bound_ratio": pc_ratio})

    # -- star with one geometry row per bin row --------------------------
    (ndx, stop_val, typ, strand, win_lo, valid, edge,
     cscore, ssc, rsc, usc, stw) = sd._score_items(
        runner.tables.as_tuple(), geo, bin_idx, gidx, is_meta=True,
        closed=False, has_nonsd=nonsd)
    kind4 = dp_cuda.kind4_of(typ, strand, valid)
    cs = (cscore + ssc).contiguous()
    rsc, usc, stw = (a.contiguous() for a in (rsc, usc, stw))
    args = (ndx.contiguous(), stop_val.contiguous(), kind4,
            edge.contiguous(), cs, rsc, usc, stw, RELK, runner.max_overlap)
    got = star_cuda.star_tables(*args)
    ref = star_cuda.star_tables_plain(*args)
    for name, a, b in zip(("star_ptr", "opv1", "val3", "t_sv", "t_ndx"),
                          got, ref):
        if a.dtype == torch.int32:
            if not torch.equal(a, b):
                raise AssertionError(f"per-row star {name}: integers differ")
        elif not torch.allclose(a, b, rtol=1e-6, atol=1e-5):
            raise AssertionError(f"per-row star {name}: beyond rtol 1e-6")
    if int((got[0] != -1).sum()) == 0:
        raise AssertionError("per-row star: no pointer set")
    star_err = max(float((a - b).abs().max()) for a, b in zip(got, ref)
                   if a.dtype == torch.float32)
    star_ms = _time_ms(lambda: star_cuda.star_tables(*args), 10)
    star_plain_ms = _time_ms(lambda: star_cuda.star_tables_plain(*args), 3)
    star = {"max_abs_err_per_row": star_err, "ms_per_row": star_ms,
            "plain_ms_per_row": star_plain_ms, "shape_per_row": [BT, n]}

    # -- the std DP: all four outputs exactly equal -----------------------
    dargs = (args[0], args[1], kind4, win_lo.contiguous(), cs, rsc, usc,
             *got[1:], stw)
    got = dp_cuda.std_dp(*dargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = dp_cuda.std_dp_plain(*dargs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    for name, a, b in zip(("score", "traceb", "ovmark", "tbndx"), got, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"std DP {name}: {int((a != b).sum())} "
                                 f"entries differ")
    if int((got[1] != -1).sum()) < BT * 100:
        raise AssertionError("std DP: too few committed nodes")
    ms = _time_ms(lambda: dp_cuda.std_dp(*dargs), 10)
    out.append({"name": "dp_std", "route": "cuda",
                "source": "pyrodigal_tpu_torch/csrc/dp_std.cu",
                "replaces": "pyrodigal_tpu/ops/dp_pallas.py:76",
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "shape": [BT, n],
                "nodes_max": int((kind4 != 4).sum(1).max())})
    print(f"phase 2 kernels, std route (first std launch: {len(work)} work "
          f"items, {len(geoms)} geometries, BT {BT}, S {S}, n {n}): "
          + "; ".join(f"{k['name']} {k['shape']}: kernel {k['ms']:.3f} ms, "
                      f"plain {k['plain_ms']:.3f} ms, max abs err "
                      f"{k['max_abs_err']:.3g}" for k in out)
          + f"; per-row star {star['shape_per_row']}: kernel "
          f"{star_ms:.3f} ms, plain {star_plain_ms:.3f} ms, max abs err "
          f"{star_err:.3g}; kernels the mean of 10 calls, plain "
          f"phase-cumsum and star of 3, the plain DP one host-timed call",
          flush=True)
    return out, star


def _outputs(genes, name):
    streams = []
    for write in (genes.write_gff, genes.write_genes,
                  genes.write_translations):
        f = io.StringIO()
        write(f, name)
        streams.append(f.getvalue().encode())
    return streams


def _refcore(seqs):
    """The exact C engine's genes for every contig, numbered as one call
    of a fresh GeneFinder numbers them (num_seq 1, 2, ...), on 8
    threads."""
    import pyrodigal_tpu

    def one(i):
        finder = pyrodigal_tpu.GeneFinder(meta=True, backend="refcore")
        finder._num_seq = i + 1
        return finder.find_genes(seqs[i])

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        return list(ex.map(one, range(len(seqs))))


def _drive(named, kernels):
    """One path end to end: a fresh GeneFinder(meta=True, backend="cuda")
    on [(name, sequence)], the launch counters set to 0 just before its
    first call and read just after; then a warm call, the host prep alone,
    and the bytes of every contig against the exact C engine.  Fails when
    a kernel of `kernels` was not launched or a contig took "c"."""
    import torch

    import pyrodigal_tpu_torch
    from pyrodigal_tpu.sequence import Sequence
    from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda

    seqs = [s for _n, s in named]
    finder = pyrodigal_tpu_torch.GeneFinder(meta=True, backend="cuda")
    runner = finder._get_meta_runner()
    for counts in (star_cuda.LAUNCHES, dp_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = finder.find_genes_batch(seqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**star_cuda.LAUNCHES, **dp_cuda.LAUNCHES}
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
    for (name, _s), a, b in zip(named, got, ref):
        for kind, x, y in zip(("GFF", "FNA", "FAA"), _outputs(a, name),
                              _outputs(b, name)):
            if x != y:
                raise AssertionError(f"{name}: {kind} bytes differ from "
                                     f"refcore")
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
    from pyrodigal_tpu.sequence import Sequence

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
    from pyrodigal_tpu.sequence import Sequence

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pyrodigal_tpu import METAGENOMIC_BINS
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
    for k in kernels:
        k["launches"] = mega[k["name"]] + std[k["name"]]
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported: the port must run without it")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    # the port drives one card
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
