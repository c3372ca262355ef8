#!/usr/bin/env python3
"""Time this tree's phase prefix-sum kernels (dc-chain, phase-cumsum)
against another checkout's, on one GPU.

    python3 scripts/ab_prefix_kernels.py [--other DIR] [--reps 10] [--sweep]
                                         [--profile]

Operands, built once by this tree: dc-chain on the genome's two code rows
with its 16 bin rows (16, 2,555,904), phase-cumsum on the looked-up dc
scores of the first std launch of chip_smoke's short-contig set
(128, 49,152).  Each time is the mean of `--reps` calls captured in one
CUDA graph (chip_smoke._graph_ms).

- `--other DIR`: DIR is a checkout of the port (for example an earlier
  commit unpacked with `git archive`) whose `_build.py` builds its
  kernels into DIR/build and whose C entry points take its own
  signatures (one block per (phase, row): held within that design's
  depth, 4 + 8 + ceil(S / 3 / 1024) + 1); order other, this, this, other.
- `--sweep`: this tree's bare C launches at other tiles per block, each
  held within the round-once bound.
- `--profile`: the device time of each CUDA kernel a call launches
  (torch.profiler).

Every output is held to its plain twin within its bound.
Prints one JSON line, then the card's name and power limit.
"""

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _other_build(path):
    spec = importlib.util.spec_from_file_location(
        "other_build", os.path.join(path, "pyrodigal_tpu_torch", "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _call(lib, name, *args):
    import torch

    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _profile(fn, reps=10):
    """Device microseconds a call of each CUDA kernel fn launches (self
    device time under torch.profiler over `reps` calls, after one)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--other")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--profile", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_prefix_kernels: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from pyrodigal_tpu_torch import METAGENOMIC_BINS, _build
    from pyrodigal_tpu_torch.ops import score_device as sd, star_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner

    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0")
    geo, bin_idx, _g, _NT, _SB = cs._prepared(runner,
                                              cs._records(cs.GENOME)[0].seq)
    table = runner.tables.gene_dc[bin_idx].contiguous()
    codes = [m6[0].contiguous() for m6 in sd._derive_m6(geo)]
    work, geoms = cs._first_std_launch(runner, cs.short_contigs())
    spacked, sbins, gidx, _nonsd = runner._std_inputs(work, geoms)
    sgeo = sd.to_device(spacked, runner.device)
    sbins = torch.from_numpy(sbins).to(runner.device)
    gidx = torch.from_numpy(gidx).to(runner.device)
    stable = runner.tables.gene_dc[sbins].contiguous()
    xs = [stable.gather(1, m6[gidx].long()).contiguous()
          for m6 in sd._derive_m6(sgeo)]
    runner.close()
    del geo, sgeo
    B, S = table.shape[0], codes[0].shape[0]
    BT, SS = xs[0].shape
    dev = table.device

    def check(got, ref, x_abs, depth=None):
        """(max abs err, worst ratio to the bound): this tree's round-once
        bound, or, for another checkout whose kernels add in f32, the
        sum-order bound of the given depth."""
        err = (got.double() - ref.double()).abs()
        if depth is None:
            bound = star_cuda.round_once_bound(x_abs, ref)
        else:
            cabs = star_cuda.phase_cumsum_plain(x_abs, rounded=False)
            bound = (depth * star_cuda.U * cabs
                     + star_cuda.U * ref.double().abs())
        if not bool((err <= bound).all()):
            raise AssertionError("beyond the bound")
        return float(err.max()), float((err / bound).max())

    dc_ref = [star_cuda.dc_phase_cumsum_plain(table, c) for c in codes]
    dc_abs = [table[:, c.long()].abs() for c in codes]
    pc_ref = [star_cuda.phase_cumsum_plain(x) for x in xs]

    # this tree's bare launches at a given shape
    def dc_this(tpb, c):
        chunks = -(-(-(-S // star_cuda.TILE)) // tpb)
        out = torch.empty((B, S), dtype=torch.float32, device=dev)
        scr = torch.empty((B, chunks, 3), dtype=torch.float64, device=dev)
        _call(_build.lib(), "dc_chain_launch",
              *_ptrs(table, c, out, scr), B, S, tpb)
        return out

    def pc_this(tpb, x):
        chunks = -(-(-(-SS // star_cuda.TILE)) // tpb)
        out = torch.empty_like(x)
        scr = torch.empty((BT, chunks, 3), dtype=torch.float64, device=dev)
        _call(_build.lib(), "phase_cumsum_launch",
              *_ptrs(x, out, scr), BT, SS, tpb)
        return out

    dc_tpb, _ = star_cuda._chunking(S)
    pc_tpb, _ = star_cuda._chunking(SS)

    result = {"dc_chain": {"shape": [B, S]},
              "phase_cumsum": {"shape": [BT, SS]}}
    r = result["dc_chain"]
    r["max_abs_err"], r["bound_ratio"] = max(
        check(star_cuda.dc_phase_cumsum(table, c), ref, xa)
        for c, ref, xa in zip(codes, dc_ref, dc_abs))
    r = result["phase_cumsum"]
    r["max_abs_err"], r["bound_ratio"] = max(
        check(star_cuda.phase_cumsum(x), ref, x.abs())
        for x, ref in zip(xs, pc_ref))

    if opts.other:
        other = _other_build(os.path.abspath(opts.other))
        olib = other.lib()

        def dc_other(c):
            out = torch.empty((B, S), dtype=torch.float32, device=dev)
            _call(olib, "dc_chain_launch", *_ptrs(table, c, out), B, S)
            return out

        def pc_other(x):
            out = torch.empty_like(x)
            _call(olib, "phase_cumsum_launch", *_ptrs(x, out), BT, SS)
            return out

        depth_dc = 4 + 8 + math.ceil(S / 3 / 1024) + 1
        depth_pc = 4 + 8 + math.ceil(SS / 3 / 1024) + 1
        for c, ref, xa in zip(codes, dc_ref, dc_abs):
            check(dc_other(c), ref, xa, depth_dc)
        for x, ref in zip(xs, pc_ref):
            check(pc_other(x), ref, x.abs(), depth_pc)
        fns = {"dc_chain": {"other": lambda: dc_other(codes[0]),
                            "this": lambda: dc_this(dc_tpb, codes[0])},
               "phase_cumsum": {"other": lambda: pc_other(xs[0]),
                                "this": lambda: pc_this(pc_tpb, xs[0])}}
        for kernel, f in fns.items():
            ms = {"other": [], "this": []}
            for k in ("other", "this", "this", "other"):
                ms[k].append(cs._graph_ms(f[k], opts.reps))
            result[kernel].update(ms_other=ms["other"], ms_this=ms["this"])

    if opts.sweep:
        sweep = []
        for kernel, fn, arg, ref, xa in (
                ("dc_chain", dc_this, codes[0], dc_ref[0], dc_abs[0]),
                ("phase_cumsum", pc_this, xs[0], pc_ref[0], xs[0].abs())):
            for tpb in (1, 2, 4, 7, 13, 16):
                check(fn(tpb, arg), ref, xa)
                sweep.append({"kernel": kernel, "tiles_per_block": tpb,
                              "ms": cs._graph_ms(lambda: fn(tpb, arg),
                                                 opts.reps)})
        result["sweep"] = sweep
        result["chosen"] = {"dc_chain": dc_tpb, "phase_cumsum": pc_tpb}
    if opts.profile:
        result["profile"] = {
            "dc_chain": _profile(lambda: dc_this(dc_tpb, codes[0])),
            "phase_cumsum": _profile(lambda: pc_this(pc_tpb, xs[0]))}
    print(json.dumps(result))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
