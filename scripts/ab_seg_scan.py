#!/usr/bin/env python3
"""Time this tree's seg-scan kernel against another checkout's, on one GPU.

    python3 scripts/ab_seg_scan.py [--other DIR] [--reps 10] [--sweep]

Operands, built once by this tree: the (cscore, lfac_raw, code) of the
genome's mega scoring launch (16 bin rows x 163,840 nodes, one shared
geometry row) and of the first std launch of chip_smoke's short-contig
set (128 x 3,072, one geometry row per bin row), captured from
`star_cuda.seg_scan_passes`.  Each time is the mean of `--reps` calls
captured in one CUDA graph (chip_smoke._graph_ms), outputs and scratch
allocated inside, as the runner calls it.

- `--other DIR` (repeatable): DIR is a checkout of the port (an earlier
  commit unpacked with `git archive`) whose `_build.py` builds its kernels
  into DIR/build.  If its `seg_scan_launch` takes one walk (the
  signature before this design), scoring passes 2 and 3 are its four
  calls, seeded and selected as its `_score_items` did; else one call.
  Order other, this, this, other; both outputs compared bit for bit.
- `--sweep`: this tree's kernel on numpy-seeded operands at more rows and
  lengths (both kernels), to show how its time scales.

Every output is held to the plain twin bit for bit.  Beside the kernel,
`copy_ms` times one `torch.maximum(cscore, lfac_raw)`: a read of both
value arrays and a write of one, what this card's plain streaming
reaches on a third fewer bytes than the kernel moves.  Prints one JSON
line, then the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SWEEP = [(1, 163840), (4, 163840), (16, 163840), (64, 163840),
         (16, 16384), (16, 655360), (16, 3072), (128, 3072), (512, 3072),
         (128, 4096)]


def _other_build(path):
    spec = importlib.util.spec_from_file_location(
        "other_build", os.path.join(path, "pyrodigal_tpu_torch", "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _four_calls(lib, cscore, lfac_raw, code):
    """Scoring passes 2 and 3 through a one-walk `seg_scan_launch`
    (values, elem, reset, phase, init, own, fin, scratch, BT, n,
    geo_stride, tiles, reset_val, reverse, exclusive, stream; tiles of
    2,304): the four walks, seeded and selected as that checkout's
    `_score_items` did."""
    import torch

    BT, n = cscore.shape
    R = code.shape[0]
    dev = cscore.device
    phase = (code & 3).to(torch.int32)
    start, stop, fwd = (((code >> s) & 1).bool() for s in (2, 3, 4))
    tiles = -(-n // 2304)
    stream = torch.cuda.current_stream().cuda_stream

    def walk(values, forward, init, exclusive):
        strand = fwd if forward else ~fwd
        elem = (start & strand).contiguous()
        reset = (stop & strand).contiguous()
        own = torch.empty_like(values)
        fin = torch.empty((BT, 3), dtype=torch.float32, device=dev)
        scratch = torch.empty((BT, tiles, 3), dtype=torch.int64, device=dev)
        err = lib.seg_scan_launch(
            values.data_ptr(), elem.data_ptr(), reset.data_ptr(),
            phase.data_ptr(), init.data_ptr(), own.data_ptr(),
            fin.data_ptr(), scratch.data_ptr(), BT, n, 0 if R == 1 else n,
            tiles, -1e4, int(not forward), int(exclusive), stream)
        if err:
            raise RuntimeError(f"seg_scan_launch: CUDA error {err}")
        return own, fin

    neg1e4 = torch.full((BT, 3), -1e4, dtype=torch.float32, device=dev)
    run2_f, _ = walk(cscore, True, neg1e4, False)
    run2_r, fin2r = walk(cscore, False, neg1e4, False)
    run3_f, fin3f = walk(lfac_raw, True, fin2r, True)
    run3_r, _ = walk(lfac_raw, False, fin3f, True)
    return torch.where(fwd, run2_f, run2_r), torch.where(fwd, run3_f, run3_r)


def _seg_constants(path):
    """(SEG_ROW_LIMIT, SEG_TILE) of another checkout's `star_cuda`, read
    from its source (this tree's where it has none)."""
    import re

    from pyrodigal_tpu_torch.ops import star_cuda

    src = os.path.join(path, "pyrodigal_tpu_torch", "ops", "star_cuda.py")
    text = open(src).read() if os.path.exists(src) else ""
    found = [re.search(rf"^{k} = (\d+)", text, re.M)
             for k in ("SEG_ROW_LIMIT", "SEG_TILE")]
    return tuple(int(m.group(1)) if m else default for m, default in
                 zip(found, (star_cuda.SEG_ROW_LIMIT, star_cuda.SEG_TILE)))


def _caller(path):
    """(label, fn(cscore, lfac_raw, code) -> (run2, run3)) of another
    checkout's kernel library."""
    import ctypes

    import torch

    ob = _other_build(path)
    lib = ob.lib()
    argtypes = ob._SIGNATURES["seg_scan_launch"]
    if len(argtypes) == 16:
        return "four calls", lambda *a: _four_calls(lib, *a)
    assert len(argtypes) == 13, argtypes

    limit, tile = _seg_constants(path)

    def one(cscore, lfac_raw, code):
        BT, n = cscore.shape
        R = code.shape[0]
        tiles = 0 if n <= limit else -(-n // tile)
        run2 = torch.empty_like(cscore)
        run3 = torch.empty_like(cscore)
        scratch = (torch.zeros(1 + BT * 4 * tiles * 3 + BT * 6,
                               dtype=torch.int64, device=cscore.device)
                   if tiles else None)
        err = lib.seg_scan_launch(
            cscore.data_ptr(), lfac_raw.data_ptr(), code.data_ptr(),
            run2.data_ptr(), run3.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), BT, n,
            0 if R == 1 else n, tiles, ctypes.c_float(-1e4),
            ctypes.c_float(-1e4), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"seg_scan_launch: CUDA error {err}")
        return run2, run3

    return "one call", one


def _synthetic(BT, n, device, seed=0):
    """numpy-seeded operands: values N(0, 10), starts 40%, stops 5%,
    strands even, one geometry row per bin row when BT <= 512 and n is a
    std length, else one shared row."""
    import numpy as np
    import torch

    from pyrodigal_tpu_torch.ops import star_cuda

    rng = np.random.default_rng(seed)
    R = BT if n <= star_cuda.SEG_ROW_LIMIT else 1
    vals = [torch.from_numpy((rng.normal(size=(BT, n)) * 10)
                             .astype(np.float32)).to(device)
            for _ in range(2)]
    geo = [torch.from_numpy(a).to(device) for a in (
        rng.integers(0, 3, (R, n)), rng.random((R, n)) < 0.4,
        rng.random((R, n)) < 0.05, rng.random((R, n)) < 0.5)]
    return (*vals, star_cuda.seg_code(*geo))


def _same(label, got, want):
    import torch

    for name, a, b in zip(("run2", "run3"), got, want):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{label} {name}: bits differ")


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_seg_scan: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from pyrodigal_tpu_torch import METAGENOMIC_BINS
    from pyrodigal_tpu_torch.ops import star_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner

    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0")
    geo, bin_idx, _g, _NT, _SB = cs._prepared(runner,
                                              cs._records(cs.GENOME)[0].seq)
    shapes = {"genome": cs._seg_calls(cs._captured(
        lambda: cs._scores(runner, geo, bin_idx)))[0][0]}
    work, geoms = cs._first_std_launch(runner, cs.short_contigs())
    shapes["std"] = cs._seg_calls(cs._captured(
        lambda: cs._std_dp_args(runner, work, geoms)))[0][0]
    runner.close()
    del geo

    others = [(path, *_caller(path)) for path in opts.other]
    out = {"reps": opts.reps, "shapes": {}}
    for label, a in shapes.items():
        want = star_cuda.seg_scan_passes_plain(*a)
        mine = star_cuda.seg_scan_passes(*a)
        _same(f"this ({label})", mine, want)
        BT, n = a[0].shape
        bound_ms = (cs._nbytes(*a) + cs._nbytes(*mine)) / cs.HBM_BPS * 1e3
        rec = {"shape": [BT, n], "geometry_rows": a[2].shape[0],
               "bound_ms": bound_ms,
               "copy_ms": cs._graph_ms(lambda: torch.maximum(a[0], a[1]),
                                       opts.reps)}
        for path, kind, fn in others:
            _same(f"{path} ({label})", fn(*a), want)
        this = lambda: cs._graph_ms(  # noqa: E731
            lambda: star_cuda.seg_scan_passes(*a), opts.reps)
        times = {"this": []}
        for path, kind, fn in others:
            times[path] = [cs._graph_ms(lambda: fn(*a), opts.reps)]
        times["this"] += [this(), this()]
        for path, kind, fn in others:
            times[path].append(cs._graph_ms(lambda: fn(*a), opts.reps))
        rec["ms"] = times
        rec["kinds"] = {path: kind for path, kind, _fn in others}
        out["shapes"][label] = rec
        print(f"{label} {rec['shape']}: " + "; ".join(
            f"{k} {', '.join(f'{x:.4f}' for x in v)} ms"
            for k, v in times.items()) + f"; bound {bound_ms:.4f} ms, "
            f"torch.maximum of the values {rec['copy_ms']:.4f} ms",
            flush=True)

    if opts.sweep:
        out["sweep"] = []
        for BT, n in SWEEP:
            a = _synthetic(BT, n, "cuda:0")
            got = star_cuda.seg_scan_passes(*a)
            _same(f"sweep ({BT}, {n})", got,
                  star_cuda.seg_scan_passes_plain(*a))
            ms = cs._graph_ms(lambda: star_cuda.seg_scan_passes(*a),
                              opts.reps)
            bound_ms = (cs._nbytes(*a) + cs._nbytes(*got)) / cs.HBM_BPS * 1e3
            out["sweep"].append({"shape": [BT, n], "ms": ms,
                                 "bound_ms": bound_ms})
            print(f"sweep ({BT}, {n}): {ms:.4f} ms, bound {bound_ms:.4f} "
                  f"ms ({bound_ms / ms:.1%})", flush=True)
            del a, got

    print(json.dumps(out))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
