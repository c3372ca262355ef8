#!/usr/bin/env python3
"""Time this tree's DP kernels against another checkout's, on one GPU.

    python3 scripts/ab_dp_kernels.py --other DIR [--reps 10]

DIR is a checkout of the port (for example an earlier commit unpacked
with `git archive`); its `pyrodigal_tpu_torch/_build.py` builds its own
kernels into DIR/build.  Both libraries take the same C launch
signatures, so each launch gets the same operands, built once by this
tree: the mega DP at the genome's shape (16 rows, 163,840 nodes) and the
std DP at the first std launch of chip_smoke's short-contig set.  Order
other, this, this, other; each a mean of `--reps` launches timed with
CUDA events after one warm-up.  The outputs of the two libraries must be
equal.  Prints one JSON line, then the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _other_lib(path):
    spec = importlib.util.spec_from_file_location(
        "other_build", os.path.join(path, "pyrodigal_tpu_torch", "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib()


def _launch(lib, name, args, outs, dims):
    import torch

    fn = getattr(lib, name)
    err = fn(*(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
             *dims, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def _time(lib, name, args, outs, dims, reps):
    import torch

    _launch(lib, name, args, outs, dims)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        _launch(lib, name, args, outs, dims)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_dp_kernels: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from pyrodigal_tpu_torch import METAGENOMIC_BINS, _build
    from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner

    libs = {"other": _other_lib(os.path.abspath(opts.other)),
            "this": _build.lib()}
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0")
    mega = cs._mega_dp_args(runner, cs._records(cs.GENOME)[0].seq)
    work, geoms = cs._first_std_launch(runner, cs.short_contigs())
    std = cs._std_dp_args(runner, work, geoms)[0]
    runner.close()
    B, NT = mega[7].shape
    BT, n = std[4].shape
    cases = {
        "dp_mega": ("dp_mega_launch", mega[:-1], (B, NT, mega[-1]),
                    int(mega[6].sum())),
        "dp_std": ("dp_std_launch", std, (BT, n),
                   int((std[2] != 4).sum(1).max())),
    }
    result = {}
    for kernel, (fn, args, dims, steps) in cases.items():
        outs = {k: [torch.empty((dims[0], dims[1]), dtype=torch.int32,
                                device="cuda:0") for _ in range(4)]
                for k in libs}
        ms = {k: [] for k in libs}
        for k in ("other", "this", "this", "other"):
            ms[k].append(_time(libs[k], fn, args, outs[k], dims, opts.reps))
        for a, b in zip(outs["other"], outs["this"]):
            if not torch.equal(a, b):
                raise AssertionError(f"{kernel}: the two libraries differ")
        result[kernel] = {
            "shape": list(dims[:2]), "steps": steps,
            "ms_other": ms["other"], "ms_this": ms["this"],
            "us_per_step_other": [t * 1e3 / steps for t in ms["other"]],
            "us_per_step_this": [t * 1e3 / steps for t in ms["this"]]}
    print(json.dumps(result))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
