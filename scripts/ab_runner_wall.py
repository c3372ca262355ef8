#!/usr/bin/env python3
"""Warm wall of the one-card meta runner, this tree against another
checkout of the port, on one GPU.

    python3 scripts/ab_runner_wall.py --other DIR [--passes 3]

Each tree runs in a process of its own, in the order other, this, this,
other: it builds its kernels into its own `build/`, makes one
`CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0")`, and times
`find_genes_batch` on chip_smoke's bench set (mega route) and on its
518-contig short set (std route): one untimed call, then `--passes`
calls, each synchronised on both ends (host clock).  DIR is, for
example, an earlier commit unpacked with `git archive`.

Prints one JSON line per process, then one with each tree's median per
set, then the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree, passes):
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from pyrodigal_tpu_torch import METAGENOMIC_BINS, _build
    from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner

    _build.lib()
    sets = {"bench_set": [r.seq for name in cs.CONTIGS
                          for r in cs._records(name)],
            "short_set": [s for _n, s in cs.short_contigs()]}
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0")
    out = {"tree": tree}
    for label, seqs in sets.items():
        runner.find_genes_batch(seqs)
        walls = []
        for _ in range(passes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.find_genes_batch(seqs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[label] = walls
    runner.close()
    print(json.dumps(out))
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.child:
        return child(opts.child, opts.passes)
    if opts.other is None:
        ap.error("--other DIR is required")
    trees = {"other": os.path.abspath(opts.other), "this": ROOT}
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             trees[name], "--passes", str(opts.passes)],
            capture_output=True, text=True, cwd=trees[name])
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[name].append(json.loads(line))
    print(json.dumps({
        name: {label: statistics.median(
            w for r in rs for w in r[label])
            for label in ("bench_set", "short_set")}
        for name, rs in runs.items()}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
