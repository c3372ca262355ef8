#!/usr/bin/env python3
"""Every host synchronisation on the card during a few meta-mode calls,
with the program span open where it happened (CUDA host only).

    python3 scripts/find_launch_syncs.py [--seed N] [--out PATH]

Runs `GeneFinder(meta=True).find_genes_batch` on the first three calls
of the benchmark's `long_contigs` traffic (a call a genome; the mega
route and the exact route) and on one call of short contigs cut from the
GCF genome (the std route), after a warm call of each, under
`torch.cuda.set_sync_debug_mode("warn")` with the program's tracing on.
Each sync is listed by the innermost frame of the port and the thread's
innermost open span.  Inside a launch, every sync should lie inside a
`launch.wait` span, so that no device time hides in the launch's
enqueue; the script exits 1 when one does not.  With `--out`, the
table is also written there as JSON.
"""

import argparse
import collections
import json
import os
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PKG = os.path.join(ROOT, "pyrodigal_tpu_torch")


def short_contigs(seq, n=200, lo=2000, hi=20000, seed=7):
    import numpy as np

    rng = np.random.default_rng(seed)
    out, at = [], 0
    for k in range(n):
        L = int(rng.integers(lo, hi))
        if at + L > len(seq):
            at = 0
        out.append((f"short_{k}", seq[at:at + L]))
        at += L
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=3141592653)
    p.add_argument("--out")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("find_launch_syncs: needs a CUDA device", file=sys.stderr)
        return 1
    from genebench import generate
    from pyrodigal_tpu_torch import GeneFinder, tracing

    mix = generate.load_mix("long_contigs")
    pool = generate.make(args.seed, mix)[:3]
    gcf = generate.read_source("GCF_001457455.1_NCTC11397_genomic.fna.gz")
    calls = pool + [short_contigs(gcf)]
    finder = GeneFinder(meta=True)
    for call in calls:                      # warm: build, every shape
        finder.find_genes_batch([s for _n, s in call])
    torch.cuda.synchronize()

    found = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        stack = traceback.extract_stack()[:-1]
        port = [f for f in stack if f.filename.startswith(PKG)]
        site = (f"{os.path.relpath(port[-1].filename, ROOT)}:"
                f"{port[-1].lineno} {port[-1].name}" if port
                else f"{filename}:{lineno}")
        open_ = [sp.name for sp in tracing._stack()]
        found[(site, open_[-1] if open_ else "",
               "launch" in open_ or "launch.shard" in open_,
               str(message)[:60])] += 1

    tracing.enable()
    warnings.simplefilter("always")
    warnings.showwarning = show
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for call in calls:
            finder.find_genes_batch([s for _n, s in call])
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rows = [{"site": site, "span": sp, "in_launch": in_launch,
             "count": n, "message": msg}
            for (site, sp, in_launch, msg), n in found.most_common()]
    bad = [r for r in rows if r["in_launch"] and r["span"] != "launch.wait"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"torch": torch.__version__,
                       "device": torch.cuda.get_device_name(0),
                       "calls": len(calls), "syncs": rows,
                       "outside_launch_wait": bad}, f, indent=1)
    for r in rows:
        print(f"{r['count']:6d}  {r['span'] or '-':14s} "
              f"{'launch' if r['in_launch'] else '      '}  {r['site']}")
    print(json.dumps({"syncs": sum(r["count"] for r in rows),
                      "sites": len(rows),
                      "in_a_launch_outside_launch_wait": len(bad)}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
