#!/usr/bin/env python3
"""Sweep the tiles a block of the prefix-sum kernels (dc-chain,
phase-cumsum) over the launch shapes the runner issues, on one GPU, and
weigh rules that pick the tiles a block.

    python3 scripts/sweep_prefix_chunking.py [--reps 20] [--rounds 3]

1. Records every (kernel, rows, S) the runner launches (the wrappers
   wrapped): meta mode on chip_smoke's bench set and short-contig set,
   and on both sets over two shards on cuda:0.
2. Times, at every recorded shape, the bare C launch at 1 to 16 tiles a
   block on random operands: the least, over `--rounds` rounds, of the
   mean of `--reps` calls in one CUDA graph (chip_smoke._graph_ms).
3. Weighs rules: the B-dependent rule (about 1,024 blocks a launch) and
   S-only rules min(16, max(floor, ceil(tiles / chunks))), by the time
   of one pass of the unsharded runs (each shape's time x its launches)
   and by the worst ratio, over the unsharded shapes, to the B-dependent
   rule's time at that shape.

Prints one JSON line, then the card's name and power limit.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MAX_TPB = 16
_lock = threading.Lock()        # shards log from their own threads


def _record(shapes, tag, fn):
    """Run fn with the prefix wrappers logging their shapes under tag."""
    from pyrodigal_tpu_torch.ops import star_cuda

    dc, pc = star_cuda.dc_phase_cumsum, star_cuda.phase_cumsum

    def dc_logged(table, codes):
        with _lock:
            shapes[tag]["dc_chain", table.shape[0], codes.shape[0]] += 1
        return dc(table, codes)

    def pc_logged(x):
        with _lock:
            shapes[tag]["phase_cumsum", *x.shape] += 1
        return pc(x)

    star_cuda.dc_phase_cumsum, star_cuda.phase_cumsum = dc_logged, pc_logged
    try:
        fn()
    finally:
        star_cuda.dc_phase_cumsum, star_cuda.phase_cumsum = dc, pc


def _old_tpb(B, S):
    """The B-dependent rule: as few tiles a block as give about 1,024
    blocks a launch."""
    from pyrodigal_tpu_torch.ops.star_cuda import TILE

    T = -(-S // TILE)
    return min(MAX_TPB, max(1, -(-B * T // 1024)))


def _s_only_tpb(S, chunks, floor):
    from pyrodigal_tpu_torch.ops.star_cuda import TILE

    T = -(-S // TILE)
    return min(MAX_TPB, max(floor, -(-T // chunks)))


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_prefix_chunking: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from pyrodigal_tpu_torch import METAGENOMIC_BINS, _build
    from pyrodigal_tpu_torch.ops import star_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner
    from pyrodigal_tpu_torch.parallel import make_mesh

    _build.lib()
    bench = [r.seq for name in cs.CONTIGS for r in cs._records(name)]
    short = [s for _n, s in cs.short_contigs()]
    shapes = {"main": collections.Counter(), "mesh2": collections.Counter()}

    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0")
    _record(shapes, "main", lambda: runner.find_genes_batch(bench))
    _record(shapes, "main", lambda: runner.find_genes_batch(short))
    runner.close()
    mesh = make_mesh(devices=["cuda:0"] * 2)
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0", mesh=mesh)
    _record(shapes, "mesh2", lambda: runner.find_genes_batch(bench))
    _record(shapes, "mesh2", lambda: runner.find_genes_batch(short))
    runner.close()
    torch.cuda.empty_cache()

    lib = _build.lib()
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    times = {}
    for kernel, B, S in sorted(set(shapes["main"]) | set(shapes["mesh2"])):
        T = -(-S // star_cuda.TILE)
        if kernel == "dc_chain":
            table = torch.randn((B, 4096), generator=gen, device="cuda:0")
            codes = torch.randint(0, 4096, (S,), generator=gen,
                                  device="cuda:0", dtype=torch.int32)
            out = torch.empty((B, S), device="cuda:0")
            ins = (table, codes)
        else:
            x = torch.randn((B, S), generator=gen, device="cuda:0")
            out = torch.empty_like(x)
            ins = (x,)
        row = {}
        for tpb in range(1, MAX_TPB + 1):
            scr = torch.empty((B, -(-T // tpb), 3), device="cuda:0")

            def launch(tpb=tpb, scr=scr):
                _build.check(getattr(lib, f"{kernel}_launch")(
                    *(t.data_ptr() for t in (*ins, out, scr)), B, S, tpb,
                    torch.cuda.current_stream().cuda_stream), kernel)

            row[tpb] = min(cs._graph_ms(launch, opts.reps)
                           for _ in range(opts.rounds))
        times[kernel, B, S] = row
        del ins, out
        torch.cuda.empty_cache()

    def at(key, tpb):
        return times[key][tpb]

    rules = {"B-dependent": lambda B, S: _old_tpb(B, S)}
    for chunks in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128):
        for floor in (1, 2):
            rules[f"S-only chunks {chunks} floor {floor}"] = (
                lambda B, S, c=chunks, f=floor: _s_only_tpb(S, c, f))
    weighed = []
    for name, rule in rules.items():
        total = {tag: sum(at(key, rule(*key[1:])) * n
                          for key, n in shapes[tag].items())
                 for tag in shapes}
        worst = max((at(key, rule(*key[1:])) / at(key, _old_tpb(*key[1:])),
                     key) for key in shapes["main"])
        weighed.append({"rule": name, "pass_ms": total["main"],
                        "mesh2_pass_ms": total["mesh2"],
                        "worst_ratio": worst[0], "worst_shape": worst[1],
                        "tiles_per_block": {
                            f"{k}:{B}x{S}": rule(B, S)
                            for k, B, S in sorted(times)}})
    result = {
        "shapes": {tag: [[*key, n] for key, n in sorted(c.items())]
                   for tag, c in shapes.items()},
        "ms": [[*key, row] for key, row in sorted(times.items())],
        "rules": weighed}
    print(json.dumps(result))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
