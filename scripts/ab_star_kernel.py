#!/usr/bin/env python3
"""Time this tree's star kernel against another checkout's, on one GPU.

    python3 scripts/ab_star_kernel.py [--other DIR] [--reps 10] [--sweep]

Operands, built once by this tree: the genome's mega launch (one shared
geometry row, 16 bin rows x 163,840 nodes) and the first std launch of
chip_smoke's short-contig set (one geometry row per bin row, 128 x 3,072).
Each time is the mean of `--reps` bare C launches captured in one CUDA
graph (chip_smoke._graph_ms).

- `--other DIR` (repeatable): DIR is a checkout of the port (for example
  an earlier commit unpacked with `git archive`) whose `_build.py` builds
  its kernels into DIR/build; its `star_launch` takes the signature its
  `_build.py` declares (without the tile and rows-a-block arguments
  before this design).  Order other, this, this, other; both kernels'
  outputs are compared bit for bit.
- `--sweep`: this tree's kernel at other tiles (nodes a block) and other
  bin rows a block (1-16 over the shared geometry, 1-2 per row).

Every output is held to the plain twin (integers exactly, floats within
rtol 1e-6).  Beside the kernel, `fill_ms` times one `fill_` of as many
bytes as the kernel writes: what this card's stores reach.  Prints one
JSON line, then the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TILES = (64, 128, 256, 512)
ROWS = (1, 2, 4, 8, 16)


def _other_build(path):
    spec = importlib.util.spec_from_file_location(
        "other_build", os.path.join(path, "pyrodigal_tpu_torch", "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sweep", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_star_kernel: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from pyrodigal_tpu_torch import METAGENOMIC_BINS, _build
    from pyrodigal_tpu_torch.ops import star_cuda
    from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner

    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0")
    geo, bin_idx, _g, _NT, _SB = cs._prepared(runner,
                                              cs._records(cs.GENOME)[0].seq)
    layouts = {"shared": cs._mega_star_args(runner, geo, bin_idx)}
    work, geoms = cs._first_std_launch(runner, cs.short_contigs())
    layouts["per_row"] = cs._std_dp_args(runner, work, geoms)[4]
    runner.close()
    del geo

    def launcher(lib, args, tile=None, rows=None):
        """A bare launch of `lib`'s star_launch on `args` into fresh
        outputs (tile None: the signature without tile and rows)."""
        B, NT = args[4].shape
        R = args[0].shape[0]

        def run():
            outs = [torch.empty((3, B, NT), dtype=dt, device=args[4].device)
                    for dt in (torch.int32, torch.float32, torch.float32,
                               torch.int32, torch.int32)]
            shape = [] if tile is None else [tile, rows]
            err = lib.star_launch(
                *(a.data_ptr() for a in args[:8]),
                *(o.data_ptr() for o in outs), B, NT, args[8], args[9],
                0 if R == 1 else NT, *shape,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"star_launch: CUDA error {err}")
            return outs
        return run

    lib = _build.lib()
    result = {}
    for name, args in layouts.items():
        B, NT = args[4].shape
        R = args[0].shape[0]
        ref = star_cuda.star_tables_plain(*args)
        tile, rows = star_cuda.STAR_TILE, star_cuda._star_rows(B, R)
        this = launcher(lib, args, tile, rows)
        got = this()
        err, bits = cs._star_check(f"{name} star", got, ref)
        r = result[name] = {"shape": [B, NT], "tile": tile,
                            "rows_per_block": rows, "max_abs_err": err,
                            "float_bit_equal_plain": bits}
        # the store rate's yardstick: the same output bytes written by
        # one fill kernel
        fill = torch.empty(sum(o.numel() for o in got), dtype=torch.int32,
                           device=args[4].device)
        r["fill_ms"] = cs._graph_ms(lambda: fill.fill_(0), opts.reps)
        del fill
        for path in opts.other:
            olib = _other_build(os.path.abspath(path)).lib()
            old_sig = len(olib.star_launch.argtypes) == 19
            other = launcher(olib, args, *((None, None) if old_sig
                                           else (tile, rows)))
            ogot = other()
            cs._star_check(f"{name} star ({path})", ogot, ref)
            ms = {"other": [], "this": []}
            for k, fn in (("other", other), ("this", this), ("this", this),
                          ("other", other)):
                ms[k].append(cs._graph_ms(fn, opts.reps))
            r.setdefault("other", {})[path] = {
                "bit_equal": all(torch.equal(a, b)
                                 for a, b in zip(got, ogot)),
                "ms_other": ms["other"], "ms_this": ms["this"]}
        if opts.sweep:
            sweep = []
            for t in TILES:
                for g in (ROWS if R == 1 else (1, 2)):
                    fn = launcher(lib, args, t, g)
                    cs._star_check(f"{name} star (tile {t}, rows {g})",
                                   fn(), ref)
                    sweep.append({"tile": t, "rows_per_block": g,
                                  "ms": cs._graph_ms(fn, opts.reps)})
            r["sweep"] = sweep
        del ref, got
    print(json.dumps(result))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
