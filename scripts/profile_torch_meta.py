#!/usr/bin/env python3
"""Where a meta-mode pass of the PyTorch/CUDA port spends its time.

    python3 scripts/profile_torch_meta.py [--out FILE] [--root DIR]
                                          [--scoring-only]

On one CUDA device, for each of two contig sets -- "bench", the four
bench contigs (`bench.py` WORKLOAD, one replica each; the mega route),
and "short", `chip_smoke.py`'s short-contig set (the genome cut into ~500
contigs of lognormal length, plus KK037166; the std route):

1. warm passes: one untimed `GeneFinder(meta=True,
   backend="cuda").find_genes_batch`, then PASSES timed ones (wall,
   median, Mbp/s);
2. stage replay, each stage alone with a synchronize around it: host prep
   (`_prepare_contig`) per contig on one thread and on the runner's pool,
   each launch as the runner packs it (`_sweep_mega_multi` per
   `_group_mega` group, `_sweep_std` per `_pack_std` launch: scoring,
   star, DP, pull), and the exact-C finishing (`_produce_winner`) per
   contig;
3. one warm pass under `torch.profiler` (CPU and CUDA activity): device
   time by kernel name (`key_averages()`, self device time; the TOP
   largest, and every kernel of `csrc/` apart), the total, and the
   device's busy share of that pass;
4. one scoring launch (`score_device._score_items`) under
   `torch.profiler` after a warm-up call: the genome's mega launch
   (bench) or the short set's first std launch (short), its device
   events counted in total and by name.

`--root DIR` profiles the package and `chip_smoke.py` of another
checkout (unpacked with `git archive`) with this script; `--scoring-only`
runs part 4 alone.  Prints one line per part and set and, last, the
whole record as one JSON line; `--out` also writes that record to a
file.  Imports no jax.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PASSES = 5
TOP = 12
# entry functions of csrc/*.cu, listed apart from the top TOP
PORT_KERNELS = ("dc_chain_", "phase_cumsum_", "star_kernel", "dp_mega_kernel",
                "dp_std_kernel", "seg_scan_")


def _sync_time(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_ms(evt):
    # the attribute was renamed from *_cuda_* to *_device_* in PyTorch 2.4
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name) / 1e3
    return 0.0


def warm_passes(finder, seqs, passes):
    finder.find_genes_batch(seqs)
    walls = [_sync_time(lambda: finder.find_genes_batch(seqs))[1]
             for _ in range(passes)]
    return walls


def stage_replay(runner, seqs):
    from pyrodigal_tpu_torch.sequence import Sequence

    contigs = [Sequence(s) for s in seqs]
    preps, prep_one = [], []
    for seq in contigs:
        p, dt = _sync_time(lambda: runner._prepare_contig(seq))
        preps.append(p)
        prep_one.append(dt)
    _, prep_pool = _sync_time(
        lambda: list(runner.pool.map(runner._prepare_contig, contigs)))

    mega_items, std_items = [], []
    for ci, (cand, geoms, _nbt, route) in enumerate(preps):
        assert route != "c", route
        if not cand:
            continue
        if route == "std":
            std_items.append((ci, cand, geoms))
            continue
        by_tt = {}
        for b in cand:
            by_tt.setdefault(runner.bins[b].training_info.translation_table,
                             []).append(b)
        mega_items += [{"ci": ci, "g": geoms[tt], "rows": bs}
                       for tt, bs in by_tt.items()]
    launches, cands = [], {}
    for gr in runner._group_mega(mega_items):
        (bests, rows, CP, B), dt = _sync_time(
            lambda: runner._sweep_mega_multi(gr["items"]))
        pos = {b: i for i, b in enumerate(rows)}
        for k, it in enumerate(gr["items"]):
            cands.setdefault(it["ci"], []).extend(
                (b, float(bests[k, pos[b]])) for b in it["rows"])
        launches.append({
            "route": "mega",
            "contigs": sorted({it["ci"] for it in gr["items"]}),
            "rows": len(rows), "B": B, "CP": CP,
            "nodes": sum(it["g"]["nn"] for it in gr["items"]),
            "s": dt})
    for L in runner._pack_std(std_items):
        bests, dt = _sync_time(
            lambda: runner._sweep_std(L["work"], L["geoms"]))
        for k, (ci, b, _key) in enumerate(L["work"]):
            cands.setdefault(ci, []).append((b, float(bests[k])))
        launches.append({
            "route": "std",
            "contigs": sorted({ci for ci, _b, _key in L["work"]}),
            "rows": len(L["work"]), "geoms": len(L["geoms"]),
            "nodes_max": max(g["nn"] for g in L["geoms"].values()),
            "s": dt})

    finishing = []
    for ci, cs in cands.items():
        _, dt = _sync_time(lambda: runner._produce_winner(
            contigs[ci], ci + 1, cs, preps[ci][2]))
        finishing.append(dt)
    return {"prep_one_thread_s": prep_one, "prep_pool_s": prep_pool,
            "launches": launches, "finishing_s": finishing}


def _launch_summary(launches):
    parts = []
    for route in ("mega", "std"):
        ls = [g for g in launches if g["route"] == route]
        if ls:
            t = [g["s"] for g in ls]
            parts.append(f"{route} {len(ls)} launches, {sum(t)} s (mean "
                         f"{statistics.mean(t)}, max {max(t)})")
    return "; ".join(parts)


def profiled_pass(finder, seqs, top):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _sync_time(lambda: finder.find_genes_batch(seqs))
    rows = [(e.key, e.count, _device_ms(e)) for e in prof.key_averages()]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    return {"wall_s": wall, "device_ms": device_ms,
            "busy": device_ms / 1e3 / wall,
            # PyTorch's scans along an outer axis, one thread a column
            "outer_dim_scans_ms": sum(ms for k, _n, ms in rows
                                      if "scan_outer_dim" in k),
            "kernels": [{"name": k, "calls": n, "self_device_ms": ms}
                        for k, n, ms in rows[:top]],
            # the port's own kernels (csrc/*.cu), whatever their rank
            "port_kernels": [{"name": k, "calls": n, "self_device_ms": ms}
                             for k, n, ms in rows if "_kernel" in k
                             and any(e in k for e in PORT_KERNELS)]}


def scoring_launch(runner, name, seqs):
    """Device events of one scoring launch (`_score_items`, the
    seg-scan's wrapper calls and every elementwise op around them): the
    genome's mega launch for "bench", the first std launch for "short"."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from pyrodigal_tpu_torch.ops import score_device as sd

    if name == "bench":
        geo, bin_idx, _g, _NT, _SB = chip_smoke._prepared(runner, seqs[0])
        gidx, nonsd = None, runner.tables.any_nonsd
    else:
        work, geoms = chip_smoke._first_std_launch(
            runner, [(None, s) for s in seqs])
        packed, bin_idx, gidx, nonsd = runner._std_inputs(work, geoms)
        geo = sd.to_device(packed, runner.device)
        bin_idx = torch.from_numpy(bin_idx).to(runner.device)
        gidx = torch.from_numpy(gidx).to(runner.device)

    def score():
        return sd._score_items(runner.tables.as_tuple(), geo, bin_idx, gidx,
                               is_meta=True, closed=False, has_nonsd=nonsd)

    score()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        score()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"shape": [int(bin_idx.shape[0]), int(geo["n32"].shape[2])],
            "device_events": len(events),
            "device_ms": sum(e.time_range.elapsed_us() for e in events) / 1e3,
            "by_name": dict(collections.Counter(e.name[:80]
                                               for e in events))}


def profile_set(finder, runner, seqs):
    total_bp = sum(len(s) for s in seqs)
    walls = warm_passes(finder, seqs, PASSES)
    med = statistics.median(walls)
    print(f"  warm passes: {walls}; median {med} s, "
          f"{total_bp / med / 1e6} Mbp/s ({len(seqs)} contigs, {total_bp} "
          f"bp)", flush=True)
    replay = stage_replay(runner, seqs)
    print(f"  stage replay: prep one thread sum "
          f"{sum(replay['prep_one_thread_s'])} s, pool "
          f"{replay['prep_pool_s']} s; "
          f"{_launch_summary(replay['launches'])}; finishing sum "
          f"{sum(replay['finishing_s'])} s over "
          f"{len(replay['finishing_s'])} contigs (max "
          f"{max(replay['finishing_s'], default=0.0)})", flush=True)
    prof = profiled_pass(finder, seqs, TOP)
    print(f"  profiled pass: wall {prof['wall_s']} s, device "
          f"{prof['device_ms']} ms, busy {prof['busy']}; outer-axis scans "
          f"{prof['outer_dim_scans_ms']} ms", flush=True)
    for k in prof["port_kernels"]:
        print(f"  port kernel {k['self_device_ms']:10.3f} ms "
              f"{k['calls']:5d}x {k['name'][:80]}")
    for k in prof["kernels"]:
        print(f"  {k['self_device_ms']:10.3f} ms {k['calls']:5d}x "
              f"{k['name'][:100]}")
    return {"total_bp": total_bp, "contigs": len(seqs),
            "warm_walls_s": walls, "warm_median_s": med,
            "mbps": total_bp / med / 1e6, "replay": replay,
            "profile": prof}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON record here")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package is profiled")
    ap.add_argument("--scoring-only", action="store_true",
                    help="only count one scoring launch's device events")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_meta: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    import pyrodigal_tpu_torch

    sets = {
        "bench": [r.seq for name in chip_smoke.CONTIGS
                  for r in chip_smoke._records(name)],
        "short": [s for _n, s in chip_smoke.short_contigs()],
    }
    record = {}
    for name, seqs in sets.items():
        print(f"{name}:", flush=True)
        finder = pyrodigal_tpu_torch.GeneFinder(meta=True, backend="cuda")
        runner = finder._get_meta_runner()
        record[name] = ({} if args.scoring_only
                        else profile_set(finder, runner, seqs))
        sc = record[name]["scoring_launch"] = scoring_launch(runner, name,
                                                              seqs)
        print(f"  one scoring launch {sc['shape']}: {sc['device_events']} "
              f"device events, {sc['device_ms']} ms; " + ", ".join(
                  f"{n}x {k}" for k, n in sorted(sc["by_name"].items(),
                                                 key=lambda x: -x[1])),
              flush=True)
        runner.close()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    record["device"] = smi
    record["root"] = os.path.abspath(args.root)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported: the port must run without it")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(smi)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
