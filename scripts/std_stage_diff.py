#!/usr/bin/env python3
"""Stage by stage, a std launch on the card against its plain twins.

Rebuilds the std launch that holds one contig of a pool call of the
benchmark's `short_contigs` mix (as `CudaMetaRunner` packs that call),
runs it on the card with every kernel wrapper's call captured
(phase-cumsum, the seg-scan passes, star, the std DP), replays each
captured call on its plain twin on the CPU from the same operands, and
prints, stage by stage, how far the card's outputs lie from the twin's
(the prefix sums against `star_cuda.round_once_bound`, the others bit for
bit), then the contig's per-bin best path scores on the card, on the CPU
twins end to end, and on the exact engine.  It exits 1 when a stage
departs from its twin.

    python3 scripts/std_stage_diff.py --seed 22 --call 2 --contig 89 \\
        --out chiprun_out/std_stage_diff.json

H100 only (it exits 1 without CUDA).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def launch_holding(runner, contigs, ci):
    """(work, geoms) of the std launch of `contigs` that holds contig ci,
    packed as the runner packs the call."""
    from pyrodigal_tpu_torch.sequence import Sequence

    preps = list(runner.pool.map(
        lambda s: runner._prepare_contig(Sequence(s)), contigs))
    items = [(k, cand, geoms) for k, (cand, geoms, _n, route)
             in enumerate(preps) if route == "std" and cand]
    for L in runner._pack_std(items):
        if any(k == ci for k, _b, _key in L["work"]):
            return L["work"], L["geoms"]
    raise ValueError(f"contig {ci} takes no std launch")


class Capture:
    """Every call of the std launch's kernel wrappers: (stage, args,
    output), the tensors as they were on the card."""

    STAGES = (("star_cuda", "phase_cumsum"), ("star_cuda", "seg_scan_passes"),
              ("star_cuda", "star_tables"), ("dp_cuda", "std_dp"))

    def __init__(self):
        from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda

        self.mods = {"star_cuda": star_cuda, "dp_cuda": dp_cuda}
        self.calls = []
        self.saved = []

    def __enter__(self):
        for mod, name in self.STAGES:
            owner = self.mods[mod]
            orig = getattr(owner, name)
            self.saved.append((owner, name, orig))
            setattr(owner, name, self._wrap(name, orig))
        return self

    def _wrap(self, name, orig):
        def wrapper(*args):
            out = orig(*args)
            self.calls.append((name, [_keep(a) for a in args], _keep(out)))
            return out
        return wrapper

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.saved):
            setattr(owner, name, orig)


def _keep(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_keep(a) for a in x)
    return x


def _cpu(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(a) for a in x)
    return x


def _flat(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def compare_stages(calls):
    """[(stage, call index, fields)] for every captured call, each field
    {'max_abs': ..., 'ok': ...}: the card's output against the plain
    twin's on the CPU copies of the same operands."""
    import torch

    from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda

    twins = {"phase_cumsum": star_cuda.phase_cumsum,
             "seg_scan_passes": star_cuda.seg_scan_passes,
             "star_tables": star_cuda.star_tables,
             "std_dp": dp_cuda.std_dp}
    out = []
    for k, (name, args, got) in enumerate(calls):
        cargs = [_cpu(a) for a in args]
        ref = twins[name](*cargs)
        fields = []
        for g, r in zip(_flat(_cpu(got)), _flat(ref)):
            if g.dtype.is_floating_point:
                diff = (g.double() - r.double()).abs()
                diff = torch.where(torch.isnan(g) & torch.isnan(r),
                                   torch.zeros_like(diff), diff)
                if name == "phase_cumsum":
                    bound = star_cuda.round_once_bound(cargs[0].abs(), r)
                    ok = bool((diff <= bound).all())
                else:
                    ok = bool((diff == 0).all())
                fields.append({"max_abs": float(diff.max()), "ok": ok})
            else:
                fields.append({"max_abs": float((g.long() - r.long()).abs()
                                                .max()),
                               "ok": bool(torch.equal(g, r))})
        out.append((name, k, fields))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--call", type=int, required=True)
    p.add_argument("--contig", type=int, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("std_stage_diff: needs a CUDA device", file=sys.stderr)
        return 1
    from genebench import generate
    from pyrodigal_tpu_torch.metagenomic import METAGENOMIC_BINS
    from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner
    from pyrodigal_tpu_torch.sequence import Sequence

    contigs = [s for _n, s in generate.make(
        args.seed, generate.load_mix("short_contigs"))[args.call]]
    card = CudaMetaRunner(METAGENOMIC_BINS, device="cuda")
    host = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    try:
        work, geoms = launch_holding(card, contigs, args.contig)
        card._sweep_std(work, geoms)            # warm
        with Capture() as cap:
            best_card = card._sweep_std(work, geoms)
        best_cpu = host._sweep_std(work, geoms)
        stages = compare_stages(cap.calls)
        seq = Sequence(contigs[args.contig])
        nodes_by_tt = host._prepare_contig(seq)[2]
        rows = []
        for k, (ci, b, _key) in enumerate(work):
            if ci != args.contig:
                continue
            run = host._run_bin(seq, nodes_by_tt, b)
            exact = run.score if run.ipath >= 0 else None
            rows.append({"bin": b, "card": float(best_card[k]),
                         "cpu_twins": float(best_cpu[k]), "exact": exact})
    finally:
        card.close()
        host.close()
    departs = [(n, k) for n, k, f in stages if not all(x["ok"] for x in f)]
    result = {"seed": args.seed, "call": args.call, "contig": args.contig,
              "rows": len(work), "geometries": len(geoms),
              "device": torch.cuda.get_device_name(0),
              "stages": [{"stage": n, "call": k, "fields": f}
                         for n, k, f in stages],
              "first_departing_stage": departs[0] if departs else None,
              "best": rows,
              "rows_card_vs_cpu_max_abs": float(abs(best_card - best_cpu)
                                                .max())}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({k: result[k] for k in
                      ("first_departing_stage", "best",
                       "rows_card_vs_cpu_max_abs", "rows", "geometries")}))
    for s in result["stages"]:
        print(s["stage"], s["call"], s["fields"])
    return 1 if departs else 0


if __name__ == "__main__":
    sys.exit(main())
