#!/usr/bin/env python3
"""Each kernel wrapper with its tensors on the last card while card 0 is
current: does it launch there, and does it agree with its plain twin?

    python3 scripts/check_device_guard.py [--root DIR]

`--root` imports `pyrodigal_tpu_torch` from another checkout (e.g. `git
archive <commit> | tar -x -C build/parent`), so that the same calls can
be made on code from before the wrappers set their tensors' device.
The operands are a CPU runner's first std and mega launch on a 6 kb
slice of SRR492066 (the mega route forced), recorded at the wrappers.
Prints one JSON line a kernel: the error the call raised, if any, and
otherwise whether it agrees with its plain twin (the prefix sums within
the checkout's own bound: `star_cuda.round_once_bound`, or
`sum_order_bound` in a checkout whose kernels add in f32; star's
integers exactly and its floats to rtol 1e-6, the DPs exactly).  Needs two CUDA devices; imports neither
jax nor the JAX package.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = {
    "dc_chain": ("star_cuda", "dc_phase_cumsum"),
    "phase_cumsum": ("star_cuda", "phase_cumsum"),
    "star": ("star_cuda", "star_tables"),
    "dp_mega": ("dp_cuda", "mega_dp"),
    "dp_std": ("dp_cuda", "std_dp"),
}


def _captured(mods, meta_cuda, bins, seq):
    """{kernel: (arguments, plain output)}: the first call of each wrapper
    in a CPU runner's std launch, then its mega launch, of `seq`."""
    calls = {}
    saved = []
    for kernel, (mod, name) in WRAPPERS.items():
        orig = getattr(mods[mod], name)
        saved.append((mods[mod], name, orig))

        def record(*a, _orig=orig, _kernel=kernel):
            out = _orig(*a)
            calls.setdefault(_kernel, (a, out))
            return out

        setattr(mods[mod], name, record)
    bucket = meta_cuda.SEQ_BUCKET
    try:
        for route_bucket in (bucket, 2048):
            meta_cuda.SEQ_BUCKET = route_bucket
            runner = meta_cuda.CudaMetaRunner(bins, device="cpu")
            runner.find_genes_batch([seq])
            runner.close()
    finally:
        meta_cuda.SEQ_BUCKET = bucket
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return calls


def _agrees(torch, star_cuda, kernel, args, got, ref):
    if kernel in ("dc_chain", "phase_cumsum"):
        x_abs = (args[0][:, args[1].long()] if kernel == "dc_chain"
                 else args[0]).abs()
        err = (got.cpu().double() - ref.double()).abs()
        bound = getattr(star_cuda, "round_once_bound", None) \
            or star_cuda.sum_order_bound
        return bool((err <= bound(x_abs, ref)).all())
    if kernel == "star":
        return all(
            torch.equal(a.cpu(), b) if a.dtype == torch.int32
            else torch.allclose(a.cpu(), b, rtol=1e-6, atol=0)
            for a, b in zip(got, ref))
    return all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE,
                    help="checkout whose pyrodigal_tpu_torch is imported")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if torch.cuda.device_count() < 2:
        print("check_device_guard: needs two CUDA devices", file=sys.stderr)
        return 1
    from pyrodigal_tpu_torch import METAGENOMIC_BINS
    from pyrodigal_tpu_torch.fasta import parse
    from pyrodigal_tpu_torch.ops import dp_cuda, meta_cuda, star_cuda

    torch.set_num_threads(8)
    seq = list(parse(os.path.join(HERE, "tests", "data",
                                  "SRR492066.fna.gz")))[0].seq[:6000]
    mods = {"star_cuda": star_cuda, "dp_cuda": dp_cuda}
    calls = _captured(mods, meta_cuda, METAGENOMIC_BINS, seq)
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    failed = 0
    for kernel, (mod, name) in WRAPPERS.items():
        a, ref = calls[kernel]
        moved = [x.to(last) if torch.is_tensor(x) else x for x in a]
        row = {"kernel": kernel, "root": os.path.abspath(args.root),
               "tensors_on": str(last), "current": 0,
               "shape": list(a[4].shape if kernel == "star" else
                             a[7].shape if kernel == "dp_mega" else
                             a[4].shape if kernel == "dp_std" else
                             a[0].shape)}
        try:
            with torch.cuda.device(0):
                got = getattr(mods[mod], name)(*moved)
                torch.cuda.synchronize(last)
            row["error"] = None
            row["agrees_with_plain"] = _agrees(torch, star_cuda, kernel, a,
                                               got, ref)
        except Exception as e:            # report every wrapper's outcome
            row["error"] = f"{type(e).__name__}: {e}"
            row["agrees_with_plain"] = False
        failed += not row["agrees_with_plain"]
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
