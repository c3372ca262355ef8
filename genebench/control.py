#!/usr/bin/env python3
"""The control of the `correct` comparison: the reference put in the
program's place with its node scores rounded to bfloat16, the precision
below the float32 that the configuration states for the device's scores.

For each seed it makes the cell's pool of calls as a run does, scores
every (contig, bin) of every call with the reference in float64 and with
the control, hands the control's scores to the harness's own comparison
(`check.compare`, `check.verdict`, the cell's limits) in place of the
device's, and prints the result: `correct` has to come out false.

    python3 genebench/control.py --workload meta.long_contigs \
        --seeds 1 2 3

Benchmark runs never run it; it needs no card.
"""

import argparse
import json
import os
import sys
import time


def control_result(config, mode, pool, limits, ex):
    """(correct, checks, facts) of the control over the pool of calls."""
    from genebench.check import compare, verdict

    numbered = [(contigs, 1) for contigs in pool]
    exact = mode.reference(ex, config, numbered, "f64", with_texts=False)
    low = mode.reference(ex, config, numbered, "bf16", with_texts=False)
    device = {(k, ci): scores for k, call in enumerate(low)
              for ci, (scores, _t) in enumerate(call)}
    expected = dict(enumerate(exact))
    got = {k: [None] * len(call) for k, call in enumerate(pool)}
    numbers, facts = compare(expected, got, device,
                             {k: k for k in range(len(pool))})
    checks = verdict(numbers, limits["limits"])
    return all(w for *_x, w in checks), checks, facts


def main(argv=None):
    from genebench import generate, harness
    from genebench.reference import engine

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    _cell, config, mix, limits = harness.resolve(args.workload, bench)
    mode = harness.load_mode(config["mode"])
    with engine.executor() as ex:
        for seed in args.seeds:
            t0 = time.perf_counter()
            pool = generate.make(seed, mix)
            correct, checks, facts = control_result(config, mode, pool,
                                                    limits, ex)
            print(json.dumps({
                "workload": args.workload, "seed": seed,
                "control": "bfloat16 node scores", "correct": correct,
                "checks": {n: {"value": v, "limit": lim}
                           for n, v, lim, _w in checks},
                "pairs": facts["pairs"],
                "widest_gaps": [g[:4] for g in facts["widest_gaps"][:3]],
                "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    main()
