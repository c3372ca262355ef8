#!/usr/bin/env python3
"""One benchmark run with the program's spans laid beside the
benchmark's own (CUDA host only).

    python3 scripts/program_spans.py --workload meta.long_contigs \
        --seed N --seconds 51 --trace 1 [--tracing on] [--out PATH]

Runs the cell once as `genebench/run.py` does and prints its result
line, then one JSON line of what the run held:

* with `--trace 1`, over the profiled stretch: each pair of the
  program's span and the benchmark wrapper that times the same method
  (`prep`/`prep`, `launch`/`sweep`, `finish`/`finish`,
  `exact_route`/`fallback`) in thread-seconds and their ratio; the
  device's idle time split by the program span open in it
  (`genebench.progspans.attribute_idle`); the stretch's wall time split
  the same way; and the window's wall per Mbp against the benchmark's
  spans per Mbp; each call's bp, wall seconds and routes; each launch
  in order: its start after its call's, its seconds and those of its
  `launch.pack`, `launch.score` and `launch.wait` children, its route,
  rows, padded rows and buckets;
* with `--tracing on`, the program's tracing is on for the whole run
  (`pyrodigal_tpu_torch.tracing.enable()`), so that a `--trace 0` run
  gives its cost against a run without it on the same seed.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PAIRS = (("prep", "prep"), ("launch", "sweep"), ("finish", "finish"),
         ("exact_route", "fallback"))


def wall_split(st, t0, t1):
    """The stretch's wall time [t0, t1) (ns) split as `attribute_idle`
    splits idle time, by each thread's innermost open span."""
    from genebench import progspans

    points = [(t0, 1, -1), (t1, 0, -1)]
    spans = [(s, s.start, s.end) for s in st.spans if s.end > s.start]
    for k, (_s, a, b) in enumerate(spans):
        points += [(a, 1, k), (b, 0, k)]
    points.sort()
    out, open_, on, last = {}, set(), False, None
    for t, opening, k in points:
        if on and t > last:
            progspans._share(out, t - last, [spans[j] for j in open_])
        last = t
        if k < 0:
            on = bool(opening)
        elif opening:
            open_.add(k)
        else:
            open_.discard(k)
    return {name: ns * 1e-9 for name, ns in sorted(
        out.items(), key=lambda kv: -kv[1])}


def launches(st):
    """Each `launch` span of the stretch in order of start: offset after
    its call's start, seconds, its children's seconds by name, and its
    shape attributes."""
    calls = {c.id: c for c in st.calls}
    kids = {}
    for s in st.spans:
        kids.setdefault(s.parent, []).append(s)

    def below(sp):
        for k in kids.get(sp.id, []):
            yield k
            yield from below(k)

    out = []
    for sp in sorted(st.named("launch"), key=lambda s: s.start):
        parts = {}
        for k in below(sp):
            parts[k.name] = parts.get(k.name, 0.0) + (k.end - k.start) * 1e-9
        out.append({"at_s": (sp.start - calls[sp.call].start) * 1e-9,
                    "s": (sp.end - sp.start) * 1e-9, **parts,
                    **{a: sp.attrs.get(a) for a in (
                        "route", "contigs", "rows", "rows_bucket",
                        "node_bucket", "seq_bucket", "nodes_bucket")}})
    return out


def report(run):
    from genebench import progspans

    st = progspans.stretch(run)
    if st is None:
        return {"stretch": None}
    host = run.calls[:len(run.trace.calls)]
    c0, c1 = host[0]["start"], host[-1]["end"]
    bench = [sp for sp in run.spans if c0 <= sp[1] and sp[2] <= c1]
    pairs = {}
    for prog, mine in PAIRS:
        a = st.seconds(prog)
        b = sum(e - s for n, s, e, _t in bench if n == mine)
        pairs[f"{prog}/{mine}"] = [a, b, a / b if b else None]
    idle = progspans.attribute_idle(run, st)
    window_mbp = run.window_bp / 1e6
    return {
        "stretch": {"calls": len(st.calls), "bp": st.bp,
                    "wall_s": c1 - c0,
                    "routes": [[s.attrs.get("bp"), s.attrs.get("route"),
                                s.attrs.get("route_reason")]
                               for s in st.named("prep")],
                    "call_s": [[c.attrs["bp"], c.seconds,
                                [s.attrs.get("route") for s in st.named("prep")
                                 if s.call == c.id]] for c in st.calls]},
        "pairs_thread_s": pairs,
        "launches": launches(st),
        "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "wall_s": wall_split(st, int(c0 * 1e9), int(c1 * 1e9)),
        "window": {"wall_s_per_mbp": run.window_s / window_mbp,
                   "bench_spans_s_per_mbp": {
                       n: run.span_seconds(n) / window_mbp
                       for n in ("prep", "sweep", "finish", "fallback")}},
    }


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--tracing", choices=("on", "off"), default="off")
    p.add_argument("--out")
    args = p.parse_args()
    from genebench import harness

    runs = []

    class Run(harness.Run):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    harness.Run = Run
    if args.tracing == "on":
        from pyrodigal_tpu_torch import tracing

        tracing.enable()
    code, result = harness.run(args)
    out = {"seed": args.seed, "trace": args.trace, "tracing": args.tracing,
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "correct": result["correct"]}
    if args.trace:
        out.update(report(runs[0]))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return code


if __name__ == "__main__":
    sys.exit(main())
