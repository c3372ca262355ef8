"""One run of one cell: `python3 genebench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`.

Everything a cell is made of is found by name: the cell in
`BENCHMARK.json`'s `workloads`, its configuration in
`genebench/configs/<config>.json`, the configuration's mode (how a call
drives the port's entry, and the reference of that entry) in
`genebench/modes/<mode>.py`, its traffic mix in
`genebench/traffic/<traffic>.json` (read by `generate.py`), its limits
in `genebench/checks/<cell>.json`, and each metric in
`genebench/metrics/<metric>.py` (a `read(run)` that returns a number,
or None when the run holds nothing for it to read).

A run: set-up (imports, CUDA, the port's kernels and C engine, the
traffic from the seed, the finder, warm calls of the cell's own
traffic), then a closed loop with one client that starts whole calls
until `--seconds` have passed and lets the last one finish, then the
comparison with the reference (`check.py`), then one JSON line.
"""

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "pyrodigal_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "pyrodigal_tpu")


class RunError(Exception):
    """A run that cannot give a result: exit code 1, no result line."""


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `pyrodigal_tpu_torch` is not
    `pyrodigal_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _load(kind, name, directory):
    path = os.path.join(directory, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"genebench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name, directory=None):
    return _load("metric", name,
                 directory or os.path.join(HERE, "metrics"))


def load_mode(name, directory=None):
    return _load("mode", name, directory or os.path.join(HERE, "modes"))


def resolve(cell, bench, root=ROOT, here=HERE):
    """The cell's entry, configuration, traffic mix and limits, each from
    its own file, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise RunError(f"no workload {cell!r} in BENCHMARK.json")
    w = cells[cell]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root, cfg["file"])
    mix = load_json(here, "traffic", f"{w['traffic']}.json")
    limits = load_json(here, "checks", f"{cell}.json")
    return w, config, mix, limits


def metrics_for(cell, bench, trace):
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


class Device:
    """The card the run measures, or the CPU in a test that drives the
    rest of a run (`device="cpu"`)."""

    def __init__(self, kind, chips):
        import torch

        self.torch = torch
        self.cuda = kind == "cuda"
        self.chips = chips

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def info(self):
        if not self.cuda:
            return {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}
        t = self.torch.cuda
        return {"platform": "gpu", "kind": t.get_device_name(0),
                "count": self.chips,
                "memory_peak_bytes": max(t.max_memory_allocated(i)
                                         for i in range(self.chips)),
                "power_limit_w": power_limit()}


def power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """What the metric readers read: the cell, set-up time, the window's
    calls, the recorder's spans and counts, the port's counters, and the
    profiled stretch's `trace` (None without `--trace 1`)."""

    def __init__(self, cell, setup_s, calls, recorder, counters, trace):
        self.cell = cell
        self.setup_s = setup_s
        self.calls = calls
        ok = [c for c in calls if c["ok"]]
        self.window_bp = sum(c["bp"] for c in ok)
        self.window_s = (calls[-1]["end"] - calls[0]["start"]) if calls \
            else 0.0
        self.spans = list(recorder.spans)
        self.counts = dict(recorder.counts, **counters)
        self.dp_launches = list(recorder.dp_launches)
        self.trace = trace

    def span_seconds(self, name):
        return sum(b - a for n, a, b, _t in self.spans if n == name)


def run(args, device="cuda", out=sys.stdout, err=sys.stderr, t0=None,
        root=ROOT, here=HERE):
    """One run; returns (exit code, result dict).  `device="cpu"` lets a
    test drive a run without a card (its finder's runner put on the CPU);
    `root` and `here` hold BENCHMARK.json and the cell's files."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = load_json(root, "BENCHMARK.json")
    cell, config, mix, limits = resolve(args.workload, bench, root, here)
    chips = cell["chips"]
    if not os.path.exists(os.path.join(ROOT, PORT, "__init__.py")):
        raise RunError(f"{PORT}/ is not beside genebench/ in {ROOT}")
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        raise RunError(
            f"needs {chips} CUDA device(s): torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() is "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = Device(device, chips)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import pyrodigal_tpu_torch
    from pyrodigal_tpu_torch.ops import dp_cuda, meta_cuda

    if not os.path.abspath(pyrodigal_tpu_torch.__file__).startswith(ROOT):
        raise RunError(f"{PORT} came from {pyrodigal_tpu_torch.__file__}, "
                       f"not from {ROOT}")
    if device == "cuda":
        from pyrodigal_tpu_torch import _build

        _build.lib()                    # nvcc at a checkout's first run
    from genebench import generate, instrument

    mode = load_mode(config["mode"], os.path.join(here, "modes"))
    pool = generate.make(args.seed, mix)
    recorder = instrument.Recorder(bool(args.trace))
    recorder.install(meta_cuda, dp_cuda)
    finder = mode.finder(config)
    try:
        return _measure(args, bench, cell, config, mode, mix, limits, dev,
                        pool, recorder, finder, dp_cuda, out, err, t0, here)
    finally:
        recorder.uninstall()


def _measure(args, bench, cell, config, mode, mix, limits, dev, pool,
             recorder, finder, dp_cuda, out, err, t0, here):
    from genebench import devtrace as tracing

    # the profiler of a traced run starts before the warm call, which is
    # its warm-up step (CUPTI's start-up stays out of the window); its
    # active steps are the window's first `trace_calls` calls
    traced = mix.get("trace_calls", 1) if args.trace else 0
    prof = tracing.start(traced, dev.cuda) if traced else None
    # warm-up on the cell's own traffic: the pool's first `warm_calls`
    # calls, enough for each route and shape the pool's calls take
    sizes = [sum(len(s) for _n, s in call) for call in pool]
    warm = pool[:mix.get("warm_calls", 1)]
    for call in warm:
        mode.call(finder, call, recorder, -1)
    sent = sum(map(len, warm))
    dev.sync()
    recorder.clear()
    dp_cuda.LAUNCHES.reset()
    setup_s = time.perf_counter() - t0

    calls, kept = [], {}
    if prof is not None:
        prof.step()
        recorder.profiling = True
    start = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - start < args.seconds:
        pi = k % len(pool)
        c0 = time.perf_counter()
        try:
            if k < traced:
                import torch

                with torch.profiler.record_function(tracing.CALL):
                    result = mode.call(finder, pool[pi], recorder, k)
            else:
                result = mode.call(finder, pool[pi], recorder, k)
            ok = True
        except Exception:
            traceback.print_exc(file=err)
            result, ok = None, False
        c1 = time.perf_counter()
        if args.trace:
            recorder.span("call", c0, c1)
        calls.append({"index": k, "pool": pi, "start": c0, "end": c1,
                      "bp": sizes[pi], "contigs": len(pool[pi]), "ok": ok})
        if pi not in kept:
            kept[pi] = (k, 1 + sent, result)
        sent += len(pool[pi])
        k += 1
        if k == traced:
            # the stretch ends with its last call: the profiler stops
            # here, and its trace is written once the window has closed
            recorder.profiling = False
            prof.stop()
        elif k < traced:
            prof.step()
    trace_events = None
    if prof is not None:
        if recorder.profiling:          # the window ended first
            recorder.profiling = False
            prof.stop()
        trace_events = tracing.export(prof, os.path.join(
            ROOT, "build", "genebench", "trace", f"{cell['name']}.json"))
    device_info = dev.info()
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: "
                       f"{', '.join(found)}")

    counters = {f"launches.{k}": v for k, v in dp_cuda.LAUNCHES.items()}
    trace = None
    if trace_events is not None:
        stretch = calls[:traced]
        trace = tracing.Trace(trace_events, [c["start"] for c in stretch],
                              recorder.spans, sum(c["bp"] for c in stretch))
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
    run_ = Run(cell["name"], setup_s, calls, recorder, counters, trace)
    metrics = {}
    for m in metrics_for(cell["name"], bench, args.trace):
        value = load_metric(m["name"],
                            os.path.join(here, "metrics")).read(run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_scores = recorder.scores()

    # the program's state goes before the reference runs
    mode.close(finder)
    del finder
    gc.collect()
    if dev.cuda:
        dev.torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, facts = _compare(config, mode, pool, kept, calls,
                              device_scores)
    from genebench.check import verdict

    checks = verdict(numbers, limits["limits"])
    failed = sum(1 for c in calls if not c["ok"])
    correct = (failed == 0 and facts["contigs"] > 0
               and all(w for *_x, w in checks))
    print(f"compared the genes of {facts['entries']} pool entries "
          f"({facts['contigs']} contigs) and {facts['pairs']} (contig, bin) "
          f"scores of {facts['calls']} calls; "
          f"{facts['contigs_without_device_score']} contigs of those calls "
          f"had no device score (exact route); reference "
          f"{time.perf_counter() - t_ref:.1f} s", file=err)
    for g, call, ci, b, d, x, top in facts["widest_gaps"]:
        print(f"  gap {g:.4g}: call {call} contig {ci} bin {b}: device "
              f"{d!r}, exact {x!r} (contig's best {top!r})", file=err)
    found = forbidden_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package are loaded: "
                       f"{', '.join(found)}")
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {name: {"value": _num(v), "limit": lim}
                        for name, v, lim, _w in checks}
    for name, v, lim, w in checks:
        print(f"check {name}: {v} (limit {lim}){'' if w else ' FAILED'}",
              file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0, result


def _num(v):
    return v if math.isfinite(v) else None


def _compare(config, mode, pool, kept, calls, device_scores):
    """The reference over every pool entry the window ran, in worker
    processes: the numbers `check.compare` gives, and what it compared."""
    from genebench.check import compare
    from genebench.reference import engine

    entries = sorted(kept, key=lambda pi: kept[pi][0])
    got = {pi: mode.texts(kept[pi][2], pool[pi]) for pi in entries}
    with engine.executor() as ex:
        ref = mode.reference(ex, config, [(pool[pi], kept[pi][1])
                                          for pi in entries])
    expected = dict(zip(entries, ref))
    entry_of = {c["index"]: c["pool"] for c in calls}
    return compare(expected, got, device_scores, entry_of)


def main(argv=None, t0=None):
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache = os.path.join(ROOT, "build", "genebench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    try:
        code, _ = run(args, t0=t0)
    except RunError as e:
        print(f"genebench: {e}", file=sys.stderr)
        return 1
    return code
