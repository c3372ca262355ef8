"""The port's own spans (`pyrodigal_tpu_torch.tracing`) over a traced
run's profiled stretch, as the `prog.*` metrics read them.

The stretch is the window's first `len(run.trace.calls)` calls, the ones
the profiler traced.  The program's `call` spans that lie inside those
calls on the host clock are kept, with every span of theirs (a span
carries its call's id); their bp must equal the stretch's.  Spans run
from the same process, on `time.perf_counter_ns()`; `tracing.clock_anchor`
puts them on the trace's clock for the device's idle time, where each
program call must lie inside its `genebench.call` annotation to within
`CLOCK_SLACK_US`, or the reader raises: a clock out of line never gives
a number.

A program without `tracing` (an older checkout) gives None everywhere.
"""

import json
import os

from genebench import devtrace
from genebench.harness import ROOT

# where the harness writes the stretch's trace, `<cell>.json`
TRACE_DIR = os.path.join(ROOT, "build", "genebench", "trace")
CLOCK_SLACK_US = 1000.0
CALL = "call"
# what idle time is called where only a call span, or none, is open
CALL_ONLY = "call, no inner span"
OUTSIDE = "outside the calls"


def tracing():
    """The port's tracing module, or None in a program without one."""
    try:
        from pyrodigal_tpu_torch import tracing as t
    except ImportError:
        return None
    return t


def program_spans():
    """Every span the program recorded, or None without `tracing`."""
    t = tracing()
    if t is None:
        return None
    if t.dropped():
        raise RuntimeError(f"the program's span buffer dropped "
                           f"{t.dropped()} spans")
    return t.spans()


class Stretch:
    """`calls`: the program's call spans of the stretch, in order;
    `spans`: theirs, calls included; `bp`: the stretch's bp."""

    def __init__(self, calls, spans, bp):
        self.calls = calls
        self.spans = spans
        self.bp = bp

    def named(self, name):
        return [s for s in self.spans if s.name == name]

    def seconds(self, name):
        return sum((s.end - s.start) * 1e-9 for s in self.named(name))

    def per_mbp(self, name):
        return self.seconds(name) / (self.bp / 1e6)


def stretch(run, spans=None):
    """The program's spans of the run's profiled stretch, or None when the
    run has no trace or the program recorded no call there."""
    if run.trace is None or not run.trace.calls:
        return None
    spans = program_spans() if spans is None else spans
    if spans is None:
        return None
    host = run.calls[:len(run.trace.calls)]
    calls = sorted((s for s in spans if s.name == CALL and any(
        c["start"] <= s.start * 1e-9 and s.end * 1e-9 <= c["end"]
        for c in host)), key=lambda s: s.start)
    if not calls:
        return None
    bp = sum(s.attrs["bp"] for s in calls)
    if bp != run.trace.bp:
        raise RuntimeError(f"the program's calls in the stretch hold {bp} "
                           f"bp, the stretch {run.trace.bp}")
    ids = {s.id for s in calls}
    return Stretch(calls, [s for s in spans if s.call in ids], bp)


def _events(run):
    with open(os.path.join(TRACE_DIR, f"{run.cell}.json")) as f:
        return json.load(f)


def _on_trace_clock(st, events, anchor):
    """(device intervals, call annotations, [(span, a, b)]) in µs on the
    trace's clock; raises when a program call is not inside its
    annotation to within CLOCK_SLACK_US."""
    base = events.get("baseTimeNanoseconds", 0)
    ev = [e for e in events.get("traceEvents", [])
          if e.get("ph") == "X" and "dur" in e]
    device = devtrace.merge((e["ts"], e["ts"] + e["dur"]) for e in ev
                            if e.get("cat") in devtrace.DEVICE_CATS)
    marks = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("name") == devtrace.CALL
                   and e.get("cat") == "user_annotation")
    perf, wall = anchor

    def us(t):
        return (t - perf + wall - base) / 1000.0

    spans = [(s, us(s.start), us(s.end)) for s in st.spans]
    calls = [(a, b) for s, a, b in spans if s.name == CALL]
    if len(calls) != len(marks):
        raise RuntimeError(f"{len(calls)} program calls in the stretch, "
                           f"{len(marks)} {devtrace.CALL} annotations")
    for k, ((a, b), (ma, mb)) in enumerate(zip(calls, marks)):
        if a < ma - CLOCK_SLACK_US or b > mb + CLOCK_SLACK_US:
            raise RuntimeError(
                f"program call {k} ({a:.1f}, {b:.1f}) µs is not inside its "
                f"annotation ({ma:.1f}, {mb:.1f}) µs to within "
                f"{CLOCK_SLACK_US:.0f} µs: the clocks do not line up")
    return device, marks, spans


def attribute_idle(run, st=None, events=None, anchor=None):
    """The stretch's device idle time, in seconds, split by the program
    span open in it: at each moment, each thread's innermost open span
    (other than `call`) takes an equal share, weighted by time; where
    none is open, CALL_ONLY inside a call and OUTSIDE between them.  None
    without a trace or program spans."""
    st = stretch(run) if st is None else st
    if st is None:
        return None
    if events is None:
        events = _events(run)
    if anchor is None:
        anchor = tracing().clock_anchor()
    device, marks, spans = _on_trace_clock(st, events, anchor)
    w0, w1 = marks[0][0], marks[-1][1]
    edges = [w0] + [x for ab in device for x in ab] + [w1]
    idle = [(max(a, w0), min(b, w1)) for a, b in zip(edges[0::2],
                                                     edges[1::2])]
    idle = [(a, b) for a, b in idle if b > a]
    # a sweep over the boundaries of idle intervals and spans
    points = []
    for k, (a, b) in enumerate(idle):
        points += [(a, 1, "idle", k), (b, 0, "idle", k)]
    for k, (s, a, b) in enumerate(spans):
        if b > a:
            points += [(a, 1, "span", k), (b, 0, "span", k)]
    points.sort()
    out, open_, idle_open, last = {}, set(), False, None
    for t, opening, kind, k in points:
        if idle_open and last is not None and t > last:
            _share(out, t - last, [spans[j] for j in open_])
        last = t
        if kind == "idle":
            idle_open = bool(opening)
        elif opening:
            open_.add(k)
        else:
            open_.discard(k)
    return {name: us * 1e-6 for name, us in out.items()}


def _share(out, dt, open_spans):
    inner = {}
    for s, a, _b in open_spans:
        if s.name != CALL and (s.thread not in inner
                               or a >= inner[s.thread][1]):
            inner[s.thread] = (s.name, a)
    if not inner:
        name = CALL_ONLY if any(s.name == CALL for s, _a, _b in open_spans) \
            else OUTSIDE
        out[name] = out.get(name, 0.0) + dt
        return
    for name, _a in inner.values():
        out[name] = out.get(name, 0.0) + dt / len(inner)
