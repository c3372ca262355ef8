"""The device trace of a run's profiled stretch: `torch.profiler` over a
few whole calls of the window, written as a Chrome trace and read back.

Device activity is every kernel, copy and fill on the card; the window
is the span of the stretch's calls, marked on the main thread by a
`genebench.call` annotation.  The host spans the benchmark records
(`instrument.Recorder`) are on the host clock; they are moved onto the
trace's clock by the mean offset between each traced call's annotation
and its host start, and name what the host was doing in each idle gap.
"""

import json
import os

CALL = "genebench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the label of an idle gap: the first kind of host span open at its middle
GAP_ORDER = ("sweep", "prep", "fallback", "finish")


def start(active, cuda=True):
    """A started profiler whose first step is a warm-up and whose next
    `active` steps are traced (`prof.step()` after each)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   schedule=schedule(wait=0, warmup=1, active=active,
                                     repeat=1))
    prof.start()
    return prof


def export(prof, path):
    """The stopped profiler's trace, written to `path` and read back."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


def merge(intervals):
    """The union of [(start, end)] as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class Trace:
    """What the metrics read of one stretch: `kernels` [(name, start,
    end)], `device` (every device activity), `window` (start, end), all
    in seconds on the trace's clock; `busy_s`, `window_s`, `gaps`."""

    def __init__(self, events, host_starts, spans, bp):
        ev = [e for e in events.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
        self.kernels = [(e["name"], e["ts"] * 1e-6,
                         (e["ts"] + e["dur"]) * 1e-6)
                        for e in ev if e.get("cat") == "kernel"]
        device = [(e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
                  for e in ev if e.get("cat") in DEVICE_CATS]
        calls = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
                       for e in ev if e.get("name") == CALL
                       and e.get("cat") == "user_annotation")
        self.bp = bp
        self.calls = calls
        if not calls:
            self.window = None
            self.busy_s = self.window_s = 0.0
            self.gaps = []
            return
        self.window = (calls[0][0], calls[-1][1])
        w0, w1 = self.window
        self.window_s = w1 - w0
        busy = merge((max(a, w0), min(b, w1)) for a, b in device
                     if b > w0 and a < w1)
        self.busy_s = sum(b - a for a, b in busy)
        # host clock -> trace clock
        n = min(len(calls), len(host_starts))
        offset = (sum(calls[i][0] - host_starts[i] for i in range(n)) / n
                  if n else 0.0)
        spans = [(name, a + offset, b + offset) for name, a, b, _t in spans]
        self.gaps = []
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                self.gaps.append((self._label((a + b) / 2, spans), b - a))

    def _label(self, t, spans):
        open_ = {name for name, a, b in spans if a <= t < b}
        for name in GAP_ORDER:
            if name in open_:
                return name
        if any(a <= t < b for a, b in self.calls):
            return "call, other host work"
        return "between calls"

    def kernel_seconds(self, *patterns):
        """Device seconds of the kernels whose name holds any pattern."""
        return sum(b - a for name, a, b in self.kernels
                   if any(p in name for p in patterns))

    def kernel_count(self, *patterns):
        return sum(1 for name, _a, _b in self.kernels
                   if any(p in name for p in patterns))

    def breakdown(self, top=10):
        by_name = {}
        for name, a, b in self.kernels:
            key = name.replace("(anonymous namespace)::", "") \
                .split("(")[0][:120]
            by_name[key] = by_name.get(key, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}
