"""Spans of the port's own work: where a call's time goes, layer by layer.

A span is one stretch of work on one thread: its `name`, the span that
caused it (`parent`), the `find_genes_batch` call it belongs to (`call`,
the id of that call's span), the thread, its start and end on
`time.perf_counter_ns()`, and a few counts (`attrs`).  Spans stay in a
bounded buffer in memory; `spans()` reads them and `clear()` empties it.

Tracing is on after `enable()`, or while a `torch.profiler` records (its
active steps; not its warm-up step), so a profiled stretch carries the
program's spans without a switch of its own.  When it is off a span site
costs one flag read and records nothing, and `carry` returns the
callable it was given.  Set-up spans (`setup`: the kernels' and the C
engine's build or load, the runner's construction) happen once a process
and are recorded whether or not tracing is on.

Work handed to another thread keeps its cause: `carry(fn, name)` wraps a
callable at submit time, and the callable opens `name` under the
submitting span on whatever thread runs it, with `queued_s`, the time
from submit to start, among its attributes.

The spans' clock is the host's monotonic one; `clock_anchor()` ties it
to the wall clock that `torch.profiler` traces use, and
`write_chrome_trace` writes the spans as a Chrome trace on that clock,
alone or merged into a profiler's trace.
"""

import collections
import contextlib
import itertools
import json
import os
import threading
import time

from torch.autograd import profiler as _profiler

CALL = "call"
MAX_SPANS = 1 << 16

_on = False
_lock = threading.Lock()
_buffer = collections.deque(maxlen=MAX_SPANS)
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


def enable():
    """Record spans from now on, profiler or not."""
    global _on
    _on = True


def disable():
    """Record spans only while a profiler records."""
    global _on
    _on = False


def enabled():
    """True after `enable()` or while a `torch.profiler` records."""
    return _on or _profiler._is_profiler_enabled


class Span:
    """One recorded stretch of work; a context manager that records it on
    exit.  `end` is None while it is open."""

    __slots__ = ("id", "parent", "call", "name", "thread", "start", "end",
                 "attrs")

    def __init__(self, name, parent=None, attrs=None):
        self.id = next(_ids)
        self.name = name
        self.parent = parent.id if parent is not None else None
        self.call = (self.id if name == CALL
                     else parent.call if parent is not None else None)
        self.thread = None
        self.start = self.end = None
        self.attrs = dict(attrs) if attrs else {}

    def __bool__(self):
        return True

    def set(self, **attrs):
        self.attrs.update(attrs)

    @property
    def seconds(self):
        return (self.end - self.start) * 1e-9

    def __enter__(self):
        _stack().append(self)
        self.thread = threading.get_native_id()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _record(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"call={self.call}, {self.attrs})")


class _Off:
    """What a span site gets when tracing is off: nothing is recorded."""

    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


OFF = _Off()


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _record(sp):
    global _dropped
    with _lock:
        if len(_buffer) == MAX_SPANS:
            _dropped += 1
        _buffer.append(sp)


def span(name, **attrs):
    """A span under the thread's innermost open span, or `OFF` when
    tracing is off (falsy, so a site can skip counting for it)."""
    if not (_on or _profiler._is_profiler_enabled):
        return OFF
    stack = _stack()
    return Span(name, stack[-1] if stack else None, attrs)


def current(*names):
    """The thread's innermost open span if it is named one of `names`,
    else `OFF`: where a span's attributes are known only inside the
    work."""
    if not (_on or _profiler._is_profiler_enabled):
        return OFF
    stack = _stack()
    return stack[-1] if stack and stack[-1].name in names else OFF


def carry(fn, name, **attrs):
    """`fn` itself when tracing is off; else a callable that runs `fn`
    inside a span `name` whose parent is the span open here, now, on the
    submitting thread, with `queued_s` (submit to start) among its
    attributes."""
    if not (_on or _profiler._is_profiler_enabled):
        return fn
    stack = _stack()
    parent = stack[-1] if stack else None
    submitted = time.perf_counter_ns()

    def run(*args, **kwargs):
        with Span(name, parent, attrs) as sp:
            sp.attrs["queued_s"] = (sp.start - submitted) * 1e-9
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def setup(name, **attrs):
    """A set-up span, recorded whether or not tracing is on."""
    stack = _stack()
    with Span(name, stack[-1] if stack else None, attrs) as sp:
        yield sp


def spans():
    """The recorded spans, oldest first."""
    with _lock:
        return list(_buffer)


def dropped():
    """Spans the bounded buffer let go since the last `clear()`."""
    return _dropped


def clear():
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0


def clock_anchor():
    """One (perf_counter_ns, time_ns) pair, read together (the closest of
    a few tries).  A span time t is `t - perf + wall` ns on the wall
    clock, and `(t - perf + wall - baseTimeNanoseconds) / 1000` µs on a
    `torch.profiler` Chrome trace's clock."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        w = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, (p0 + p1) // 2, w)
    return best[1], best[2]


def write_chrome_trace(path, profiler_trace=None):
    """Write the spans as Chrome-trace complete ("X") events, one track a
    thread, for Perfetto or chrome://tracing.  With `profiler_trace`, the
    path of a `torch.profiler` Chrome trace, its events are written too,
    and the spans are put on its clock (`baseTimeNanoseconds`); else on
    the wall clock, in µs since the epoch."""
    perf, wall = clock_anchor()
    events, base, extra = [], 0, {}
    if profiler_trace is not None:
        with open(profiler_trace) as f:
            prof = json.load(f)
        events = list(prof.get("traceEvents", []))
        base = prof.get("baseTimeNanoseconds", 0)
        extra = {k: v for k, v in prof.items() if k != "traceEvents"}
    pid = os.getpid()
    for sp in spans():
        events.append({
            "ph": "X", "cat": "pyrodigal_tpu_torch", "name": sp.name,
            "pid": pid, "tid": sp.thread,
            "ts": (sp.start - perf + wall - base) / 1000,
            "dur": (sp.end - sp.start) / 1000,
            "args": {"id": sp.id, "parent": sp.parent, "call": sp.call,
                     **sp.attrs}})
    with open(path, "w") as f:
        json.dump({**extra, "traceEvents": events}, f)
