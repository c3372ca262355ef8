"""The `prog.*` readers (`genebench/progspans.py`) on made-up program
spans and a made-up trace file, against counts by hand: the per-Mbp
times, the launches' fill, the exact route's share of bp, the device's
idle time split by the span open in it (weighted by time), nothing to
read without a trace or without the program's tracing, and a clock out
of line raising."""

import json
import types

import pytest

from genebench import devtrace, harness, progspans

MS = 1_000_000              # ns
US = 1_000


def metric(name):
    return harness.load_metric(name)


def span(id_, name, a_us, b_us, parent=None, call=None, thread=1,
         **attrs):
    """A made-up program span, times in µs (the anchor below puts the
    program's clock and the trace's on the same µs)."""
    return types.SimpleNamespace(id=id_, name=name, parent=parent,
                                 call=call, thread=thread,
                                 start=int(a_us * US), end=int(b_us * US),
                                 attrs=attrs)


# two traced calls (annotations 1,000..11,000 and 12,000..20,000 µs) and
# a third, untraced one whose spans the readers leave out
SPANS = [
    span(90, "setup.native", -900, -400),
    span(91, "setup.kernels", -400, -200),
    span(92, "setup.runner", -200, -100),
    span(1, "call", 1000.5, 10999.5, call=1, bp=1_000_000, contigs=1),
    span(2, "prep", 1100, 2100, 1, 1, thread=2, bp=1_000_000, route="c",
         route_reason="window"),
    span(3, "exact_route", 2200, 6200, 1, 1, thread=2, bp=1_000_000),
    span(11, "launch", 6300, 6500, 1, 1, thread=5, node_rows=100,
         node_rows_bucket=1000),
    span(4, "call", 12000.5, 19999.5, call=4, bp=3_000_000, contigs=1),
    span(5, "prep", 12100, 12600, 4, 4, thread=2, bp=3_000_000,
         route="mega", route_reason=None),
    span(7, "launch", 13000, 17000, 4, 4, thread=5, node_rows=300,
         node_rows_bucket=1000),
    span(8, "launch.pack", 13000, 13500, 7, 4, thread=5),
    span(9, "launch.wait", 14000, 17000, 7, 4, thread=5),
    span(10, "finish", 16000, 18000, 4, 4, thread=2),
    span(12, "call", 21000.5, 29000, call=12, bp=5_000_000, contigs=1),
    span(13, "prep", 21100, 23000, 12, 12, thread=2, bp=5_000_000,
         route="c"),
]
MARKS = [(1000, 11000), (12000, 20000)]
KERNELS = [(3000, 4000), (14500, 16500)]
BASE = 7 * 10**15           # baseTimeNanoseconds
STRETCH_BP = 4_000_000


def trace_file(path, marks=MARKS, kernels=KERNELS):
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": b - a}
          for a, b in kernels]
    ev += [{"ph": "X", "cat": "user_annotation", "name": devtrace.CALL,
            "ts": a, "dur": b - a} for a, b in marks]
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": BASE, "traceEvents": ev}, f)


def fake_run(trace=True):
    calls = [{"start": a * 1e-6, "end": b * 1e-6, "bp": bp, "ok": True}
             for (a, b), bp in zip(MARKS + [(21000, 30000)],
                                   (1_000_000, 3_000_000, 5_000_000))]
    rec = types.SimpleNamespace(spans=[], counts={}, dp_launches=[])
    t = types.SimpleNamespace(calls=[(a * 1e-6, b * 1e-6) for a, b in MARKS],
                              bp=STRETCH_BP) if trace else None
    return harness.Run("cell", 12.5, calls, rec, {}, t)


@pytest.fixture
def program(monkeypatch, tmp_path):
    """The made-up spans as the program's, the trace file where the
    harness writes it, and a clock anchor that maps the program's ns
    onto the trace's µs one for one (`offset_ns` shifts it)."""
    from pyrodigal_tpu_torch import tracing

    monkeypatch.setattr(progspans, "TRACE_DIR", str(tmp_path))
    monkeypatch.setattr(progspans, "program_spans", lambda: list(SPANS))
    trace_file(tmp_path / "cell.json")
    state = {"offset_ns": 0}
    monkeypatch.setattr(tracing, "clock_anchor",
                        lambda: (0, BASE + state["offset_ns"]))
    return state


def test_times_per_mbp_fill_and_exact_share_by_hand(program):
    run = fake_run()
    got = {name: metric(name).read(run) for name in (
        "prog.prep.thread_s_per_mbp", "prog.launch.pack_s_per_mbp",
        "prog.launch.device_wait_s_per_mbp", "prog.launch.node_fill_pct",
        "prog.finish.thread_s_per_mbp", "prog.exact_route.thread_s_per_mbp",
        "prog.route.exact_bp_pct", "prog.setup.program_s")}
    # the stretch's 4 Mbp; the third call's 5 Mbp and its prep left out
    assert got == pytest.approx({
        "prog.prep.thread_s_per_mbp": 1.5e-3 / 4,
        "prog.launch.pack_s_per_mbp": 0.5e-3 / 4,
        "prog.launch.device_wait_s_per_mbp": 3e-3 / 4,
        "prog.launch.node_fill_pct": 100 * 400 / 2000,
        "prog.finish.thread_s_per_mbp": 2e-3 / 4,
        "prog.exact_route.thread_s_per_mbp": 4e-3 / 4,
        "prog.route.exact_bp_pct": 25.0,
        "prog.setup.program_s": 0.8e-3})


def test_idle_time_split_by_the_open_span_weighted_by_time(program):
    """Window 1,000..20,000 µs, kernels 3,000..4,000 and 14,500..16,500:
    16,000 µs idle, split by each thread's innermost span; 16,500..17,000
    holds a launch's wait and a finishing at once, 250 µs each."""
    run = fake_run()
    idle = progspans.attribute_idle(run)
    by_hand = {progspans.OUTSIDE: 0.5 + 1001 + 0.5,
               progspans.CALL_ONLY: 99.5 + 100 + 100 + 4499.5 + 99.5 + 400
               + 1999.5,
               "prep": 1500, "exact_route": 3000, "launch": 700,
               "launch.pack": 500, "launch.wait": 750, "finish": 1250}
    assert idle == pytest.approx({k: v * 1e-6 for k, v in by_hand.items()})
    assert sum(idle.values()) == pytest.approx(16000e-6)
    assert metric("prog.device.idle_unattributed_pct").read(run) == \
        pytest.approx(100 * 8300 / 16000)
    # not by the midpoint: the gap 4,000..14,500 is mostly one call's
    # own time, but its middle (9,250) falls in no inner span
    assert idle["exact_route"] > 0 and idle["launch.wait"] > 0


def test_nothing_to_read_without_a_trace_or_without_tracing(program,
                                                            monkeypatch):
    names = [m["name"] for m in harness.load_json(
        harness.ROOT, "BENCHMARK.json")["per_layer"]
        if m["name"].startswith("prog.")]
    assert len(names) == 9
    for name in names:
        if name != "prog.setup.program_s":
            assert metric(name).read(fake_run(trace=False)) is None, name
    monkeypatch.setattr(progspans, "program_spans", lambda: None)
    for name in names:
        assert metric(name).read(fake_run()) is None, name


def test_a_call_5_ms_off_its_annotation_raises(program):
    program["offset_ns"] = 5 * MS
    with pytest.raises(RuntimeError, match="clocks do not line up"):
        metric("prog.device.idle_unattributed_pct").read(fake_run())
    program["offset_ns"] = int(0.5 * MS)        # within 1 ms: a number
    assert metric("prog.device.idle_unattributed_pct").read(fake_run()) \
        is not None


def test_the_program_bp_must_be_the_stretchs(program, monkeypatch):
    monkeypatch.setattr(progspans, "program_spans",
                        lambda: [s for s in SPANS if s.id != 4])
    with pytest.raises(RuntimeError, match="bp"):
        metric("prog.prep.thread_s_per_mbp").read(fake_run())
