"""`prog.finish.native_pct` on made-up program spans (those of
`test_genebench_program_spans.py`, with the winner's re-runs added),
against a count by hand: the native share of the stretch's re-runs, a
re-run of the untraced call left out, nothing to read where no span
carries `native_s` or none re-runs a bin, and nothing without a trace or
without the program's tracing."""

import pytest

from genebench import progspans
from genebench.tests.test_genebench_program_spans import (  # noqa: F401
    SPANS, fake_run, metric, program, span)

NAME = "prog.finish.native_pct"
# two re-runs under the second traced call's `finish` (16,000..18,000 µs)
# and one of the untraced third call
RERUNS = [
    span(30, "finish.rerun", 16000, 17000, 10, 4, thread=2, bin=3,
         native_s=0.0008),
    span(31, "finish.rerun", 17000, 17500, 10, 4, thread=2, bin=5,
         native_s=0.0004),
    span(32, "finish.rerun", 24000, 26000, 12, 12, thread=2, bin=7,
         native_s=0.0001)]


def _with(monkeypatch, spans):
    monkeypatch.setattr(progspans, "program_spans", lambda: list(spans))


def test_native_share_of_the_stretchs_reruns_by_hand(program, monkeypatch):
    _with(monkeypatch, SPANS + RERUNS)
    assert metric(NAME).read(fake_run()) == pytest.approx(
        100 * (800 + 400) / (1000 + 500))


def test_reruns_without_native_seconds_read_nothing(program, monkeypatch):
    """A program whose re-runs carry no `native_s`, and a stretch with no
    re-run at all."""
    bare = [span(s.id, s.name, s.start / 1000, s.end / 1000, s.parent,
                 s.call, s.thread, bin=s.attrs["bin"]) for s in RERUNS]
    _with(monkeypatch, SPANS + bare)
    assert metric(NAME).read(fake_run()) is None
    _with(monkeypatch, SPANS)
    assert metric(NAME).read(fake_run()) is None


def test_nothing_to_read_without_a_trace_or_without_tracing(program,
                                                            monkeypatch):
    _with(monkeypatch, SPANS + RERUNS)
    assert metric(NAME).read(fake_run(trace=False)) is None
    monkeypatch.setattr(progspans, "program_spans", lambda: None)
    assert metric(NAME).read(fake_run()) is None
