"""`prog.exact_route.bin_concurrency` on made-up program spans (those of
`test_genebench_program_spans.py`, with the exact route's bins added),
against a count by hand: bins run beside their contig's span, bins swept
inside it, a stretch without the exact route, and no trace."""

import pytest

from genebench import progspans
from genebench.tests.test_genebench_program_spans import (  # noqa: F401
    SPANS, fake_run, metric, program, span)

NAME = "prog.exact_route.bin_concurrency"


def _with(monkeypatch, spans):
    monkeypatch.setattr(progspans, "program_spans", lambda: list(spans))


def test_bins_beside_their_span_by_hand(program, monkeypatch):
    """The stretch's one exact route is 2,200..6,200 µs on thread 2; its
    three bins on threads 6-8 sum to 1,000 + 2,000 + 2,700 µs.  A bin of
    the third, untraced call is left out."""
    bins = [span(20, "exact_route.bin", 2300, 3300, 3, 1, thread=6, bin=3),
            span(21, "exact_route.bin", 2300, 4300, 3, 1, thread=7, bin=4),
            span(22, "exact_route.bin", 3400, 6100, 3, 1, thread=8, bin=5),
            span(23, "exact_route.bin", 21200, 28000, 13, 12, thread=6)]
    _with(monkeypatch, SPANS + bins)
    assert metric(NAME).read(fake_run()) == pytest.approx(5700 / 4000)


def test_bins_swept_inside_their_span_read_under_one(program, monkeypatch):
    bins = [span(20 + k, "exact_route.bin", 2210 + 1000 * k,
                 3190 + 1000 * k, 3, 1, thread=2, bin=k) for k in range(4)]
    _with(monkeypatch, SPANS + bins)
    assert metric(NAME).read(fake_run()) == pytest.approx(4 * 980 / 4000)


def test_no_exact_route_in_the_stretch_reads_zero(program, monkeypatch):
    _with(monkeypatch, [s for s in SPANS if s.name != "exact_route"])
    assert metric(NAME).read(fake_run()) == 0.0
    assert metric(NAME).read(fake_run(trace=False)) is None
    monkeypatch.setattr(progspans, "program_spans", lambda: None)
    assert metric(NAME).read(fake_run()) is None
