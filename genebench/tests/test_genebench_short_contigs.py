"""The `meta.short_contigs` cell's own parts, on made-up inputs and on
the CPU (no card): its mix (512 contigs a call, each at most 49,152 bp,
the std route for all but the few whose nodes pass the std node bucket)
and its four readers against counts by hand, each None where there is
nothing to read."""

import collections
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from genebench import devtrace, generate, harness, instrument, peaks, \
    progspans

from .test_genebench_traffic import MIXES

SEED = 3_141_592_653
MS = 1_000_000              # ns


def metric(name):
    return harness.load_metric(name)


def test_the_mix_is_the_assembly_stream_of_the_traffic_tests():
    """The traffic tests' assembly stream as they hold it, with one
    traced and one warm call."""
    mix = generate.load_mix("short_contigs")
    assert {k: v for k, v in mix.items()
            if k not in ("about", "trace_calls", "warm_calls")} \
        == MIXES["short_contigs"]
    assert mix["trace_calls"] == mix["warm_calls"] == 1


def test_512_contigs_a_call_on_the_std_route():
    from pyrodigal_tpu_torch.metagenomic import METAGENOMIC_BINS
    from pyrodigal_tpu_torch.ops import meta_cuda
    from pyrodigal_tpu_torch.sequence import Sequence

    pool = generate.make(SEED, generate.load_mix("short_contigs"))
    assert [len(call) for call in pool] == [512] * 8
    seqs = [s for call in pool for _n, s in call]
    assert 500 <= min(map(len, seqs)) and max(map(len, seqs)) <= 49_152
    runner = meta_cuda.CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    try:
        with ThreadPoolExecutor(4) as ex:
            preps = list(ex.map(
                lambda s: runner._prepare_contig(Sequence(s)), seqs))
    finally:
        runner.close()
    routes = collections.Counter(p[3] for p in preps)
    # a contig near 49 kb may hold more nodes than the std bucket: the
    # mega route takes it, as the JAX package's runner does
    for (_c, geoms, _n, route), s in zip(preps, seqs):
        if route != "std":
            assert route == "mega" and len(s) > 30_000
            assert max(g["nn"] for g in geoms.values()) \
                > meta_cuda.NODE_BUCKET
    assert routes["std"] >= 0.995 * len(seqs), routes


# -- the readers -------------------------------------------------------------

def fake_run(trace=None, dp=(), calls=None):
    rec = types.SimpleNamespace(spans=[], counts={}, dp_launches=list(dp))
    calls = calls or [{"start": 0.0, "end": 1.0, "bp": 1, "ok": True}]
    return harness.Run("cell", 12.5, calls, rec, {}, trace)


def _std_args(kind4, ndx, win_lo):
    BT, n = kind4.shape
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)      # noqa: E731
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32)    # noqa: E731
    t = lambda a: torch.tensor(a, dtype=torch.int32)        # noqa: E731
    return [t(ndx), i32(BT, n), t(kind4), t(win_lo), f32(BT, n),
            f32(BT, n), f32(BT, n), f32(3, BT, n), f32(3, BT, n),
            i32(3, BT, n), i32(3, BT, n), f32(BT)]


def test_std_dp_roofline_by_hand():
    # a fwd stop, a fwd start, a rev start, a rev stop and a pad; row 1
    # reads no source (win_lo = i)
    kind4 = np.array([[1, 0, 2, 3, 4]] * 2)
    ndx = np.array([[0, 3, 7, 9, 0]] * 2)
    win_lo = np.array([[0] * 5, list(range(5))])
    m = metric("dp_std_roofline")
    # node 1: the fwd stop; node 2: the fwd stop (no rev stop of its
    # frame); node 3: the fwd stop and the rev start
    assert m.lanes(kind4, ndx, win_lo) == 1 + 1 + 2
    # the window stops SPAN nodes back
    for gap, want in ((m.SPAN - 1, 1), (m.SPAN, 0)):
        row = np.array([[1] + [4] * gap + [0]])
        zero = np.zeros_like(row)
        assert m.lanes(row, zero, zero) == want, gap
    BT, n = kind4.shape
    ops = [instrument.operand(a) for a in _std_args(kind4, ndx, win_lo)]
    by_hand = (7 * BT * n * 4 + 4 * 3 * BT * n * 4 + BT * 4) \
        + 4 * BT * n * 4
    assert by_hand / peaks.HBM_BYTES_PER_S > 4 * 8 / peaks.F32_FLOPS
    assert m.launch_bound(ops) == pytest.approx(
        by_hand / peaks.HBM_BYTES_PER_S)
    t = types.SimpleNamespace(kernel_count=lambda *p: 2,
                              kernel_seconds=lambda *p: 1e-3)
    run = fake_run(trace=t, dp=[("dp_std", ops), ("dp_std", ops),
                                ("dp_mega", None)])
    assert m.read(run) == pytest.approx(
        100 * 2 * by_hand / peaks.HBM_BYTES_PER_S / 1e-3)
    with pytest.raises(RuntimeError, match="launches recorded"):
        m.read(fake_run(trace=t, dp=[("dp_std", ops)]))
    assert m.read(fake_run()) is None                   # no trace
    assert m.read(fake_run(trace=t)) is None            # no std launch


def _events(kernels, calls):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a}
          for n, a, b in kernels]
    ev += [{"ph": "X", "cat": "user_annotation", "name": devtrace.CALL,
            "ts": a, "dur": b - a} for a, b in calls]
    return {"traceEvents": ev}


def test_std_kernel_ms_per_mbp_by_hand(monkeypatch):
    """The four std-only kernels by their whole names, and the star
    kernels whose midpoint lies in a std `launch` span once the program's
    spans are on the trace's clock (its call annotation starts 99 ms
    after the program's call span on the host clock); never the mega
    route's kernels, nor a star kernel of a mega launch."""
    spans = [span(1, "call", 1, 11, call=1, bp=2_000_000, contigs=512),
             span(2, "launch", 5, 8, 1, 1, route="std", contigs=512),
             span(3, "launch", 8.5, 10, 1, 1, route="mega")]
    kernels = [("phase_cumsum_reduce_kernel(float const*, double*)",
                104_000, 104_100),
               ("(anonymous namespace)::phase_cumsum_kernel(float const*)",
                104_100, 104_300),
               ("star_kernel(int const*, int const*)", 104_300, 104_400),
               ("seg_scan_rows_kernel", 104_400, 104_450),
               ("void dp_std_kernel<8>(int const*)", 104_500, 105_500),
               ("star_kernel(int const*, int const*)", 107_600, 107_700),
               ("seg_scan_chain_kernel", 107_700, 107_800),
               ("dc_chain_reduce_kernel", 107_800, 107_900),
               ("dc_chain_kernel", 107_900, 108_000),
               ("dp_mega_kernel", 108_000, 108_900),
               ("void at::native::elementwise_kernel<128, 2>(int)",
                109_000, 110_000)]
    calls = [{"start": 0.5e-3, "end": 11.5e-3, "bp": 2_000_000,
              "ok": True}]
    monkeypatch.setattr(progspans, "program_spans", lambda: list(spans))
    m = metric("device.std_kernel_ms_per_mbp")
    assert m.base_name(kernels[1][0]) == "phase_cumsum_kernel"
    assert m.base_name(kernels[4][0]) == "dp_std_kernel"
    assert m.base_name(kernels[-1][0]) == "elementwise_kernel"

    def run(ks):
        t = devtrace.Trace(_events(ks, [(100_000, 111_000)]), [0.0], [],
                           bp=2_000_000)
        return fake_run(trace=t, calls=calls)
    assert m.read(run(kernels)) == pytest.approx(1e3 * 1450e-6 / 2)
    assert m.read(fake_run()) is None                   # no trace
    assert m.read(run(kernels[5:])) is None             # the mega route's
    monkeypatch.setattr(progspans, "program_spans", lambda: None)
    assert m.read(run(kernels)) is None                 # no tracing


def span(id_, name, a_ms, b_ms, parent=None, call=None, **attrs):
    return types.SimpleNamespace(id=id_, name=name, parent=parent,
                                 call=call, thread=1, start=int(a_ms * MS),
                                 end=int(b_ms * MS), attrs=attrs)


# two traced calls of 1 and 3 Mbp; the first launches on the std route
# after 4 of its 10 ms, the second only on the mega route
SPANS = [
    span(1, "call", 1, 11, call=1, bp=1_000_000, contigs=512),
    span(2, "launch", 5, 8, 1, 1, route="std", contigs=300),
    span(3, "launch.score", 5, 7, 2, 1),
    span(4, "launch.wait", 5.5, 6, 3, 1),
    span(5, "launch.wait", 7, 8, 2, 1),
    span(6, "launch", 8, 10, 1, 1, route="std", contigs=212),
    span(7, "launch.score", 8, 9, 6, 1),
    span(8, "call", 12, 20, call=8, bp=3_000_000, contigs=2),
    span(9, "launch", 13, 19, 8, 8, route="mega"),
    span(10, "launch.score", 13, 14, 9, 8),
    span(11, "launch.wait", 13.5, 14, 10, 8),
]


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(progspans, "program_spans", lambda: list(SPANS))


def traced_run(trace=True):
    calls = [{"start": a * 1e-3, "end": b * 1e-3, "bp": bp, "ok": True}
             for (a, b), bp in (((0.5, 11.5), 1_000_000),
                                ((11.5, 20.5), 3_000_000))]
    t = types.SimpleNamespace(calls=[(c["start"], c["end"]) for c in calls],
                              bp=4_000_000) if trace else None
    return fake_run(trace=t, calls=calls)


def test_launch_score_less_its_own_waits_per_mbp(program, monkeypatch):
    m = metric("prog.launch.score_s_per_mbp")
    # 2 - 0.5 + 1 + 1 - 0.5 ms; the launch's own wait (7..8) is not the
    # scoring's
    assert m.read(traced_run()) == pytest.approx(3e-3 / 4)
    assert m.read(traced_run(trace=False)) is None
    monkeypatch.setattr(progspans, "program_spans",
                        lambda: [s for s in SPANS
                                 if s.name != "launch.score"])
    assert m.read(traced_run()) is None          # an older program
    monkeypatch.setattr(progspans, "program_spans", lambda: None)
    assert m.read(traced_run()) is None          # no tracing at all


def test_first_std_launch_share_of_the_calls_that_launch_std(program,
                                                             monkeypatch):
    m = metric("prog.std.first_launch_pct")
    assert m.read(traced_run()) == pytest.approx(100 * 4 / 10)
    assert m.read(traced_run(trace=False)) is None
    monkeypatch.setattr(progspans, "program_spans",
                        lambda: [s for s in SPANS if s.id not in (2, 6)])
    assert m.read(traced_run()) is None          # no std launch
