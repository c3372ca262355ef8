"""The port's own spans (`pyrodigal_tpu_torch.tracing`) on the CPU runner
(`device="cpu"`, the kernels' plain versions): nothing recorded when
off, a tree of spans under each call when on, whether switched on or
following a `torch.profiler`'s active steps, the route each contig took
and why, the same genes either way, a call span on the profiler's clock,
and the Chrome-trace export."""

import json
import threading

import pytest

torch = pytest.importorskip("torch")

from genebench import devtrace  # noqa: E402
from pyrodigal_tpu_torch import METAGENOMIC_BINS, tracing  # noqa: E402
from pyrodigal_tpu_torch.fasta import parse  # noqa: E402
from pyrodigal_tpu_torch.ops import dp_cuda, meta_cuda  # noqa: E402
from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner  # noqa: E402
from pyrodigal_tpu_torch.sequence import Sequence  # noqa: E402

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)
LAYERS = {"call", "prep", "prep.nodes", "prep.geometry", "prep.route",
          "launch", "launch.pack", "launch.score", "launch.wait", "finish",
          "finish.rerun"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run shares the cores among several pytest workers; torch's
    intra-op thread pool on top of that slows these small ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture
def mega_only(monkeypatch):
    monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)


@pytest.fixture(scope="module")
def srr(data):
    return list(parse(data("SRR492066.fna.gz")))[0].seq


def _runner(**kw):
    return CudaMetaRunner(METAGENOMIC_BINS, device="cpu", **kw)


def _named(name):
    return [s for s in tracing.spans() if s.name == name]


def _gene_bytes(genes):
    return [[g._gene_data(1) for g in gs] for gs in genes]


@needs_bins
def test_off_records_nothing_and_carry_is_the_callable(srr):
    runner = _runner()
    assert [s.name for s in _named("setup.runner")] == ["setup.runner"]
    tracing.clear()
    runner.find_genes_batch([srr[:6000]])
    runner.close()
    assert tracing.spans() == []
    assert not tracing.enabled()
    assert tracing.carry(len, "x") is len
    assert tracing.span("x") is tracing.OFF
    assert tracing.current("call") is tracing.OFF


@needs_bins
def test_enabled_spans_form_one_tree_a_call(srr):
    """Every span reaches its call through its parents, across the pool
    and launcher threads; a std launch's counts equal the hand count from
    the prep spans."""
    runner = _runner()
    seqs = [srr[:6000], srr[6000:14000]]
    tracing.enable()
    runner.find_genes_batch(seqs)
    runner.close()
    spans = {s.id: s for s in tracing.spans()}
    assert LAYERS <= {s.name for s in spans.values()}
    (call,) = _named("call")
    assert call.attrs == {"contigs": 2, "bp": 14000}
    assert len({s.thread for s in spans.values()}) >= 3
    for s in spans.values():
        if s.name.startswith("setup."):
            continue
        assert s.call == call.id
        up = s
        while up.parent is not None:
            up = spans[up.parent]
        assert up is call
        assert call.start <= s.start <= s.end <= call.end
    for name in ("prep", "launch", "finish"):
        assert all(s.attrs["queued_s"] >= 0 for s in _named(name))
    (launch,) = _named("launch")
    preps = sorted(_named("prep"), key=lambda s: s.attrs["contig"])
    tts = {b: METAGENOMIC_BINS[b].training_info.translation_table
           for b in range(len(METAGENOMIC_BINS))}
    cands = [runner._candidate_bins(Sequence(s)) for s in seqs]
    assert launch.attrs["route"] == "std"
    assert launch.attrs["contigs"] == 2
    assert launch.attrs["rows"] == sum(map(len, cands))
    assert launch.attrs["rows_bucket"] == -(-launch.attrs["rows"] // 16) * 16
    assert launch.attrs["node_rows"] == sum(
        p.attrs["nodes"][tts[b]] for p, c in zip(preps, cands) for b in c)
    assert launch.attrs["node_rows_bucket"] == \
        launch.attrs["rows_bucket"] * launch.attrs["node_bucket"]
    assert (launch.attrs["node_bucket"], launch.attrs["seq_bucket"]) == \
        meta_cuda.std_buckets(max(p.attrs["nodes"][tts[b]] for p, c in
                                  zip(preps, cands) for b in c), 8000)
    assert {s.attrs["contig"] for s in _named("finish")} == {0, 1}
    assert len(_named("finish.rerun")) == sum(
        s.attrs["bins"] for s in _named("finish"))


@needs_bins
@pytest.mark.parametrize("route", ["std", "mega"])
def test_launch_score_holds_the_scoring_and_its_waits(srr, monkeypatch,
                                                      route):
    """A launch's device scoring is one `launch.score` span under its
    `launch`, and the host syncs inside the scoring are its own
    `launch.wait` children."""
    if route == "mega":
        monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
    runner = _runner()
    tracing.enable()
    runner.find_genes_batch([srr[:6000], srr[6000:14000]])
    runner.close()
    spans = {s.id: s for s in tracing.spans()}
    (launch,) = _named("launch")
    assert launch.attrs["route"] == route
    (score,) = _named("launch.score")
    up = spans[score.parent]
    while up.name != "launch":
        up = spans[up.parent]
    assert up is launch
    assert launch.start <= score.start <= score.end <= launch.end
    inner = [s for s in spans.values() if s.parent == score.id]
    assert inner and {s.name for s in inner} == {"launch.wait"}
    assert all(score.start <= s.start <= s.end <= score.end for s in inner)


@needs_bins
def test_a_profiler_turns_tracing_on_in_its_active_steps_only(srr):
    runner = _runner()
    tracing.clear()
    prof = devtrace.start(1, cuda=False)
    try:
        runner.find_genes_batch([srr[:6000]])          # warm-up step
        assert tracing.spans() == []
        prof.step()
        assert tracing.enabled()
        runner.find_genes_batch([srr[:6000]])          # active step
    finally:
        prof.stop()
    assert not tracing.enabled()
    n = len(tracing.spans())
    runner.find_genes_batch([srr[:6000]])
    runner.close()
    assert len(_named("call")) == 1 and n == len(tracing.spans())
    assert LAYERS <= {s.name for s in tracing.spans()}


@needs_bins
@pytest.mark.parametrize("route", ["std", "mega", "ring", "window"])
def test_prep_records_the_route_and_why(srr, monkeypatch, route):
    """Std, mega, and the exact route reached by lowering one of the mega
    kernel's limits, so that the reason is the constraint that broke."""
    if route != "std":
        monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
    if route == "ring":
        monkeypatch.setattr(dp_cuda, "MEGA_RING", 0)
    if route == "window":
        monkeypatch.setattr(dp_cuda, "MEGA_CHUNKS", 0)
    runner = _runner()
    tracing.enable()
    runner.find_genes_batch([srr[:8000]])
    runner.close()
    (prep,) = _named("prep")
    assert {s.name for s in tracing.spans() if s.parent == prep.id} == \
        {"prep.nodes", "prep.geometry", "prep.route"}
    expected = {"std": ("std", None), "mega": ("mega", None),
                "ring": ("c", "ring"), "window": ("c", "window")}[route]
    assert (prep.attrs["route"], prep.attrs["route_reason"]) == expected
    assert prep.attrs["bp"] == 8000
    assert runner.route_counts[expected[0]] == 1
    if expected[0] == "c":
        (exact,) = _named("exact_route")
        assert exact.attrs["bins"] == len(_named("exact_route.bin")) > 0
        assert _named("launch") == []
    else:
        assert _named("launch")[0].attrs["route"] == expected[0]


@needs_bins
def test_exact_route_bins_run_beside_their_span(srr, mega_only,
                                                monkeypatch):
    """Route "c" in meta mode: one `exact_route.bin` span a candidate bin,
    a child of its contig's `exact_route` span with `queued_s`, run on
    another thread than that span's and inside its time; the span counts
    its bins and the threads they may run on."""
    monkeypatch.setattr(dp_cuda, "MEGA_CHUNKS", 0)
    seqs = [srr[:8000], srr[8000:16000]]
    runner = _runner()
    tracing.enable()
    runner.find_genes_batch(seqs)
    runner.close()
    exact = sorted(_named("exact_route"), key=lambda s: s.attrs["contig"])
    assert [s.attrs["bp"] for s in exact] == [8000, 8000]
    for ex, seq in zip(exact, seqs):
        bins = [s for s in tracing.spans() if s.parent == ex.id]
        assert {s.name for s in bins} == {"exact_route.bin"}
        assert sorted(s.attrs["bin"] for s in bins) == \
            runner._candidate_bins(Sequence(seq))
        assert ex.attrs["bins"] == len(bins) > 1
        assert ex.attrs["workers"] == meta_cuda.PREP_THREADS
        assert ex.thread not in {s.thread for s in bins}
        for s in bins:
            assert s.call == ex.call and s.attrs["queued_s"] >= 0
            assert ex.start <= s.start <= s.end <= ex.end
    assert len(_named("exact_route.bin")) == \
        sum(s.attrs["bins"] for s in exact)


@needs_bins
@pytest.mark.parametrize("route", ["std", "c"])
def test_exact_reruns_carry_their_native_seconds(srr, monkeypatch, route):
    """Every bin re-run on the exact engine, `finish.rerun` (a launch's
    winner) or `exact_route.bin` (the exact route), carries `native_s`:
    the seconds inside its foreign call, at least 0 and at most the span's
    own length."""
    name = "finish.rerun"
    if route == "c":
        monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
        monkeypatch.setattr(dp_cuda, "MEGA_CHUNKS", 0)
        name = "exact_route.bin"
    runner = _runner()
    tracing.enable()
    runner.find_genes_batch([srr[:8000], srr[8000:14000]])
    runner.close()
    assert runner.route_counts[route] == 2
    spans = _named(name)
    assert len(spans) >= 2
    for s in spans:
        assert 0 <= s.attrs["native_s"] <= s.seconds
    assert sum(s.attrs["native_s"] for s in spans) > 0


def test_mega_refusal_names_the_first_broken_constraint():
    """`_mega_refusal` on made-up geometries; `_mega_ok` is its None."""
    import numpy as np

    runner = CudaMetaRunner.__new__(CudaMetaRunner)
    n = 4

    def geo(**kw):
        g = {"nn": n, "star_overflow": False, "slen": 1000,
             "win_lo": np.zeros(n, np.int64),
             "ndx": np.array([10, 400, 800, 900]),
             "typ": np.array([0, 0, 0, 0]),
             "strand": np.array([1, 1, 1, 1])}
        g.update(kw)
        return g

    nodes = 300
    dense = geo(nn=nodes, ndx=np.arange(nodes) // 2,
                win_lo=np.zeros(nodes, np.int64),
                typ=np.zeros(nodes, int), strand=np.ones(nodes, int))
    ring = dp_cuda.MEGA_RING + 2
    stops = geo(nn=ring, ndx=np.arange(ring) * 1000,
                win_lo=np.zeros(ring, np.int64),
                typ=np.array([meta_cuda.STOP] * (ring - 1) + [0]),
                strand=np.ones(ring, int))
    cases = [(geo(nn=0), "nodes"),
             (geo(nn=CudaMetaRunner.MEGA_NT[-1] + 1), "nodes"),
             (geo(star_overflow=True), "star_overflow"),
             (geo(slen=CudaMetaRunner.MEGA_SB[-1] + 1), "length"),
             (geo(win_lo=np.array([0, 0, 0, -dp_cuda.MEGA_CHUNKS
                                   * dp_cuda.W_MEGA])), "window"),
             (dense, "density"), (stops, "ring"), (geo(), None)]
    for g, reason in cases:
        assert runner._mega_refusal(g) == reason
        assert runner._mega_ok(g) is (reason is None)


@needs_bins
def test_genes_are_the_same_with_tracing_on_and_off(srr, mega_only):
    seqs = [srr[:8000], srr[8000:20000]]
    runner = _runner()
    off = runner.find_genes_batch(seqs)
    tracing.enable()
    on = runner.find_genes_batch(seqs)
    runner.close()
    assert _named("launch")[0].attrs["route"] == "mega"
    assert _gene_bytes(on) == _gene_bytes(off)
    assert [g.metagenomic_bin.description for g in on] == \
        [g.metagenomic_bin.description for g in off]


@needs_bins
def test_a_profiled_call_lies_on_the_profilers_clock(srr, tmp_path):
    """The call span, put on the trace's clock through `clock_anchor`
    and `baseTimeNanoseconds`, lies within 1 ms of the `record_function`
    around it."""
    runner = _runner()
    prof = devtrace.start(1, cuda=False)
    runner.find_genes_batch([srr[:6000]])
    prof.step()
    with torch.profiler.record_function(devtrace.CALL):
        runner.find_genes_batch([srr[:6000]])
    prof.stop()
    runner.close()
    events = devtrace.export(prof, str(tmp_path / "trace.json"))
    (mark,) = [e for e in events["traceEvents"]
               if e.get("name") == devtrace.CALL and e.get("ph") == "X"]
    perf, wall = tracing.clock_anchor()
    base = events["baseTimeNanoseconds"]
    (call,) = _named("call")
    a, b = ((t - perf + wall - base) / 1000 for t in (call.start, call.end))
    assert mark["ts"] - 1000 <= a and b <= mark["ts"] + mark["dur"] + 1000
    assert abs(a - mark["ts"]) < 1000


def test_write_chrome_trace_loads_back(tmp_path):
    tracing.enable()
    with tracing.span("call", bp=5):
        with tracing.span("prep"):
            pass
        t = threading.Thread(target=tracing.carry(lambda: None, "finish",
                                                  contig=0))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    spans = {s.name: s for s in tracing.spans()}
    path = tmp_path / "spans.json"
    tracing.write_chrome_trace(str(path))
    with open(path) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]}
    assert set(events) == {"call", "prep", "finish"}
    assert events["finish"]["tid"] != events["call"]["tid"]
    assert events["finish"]["args"]["parent"] == spans["call"].id
    assert events["finish"]["args"]["contig"] == 0
    assert events["call"]["args"]["bp"] == 5
    assert events["call"]["ts"] <= events["prep"]["ts"]
    assert events["call"]["dur"] >= events["prep"]["dur"] >= 0
    # merged into a profiler's trace, on its clock
    base = events["call"]["ts"] * 1000 - 10**6
    prof = tmp_path / "prof.json"
    with open(prof, "w") as f:
        json.dump({"baseTimeNanoseconds": base, "traceEvents": [
            {"ph": "X", "name": "kernel", "ts": 0, "dur": 1}]}, f)
    tracing.write_chrome_trace(str(path), profiler_trace=str(prof))
    with open(path) as f:
        merged = json.load(f)
    assert merged["baseTimeNanoseconds"] == base
    ts = {e["name"]: e["ts"] for e in merged["traceEvents"]}
    assert ts["kernel"] == 0
    assert ts["call"] == pytest.approx(1000.0, abs=200)
