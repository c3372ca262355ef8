"""The port's meta-mode runner on the CPU (plain versions of the kernels)
against the exact C engine: winner bins and gene data byte-equal, as the
JAX package's runner tests in tests/test_meta.py, on the std route and
(with the sequence bucket shrunk, as those tests shrink it) the mega
route; and its per-(contig, bin) best path scores against the JAX
package's std and mega launches."""

import io
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyrodigal_tpu import GeneFinder, MetagenomicBins, METAGENOMIC_BINS  # noqa: E402,E501
from pyrodigal_tpu.fasta import parse  # noqa: E402
from pyrodigal_tpu.sequence import Sequence  # noqa: E402
from pyrodigal_tpu_torch.ops import dp_cuda, meta_cuda  # noqa: E402
from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner  # noqa: E402

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run shares the cores among several pytest workers; torch's
    intra-op thread pool on top of that slows these small ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runner(bins=METAGENOMIC_BINS, cls=CudaMetaRunner, **kw):
    return cls(bins, device="cpu", **kw)


@pytest.fixture
def mega_only(monkeypatch):
    """Send every contig longer than 2,048 bp down the mega route, as the
    JAX package's mega tests pass seq_bucket=2048."""
    monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)


def _assert_same_genes(a, b):
    assert len(a) == len(b)
    assert [(g.begin, g.end, g.strand) for g in b] == \
        [(g.begin, g.end, g.strand) for g in a]
    assert all(x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b))


class _Clone:
    """A bin whose model is another's, under another name."""

    description = "clone-of-winner"

    def __init__(self, ti):
        self.training_info = ti


def _packed_contigs(data):
    srr = list(parse(data("SRR492066.fna.gz")))[0].seq
    miij = list(parse(data("MIIJ01000039.fna.gz")))[0].seq
    return [srr[:30000], miij[:24000], srr[30000:54000]]


@needs_bins
def test_mega_route_matches_c_path(data, mega_only):
    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:30000]
    a = GeneFinder(meta=True, backend="refcore").find_genes(seq)
    runner = _runner()
    b = runner.find_genes_batch([seq])[0]
    assert runner.route_counts == {"std": 0, "mega": 1, "c": 0}
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    _assert_same_genes(a, b)


@needs_bins
@pytest.mark.parametrize("closed,mask", [(True, False), (False, True)])
def test_mega_route_closed_mask(data, closed, mask, mega_only):
    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:24000]
    if mask:
        seq = seq[:9000] + "N" * 120 + seq[9000:]
    a = GeneFinder(meta=True, closed=closed, mask=mask,
                   backend="refcore").find_genes(seq)
    runner = _runner(closed=closed, mask=mask)
    b = runner.find_genes_batch([seq])[0]
    assert runner.route_counts["mega"] == 1
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    _assert_same_genes(a, b)


@needs_bins
def test_mega_route_packed_multi_contig(data, mega_only):
    contigs = _packed_contigs(data)
    p = GeneFinder(meta=True, backend="refcore")
    expected = [p.find_genes(c) for c in contigs]
    runner = _runner()
    got = runner.find_genes_batch(contigs)
    assert runner.route_counts == {"std": 0, "mega": 3, "c": 0}
    items = []
    for i, c in enumerate(contigs):
        seq = Sequence(c)
        items.append({"ci": i, "g": runner._prepare_contig(seq)[1][11],
                      "rows": runner._candidate_bins(seq)})
    groups = runner._group_mega(items)
    assert len(groups) < len(contigs)
    assert max(len(g["items"]) for g in groups) >= 2
    for a, b in zip(expected, got):
        assert b.metagenomic_bin.description == \
            a.metagenomic_bin.description
        _assert_same_genes(a, b)


@needs_bins
def test_mega_route_fxs_rescale(data, mega_only):
    """Past MEGA_FXS_LIMIT the DP runs at FXS=1024; forcing that on a
    small contig must still give the exact C path's genes."""
    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:30000]
    a = GeneFinder(meta=True, backend="refcore").find_genes(seq)

    class _HalfFXS(CudaMetaRunner):
        MEGA_FXS_LIMIT = 1

    runner = _runner(cls=_HalfFXS)
    b = runner.find_genes_batch([seq])[0]
    assert runner.route_counts["mega"] == 1
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    _assert_same_genes(a, b)


@needs_bins
def test_bin_near_tie_exact_arbitration(data):
    """Two bins with identical models tie exactly on the device; the
    exact engine arbitrates and keeps the earlier bin (lib.pyx:5363-5365)."""
    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:20000]
    full = GeneFinder(meta=True, backend="refcore").find_genes(seq)
    chosen = full.metagenomic_bin
    bins = MetagenomicBins((chosen, _Clone(chosen.training_info)))
    runner = _runner(bins)
    b = runner.find_genes_batch([seq])[0]
    assert runner.route_counts["std"] == 1
    assert b.metagenomic_bin.description == chosen.description
    _assert_same_genes(full, b)


@pytest.fixture
def exact_only(monkeypatch, mega_only):
    """Send every contig longer than 2,048 bp down the exact route ("c"):
    no node's window fits a mega kernel without chunks."""
    monkeypatch.setattr(dp_cuda, "MEGA_CHUNKS", 0)


def _writer_bytes(genes, scores=False):
    """GFF, nucleotide FASTA and protein FASTA, and with `scores` the
    start score table."""
    out = []
    writers = [genes.write_gff, genes.write_genes, genes.write_translations]
    for write in writers + [genes.write_scores] * scores:
        f = io.StringIO()
        write(f, "contig")
        out.append(f.getvalue())
    return out


def _assert_same_bytes(expected, got):
    assert len(expected) == len(got)
    for a, b in zip(expected, got):
        assert (b.metagenomic_bin and b.metagenomic_bin.description) == \
            (a.metagenomic_bin and a.metagenomic_bin.description)
        assert _writer_bytes(b) == _writer_bytes(a)


@needs_bins
@pytest.mark.parametrize("case", ["gc_levels", "closed", "mask",
                                  "two_tables", "tie", "no_path"])
def test_exact_route_matches_c_path(data, case, exact_only):
    """Route "c": each contig's candidate bins run side by side on the
    exact engine, from the nodes prep extracted, and the winner is the one
    the sequential sweep picks: the same bytes and bin as refcore's, for
    contigs of three GC levels in one call, closed ends, a masked N run,
    bins of two translation tables, two bins with one model (the earlier
    wins) and a contig with no node (no genes)."""
    srr = list(parse(data("SRR492066.fna.gz")))[0].seq
    seqs, kw, bins = [srr[:24000]], {}, METAGENOMIC_BINS
    if case == "gc_levels":
        seqs = [srr[:12000],
                list(parse(data("MIIJ01000039.fna.gz")))[0].seq[:24000],
                list(parse(data("KK037166.fna.gz")))[0].seq]
    elif case == "closed":
        kw = dict(closed=True)
    elif case == "mask":
        seqs, kw = [srr[:9000] + "N" * 120 + srr[9000:24000]], dict(mask=True)
    elif case == "two_tables":
        seqs = [srr[30000:54000]]
        assert len({bins[b].training_info.translation_table for b in
                    _runner()._candidate_bins(Sequence(seqs[0]))}) == 2
    elif case == "tie":
        chosen = GeneFinder(meta=True, backend="refcore").find_genes(
            seqs[0]).metagenomic_bin
        bins = MetagenomicBins((chosen, _Clone(chosen.training_info)))
    elif case == "no_path":
        seqs = ["TTAATTAGTGA" * 300]
    finder = GeneFinder(meta=True, metagenomic_bins=bins, backend="refcore",
                        **kw)
    expected = [finder.find_genes(s) for s in seqs]
    runner = _runner(bins, **kw)
    got = runner.find_genes_batch(seqs)
    runner.close()
    assert runner.route_counts == {"std": 0, "mega": 0, "c": len(seqs)}
    _assert_same_bytes(expected, got)
    if case == "tie":
        assert got[0].metagenomic_bin is chosen
    if case == "no_path":
        assert len(got[0]) == 0 and got[0].metagenomic_bin is None
    else:
        assert all(len(g) > 0 for g in got)


@needs_bins
def test_exact_route_many_contigs_in_one_call(data, exact_only):
    """More route-"c" contigs in one call than the pool has threads: each
    pool thread that sweeps a contig waits on its bins, which run on the
    runner's second pool and wait on nothing, so the call finishes."""
    srr = list(parse(data("SRR492066.fna.gz")))[0].seq
    seqs = [srr[k * 2500:k * 2500 + 3000] for k in range(24)]
    assert len(seqs) > 2 * meta_cuda.PREP_THREADS
    finder = GeneFinder(meta=True, backend="refcore")
    expected = [finder.find_genes(s) for s in seqs]
    runner = _runner()
    got = []
    call = threading.Thread(
        target=lambda: got.extend(runner.find_genes_batch(seqs)),
        daemon=True)
    call.start()
    call.join(timeout=120)
    assert not call.is_alive(), "the call did not finish in 120 s"
    runner.close()
    assert runner.route_counts == {"std": 0, "mega": 0, "c": len(seqs)}
    _assert_same_bytes(expected, got)
    assert [g._num_seq for g in got] == list(range(1, len(seqs) + 1))


@needs_bins
def test_short_contigs_take_the_std_route(data):
    """Short contigs (empty, all-N, shorter than a gene, 4 kb) take the
    std route, packed into one launch, and keep their order and
    num_seq."""
    base = list(parse(data("SRR492066.fna.gz")))[0].seq
    seqs = []
    for k in range(12):
        if k % 4 == 0:
            seqs.append("")
        elif k % 4 == 1:
            seqs.append("N" * 500)
        elif k % 4 == 2:
            seqs.append(base[:90])
        else:
            seqs.append(base[(k * 997) % 20000:][:4000])
    p = GeneFinder(meta=True, backend="refcore")
    expected = [p.find_genes(s) for s in seqs]
    runner = _runner()
    got = runner.find_genes_batch(seqs, num_seq_start=5)
    assert runner.route_counts["c"] == 0
    assert runner.route_counts["std"] == len(seqs)
    assert len(got) == len(seqs)
    for i, (a, b) in enumerate(zip(expected, got)):
        _assert_same_genes(a, b)
        assert b._num_seq == i + 5
    assert sum(len(g) for g in got) > 0


@needs_bins
def test_best_scores_match_jax_mega_launch(data):
    """Per-(contig, bin) best path scores of the packed launch against the
    JAX package's `score_dp_launch_mega(interpret=True)` on the same
    items.  Both score in f32 from the same tables but round the dc prefix
    sums differently (see test_torch_score), which moves path scores by a
    few 1e-6 relative; the exact engine settles every bin within
    `_margin` = 1 + 1e-4 |best| of the winner, so the bar is a tenth of
    that margin."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    contigs = _packed_contigs(data)
    jr = TpuMetaRunner(METAGENOMIC_BINS, seq_bucket=2048, interpret=True)
    pr = _runner()
    j_items, p_items = [], []
    for i, c in enumerate(contigs):
        seq = Sequence(c)
        cand, geoms, _nbt, _r = jr._prepare_contig(seq)
        j_items.append({"ci": i, "g": geoms[11], "rows": cand})
        cand, geoms, _nbt, _r = pr._prepare_contig(seq)
        p_items.append({"ci": i, "g": geoms[11], "rows": cand})
    j_groups = jr._group_mega(j_items)
    p_groups = pr._group_mega(p_items)
    assert [len(g["items"]) for g in j_groups] == \
        [len(g["items"]) for g in p_groups]
    items = j_groups[0]["items"]
    assert len(items) >= 2
    dev, j_rows, CP, B = jr._sweep_mega_multi(items)
    j_best = np.asarray(dev).view(np.float32).reshape(CP, B)
    p_best, p_rows, CP2, B2 = pr._sweep_mega_multi(p_groups[0]["items"])
    assert (p_rows, CP2, B2) == (j_rows, CP, B)
    worst = 0.0
    for k, it in enumerate(items):
        for b in it["rows"]:
            r = j_rows.index(b)
            ref = float(j_best[k, r])
            assert ref > 0
            diff = abs(float(p_best[k, r]) - ref)
            assert diff <= 0.1 * CudaMetaRunner._margin(ref), (k, b)
            worst = max(worst, diff / abs(ref))
    assert worst < 1e-4


@needs_bins
def test_std_route_matches_c_path(data):
    """Port of test_tpu_meta_runner_matches_c_path: two short contigs in
    one std launch give the exact C path's winner bins and gene data."""
    seqs = [list(parse(data("KK037166.fna.gz")))[0].seq,
            list(parse(data("SRR492066.fna.gz")))[0].seq[:30000]]
    p = GeneFinder(meta=True, backend="refcore")
    anchor = [p.find_genes(s) for s in seqs]
    runner = _runner()
    batched = runner.find_genes_batch(seqs)
    assert runner.route_counts == {"std": 2, "mega": 0, "c": 0}
    for a, b in zip(anchor, batched):
        assert b.metagenomic_bin.description == a.metagenomic_bin.description
        _assert_same_genes(a, b)


@needs_bins
@pytest.mark.parametrize("closed,mask", [(True, False), (False, True)])
def test_std_route_closed_mask(data, closed, mask):
    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:30000]
    if mask:
        seq = seq[:12000] + "N" * 120 + seq[12000:]
    a = GeneFinder(meta=True, closed=closed, mask=mask,
                   backend="refcore").find_genes(seq)
    runner = _runner(closed=closed, mask=mask)
    b = runner.find_genes_batch([seq])[0]
    assert runner.route_counts["std"] == 1
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    _assert_same_genes(a, b)


@needs_bins
@pytest.mark.parametrize("route", ["std", "mega"])
@pytest.mark.parametrize("kw", [
    dict(min_gene=60, min_edge_gene=30, max_overlap=30),
    dict(min_gene=120, max_overlap=40),
    dict(max_overlap=0),
])
def test_std_route_option_variants(data, kw, route, monkeypatch):
    """`min_gene`, `min_edge_gene` and `max_overlap` on each route."""
    if route == "mega":
        monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:24000]
    a = GeneFinder(meta=True, backend="refcore", **kw).find_genes(seq)
    runner = _runner(**kw)
    b = runner.find_genes_batch([seq])[0]
    assert runner.route_counts[route] == 1
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    _assert_same_genes(a, b)


def _bin_set(data, name):
    """(contig, bins) of a bin set: every bin, the non-SD bins, the
    translation table 4 bins, or the all-bins winner alone; the contig's
    GC admits the set's bins."""
    srr = list(parse(data("SRR492066.fna.gz")))[0].seq[30000:54000]
    if name == "nonsd":
        return (list(parse(data("KK037166.fna.gz")))[0].seq,
                MetagenomicBins(b for b in METAGENOMIC_BINS
                                if not b.training_info.uses_sd))
    if name == "table4":
        # 12 kb of sequence before an N run: GC 0.25
        miij = list(parse(data("MIIJ01000039.fna.gz")))[0].seq
        return (miij[372000:396000],
                MetagenomicBins(b for b in METAGENOMIC_BINS
                                if b.training_info.translation_table == 4))
    if name == "winner":
        winner = GeneFinder(meta=True, backend="refcore").find_genes(
            srr).metagenomic_bin
        return srr, MetagenomicBins((winner,))
    return srr, METAGENOMIC_BINS


@needs_bins
@pytest.mark.parametrize("route", ["std", "mega", "c"])
@pytest.mark.parametrize("bin_set", ["all", "nonsd", "table4", "winner"])
def test_outputs_match_refcore_bytes(data, bin_set, route, monkeypatch):
    """All four writers' bytes, the start score table (the pre-DP
    snapshot `_finish` writes) among them, equal refcore's over the same
    bins on each route: every bin, a launch whose every row is non-SD,
    node extraction for translation table 4 alone, and a one-row launch
    of the winner alone."""
    if route != "std":
        monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
    if route == "c":
        monkeypatch.setattr(dp_cuda, "MEGA_CHUNKS", 0)
    seq, bins = _bin_set(data, bin_set)
    runner = _runner(bins)
    if bin_set != "all":
        # the contig's GC admits every bin of the set
        assert runner._candidate_bins(Sequence(seq)) == \
            list(range(len(bins)))
    expected = GeneFinder(meta=True, metagenomic_bins=bins,
                          backend="refcore").find_genes(seq)
    (got,) = runner.find_genes_batch([seq])
    runner.close()
    routes = dict.fromkeys(("std", "mega", "c"), 0)
    routes[route] = 1
    assert runner.route_counts == routes
    assert len(got) > 0
    assert got.metagenomic_bin.description == \
        expected.metagenomic_bin.description
    assert _writer_bytes(got, scores=True) == \
        _writer_bytes(expected, scores=True)


@needs_bins
def test_many_tiny_contigs_batch(data, monkeypatch):
    """Many tiny or odd contigs (empty, all-N, short, normal) over several
    std launches keep launch packing, row mapping and num_seq straight
    (the node-row budget lowered, so that they take several)."""
    monkeypatch.setattr(meta_cuda, "NODE_ROW_BUDGET", 128 * 256)
    base = list(parse(data("SRR492066.fna.gz")))[0].seq
    seqs = []
    for k in range(40):
        if k % 7 == 0:
            seqs.append("")
        elif k % 7 == 1:
            seqs.append("N" * 500)
        elif k % 7 == 2:
            seqs.append(base[:90])
        else:
            seqs.append(base[(k * 997) % 20000:][:4000])
    p = GeneFinder(meta=True, backend="refcore")
    anchor = [p.find_genes(s) for s in seqs]
    runner = _runner()
    items = []
    for ci, s in enumerate(seqs):
        cand, geoms, _nbt, _route = runner._prepare_contig(Sequence(s))
        if cand:
            items.append((ci, cand, geoms))
    assert len(runner._pack_std(items)) >= 2
    outs = runner.find_genes_batch(seqs, num_seq_start=1)
    assert runner.route_counts == {"std": len(seqs), "mega": 0, "c": 0}
    assert len(outs) == len(seqs)
    for i, (a, b) in enumerate(zip(anchor, outs)):
        _assert_same_genes(a, b)
        assert b._num_seq == i + 1


@needs_bins
def test_runner_thread_reentrancy(data):
    """Concurrent find_genes_batch calls share the runner (its pools and
    the refcore entry points are state-free) and give the same genes."""
    import concurrent.futures

    seqs = [list(parse(data("SRR492066.fna.gz")))[0].seq[:15000],
            list(parse(data("KK037166.fna.gz")))[0].seq]
    runner = _runner()
    ref = runner.find_genes_batch(seqs)
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        outs = list(ex.map(lambda _: runner.find_genes_batch(seqs),
                           range(4)))
    assert runner.route_counts == {"std": 10, "mega": 0, "c": 0}
    for out in outs:
        for a, b in zip(ref, out):
            _assert_same_genes(a, b)


@needs_bins
def test_std_contig_skips_the_mega_check(data, monkeypatch):
    """A short contig whose geometry fits the std buckets takes the std
    route whatever the mega kernel's own checks say: the JAX package runs
    `_mega_ok` on mega-route contigs only (meta_tpu.py:197-203)."""
    monkeypatch.setattr(CudaMetaRunner, "_mega_ok", lambda self, g: False)
    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:20000]
    a = GeneFinder(meta=True, backend="refcore").find_genes(seq)
    runner = _runner()
    b = runner.find_genes_batch([seq])[0]
    assert runner.route_counts == {"std": 1, "mega": 0, "c": 0}
    assert b.metagenomic_bin.description == a.metagenomic_bin.description
    _assert_same_genes(a, b)


@needs_bins
def test_best_scores_match_jax_std_launch(data):
    """Per-(contig, bin) best path scores of one std launch against the
    JAX package's `score_dp_launch_packed(interpret=True)` on the same
    work items (KK037166 and the first 24,000 bp of SRR492066, eight bins
    of each).  The dc prefix sums round differently (see
    test_torch_score), which moves path scores by a few 1e-6 relative;
    the bar is a tenth of the exact engine's `_margin`."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    seqs = [list(parse(data("KK037166.fna.gz")))[0].seq,
            list(parse(data("SRR492066.fna.gz")))[0].seq[:24000]]
    jr = TpuMetaRunner(METAGENOMIC_BINS, node_bucket=1536, batch_size=16,
                       seq_bucket=24576, interpret=True)
    pr = _runner()
    items = []
    for ci, s in enumerate(seqs):
        cand, geoms, _nbt, route = pr._prepare_contig(Sequence(s))
        assert route == "std"
        items.append((ci, cand[:8], geoms))
    (launch,) = pr._pack_std(items)
    work, geoms = launch["work"], launch["geoms"]
    assert len(work) == 16 and len(geoms) >= 2
    j_best = np.asarray(jr._sweep(work, geoms, {0: 0, 1: 1})).view(
        np.float32)
    p_best = pr._sweep_std(work, geoms)
    assert p_best.shape == (16,)
    worst = 0.0
    for k in range(len(work)):
        ref = float(j_best[k])
        assert ref > 0
        diff = abs(float(p_best[k]) - ref)
        assert diff <= 0.1 * CudaMetaRunner._margin(ref), work[k]
        worst = max(worst, diff / abs(ref))
    assert worst < 1e-4


# -- the std packer: launches sized by their contents -------------------------

SHORT_SEED = 2_718_281_829


@pytest.fixture(scope="module")
def short_call():
    """Call 0 of the benchmark's short-read assembly mix (512 contigs,
    about 2.5 Mbp), prepped: [(ci, bin_ids, geoms)] of its std contigs."""
    import concurrent.futures

    from genebench import generate

    call = generate.make(SHORT_SEED, generate.load_mix("short_contigs"))[0]
    runner = _runner()
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            preps = list(ex.map(
                lambda s: runner._prepare_contig(Sequence(s[1])), call))
    finally:
        runner.close()
    return [(ci, cand, geoms) for ci, (cand, geoms, _nbt, route)
            in enumerate(preps) if route == "std" and cand]


def _largest(runner, cand, geoms):
    """(nodes, bp) of the largest geometry a contig's bins use."""
    gs = [geoms[runner.bins[b].training_info.translation_table]
          for b in cand]
    return max(g["nn"] for g in gs), max(g["slen"] for g in gs)


@needs_bins
def test_std_packer_keeps_a_contigs_bins_in_one_launch(short_call):
    runner = _runner()
    launches = runner._pack_std(short_call)
    runner.close()
    geoms_of = {ci: geoms for ci, _cand, geoms in short_call}
    seen, bins = {}, {}
    for k, L in enumerate(launches):
        for ci, b, key in L["work"]:
            assert seen.setdefault(ci, k) == k, ci
            assert L["geoms"][key] is geoms_of[ci][key[1]]
            bins.setdefault(ci, []).append(b)
    assert bins == {ci: list(cand) for ci, cand, _g in short_call}


@needs_bins
@pytest.mark.parametrize("shards", [1, 3])
def test_std_launches_stay_within_their_budgets(short_call, shards):
    """No launch passes 1,024 rows, 128 x 3,072 padded node-rows or 128 x
    49,152 padded sequence-rows on one card; over a mesh of 3 shards the
    launches hold the same work, padded to whole blocks a shard."""
    from pyrodigal_tpu_torch.parallel import make_mesh

    one = _runner()
    runner = _runner(mesh=make_mesh(devices=["cpu"] * shards))
    launches = runner._pack_std(short_call)
    assert [L["work"] for L in launches] \
        == [L["work"] for L in one._pack_std(short_call)]
    one.close()
    runner.close()
    assert meta_cuda.MAX_ROWS == 1024
    assert meta_cuda.NODE_ROW_BUDGET == 393_216
    assert meta_cuda.SEQ_ROW_BUDGET == 6_291_456
    for L in launches:
        packed, bin_idx, _gidx, _nonsd = runner._std_inputs(L["work"],
                                                            L["geoms"])
        n, S = packed["n32"].shape[2], packed["digits"].shape[1]
        BT = -(-len(L["work"]) // meta_cuda.BLOCK) * meta_cuda.BLOCK
        assert len(bin_idx) == -(-BT // (16 * shards)) * 16 * shards
        assert BT <= 1024 and BT * n <= 393_216 and BT * S <= 6_291_456


@needs_bins
def test_std_launch_buckets_are_the_smallest_rungs(short_call):
    """Each launch's node bucket is the smallest rung that holds its
    largest geometry, and its sequence bucket its longest contig rounded
    up to 1,024 bp; the short call's launches take six or more rungs."""
    ladder = [256, 512, 768, 1024, 1536, 2048, 3072]
    runner = _runner()
    rungs = set()
    for L in runner._pack_std(short_call):
        packed, *_ = runner._std_inputs(L["work"], L["geoms"])
        n, S = packed["n32"].shape[2], packed["digits"].shape[1]
        nn = max(g["nn"] for g in L["geoms"].values())
        slen = max(g["slen"] for g in L["geoms"].values())
        assert n == min(r for r in ladder if r >= nn)
        assert S == min(-(-slen // 1024) * 1024, 49_152)
        rungs.add(n)
    runner.close()
    assert len(rungs) >= 6, rungs


@needs_bins
def test_std_packer_orders_largest_first(short_call):
    """Contigs go out largest first (by their largest geometry's nodes,
    ties by contig index), whatever order they came in."""
    import random

    runner = _runner()
    launches = runner._pack_std(short_call)
    shuffled = list(short_call)
    random.Random(7).shuffle(shuffled)
    again = runner._pack_std(shuffled)
    runner.close()
    order = list(dict.fromkeys(ci for L in launches
                               for ci, _b, _k in L["work"]))
    by = {ci: _largest(runner, cand, geoms)[0]
          for ci, cand, geoms in short_call}
    assert order == sorted(by, key=lambda ci: (-by[ci], ci))
    assert [L["work"] for L in again] == [L["work"] for L in launches]


@needs_bins
def test_std_packer_fills_a_short_assembly_call(short_call):
    """The 511 std contigs of a short-read assembly call take at most 12
    launches, their node-rows at least 45% of the padded ones (56
    launches at 9% with every launch 128 rows of 3,072 nodes)."""
    runner = _runner()
    launches = runner._pack_std(short_call)
    real = padded = 0
    for L in launches:
        _packed, bin_idx, _g, _n = runner._std_inputs(L["work"], L["geoms"])
        n = _packed["n32"].shape[2]
        real += sum(L["geoms"][key]["nn"] for _ci, _b, key in L["work"])
        padded += len(bin_idx) * n
    runner.close()
    assert len(short_call) >= 500
    assert len(launches) <= 12
    assert 100.0 * real / padded >= 45.0


@needs_bins
def test_std_launches_at_several_rungs_match_one_top_launch(data,
                                                             monkeypatch):
    """Four contigs whose largest geometries take node rungs 256, 512,
    768 and 1,536, each launch of its own (rows capped at 16): the genes
    are refcore's, and every (contig, bin) best score lies within a tenth
    of the margin of the one the contig gets in a single launch at the
    top buckets (3,072 nodes, 49,152 bp)."""
    srr = list(parse(data("SRR492066.fna.gz")))[0].seq
    seqs = [srr[:3000], srr[9000:23000], srr[20000:40000],
            list(parse(data("KK037166.fna.gz")))[0].seq]
    p = GeneFinder(meta=True, backend="refcore")
    anchor = [p.find_genes(s) for s in seqs]
    monkeypatch.setattr(meta_cuda, "MAX_ROWS", 16)
    runner = _runner()
    launched = []
    sweep = runner._sweep_std

    def record(work, geoms):
        best = sweep(work, geoms)
        packed, *_ = runner._std_inputs(work, geoms)
        launched.append((packed["n32"].shape[2], work, best))
        return best
    monkeypatch.setattr(runner, "_sweep_std", record)
    outs = runner.find_genes_batch(seqs)
    assert runner.route_counts == {"std": 4, "mega": 0, "c": 0}
    for a, b in zip(anchor, outs):
        _assert_same_genes(a, b)
    assert sorted(n for n, _w, _b in launched) == [256, 512, 768, 1536]

    monkeypatch.setattr(meta_cuda, "MAX_ROWS", 1024)
    monkeypatch.setattr(meta_cuda, "NODE_RUNGS", ())
    monkeypatch.setattr(meta_cuda, "SEQ_STEP", meta_cuda.SEQ_BUCKET)
    items = []
    for ci, s in enumerate(seqs):
        cand, geoms, _nbt, _route = runner._prepare_contig(Sequence(s))
        items.append((ci, cand, geoms))
    (top,) = runner._pack_std(items)
    top_best = sweep(top["work"], top["geoms"])
    runner.close()
    ref = {(ci, b): float(top_best[k])
           for k, (ci, b, _key) in enumerate(top["work"])}
    got = {(ci, b): float(best[k]) for _n, work, best in launched
           for k, (ci, b, _key) in enumerate(work)}
    assert got.keys() == ref.keys()
    for key, r in ref.items():
        assert abs(got[key] - r) <= 0.1 * CudaMetaRunner._margin(r), key
