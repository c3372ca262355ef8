"""Single mode of the port's runner (`CudaMetaRunner(is_meta=False)`, one
bin carrying the trained model) on the CPU, with the plain versions of
the kernels: output bytes (GFF, nucleotide and protein FASTA, the start
score table) against the exact C engine's single mode on both routes,
for a non-SD model, translation table 4, closed ends, masking and the
C-engine route; per-launch best path scores against the JAX package's
`TpuMetaRunner(is_meta=False)` launches on the same model; and, on a
card, `GeneFinder(backend="cuda")` in single mode."""

import io
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyrodigal_tpu  # noqa: E402
import pyrodigal_tpu_torch  # noqa: E402
from pyrodigal_tpu.fasta import parse  # noqa: E402
from pyrodigal_tpu_torch.ops import meta_cuda  # noqa: E402
from pyrodigal_tpu_torch.ops import score_device as tsd  # noqa: E402
from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner  # noqa: E402
from pyrodigal_tpu_torch.sequence import Sequence  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run shares the cores among several pytest workers; torch's
    intra-op thread pool on top of that slows these small ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


class _Bin:
    description = "single"

    def __init__(self, ti):
        self.training_info = ti


def _srr(data):
    return list(parse(data("SRR492066.fna.gz")))[0].seq


def _train(seq, **kw):
    """(the JAX package's TrainingInfo, the port's copy of its bytes):
    trained on the exact C engine, carried into the port by
    `TrainingInfo.load`, so that both packages score one model."""
    finder = pyrodigal_tpu.GeneFinder(backend="refcore")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tinf = finder.train(seq, **kw)
    buf = io.BytesIO()
    tinf.dump(buf)
    buf.seek(0)
    port = pyrodigal_tpu_torch.TrainingInfo.load(buf)
    assert bytes(port.raw) == bytes(tinf.raw)
    return tinf, port


@pytest.fixture(scope="module")
def model(data):
    return _train(_srr(data))


def _outputs(genes, name="contig"):
    """GFF, nucleotide FASTA, protein FASTA and the start score table."""
    out = []
    for write in (genes.write_gff, genes.write_genes,
                  genes.write_translations, genes.write_scores):
        f = io.StringIO()
        write(f, name)
        out.append(f.getvalue())
    return out


def _refcore(tinf, seqs, num_seq=1, **kw):
    finder = pyrodigal_tpu.GeneFinder(training_info=tinf, backend="refcore",
                                      **kw)
    finder._num_seq = num_seq
    return [finder.find_genes(s) for s in seqs]


def _assert_bytes_equal(expected, got):
    assert len(expected) == len(got)
    for a, b in zip(expected, got):
        assert b.meta is False and b.metagenomic_bin is None
        assert _outputs(b) == _outputs(a)


def _single_runner(port_tinf, **kw):
    return CudaMetaRunner([_Bin(port_tinf)], device="cpu", is_meta=False,
                          **kw)


@pytest.mark.parametrize("route", ["mega", "std"])
def test_single_mode_golden_genome(data, model, route, monkeypatch):
    """Port of tests/test_meta.py::test_single_device_matches_c_path: the
    76 genes of SRR492066 (79,939 bp) on each route, byte-equal to the
    exact engine's single mode and to Prodigal's proteins."""
    if route == "mega":
        monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
    else:
        # the JAX test's node_bucket=6144, seq_bucket=81920
        monkeypatch.setattr(meta_cuda, "NODE_BUCKET", 6144)
        monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 81920)
    tinf, port = model
    seq = _srr(data)
    (a,) = _refcore(tinf, [seq])
    runner = _single_runner(port)
    (b,) = runner.find_genes_batch([seq])
    runner.close()
    expected = dict.fromkeys(("std", "mega", "c"), 0)
    expected[route] = 1
    assert runner.route_counts == expected
    assert len(a) == len(b) == 76
    assert all(x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b))
    golden = list(parse(data("SRR492066.single.faa.gz")))
    assert [g.translate() for g in b] == [r.seq for r in golden]
    assert b.training_info is port
    _assert_bytes_equal([a], [b])


# (training keywords, finder keywords, edit of the contig)
CASES = {
    "nonsd": (dict(force_nonsd=True), {}, None),
    "table4": (dict(translation_table=4), {}, None),
    "closed": ({}, dict(closed=True), None),
    "mask": ({}, dict(mask=True),
             lambda s: s[:9000] + "N" * 120 + s[9000:]),
}


@pytest.mark.parametrize("route", ["mega", "std"])
@pytest.mark.parametrize("case", list(CASES))
def test_single_mode_options(data, case, route, monkeypatch):
    """Models and options of single mode that meta mode never runs with
    one bin: a non-SD model (the `has_nonsd` scoring branch with a
    single-bin table), translation table 4 (node extraction by the one
    bin's table), closed ends and masking; bytes equal to the exact
    engine's on a 24,000 bp slice, on each route."""
    train_kw, kw, edit = CASES[case]
    if route == "mega":
        monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
    full = _srr(data)
    tinf, port = _train(full, **train_kw)
    if case == "nonsd":
        assert not tinf.uses_sd and not port.uses_sd
    if case == "table4":
        assert port.translation_table == 4
    seq = full[30000:54000]
    if edit is not None:
        seq = edit(seq)
    expected = _refcore(tinf, [seq], **kw)
    runner = _single_runner(port, **kw)
    got = runner.find_genes_batch([seq])
    runner.close()
    assert runner.route_counts[route] == 1
    assert len(got[0]) > 0
    _assert_bytes_equal(expected, got)


def test_single_mode_c_route(data, model, monkeypatch):
    """A mega geometry the kernel refuses takes the exact engine in single
    mode: a single-mode finder on the runner's model."""
    monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
    monkeypatch.setattr(CudaMetaRunner, "_mega_ok", lambda self, g: False)
    tinf, port = model
    seqs = [_srr(data)[:24000], _srr(data)[40000:64000]]
    expected = _refcore(tinf, seqs, num_seq=3)
    runner = _single_runner(port)
    got = runner.find_genes_batch(seqs, num_seq_start=3)
    runner.close()
    assert runner.route_counts == {"std": 0, "mega": 0, "c": 2}
    assert [g._num_seq for g in got] == [3, 4]
    _assert_bytes_equal(expected, got)


def test_single_mode_short_contigs(data, model):
    """Odd contigs on the std route (empty, nodes but no gene, all-N,
    shorter than a gene, 4 kb) in one call keep their order and
    numbering, and carry the model and the scored nodes even where no
    gene is found, as the exact engine's single mode does.  (The JAX
    package's device single mode returns no model and no nodes for the
    first two, so its `write_gff` raises there: ROADMAP queue 3.)"""
    tinf, port = model
    base = _srr(data)
    seqs = ["", "ACGT" * 20, "N" * 500, base[:90], base[7000:11000],
            base[50000:54000]]
    expected = _refcore(tinf, seqs, num_seq=5)
    assert [len(g) for g in expected][:2] == [0, 0]
    assert len(expected[1].nodes) > 0
    runner = _single_runner(port)
    got = runner.find_genes_batch(seqs, num_seq_start=5)
    runner.close()
    assert runner.route_counts == {"std": 6, "mega": 0, "c": 0}
    assert [g._num_seq for g in got] == [5, 6, 7, 8, 9, 10]
    assert all(g.training_info is port for g in got)
    _assert_bytes_equal(expected, got)


def test_finder_pickles_without_its_runner(data, model):
    """`GeneFinder.__reduce__` carries the model and the options, never
    the single-mode runner (its thread pools cannot be pickled); the
    copy builds its own."""
    import pickle

    _tinf, port = model
    finder = pyrodigal_tpu_torch.GeneFinder(port, backend="refcore",
                                            closed=True)
    finder._single_runner = _single_runner(port, closed=True)
    finder._single_runner_tinf = port
    clone = pickle.loads(pickle.dumps(finder))
    finder._single_runner.close()
    assert clone._single_runner is None
    assert bytes(clone.training_info.raw) == bytes(port.raw)
    assert (clone.backend, clone.closed) == ("refcore", True)
    seq = _srr(data)[:20000]
    assert _outputs(clone.find_genes(seq)) == \
        _outputs(pyrodigal_tpu_torch.GeneFinder(
            port, backend="refcore", closed=True).find_genes(seq))


def _copy(tinf):
    buf = io.BytesIO()
    tinf.dump(buf)
    buf.seek(0)
    return pyrodigal_tpu_torch.TrainingInfo.load(buf)


def test_finder_single_mode_routes_through_runner(data, model, monkeypatch):
    """`GeneFinder` on the "cuda" backend, its runner moved to the CPU:
    single-mode calls go through one runner, bytes equal to the exact
    engine's; the runner records its launches' one-row best scores
    against the exact ones within a tenth of the winner margin; a new
    model builds a new runner, and the one it replaces is closed once
    the calls running on it have returned."""
    monkeypatch.setattr(
        meta_cuda, "CudaMetaRunner",
        lambda bins, device, **kw: CudaMetaRunner(bins, device="cpu", **kw))
    tinf, port = model
    srr = _srr(data)
    seqs = [srr[:12000], srr[12000:24000]]
    finder = pyrodigal_tpu_torch.GeneFinder(port, backend="refcore")
    finder.backend = "cuda"
    got = [finder.find_genes(seqs[0])] + finder.find_genes_batch(seqs[1:])
    first = finder._single_runner
    assert first.route_counts == {"std": 2, "mega": 0, "c": 0}
    assert first.single_drift["pairs"] == 2
    assert 0.0 < first.single_drift["margin_ratio"] <= 1.0
    assert finder._single_calls == {}
    _assert_bytes_equal(_refcore(tinf, seqs), got)

    # a call still running on the old runner keeps it open
    held = finder._get_single_runner()
    assert held is first
    finder.training_info = _copy(port)
    (again,) = finder.find_genes_batch(seqs[:1])
    assert finder._single_runner is not first
    first.pool.submit(int).result()
    finder._release_single_runner(held)
    with pytest.raises(RuntimeError):
        first.pool.submit(int)
    assert finder._single_calls == {}
    assert _outputs(again) == _outputs(_refcore(tinf, seqs[:1], num_seq=3)[0])
    finder._single_runner.close()


def _jax_tables(jr, pr):
    """The JAX runner's stacked tables, checked equal to the port's own
    and carried into the port's runner (`BinTables.from_numpy`)."""
    arrays = tuple(np.asarray(a) for a in jr.tables.as_tuple())
    for name, a, b in zip(tsd.TABLE_NAMES, arrays, pr.tables.as_tuple()):
        assert np.array_equal(a, b.numpy()), name
    pr.tables = tsd.BinTables.from_numpy(arrays)


def _check_best(ref, got):
    """Per-launch best path scores within a tenth of the exact engine's
    winner margin, and relatively within 1e-4 (see
    tests/test_torch_meta.py: the dc prefix sums round differently)."""
    worst = 0.0
    for r, g in zip(ref, got):
        r, g = float(r), float(g)
        assert r > 0
        assert abs(g - r) <= 0.1 * CudaMetaRunner._margin(r), (r, g)
        worst = max(worst, abs(g - r) / abs(r))
    assert worst < 1e-4


@pytest.mark.parametrize("nonsd", [False, True], ids=["sd", "nonsd"])
def test_best_scores_match_jax_single_std_launch(data, nonsd):
    """One std launch of single mode (KK037166 and 24,000 bp of SRR492066,
    one row each) against the JAX package's `is_meta=False` launch."""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    tinf, port = _train(_srr(data), force_nonsd=nonsd)
    seqs = [list(parse(data("KK037166.fna.gz")))[0].seq, _srr(data)[:24000]]
    jr = TpuMetaRunner([_Bin(tinf)], is_meta=False, interpret=True,
                       node_bucket=1536, seq_bucket=24576, batch_size=16)
    pr = _single_runner(port)
    _jax_tables(jr, pr)
    items = []
    for ci, s in enumerate(seqs):
        cand, geoms, _nbt, route = pr._prepare_contig(Sequence(s))
        assert route == "std" and cand == [0]
        items.append((ci, cand, geoms))
    (launch,) = pr._pack_std(items)
    work, geoms = launch["work"], launch["geoms"]
    assert len(work) == 2
    j_best = np.asarray(jr._sweep(work, geoms, {0: 0, 1: 1})).view(
        np.float32)
    p_best = pr._sweep_std(work, geoms)
    pr.close()
    assert p_best.shape == (16,)
    _check_best(j_best[:2], p_best[:2])


def test_best_scores_match_jax_single_mega_launch(data, model):
    """One packed mega launch of single mode (three slices, one row each,
    padded to 8 rows) against the JAX package's `is_meta=False` launch.
    (The non-SD model's scoring is held against JAX on the std launch;
    a second mega variant would cost the JAX interpreter another ~45 s
    of compilation.)"""
    pytest.importorskip("jax")
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    srr = _srr(data)
    tinf, port = model
    miij = list(parse(data("MIIJ01000039.fna.gz")))[0].seq
    contigs = [srr[:30000], miij[:24000], srr[30000:54000]]
    jr = TpuMetaRunner([_Bin(tinf)], is_meta=False, interpret=True,
                       seq_bucket=2048)
    pr = _single_runner(port)
    _jax_tables(jr, pr)
    j_items, p_items = [], []
    for i, c in enumerate(contigs):
        seq = Sequence(c)
        for runner, items in ((jr, j_items), (pr, p_items)):
            cand, geoms, _nbt, _route = runner._prepare_contig(seq)
            assert cand == [0]
            items.append({"ci": i, "g": geoms[11], "rows": cand})
    (j_group,) = jr._group_mega(j_items)
    (p_group,) = pr._group_mega(p_items)
    dev, j_rows, CP, B = jr._sweep_mega_multi(j_group["items"])
    j_best = np.asarray(dev).view(np.float32).reshape(CP, B)
    p_best, p_rows, CP2, B2 = pr._sweep_mega_multi(p_group["items"])
    pr.close()
    assert (p_rows, CP2, B2) == (j_rows, CP, B) == ([0], 4, 8)
    _check_best(j_best[:3, 0], p_best[:3, 0])


# -- on a card ----------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_single_mode_matches_refcore(data, cuda_device):
    """`GeneFinder(backend="cuda")` trains (on the C engine) and calls
    single mode through the runner: bytes equal to refcore single mode,
    for `find_genes` and `find_genes_batch`, with the numbering of one
    finder's calls."""
    srr = _srr(data)
    seqs = [srr, list(parse(data("KK037166.fna.gz")))[0].seq, srr[:3000]]
    ref = pyrodigal_tpu_torch.GeneFinder(backend="refcore")
    gpu = pyrodigal_tpu_torch.GeneFinder(backend="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref.train(srr)
        gpu.train(srr)
    assert bytes(gpu.training_info.raw) == bytes(ref.training_info.raw)
    expected = [ref.find_genes(s) for s in seqs + seqs]
    got = [gpu.find_genes(s) for s in seqs] + gpu.find_genes_batch(seqs)
    assert gpu._single_runner is not None
    assert gpu._single_runner.device.type == "cuda"
    assert [g._num_seq for g in got] == list(range(1, 7))
    _assert_bytes_equal(expected, got)


@pytest.mark.cuda
def test_cuda_single_runner_rebuilt_after_retrain(data, cuda_device):
    srr = _srr(data)
    gpu = pyrodigal_tpu_torch.GeneFinder(backend="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gpu.train(srr)
        gpu.find_genes(srr[:20000])
        first = gpu._single_runner
        gpu.find_genes(srr[20000:40000])
        assert gpu._single_runner is first
        tinf = gpu.train(srr, force_nonsd=True)
    got = gpu.find_genes(srr[:20000])
    assert gpu._single_runner is not first
    assert gpu._single_runner.bins[0].training_info is tinf
    (expected,) = _refcore(tinf, [srr[:20000]], num_seq=3)
    _assert_bytes_equal([expected], [got])


@pytest.mark.cuda
def test_cuda_single_mode_threads(data, cuda_device):
    """Two threads calling one finder's `find_genes` (the CLI's `-j 2`)
    give the genes of one thread, each call its own number (the order in
    which the threads take numbers is theirs, as on the C engine)."""
    from multiprocessing.pool import ThreadPool

    srr = _srr(data)
    seqs = [srr[k:k + 15000] for k in range(0, 75000, 15000)]
    outs = []
    for jobs in (1, 2):
        gpu = pyrodigal_tpu_torch.GeneFinder(backend="cuda")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            gpu.train(srr)
        if jobs == 1:
            got = [gpu.find_genes(s) for s in seqs]
        else:
            with ThreadPool(2) as pool:
                got = pool.map(gpu.find_genes, seqs, chunksize=1)
        assert sorted(g._num_seq for g in got) == \
            list(range(1, len(seqs) + 1))
        for g in got:
            g._num_seq = 0
        outs.append([_outputs(g) for g in got])
    assert outs[0] == outs[1]
