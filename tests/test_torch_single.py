"""Single mode of the port's `GeneFinder`: it runs the exact C engine on
every backend, so on ``backend="cuda"`` it builds no runner and its
output bytes (GFF, nucleotide and protein FASTA, the start score table)
are the exact engine's, with the numbering of one finder's calls; a
pickled finder carries its model and options, never a runner; and, on a
card, `GeneFinder(backend="cuda")` trains and calls single mode."""

import io
import warnings

import pytest

torch = pytest.importorskip("torch")

import pyrodigal_tpu  # noqa: E402
import pyrodigal_tpu_torch  # noqa: E402
from pyrodigal_tpu.fasta import parse  # noqa: E402
from pyrodigal_tpu_torch.ops import meta_cuda  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _srr(data):
    return list(parse(data("SRR492066.fna.gz")))[0].seq


def _train(seq):
    """(the JAX package's TrainingInfo, the port's copy of its bytes):
    trained on the exact C engine, carried into the port by
    `TrainingInfo.load`, so that both packages score one model."""
    finder = pyrodigal_tpu.GeneFinder(backend="refcore")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tinf = finder.train(seq)
    buf = io.BytesIO()
    tinf.dump(buf)
    buf.seek(0)
    port = pyrodigal_tpu_torch.TrainingInfo.load(buf)
    assert bytes(port.raw) == bytes(tinf.raw)
    return tinf, port


@pytest.fixture(scope="module")
def model(data):
    return _train(_srr(data))


def _outputs(genes):
    """GFF, nucleotide FASTA, protein FASTA and the start score table."""
    out = []
    for write in (genes.write_gff, genes.write_genes,
                  genes.write_translations, genes.write_scores):
        f = io.StringIO()
        write(f, "contig")
        out.append(f.getvalue())
    return out


def _refcore(tinf, seqs):
    finder = pyrodigal_tpu.GeneFinder(training_info=tinf, backend="refcore")
    return [finder.find_genes(s) for s in seqs]


def _assert_bytes_equal(expected, got):
    assert len(expected) == len(got)
    for a, b in zip(expected, got):
        assert b.meta is False and b.metagenomic_bin is None
        assert _outputs(b) == _outputs(a)


def test_finder_pickles_without_its_runner(data, model):
    """`GeneFinder.__reduce__` carries the model and the options, never
    the runner (its thread pools cannot be pickled); the copy builds its
    own."""
    import pickle

    _tinf, port = model
    finder = pyrodigal_tpu_torch.GeneFinder(port, backend="refcore",
                                            closed=True)
    finder._meta_runner = meta_cuda.CudaMetaRunner(
        pyrodigal_tpu_torch.METAGENOMIC_BINS, device="cpu", closed=True)
    clone = pickle.loads(pickle.dumps(finder))
    finder._meta_runner.close()
    assert clone._meta_runner is None
    assert bytes(clone.training_info.raw) == bytes(port.raw)
    assert (clone.backend, clone.closed) == ("refcore", True)
    seq = _srr(data)[:20000]
    assert _outputs(clone.find_genes(seq)) == \
        _outputs(pyrodigal_tpu_torch.GeneFinder(
            port, backend="refcore", closed=True).find_genes(seq))


def test_single_mode_never_builds_a_runner(data, model, monkeypatch):
    """`GeneFinder` on the "cuda" backend in single mode runs the exact
    engine and builds no runner: `find_genes` and `find_genes_batch` give
    the exact engine's bytes from all four writers, numbered as one
    finder's calls."""
    def refuse(*_a, **_kw):
        raise AssertionError("single mode built a runner")

    monkeypatch.setattr(meta_cuda, "CudaMetaRunner", refuse)
    tinf, port = model
    srr = _srr(data)
    seqs = [srr[:12000], srr[12000:24000], srr[24000:36000]]
    finder = pyrodigal_tpu_torch.GeneFinder(port, backend="refcore")
    finder.backend = "cuda"
    got = [finder.find_genes(seqs[0])] + finder.find_genes_batch(seqs[1:])
    assert finder._meta_runner is None
    assert [g._num_seq for g in got] == [1, 2, 3]
    assert all(len(g) > 0 for g in got)
    _assert_bytes_equal(_refcore(tinf, seqs), got)


# -- on a card ----------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_single_mode_matches_refcore(data, cuda_device):
    """`GeneFinder(backend="cuda")` trains and calls single mode on the C
    engine, with no runner: bytes equal to refcore single mode, for
    `find_genes` and `find_genes_batch`, with the numbering of one
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
    assert gpu._meta_runner is None
    assert [g._num_seq for g in got] == list(range(1, 7))
    _assert_bytes_equal(expected, got)


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
