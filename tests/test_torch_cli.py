"""The port's command line (`pyrodigal_tpu_torch.cli`, `python -m
pyrodigal_tpu_torch`), the twin of tests/test_cli.py: every CPU case
runs with `--backend refcore`; the default backend needs a card and
fails without one; the byte-equal pairs of the device pipeline against
the exact C engine run on a card."""

import gzip
import io
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import pyrodigal_tpu.cli  # noqa: E402
from pyrodigal_tpu_torch import GeneFinder, METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu_torch.cli import main  # noqa: E402
from pyrodigal_tpu_torch.fasta import parse  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built",
)
# the CLI trains on the 80 kb contig, under the ideal training length
short_training = pytest.mark.filterwarnings(
    "ignore:sequence should be at least")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _run(argv, stdin_text=None, entry=main):
    out = io.StringIO()
    err = io.StringIO()
    stdin = io.StringIO(stdin_text or "")
    stdin.isatty = lambda: stdin_text is None
    rc = entry(argv, stdout=out, stderr=err, stdin=stdin)
    return rc, out.getvalue(), err.getvalue()


def _refcore(argv, **kw):
    return _run([*argv, "--backend", "refcore"], **kw)


def _gene_lines(out):
    return [ln for ln in out.splitlines() if ln and not ln.startswith("#")]


@short_training
def test_single_mode_gff_matches_api(data):
    path = data("SRR492066.fna.gz")
    rc, out, err = _refcore(["-i", path, "-p", "single"])
    assert rc == 0, err
    lines = _gene_lines(out)

    record = list(parse(path))[0]
    finder = GeneFinder(backend="refcore")
    finder.train(record.seq)
    genes = finder.find_genes(record.seq)
    assert len(lines) == len(genes) == 76
    for ln, gene in zip(lines, genes):
        cols = ln.split("\t")
        assert cols[2] == "CDS"
        assert int(cols[3]) == gene.begin
        assert int(cols[4]) == gene.end
        assert cols[6] == "+-"[gene.strand == -1]


@short_training
def test_single_mode_writers(data, tmp_path):
    path = data("SRR492066.fna.gz")
    nuc = tmp_path / "genes.fna"
    prot = tmp_path / "prots.faa"
    scores = tmp_path / "starts.tsv"
    gff = tmp_path / "out.gff"
    rc, out, err = _refcore([
        "-i", path, "-p", "single", "-o", str(gff), "-d", str(nuc),
        "-a", str(prot), "-s", str(scores),
    ])
    assert rc == 0, err
    assert out == ""
    assert gff.read_text().startswith("##gff-version  3")
    assert nuc.read_text().startswith(">")
    assert prot.read_text().startswith(">")
    assert scores.read_text()
    golden = list(parse(data("SRR492066.single.faa.gz")))
    got = list(parse(str(prot)))
    assert [r.seq for r in got] == [r.seq for r in golden]


@short_training
@pytest.mark.parametrize("mode", ["single", "meta"])
def test_refcore_bytes_equal_the_jax_package_cli(data, tmp_path, mode):
    """The port's CLI on the exact engine writes the JAX package's CLI
    bytes, all four writers and `-f gbk`."""
    path = data("SRR492066.fna.gz")
    outs = {}
    for name, entry in (("port", main), ("jax", pyrodigal_tpu.cli.main)):
        d = tmp_path / name
        d.mkdir()
        rc, out, err = _refcore([
            "-i", path, "-p", mode, "-f", "gbk", "-d", str(d / "n.fna"),
            "-a", str(d / "p.faa"), "-s", str(d / "sc.tsv")], entry=entry)
        assert rc == 0, err
        outs[name] = (out, *((d / f).read_text()
                             for f in ("n.fna", "p.faa", "sc.tsv")))
    assert outs["port"] == outs["jax"]


@short_training
def test_training_file_roundtrip(data, tmp_path):
    path = data("SRR492066.fna.gz")
    tfile = tmp_path / "model.trn"
    rc1, out1, err1 = _refcore(["-i", path, "-t", str(tfile)])
    assert rc1 == 0, err1
    assert tfile.exists() and tfile.stat().st_size == 558392
    rc2, out2, err2 = _refcore(["-i", path, "-t", str(tfile)])
    assert rc2 == 0, err2
    assert out1 == out2


def test_training_file_rejected_in_meta(data, tmp_path):
    tfile = tmp_path / "model.trn"
    tfile.write_bytes(b"")
    rc, out, err = _refcore(["-i", data("SRR492066.fna.gz"), "-p", "meta",
                             "-t", str(tfile)])
    assert rc == 1
    assert "cannot specify metagenomic" in err


@needs_bins
def test_meta_mode_matches_api(data):
    path = data("SRR492066.fna.gz")
    rc, out, err = _refcore(["-i", path, "-p", "meta"])
    assert rc == 0, err
    record = list(parse(path))[0]
    genes = GeneFinder(meta=True, backend="refcore").find_genes(record.seq)
    assert len(_gene_lines(out)) == len(genes) > 0


@short_training
def test_plain_and_stdin_input(data, tmp_path):
    """A plain-text file and the same text on standard input give the
    gzip file's output."""
    src = data("SRR492066.fna.gz")
    plain = tmp_path / "seq.fna"
    with gzip.open(src, "rt") as f:
        text = f.read()
    plain.write_text(text)
    rc1, out1, _ = _refcore(["-i", str(plain), "-p", "single"])
    rc2, out2, _ = _refcore(["-i", src, "-p", "single"])
    rc3, out3, err3 = _refcore(["-p", "single"], stdin_text=text)
    assert rc1 == rc2 == rc3 == 0, err3
    assert out1 == out2 == out3
    assert len(_gene_lines(out1)) == 76


def test_bad_input_returns_errno(tmp_path):
    rc, out, err = _refcore(["-i", str(tmp_path / "missing.fna")])
    assert rc != 0
    assert "Error" in err


@short_training
def test_jobs_thread_pool(data):
    """-j/--pool must parallelize over contigs without changing output."""
    path = data("SRR492066.fna.gz")
    rc1, out1, err1 = _refcore(["-i", path, "-p", "single"])
    rc2, out2, err2 = _refcore(["-i", path, "-p", "single", "-j", "2",
                                "--pool", "thread"])
    assert rc1 == rc2 == 0
    assert out1 == out2


@short_training
def test_jobs_process_pool(data):
    """--pool process starts its workers by spawning (a forked child
    cannot use the CUDA state its parent initialised); the finder
    reaches them pickled.  The genes are one process's, and the bytes
    the JAX package's CLI writes with its process pool (a pickled finder
    numbers its contigs from 1 in every task, as there)."""
    record = list(parse(data("SRR492066.fna.gz")))[0]
    text = "".join(f">{record.id}_{k}\n{record.seq[k * 20000:][:20000]}\n"
                   for k in range(4))
    argv = ["-p", "single", "-j", "2", "--pool", "process"]
    rc1, out1, err1 = _refcore(["-p", "single"], stdin_text=text)
    rc2, out2, err2 = _refcore(argv, stdin_text=text)
    rc3, out3, err3 = _refcore(argv, stdin_text=text,
                               entry=pyrodigal_tpu.cli.main)
    assert rc1 == rc2 == rc3 == 0, err1 + err2 + err3
    assert _gene_lines(out1) == _gene_lines(out2)
    assert out1.count("# Sequence Data") == 4
    assert out2 == out3


@pytest.mark.parametrize("token", ["jax", "detect"])
def test_jax_backend_tokens_rejected(data, token, capsys):
    with pytest.raises(SystemExit) as exc:
        _run(["-i", data("SRR492066.fna.gz"), "--backend", token])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["single", "meta"])
def test_default_backend_needs_a_card(data, mode):
    """No quiet CPU run: without a card the default backend reports the
    missing CUDA device and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = _run(["-i", data("SRR492066.fna.gz"), "-p", mode])
    assert rc != 0
    assert err.startswith("Error: ") and "CUDA" in err
    assert out == ""


def test_module_entry_version():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "pyrodigal_tpu_torch",
                        "--version"], env=env, cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    from pyrodigal_tpu_torch import __version__

    assert r.stdout.strip() == f"pyrodigal_tpu_torch v{__version__}"


def test_help_says_single_mode_is_not_accelerated(capsys):
    with pytest.raises(SystemExit) as exc:
        _run(["--help"])
    assert exc.value.code == 0
    text = " ".join(capsys.readouterr().out.split())
    assert "{cuda,refcore}" in text
    assert "Single mode is not accelerated" in text


# -- on a card ----------------------------------------------------------------

def _all_writers(tmp_path, argv):
    outs = {}
    for backend in ("refcore", "cuda"):
        d = tmp_path / backend
        d.mkdir()
        rc, out, err = _run([*argv, "--backend", backend,
                             "-d", str(d / "n.fna"), "-a", str(d / "p.faa"),
                             "-s", str(d / "sc.tsv")])
        assert rc == 0, err
        outs[backend] = (out, *((d / f).read_text()
                                for f in ("n.fna", "p.faa", "sc.tsv")))
    return outs


@pytest.mark.cuda
@short_training
@pytest.mark.parametrize("fmt", ["gff", "gbk"])
def test_cuda_single_mode_all_writers_byte_equal(data, tmp_path, fmt,
                                                 cuda_device):
    outs = _all_writers(tmp_path, ["-i", data("SRR492066.fna.gz"), "-p",
                                   "single", "-f", fmt])
    assert outs["cuda"] == outs["refcore"]
    assert len(_gene_lines(outs["cuda"][0])) > 0


@pytest.mark.cuda
@needs_bins
@pytest.mark.parametrize("fmt", ["gff", "gbk"])
def test_cuda_meta_mode_all_writers_byte_equal(data, tmp_path, fmt,
                                               cuda_device):
    outs = _all_writers(tmp_path, ["-i", data("MIIJ01000039.fna.gz"), "-p",
                                   "meta", "-f", fmt])
    assert outs["cuda"] == outs["refcore"]


@pytest.mark.cuda
@short_training
def test_cuda_jobs_process_pool(data, cuda_device):
    """Spawned workers each reach the card with their own runner."""
    record = list(parse(data("SRR492066.fna.gz")))[0]
    text = "".join(f">{record.id}_{k}\n{record.seq[k * 20000:][:20000]}\n"
                   for k in range(4))
    argv = ["-p", "single", "-j", "2", "--pool", "process"]
    rc1, out1, err1 = _refcore(argv, stdin_text=text)
    rc2, out2, err2 = _run(argv, stdin_text=text)
    assert rc1 == rc2 == 0, err1 + err2
    assert out1 == out2


@pytest.mark.cuda
@short_training
def test_cuda_jobs_thread_pool(data, cuda_device):
    path = data("SRR492066.fna.gz")
    rc1, out1, err1 = _run(["-i", path, "-p", "single"])
    rc2, out2, err2 = _run(["-i", path, "-p", "single", "-j", "2",
                            "--pool", "thread"])
    assert rc1 == rc2 == 0, err1 + err2
    assert out1 == out2
