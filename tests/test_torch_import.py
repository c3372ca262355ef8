"""The PyTorch/CUDA port imports torch, and neither jax nor the JAX
package, and its backends resolve as documented: on the card unless the
caller asks for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = pathlib.Path(REPO, "pyrodigal_tpu_torch")


# an import of jax or of the JAX package (`pyrodigal_tpu`, never matching
# `pyrodigal_tpu_torch`)
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|pyrodigal_tpu)\b(?!_)",
                       re.M)


def test_port_sources_never_import_jax():
    sources = list(PKG.rglob("*.py")) + [
        pathlib.Path(REPO, "chip_smoke.py"),
        pathlib.Path(REPO, "scripts", "profile_torch_meta.py"),
        pathlib.Path(REPO, "scripts", "ab_dp_kernels.py"),
        pathlib.Path(REPO, "scripts", "ab_prefix_kernels.py")]
    assert len(sources) >= 17
    offenders = [str(p) for p in sources
                 if FORBIDDEN.search(p.read_text())]
    assert offenders == []
    # the pattern catches both packages and spares the port's own name
    assert FORBIDDEN.search("from pyrodigal_tpu.fasta import parse")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from pyrodigal_tpu_torch import GeneFinder")


def test_import_and_mega_launch_with_jax_blocked():
    """With jax and the JAX package unimportable, the port imports and
    runs meta-mode batches through a CPU std launch and a CPU mega launch
    (plain versions of the kernels)."""
    probe = (
        "import sys, importlib.abc\n"
        "class _Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'pyrodigal_tpu'):\n"
        "            raise ImportError(name + ' blocked for test')\n"
        "sys.meta_path.insert(0, _Block())\n"
        "sys.modules.pop('jax', None)\n"
        "import pyrodigal_tpu_torch\n"
        "from pyrodigal_tpu_torch.ops import meta_cuda\n"
        "from pyrodigal_tpu_torch.fasta import parse\n"
        "seq = list(parse(sys.argv[1]))[0].seq[:6000]\n"
        "r = meta_cuda.CudaMetaRunner(pyrodigal_tpu_torch.METAGENOMIC_BINS,\n"
        "                             device='cpu')\n"
        "std = r.find_genes_batch([seq])[0]\n"
        "meta_cuda.SEQ_BUCKET = 2048\n"
        "mega = r.find_genes_batch([seq])[0]\n"
        "assert 'jax' not in sys.modules\n"
        "assert 'pyrodigal_tpu' not in sys.modules\n"
        "same = [g._gene_data(1) for g in std] == "
        "[g._gene_data(1) for g in mega]\n"
        "print(r.route_counts['std'], r.route_counts['mega'], len(std) > 0,"
        " same)\n"
    )
    # one intra-op thread: the test run shares the cores among its workers
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONNOUSERSITE="1",
               OMP_NUM_THREADS="1")
    data = os.path.join(REPO, "tests", "data", "SRR492066.fna.gz")
    r = subprocess.run([sys.executable, "-c", probe, data], env=env,
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["1", "1", "True", "True"]


def test_backend_resolution():
    """"cuda" is the default in both modes and needs a card; "refcore" is
    the only way to the CPU; the JAX package's "detect" and "jax" tokens
    are gone."""
    from pyrodigal_tpu_torch import GeneFinder

    for kw in ({"meta": True}, {}):
        if torch.cuda.is_available():
            assert GeneFinder(**kw).backend == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                GeneFinder(**kw)
            with pytest.raises(RuntimeError, match="CUDA"):
                GeneFinder(**kw, backend="cuda")
    assert GeneFinder(backend="refcore", meta=True).backend == "refcore"
    assert GeneFinder(backend="refcore").backend == "refcore"
    for token in ("detect", "jax"):
        with pytest.raises(ValueError, match="backend"):
            GeneFinder(meta=True, backend=token)


def test_detect_without_card_matches_refcore(data):
    """Without a card the port's default GeneFinder raises rather than
    run on the CPU; asked for explicitly, its "refcore" backend is
    byte-equal to the reference package's exact engine."""
    import pyrodigal_tpu
    import pyrodigal_tpu_torch
    from pyrodigal_tpu.fasta import parse

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pyrodigal_tpu_torch.GeneFinder(meta=True)
    seq = list(parse(data("SRR492066.fna.gz")))[0].seq[:20000]
    a = pyrodigal_tpu.GeneFinder(meta=True, backend="refcore").find_genes(
        seq)
    b = pyrodigal_tpu_torch.GeneFinder(meta=True, backend="refcore") \
        .find_genes(seq)
    assert len(a) == len(b) > 0
    assert all(x._gene_data(1) == y._gene_data(1) for x, y in zip(a, b))
