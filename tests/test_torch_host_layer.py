"""The port's own copy of the host layer (sequence, nodes, genes,
training, metagenomic bins, FASTA, the refcore C engine) against the JAX
package's: output bytes, node arrays and trained models equal."""

import io
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyrodigal_tpu  # noqa: E402
import pyrodigal_tpu_torch  # noqa: E402
from pyrodigal_tpu.fasta import parse as ref_parse  # noqa: E402
from pyrodigal_tpu_torch.fasta import parse as port_parse  # noqa: E402

NODE_FIELDS = ("ndx", "stop_val", "type", "strand", "edge", "gc_cont",
               "star_ptr")


def _seq(pkg_parse, data, name, lo=0, hi=None):
    return list(pkg_parse(data(name)))[0].seq[lo:hi]


def _outputs(genes, name):
    streams = []
    for write in (genes.write_gff, genes.write_genes,
                  genes.write_translations):
        f = io.StringIO()
        write(f, name)
        streams.append(f.getvalue().encode())
    return streams


def _single(pkg, seq):
    finder = pkg.GeneFinder(backend="refcore")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        finder.train(seq)
    return finder, finder.find_genes(seq)


def _case_single(data):
    """SRR492066, single mode trained on itself: GFF, FNA, FAA."""
    a = _single(pyrodigal_tpu, _seq(ref_parse, data, "SRR492066.fna.gz"))[1]
    b = _single(pyrodigal_tpu_torch,
                _seq(port_parse, data, "SRR492066.fna.gz"))[1]
    assert len(a) > 50
    return _outputs(a, "srr"), _outputs(b, "srr")


def _case_meta(data):
    """SRR492066 in meta mode: GFF, FNA, FAA."""
    seq = _seq(ref_parse, data, "SRR492066.fna.gz")
    assert seq == _seq(port_parse, data, "SRR492066.fna.gz")
    a = pyrodigal_tpu.GeneFinder(meta=True, backend="refcore") \
        .find_genes(seq)
    b = pyrodigal_tpu_torch.GeneFinder(meta=True, backend="refcore") \
        .find_genes(seq)
    assert len(a) > 50
    return _outputs(a, "srr"), _outputs(b, "srr")


def _case_masked(data):
    """A 40 kb slice of MIIJ01000039 across the start of its N run, meta
    mode with masking: GFF, FNA, FAA."""
    lo, hi = 363781, 403781
    seq = _seq(ref_parse, data, "MIIJ01000039.fna.gz", lo, hi)
    assert "N" * 100 in seq
    assert seq == _seq(port_parse, data, "MIIJ01000039.fna.gz", lo, hi)
    a = pyrodigal_tpu.GeneFinder(meta=True, mask=True, backend="refcore") \
        .find_genes(seq)
    b = pyrodigal_tpu_torch.GeneFinder(meta=True, mask=True,
                                       backend="refcore").find_genes(seq)
    assert len(a) > 10
    return _outputs(a, "miij"), _outputs(b, "miij")


def _case_nodes(data):
    """Node arrays after extraction and sorting on SRR492066 (tables 11
    and 4)."""
    seq = _seq(ref_parse, data, "SRR492066.fna.gz")
    got = []
    for pkg in (pyrodigal_tpu, pyrodigal_tpu_torch):
        s = pkg.Sequence(seq)
        fields = []
        for tt in (11, 4):
            nodes = pkg.Nodes()
            nodes.extract(s, translation_table=tt)
            nodes.sort()
            assert nodes.length > 1000
            fields += [getattr(nodes, f)[:nodes.length].tobytes()
                       for f in NODE_FIELDS]
        got.append(fields)
    return got


def _case_training(data):
    """`TrainingInfo.raw` after training on SRR492066."""
    seq = _seq(ref_parse, data, "SRR492066.fna.gz")
    a = _single(pyrodigal_tpu, seq)[0].training_info
    b = _single(pyrodigal_tpu_torch, seq)[0].training_info
    assert type(b).__module__ == "pyrodigal_tpu_torch.training"
    return [np.asarray(a.raw).tobytes()], [np.asarray(b.raw).tobytes()]


CASES = {
    "single_trained": _case_single,
    "meta": _case_meta,
    "meta_masked_slice": _case_masked,
    "node_arrays": _case_nodes,
    "training_raw": _case_training,
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_layer_equals_reference(data, case):
    ref, port = CASES[case](data)
    assert len(ref) == len(port) > 0
    for k, (x, y) in enumerate(zip(ref, port)):
        assert x == y, f"{case}: stream {k} differs"


def test_port_uses_its_own_modules():
    """The port's public names are its own copies, and its engine is built
    outside the package's source tree."""
    from pyrodigal_tpu_torch import _native

    for name in ("Sequence", "Nodes", "Genes", "TrainingInfo",
                 "MetagenomicBins", "GeneFinder"):
        assert getattr(pyrodigal_tpu_torch, name).__module__.startswith(
            "pyrodigal_tpu_torch.")
    assert pyrodigal_tpu_torch.__version__ == pyrodigal_tpu.__version__
    assert _native.lib._name.startswith(_native.BUILD_DIR)
    assert len(pyrodigal_tpu_torch.METAGENOMIC_BINS) == \
        len(pyrodigal_tpu.METAGENOMIC_BINS)
