"""The reference (`reference/plain.py`, `reference/writer.py`) against
the port's exact C engine on the CPU: the same candidate bins, the best
path score of each to float64 rounding, and the same GFF, protein FASTA
and nucleotide FASTA bytes, on contigs of both genomes, both strands and
both translation tables, short contigs (meta mode's short-contig rules)
to long ones.  The reference itself imports nothing of the port or JAX."""

import ast
import io
import os

import numpy as np
import pytest

from genebench import generate
from genebench.check import normalise
from genebench.reference import engine, plain

OPTS = {"closed": False, "mask": False, "min_mask": 50, "min_gene": 90,
        "min_edge_gene": 60, "max_overlap": 60}
GCF = "GCF_001457455.1_NCTC11397_genomic.fna.gz"
MIIJ = "MIIJ01000039.fna.gz"


def _exact_scores(s):
    """{bin: best score} of the port's exact engine, bin by bin."""
    from pyrodigal_tpu_torch.metagenomic import METAGENOMIC_BINS
    from pyrodigal_tpu_torch.nodes import Nodes
    from pyrodigal_tpu_torch.sequence import Sequence

    seq = Sequence(s)
    out, nodes = {}, {}
    for b in plain.candidates(seq.gc, engine.Reference(OPTS).bins):
        tinf = METAGENOMIC_BINS[b].training_info
        tt = tinf.translation_table
        if tt not in nodes:
            nodes[tt] = Nodes()
            nodes[tt].extract(seq, translation_table=tt, closed=False,
                              min_gene=90, min_edge_gene=60)
            nodes[tt].sort()
        nd = nodes[tt].copy()
        nd.reset_scores()
        nd.score_nodes(seq, tinf, closed=False, is_meta=True)
        nd.record_overlapping_starts(tinf, 1, 60)
        ipath = nd.dynamic_programming(tinf, final=True)
        out[b] = float(nd.score[ipath]) if ipath >= 0 else None
    return out


def _exact_texts(name, s):
    from pyrodigal_tpu_torch import GeneFinder

    genes = GeneFinder(meta=True, backend="refcore").find_genes(s)
    files = []
    for write in (genes.write_gff, genes.write_translations,
                  genes.write_genes):
        buf = io.StringIO()
        write(buf, name)
        files.append(normalise(buf.getvalue()))
    return tuple(files)


CASES = [(GCF, 700), (GCF, 1400), (GCF, 2900), (GCF, 8000), (GCF, 60000),
         (MIIJ, 1100), (MIIJ, 5000), (MIIJ, 40000)]


@pytest.mark.parametrize("source,length", CASES)
@pytest.mark.parametrize("strand", [1, -1])
def test_plain_scores_and_genes_equal_the_exact_engine(source, length,
                                                       strand):
    rng = np.random.default_rng(length + (strand > 0))
    g = generate.read_source(source)
    while True:
        o = int(rng.integers(0, len(g) - length))
        s = g[o:o + length]
        if s.count("N") < length // 10:
            break
    if strand < 0:
        s = generate.revcomp(s)
    ref = engine.Reference(OPTS)
    got, files = ref.call("ctg", s, 1)
    want = _exact_scores(s)
    assert list(got) == list(want) and got
    for b, x in want.items():
        if x is None:
            assert got[b] is None
        else:
            assert got[b] == pytest.approx(x, rel=1e-9, abs=1e-9), b
    assert tuple(map(normalise, files)) == _exact_texts("ctg", s)
    assert files[0].count("\tCDS\t") > 0 or length < 1500


def test_bf16_control_departs():
    s = generate.read_source(GCF)[:20000]
    ref = engine.Reference(OPTS)
    a, b = ref.scores(s), ref.scores(s, "bf16")
    assert a.keys() == b.keys()
    assert max(abs(a[k] - b[k]) for k in a) > 1e-3


@pytest.mark.parametrize("module", ["plain.py", "writer.py", "engine.py"])
def test_reference_imports_nothing_of_the_port(module):
    path = os.path.join(os.path.dirname(plain.__file__), module)
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {a.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for a in node.names}
    froms = {(node.level, node.module) for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom)}
    assert names <= {"math", "numpy", "os", "concurrent", "multiprocessing"}
    assert all(level == 1 for level, _m in froms)
