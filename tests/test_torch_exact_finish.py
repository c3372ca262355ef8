"""Meta-mode exact finishing in two foreign calls (`rc_run_bin`,
`rc_finish_bin`) against the chain of `Nodes` and `Genes` methods that
single mode and training still call: for every candidate bin of each
contig, the same path end and score, the same work and snapshot node
arrays byte for byte, and the same GFF, nucleotide and protein FASTA and
start scores; the winner as that chain picks it, on the std, mega and
exact routes; and a call's finishing on 8 threads equal to one thread's."""

import concurrent.futures
import io
import random

import pytest

torch = pytest.importorskip("torch")

from pyrodigal_tpu_torch import _native  # noqa: E402
from pyrodigal_tpu_torch.fasta import parse  # noqa: E402
from pyrodigal_tpu_torch.metagenomic import METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu_torch.nodes import Nodes  # noqa: E402
from pyrodigal_tpu_torch.ops import dp_cuda, meta_cuda  # noqa: E402
from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner  # noqa: E402
from pyrodigal_tpu_torch.sequence import Sequence  # noqa: E402

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)
SHORT_SEED = 1_732_050_807
SHORT_CONTIGS = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def short_seqs():
    """The first 64 contigs of call 0 of the benchmark's short-read
    assembly stream."""
    from genebench import generate

    call = generate.make(SHORT_SEED, generate.load_mix("short_contigs"))[0]
    return [s for _name, s in call[:SHORT_CONTIGS]]


def _chain_run(runner, seq, nodes_by_tt, b):
    """One bin through the `Nodes` methods: (nodes after the final DP, its
    path end, the scored snapshot before it)."""
    tinf = runner.bins[b].training_info
    nodes = nodes_by_tt[tinf.translation_table].copy()
    nodes.reset_scores()
    nodes.score_nodes(seq, tinf, closed=runner.closed, is_meta=True)
    nodes.record_overlapping_starts(tinf, 1, runner.max_overlap)
    snapshot = nodes.copy()
    ipath = nodes.dynamic_programming(tinf, final=True)
    return nodes, ipath, snapshot


def _chain_finish(runner, seq, b, nodes, ipath, snapshot):
    tinf = runner.bins[b].training_info
    genes = runner._genes(seq, 1)
    nodes.eliminate_bad_genes(ipath, tinf)
    genes._extract(nodes, ipath)
    genes._tweak_final_starts(nodes, tinf, runner.max_overlap)
    genes.nodes = snapshot
    genes.metagenomic_bin = runner.bins[b]
    genes.training_info = tinf
    return genes


def _writer_bytes(genes):
    out = []
    for write in (genes.write_gff, genes.write_genes,
                  genes.write_translations, genes.write_scores):
        f = io.StringIO()
        write(f, "contig")
        out.append(f.getvalue())
    return out


def _node_bytes(nodes):
    return {name: getattr(nodes, name)[:nodes.length * width].tobytes()
            for name, _d, _c, width in _native.NODE_FIELDS}


def _assert_bins_match_the_chain(runner, seq, cand, nodes_by_tt):
    """Every candidate bin: the two calls against the chain.  Returns the
    chain's winner's genes (None without a path)."""
    chosen, max_score = None, -100.0
    for b in cand:
        nodes, ipath, snapshot = _chain_run(runner, seq, nodes_by_tt, b)
        run = runner._run_bin(seq, nodes_by_tt, b)
        assert (run.bin, run.ipath, run.nn) == (b, ipath, nodes.length)
        if nodes.length == 0:
            assert run.work is None and run.snapshot is None
            continue
        if ipath >= 0:
            assert run.score == nodes.score[ipath]
        assert _node_bytes(Nodes.from_block(run.work, run.nn)) == \
            _node_bytes(nodes), b
        assert _node_bytes(Nodes.from_block(run.snapshot, run.nn)) == \
            _node_bytes(snapshot), b
        if ipath < 0:
            continue
        want = _chain_finish(runner, seq, b, nodes, ipath, snapshot)
        got = runner._finish(seq, 1, run)
        assert got.ipath == want.ipath
        assert _writer_bytes(got) == _writer_bytes(want), b
        if nodes.score[ipath] > max_score:
            chosen, max_score = want, nodes.score[ipath]
    return chosen


def _prep(runner, s):
    seq = Sequence(s, mask=runner.mask, mask_size=runner.min_mask)
    cand, _geoms, nodes_by_tt, route = runner._prepare_contig(seq)
    return seq, cand, nodes_by_tt, route


def _produce(runner, route, seq, cand, nodes_by_tt):
    """The runner's finishing of a contig: the exact route's fan-out, or
    the winner re-run with every candidate bin as close (scores as the
    device would give them: equal ones)."""
    if route == "c":
        return runner._produce_fallback(seq, 1, cand, nodes_by_tt)
    return runner._produce_winner(seq, 1, [(b, 0.0) for b in cand],
                                  nodes_by_tt)


@needs_bins
@pytest.mark.parametrize("route", ["std", "mega", "c", "few_nodes"])
def test_two_calls_match_the_chain_of_methods(data, short_seqs, route,
                                              monkeypatch):
    """Std: 64 contigs of the short-read stream.  Mega: a 100 kb slice of
    GCF_001457455.1.  The exact route, forced as the runner tests force it:
    24 kb of SRR492066 with two translation tables.  Few nodes: an empty
    contig, one shorter than a gene, an all-N one, and two of 600 random
    bases whose nodes make a path in one bin or none."""
    if route == "std":
        seqs = short_seqs
    elif route == "mega":
        seqs = [list(parse(data(
            "GCF_001457455.1_NCTC11397_genomic_100kb.fna.gz")))[0].seq]
    elif route == "c":
        monkeypatch.setattr(meta_cuda, "SEQ_BUCKET", 2048)
        monkeypatch.setattr(dp_cuda, "MEGA_CHUNKS", 0)
        seqs = [list(parse(data("SRR492066.fna.gz")))[0].seq[30000:54000]]
    else:
        seqs = ["", "ATGAAATAA", "N" * 5000] + [
            "".join(random.Random(seed).choices("ACGT", k=600))
            for seed in (0, 3)]
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    try:
        for s in seqs:
            seq, cand, nodes_by_tt, got_route = _prep(runner, s)
            if route != "few_nodes":
                assert got_route == route
                assert cand
            want = _assert_bins_match_the_chain(runner, seq, cand,
                                                nodes_by_tt)
            if not cand:
                continue
            got = _produce(runner, got_route, seq, cand, nodes_by_tt)
            if want is None:
                assert len(got) == 0 and got.metagenomic_bin is None
            else:
                assert got.metagenomic_bin is want.metagenomic_bin
                assert _writer_bytes(got) == _writer_bytes(want)
    finally:
        runner.close()


@needs_bins
def test_finishing_on_eight_threads_equals_one(short_seqs):
    """The 64 contigs' winner finishing side by side on 8 threads, each
    re-run in foreign calls that let the others run, against the same on
    one thread: the same bins and bytes, contig by contig."""
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    try:
        preps = [_prep(runner, s) for s in short_seqs]

        def finish(p):
            return _produce(runner, "std", *p[:3])

        one = [finish(p) for p in preps]
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            eight = list(pool.map(finish, preps))
    finally:
        runner.close()
    assert sum(len(g) for g in one) > 0
    assert [g.metagenomic_bin for g in eight] == \
        [g.metagenomic_bin for g in one]
    assert [_writer_bytes(g) for g in eight] == \
        [_writer_bytes(g) for g in one]


def test_node_block_layout():
    """The block's arrays in NODE_FIELDS order, each on an 8-byte boundary
    and as long as its nodes need, and `from_block` viewing them."""
    import numpy as np

    for nn in (0, 1, 7, 1000):
        off = _native.node_block_offsets(nn)
        assert off[-1] == _native.lib.rc_node_block_layout(nn, None)
        assert off[0] == 0 and all(o % 8 == 0 for o in off)
        block = np.zeros(int(off[-1]), np.uint8)
        nodes = Nodes.from_block(block, nn)
        assert (nodes.length, nodes.capacity) == (nn, nn)
        for k, (name, dtype, _c, width) in enumerate(_native.NODE_FIELDS):
            arr = getattr(nodes, name)
            assert arr.dtype == dtype and arr.size == nn * width
            assert off[k] + arr.nbytes <= off[k + 1] < off[k] + arr.nbytes + 8
            if nn:
                assert _native.addr(arr) == _native.addr(block) + off[k]
