"""The std DP: the port's plain `_dp_core` against the JAX package's
`dp_pallas._dp_core(interpret=True)`, fed identical inputs, and the CUDA
kernel against the plain version on a card.  Every output is integer
fixed point underneath, so the bar is exact equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyrodigal_tpu import METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu.fasta import parse  # noqa: E402
from pyrodigal_tpu.sequence import Sequence  # noqa: E402
from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda  # noqa: E402
from pyrodigal_tpu_torch.ops import score_device as tsd  # noqa: E402
from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner  # noqa: E402

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)

W = 640
N = 1536            # node bucket of tests/test_meta.py's std-route runs
S = 24576


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


def _dp_inputs(contigs, max_overlap, rows_per_contig=8):
    """One 16-row std launch of two contigs (translation table 11, eight
    bins each), scored by the port's plain pipeline; numpy arrays."""
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cpu",
                            max_overlap=max_overlap)
    geoms, bins, gidx = [], [], []
    for c in contigs:
        cand, gs, _nbt, route = runner._prepare_contig(Sequence(c))
        assert route == "std" and gs[11]["nn"] <= N
        rows = [b for b in cand
                if runner.bins[b].training_info.translation_table == 11]
        bins += rows[:rows_per_contig]
        gidx += [len(geoms)] * len(rows[:rows_per_contig])
        geoms.append(gs[11])
    packed = tsd.pack_geometries(geoms, len(geoms), N, S)
    bin_idx = torch.tensor(bins)
    (ndx, stop_val, typ, strand, win_lo, valid, edge, cscore, ssc, rsc, usc,
     stw) = tsd._score_items(runner.tables.as_tuple(),
                             tsd.to_device(packed, "cpu"), bin_idx,
                             torch.tensor(gidx), is_meta=True, closed=False,
                             has_nonsd=runner.tables.any_nonsd)
    runner.close()
    cs = cscore + ssc
    sp, *tables = star_cuda.star_tables(
        ndx, stop_val, dp_cuda.kind4_of(typ, strand, valid), edge, cs, rsc,
        usc, stw, 32, max_overlap)
    return {"geometry": [a.numpy() for a in (ndx, stop_val, typ, strand,
                                               win_lo, valid)],
            "scores": [a.numpy() for a in (cs, rsc, usc)],
            "sp": sp.numpy(), "st_wt": stw.numpy(),
            "tables": [t.numpy() for t in tables]}


def _ext(inp):
    """The farthest any valid node's window reaches back, in nodes."""
    _ndx, _sv, _typ, _strand, win_lo, valid = inp["geometry"]
    return int(np.where(valid != 0, np.arange(N) - win_lo, 0).max())


@pytest.fixture(scope="module")
def cases(data):
    kk = list(parse(data("KK037166.fna.gz")))[0].seq
    srr = list(parse(data("SRR492066.fna.gz")))[0].seq[:24000]
    g100 = list(parse(data(
        "GCF_001457455.1_NCTC11397_genomic_100kb.fna.gz")))[0].seq[:20000]
    # No std-route geometry of the test data reaches further back than
    # 2 * 640 nodes (the farthest, 1,256, is in a 48 kb slice of the genome
    # with too many nodes for the std route), so the 3-chunk case lowers
    # win_lo on a 1,372-node slice: both sides take the same inputs, and
    # the DP is defined for any win_lo <= i.
    three = _dp_inputs([kk, g100], 60)
    three["geometry"][4] = np.maximum(
        np.arange(N, dtype=np.int32) - 1900, 0)[None].repeat(16, 0)
    return {"two_contigs": _dp_inputs([kk, srr], 60),
            "max_overlap_0": _dp_inputs([kk, srr], 0),
            "three_chunks": three}


def _reference(inp):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pyrodigal_tpu.ops import dp_pallas

    BT = inp["st_wt"].shape[0]
    out = dp_pallas._dp_core(
        *(jnp.asarray(a) for a in inp["geometry"]),
        *(jnp.asarray(a) for a in inp["scores"]), jnp.asarray(inp["sp"]),
        jnp.asarray(inp["st_wt"]), W, W + N + 128, BT, 16,
        dp_pallas.FIXED_CHUNKS, interpret=True, star_span=36)
    score, traceb, ov, best = (np.asarray(a) for a in out)
    # the kernel's lanes are node indices front-padded by W
    traceb = traceb[:, W:W + N]
    traceb = np.where(traceb == -1, -1, traceb - W)
    return score[:, W:W + N], traceb, ov[:, W:W + N], best


def _port(inp, device="cpu"):
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return dp_cuda._dp_core(
        *(t(a) for a in inp["geometry"]), *(t(a) for a in inp["scores"]),
        tuple(t(a) for a in inp["tables"]), t(inp["st_wt"]))


@needs_bins
@pytest.mark.parametrize("case", ["two_contigs", "max_overlap_0",
                                  "three_chunks"])
def test_plain_dp_equals_reference(cases, case):
    inp = cases[case]
    assert _ext(inp) > (2 * W if case == "three_chunks" else W)
    ref = _reference(inp)
    score, traceb, ovmark, tbndx, best = _port(inp)
    for name, a, b in zip(("score", "traceb", "ovmark", "best"),
                          (score, traceb, ovmark, best), ref):
        a = a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    # tbndx is ndx at the traceback (the JAX kernel keeps it internally)
    ndx = inp["geometry"][0]
    tb = traceb.numpy()
    assert np.array_equal(tbndx.numpy(), np.where(
        tb == -1, 0, np.take_along_axis(ndx, np.maximum(tb, 0), 1)))
    # the DP really committed paths on every row
    assert ((tb != -1).sum(1) > 100).all()
    assert (ref[3] > 0).all()


@needs_bins
def test_std_dp_refuses_a_window_past_three_chunks(cases):
    inp = dict(cases["two_contigs"], geometry=list(
        cases["two_contigs"]["geometry"]))
    inp["geometry"][4] = np.full_like(inp["geometry"][4], -1000)
    with pytest.raises(ValueError, match="window"):
        _port(inp)


@pytest.mark.cuda
@needs_bins
@pytest.mark.parametrize("case", ["two_contigs", "max_overlap_0",
                                  "three_chunks"])
def test_dp_kernel_equals_plain(cases, case, cuda_device):
    inp = cases[case]
    before = dp_cuda.LAUNCHES["dp_std"]
    got = _port(inp, cuda_device)
    torch.cuda.synchronize()
    assert dp_cuda.LAUNCHES["dp_std"] == before + 1
    ref = _port(inp)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@needs_bins
def test_dp_kernel_rows_with_no_valid_node(cases, cuda_device):
    """Rows with no valid node beside full ones: the kernel walks empty
    source lists there and commits nothing, as the plain version."""
    inp = dict(cases["two_contigs"], geometry=list(
        cases["two_contigs"]["geometry"]))
    valid = inp["geometry"][5].copy()
    valid[::4] = 0
    inp["geometry"][5] = valid
    got = _port(inp, cuda_device)
    ref = _port(inp)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    assert (got[1][::4] == -1).all()


def test_quant_never_rounds_a_negative_value_to_zero():
    """The DPs' fixed point (csrc/common.cuh `quant` and its twin): round
    half to even, but a negative value that rounds to 0 reads -1, so that
    it cannot tie a node's baseline (0, no source)."""
    x = torch.tensor([-0.000211, -0.5 / 2048, -1e-30, -0.0, 0.0, 0.000211,
                      -0.00074, 1.3], dtype=torch.float32)
    q = dp_cuda._quant(x, dp_cuda.FXS)
    assert q.dtype == torch.int32
    assert q.tolist() == [-1, -1, -1, 0, 0, 0, -2, 2662]
