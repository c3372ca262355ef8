"""The mega DP: the port's plain `_dp_core_mega` against the JAX
package's `_dp_core_mega(interpret=True)`, fed identical inputs, and the
CUDA kernel against the plain version on a card.  Every output is
integer fixed point underneath, so the bar is exact equality."""

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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run shares the cores among several pytest workers; torch's
    intra-op thread pool on top of that slows these small ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
T = dp_cuda.MEGA_TILE


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _dp_inputs(runner, contigs, packed_layout):
    """Scores and star tables (port, plain) for contigs laid out as one
    mega geometry: `pack_geometries` for one contig (pads sort last),
    `pack_geometries_multi` for a pack (monotonic pads, node bounds)."""
    geoms, rows = [], set()
    for c in contigs:
        cand, gs, _nbt, _route = runner._prepare_contig(Sequence(c))
        geoms.append(gs[11])
        rows |= {b for b in cand
                 if runner.bins[b].training_info.translation_table == 11}
    nb = sum(-(-g["nn"] // T) * T for g in geoms)
    NT = nb + T                                  # one trailing pad tile
    SB = 196608 * len(contigs)
    if packed_layout:
        packed = tsd.pack_geometries_multi(geoms, NT, SB, len(geoms) + 1, T)
    else:
        packed = tsd.pack_geometries(geoms, 1, NT, SB)
    rows = sorted(rows)[:24]         # the widest launch (MEGA_ROWB)
    B = 8 if len(rows) <= 8 else 16 if len(rows) <= 16 else 24
    bins = np.full(B, rows[0], np.int64)
    bins[:len(rows)] = rows
    geo = tsd.to_device(packed, "cpu")
    (ndx, stop_val, typ, strand, win_lo, valid, edge, cscore, ssc, rsc, usc,
     stw) = tsd._score_items(runner.tables.as_tuple(), geo,
                             torch.from_numpy(bins), is_meta=True,
                             closed=False,
                             has_nonsd=runner.tables.any_nonsd)
    kind4, *_ = dp_cuda.mega_geometry(ndx[0], stop_val[0], typ[0],
                                      strand[0], valid[0], packed_layout)
    cs = cscore + ssc
    sp, *tables = star_cuda.star_tables(
        ndx, stop_val, kind4[None], edge, cs, rsc, usc, stw, 32, 60)
    geometry = [a.expand(B, -1).numpy() for a in
                (ndx, stop_val, typ, strand, win_lo, valid)]
    return {"geometry": geometry,
            "scores": [a.numpy() for a in (cs, rsc, usc)],
            "sp": sp.numpy(), "st_wt": stw.numpy(),
            "tables": [t.numpy() for t in tables], "NT": NT,
            "node_bounds": packed.get("nbound"), "monotonic": packed_layout}


@pytest.fixture(scope="module")
def cases(data):
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    srr = list(parse(data("SRR492066.fna.gz")))[0].seq
    miij = list(parse(data("MIIJ01000039.fna.gz")))[0].seq
    single = _dp_inputs(runner, [srr[:30000]], False)
    packed = _dp_inputs(runner, [srr[:30000], miij[:24000],
                                 srr[30000:54000]], True)
    runner.close()
    return {"single": (single, 2048), "packed": (packed, 2048),
            "fxs1024": (single, 1024)}


def _reference(inp, fxs):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pyrodigal_tpu.ops import dp_pallas

    tables = tuple([jnp.asarray(x) for x in t] for t in inp["tables"])
    nb = inp["node_bounds"]
    out = dp_pallas._dp_core_mega(
        *(jnp.asarray(a) for a in inp["geometry"]),
        *(jnp.asarray(a) for a in inp["scores"]), jnp.asarray(inp["sp"]),
        jnp.asarray(inp["st_wt"]), inp["NT"], True, star_span=36,
        tables=tables, fxs=fxs,
        node_bounds=None if nb is None else jnp.asarray(nb),
        monotonic_ndx=inp["monotonic"])
    return [np.asarray(a) for a in out]


def _port(inp, fxs, device="cpu"):
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    ndx, stop_val, typ, strand, win_lo, valid = (
        t(a[0]) for a in inp["geometry"])
    geometry = dp_cuda.mega_geometry(ndx, stop_val, typ, strand, valid,
                                     inp["monotonic"])
    return dp_cuda._dp_core_mega(
        ndx, stop_val, win_lo, geometry, *(t(a) for a in inp["scores"]),
        t(inp["st_wt"]), tuple(t(a) for a in inp["tables"]), fxs=fxs,
        node_bounds=inp["node_bounds"])


@needs_bins
@pytest.mark.parametrize("case", ["single", "packed", "fxs1024"])
def test_plain_dp_equals_reference(cases, case):
    inp, fxs = cases[case]
    ref = _reference(inp, fxs)
    score, traceb, ovmark, _tbndx, best = _port(inp, fxs)
    for name, a, b in zip(("score", "traceb", "ovmark", "best"),
                          (score, traceb, ovmark, best), ref):
        a = a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.array_equal(a, b), name
    # the DP really committed paths, and a pack reports one row per contig
    assert (traceb.numpy() != -1).sum() > 1000
    assert np.isfinite(ref[3]).all() and ref[3].max() > 0
    if case == "packed":
        assert best.shape[0] == len(inp["node_bounds"]) - 1


@pytest.mark.cuda
@needs_bins
@pytest.mark.parametrize("case", ["single", "packed", "fxs1024"])
def test_dp_kernel_equals_plain(cases, case, cuda_device):
    inp, fxs = cases[case]
    before = dp_cuda.LAUNCHES["dp_mega"]
    got = _port(inp, fxs, cuda_device)
    torch.cuda.synchronize()
    assert dp_cuda.LAUNCHES["dp_mega"] == before + 1
    ref = _port(inp, fxs)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def _kernel_args(inp, fxs, device):
    """`mega_dp`'s operands for `inp` on `device`."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    ndx, stop_val, typ, strand, win_lo, valid = (
        t(a[0]) for a in inp["geometry"])
    kind4, tile_nn, ovlo, has_ov, _ok = dp_cuda.mega_geometry(
        ndx, stop_val, typ, strand, valid, inp["monotonic"])
    return [ndx, stop_val, kind4, win_lo, ovlo, has_ov, tile_nn,
            *(t(a) for a in inp["scores"]), *(t(a) for a in inp["tables"]),
            t(inp["st_wt"]), fxs]


@pytest.mark.cuda
@needs_bins
@pytest.mark.parametrize("case", ["100kb", "no_valid_node"])
def test_dp_kernel_edges_equal_plain(data, case, cuda_device):
    """The kernel against its plain twin, both on the card, where the
    kernel's design has edges: the 100 kb contig, whose 6,918 nodes span
    four tiles, so the kernel's three-tile ring of node slots and its
    source lists wrap (and the JAX kernel's 256-slot fwd-stop ring with
    them); and a geometry with no valid node."""
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    seq = list(parse(data(
        "GCF_001457455.1_NCTC11397_genomic_100kb.fna.gz")))[0].seq
    inp = _dp_inputs(runner, [seq], True)
    runner.close()
    args = _kernel_args(inp, 2048, cuda_device)
    assert int(args[6].sum()) > 3 * T
    if case == "no_valid_node":
        args[6] = torch.zeros_like(args[6])
    got = dp_cuda.mega_dp(*args)
    ref = dp_cuda.mega_dp_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    committed = int((got[1] != -1).sum())
    assert committed == 0 if case == "no_valid_node" else committed > 1000
