"""Port scoring (`score_device.score_only`) against the JAX package's,
field by field, in meta mode and in single mode: one shared geometry (the mega route's layout, the 24,576
bp slice of tests/test_meta.py), and two stacked geometries with one
(contig, bin) per row picked by `gidx` (the std route's layout:
KK037166 and the first 24,000 bp of SRR492066)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pyrodigal_tpu import METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu.fasta import parse  # noqa: E402
from pyrodigal_tpu.sequence import Sequence  # noqa: E402
from pyrodigal_tpu.ops import score_device as jsd  # noqa: E402
from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner  # noqa: E402
from pyrodigal_tpu_torch.ops import score_device as tsd  # noqa: E402
from pyrodigal_tpu_torch.ops import dp_cuda, star_cuda  # noqa: E402

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

FIELDS = ("ndx", "stop_val", "typ", "strand", "win_lo", "valid", "cscore",
          "ssc", "rsc", "usc", "edge/star_ptr", "st_wt")
U = 2.0 ** -24


def _shared(runner, data):
    seq = Sequence(list(parse(data("SRR492066.fna.gz")))[0].seq[:24576])
    cand, geoms, _nbt, _route = runner._prepare_contig(seq)
    g = geoms[list(geoms)[0]]
    NT = 2048 * ((g["nn"] + 2047) // 2048)
    SB = ((seq.slen + 196607) // 196608) * 196608
    packed = jsd.pack_geometries([g], 1, NT, SB)
    bin_idx = np.zeros(16, np.int32)
    bin_idx[:len(cand[:16])] = cand[:16]
    return packed, bin_idx, None, SB


def _per_item(runner, data):
    """Two geometries (translation table 11), eight bins of each."""
    seqs = [list(parse(data("KK037166.fna.gz")))[0].seq,
            list(parse(data("SRR492066.fna.gz")))[0].seq[:24000]]
    geoms, bins, gidx = [], [], []
    for s in seqs:
        cand, gs, _nbt, route = runner._prepare_contig(Sequence(s))
        assert route == "std"
        rows = [b for b in cand
                if runner.bins[b].training_info.translation_table == 11][:8]
        bins += rows
        gidx += [len(geoms)] * len(rows)
        geoms.append(gs[11])
    packed = jsd.pack_geometries(geoms, 2, 1536, 24576)
    return (packed, np.array(bins, np.int32), np.array(gidx, np.int32),
            24576)


@pytest.fixture(scope="module", params=[
    ("shared", True), ("per_item", True), ("shared", False),
    ("per_item", False)],
    ids=["shared", "per_item", "shared-single", "per_item-single"])
def scored(request, data):
    """Both layouts in meta mode and in single mode (`is_meta=False`: the
    single-mode branches of the start scores, on the same bins)."""
    layout, is_meta = request.param
    runner = TpuMetaRunner(METAGENOMIC_BINS, interpret=True)
    packed, bin_idx, gidx, S = (_shared if layout == "shared"
                                else _per_item)(runner, data)
    BT = len(bin_idx)
    arrays = tuple(np.asarray(a) for a in runner.tables.as_tuple())
    nonsd = runner.tables.any_nonsd
    ref = jsd.score_only(
        runner.tables.as_tuple(), {k: jnp.asarray(v) for k, v in
                                   packed.items()},
        jnp.asarray(bin_idx),
        jnp.zeros(BT, jnp.int32) if gidx is None else jnp.asarray(gidx),
        is_meta=is_meta, closed=False, S3=S // 3, has_nonsd=nonsd, relk=32,
        max_overlap=60)
    ref = [np.asarray(a) for a in ref]
    tables = tsd.BinTables.from_numpy(arrays)
    geo = tsd.to_device(packed, "cpu")
    bins = torch.from_numpy(bin_idx.astype(np.int64))
    rows = None if gidx is None else torch.from_numpy(gidx.astype(np.int64))
    got = tsd.score_only(tables.as_tuple(), geo, bins, rows,
                         is_meta=is_meta, closed=False, has_nonsd=nonsd)
    return ref, [a.numpy() for a in got], tables, geo, bins, rows


@needs_bins
def test_geometry_fields_exact(scored):
    ref, got, *_ = scored
    for k in (0, 1, 2, 3, 4, 5, 11):
        assert got[k].shape == ref[k].shape, FIELDS[k]
        assert np.array_equal(got[k], ref[k]), FIELDS[k]


@needs_bins
def test_cscore_within_prefix_sum_rounding(scored):
    """cscore is a difference of per-phase dc prefix sums, then doubled
    minus a running max of such differences (pass 2): |d cscore| <= 6 d,
    d the prefix-sum difference.  The reference sums each phase in f32
    with a log-depth scan of K terms (error <= 2 log2(K) u sum|x|), the
    port in f64 rounded once (u |C|); exp/log1p of the length factor add
    f32 ulps (rtol 1e-5)."""
    ref, got, tables, geo, bins, rows = scored
    dc = tables.gene_dc[bins].double()
    S = geo["digits"].shape[1]
    K = math.ceil(S / 3)
    sum_abs = 0.0
    for m6 in tsd._derive_m6(geo):
        codes = m6.expand(len(bins), -1) if rows is None else m6[rows]
        sum_abs = max(sum_abs, float(dc.gather(1, codes.long()).abs()
                                     .reshape(len(bins), -1, 3).sum(1).max()))
    d = (2 * math.log2(K) + 1) * U * sum_abs
    cs_ref, cs_got = ref[6], got[6]
    assert cs_got.shape == cs_ref.shape
    assert np.allclose(cs_got, cs_ref, rtol=1e-5, atol=6 * d)


@needs_bins
def test_start_scores_close(scored):
    """ssc/rsc/usc: the same f32 formulas; the reference's XLA fuses them,
    the port rounds each op and sums the upstream cells in f64, so they
    agree to a few ulps (rtol 1e-5, atol 1e-5)."""
    ref, got, *_ = scored
    for k in (7, 8, 9):
        assert got[k].shape == ref[k].shape, FIELDS[k]
        assert np.allclose(got[k], ref[k], rtol=1e-5, atol=1e-5), FIELDS[k]


@needs_bins
def test_star_pointers_from_port_scores_equal_reference(scored):
    """The reference's score_only also returns its XLA star pointers; the
    port's star sweep over the port's own scores lands on the same nodes
    (integers: exact).  A shared geometry goes to the sweep as one row."""
    ref, got, tables, geo, bins, rows = scored
    ndx, sv, typ, strand, _wlo, valid, cscore, ssc, rsc, usc, edge, stw = (
        torch.from_numpy(np.ascontiguousarray(a)) for a in got)
    R = 1 if rows is None else len(bins)
    kind4 = dp_cuda.kind4_of(typ, strand, valid)
    sp = star_cuda.star_tables(
        ndx[:R], sv[:R], kind4[:R], edge[:R], cscore + ssc, rsc, usc, stw,
        32, 60)[0]
    assert np.array_equal(sp.numpy(), ref[10])
    assert (sp != -1).sum() > 0
