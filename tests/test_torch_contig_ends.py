"""Node scores at a contig's ends, the port's scoring against the exact C
engine, on the CPU.

A reverse start's RBS scan reads the 20 bp upstream of it, which for a
start near the contig's 3' end lie partly past the contig.  Prodigal
reads every base there as C (`_native/refcore.c` `rc_rbs_score`: a
position outside the sequence reads as code 2, and the scan's bound is
`j0 + p < slen`); the port's scoring must read them so on the std route
(one geometry a row) and on the mega route (contigs packed end to end,
where the gap after a contig holds other bases).  The cases:

* two contigs of the benchmark's `short_contigs` mix whose best path
  scores departed from the exact engine's by 1-7.5 units
  (`data/short_assembly_departures.fna.gz`: seed 1732050807, call 6,
  contig 446 of 1,026 bp; seed 2645751311, call 6, contig 215 of 6,127
  bp);
* slices of the GCF genome cut 8-14 bp after a reverse ATG,
  alone on the std route and packed ahead of another slice on the mega
  route;
* the motif path of the non-SD bins, whose scan stays inside the contig
  at both ends, on both layouts;
* on the card, a third contig of the mix (seed 22, call 2, contig 89 of
  4,517 bp), where a coding score 6e-5 under the scoring's threshold of
  5.0 went over it when the prefix-sum kernels rounded every add to f32;
* a fourth (seed 5368709143, call 7, contig 195 of 8,646 bp), where a
  gene worth -0.0002 rounded to 0 in the DP's fixed point and tied a
  node's baseline, on both routes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyrodigal_tpu_torch.fasta import parse  # noqa: E402
from pyrodigal_tpu_torch.metagenomic import METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu_torch.nodes import Nodes  # noqa: E402
from pyrodigal_tpu_torch.ops import dp_cuda, meta_cuda, star_cuda  # noqa: E402,E501
from pyrodigal_tpu_torch.ops import score_device as sd  # noqa: E402
from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner  # noqa: E402
from pyrodigal_tpu_torch.sequence import Sequence  # noqa: E402

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)

GCF = "GCF_001457455.1_NCTC11397_genomic_100kb.fna.gz"
# (first bp, end bp) of GCF slices with a reverse ATG 10, 12 (and 8)
# and 14 bp before the slice's 3' end, a start node of translation table
# 11 whose RBS score the port got 8.6-15.6 units wrong under some bin
# while it read the bases past the end as A
SLICES = {10: (677, 3677), 12: (2417, 5417), 14: (665, 3665)}
# a slice packed after them on the mega route
NEXT = (40000, 43000)
# f32 rounding of a start score: a few ulps of its size
ULPS = 2.0 ** -19
NONSD = [b for b, bin_ in enumerate(METAGENOMIC_BINS)
         if not bin_.training_info.uses_sd]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run shares the cores among several pytest workers; torch's
    intra-op thread pool on top of that slows these small ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runner():
    r = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    yield r
    r.close()


@pytest.fixture(scope="module")
def gcf(data):
    return list(parse(data(GCF)))[0].seq


@pytest.fixture(scope="module")
def departed(data):
    return [r.seq for r in parse(data("short_assembly_departures.fna.gz"))]


def _prep(runner, s):
    seq = Sequence(s)
    cand, geoms, nodes_by_tt, route = runner._prepare_contig(seq)
    return seq, cand, geoms, nodes_by_tt, route


def _std_scores(runner, g, bins):
    """score_only of one geometry on the std layout: (rsc, ssc) per bin
    row, over the geometry's nodes."""
    packed = sd.pack_geometries([g], 1, meta_cuda.NODE_BUCKET,
                                meta_cuda.SEQ_BUCKET)
    out = sd.score_only(
        runner.tables.as_tuple(), sd.to_device(packed, "cpu"),
        torch.tensor(bins), torch.zeros(len(bins), dtype=torch.int64),
        is_meta=True, closed=False, has_nonsd=runner.tables.any_nonsd)
    nn = g["nn"]
    return out[8][:, :nn].numpy(), out[7][:, :nn].numpy()


def _mega_pack(geoms):
    nb, sb = (sum(r) for r in zip(*(CudaMetaRunner._mega_regions(g)
                                    for g in geoms)))
    NT = next(b for b in CudaMetaRunner.MEGA_NT if b >= nb)
    SB = next(b for b in CudaMetaRunner.MEGA_SB if b >= sb)
    CP = next(c for c in CudaMetaRunner.MEGA_CP if c >= len(geoms))
    return sd.pack_geometries_multi(geoms, NT, SB, CP, dp_cuda.MEGA_TILE)


def _mega_scores(runner, geoms, bins, k):
    """score_only of contig k of `geoms` packed end to end (the mega
    layout): (rsc, ssc) per bin row, over contig k's nodes."""
    packed = _mega_pack(geoms)
    out = sd.score_only(
        runner.tables.as_tuple(), sd.to_device(packed, "cpu"),
        torch.tensor(bins), is_meta=True, closed=False,
        has_nonsd=runner.tables.any_nonsd)
    lo = int(packed["nbound"][k])
    sl = slice(lo, lo + geoms[k]["nn"])
    return out[8][:, sl].numpy(), out[7][:, sl].numpy()


def _exact(runner, seq, nodes_by_tt, b):
    run = runner._run_bin(seq, nodes_by_tt, b)
    nodes = Nodes.from_block(run.snapshot, run.nn)
    return (np.asarray(nodes.rscore), np.asarray(nodes.sscore))


def _near_3prime_rev_starts(g, reach=20):
    """Indices of the non-edge reverse starts whose RBS scan reads past
    the contig's 3' end."""
    nn = g["nn"]
    return np.nonzero((g["strand"][:nn] == -1) & (g["typ"][:nn] != 3)
                      & (g["edge"][:nn] == 0)
                      & (g["ndx"][:nn] >= g["slen"] - reach))[0]


def _assert_rounding(got, want, what):
    err = np.abs(got.astype(np.float64) - want)
    tol = ULPS * np.maximum(np.abs(want), 1.0)
    bad = np.nonzero(err > tol)[0]
    assert not len(bad), (what, bad[:8], got[bad[:8]], want[bad[:8]])


def _assert_nodes(runner, seq, nodes_by_tt, g, bins, got, ends):
    """Every start's rscore, and the sscore of the starts at `ends`,
    equal to the exact engine's to f32 rounding, under every bin."""
    rsc, ssc = got
    start = g["typ"][:g["nn"]] != 3
    for r, b in enumerate(bins):
        x_rsc, x_ssc = _exact(runner, seq, nodes_by_tt, b)
        _assert_rounding(rsc[r][start], x_rsc[start], ("rscore", b))
        _assert_rounding(ssc[r][ends], x_ssc[ends], ("sscore", b))


def _assert_best(runner, seq, nodes_by_tt, bins, best):
    """Per-bin best path scores within a tenth of the finishing margin of
    the exact engine's."""
    for b, dev in zip(bins, best):
        exact = runner._run_bin(seq, nodes_by_tt, b).score
        assert abs(float(dev) - exact) <= 0.1 * CudaMetaRunner._margin(
            exact), (b, float(dev), exact)


@needs_bins
@pytest.mark.parametrize("which,ndx,bin_", [(0, 1012, 33), (1, 6115, 21)],
                         ids=["contig446", "contig215"])
def test_departed_contigs_match_refcore(runner, departed, which, ndx, bin_):
    """Each candidate bin's best path score within a tenth of the margin
    of refcore's on the std route, and the reverse start that departed
    (its scan reads past the 3' end) scored as refcore scores it."""
    seq, cand, geoms, nbt, route = _prep(runner, departed[which])
    assert route == "std"
    g = geoms[11]
    ends = _near_3prime_rev_starts(g)
    assert ndx in g["ndx"][ends]
    work = [(0, b, (0, 11)) for b in cand]
    _assert_best(runner, seq, nbt, cand, runner._sweep_std(work, {(0, 11): g}))
    _assert_nodes(runner, seq, nbt, g, [bin_], _std_scores(runner, g, [bin_]),
                  ends)


@needs_bins
@pytest.mark.parametrize("reach", sorted(SLICES))
def test_reverse_start_near_3prime_end_std(runner, gcf, reach):
    a, b = SLICES[reach]
    seq, cand, geoms, nbt, route = _prep(runner, gcf[a:b])
    assert route == "std"
    g = geoms[11]
    ends = _near_3prime_rev_starts(g)
    assert g["slen"] - 1 - reach in g["ndx"][ends]
    work = [(0, b, (0, 11)) for b in cand]
    _assert_best(runner, seq, nbt, cand, runner._sweep_std(work, {(0, 11): g}))
    _assert_nodes(runner, seq, nbt, g, cand, _std_scores(runner, g, cand),
                  ends)


@needs_bins
@pytest.mark.parametrize("reach", sorted(SLICES))
def test_reverse_start_near_3prime_end_packed(runner, gcf, reach):
    """The slice packed ahead of another on the mega route: the gap after
    it reads as past its end, not as the gap's bases or the next
    contig's."""
    a, b = SLICES[reach]
    first = _prep(runner, gcf[a:b])
    second = _prep(runner, gcf[NEXT[0]:NEXT[1]])
    items = [{"ci": k, "g": p[2][11], "rows": p[1]}
             for k, p in enumerate((first, second))]
    best, rows, _CP, _B = runner._sweep_mega_multi(items)
    for k, (seq, cand, geoms, nbt, _route) in enumerate((first, second)):
        _assert_best(runner, seq, nbt, cand,
                     [best[k, rows.index(b)] for b in cand])
    seq, cand, geoms, nbt, _route = first
    g = geoms[11]
    ends = _near_3prime_rev_starts(g)
    assert g["slen"] - 1 - reach in g["ndx"][ends]
    _assert_nodes(runner, seq, nbt, g, cand,
                  _mega_scores(runner, [g, second[2][11]], cand, 0), ends)


@needs_bins
@pytest.mark.parametrize("layout", ["std", "packed"])
def test_motif_path_at_both_ends(runner, gcf, layout):
    """Non-SD bins score their starts by the upstream motif, whose scan
    stays inside the contig at both ends; every start of the slices
    (reverse ATGs 8-14 bp before the 3' end, and whatever starts lie
    near either end on either strand) as refcore scores it."""
    assert NONSD
    for a, b in SLICES.values():
        seq, _cand, geoms, nbt, _route = _prep(runner, gcf[a:b])
        g = geoms[11]
        ends = _near_3prime_rev_starts(g)
        if layout == "std":
            got = _std_scores(runner, g, NONSD)
        else:
            other = _prep(runner, gcf[NEXT[0]:NEXT[1]])[2][11]
            got = _mega_scores(runner, [other, g], NONSD, 1)
        _assert_nodes(runner, seq, nbt, g, NONSD, got, ends)


@needs_bins
@pytest.mark.parametrize("route", ["std", "mega"])
def test_negative_gene_does_not_tie_a_baseline(runner, departed, route):
    """A fourth contig of the mix (seed 5368709143, call 7, contig 195 of
    8,646 bp): under bin 30 the edge gene from its first start (ndx 1) to
    the stop at 277 is worth -0.000211 (cscore -2.719212, sscore 2.719).
    Rounded to the DP's fixed point (1/2048) it read 0, tied the stop's
    baseline (0, no source), won it by source index, and the chain it
    opened raised the bin's best path to 325.048 against the exact
    324.308.  A negative value now never rounds to 0: every bin within a
    tenth of the margin of refcore's, on the std route and on the mega
    route."""
    seq, cand, geoms, nbt, std = _prep(runner, departed[3])
    assert std == "std" and 30 in cand
    g = geoms[11]
    if route == "std":
        best = runner._sweep_std([(0, b, (0, 11)) for b in cand],
                                 {(0, 11): g})
    else:
        out, rows, _CP, _B = runner._sweep_mega_multi(
            [{"ci": 0, "g": g, "rows": cand}])
        best = [out[0, rows.index(b)] for b in cand]
    _assert_best(runner, seq, nbt, cand, best)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@needs_bins
def test_card_prefix_sums_round_once_on_contig89(departed, cuda_device,
                                                 monkeypatch):
    """Under bin 30, a fwd start of contig 89 (ndx 4,412) has a coding
    score of 4.99994 on the exact engine, under the threshold of 5.0 below
    which a short ORF's start score loses st_wt; prefix sums rounded to f32
    at every add put it over on the card, and the bin's best path score
    read 255.276 against the exact 254.212.  The prefix-sum kernels sum in
    f64 and round each output once: on a std launch of the contig beside
    another (two geometries: the phase-cumsum kernel) its outputs lie
    within one f32 ulp of the twin's, and every row's best path score is
    the CPU twins' and within a tenth of the margin of refcore's."""
    host = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    card = CudaMetaRunner(METAGENOMIC_BINS, device=cuda_device)
    try:
        preps = [_prep(host, departed[k]) for k in (2, 0)]
        work, gm = [], {}
        for ci, (_seq, cand, geoms, _nbt, route) in enumerate(preps):
            assert route == "std"
            work += [(ci, b, (ci, 11)) for b in cand]
            gm[(ci, 11)] = geoms[11]
        assert (0, 30, (0, 11)) in work
        best_cpu = host._sweep_std(work, gm)
        sums = []
        orig = star_cuda.phase_cumsum

        def keep(x):
            out = orig(x)
            sums.append((x.cpu(), out.cpu()))
            return out
        monkeypatch.setattr(star_cuda, "phase_cumsum", keep)
        best_card = card._sweep_std(work, gm)
    finally:
        host.close()
        card.close()
    assert len(sums) == 2                          # Cf and Cr
    for x, out in sums:
        ref = star_cuda.phase_cumsum_plain(x)
        bound = star_cuda.round_once_bound(x.abs(), ref)
        assert ((out.double() - ref.double()).abs() <= bound).all()
    assert best_card.tolist() == best_cpu.tolist()
    for ci, (seq, cand, _geoms, nbt, _route) in enumerate(preps):
        _assert_best(host, seq, nbt, cand,
                     [best_card[k] for k, w in enumerate(work) if w[0] == ci])


@needs_bins
def test_card_negative_gene_does_not_tie_a_baseline(departed, cuda_device):
    """Contig 195 on the card: the std and the mega DP kernels round a
    negative gene value as their twins do, so every bin's best path
    score is the CPU twins' on both routes."""
    host = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    card = CudaMetaRunner(METAGENOMIC_BINS, device=cuda_device)
    try:
        _seq, cand, geoms, _nbt, _route = _prep(host, departed[3])
        work = [(0, b, (0, 11)) for b in cand]
        gm = {(0, 11): geoms[11]}
        assert card._sweep_std(work, gm).tolist() \
            == host._sweep_std(work, gm).tolist()
        items = [{"ci": 0, "g": geoms[11], "rows": cand}]
        got, want = card._sweep_mega_multi(items), \
            host._sweep_mega_multi(items)
        rows = want[1]
        assert got[1] == rows
        assert got[0][0, :len(rows)].tolist() \
            == want[0][0, :len(rows)].tolist()
    finally:
        host.close()
        card.close()
