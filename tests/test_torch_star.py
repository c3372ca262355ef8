"""dc-chain and phase prefix sums and the star sweep (one shared geometry
row, and one geometry row per bin row): the port's plain versions against
the JAX reference (Pallas in interpret mode, XLA on the CPU), and the CUDA
kernels against the plain versions on a card."""

import math

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
U = 2.0 ** -24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def inputs(data):
    """The 30 kb mega-route geometry of tests/test_meta.py, scored by the
    port's plain pipeline; numpy arrays, fed as they are to both sides."""
    seq = Sequence(list(parse(data("SRR492066.fna.gz")))[0].seq[:30000])
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    cand, geoms, _nbt, route = runner._prepare_contig(seq)
    runner.close()
    assert route == "std"
    g = geoms[11]
    NT = 2048 * ((g["nn"] + 2047) // 2048)
    packed = tsd.pack_geometries_multi([g], NT, 196608, 1, 2048)
    BT = 16
    bin_idx = np.full(BT, cand[0], np.int64)
    bin_idx[:len(cand)] = cand
    geo = tsd.to_device(packed, "cpu")
    (ndx, stop_val, typ, strand, _wlo, valid, edge, cscore, ssc, rsc, usc,
     stw) = tsd._score_items(runner.tables.as_tuple(), geo,
                             torch.from_numpy(bin_idx), is_meta=True,
                             closed=False, has_nonsd=runner.tables.any_nonsd)
    kind4 = dp_cuda.kind4_of(typ, strand, valid)
    m6f, m6r = tsd._derive_m6(geo)
    return {
        "packed": packed, "bin_idx": bin_idx,
        "table": runner.tables.gene_dc[torch.from_numpy(bin_idx)].numpy(),
        "m6f": m6f[0].numpy(), "m6r": m6r[0].numpy(),
        "star": tuple(a.numpy() for a in (
            ndx, stop_val, kind4, edge, cscore + ssc, rsc, usc, stw)),
    }


def _per_row_geometries(runner, data):
    """Two stacked geometries (KK037166 and the first 24,000 bp of
    SRR492066, translation table 11) and eight bins of each, one
    (contig, bin) per row: (packed, bin_idx, gidx), numpy."""
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
    return (tsd.pack_geometries(geoms, 2, 1536, 24576),
            np.array(bins, np.int32), np.array(gidx, np.int32))


@pytest.fixture(scope="module")
def per_row_inputs(data):
    """Star inputs with one geometry row per bin row, scored by the port's
    plain pipeline."""
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
    packed, bins, gidx = _per_row_geometries(runner, data)
    (ndx, stop_val, typ, strand, _wlo, valid, edge, cscore, ssc, rsc, usc,
     stw) = tsd._score_items(runner.tables.as_tuple(),
                             tsd.to_device(packed, "cpu"),
                             torch.from_numpy(bins.astype(np.int64)),
                             torch.from_numpy(gidx.astype(np.int64)),
                             is_meta=True, closed=False,
                             has_nonsd=runner.tables.any_nonsd)
    runner.close()
    kind4 = dp_cuda.kind4_of(typ, strand, valid)
    return {"star": tuple(a.numpy() for a in (
        ndx, stop_val, kind4, edge, cscore + ssc, rsc, usc, stw))}


@pytest.fixture(scope="module")
def per_row_reference(data):
    """The JAX package's `score_only` on two stacked geometries, one
    (contig, bin) per row (KK037166 and the first 24,000 bp of SRR492066,
    translation table 11, eight bins each): its scores and star
    pointers, numpy."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pyrodigal_tpu.ops import score_device as jsd
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    runner = TpuMetaRunner(METAGENOMIC_BINS, interpret=True)
    packed, bins, gidx = _per_row_geometries(runner, data)
    out = jsd.score_only(
        runner.tables.as_tuple(),
        {k: jnp.asarray(v) for k, v in packed.items()},
        jnp.asarray(bins), jnp.asarray(gidx), is_meta=True, closed=False,
        S3=24576 // 3, has_nonsd=runner.tables.any_nonsd, relk=32,
        max_overlap=60)
    runner.pool.shutdown()
    (ndx, stop_val, typ, strand, _wlo, valid, cscore, ssc, rsc, usc, sp,
     stw) = (np.array(a) for a in out)
    edge = packed["n8"][2].astype(np.int32)[gidx]
    kind4 = dp_cuda.kind4_of(*(torch.from_numpy(a) for a in (
        typ, strand, valid))).numpy()
    return {"star": (ndx, stop_val, kind4, edge, cscore + ssc, rsc, usc,
                     stw), "star_ptr": sp}


@pytest.fixture(scope="module")
def star_reference(inputs):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pyrodigal_tpu.ops import star_pallas

    sp, opv1, val3, t_sv, t_ndx = star_pallas.star_tables_mega(
        *(jnp.asarray(a) for a in inputs["star"]), 32, 60, interpret=True)
    return [np.asarray(sp)] + [np.stack([np.asarray(x) for x in t])
                               for t in (opv1, val3, t_sv, t_ndx)]


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


@needs_bins
def test_codes_equal_reference(inputs):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pyrodigal_tpu.ops import score_device as jsd

    m6f, m6r = jsd._derive_m6({k: jnp.asarray(v)
                               for k, v in inputs["packed"].items()})
    assert np.array_equal(inputs["m6f"], np.asarray(m6f)[0])
    assert np.array_equal(inputs["m6r"], np.asarray(m6r)[0])


@needs_bins
@pytest.mark.parametrize("strand", ["m6f", "m6r"])
def test_dc_prefix_sums_match_reference(inputs, strand):
    """Plain dc prefix sums against the reference's `_lookup64` +
    `phase_cumsum(interpret=True)`.  Same sums in another order: the
    reference runs a float32 log-depth scan over K same-phase terms
    (error <= 2 log2(K) u sum|x|), the port sums in float64 and rounds
    once (<= u |C|)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pyrodigal_tpu.ops import score_device as jsd
    from pyrodigal_tpu.ops import star_pallas

    codes = inputs[strand]
    table = inputs["table"]
    ref = np.asarray(star_pallas.phase_cumsum(jsd._lookup64(
        jnp.asarray(table), jnp.broadcast_to(jnp.asarray(codes),
                                             (len(table), len(codes)))),
        interpret=True))
    got = star_cuda.dc_phase_cumsum(_t(table), _t(codes)).numpy()
    x = table[:, codes].astype(np.float64)
    B, S = x.shape
    cabs = np.abs(x).reshape(B, -1, 3).cumsum(1).reshape(B, S)
    K = math.ceil(S / 3)
    bound = (2 * math.log2(K) + 1) * U * cabs + U * np.abs(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert (np.abs(got.astype(np.float64) - ref) <= bound).all()


@needs_bins
def test_phase_cumsum_plain_matches_reference():
    """Plain phase prefix sums against the reference's
    `phase_cumsum(interpret=True)` at (16, 6,144), on dc-score-sized
    values from a seed.  Same sums in another order: the reference sums
    each phase in float32 (error <= 2 log2(K) u sum|x| for any order),
    the port in float64 rounded once (<= u |C|)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pyrodigal_tpu.ops import star_pallas

    x = np.random.default_rng(0).normal(0.0, 0.5, (16, 6144)) \
        .astype(np.float32)
    ref = np.asarray(star_pallas.phase_cumsum(jnp.asarray(x),
                                              interpret=True))
    got = star_cuda.phase_cumsum(_t(x)).numpy()
    B, S = x.shape
    cabs = np.abs(x.astype(np.float64)).reshape(B, -1, 3).cumsum(1) \
        .reshape(B, S)
    bound = (2 * math.log2(S / 3) + 1) * U * cabs + U * np.abs(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert (np.abs(got.astype(np.float64) - ref) <= bound).all()


@needs_bins
def test_star_plain_matches_reference(inputs, star_reference):
    """Star pointers and integer tables exact; float tables to rtol 1e-6
    (tests/test_meta.py:444-447: XLA's fusion moves last ulps)."""
    got = star_cuda.star_tables(*(_t(a) for a in inputs["star"]), 32, 60)
    names = ("star_ptr", "opv1", "val3", "t_sv", "t_ndx")
    for name, a, b in zip(names, got, star_reference):
        a = a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == np.int32:
            assert np.array_equal(a, b), name
        else:
            assert np.allclose(a, b, rtol=1e-6, atol=1e-5), name
    assert (got[0] != -1).sum() > 0


@needs_bins
def test_per_row_star_plain_matches_reference(per_row_reference):
    """Geometry rows per bin row, fed the reference's own scores: the
    pointers equal those of the reference's XLA sweep (integers: exact)."""
    ref = per_row_reference
    sp = star_cuda.star_tables(*(_t(a) for a in ref["star"]), 32, 60)[0]
    assert np.array_equal(sp.numpy(), ref["star_ptr"])
    assert (sp != -1).sum() > 1000


@pytest.mark.cuda
@needs_bins
def test_dc_chain_kernel_matches_plain(inputs, cuda_device):
    """Kernel against plain on the card, on the 30 kb geometry's two code
    rows, within the kernels' round-once bound
    (`star_cuda.round_once_bound`: one f32 ulp)."""
    table = _t(inputs["table"], cuda_device)
    before = star_cuda.LAUNCHES["dc_chain"]
    for strand in ("m6f", "m6r"):
        codes = _t(inputs[strand], cuda_device)
        got = star_cuda.dc_phase_cumsum(table, codes)
        ref = star_cuda.dc_phase_cumsum_plain(table, codes)
        torch.cuda.synchronize()
        bound = star_cuda.round_once_bound(
            table[:, codes.long()].abs(), ref)
        assert ((got.double() - ref.double()).abs() <= bound).all()
    assert star_cuda.LAUNCHES["dc_chain"] == before + 2


@pytest.mark.cuda
@needs_bins
def test_phase_cumsum_kernel_matches_plain(inputs, cuda_device):
    """Kernel against plain on the card, per-row looked-up dc values of
    the 30 kb geometry's two code rows, within the kernel's round-once
    bound."""
    table = _t(inputs["table"], cuda_device)
    before = star_cuda.LAUNCHES["phase_cumsum"]
    for strand in ("m6f", "m6r"):
        x = table[:, _t(inputs[strand], cuda_device).long()].contiguous()
        got = star_cuda.phase_cumsum(x)
        ref = star_cuda.phase_cumsum_plain(x)
        torch.cuda.synchronize()
        bound = star_cuda.round_once_bound(x.abs(), ref)
        assert ((got.double() - ref.double()).abs() <= bound).all()
    assert star_cuda.LAUNCHES["phase_cumsum"] == before + 2


TILE = star_cuda.TILE
# every tile edge, S % 3 and S % 4, several chunks, and (200 TILE + 5):
# chunks of several tiles
EDGE_S = [1, 2, 3, TILE - 1, TILE, TILE + 1, 3 * TILE + 2, 200 * TILE + 5]


def _prefix_case(B, S, seed):
    """dc-score-sized tables and 6-mer codes in [0, 4096) from a seed."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0.0, 0.5, (B, 4096)).astype(np.float32)
    codes = rng.integers(0, 4096, S + 1).astype(np.int32)
    return table, codes


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("S", EDGE_S)
def test_dc_chain_kernel_edges(B, S, cuda_device):
    """Every tile edge against plain, within the round-once bound; the
    codes once 16-byte aligned and once offset by one element (the
    kernel's 4-byte path)."""
    table, codes = _prefix_case(B, S, S)
    table = _t(table, cuda_device)
    before = star_cuda.LAUNCHES["dc_chain"]
    for off in (0, 1):
        c = _t(codes, cuda_device)[off:off + S]
        got = star_cuda.dc_phase_cumsum(table, c)
        ref = star_cuda.dc_phase_cumsum_plain(table, c)
        torch.cuda.synchronize()
        assert got.shape == (B, S) and torch.isfinite(got).all()
        bound = star_cuda.round_once_bound(
            table[:, c.long()].abs(), ref)
        assert ((got.double() - ref.double()).abs() <= bound).all()
    assert star_cuda.LAUNCHES["dc_chain"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("S", EDGE_S)
def test_phase_cumsum_kernel_edges(B, S, cuda_device):
    """Every tile edge against plain, within the round-once bound (rows of
    S % 4 != 0 take the kernel's 4-byte path)."""
    table, codes = _prefix_case(B, S, S)
    x = _t(table[:, codes[:S]], cuda_device).contiguous()
    before = star_cuda.LAUNCHES["phase_cumsum"]
    got = star_cuda.phase_cumsum(x)
    ref = star_cuda.phase_cumsum_plain(x)
    torch.cuda.synchronize()
    assert got.shape == (B, S) and torch.isfinite(got).all()
    bound = star_cuda.round_once_bound(x.abs(), ref)
    assert ((got.double() - ref.double()).abs() <= bound).all()
    assert star_cuda.LAUNCHES["phase_cumsum"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dc_chain", "phase_cumsum"])
def test_prefix_kernels_are_deterministic(kernel, cuda_device):
    """Two calls on the same inputs give the same bits: the carry across
    tiles is summed in a fixed order."""
    B, S = 16, 200 * TILE + 5
    table, codes = _prefix_case(B, S, 7)
    table, codes = _t(table, cuda_device), _t(codes[:S], cuda_device)
    if kernel == "dc_chain":
        def run():
            return star_cuda.dc_phase_cumsum(table, codes)
    else:
        x = table[:, codes.long()].contiguous()

        def run():
            return star_cuda.phase_cumsum(x)
    before = star_cuda.LAUNCHES[kernel]
    assert torch.equal(run(), run())
    assert star_cuda.LAUNCHES[kernel] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dc_chain", "phase_cumsum"])
def test_prefix_kernels_are_batch_invariant(kernel, cuda_device):
    """A row's sums do not depend on the rows that share its launch: the
    rows of a 16-row launch, launched again as 8 and as 3 rows, give the
    same bits (what lets a launch split its rows over a mesh)."""
    B, S = 16, 832 * TILE - 7
    table, codes = _prefix_case(B, S, 11)
    table, codes = _t(table, cuda_device), _t(codes[:S], cuda_device)
    if kernel == "dc_chain":
        def run(rows):
            return star_cuda.dc_phase_cumsum(table[rows].contiguous(), codes)
    else:
        x = table[:, codes.long()].contiguous()

        def run(rows):
            return star_cuda.phase_cumsum(x[rows].contiguous())
    whole = run(slice(0, B))
    for rows in (slice(0, 8), slice(8, 16), slice(5, 8)):
        assert torch.equal(run(rows), whole[rows])


@pytest.mark.parametrize("B,S", [(1, 1), (16, 30000), (128, 49152),
                                 (16, 2555904), (24, 4718592)])
def test_prefix_chunking_covers_every_tile(B, S):
    """The launch shape the wrappers hand the kernels: every tile in one
    chunk, at most MAX_TILES_PER_BLOCK tiles a block, a grid the card
    takes."""
    tpb, chunks = star_cuda._chunking(S)
    T = -(-S // TILE)
    assert 1 <= tpb <= star_cuda.MAX_TILES_PER_BLOCK
    assert (chunks - 1) * tpb < T <= chunks * tpb
    assert chunks <= 65535


def test_round_once_bound_takes_f64_orders_and_refuses_f32_sums():
    """The bound's own arithmetic on the CPU, over 3 x 4,096 terms: f64
    sums in another order (chunks of 64 a phase, then the chunk totals
    carried) rounded once lie within it, the twin itself within one
    rounding of its f64 sum; a float32 cumsum, rounded at every add as
    the kernels once did, leaves it."""
    B, S = 4, 3 * 4096
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0.0, 0.5, (B, S)).astype(np.float32))
    ref = star_cuda.phase_cumsum_plain(x)
    bound = star_cuda.round_once_bound(x.abs(), ref)
    ph = x.double().reshape(B, -1, 64, 3)
    carry = ph.sum(2).cumsum(1) - ph.sum(2)
    other = (ph.cumsum(2) + carry[:, :, None]).reshape(B, S).float()
    assert not torch.equal(other.double(), star_cuda.phase_cumsum_plain(
        x, rounded=False))
    assert ((other.double() - ref.double()).abs() <= bound).all()
    assert ((ref.double() - star_cuda.phase_cumsum_plain(
        x, rounded=False)).abs() <= star_cuda.U * ref.double().abs()).all()
    f32 = torch.from_numpy(np.cumsum(x.numpy().reshape(B, -1, 3), 1,
                                     dtype=np.float32).reshape(B, S))
    assert ((f32.double() - ref.double()).abs() > bound).any()


@pytest.mark.cuda
@needs_bins
@pytest.mark.parametrize("layout", ["shared", "per_row"])
def test_star_kernel_matches_plain(inputs, per_row_inputs, layout,
                                   cuda_device):
    star = (inputs if layout == "shared" else per_row_inputs)["star"]
    args = [_t(np.ascontiguousarray(a), cuda_device) for a in star]
    got = star_cuda.star_tables(*args, 32, 60)
    ref = star_cuda.star_tables_plain(*args, 32, 60)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-5)


# --------------------------------------------------------------------------
# the star kernel's candidate masks, and its tile edges on the card
# --------------------------------------------------------------------------

RELK, MAX_OVERLAP = 32, 60


def _tie_star(B=2):
    """A crafted shared geometry (64 nodes, ndx = 100 + 5 i) with one
    forward stop (node 20, ndx 200) and one reverse stop (node 40, ndx 300),
    each with two candidates of equal score in different frames: forward
    starts at nodes 14 and 12 (ndx 170 and 160), reverse starts at nodes
    45 and 47 (ndx 325 and 335); all at 15-60 bp, so no operon bonus and
    no adjacency, and the same cs.  The first candidate in walk order
    (node 14, node 45) must win."""
    NT = 64
    ndx = 100 + 5 * np.arange(NT, dtype=np.int32)
    kind4 = np.full(NT, 4, np.int32)
    sv = np.zeros(NT, np.int32)
    kind4[20], kind4[40] = 1, 3
    kind4[[12, 14]] = 0
    sv[[12, 14]] = 400
    kind4[[45, 47]] = 2
    sv[[45, 47]] = 150
    rng = np.random.default_rng(5)
    cs = rng.normal(0.0, 1.0, (B, NT)).astype(np.float32)
    cs[:, [12, 14, 45, 47]] = 1.5
    rsc = rng.normal(0.0, 1.0, (B, NT)).astype(np.float32)
    usc = rng.normal(0.0, 1.0, (B, NT)).astype(np.float32)
    stw = rng.uniform(0.5, 2.0, B).astype(np.float32)
    return (ndx[None], sv[None], kind4[None], np.zeros((1, NT), np.int32),
            cs, rsc, usc, stw)


def _walk_candidates(masks, ndx, stop_val, kind4, edge, cs, rsc, usc, st_wt,
                     relk):
    """The sweep as the star kernel runs it: each stop walks the set bits
    of its candidate mask in ascending order, a strict `>` running max of
    cs[j] + igm from -100, one pointer per frame of ndx[j]; (3, B, NT)."""
    B, NT = cs.shape
    fstop = ((kind4 & 7) == 1) & (edge == 0)
    ndx, masks, fstop = (a.expand(B, NT) for a in (ndx, masks, fstop))
    stw = st_wt[:, None]
    iidx = torch.arange(NT)
    runmax = torch.full((B, NT), -100.0)
    ptr = torch.full((3, B, NT), -1, dtype=torch.int32)
    for k in range(relk):
        bit = ((masks >> k) & 1) != 0
        j = iidx + torch.where(fstop, 3 - k, k - 3)
        jc = j.clamp(0, NT - 1)
        ndx_j, cs_j, rsc_j, usc_j = (a.gather(1, jc)
                                     for a in (ndx, cs, rsc, usc))
        igm = torch.where(
            fstop,
            dp_cuda._igm_same(ndx, 1, rsc, usc, ndx_j, rsc_j, usc_j, stw),
            dp_cuda._igm_same(ndx_j, -1, rsc_j, usc_j, ndx, rsc, usc, stw))
        sc = cs_j + igm
        upd = bit & (sc > runmax)
        for f in range(3):
            ptr[f] = torch.where(upd & (ndx_j % 3 == f), j.to(torch.int32),
                                 ptr[f])
        runmax = torch.where(upd, sc, runmax)
    return ptr


@needs_bins
@pytest.mark.parametrize("case", ["shared", "per_row", "tie"])
def test_star_candidate_masks_walk_to_plain_pointers(case, inputs,
                                                     per_row_inputs):
    """`star_candidates_plain`'s masks, walked bit by bit as the kernel
    walks them, give `star_tables_plain`'s pointers exactly, on the 30 kb
    shared geometry, on per-row geometries and on the tie input; masks
    are 0 off the non-edge stops."""
    star = {"shared": lambda: inputs["star"],
            "per_row": lambda: per_row_inputs["star"],
            "tie": _tie_star}[case]()
    ndx, sv, kind4, edge, cs, rsc, usc, stw = (_t(a) for a in star)
    masks = star_cuda.star_candidates_plain(ndx, sv, kind4, edge, RELK,
                                            MAX_OVERLAP)
    assert masks.shape == ndx.shape and masks.dtype == torch.int64
    stops = (((kind4 & 7) == 1) | ((kind4 & 7) == 3)) & (edge == 0)
    assert not (masks[~stops] != 0).any()
    assert (masks >> RELK == 0).all()
    sp = star_cuda.star_tables_plain(ndx, sv, kind4, edge, cs, rsc, usc, stw,
                                     RELK, MAX_OVERLAP)[0]
    walked = _walk_candidates(masks, ndx, sv, kind4, edge, cs, rsc, usc, stw,
                              RELK)
    assert torch.equal(walked, sp)
    assert (sp != -1).sum() > 0
    if case == "tie":
        # two candidates each: j = i + 3 - k (fwd), j = i - 3 + k (rev)
        assert masks[0, 20] == (1 << 9) | (1 << 11)
        assert masks[0, 40] == (1 << 8) | (1 << 10)
        # ndx 170 % 3 = 2 wins over 160 % 3 = 1; 325 % 3 = 1 over 335 % 3 = 2
        assert sp[:, :, 20].T.tolist() == [[-1, -1, 14]] * 2
        assert sp[:, :, 40].T.tolist() == [[-1, 45, -1]] * 2


def test_star_candidates_plain_rejects_long_walks():
    """The masks hold 32 steps: relk past that, or below 1, is refused."""
    z = torch.zeros((1, 8), dtype=torch.int32)
    for relk in (0, 33):
        with pytest.raises(ValueError):
            star_cuda.star_candidates_plain(z, z, z, z, relk, MAX_OVERLAP)


@pytest.mark.parametrize("B,R", [(16, 1), (3, 1), (128, 128), (1, 1)])
def test_star_rows_a_block(B, R):
    """A block sweeps up to STAR_ROWS bin rows over one shared geometry row,
    and one row where each row has its own geometry."""
    G = star_cuda._star_rows(B, R)
    assert 1 <= G <= star_cuda.STAR_ROWS and G <= B
    assert G == (1 if R > 1 else min(B, star_cuda.STAR_ROWS))


def _synthetic_star(B, NT, per_row, seed, tile):
    """Star inputs from a seed, dense in candidates: ndx rising by 1-6 bp a
    node, kinds 0-3 at random with 5% padding, 5% edge nodes, a start's
    stop 0-400 bp downstream of it; at every tile edge e, a forward stop
    at node e whose best candidate is node e - 2, across the edge; one
    shared geometry row, or one per bin row with every fourth row all
    padding.  Numpy."""
    rng = np.random.default_rng(seed)
    R = B if per_row else 1
    ndx = np.cumsum(rng.integers(1, 7, (R, NT)), 1).astype(np.int32)
    kind4 = rng.choice(4, (R, NT), p=[0.35, 0.15, 0.35, 0.15]) \
        .astype(np.int32)
    kind4[rng.random((R, NT)) < 0.05] = 4
    reach = rng.integers(0, 400, (R, NT))
    sv = np.where(kind4 == 2, ndx - reach, ndx + reach).astype(np.int32)
    edge = (rng.random((R, NT)) < 0.05).astype(np.int32)
    cs = rng.normal(0.0, 3.0, (B, NT)).astype(np.float32)
    for e in range(tile, NT, tile):
        kind4[:, e], edge[:, e] = 1, 0
        kind4[:, e - 2], sv[:, e - 2] = 0, ndx[:, e] + 100
        cs[:, e - 2] = 50.0
    if per_row:
        kind4[3::4] = 4
    rsc = rng.normal(0.0, 1.0, (B, NT)).astype(np.float32)
    usc = rng.normal(0.0, 1.0, (B, NT)).astype(np.float32)
    stw = rng.uniform(0.5, 2.0, B).astype(np.float32)
    return ndx, sv, kind4, edge, cs, rsc, usc, stw


def _star_kernel_against_plain(star, device, record_property):
    """The kernel against its plain twin on the card: integers exactly
    equal, floats within rtol 1e-6 (whether they are bit-equal is
    recorded); returns the plain pointers."""
    args = [_t(np.ascontiguousarray(a), device) for a in star]
    before = star_cuda.LAUNCHES["star"]
    got = star_cuda.star_tables(*args, RELK, MAX_OVERLAP)
    ref = star_cuda.star_tables_plain(*args, RELK, MAX_OVERLAP)
    torch.cuda.synchronize()
    assert star_cuda.LAUNCHES["star"] == before + 1
    bit_equal = True
    for name, a, b in zip(("star_ptr", "opv1", "val3", "t_sv", "t_ndx"),
                          got, ref):
        if a.dtype == torch.int32:
            assert torch.equal(a, b), name
        else:
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-5), name
            bit_equal &= torch.equal(a, b)
    record_property("float_tables_bit_equal", bit_equal)
    return ref[0].cpu()


STAR_T = star_cuda.STAR_TILE


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "per_row"])
@pytest.mark.parametrize("B", [1, 16, 24])
@pytest.mark.parametrize("NT", [STAR_T - 1, STAR_T, STAR_T + 1,
                                3 * STAR_T + 5])
def test_star_kernel_tile_edges(NT, B, layout, cuda_device, record_property):
    """Synthetic geometries at NT = T - 1, T, T + 1 and 3T + 5 (T the
    kernel's tile) and B = 1, 16, 24 (a partial row group): stops within
    28 nodes of a tile edge point across it, and per-row geometries
    include all-padding rows."""
    star = _synthetic_star(B, NT, layout == "per_row", NT * 100 + B, STAR_T)
    sp = _star_kernel_against_plain(star, cuda_device, record_property)
    i = torch.arange(NT)
    across = (sp != -1) & (sp // STAR_T != i // STAR_T)
    assert (sp != -1).sum() > B * NT // 20
    if NT > STAR_T:
        assert across.sum() > 0


@pytest.mark.cuda
def test_star_kernel_tie(cuda_device, record_property):
    """Two candidates of equal score: the first in walk order wins on the
    card as in the plain twin."""
    sp = _star_kernel_against_plain(_tie_star(), cuda_device,
                                    record_property)
    assert sp[:, :, 20].T.tolist() == [[-1, -1, 14]] * 2
    assert sp[:, :, 40].T.tolist() == [[-1, 45, -1]] * 2
