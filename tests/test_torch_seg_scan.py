"""The scoring passes' segmented running max (`star_cuda.seg_scan`): the
plain twin against the JAX package's `score_device._seg_scan` followed by
`_sel_phase` (both of its branches: one associative scan up to 4,096
nodes, the blocked scan above), scoring through the new call path against
the JAX package's, and the CUDA kernel (`csrc/seg_scan.cu`) bit-equal to
the twin on a card.  JAX is imported by the tests that hold the port
against it (the `ref` fixture), so that the card's tests run where JAX is
not installed."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyrodigal_tpu import METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu.fasta import parse  # noqa: E402
from pyrodigal_tpu.sequence import Sequence  # noqa: E402
from pyrodigal_tpu_torch.ops import score_device as tsd  # noqa: E402
from pyrodigal_tpu_torch.ops import star_cuda  # noqa: E402

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)
T = star_cuda.SEG_TILE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run shares the cores among several pytest workers; torch's
    intra-op thread pool on top of that slows these small ops many-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's scoring module, jax.numpy and its runner."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pyrodigal_tpu.ops import score_device as jsd
    from pyrodigal_tpu.ops.meta_tpu import TpuMetaRunner

    return jsd, jnp, TpuMetaRunner


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _operands(seed, BT, R, n, special=True):
    """Scan operands from numpy: values (BT, n) f32 with +0.0 and -0.0
    among them, elem/reset (R, n) bool, phase (R, n) int32, init (BT, 3)
    f32 (nonzero).  With `special` and R > 2, geometry row 1 holds no
    elem and row 2 is all resets."""
    rng = np.random.default_rng(seed)
    values = (rng.normal(size=(BT, n)) * 10).astype(np.float32)
    values[rng.random((BT, n)) < 0.1] = 0.0
    values[rng.random((BT, n)) < 0.1] = -0.0
    elem = rng.random((R, n)) < 0.4
    reset = rng.random((R, n)) < 0.05
    phase = rng.integers(0, 3, (R, n)).astype(np.int32)
    init = (rng.normal(size=(BT, 3)) * 20).astype(np.float32)
    if special and R > 2:
        elem[1] = False
        reset[2] = True
    return values, elem, reset, phase, init


def _reference(ref, values, elem, reset, phase, reset_val, init, reverse,
               exclusive):
    """The JAX package's scan of the same operands, channels spelt out as
    its `_score_items` spells them, (BT, n, 3); (own, final) as numpy."""
    jsd, jnp, _runner = ref
    BT, n = values.shape
    ph1 = np.eye(3, dtype=bool)[phase]                  # (R, n, 3)

    def chan(pred):
        return jnp.asarray(np.broadcast_to(pred[..., None] & ph1,
                                           (BT, n, 3)))

    v = jnp.broadcast_to(jnp.asarray(values)[..., None], (BT, n, 3))
    incl, excl, final = jsd._seg_scan(v, chan(elem), chan(reset), reset_val,
                                      jnp.asarray(init), reverse)
    own = jsd._sel_phase(excl if exclusive else incl, jnp.asarray(phase))
    return np.asarray(own), np.asarray(final)


def _plain(values, elem, reset, phase, reset_val, init, reverse, exclusive,
           device="cpu"):
    args = [torch.from_numpy(a).to(device)
            for a in (values, elem, reset, phase)]
    return star_cuda.seg_scan_plain(*args, reset_val,
                                    torch.from_numpy(init).to(device),
                                    reverse, exclusive)


@pytest.mark.parametrize("n", [1500, 5000], ids=["one_scan", "blocked"])
@pytest.mark.parametrize("layout", ["shared", "per_row"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("exclusive", [False, True], ids=["incl", "excl"])
def test_plain_matches_reference(n, layout, reverse, exclusive, ref):
    """Exactly equal to the JAX scan (values: the two order +0.0 and -0.0
    alike where they tie), per-row rows including one with no elem and
    one of resets only."""
    BT = 5
    ops = _operands(n + 7 * reverse + 3 * exclusive, BT,
                    1 if layout == "shared" else BT, n)
    ref_own, ref_final = _reference(ref, *ops[:4], -1e4, ops[4], reverse,
                                    exclusive)
    own, final = _plain(*ops[:4], -1e4, ops[4], reverse, exclusive)
    assert own.shape == (BT, n) and final.shape == (BT, 3)
    np.testing.assert_array_equal(own.numpy(), ref_own)
    np.testing.assert_array_equal(final.numpy(), ref_final)


@pytest.mark.parametrize("pattern", ["no_elem", "all_reset", "signed_zero"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_plain_matches_reference_on_special_rows(pattern, reverse, ref):
    """A shared geometry row with no elem (every output is the seed), one
    of resets only (every output reset_val), and values of +0.0 and -0.0
    only with seeds of both signs: equal to the JAX scan, inclusive and
    exclusive."""
    BT, n = 3, 700
    values, elem, reset, phase, init = _operands(11, BT, 1, n,
                                                 special=False)
    if pattern == "no_elem":
        elem[:] = False
        reset[:] = False
    elif pattern == "all_reset":
        reset[:] = True
    else:
        values = np.where(np.random.default_rng(3).random((BT, n)) < 0.5,
                          np.float32(0.0), np.float32(-0.0))
        init = np.array([[0.0, -0.0, 0.0], [-0.0, 0.0, -0.0],
                         [-1.0, 0.0, 1.0]], np.float32)
        reset[:] = False
    for exclusive in (False, True):
        ref_own, ref_final = _reference(ref, values, elem, reset, phase,
                                        -1e4, init, reverse, exclusive)
        own, final = _plain(values, elem, reset, phase, -1e4, init, reverse,
                            exclusive)
        np.testing.assert_array_equal(own.numpy(), ref_own)
        np.testing.assert_array_equal(final.numpy(), ref_final)
        if pattern == "no_elem":
            expect = np.take_along_axis(init, np.broadcast_to(
                phase, (BT, n)).astype(np.int64), 1)
            np.testing.assert_array_equal(own.numpy(), expect)
        if pattern == "all_reset" and not exclusive:
            assert (own.numpy() == np.float32(-1e4)).all()


def test_keys_run_along_the_walk():
    """`seg_scan_keys` (the library yardstick's operand in chip_smoke.py):
    a cummax of the keys along the walk, masked to 32 bits and mapped
    back, is the twin's running max wherever a reset was seen."""
    values, elem, reset, phase, init = _operands(5, 4, 1, 300)
    args = [torch.from_numpy(a) for a in (values, elem, reset, phase)]
    keys, seg = star_cuda.seg_scan_keys(*args, -1e4, False)
    assert keys.shape == seg.shape == (4, 300, 3)
    ms = star_cuda._unordered(torch.cummax(keys, 1).values
                              & star_cuda._MASK32)
    own, _ = star_cuda.seg_scan_plain(*args, -1e4, torch.from_numpy(init),
                                      False, False)
    sel = seg.gather(2, args[3].long()[..., None].expand(4, -1, 1))[..., 0]
    pick = ms.gather(2, args[3].long()[..., None].expand(4, -1, 1))[..., 0]
    assert bool((sel > 0).any())
    assert torch.equal(own[sel > 0], pick[sel > 0])


@needs_bins
def test_scoring_through_seg_scan_matches_reference(data, monkeypatch,
                                                    ref):
    """`tsd.score_only` on one shared geometry (the first 12,288 bp of
    SRR492066, 8 bins) reaches the scan through `star_cuda.seg_scan`
    four times, and its cscore equals the JAX package's within the bound
    of `tests/test_torch_score.py::test_cscore_within_prefix_sum_rounding`
    (6 d, d the prefix sums' rounding, and rtol 1e-5 for the length
    factor's exp/log1p); the geometry fields exactly, the start scores to
    rtol 1e-5."""
    jsd, jnp, TpuMetaRunner = ref
    runner = TpuMetaRunner(METAGENOMIC_BINS, interpret=True)
    seq = Sequence(list(parse(data("SRR492066.fna.gz")))[0].seq[:12288])
    cand, geoms, _nbt, _route = runner._prepare_contig(seq)
    g = geoms[list(geoms)[0]]
    NT = 2048 * ((g["nn"] + 2047) // 2048)
    SB = 196608
    packed = jsd.pack_geometries([g], 1, NT, SB)
    bin_idx = np.zeros(8, np.int32)
    bin_idx[:len(cand[:8])] = cand[:8]
    nonsd = runner.tables.any_nonsd
    want = jsd.score_only(
        runner.tables.as_tuple(),
        {k: jnp.asarray(v) for k, v in packed.items()},
        jnp.asarray(bin_idx), jnp.zeros(8, jnp.int32), is_meta=True,
        closed=False, S3=SB // 3, has_nonsd=nonsd, relk=32, max_overlap=60)
    want = [np.asarray(a) for a in want]
    tables = tsd.BinTables.from_numpy(
        tuple(np.asarray(a) for a in runner.tables.as_tuple()))

    calls = []
    orig = star_cuda.seg_scan

    def counted(*a):
        calls.append(a[6:])                     # (reverse, exclusive)
        return orig(*a)

    monkeypatch.setattr(star_cuda, "seg_scan", counted)
    got = tsd.score_only(tables.as_tuple(), tsd.to_device(packed, "cpu"),
                         torch.from_numpy(bin_idx.astype(np.int64)), None,
                         is_meta=True, closed=False, has_nonsd=nonsd)
    got = [a.numpy() for a in got]
    assert calls == [(False, False), (True, False), (False, True),
                     (True, True)]
    for k in (0, 1, 2, 3, 4, 5, 11):
        assert np.array_equal(got[k], want[k]), k
    geo = tsd.to_device(packed, "cpu")
    dc = tables.gene_dc[torch.from_numpy(bin_idx.astype(np.int64))].double()
    sum_abs = max(float(dc[:, m6[0].long()].abs().reshape(8, -1, 3).sum(1)
                        .max()) for m6 in tsd._derive_m6(geo))
    d = (2 * math.log2(math.ceil(SB / 3)) + 1) * 2.0 ** -24 * sum_abs
    assert np.allclose(got[6], want[6], rtol=1e-5, atol=6 * d)
    for k in (7, 8, 9):
        assert np.allclose(got[k], want[k], rtol=1e-5, atol=1e-5), k


def _bits(t):
    return t.contiguous().view(torch.int32)


def _kernel_vs_plain(ops, device, reset_val=-1e4):
    """The kernel against the twin on the card, every direction and form,
    bit for bit; each call launches the kernel once."""
    args = [torch.from_numpy(a).to(device) for a in ops[:4]]
    init = torch.from_numpy(ops[4]).to(device)
    for reverse in (False, True):
        for exclusive in (False, True):
            before = star_cuda.LAUNCHES["seg_scan"]
            own, final = star_cuda.seg_scan(*args, reset_val, init, reverse,
                                            exclusive)
            torch.cuda.synchronize()
            assert star_cuda.LAUNCHES["seg_scan"] == before + 1
            ref_own, ref_final = star_cuda.seg_scan_plain(
                *args, reset_val, init, reverse, exclusive)
            assert torch.equal(_bits(own), _bits(ref_own)), \
                (reverse, exclusive)
            assert torch.equal(_bits(final), _bits(ref_final)), \
                (reverse, exclusive)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "per_row"])
@pytest.mark.parametrize("B", [1, 16, 128])
@pytest.mark.parametrize("n", [T - 1, T, T + 1, 3 * T + 5])
def test_kernel_bit_equal_at_tile_edges(n, B, layout, cuda_device):
    """Every tile edge (n = T-1, T, T+1, 3T+5), one to 128 rows, a shared
    geometry row and one per row (with a row of no elem and one of resets
    only when there are more than two)."""
    ops = _operands(n + B, B, 1 if layout == "shared" else B, n)
    _kernel_vs_plain(ops, cuda_device)


@pytest.mark.cuda
def test_kernel_bit_equal_past_a_block_of_tiles(cuda_device):
    """The runner's largest mega bucket, 1,048,576 nodes (456 tiles):
    past 256 tiles each thread of the scan combines a run of tile
    summaries into the carry before the block combines the runs."""
    n = 1048576
    assert -(-n // T) > 256
    _kernel_vs_plain(_operands(17, 2, 1, n), cuda_device)


@pytest.mark.cuda
def test_kernel_bit_equal_on_signed_zeros_and_ties(cuda_device):
    """Values of +0.0 and -0.0 only, ties among them, and seeds of both
    signs: the kernel's order-preserving keys and its torch.maximum rule
    give the twin's bits."""
    BT, n = 6, 2 * T + 17
    rng = np.random.default_rng(9)
    values = np.where(rng.random((BT, n)) < 0.5, np.float32(0.0),
                      np.float32(-0.0))
    elem = rng.random((1, n)) < 0.7
    reset = rng.random((1, n)) < 0.002
    phase = rng.integers(0, 3, (1, n)).astype(np.int32)
    init = np.array([[0.0, -0.0, 0.0], [-0.0, 0.0, -0.0], [-1.0, 0.0, 1.0],
                     [0.0, 0.0, 0.0], [-0.0, -0.0, -0.0], [5.0, -5.0, 0.0]],
                    np.float32)
    _kernel_vs_plain((values, elem, reset, phase, init), cuda_device,
                     reset_val=0.0)


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda_device):
    values, elem, reset, phase, init = (
        torch.from_numpy(a).to(cuda_device)
        for a in _operands(1, 4, 1, 100))
    with pytest.raises(ValueError):
        star_cuda.seg_scan(values, elem, reset, phase.long(), -1e4, init,
                           False, False)
    with pytest.raises(ValueError):
        star_cuda.seg_scan(values, elem[:, :50], reset, phase, -1e4, init,
                           False, False)
    with pytest.raises(ValueError):
        star_cuda.seg_scan(values, elem.expand(2, -1).contiguous(),
                           reset.expand(2, -1).contiguous(),
                           phase.expand(2, -1).contiguous(), -1e4, init,
                           False, False)
