"""The scoring passes' segmented running maxima: the plain twins
(`star_cuda.seg_scan_plain`, one walk, and `seg_scan_passes_plain`, the
four walks of passes 2 and 3 chained) against the JAX package's
`score_device._seg_scan` followed by `_sel_phase` (both of its branches:
one associative scan up to 4,096 nodes, the blocked scan above), scoring
through the new call path against the JAX package's, and the CUDA kernel
(`csrc/seg_scan.cu`, `star_cuda.seg_scan_passes`) bit-equal to the twin
on a card.  JAX is imported by the tests that hold the port against it
(the `ref` fixture), so that the card's tests run where JAX is not
installed."""

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
L = star_cuda.SEG_ROW_LIMIT


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


def _pass_operands(seed, BT, R, n, special=True):
    """Operands of the four chained walks from numpy: cscore and lfac_raw
    (BT, n) f32 with +0.0, -0.0 and ties among them (and NaNs in bin row
    0 with `special`), code (R, n) uint8.  With `special` and R > 3,
    geometry row 1 holds no start, row 2 is all stops, and row 3 has its
    resets on the chain's walk boundary: a stop at node 0, a reverse node
    and so r2's last walk position, and no forward stop, so that f3 sees
    no reset and runs on r2's finals throughout."""
    rng = np.random.default_rng(seed)

    def values():
        v = (rng.normal(size=(BT, n)) * 10).astype(np.float32)
        tie = rng.random((BT, n)) < 0.2
        v[tie] = np.round(v[tie] / 5.0) * 5.0
        v[rng.random((BT, n)) < 0.1] = 0.0
        v[rng.random((BT, n)) < 0.1] = -0.0
        if special:
            v[0, rng.random(n) < 0.01] = np.nan
        return v

    cscore, lfac = values(), values()
    start = rng.random((R, n)) < 0.4
    stop = rng.random((R, n)) < 0.05
    fwd = rng.random((R, n)) < 0.5
    phase = rng.integers(0, 3, (R, n))
    if special and R > 3:
        start[1] = False
        stop[2] = True
        _on_the_boundary(start[3], stop[3], fwd[3])
    return cscore, lfac, _code(phase, start, stop, fwd)


def _on_the_boundary(start, stop, fwd):
    """One geometry row with its resets on the chain's walk boundary, in
    place: node 0 a reverse stop, no forward stop."""
    fwd[0] = False
    stop &= ~fwd
    stop[0] = True


def _code(phase, start, stop, fwd):
    return (phase + 4 * start + 8 * stop + 16 * fwd).astype(np.uint8)


def _reference_passes(ref, cscore, lfac, code, reset_val=-1e4):
    """The JAX package's passes 2 and 3 on the same operands, chained as
    its `_score_items` chains them (score_device.py:832-865): (run2, run3)
    as numpy."""
    jsd, jnp, _runner = ref
    BT, n = cscore.shape
    phase = (code & 3).astype(np.int32)
    start, stop, fwd = ((code >> s) & 1 == 1 for s in (2, 3, 4))
    ph1 = np.eye(3, dtype=bool)[phase]                  # (R, n, 3)

    def chan(pred):
        return jnp.asarray(np.broadcast_to(pred[..., None] & ph1,
                                           (BT, n, 3)))

    def sel(scan):
        return jsd._sel_phase(scan, jnp.asarray(phase))

    neg1e4 = jnp.full((BT, 3), -1e4, jnp.float32)
    fwdb = jnp.asarray(np.broadcast_to(fwd, (BT, n)))
    v_c = jnp.broadcast_to(jnp.asarray(cscore)[..., None], (BT, n, 3))
    inc_f, _, _ = jsd._seg_scan(v_c, chan(start & fwd), chan(stop & fwd),
                                reset_val, neg1e4, False)
    inc_r, _, fin2r = jsd._seg_scan(v_c, chan(start & ~fwd),
                                    chan(stop & ~fwd), reset_val, neg1e4,
                                    True)
    run2 = jnp.where(fwdb, sel(inc_f), sel(inc_r))
    v_l = jnp.broadcast_to(jnp.asarray(lfac)[..., None], (BT, n, 3))
    _, exc3f, fin3f = jsd._seg_scan(v_l, chan(start & fwd),
                                    chan(stop & fwd), reset_val, fin2r,
                                    False)
    _, exc3r, _ = jsd._seg_scan(v_l, chan(start & ~fwd), chan(stop & ~fwd),
                                reset_val, fin3f, True)
    run3 = jnp.where(fwdb, sel(exc3f), sel(exc3r))
    return np.asarray(run2), np.asarray(run3)


def _assert_same(got, want):
    """Equal values (NaN where the reference has NaN; +0.0 and -0.0
    alike, which JAX's maximum orders as it finds them), and equal bits
    wherever the reference is neither zero nor NaN."""
    np.testing.assert_array_equal(got, want)
    plain = ~np.isnan(want) & (want != 0)
    np.testing.assert_array_equal(got.view(np.int32)[plain],
                                  want.view(np.int32)[plain])


def _passes_plain(cscore, lfac, code, reset_val=-1e4):
    return [a.numpy() for a in star_cuda.seg_scan_passes_plain(
        torch.from_numpy(cscore), torch.from_numpy(lfac),
        torch.from_numpy(code), reset_val)]


@pytest.mark.parametrize("n", [1500, 5000], ids=["one_scan", "blocked"])
@pytest.mark.parametrize("layout", ["shared", "per_row"])
def test_passes_plain_matches_reference(n, layout, ref):
    """The four chained walks equal the JAX package's passes 2 and 3,
    per-row rows including one with no start, one of stops only and one
    with its resets on the walk boundary, NaNs in bin row 0."""
    BT = 5
    ops = _pass_operands(n + 11, BT, 1 if layout == "shared" else BT, n)
    want = _reference_passes(ref, *ops)
    got = _passes_plain(*ops)
    for g, w in zip(got, want):
        assert g.shape == (BT, n) and g.dtype == np.float32
        _assert_same(g, w)


@pytest.mark.parametrize("pattern", ["no_elem", "all_reset", "signed_zero",
                                     "nan", "boundary"])
def test_passes_plain_matches_reference_on_special_rows(pattern, ref):
    """One shared geometry row with no start (every run2 output is the
    seed, every run3 output a final of the walk before), one of stops
    only, values of +0.0 and -0.0 only with reset_val 0.0, NaNs in
    every bin row, and resets on the walk boundary (r2's last position a
    reset, none in f3): equal to the JAX package's passes 2 and 3."""
    BT, n = 3, 700
    rng = np.random.default_rng(13)
    cscore, lfac, code = _pass_operands(17, BT, 1, n, special=False)
    phase = code & 3
    start, stop, fwd = ((code >> s) & 1 == 1 for s in (2, 3, 4))
    reset_val = -1e4
    if pattern == "no_elem":
        start[:] = False
        stop[:] = False
    elif pattern == "all_reset":
        stop[:] = True
    elif pattern == "signed_zero":
        cscore, lfac = (np.where(rng.random((BT, n)) < 0.5, np.float32(0.0),
                                 np.float32(-0.0)) for _ in range(2))
        stop &= rng.random((1, n)) < 0.2
        reset_val = 0.0
    elif pattern == "nan":
        for v in (cscore, lfac):
            v[rng.random((BT, n)) < 0.01] = np.nan
    else:
        _on_the_boundary(start[0], stop[0], fwd[0])
    code = _code(phase, start, stop, fwd)
    want = _reference_passes(ref, cscore, lfac, code, reset_val)
    got = _passes_plain(cscore, lfac, code, reset_val)
    for g, w in zip(got, want):
        _assert_same(g, w)
    if pattern in ("no_elem", "all_reset"):
        # no elem reaches a channel, so every output is -1e4: the seed,
        # reset_val or a final made of them
        for g in got:
            assert (g == np.float32(-1e4)).all()
    if pattern == "boundary":
        assert stop[0, 0] and not fwd[0, 0] and not (stop & fwd).any()


def test_seg_code_packs_what_the_twin_reads():
    """`seg_code` packs phase, start, stop and fwd as the twin and the
    kernel unpack them, in both layouts' shapes."""
    rng = np.random.default_rng(2)
    phase = torch.from_numpy(rng.integers(0, 3, (4, 50)).astype(np.int32))
    start, stop, fwd = (torch.from_numpy(rng.random((4, 50)) < 0.5)
                        for _ in range(3))
    code = star_cuda.seg_code(phase, start, stop, fwd)
    assert code.dtype == torch.uint8 and code.shape == (4, 50)
    assert torch.equal((code & 3).int(), phase)
    for s, want in ((2, start), (3, stop), (4, fwd)):
        assert torch.equal(((code >> s) & 1).bool(), want)


def test_passes_wrapper_runs_the_twin_on_the_cpu():
    """On CPU tensors `seg_scan_passes` is its twin, and counts no
    launch."""
    ops = [torch.from_numpy(a) for a in _pass_operands(3, 4, 4, 900)]
    before = star_cuda.LAUNCHES["seg_scan"]
    got = star_cuda.seg_scan_passes(*ops)
    want = star_cuda.seg_scan_passes_plain(*ops)
    assert star_cuda.LAUNCHES["seg_scan"] == before
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@needs_bins
def test_scoring_through_seg_scan_matches_reference(data, monkeypatch,
                                                    ref):
    """`tsd.score_only` on one shared geometry (the first 12,288 bp of
    SRR492066, 8 bins) reaches passes 2 and 3 through one
    `star_cuda.seg_scan_passes` call with one shared code row, and its
    cscore equals the JAX package's within the bound of
    `tests/test_torch_score.py::test_cscore_within_prefix_sum_rounding`
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
    orig = star_cuda.seg_scan_passes

    def counted(*a):
        calls.append(a)
        return orig(*a)

    monkeypatch.setattr(star_cuda, "seg_scan_passes", counted)
    got = tsd.score_only(tables.as_tuple(), tsd.to_device(packed, "cpu"),
                         torch.from_numpy(bin_idx.astype(np.int64)), None,
                         is_meta=True, closed=False, has_nonsd=nonsd)
    got = [a.numpy() for a in got]
    assert len(calls) == 1
    assert calls[0][0].shape == calls[0][1].shape == (8, NT)
    assert calls[0][2].dtype == torch.uint8
    assert calls[0][2].shape == (1, NT)
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


def _on(device, ops):
    return [torch.from_numpy(a).to(device) for a in ops]


def _kernel_vs_plain(ops, device, reset_val=-1e4):
    """The kernel against the twin on the card, both outputs bit for bit;
    the call launches the kernel once.  Returns the kernel's outputs."""
    args = _on(device, ops)
    before = star_cuda.LAUNCHES["seg_scan"]
    got = star_cuda.seg_scan_passes(*args, reset_val)
    torch.cuda.synchronize()
    assert star_cuda.LAUNCHES["seg_scan"] == before + 1
    want = star_cuda.seg_scan_passes_plain(*args, reset_val)
    for name, g, w in zip(("run2", "run3"), got, want):
        assert torch.equal(_bits(g), _bits(w)), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["shared", "per_row"])
@pytest.mark.parametrize("B", [1, 16, 128])
@pytest.mark.parametrize("n", [L - 1, L, L + 1, T - 1, T, T + 1, 3 * T + 5])
def test_kernel_bit_equal_at_tile_edges(n, B, layout, cuda_device):
    """Both sides of the one-block row limit (n = L-1, L, L+1) and every
    tile edge of the look-back (n = T-1, T, T+1, 3T+5), one to 128 rows,
    a shared geometry row and one per row (with a row of no start, one of
    stops only and one with its resets on the walk boundary when there
    are more than three)."""
    ops = _pass_operands(n + B, B, 1 if layout == "shared" else B, n)
    _kernel_vs_plain(ops, cuda_device)


@pytest.mark.cuda
def test_kernel_bit_equal_past_a_block_of_tiles(cuda_device):
    """The runner's largest mega bucket, 1,048,576 nodes (241 tiles a
    walk): past 32 tiles a look-back takes more than one window of
    predecessors, and the chain's 964 tiles a row outnumber the blocks
    the card holds at once."""
    n = 1048576
    assert -(-n // T) > 32
    _kernel_vs_plain(_pass_operands(17, 2, 1, n), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3000, 2 * T + 17], ids=["rows", "chain"])
def test_kernel_bit_equal_on_signed_zeros_and_ties(n, cuda_device):
    """Values of +0.0 and -0.0 only, ties among them and reset_val 0.0,
    then NaNs, then resets on the walk boundary: the kernel's
    order-preserving keys and its torch.maximum rule give the twin's
    bits, in both kernels."""
    BT = 6
    rng = np.random.default_rng(9)
    cscore, lfac, code = _pass_operands(n, BT, 1, n, special=False)
    zeros = [np.where(rng.random((BT, n)) < 0.5, np.float32(0.0),
                      np.float32(-0.0)) for _ in range(2)]
    sparse = code & ~np.uint8(8) | ((rng.random((1, n)) < 0.002)
                                    .astype(np.uint8) << 3)
    _kernel_vs_plain((*zeros, sparse), cuda_device, reset_val=0.0)
    nan = [v.copy() for v in (cscore, lfac)]
    for v in nan:
        v[rng.random((BT, n)) < 0.01] = np.nan
    _kernel_vs_plain((*nan, code), cuda_device)
    phase = code & 3
    start, stop, fwd = ((code >> s) & 1 == 1 for s in (2, 3, 4))
    _on_the_boundary(start[0], stop[0], fwd[0])
    _kernel_vs_plain((cscore, lfac, _code(phase, start, stop, fwd)),
                     cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3072, 163840], ids=["rows", "chain"])
def test_kernel_two_calls_bit_identical(n, cuda_device):
    """Two calls on the same operands give the same bits (the look-back's
    order among blocks changes from call to call; a max is exact)."""
    args = _on(cuda_device, _pass_operands(4, 16, 1, n))
    a = star_cuda.seg_scan_passes(*args)
    b = star_cuda.seg_scan_passes(*args)
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3072, 2 * T + 17], ids=["rows", "chain"])
def test_kernel_in_a_cuda_graph(n, cuda_device):
    """Three replays of one CUDA graph holding a call: each replay
    rewrites both outputs with the twin's bits, so the look-back's
    counter and flags are zeroed inside what the graph replays."""
    args = _on(cuda_device, _pass_operands(8, 16, 16, n))
    star_cuda.seg_scan_passes(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = star_cuda.seg_scan_passes(*args)
    want = star_cuda.seg_scan_passes_plain(*args)
    for _ in range(3):
        for o in out:
            o.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(out, want):
            assert torch.equal(_bits(o), _bits(w))


@pytest.mark.cuda
def test_kernel_on_two_streams_from_two_threads(cuda_device):
    """Two threads, each on a stream of its own on one card, calling at
    once (as a mesh's two shards on one card do): each call's scratch is
    its own, so both give the twin's bits."""
    import threading

    ops = [_on(cuda_device, _pass_operands(k, 8, 1, 163840 + 7 * k))
           for k in range(2)]
    out = [None, None]

    def run(k):
        stream = torch.cuda.Stream(cuda_device)
        with torch.cuda.stream(stream):
            for _ in range(5):
                out[k] = star_cuda.seg_scan_passes(*ops[k])
        stream.synchronize()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for k in range(2):
        want = star_cuda.seg_scan_passes_plain(*ops[k])
        for o, w in zip(out[k], want):
            assert torch.equal(_bits(o), _bits(w))


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda_device):
    cscore, lfac, code = _on(cuda_device, _pass_operands(1, 4, 1, 100))
    with pytest.raises(ValueError):
        star_cuda.seg_scan_passes(cscore, lfac, code.int())
    with pytest.raises(ValueError):
        star_cuda.seg_scan_passes(cscore, lfac, code[:, :50].contiguous())
    with pytest.raises(ValueError):
        star_cuda.seg_scan_passes(cscore, lfac,
                                  code.expand(2, -1).contiguous())
    with pytest.raises(ValueError):
        star_cuda.seg_scan_passes(cscore, lfac.double(), code)
