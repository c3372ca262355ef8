"""The port's multi-device layer (`pyrodigal_tpu_torch.parallel`) on CPU
meshes, the twin of tests/test_parallel.py: the mesh, the hexamer tallies
and `train_distributed` against the serial tally, the exact C engine and
the JAX package's `parallel` functions; `CudaMetaRunner(mesh=...)` on both
routes against refcore's bytes and, per (contig, bin),
exactly against the unsharded runner's best scores (the plain twins score
each row alone, so a row's result cannot depend on its shard); the
launch counters under concurrent threads; and, on a card, two shards on
one card, a mesh over every card, and each kernel wrapper on a card that
is not the current one."""

import io
import sys
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pyrodigal_tpu_torch  # noqa: E402
from pyrodigal_tpu_torch import METAGENOMIC_BINS  # noqa: E402
from pyrodigal_tpu_torch import _build  # noqa: E402
from pyrodigal_tpu_torch.fasta import parse  # noqa: E402
from pyrodigal_tpu_torch.ops import dp_cuda, meta_cuda, star_cuda  # noqa: E402
from pyrodigal_tpu_torch.ops.meta_cuda import CudaMetaRunner  # noqa: E402
from pyrodigal_tpu_torch.parallel import (  # noqa: E402
    make_mesh, sharded_background_counts, train_distributed,
)

needs_bins = pytest.mark.skipif(
    len(METAGENOMIC_BINS) == 0,
    reason="metagenomic bins asset not built (scripts/build_bins.py)",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run shares the cores among several pytest workers; torch's
    intra-op thread pool on top of that slows these small ops many-fold
    (each shard runs in a thread of its own on top)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_parallel():
    """The JAX package's `parallel` on its 8-device CPU mesh
    (tests/conftest.py); imported here, so that the card tests of this
    file run on a host without jax."""
    pytest.importorskip("jax")
    import pyrodigal_tpu.parallel

    return pyrodigal_tpu.parallel


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.cuda.device_count()


def _srr(data):
    return list(parse(data("SRR492066.fna.gz")))[0].seq


def _refcore_train(*seqs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pyrodigal_tpu_torch.GeneFinder(backend="refcore").train(*seqs)


# --------------------------------------------------------------------------
# the mesh and the training tallies
# --------------------------------------------------------------------------

def test_make_mesh():
    if torch.cuda.is_available():
        assert make_mesh().size == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1)
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert make_mesh(3, devices=["cpu"] * 8).size == 3
    for n in (0, 9):
        with pytest.raises(ValueError):
            make_mesh(n, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    # shards run in order, each from its own thread
    seen = mesh.run(lambda k, dev: (k, str(dev), threading.get_ident()))
    assert [s[:2] for s in seen] == [(k, "cpu") for k in range(8)]
    assert threading.get_ident() not in {s[2] for s in seen}


def _serial_tally(digits):
    """Both strands' hexamer counts, one position at a time (N is digit
    4; its code bits are `& 3`, as in the C scan)."""
    comp = np.where(digits < 4, 3 - digits, digits)[::-1]
    serial = np.zeros(4096, np.int64)
    for strand in (digits, comp):
        for i in range(len(strand) - 5):
            idx = 0
            for j in range(6):
                idx |= (int(strand[i + j]) & 3) << (2 * j)
            serial[idx] += 1
    return serial


@pytest.mark.parametrize("with_n", [False, True], ids=["acgt", "with_N"])
def test_background_counts_equal_serial_and_jax(jax_parallel, with_n):
    rng = np.random.default_rng(1)
    L = 3000
    digits = rng.integers(0, 5 if with_n else 4, size=L).astype(np.uint8)
    assert (digits == 4).any() == with_n
    counts = sharded_background_counts(make_mesh(devices=["cpu"] * 8),
                                       digits)
    serial = _serial_tally(digits)
    assert counts.dtype == np.int64
    assert counts.sum() == serial.sum() == 2 * (L - 5)
    assert np.array_equal(counts, serial)
    ref = np.asarray(jax_parallel.sharded_background_counts(
        jax_parallel.make_mesh(), digits))
    assert np.array_equal(counts, ref)


def _uneven_contigs(seq):
    """tests/test_parallel.py's five-contig training set: uneven sizes,
    more contigs than some mesh axes, one tiny contig."""
    cuts = [0, 11000, 30011, 30500, 61000, len(seq)]
    return [seq[cuts[k]:cuts[k + 1]] for k in range(5)]


@pytest.fixture(scope="module")
def jax_trained(data, jax_parallel):
    """The JAX package's `train_distributed` on its 8-device CPU mesh, per
    training set, made once."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = bytes(jax_parallel.train_distributed(
                jax_parallel.make_mesh(), *_training_set(data, case)).raw)
        return cache[case]

    return get


def _training_set(data, case):
    seq = _srr(data)
    return [seq] if case == "whole" else _uneven_contigs(seq)


@pytest.mark.parametrize("case", ["whole", "five_contigs"])
@pytest.mark.parametrize("D", [8, 3])
def test_train_distributed_bit_equal(data, jax_trained, case, D):
    """`train_distributed`'s model is byte-equal to the exact engine's
    `train` on the same (joined) input and to the JAX package's
    `train_distributed`."""
    seqs = _training_set(data, case)
    ref = _refcore_train(*seqs)
    tinf = train_distributed(make_mesh(devices=["cpu"] * D), *seqs)
    assert bytes(tinf.raw) == bytes(ref.raw)
    assert bytes(tinf.raw) == jax_trained(case)


# --------------------------------------------------------------------------
# the launch counters under concurrent shards
# --------------------------------------------------------------------------

def test_launch_counts_exact_under_threads():
    """Sixteen threads bump one counter with a short switch interval; a
    lost update would leave the totals short."""
    counts = _build.LaunchCounts("a", "b")
    devices = [torch.device("cuda", k % 2) for k in range(16)]
    n = 2000
    start = threading.Barrier(len(devices))

    def bump(k):
        start.wait()
        for i in range(n):
            counts.bump("ab"[i % 2], devices[k], k)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump, args=(k,))
                   for k in range(len(devices))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert dict(counts) == {"a": 8 * n, "b": 8 * n}
    detail = counts.detail()
    assert len(detail) == 32
    assert all(v == n // 2 for v in detail.values())
    assert detail[("a", 1, 3)] == n // 2
    counts.reset()
    assert dict(counts) == {"a": 0, "b": 0} and counts.detail() == {}


def test_wrappers_count_no_launch_on_the_cpu():
    """On CPU tensors the wrappers run their plain twins and count
    nothing, so a CPU mesh adds no launch."""
    before = {**star_cuda.LAUNCHES, **dp_cuda.LAUNCHES}
    x = torch.ones((2, 30), dtype=torch.float32)
    assert star_cuda.phase_cumsum(x)[0, -1] == 10.0
    table = torch.ones((2, 4096), dtype=torch.float32)
    codes = torch.zeros(30, dtype=torch.int32)
    assert star_cuda.dc_phase_cumsum(table, codes)[1, -1] == 10.0
    assert {**star_cuda.LAUNCHES, **dp_cuda.LAUNCHES} == before


# --------------------------------------------------------------------------
# the sharded runner on the CPU
# --------------------------------------------------------------------------

def _contigs(data, route):
    seq = _srr(data)
    if route == "mega":
        # two 15 kb contigs, packed as the runner packs them
        return [seq[:15000], seq[30000:45000]]
    kk = list(parse(data("KK037166.fna.gz")))[0].seq
    # one std launch of 56 (contig, bin) rows
    return [seq[:24000], kk, seq[30000:40000], seq[50000:60000]]


def _recording(runner):
    """Wrap the runner's two sweeps to log [(sweep, work, best scores)] in
    launch order (one launcher thread runs them in dispatch order)."""
    log = []
    for name in ("_sweep_std", "_sweep_mega_multi"):
        orig = getattr(runner, name)

        def record(*args, _orig=orig, _name=name):
            out = _orig(*args)
            log.append((_name, args, out))
            return out

        setattr(runner, name, record)
    return log


def _launch_key(entry):
    """What a logged launch ran: its sweep and its (contig, bin) rows."""
    name, args, _out = entry
    if name == "_sweep_std":
        return name, args[0]
    return name, [(it["ci"], it["rows"]) for it in args[0]]


def _real_scores(entry):
    """The best scores of a logged launch's real rows (pads dropped)."""
    name, args, out = entry
    if name == "_sweep_std":
        return out[:len(args[0])]
    best, rows, _CP, _B = out
    return best[:len(args[0]), :len(rows)]


def _run(route, seqs, mesh):
    """(genes, launch log, route counts) of one find_genes_batch call."""
    runner = CudaMetaRunner(METAGENOMIC_BINS, device="cpu", mesh=mesh)
    log = _recording(runner)
    saved = meta_cuda.SEQ_BUCKET
    if route == "mega":
        meta_cuda.SEQ_BUCKET = 2048
    try:
        genes = runner.find_genes_batch(seqs)
    finally:
        meta_cuda.SEQ_BUCKET = saved
        runner.close()
    return genes, log, runner.route_counts


@pytest.fixture(scope="module")
def unsharded(data):
    """The unsharded CPU runner's run per route, made once."""
    cache = {}

    def get(route):
        if route not in cache:
            cache[route] = _run(route, _contigs(data, route), None)
        return cache[route]

    return get


def _outputs(genes):
    out = []
    for write in (genes.write_gff, genes.write_genes,
                  genes.write_translations):
        f = io.StringIO()
        write(f, "contig")
        out.append(f.getvalue())
    return out


@needs_bins
@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("route", ["std", "mega"])
def test_sharded_runner_equals_unsharded_and_refcore(data, unsharded, route,
                                                      D):
    """Output bytes equal refcore's, and every per-(contig, bin) best score
    of every launch exactly equals the unsharded runner's; D = 3 pads the
    rows (the mega route's 8 or 16 bin rows, the std route's blocks of
    16) to a multiple of the mesh."""
    seqs = _contigs(data, route)
    mesh = make_mesh(devices=["cpu"] * D)
    got, log, routes = _run(route, seqs, mesh)
    _u_genes, u_log, u_routes = unsharded(route)
    assert routes == u_routes
    assert routes[route] == len(seqs)
    finder = pyrodigal_tpu_torch.GeneFinder(meta=True, backend="refcore")
    ref = [finder.find_genes(s) for s in seqs]
    for a, b in zip(ref, got):
        assert _outputs(b) == _outputs(a)
    assert len(log) == len(u_log) > 0
    for entry, u_entry in zip(log, u_log):
        assert _launch_key(entry) == _launch_key(u_entry)
        got_best, u_best = _real_scores(entry), _real_scores(u_entry)
        assert got_best.shape == u_best.shape and got_best.size > 0
        assert np.array_equal(got_best, u_best)
    # the padded row count splits evenly over the mesh
    for name, args, out in log:
        rows = out.shape[0] if name == "_sweep_std" else out[3]
        assert rows % D == 0
        if name == "_sweep_std":
            assert rows % (D * meta_cuda.BLOCK) == 0


def test_sharded_launch_rejects_uneven_rows():
    from pyrodigal_tpu_torch.parallel import sharded_score_dp_launch_mega

    with pytest.raises(ValueError, match="split evenly"):
        sharded_score_dp_launch_mega(
            make_mesh(devices=["cpu"] * 3), [None] * 3, {},
            np.zeros(8, np.int64), closed=False, has_nonsd=False, relk=32,
            max_overlap=60, fxs=2048)


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------

def _card_contigs(data):
    seq = _srr(data)
    big = list(parse(data(
        "GCF_001457455.1_NCTC11397_genomic_100kb.fna.gz")))[0].seq
    kk = list(parse(data("KK037166.fna.gz")))[0].seq
    return [big, seq, kk, seq[:24000], seq[30000:52000]]


def _card_runs(data, mesh):
    """The contigs through an unsharded runner and a sharded one on the
    card: (refcore genes, [(genes, launch log, launch tally)] for
    unsharded and sharded)."""
    seqs = _card_contigs(data)
    finder = pyrodigal_tpu_torch.GeneFinder(meta=True, backend="refcore")
    ref = [finder.find_genes(s) for s in seqs]
    runs = []
    for m in (None, mesh):
        runner = CudaMetaRunner(METAGENOMIC_BINS, device="cuda:0", mesh=m)
        log = _recording(runner)
        star_cuda.LAUNCHES.reset()
        dp_cuda.LAUNCHES.reset()
        genes = runner.find_genes_batch(seqs)
        torch.cuda.synchronize()
        tally = {**star_cuda.LAUNCHES.detail(), **dp_cuda.LAUNCHES.detail()}
        runner.close()
        assert runner.route_counts["std"] and runner.route_counts["mega"]
        runs.append((genes, log, tally))
    return ref, runs


def _check_card_runs(ref, runs, mesh):
    (u_genes, u_log, _u), (genes, log, tally) = runs
    for a, b, c in zip(ref, u_genes, genes):
        assert _outputs(b) == _outputs(a)
        assert _outputs(c) == _outputs(a)
    assert len(log) == len(u_log) > 0
    for entry, u_entry in zip(log, u_log):
        assert _launch_key(entry) == _launch_key(u_entry)
        got_best, u_best = _real_scores(entry), _real_scores(u_entry)
        bound = 0.1 * (1.0 + 1e-4 * np.abs(u_best))
        assert (np.abs(got_best - u_best) <= bound).all()
    # every shard launched every kernel on its device and stream
    for k, dev in enumerate(mesh.devices):
        stream = mesh.stream(k).cuda_stream
        for kernel in ("dc_chain", "phase_cumsum", "star", "dp_mega",
                       "dp_std"):
            assert tally.get((kernel, dev.index, stream), 0) > 0, \
                (kernel, k)


@pytest.mark.cuda
@needs_bins
def test_two_shards_on_one_card(data, cuda_device):
    mesh = make_mesh(devices=[cuda_device] * 2)
    ref, runs = _card_runs(data, mesh)
    _check_card_runs(ref, runs, mesh)


@pytest.mark.cuda
@needs_bins
def test_mesh_over_every_card(data, two_cards):
    mesh = make_mesh()
    assert mesh.size == two_cards
    ref, runs = _card_runs(data, mesh)
    _check_card_runs(ref, runs, mesh)
    seq = _srr(data)
    tinf = train_distributed(mesh, *_uneven_contigs(seq))
    assert bytes(tinf.raw) == bytes(_refcore_train(*_uneven_contigs(seq))
                                    .raw)


WRAPPERS = {
    "dc_chain": (star_cuda, "dc_phase_cumsum"),
    "phase_cumsum": (star_cuda, "phase_cumsum"),
    "star": (star_cuda, "star_tables"),
    "dp_mega": (dp_cuda, "mega_dp"),
    "dp_std": (dp_cuda, "std_dp"),
}


def _captured_cpu_calls(data, route):
    """{kernel: (arguments, plain output)} of a CPU runner's first launch
    of `route` on a short slice, recorded at the wrappers."""
    calls = {}
    saved = [(mod, name, getattr(mod, name))
             for mod, name in WRAPPERS.values()]
    for kernel, (mod, name) in WRAPPERS.items():
        orig = getattr(mod, name)

        def record(*a, _orig=orig, _kernel=kernel):
            out = _orig(*a)
            calls.setdefault(_kernel, (a, out))
            return out

        setattr(mod, name, record)
    old_bucket = meta_cuda.SEQ_BUCKET
    if route == "mega":
        meta_cuda.SEQ_BUCKET = 2048
    try:
        runner = CudaMetaRunner(METAGENOMIC_BINS, device="cpu")
        runner.find_genes_batch([_srr(data)[:6000]])
        runner.close()
    finally:
        meta_cuda.SEQ_BUCKET = old_bucket
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    return calls


@pytest.mark.cuda
@needs_bins
@pytest.mark.parametrize("route", ["std", "mega"])
def test_wrappers_launch_on_their_tensors_card(data, two_cards, route):
    """Each wrapper of the route, given tensors on the last card while
    card 0 is current, launches there (on that card's current stream)
    and agrees with its plain twin as chip_smoke.py holds it: the prefix
    sums within their round-once bound, star's integers exactly and its
    floats to rtol 1e-6, the DPs exactly."""
    last = torch.device("cuda", two_cards - 1)
    calls = _captured_cpu_calls(data, route)
    kernels = ({"dc_chain", "star", "dp_mega"} if route == "mega"
               else {"phase_cumsum", "star", "dp_std"})
    assert kernels <= set(calls)
    for kernel in sorted(kernels):
        args, ref = calls[kernel]
        mod, name = WRAPPERS[kernel]
        moved = [a.to(last) if torch.is_tensor(a) else a for a in args]
        star_cuda.LAUNCHES.reset()
        dp_cuda.LAUNCHES.reset()
        with torch.cuda.device(0):
            got = getattr(mod, name)(*moved)
            torch.cuda.synchronize(last)
        stream = torch.cuda.current_stream(last).cuda_stream
        tally = {**star_cuda.LAUNCHES.detail(), **dp_cuda.LAUNCHES.detail()}
        assert tally == {(kernel, last.index, stream): 1}
        if kernel in ("dc_chain", "phase_cumsum"):
            x_abs = (args[0][:, args[1].long()] if kernel == "dc_chain"
                     else args[0]).abs()
            bound = star_cuda.round_once_bound(x_abs, ref)
            assert ((got.cpu().double() - ref.double()).abs()
                    <= bound).all()
        elif kernel == "star":
            for i, (a, b) in enumerate(zip(got, ref)):
                if a.dtype == torch.int32:
                    assert torch.equal(a.cpu(), b), i
                else:
                    torch.testing.assert_close(a.cpu(), b, rtol=1e-6,
                                               atol=0)
        else:
            for a, b in zip(got, ref):
                assert torch.equal(a.cpu(), b)
