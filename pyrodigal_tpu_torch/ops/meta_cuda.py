"""Meta-mode gene calling on the GPU: the std and mega routes.

Port of `pyrodigal_tpu.ops.meta_tpu.TpuMetaRunner`.  Host prep (node
extraction, geometry) runs on a thread pool and picks each contig's
route as the JAX package does:

* "std": contigs of at most SEQ_BUCKET bp whose geometries fit the std
  buckets.  Launches hold one (contig, bin) work item per row with its
  own geometry (`score_device.score_dp_launch`: scoring, the
  phase-cumsum, star and std-DP kernels), contigs largest first, each
  launch padded to node and sequence buckets of its own
  (`std_buckets`);
* "mega": longer contigs, and short ones that overflow a std bucket,
  packed end to end into launches whose rows are the union of their
  candidate bins (`score_device.score_dp_launch_mega`: scoring, the
  dc-chain, star and mega-DP kernels);
* "c": mega geometries `_mega_ok` refuses; the exact C engine takes the
  whole contig, from the nodes prep extracted, its candidate bins side
  by side on a second pool (`_produce_fallback`).

Each launch returns one best path score per (contig, bin); the exact C
engine then re-runs the winning bin(s) of each contig, so the emitted
genes are the reference's byte for byte (reference: lib.pyx:5317-5396
for the sequential bin sweep this replaces).

Every launch goes through `parallel.meta_shard`: its rows split over
the runner's mesh (`pyrodigal_tpu_torch.parallel.make_mesh`), the bin
tables replicated on each mesh device, as the JAX package's runner does
with its `mesh` (meta_tpu.py:244-250, 362-388); without one, a one-device
mesh over `device` runs the whole launch.  The genes are the same either
way; a mesh is slower than one card today (`CudaMetaRunner`).
"""

import collections
import concurrent.futures
import ctypes
import threading
import time

import numpy as np

from .. import _native, tracing
from .._constants import STOP
from ..genes import Genes
from ..nodes import Nodes
from ..sequence import Sequence
from ..parallel.mesh import Mesh, canonical
from ..parallel.meta_shard import (sharded_score_dp_launch,
                                   sharded_score_dp_launch_mega)
from . import dp_cuda
from . import score_device as sd

# std route (the JAX package's TpuMetaRunner defaults): node and sequence
# buckets, the largest a contig on the route may fill; DP window and
# windows per node (the std DP kernel's); the row multiple a launch is
# rounded to
NODE_BUCKET = 3072
SEQ_BUCKET = 49152
WINDOW = dp_cuda.W_STD
FIXED_CHUNKS = dp_cuda.FIXED_CHUNKS
BLOCK = 16
# a std launch's own buckets (`std_buckets`): node rungs below NODE_BUCKET,
# and the step its sequence bucket is rounded up to
NODE_RUNGS = (256, 512, 768, 1024, 1536, 2048)
SEQ_STEP = 1024
# what a std launch may hold, padded: node-rows and sequence-rows (128 rows
# at NODE_BUCKET and SEQ_BUCKET), and rows (the per-row bin-table gathers
# of the scoring, (rows, 16, 4,096) f32, stay under 0.3 GB each)
NODE_ROW_BUDGET = 128 * 3072
SEQ_ROW_BUDGET = 128 * 49152
MAX_ROWS = 1024
# star scan span, in node indices (reference: lib.pyx:2279-2329)
RELK = 32
PREP_THREADS = 8


def std_buckets(nodes, slen):
    """(node bucket, sequence bucket) of a std launch whose largest
    geometry holds `nodes` nodes and whose longest contig `slen` bp: the
    smallest of NODE_RUNGS and NODE_BUCKET that holds the nodes, and the
    length rounded up to SEQ_STEP, at most SEQ_BUCKET.  Padding is
    invalid nodes and zero digits, so no row's scores depend on them."""
    n = next((r for r in NODE_RUNGS if nodes <= r < NODE_BUCKET),
             NODE_BUCKET)
    return n, min(max(-(-slen // SEQ_STEP), 1) * SEQ_STEP, SEQ_BUCKET)


# one bin's exact re-run (`CudaMetaRunner._run_bin`): the bin, its path's
# end (-1 without a path) and score, the nodes' count, and two node blocks
# (`_native.node_block_offsets`, None without nodes): `work` after the final
# DP and `snapshot` scored before it, whose scores the writers print
BinRun = collections.namedtuple(
    "BinRun", ("bin", "ipath", "score", "nn", "work", "snapshot"))


class CudaMetaRunner:
    """Batched meta-mode gene calling over `metagenomic_bins`, with
    on-device per-bin scoring.

    `mesh` (`parallel.make_mesh`) splits every launch's rows over its
    devices; by default a one-device mesh over `device` runs them all.
    A mesh gives the same genes but is slower than one card on both
    routes today: `chip_smoke.py` phase 5 (NVIDIA H100 80GB HBM3,
    700 W) measured two shards on one card at 1.26-1.33x the one-card
    warm wall on the mega route and 1.77-1.81x on the std route, four
    cards at 1.28x and 4.64x, because every shard repeats its rows'
    per-row host scoring under one interpreter lock."""

    # mega-route buckets (node count, sequence length); FXS = 2048 fixed
    # point up to MEGA_FXS_LIMIT bp, 1024 above (score range 2.1e6)
    MEGA_NT = (16384, 32768, 65536, 98304, 131072, 163840, 196608,
               262144, 327680, 393216, 458752, 589824, 786432, 1048576)
    MEGA_SB = (393216, 786432, 1179648, 1572864, 1966080, 2359296,
               2555904, 3145728, 4718592, 6291456, 7864320, 8650752,
               10616832, 13172736, 17301504)
    MEGA_FXS_LIMIT = 8650752
    # packed launches: bin-row union buckets, node/sequence caps per
    # launch, contig-count buckets
    MEGA_ROWB = (8, 16, 24)
    MEGA_PACK_NB = 196608
    MEGA_PACK_SB = 4718592
    MEGA_CP = (1, 2, 4, 8, 12, 16)
    # dispatch an open group as soon as it holds this many nodes
    MEGA_PACK_EAGER = 131072

    @tracing.setup("setup.runner")
    def __init__(self, metagenomic_bins, *, device, closed=False,
                 min_gene=90, min_edge_gene=60, max_overlap=60, mask=False,
                 min_mask=50, mesh=None):
        self.device = canonical(device)
        self.mesh = mesh if mesh is not None else Mesh([self.device])
        self.bins = metagenomic_bins
        self.closed = closed
        self.min_gene = min_gene
        self.min_edge_gene = min_edge_gene
        self.max_overlap = max_overlap
        self.mask = mask
        self.min_mask = min_mask
        self.tables = sd.BinTables(metagenomic_bins, self.device)
        # one replica per distinct mesh device, shared by the shards that
        # device holds
        replicas = {self.device: self.tables}
        for dev in self.mesh.devices:
            if dev not in replicas:
                replicas[dev] = sd.BinTables.from_numpy(
                    tuple(a.cpu().numpy() for a in self.tables.as_tuple()),
                    dev)
        self.shard_tables = [replicas[dev] for dev in self.mesh.devices]
        self.pool = concurrent.futures.ThreadPoolExecutor(PREP_THREADS)
        # the exact route's bins: tasks that never wait, so a `pool` thread
        # waiting on them cannot starve either pool
        self.bin_pool = concurrent.futures.ThreadPoolExecutor(PREP_THREADS)
        # device launches run in submission order on one thread
        self.launcher = concurrent.futures.ThreadPoolExecutor(1)
        self.route_counts = {"std": 0, "mega": 0, "c": 0}
        self._count_lock = threading.Lock()

    def close(self):
        self.pool.shutdown()
        self.bin_pool.shutdown()
        self.launcher.shutdown()

    # -- host side -----------------------------------------------------------

    def _candidate_bins(self, seq):
        low = min(0.65, 0.88495 * seq.gc - 0.0102337)
        high = max(0.35, 0.86596 * seq.gc + 0.1131991)
        return [
            i for i in range(len(self.bins))
            if low <= self.bins[i].training_info.gc <= high
        ]

    def _mega_ok(self, g):
        """Geometry constraints of the mega DP kernel's window and ring."""
        return self._mega_refusal(g) is None

    def _mega_refusal(self, g):
        """The first constraint of the mega DP kernel that geometry `g`
        breaks ("nodes", "star_overflow", "length", "window", "density" or
        "ring"), or None when the kernel takes it."""
        nn = g["nn"]
        if nn == 0 or nn > self.MEGA_NT[-1]:
            return "nodes"
        if g["star_overflow"]:
            return "star_overflow"
        if g["slen"] > self.MEGA_SB[-1]:
            return "length"
        ext = int((np.arange(nn) - g["win_lo"]).max())
        if ext > dp_cuda.MEGA_CHUNKS * dp_cuda.W_MEGA:
            return "window"
        # the kind-2 overlap window reads 384 lanes at the node offset of
        # stop_val[i]-3; its candidates lie within 200 bp, so bound the node
        # count of any 200-bp span (250 + up to 127 alignment lanes <= 384)
        ndx_sorted = np.sort(g["ndx"][:nn])
        if int((np.searchsorted(ndx_sorted, ndx_sorted + 200)
                - np.arange(nn)).max()) > 250:
            return "density"
        # the fwd-stop ring serving fwd-start targets must cover every fwd
        # stop in any [win_lo(i), i) window
        fstop = ((g["typ"][:nn] == STOP)
                 & (g["strand"][:nn] == 1)).astype(np.int64)
        cumf = np.concatenate([[0], np.cumsum(fstop)])
        idx = np.arange(nn)
        fstart = (g["typ"][:nn] != STOP) & (g["strand"][:nn] == 1)
        in_win = np.where(fstart, cumf[idx] - cumf[g["win_lo"][:nn]], 0)
        return "ring" if int(in_win.max()) > dp_cuda.MEGA_RING else None

    def _prepare_contig(self, seq):
        """Returns (bin_ids, geoms, nodes_by_tt, route), route one of "std",
        "mega" or "c" (meta_tpu.py:169-204)."""
        cand = self._candidate_bins(seq)
        geoms, nodes_by_tt = {}, {}
        for b in cand:
            tt = self.bins[b].training_info.translation_table
            if tt in geoms:
                continue
            with tracing.span("prep.nodes", tt=tt):
                nodes = Nodes()
                nodes.extract(
                    seq, translation_table=tt, closed=self.closed,
                    min_gene=self.min_gene, min_edge_gene=self.min_edge_gene,
                )
                nodes.sort()
            nodes_by_tt[tt] = nodes
            with tracing.span("prep.geometry", tt=tt):
                geoms[tt] = sd.prepare_geometry(seq, nodes, tt, self.closed,
                                                self.max_overlap, RELK)
        with tracing.span("prep.route"):
            route, refused = self._route(seq, geoms)
        sp = tracing.current("prep")
        if sp:
            sp.set(route=route, nodes={tt: g["nn"] for tt, g in geoms.items()},
                   route_reason=(self._mega_refusal(refused)
                                 if refused is not None else None))
        return cand, geoms, nodes_by_tt, route

    def _route(self, seq, geoms):
        """(route, the geometry `_mega_ok` refused or None): "std" when the
        contig and each of its geometries fit the std buckets, else "mega"
        when every geometry fits the mega kernel, else "c"."""
        if seq.slen <= SEQ_BUCKET and not any(
                g["nn"] > NODE_BUCKET or g["star_overflow"]
                or (g["nn"] and int((np.arange(g["nn"]) - g["win_lo"]).max())
                    > FIXED_CHUNKS * WINDOW)
                for g in geoms.values()):
            return "std", None
        refused = next((g for g in geoms.values() if not self._mega_ok(g)),
                       None)
        return ("mega" if refused is None else "c"), refused

    # -- device side -----------------------------------------------------------

    @staticmethod
    def _mega_regions(g):
        T = dp_cuda.MEGA_TILE
        return (-(-g["nn"] // T) * T,
                (g["slen"] + 383) // 384 * 384 + 384)

    def _mega_fits(self, gr, it, nreg, sreg):
        return (len(gr["rows"] | set(it["rows"])) <= self.MEGA_ROWB[-1]
                and gr["nb"] + nreg <= self.MEGA_PACK_NB
                and gr["sb"] + sreg <= self.MEGA_PACK_SB
                and len(gr["items"]) < self.MEGA_CP[-1])

    def _mega_add(self, open_groups, it):
        """Streaming packer: place a work item into an open group (first
        fit), or open a new one; returns a group to dispatch now, if any."""
        nreg, sreg = self._mega_regions(it["g"])
        placed = None
        for gr in open_groups:
            if self._mega_fits(gr, it, nreg, sreg):
                gr["items"].append(it)
                gr["rows"] |= set(it["rows"])
                gr["nb"] += nreg
                gr["sb"] += sreg
                placed = gr
                break
        if placed is None:
            placed = {"items": [it], "rows": set(it["rows"]),
                      "nb": nreg, "sb": sreg}
            open_groups.append(placed)
        if placed["nb"] >= self.MEGA_PACK_EAGER:
            open_groups.remove(placed)
            return placed
        # at most two open groups: dispatch the oldest on a third
        if len(open_groups) > 2:
            return open_groups.pop(0)
        return None

    def _group_mega(self, items):
        """Batch form of the streaming packer: the launch groups in order."""
        open_groups, out = [], []
        for it in items:
            full = self._mega_add(open_groups, it)
            if full is not None:
                out.append(full)
        return out + open_groups

    def _sweep_mega_multi(self, items):
        """One packed launch: the items' geometries end to end on the node
        and sequence axes, the bin-row union as rows.  Returns the (CP, B)
        best scores (numpy), the rows, CP and B."""
        T = dp_cuda.MEGA_TILE
        with tracing.span("launch.pack"):
            nb, sb = (sum(r) for r in zip(*(self._mega_regions(it["g"])
                                            for it in items)))
            NT = next(b for b in self.MEGA_NT if b >= nb)
            SB = next(b for b in self.MEGA_SB if b >= sb)
            CP = next(c for c in self.MEGA_CP if c >= len(items))
            rows = sorted({b for it in items for b in it["rows"]})
            B = next(b for b in self.MEGA_ROWB if b >= len(rows))
            D = self.mesh.size
            B = -(-B // D) * D              # row shards must split evenly
            packed = sd.pack_geometries_multi([it["g"] for it in items],
                                              NT, SB, CP, T)
            bin_idx = np.full(B, rows[0], np.int64)
            bin_idx[:len(rows)] = rows
            nonsd = bool((self.tables.uses_sd_np[rows] == 0).any())
            fxs = dp_cuda.FXS \
                if max(it["g"]["slen"] for it in items) \
                <= self.MEGA_FXS_LIMIT else dp_cuda.FXS // 2
        sp = tracing.current("launch")
        if sp:
            nodes = [it["g"]["nn"] for it in items]
            sp.set(route="mega", items=len(items), rows=len(rows),
                   rows_bucket=B, nodes=sum(nodes), nodes_bucket=NT,
                   node_rows=sum(n * len(it["rows"])
                                 for n, it in zip(nodes, items)),
                   node_rows_bucket=NT * B)
        best = sharded_score_dp_launch_mega(
            self.mesh, self.shard_tables, packed, bin_idx,
            closed=self.closed, has_nonsd=nonsd, relk=RELK,
            max_overlap=self.max_overlap, fxs=fxs)
        return best, rows, CP, B

    def _pack_std(self, items):
        """Std launches from [(ci, bin_ids, geoms)]: contigs largest first
        (by their largest geometry's nodes, then contig index), each
        launch padded to its own buckets (`std_buckets`).  A contig's bins
        never split across launches, and a launch closes when the next
        contig would take its rows past MAX_ROWS, or its padded node-rows
        or sequence-rows past NODE_ROW_BUDGET or SEQ_ROW_BUDGET.  Rows
        count as one card pads them, to a multiple of BLOCK, so that what
        a launch holds does not depend on the mesh: a mesh pads them
        further, to whole blocks a shard, and splits them over its
        devices.  Each launch is {"work": [(ci, bin, key)], "geoms": {key:
        geometry}}, key = (ci, translation table)."""
        sized = []
        for ci, cand, contig_geoms in items:
            gs = [contig_geoms[tt] for tt in
                  {self.bins[b].training_info.translation_table
                   for b in cand}]
            sized.append((max(g["nn"] for g in gs),
                          max(g["slen"] for g in gs), ci, cand,
                          contig_geoms))
        sized.sort(key=lambda it: (-it[0], it[2]))
        launches, work, geoms = [], [], {}
        nodes = slen = 0
        for c_nodes, c_slen, ci, cand, contig_geoms in sized:
            rows = -(-(len(work) + len(cand)) // BLOCK) * BLOCK
            nb, sb = std_buckets(max(nodes, c_nodes), max(slen, c_slen))
            if work and (rows > MAX_ROWS or rows * nb > NODE_ROW_BUDGET
                         or rows * sb > SEQ_ROW_BUDGET):
                launches.append({"work": work, "geoms": geoms})
                work, geoms = [], {}
                nodes = slen = 0
            nodes, slen = max(nodes, c_nodes), max(slen, c_slen)
            for b in cand:
                key = (ci, self.bins[b].training_info.translation_table)
                geoms.setdefault(key, contig_geoms[key[1]])
                work.append((ci, b, key))
        if work:
            launches.append({"work": work, "geoms": geoms})
        return launches

    def _std_inputs(self, work, geoms):
        """Host inputs of one std launch: (packed geometry, bin_idx, gidx,
        has_nonsd), numpy.  Geometries are padded to the launch's own
        buckets (`std_buckets`); rows are the work items, then pads on
        geometry 0 and bin 0 (ignored) up to a multiple of BLOCK, or of
        BLOCK x the mesh size, so that every shard takes whole blocks.
        The JAX package pads every launch to one shape so that XLA
        compiles it once (meta_tpu.py:214-216); a CUDA launch compiles
        nothing per shape, and no row's result depends on another row or
        on the padding, so the shape changes no result."""
        keys = list(geoms)
        gmap = {k: i for i, k in enumerate(keys)}
        multiple = BLOCK * self.mesh.size
        BT = -(-len(work) // multiple) * multiple
        nb, sb = std_buckets(max(g["nn"] for g in geoms.values()),
                             max(g["slen"] for g in geoms.values()))
        packed = sd.pack_geometries([geoms[k] for k in keys], len(keys),
                                    nb, sb)
        bin_idx = np.zeros(BT, np.int64)
        gidx = np.zeros(BT, np.int64)
        for k, (_ci, b, key) in enumerate(work):
            bin_idx[k] = b
            gidx[k] = gmap[key]
        nonsd = bool((self.tables.uses_sd_np[
            [b for _ci, b, _key in work]] == 0).any())
        return packed, bin_idx, gidx, nonsd

    def _sweep_std(self, work, geoms):
        """One std launch; returns the (BT,) best scores (numpy), row k
        for work item k."""
        with tracing.span("launch.pack"):
            packed, bin_idx, gidx, nonsd = self._std_inputs(work, geoms)
        sp = tracing.current("launch")
        if sp:
            nb = packed["n32"].shape[2]
            sp.set(route="std", items=len(work),
                   contigs=len({ci for ci, _b, _key in work}), rows=len(work),
                   rows_bucket=len(bin_idx), node_bucket=nb,
                   seq_bucket=packed["digits"].shape[1],
                   nodes=sum(g["nn"] for g in geoms.values()),
                   nodes_bucket=len(geoms) * nb,
                   node_rows=sum(geoms[key]["nn"] for _ci, _b, key in work),
                   node_rows_bucket=len(bin_idx) * nb)
        return sharded_score_dp_launch(
            self.mesh, self.shard_tables, packed, bin_idx, gidx,
            closed=self.closed, has_nonsd=nonsd, relk=RELK,
            max_overlap=self.max_overlap)

    # -- finishing (host, exact C on the winning bin) -------------------------

    def _genes(self, seq, num_seq):
        genes = Genes()
        genes._num_seq = num_seq
        genes.meta = True
        genes.sequence = seq
        return genes

    def _finish(self, seq, num_seq, run):
        """The genes of a chosen `BinRun`, from its work block in one
        foreign call (`rc_finish_bin`: eliminate, extract, tweak)."""
        genes = self._genes(seq, num_seq)
        tinf = self.bins[run.bin].training_info
        # begin, end, start and stop node a gene; a path holds fewer genes
        # than nodes
        g = np.empty((4, run.nn), np.int32)
        a, row = _native.addr(g), 4 * run.nn
        ng = _native.lib.rc_finish_bin(
            _native.addr(run.work), run.nn, run.ipath, tinf.raw.ctypes.data,
            self.max_overlap, a, a + row, a + 2 * row, a + 3 * row, run.nn)
        genes.ipath = run.ipath
        genes._begin, genes._end, genes._start_ndx, genes._stop_ndx = \
            g[:, :ng].copy()
        # the reference re-extracts and rescores the nodes for the winning
        # bin after the sweep, so the written per-gene scores are the fresh
        # model scores without the eliminate/tweak adjustments
        # (lib.pyx:5380-5394); the snapshot is those nodes
        genes.nodes = Nodes.from_block(run.snapshot, run.nn)
        genes.metagenomic_bin = self.bins[run.bin]
        genes.training_info = tinf
        return genes

    def _run_bin(self, seq, nodes_by_tt, bin_id):
        """One bin on the exact engine, from prep's nodes, in one foreign
        call that holds no interpreter lock (`rc_run_bin`: copy, reset,
        score, overlapping starts, snapshot, final DP): a `BinRun`.  The
        open `finish.rerun` or `exact_route.bin` span gets `native_s`, the
        seconds inside that call."""
        tinf = self.bins[bin_id].training_info
        src = nodes_by_tt[tinf.translation_table]
        nn, native_ns = src.length, 0
        ipath, score, work, snap = -1, ctypes.c_double(0.0), None, None
        if nn > 0:
            size = _native.lib.rc_node_block_layout(nn, None)
            work, snap = np.empty(size, np.uint8), np.empty(size, np.uint8)
            args = (ctypes.byref(src._addr_struct()), _native.addr(work),
                    _native.addr(snap), seq.digits.ctypes.data, seq.slen,
                    tinf.raw.ctypes.data, int(self.closed), self.max_overlap,
                    ctypes.byref(score))
            t0 = time.perf_counter_ns()
            ipath = _native.lib.rc_run_bin(*args)
            native_ns = time.perf_counter_ns() - t0
        sp = tracing.current("finish.rerun", "exact_route.bin")
        if sp:
            sp.set(native_s=native_ns * 1e-9)
        return BinRun(bin_id, ipath, score.value, nn, work, snap)

    # the winner's re-runs go through this name, which genebench's
    # instrument counts (`finish.bins_per_contig`)
    _score_winner = _run_bin

    @staticmethod
    def _choose(runs):
        """The reference's choice among `BinRun`s in ascending bin order:
        the highest path score above -100, the earliest bin on a tie (a
        strict `>`, lib.pyx:5339-5374); None when no bin has a path.  Only
        the best so far is kept alive."""
        chosen, max_score = None, -100.0
        for run in runs:
            if run.nn > 0 and run.ipath >= 0 and run.score > max_score:
                chosen, max_score = run, run.score
        return chosen

    def _produce_fallback(self, seq, num_seq, cand, nodes_by_tt):
        """A contig the mega kernel cannot take: every candidate bin on the
        exact engine, from prep's nodes, side by side on `bin_pool`; the
        winner is the one the reference's sequential sweep picks."""
        sp = tracing.current("exact_route")
        if sp:
            sp.set(bins=len(cand), workers=PREP_THREADS)
        futs = [self.bin_pool.submit(
            tracing.carry(self._run_bin, "exact_route.bin", bin=b),
            seq, nodes_by_tt, b) for b in cand]
        # each result is let go once weighed: a bin holds two copies of
        # the nodes, 19 MB each for a 2.46 Mbp genome
        chosen = self._choose(futs.pop(0).result() for _ in cand)
        if chosen is None:
            return self._produce_empty(seq, num_seq)
        return self._finish(seq, num_seq, chosen)

    # bins whose device (f32) path score lies within this margin of the
    # winner are re-run on the exact engine too
    @staticmethod
    def _margin(best):
        return 1.0 + 1e-4 * abs(best)

    def _produce_winner(self, seq, num_seq, cands, nodes_by_tt):
        """Exact finishing for one contig.  `cands`: [(bin_id,
        device_score)].  The winning bin, and every bin within the f32
        drift margin of it, is re-run through the exact f64 C engine, one
        after another on this thread, and chosen as the reference chooses
        (`_choose`)."""
        best_dev = max(s for _b, s in cands)
        close = sorted(b for b, s in cands
                       if s >= best_dev - self._margin(best_dev))

        def rerun(b):
            with tracing.span("finish.rerun", bin=b):
                return self._score_winner(seq, nodes_by_tt, b)
        chosen = self._choose(map(rerun, close))
        sp = tracing.current("finish")
        if sp:
            sp.set(bins=len(close),
                   winner=chosen.bin if chosen is not None else None)
        if chosen is None:
            return self._produce_empty(seq, num_seq)
        return self._finish(seq, num_seq, chosen)

    def _produce_empty(self, seq, num_seq):
        genes = self._genes(seq, num_seq)
        genes.nodes = Nodes()
        return genes

    # -- batch entry point ---------------------------------------------------

    def find_genes_batch(self, sequences, num_seq_start=1):
        with tracing.span(tracing.CALL):
            return self._find_genes_batch(sequences, num_seq_start)

    def _find_genes_batch(self, sequences, num_seq_start):
        contigs, preps = [], []
        for ci, s in enumerate(sequences):
            seq = Sequence(s, mask=self.mask, mask_size=self.min_mask)
            contigs.append(seq)
            preps.append(self.pool.submit(
                tracing.carry(self._prepare_contig, "prep", contig=ci,
                              bp=seq.slen), seq))
        sp = tracing.current(tracing.CALL)
        if sp:
            sp.set(contigs=len(contigs), bp=sum(s.slen for s in contigs))

        futures = {}
        groups = []              # dispatched mega launches, FIFO
        open_groups = []         # mega launches still packing
        pending = {}             # ci -> un-pulled mega item count
        std_items = []           # (ci, bin_ids, geoms) of std contigs
        nodes_maps = {}

        def dispatch(gr):
            gr["fut"] = self.launcher.submit(
                tracing.carry(self._sweep_mega_multi, "launch"), gr["items"])
            groups.append(gr)

        for ci, fut in enumerate(preps):
            cand, geoms, nodes_by_tt, route = fut.result()
            with self._count_lock:
                self.route_counts[route] += 1
            if route == "c":
                futures[ci] = self.pool.submit(
                    tracing.carry(self._produce_fallback, "exact_route",
                                  contig=ci, bp=contigs[ci].slen),
                    contigs[ci], num_seq_start + ci, cand, nodes_by_tt)
                continue
            if not cand:
                futures[ci] = self.pool.submit(
                    self._produce_empty, contigs[ci], num_seq_start + ci)
                continue
            nodes_maps[ci] = nodes_by_tt
            if route == "std":
                std_items.append((ci, cand, geoms))
            else:
                by_tt = {}
                for b in cand:
                    tt = self.bins[b].training_info.translation_table
                    by_tt.setdefault(tt, []).append(b)
                for tt, bs in by_tt.items():
                    pending[ci] = pending.get(ci, 0) + 1
                    full = self._mega_add(
                        open_groups, {"ci": ci, "g": geoms[tt], "rows": bs})
                    if full is not None:
                        dispatch(full)
        for gr in open_groups:
            dispatch(gr)
        # std launches run on the launcher after the mega launches
        std_launches = self._pack_std(std_items)
        for L in std_launches:
            L["fut"] = self.launcher.submit(
                tracing.carry(self._sweep_std, "launch"), L["work"],
                L["geoms"])

        def submit(ci, cands):
            # no bin found a path (lib.pyx:5361)
            if max(s for _b, s in cands) <= -100.0:
                futures[ci] = self.pool.submit(
                    self._produce_empty, contigs[ci], num_seq_start + ci)
            else:
                futures[ci] = self.pool.submit(
                    tracing.carry(self._produce_winner, "finish", contig=ci),
                    contigs[ci], num_seq_start + ci, cands, nodes_maps[ci])

        # pull launches in dispatch order, mega first; each contig goes to
        # the exact-C winner finishing when its last item arrives, while the
        # device runs later launches
        cands_by_ci = {}
        for gr in groups:
            bests, rows, _CP, _B = gr["fut"].result()
            pos = {b: i for i, b in enumerate(rows)}
            for k, it in enumerate(gr["items"]):
                ci = it["ci"]
                cands_by_ci.setdefault(ci, []).extend(
                    (b, float(bests[k, pos[b]])) for b in it["rows"])
                pending[ci] -= 1
                if pending[ci] == 0:
                    submit(ci, cands_by_ci.pop(ci))
        for L in std_launches:
            bests = L["fut"].result()
            for k, (ci, b, _key) in enumerate(L["work"]):
                cands_by_ci.setdefault(ci, []).append((b, float(bests[k])))
            for ci in dict.fromkeys(ci for ci, _b, _key in L["work"]):
                submit(ci, cands_by_ci.pop(ci))
        return [futures[ci].result() for ci in range(len(contigs))]
