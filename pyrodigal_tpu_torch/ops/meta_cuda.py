"""Gene calling on the GPU, meta and single mode: the std and mega routes.

Port of `pyrodigal_tpu.ops.meta_tpu.TpuMetaRunner`.  Host prep (node
extraction, geometry) runs on a thread pool and picks each contig's
route as the JAX package does:

* "std": contigs of at most SEQ_BUCKET bp whose geometries fit the std
  buckets.  Launches hold up to BATCH work items, one (contig, bin) per
  row with its own geometry (`score_device.score_dp_launch`: scoring,
  the phase-cumsum, star and std-DP kernels);
* "mega": longer contigs, and short ones that overflow a std bucket,
  packed end to end into launches whose rows are the union of their
  candidate bins (`score_device.score_dp_launch_mega`: scoring, the
  dc-chain, star and mega-DP kernels);
* "c": mega geometries `_mega_ok` refuses; the exact C engine takes the
  whole contig.

Each launch returns one best path score per (contig, bin); the exact C
engine then re-runs the winning bin(s) of each contig, so the emitted
genes are the reference's byte for byte (reference: lib.pyx:5317-5396
for the sequential bin sweep this replaces).

Single mode (`is_meta=False`) runs the same launches with one bin, the
trained model, and `is_meta=False` scoring, as the JAX package's runner
does.  There is no bin to choose, so the exact engine re-runs that bin
for every contig whatever its device score (reference:
lib.pyx:5281-5315), from the moment the contig's prep is done: the
launches run beside the finishing, and their one-row best scores only
feed `single_drift`.  Single mode is not faster on the card than on the
C engine.
"""

import concurrent.futures
import threading

import numpy as np
import torch

from .._constants import STOP
from ..genes import Genes
from ..nodes import Nodes
from ..sequence import Sequence
from . import dp_cuda
from . import score_device as sd

# std route (the JAX package's TpuMetaRunner defaults): node and sequence
# buckets, DP window and windows per node (the std DP kernel's), work
# items per launch, the row multiple a launch is rounded to, and
# geometries per launch
NODE_BUCKET = 3072
SEQ_BUCKET = 49152
WINDOW = dp_cuda.W_STD
FIXED_CHUNKS = dp_cuda.FIXED_CHUNKS
BATCH = 128
BLOCK = 16
MAX_GEOMS = 16
# star scan span, in node indices (reference: lib.pyx:2279-2329)
RELK = 32
PREP_THREADS = 8


class CudaMetaRunner:
    """Batched gene calling with on-device per-bin scoring: meta mode over
    `metagenomic_bins`, or single mode (`is_meta=False`) over a one-bin
    list whose bin carries the trained `training_info`."""

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

    def __init__(self, metagenomic_bins, *, device, closed=False,
                 min_gene=90, min_edge_gene=60, max_overlap=60, mask=False,
                 min_mask=50, is_meta=True):
        self.device = torch.device(device)
        self.bins = metagenomic_bins
        self.is_meta = is_meta
        self.closed = closed
        self.min_gene = min_gene
        self.min_edge_gene = min_edge_gene
        self.max_overlap = max_overlap
        self.mask = mask
        self.min_mask = min_mask
        self.tables = sd.BinTables(metagenomic_bins, self.device)
        self.pool = concurrent.futures.ThreadPoolExecutor(PREP_THREADS)
        # device launches run in submission order on one thread
        self.launcher = concurrent.futures.ThreadPoolExecutor(1)
        self.route_counts = {"std": 0, "mega": 0, "c": 0}
        # single mode: the device's one-row best scores against the exact
        # engine's, over the runner's calls: contigs compared, the worst
        # |device - exact| over a tenth of the winner margin (the bound
        # the tests hold the kernels to), and the worst relative drift
        self.single_drift = {"pairs": 0, "margin_ratio": 0.0,
                             "relative": 0.0}
        self._count_lock = threading.Lock()

    def close(self):
        self.pool.shutdown()
        self.launcher.shutdown()

    # -- host side -----------------------------------------------------------

    def _candidate_bins(self, seq):
        if not self.is_meta:
            return [0] if len(self.bins) else []
        low = min(0.65, 0.88495 * seq.gc - 0.0102337)
        high = max(0.35, 0.86596 * seq.gc + 0.1131991)
        return [
            i for i in range(len(self.bins))
            if low <= self.bins[i].training_info.gc <= high
        ]

    def _mega_ok(self, g):
        """Geometry constraints of the mega DP kernel's window and ring."""
        nn = g["nn"]
        if nn == 0 or nn > self.MEGA_NT[-1] or g["star_overflow"]:
            return False
        if g["slen"] > self.MEGA_SB[-1]:
            return False
        ext = int((np.arange(nn) - g["win_lo"]).max())
        if ext > dp_cuda.MEGA_CHUNKS * dp_cuda.W_MEGA:
            return False
        # the kind-2 overlap window reads 384 lanes at the node offset of
        # stop_val[i]-3; its candidates lie within 200 bp, so bound the node
        # count of any 200-bp span (250 + up to 127 alignment lanes <= 384)
        ndx_sorted = np.sort(g["ndx"][:nn])
        if int((np.searchsorted(ndx_sorted, ndx_sorted + 200)
                - np.arange(nn)).max()) > 250:
            return False
        # the fwd-stop ring serving fwd-start targets must cover every fwd
        # stop in any [win_lo(i), i) window
        fstop = ((g["typ"][:nn] == STOP)
                 & (g["strand"][:nn] == 1)).astype(np.int64)
        cumf = np.concatenate([[0], np.cumsum(fstop)])
        idx = np.arange(nn)
        fstart = (g["typ"][:nn] != STOP) & (g["strand"][:nn] == 1)
        in_win = np.where(fstart, cumf[idx] - cumf[g["win_lo"][:nn]], 0)
        return int(in_win.max()) <= dp_cuda.MEGA_RING

    def _prepare_contig(self, seq):
        """Returns (bin_ids, geoms, nodes_by_tt, route), route one of "std",
        "mega" or "c" (meta_tpu.py:169-204)."""
        cand = self._candidate_bins(seq)
        geoms, nodes_by_tt = {}, {}
        route = "std" if seq.slen <= SEQ_BUCKET else "mega"
        for b in cand:
            tt = self.bins[b].training_info.translation_table
            if tt in geoms:
                continue
            nodes = Nodes()
            nodes.extract(
                seq, translation_table=tt, closed=self.closed,
                min_gene=self.min_gene, min_edge_gene=self.min_edge_gene,
            )
            nodes.sort()
            nodes_by_tt[tt] = nodes
            g = sd.prepare_geometry(seq, nodes, tt, self.closed,
                                    self.max_overlap, RELK)
            nn = g["nn"]
            if route == "std" and (
                    nn > NODE_BUCKET or g["star_overflow"]
                    or (nn and int((np.arange(nn) - g["win_lo"]).max())
                        > FIXED_CHUNKS * WINDOW)):
                route = "mega"
            geoms[tt] = g
        # every geometry of a mega contig must fit the mega kernel (the
        # route may have turned "mega" after earlier geometries were seen)
        if route == "mega" and not all(map(self._mega_ok, geoms.values())):
            route = "c"
        return cand, geoms, nodes_by_tt, route

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
        nb, sb = (sum(r) for r in zip(*(self._mega_regions(it["g"])
                                        for it in items)))
        NT = next(b for b in self.MEGA_NT if b >= nb)
        SB = next(b for b in self.MEGA_SB if b >= sb)
        CP = next(c for c in self.MEGA_CP if c >= len(items))
        rows = sorted({b for it in items for b in it["rows"]})
        B = next(b for b in self.MEGA_ROWB if b >= len(rows))
        packed = sd.pack_geometries_multi([it["g"] for it in items],
                                          NT, SB, CP, T)
        bin_idx = np.full(B, rows[0], np.int64)
        bin_idx[:len(rows)] = rows
        nonsd = bool((self.tables.uses_sd_np[rows] == 0).any())
        fxs = dp_cuda.FXS \
            if max(it["g"]["slen"] for it in items) <= self.MEGA_FXS_LIMIT \
            else dp_cuda.FXS // 2
        best = sd.score_dp_launch_mega(
            self.tables.as_tuple(), sd.to_device(packed, self.device),
            torch.from_numpy(bin_idx).to(self.device),
            is_meta=self.is_meta, closed=self.closed, has_nonsd=nonsd,
            relk=RELK, max_overlap=self.max_overlap, fxs=fxs)
        return best.cpu().numpy(), rows, CP, B

    def _pack_std(self, items):
        """Std launches from [(ci, bin_ids, geoms)] in contig order
        (meta_tpu.py:561-585): a contig's bins never split across
        launches, and a launch closes when its work would pass BATCH rows
        or its geometries MAX_GEOMS.  Each launch is {"work": [(ci, bin,
        key)], "geoms": {key: geometry}}, key = (ci, translation table)."""
        launches, work, geoms = [], [], {}
        for ci, cand, contig_geoms in items:
            tts = {self.bins[b].training_info.translation_table
                   for b in cand}
            if work and (len(work) + len(cand) > BATCH
                         or len(geoms) + len(tts) > MAX_GEOMS):
                launches.append({"work": work, "geoms": geoms})
                work, geoms = [], {}
            for b in cand:
                key = (ci, self.bins[b].training_info.translation_table)
                geoms.setdefault(key, contig_geoms[key[1]])
                work.append((ci, b, key))
        if work:
            launches.append({"work": work, "geoms": geoms})
        return launches

    def _std_inputs(self, work, geoms):
        """Device inputs of one std launch: (geo, bin_idx, gidx,
        has_nonsd).  Rows are the work items, then pads on geometry 0 and
        bin 0 (ignored) up to a multiple of BLOCK.  The JAX package pads
        every launch to BATCH rows so that XLA compiles one shape
        (meta_tpu.py:214-216); a CUDA launch compiles nothing per shape,
        and no row's result depends on another row, so the rounding
        changes the launch's shape and no result."""
        keys = list(geoms)
        gmap = {k: i for i, k in enumerate(keys)}
        BT = -(-len(work) // BLOCK) * BLOCK
        packed = sd.pack_geometries([geoms[k] for k in keys], len(keys),
                                    NODE_BUCKET, SEQ_BUCKET)
        bin_idx = np.zeros(BT, np.int64)
        gidx = np.zeros(BT, np.int64)
        for k, (_ci, b, key) in enumerate(work):
            bin_idx[k] = b
            gidx[k] = gmap[key]
        nonsd = bool((self.tables.uses_sd_np[
            [b for _ci, b, _key in work]] == 0).any())
        dev = self.device
        return (sd.to_device(packed, dev), torch.from_numpy(bin_idx).to(dev),
                torch.from_numpy(gidx).to(dev), nonsd)

    def _sweep_std(self, work, geoms):
        """One std launch; returns the (BT,) best scores (numpy), row k
        for work item k."""
        geo, bin_idx, gidx, nonsd = self._std_inputs(work, geoms)
        best = sd.score_dp_launch(
            self.tables.as_tuple(), geo, bin_idx, gidx,
            is_meta=self.is_meta, closed=self.closed, has_nonsd=nonsd,
            relk=RELK, max_overlap=self.max_overlap)
        return best.cpu().numpy()

    # -- finishing (host, exact C on the winning bin) -------------------------

    def _finish(self, genes, seq, bin_id, nodes, ipath, out_nodes):
        tinf = self.bins[bin_id].training_info
        if nodes.length > 0:
            nodes.eliminate_bad_genes(ipath, tinf)
        genes._extract(nodes, ipath)
        genes._tweak_final_starts(nodes, tinf, self.max_overlap)
        # meta: the reference re-extracts and rescores the nodes for the
        # winning bin after the sweep, so the written per-gene scores are
        # the fresh model scores without the eliminate/tweak adjustments
        # (lib.pyx:5380-5394); `out_nodes` is that pre-DP snapshot.
        # Single mode keeps the adjusted nodes (lib.pyx:5281-5315).
        genes.nodes = out_nodes if self.is_meta else nodes
        genes.metagenomic_bin = self.bins[bin_id] if self.is_meta else None
        genes.training_info = tinf
        return genes

    def _score_winner(self, seq, nodes_by_tt, bin_id):
        tinf = self.bins[bin_id].training_info
        nodes = nodes_by_tt[tinf.translation_table].copy()
        nodes.reset_scores()
        nodes.score_nodes(seq, tinf, closed=self.closed,
                          is_meta=self.is_meta)
        nodes.record_overlapping_starts(tinf, 1, self.max_overlap)
        return nodes

    def _produce_fallback(self, seq, num_seq):
        """A contig the mega kernel cannot take: the sequential exact-C
        path, in the runner's mode."""
        from ..gene_finder import GeneFinder
        if self.is_meta:
            model = dict(meta=True, metagenomic_bins=self.bins)
        else:
            model = dict(training_info=self.bins[0].training_info)
        gf = GeneFinder(
            **model, closed=self.closed, mask=self.mask,
            min_mask=self.min_mask, min_gene=self.min_gene,
            min_edge_gene=self.min_edge_gene,
            max_overlap=self.max_overlap, backend="refcore",
        )
        gf._num_seq = num_seq
        return gf.find_genes(str(seq))

    # bins whose device (f32) path score lies within this margin of the
    # winner are re-run on the exact engine too
    @staticmethod
    def _margin(best):
        return 1.0 + 1e-4 * abs(best)

    def _produce_single(self, seq, num_seq, nodes_by_tt):
        """Single mode's finishing: the exact engine re-runs the one bin
        and finishes whatever the path (lib.pyx:5281-5315).  Returns
        (genes, the exact best path score, or None with no path)."""
        genes = Genes()
        genes._num_seq = num_seq
        genes.meta = False
        genes.sequence = seq
        nodes = self._score_winner(seq, nodes_by_tt, 0)
        ipath = nodes.dynamic_programming(self.bins[0].training_info,
                                          final=True)
        exact = float(nodes.score[ipath]) \
            if nodes.length > 0 and ipath >= 0 else None
        return self._finish(genes, seq, 0, nodes, ipath, None), exact

    def _record_drift(self, device, exact):
        if exact is None:
            return
        diff = abs(device - exact)
        with self._count_lock:
            d = self.single_drift
            d["pairs"] += 1
            d["margin_ratio"] = max(d["margin_ratio"],
                                    diff / (0.1 * self._margin(exact)))
            d["relative"] = max(d["relative"], diff / max(abs(exact), 1.0))

    def _produce_winner(self, seq, num_seq, cands, nodes_by_tt):
        """Exact finishing for one contig in meta mode.  `cands`:
        [(bin_id, device_score)].  The winning bin, and every bin within
        the f32 drift margin of it, is re-run through the exact f64 C
        engine, in ascending bin order with the reference's `>`
        (lib.pyx:5339-5374)."""
        genes = Genes()
        genes._num_seq = num_seq
        genes.meta = self.is_meta
        genes.sequence = seq
        best_dev = max(s for _b, s in cands)
        close = sorted(b for b, s in cands
                       if s >= best_dev - self._margin(best_dev))
        max_score = -100.0
        chosen = None
        for b in close:
            tinf = self.bins[b].training_info
            nodes = self._score_winner(seq, nodes_by_tt, b)
            out_nodes = nodes.copy()
            ipath = nodes.dynamic_programming(tinf, final=True)
            if nodes.length > 0 and ipath >= 0 \
                    and nodes.score[ipath] > max_score:
                max_score = nodes.score[ipath]
                chosen = (b, nodes, ipath, out_nodes)
        if chosen is None:
            return self._produce_empty(seq, num_seq)
        return self._finish(genes, seq, *chosen)

    def _produce_empty(self, seq, num_seq):
        genes = Genes()
        genes._num_seq = num_seq
        genes.meta = self.is_meta
        genes.sequence = seq
        genes.nodes = Nodes()
        genes.metagenomic_bin = None
        genes.training_info = None
        return genes

    # -- batch entry point ---------------------------------------------------

    def find_genes_batch(self, sequences, num_seq_start=1):
        contigs, preps = [], []
        for s in sequences:
            seq = Sequence(s, mask=self.mask, mask_size=self.min_mask)
            contigs.append(seq)
            preps.append(self.pool.submit(self._prepare_contig, seq))

        futures = {}
        groups = []              # dispatched mega launches, FIFO
        open_groups = []         # mega launches still packing
        pending = {}             # ci -> un-pulled mega item count
        std_items = []           # (ci, bin_ids, geoms) of std contigs
        nodes_maps = {}

        def dispatch(gr):
            gr["fut"] = self.launcher.submit(self._sweep_mega_multi,
                                             gr["items"])
            groups.append(gr)

        for ci, fut in enumerate(preps):
            cand, geoms, nodes_by_tt, route = fut.result()
            with self._count_lock:
                self.route_counts[route] += 1
            if route == "c":
                futures[ci] = self.pool.submit(
                    self._produce_fallback, contigs[ci], num_seq_start + ci)
                continue
            if not cand:
                futures[ci] = self.pool.submit(
                    self._produce_empty, contigs[ci], num_seq_start + ci)
                continue
            if not self.is_meta:
                # single mode finishes now; the launch runs beside it
                futures[ci] = self.pool.submit(
                    self._produce_single, contigs[ci], num_seq_start + ci,
                    nodes_by_tt)
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
            L["fut"] = self.launcher.submit(self._sweep_std, L["work"],
                                            L["geoms"])

        device_best = {}

        def submit(ci, cands):
            if not self.is_meta:
                device_best[ci] = cands[0][1]
            # meta mode: no bin found a path (lib.pyx:5361)
            elif max(s for _b, s in cands) <= -100.0:
                futures[ci] = self.pool.submit(
                    self._produce_empty, contigs[ci], num_seq_start + ci)
            else:
                futures[ci] = self.pool.submit(
                    self._produce_winner, contigs[ci], num_seq_start + ci,
                    cands, nodes_maps[ci])

        # pull launches in dispatch order, mega first; in meta mode each
        # contig goes to the exact-C winner finishing when its last item
        # arrives, while the device runs later launches
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
        out = [futures[ci].result() for ci in range(len(contigs))]
        for ci, dev in device_best.items():
            out[ci], exact = out[ci]
            self._record_drift(dev, exact)
        return out
