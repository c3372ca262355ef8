"""The port's `GeneFinder` (reference: lib.pyx:5071-5575; the JAX
package's `pyrodigal_tpu.gene_finder`).

Backends:

* ``"cuda"`` (default): meta mode runs `CudaMetaRunner` on ``cuda:0``:
  it sweeps the metagenomic bins on the card and re-runs the winning
  bin(s) on the exact C engine.  Single mode has no bin to choose, and
  the exact engine would re-run its one model for every contig whatever
  a launch scored, so it runs the exact C engine, as ``"refcore"`` does.
  Construction raises `RuntimeError` when no CUDA device is available,
  in both modes; nothing falls back to the CPU.
* ``"refcore"``: the exact float64 C engine on the CPU, single and meta
  mode.  It runs only when the caller asks for it.

`train` runs the exact C engine whatever the backend, as in the reference.
"""

import functools
import itertools
import threading
import warnings

import torch

from ._constants import (
    MIN_GENE, MIN_EDGE_GENE, MAX_SAM_OVLP, MASK_SIZE,
    MIN_SINGLE_GENOME, IDEAL_SINGLE_GENOME, WINDOW, TRANSLATION_TABLES,
)
from .sequence import Sequence
from .nodes import Nodes
from .genes import Genes
from .training import TrainingInfo
from . import _native


class GeneFinder:
    """A configurable gene finder for genomes and metagenomes.

    Example:
        >>> from pyrodigal_tpu_torch import GeneFinder
        >>> finder = GeneFinder(meta=True, backend="refcore")
        >>> len(finder.find_genes("TTAATTAATTAA" * 4))   # too short
        0
        >>> GeneFinder(min_gene=60, backend="refcore")
        pyrodigal_tpu_torch.gene_finder.GeneFinder(min_gene=60)
    """

    BACKENDS = ("cuda", "refcore")

    def __init__(
        self,
        training_info=None,
        *,
        meta=False,
        metagenomic_bins=None,
        closed=False,
        mask=False,
        min_mask=MASK_SIZE,
        min_gene=MIN_GENE,
        min_edge_gene=MIN_EDGE_GENE,
        max_overlap=MAX_SAM_OVLP,
        backend="cuda",
    ):
        if backend not in self.BACKENDS:
            raise ValueError(f"backend must be one of {self.BACKENDS}, "
                             f"not {backend!r}")
        if backend == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("backend='cuda' needs a CUDA device, and "
                               "torch.cuda.is_available() is False; "
                               "backend='refcore' runs the exact C engine")
        if meta and training_info is not None:
            raise ValueError("cannot use a training info in meta mode.")
        if min_gene <= 0:
            raise ValueError("`min_gene` must be strictly positive")
        if min_edge_gene <= 0:
            raise ValueError("`min_edge_gene` must be strictly positive")
        if min_mask < 0:
            raise ValueError("`min_mask` must be positive")
        if max_overlap < 0:
            raise ValueError("`max_overlap` must be positive")
        elif max_overlap > min_gene:
            raise ValueError("`max_overlap` must be lower than `min_gene`")

        self.meta = meta
        self.closed = closed
        self.lock = threading.Lock()
        self.mask = mask
        self.training_info = training_info
        self.min_mask = min_mask
        self.min_gene = min_gene
        self.min_edge_gene = min_edge_gene
        self.max_overlap = max_overlap
        self.backend = backend
        self._num_seq = 1
        self._meta_runner = None
        if metagenomic_bins is None:
            from .metagenomic import METAGENOMIC_BINS
            self.metagenomic_bins = METAGENOMIC_BINS
        else:
            self.metagenomic_bins = metagenomic_bins

    def _get_meta_runner(self):
        with self.lock:
            if self._meta_runner is None:
                from .ops.meta_cuda import CudaMetaRunner

                self._meta_runner = CudaMetaRunner(
                    self.metagenomic_bins,
                    device="cuda:0",
                    closed=self.closed,
                    mask=self.mask,
                    min_mask=self.min_mask,
                    min_gene=self.min_gene,
                    min_edge_gene=self.min_edge_gene,
                    max_overlap=self.max_overlap,
                )
            return self._meta_runner

    def _find_genes_device(self, sequences, num_seq):
        return self._get_meta_runner().find_genes_batch(
            sequences, num_seq_start=num_seq)

    def _on_device(self):
        """True when the call runs on the GPU: backend "cuda" in meta mode
        with bins to sweep (with none, meta mode finds no genes)."""
        return self.backend == "cuda" and self.meta \
            and len(self.metagenomic_bins) > 0

    def __repr__(self):
        template = []
        if self.training_info is not None:
            template.append(f"training_info={self.training_info!r}")
        if self.meta:
            template.append(f"meta={self.meta!r}")
        if self.closed:
            template.append(f"closed={self.closed!r}")
        if self.mask:
            template.append(f"mask={self.mask!r}")
        if self.min_gene != MIN_GENE:
            template.append(f"min_gene={self.min_gene!r}")
        if self.min_edge_gene != MIN_EDGE_GENE:
            template.append(f"min_edge_gene={self.min_edge_gene!r}")
        if self.max_overlap != MAX_SAM_OVLP:
            template.append(f"max_overlap={self.max_overlap!r}")
        ty = type(self)
        return "{}.{}({})".format(ty.__module__, ty.__name__, ", ".join(template))

    def __reduce__(self):
        fn = functools.partial(
            type(self),
            meta=self.meta,
            metagenomic_bins=self.metagenomic_bins,
            closed=self.closed,
            mask=self.mask,
            min_mask=self.min_mask,
            min_gene=self.min_gene,
            min_edge_gene=self.min_edge_gene,
            max_overlap=self.max_overlap,
            backend=self.backend,
        )
        return fn, (self.training_info,)

    # --- internals ------------------------------------------------------------

    def _extract_sorted(self, nodes, seq, tt):
        nodes.extract(
            seq, translation_table=tt, closed=self.closed,
            min_gene=self.min_gene, min_edge_gene=self.min_edge_gene,
        )
        nodes.sort()

    def _train(self, seq, nodes, tinf, force_nonsd):
        """(reference: lib.pyx:5236-5279)"""
        self._extract_sorted(nodes, seq, tinf.translation_table)
        gc_plot = seq.max_gc_frame_plot(WINDOW)
        nodes.record_gc_bias(gc_plot, seq.slen, tinf)
        nodes.record_overlapping_starts(tinf, 0, self.max_overlap)
        ipath = nodes.dynamic_programming(tinf, final=False)
        import ctypes
        s = nodes._struct()
        _native.lib.rc_calc_dicodon_gene(
            _native.u8(tinf.raw), _native.u8(seq.digits), seq.slen,
            ctypes.byref(s), int(ipath),
        )
        _native.lib.rc_raw_coding_score(
            _native.u8(seq.digits), seq.slen, ctypes.byref(s),
            _native.u8(tinf.raw),
        )
        _native.lib.rc_rbs_score(
            _native.u8(seq.digits), seq.slen, ctypes.byref(s),
            _native.u8(tinf.raw),
        )
        _native.lib.rc_train_starts_sd(
            _native.u8(seq.digits), seq.slen, ctypes.byref(s),
            _native.u8(tinf.raw),
        )
        if force_nonsd:
            tinf.uses_sd = False
        else:
            _native.lib.rc_determine_sd_usage(_native.u8(tinf.raw))
        if not tinf.uses_sd:
            _native.lib.rc_train_starts_nonsd(
                _native.u8(seq.digits), seq.slen, ctypes.byref(s),
                _native.u8(tinf.raw),
            )
        return tinf

    def _find_genes_single(self, seq, tinf, nodes, genes):
        """(reference: lib.pyx:5281-5315), on the exact C engine on every
        backend."""
        self._extract_sorted(nodes, seq, tinf.translation_table)
        nodes.reset_scores()
        nodes.score_nodes(seq, tinf, closed=self.closed, is_meta=False)
        nodes.record_overlapping_starts(tinf, 1, self.max_overlap)
        ipath = nodes.dynamic_programming(tinf, final=True)
        if nodes.length > 0:
            nodes.eliminate_bad_genes(ipath, tinf)
        genes._extract(nodes, ipath)
        genes._tweak_final_starts(nodes, tinf, self.max_overlap)

    def _find_genes_meta(self, seq, nodes, genes):
        """(reference: lib.pyx:5317-5396), on the exact C engine."""
        low = min(0.65, 0.88495 * seq.gc - 0.0102337)
        high = max(0.35, 0.86596 * seq.gc + 0.1131991)

        tt = -1
        max_phase = -1
        max_score = -100.0

        for i in range(len(self.metagenomic_bins)):
            bin_ = self.metagenomic_bins[i]
            tinf = bin_.training_info
            if tinf.gc < low or tinf.gc > high:
                continue
            if tinf.translation_table != tt:
                tt = tinf.translation_table
                nodes.clear()
                self._extract_sorted(nodes, seq, tt)
            nodes.reset_scores()
            nodes.score_nodes(seq, tinf, closed=self.closed, is_meta=True)
            nodes.record_overlapping_starts(tinf, 1, self.max_overlap)
            ipath = nodes.dynamic_programming(tinf, final=True)
            if nodes.length > 0 and ipath >= 0 and nodes.score[ipath] > max_score:
                max_phase = i
                max_score = nodes.score[ipath]
                nodes.eliminate_bad_genes(ipath, tinf)
                genes._clear()
                genes._extract(nodes, ipath)
                genes._tweak_final_starts(nodes, tinf, self.max_overlap)

        if max_phase >= 0:
            tinf = self.metagenomic_bins[max_phase].training_info
            nodes.clear()
            self._extract_sorted(nodes, seq, tinf.translation_table)
            nodes.reset_scores()
            nodes.score_nodes(seq, tinf, closed=self.closed, is_meta=True)
        return max_phase

    # --- public API -----------------------------------------------------------

    def find_genes(self, sequence):
        """Find all the genes in the input DNA sequence."""
        if not self.meta and self.training_info is None:
            raise RuntimeError(
                "cannot find genes without having trained in single mode"
            )
        if self._on_device():
            with self.lock:
                num_seq = self._num_seq
                self._num_seq += 1
            return self._find_genes_device([sequence], num_seq)[0]
        seq = Sequence(sequence, mask=self.mask, mask_size=self.min_mask)
        nodes = Nodes()
        genes = Genes()

        with self.lock:
            genes._num_seq = self._num_seq
            self._num_seq += 1

        if self.meta:
            phase = self._find_genes_meta(seq, nodes, genes)
            if phase >= 0:
                genes.metagenomic_bin = self.metagenomic_bins[phase]
                tinf = self.metagenomic_bins[phase].training_info
            else:
                genes.metagenomic_bin = tinf = None
        else:
            tinf = self.training_info
            self._find_genes_single(seq, tinf, nodes, genes)

        genes.sequence = seq
        genes.nodes = nodes
        genes.training_info = tinf
        genes.meta = self.meta
        return genes

    def find_genes_batch(self, sequences):
        """Find genes in a batch of input sequences.

        In meta mode with ``backend="cuda"`` this sends all (contig, bin)
        work items through the batched on-device scoring + DP pipeline;
        otherwise it maps `find_genes`.
        """
        sequences = list(sequences)
        if not self.meta and self.training_info is None:
            raise RuntimeError(
                "cannot find genes without having trained in single mode"
            )
        if self._on_device():
            with self.lock:
                num_seq = self._num_seq
                self._num_seq += len(sequences)
            return self._find_genes_device(sequences, num_seq)
        return [self.find_genes(s) for s in sequences]

    def train(self, sequence, *sequences, force_nonsd=False,
              start_weight=4.35, translation_table=11):
        """Search training parameters using one or more training sequences."""
        if self.meta:
            raise RuntimeError("cannot use training sequence in metagenomic mode")
        if translation_table not in TRANSLATION_TABLES:
            raise ValueError(
                f"{translation_table} is not a valid translation table index"
            )

        if isinstance(sequence, Sequence):
            if sequences:
                raise NotImplementedError(
                    "cannot use more than one `Sequence` object in "
                    "`GeneFinder.train`"
                )
            seq = Sequence(sequence, mask=self.mask, mask_size=self.min_mask)
        elif isinstance(sequence, str):
            if sequences:
                sequence = "TTAATTAATTAA".join(
                    itertools.chain([sequence], sequences, [""])
                )
            seq = Sequence(sequence, mask=self.mask, mask_size=self.min_mask)
        else:
            if sequences:
                sequence = b"TTAATTAATTAA".join(
                    itertools.chain([bytes(sequence)], map(bytes, sequences), [b""])
                )
            seq = Sequence(sequence, mask=self.mask, mask_size=self.min_mask)

        if seq.slen < MIN_SINGLE_GENOME:
            raise ValueError(
                f"sequence must be at least {MIN_SINGLE_GENOME} characters "
                f"({seq.slen} found)"
            )
        elif seq.slen < IDEAL_SINGLE_GENOME:
            warnings.warn(
                f"sequence should be at least {IDEAL_SINGLE_GENOME} characters "
                f"({seq.slen} found)"
            )

        nodes = Nodes()
        tinf = TrainingInfo(
            seq.gc, start_weight=start_weight,
            translation_table=translation_table,
        )
        self._train(seq, nodes, tinf, force_nonsd)

        with self.lock:
            self.training_info = tinf
        return tinf
