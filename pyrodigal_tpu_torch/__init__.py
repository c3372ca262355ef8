"""pyrodigal_tpu_torch -- the PyTorch/CUDA port of pyrodigal_tpu.

Meta-mode gene calling with the per-bin node scoring and the gene-path
DP on an NVIDIA GPU (hand-written CUDA kernels for the prefix sums, the
star sweep and the DP, built at first use), and the exact float64 C
engine re-running the winning bins, so output is byte-equal to
``backend="refcore"``.

The host layer (sequences, nodes, genes, training, metagenomic bins,
FASTA, the C engine) is this package's own copy of `pyrodigal_tpu`'s.
This package imports torch, and neither jax nor `pyrodigal_tpu`.
"""

from .__about__ import __version__
from ._constants import (
    TRANSLATION_TABLES,
    MIN_SINGLE_GENOME,
    IDEAL_SINGLE_GENOME,
    PRODIGAL_VERSION,
)
from .sequence import Sequence, Mask, Masks
from .nodes import Node, Nodes
from .genes import Gene, Genes
from .training import TrainingInfo
from .metagenomic import MetagenomicBin, MetagenomicBins, METAGENOMIC_BINS
from .gene_finder import GeneFinder

__all__ = [
    "GeneFinder",
    "Gene",
    "Genes",
    "Mask",
    "Masks",
    "MetagenomicBin",
    "MetagenomicBins",
    "METAGENOMIC_BINS",
    "Node",
    "Nodes",
    "Sequence",
    "TrainingInfo",
    "TRANSLATION_TABLES",
    "MIN_SINGLE_GENOME",
    "IDEAL_SINGLE_GENOME",
    "PRODIGAL_VERSION",
    "__version__",
]
