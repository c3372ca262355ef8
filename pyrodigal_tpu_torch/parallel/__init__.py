"""Multi-device scaling for pyrodigal_tpu_torch.

Port of `pyrodigal_tpu.parallel`.  The reference is a single-process
shared-memory library; its parallelism is SIMD and a thread pool over
contigs.  Here, as in the JAX package:

* a launch's rows ((contig, bin) work items on the std route, candidate
  bins on the mega route) are sharded over a 1-D mesh of devices; each
  shard scores and runs the DP for its rows (`meta_shard`, used by
  `CudaMetaRunner(..., mesh=...)`);
* training's O(bp) count tables (background and gene hexamer counts)
  are pure sums: each shard tallies its ranges and the tables are summed
  (`train`);
* trained models and metagenomic bins are replicated.
"""

from .mesh import make_mesh
from .meta_shard import (
    sharded_score_dp_launch,
    sharded_score_dp_launch_mega,
)
from .train import sharded_background_counts, train_distributed

__all__ = [
    "make_mesh",
    "sharded_score_dp_launch",
    "sharded_score_dp_launch_mega",
    "train_distributed",
    "sharded_background_counts",
]
