"""Meta-mode launches with their rows sharded over a mesh.

Port of `pyrodigal_tpu.parallel.meta_shard`.  A launch's rows are
independent: the std route's rows are (contig, bin) work items, each
with its own geometry, and the mega route's rows are the candidate bins
of one packed geometry.  So a launch shards by rows with no collective:
the geometry and the bin tables are replicated, every shard runs the
port's own launch (`score_device.score_dp_launch` /
`score_dp_launch_mega`) on its rows, on its device, from its own thread
and on its own stream (`Mesh.run`), and the per-row best scores come back
to the host in row order.

The JAX module's `sharded_score_dp_launch_packed` also reduces each
contig's winner on the device (`pack_winners`).  The port's runner
reduces the per-(contig, bin) scores on the host, so there is no device
winner packing here.  (The reference has no distributed analog; its
outermost parallelism is a thread pool over contigs, cli.py:286-302.)
"""

import numpy as np
import torch

from .. import tracing
from ..ops import score_device as sd


def _row_slices(mesh, B):
    D = mesh.size
    if B % D:
        raise ValueError(f"{B} rows do not split evenly over {D} shards")
    step = B // D
    return [slice(k * step, (k + 1) * step) for k in range(D)]


def sharded_score_dp_launch(mesh, tables_per_device, geo, bin_idx, gidx, *,
                            closed, has_nonsd, relk, max_overlap):
    """`score_device.score_dp_launch` with the work-item rows split into
    `mesh.size` contiguous slices of equal length (the counterpart of
    the JAX package's `sharded_score_dp_launch`).

    `tables_per_device`: a `BinTables` per mesh device, in mesh order;
    `geo`: the numpy geometry of `pack_geometries`, copied to every
    shard; `bin_idx`, `gidx`: (BT,) numpy, BT a multiple of the mesh
    size.  Returns the (BT,) best scores, numpy float32, in row order."""
    slices = _row_slices(mesh, len(bin_idx))

    def shard(k, dev):
        with tracing.span("launch.wait"):
            rows = (torch.from_numpy(bin_idx[slices[k]]).to(dev),
                    torch.from_numpy(gidx[slices[k]]).to(dev))
        best = sd.score_dp_launch(
            tables_per_device[k].as_tuple(), sd.to_device(geo, dev), *rows,
            closed=closed, has_nonsd=has_nonsd, relk=relk,
            max_overlap=max_overlap)
        with tracing.span("launch.wait"):
            return best.cpu().numpy()

    return np.concatenate(mesh.run(shard))


def sharded_score_dp_launch_mega(mesh, tables_per_device, geo, bin_idx, *,
                                 closed, has_nonsd, relk, max_overlap, fxs):
    """`score_device.score_dp_launch_mega` with the bin rows split into
    `mesh.size` equal slices and the packed geometry (numpy, from
    `pack_geometries_multi`) copied to every shard: a row-parallel
    analog of the reference's sequential bin sweep (lib.pyx:5339-5374),
    the counterpart of the JAX package's `sharded_score_dp_launch_mega`.
    `bin_idx`: (B,) numpy, B a multiple of the mesh size.  Returns the
    (B,) best scores, or (CP, B) for a pack of CP contig slots, numpy
    float32, in row order."""
    slices = _row_slices(mesh, len(bin_idx))

    def shard(k, dev):
        with tracing.span("launch.wait"):
            rows = torch.from_numpy(bin_idx[slices[k]]).to(dev)
        best = sd.score_dp_launch_mega(
            tables_per_device[k].as_tuple(), sd.to_device(geo, dev), rows,
            closed=closed, has_nonsd=has_nonsd, relk=relk,
            max_overlap=max_overlap, fxs=fxs)
        with tracing.span("launch.wait"):
            return best.cpu().numpy()

    return np.concatenate(mesh.run(shard), axis=-1)
