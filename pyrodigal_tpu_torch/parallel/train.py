"""Distributed training: every O(bp) statistics scan sharded over a mesh.

Port of `pyrodigal_tpu.parallel.train`.  The reference trains on ONE
joined sequence in a single process (reference: lib.pyx:5471-5575;
multi-sequence joining lib.pyx:5536-5543).  Both O(bp) pieces of that --
the background hexamer scan and the gene-hexamer scan over the training
path's genes (`calc_dicodon_gene`, lib.pyx:4284-4358) -- are pure count
tables, so they shard exactly:

* the training set's contigs (large ones cut into balanced chunks) are
  assigned round-robin to the mesh's shards, each range carrying a
  5-base halo so every hexamer is read by exactly one owner;
* each shard tallies its 4096-bin tables on its own device in int64
  (`Mesh.run`), and the tables are summed on the mesh's first device
  (the JAX package's `psum`), then finalized into `gene_dc` by the exact
  C log-ratio tail (`rc_dicodon_finalize`).

The summed counts equal the host scans, so the final `TrainingInfo` is
byte-identical to `GeneFinder.train` on the joined sequence.  The
node-level passes (gc-bias recording, the training DP, the SD/non-SD EM
loops) stay on the exact C engine: they are O(nodes)/O(genes), not
O(bp).  The numpy helpers below are copies of the JAX package's.
"""

import ctypes

import numpy as np
import torch

from .. import _native
from .._constants import WINDOW
from ..nodes import Nodes
from ..sequence import Sequence
from ..training import TrainingInfo

_LINKER = "TTAATTAATTAA"


def _path_gene_hexamer_masks(nodes, ipath, slen):
    """Per-position hexamer-start masks of the training path's genes,
    mirroring the walk of rc_calc_dicodon_gene_bg (reference:
    lib.pyx:4320-4338): forward genes mark [left, right-5) step 3 in
    forward coordinates, reverse genes the same in reverse-complement
    coordinates."""
    fwd = np.zeros(slen, bool)
    rev = np.zeros(slen, bool)
    strand = nodes.strand
    typ = nodes.type
    ndx = nodes.ndx
    tb = nodes.traceb
    path = ipath
    in_gene = 0
    left = right = -1
    while path != -1:
        if strand[path] == 1:
            if typ[path] == 3:
                in_gene = 1
                right = int(ndx[path]) + 2
            elif in_gene == 1:
                left = int(ndx[path])
                if right - 5 > left:
                    fwd[left:right - 5:3] = True
                in_gene = 0
        else:
            if typ[path] != 3:
                in_gene = -1
                left = slen - int(ndx[path]) - 1
            elif in_gene == -1:
                right = slen - int(ndx[path]) + 1
                if right - 5 > left:
                    rev[left:right - 5:3] = True
                in_gene = 0
        path = int(tb[path])
    return fwd, rev


def _pack_ranges(digits, bg_mask, gene_mask, ranges, D):
    """Round-robin the per-contig owned ranges over D devices; each range
    ships its digits with a 5-byte halo so its hexamers read locally.
    Returns (D, L) uint8 digits + (D, L) bool masks (False on halos and
    padding, so masked positions contribute nothing)."""
    per_dev = [[] for _ in range(D)]
    for k, (lo, hi) in enumerate(ranges):
        if hi > lo:
            per_dev[k % D].append((lo, hi))
    slen = len(digits)
    lens = [sum(min(hi + 5, slen) - lo for lo, hi in rs) for rs in per_dev]
    L = max(max(lens), 6) if lens else 6
    dig = np.zeros((D, L), np.uint8)
    bgm = np.zeros((D, L), bool)
    gnm = np.zeros((D, L), bool)
    for dev, rs in enumerate(per_dev):
        off = 0
        for lo, hi in rs:
            stop = min(hi + 5, slen)
            n = stop - lo
            dig[dev, off:off + n] = digits[lo:stop]
            bgm[dev, off:off + hi - lo] = bg_mask[lo:hi]
            gnm[dev, off:off + hi - lo] = gene_mask[lo:hi]
            off += n
    return dig, bgm, gnm


def _sharded_counts(mesh, dig, bgm, gnm):
    """Per-shard hexamer tallies over the packed slices, each on its
    shard's device in int64, summed on the mesh's first device (the JAX
    package's scatter-add and `psum`, train.py:115-119).  Returns the
    background and gene tables, (4096,) int64 numpy each."""

    def shard(k, dev):
        x = torch.from_numpy(dig[k]).to(dev).long() & 3
        L = x.shape[0]
        idx = torch.zeros(L - 5, dtype=torch.int64, device=dev)
        for j in range(6):
            idx |= x[j:j + L - 5] << (2 * j)
        return [torch.bincount(idx[torch.from_numpy(m[k][:L - 5]).to(dev)],
                               minlength=4096)
                for m in (bgm, gnm)]

    first = mesh.devices[0]
    tallies = mesh.run(shard)
    bg, gn = (sum(t[i].to(first) for t in tallies).cpu().numpy()
              for i in range(2))
    return bg, gn


def _balance(ranges, D, total):
    """Split ranges into position chunks of at most ~total/(2D) so the
    round-robin assignment stays balanced even for one huge contig (or a
    skewed contig-size distribution)."""
    step = max(1, -(-total // (2 * D)))
    out = []
    for lo, hi in ranges:
        p = lo
        while p < hi:
            out.append((p, min(p + step, hi)))
            p += step
    return out


def sharded_background_counts(mesh, digits):
    """Background hexamer counts of one (joined) digit sequence, its
    position ranges tallied on the mesh's shards and summed.  Equal to
    the C scan in `rc_calc_dicodon_gene` (both strands; N folds to C,
    complement of N folds to C).  (4096,) int64 numpy."""
    d = np.asarray(digits, np.uint8)
    slen = len(d)
    npos = max(slen - 5, 0)
    comp = np.where(d < 4, 3 - d, d)[::-1].astype(np.uint8)
    D = mesh.size
    # one pass: forward and reverse-complement coordinates live side by
    # side in a concatenated source, with the reverse ranges offset
    both = np.concatenate([d, comp])
    valid = np.zeros(2 * slen, bool)
    valid[:npos] = True
    valid[slen:slen + npos] = True
    ranges = _balance([(0, npos), (slen, slen + npos)], D, 2 * npos)
    none = np.zeros(2 * slen, bool)
    bg, _ = _sharded_counts(mesh, *_pack_ranges(both, valid, none,
                                                ranges, D))
    return bg


def train_distributed(mesh, sequence, *sequences, translation_table=11,
                      start_weight=4.35, force_nonsd=False, closed=False,
                      mask=False, min_mask=50, min_gene=90,
                      min_edge_gene=60, max_overlap=60):
    """`GeneFinder.train` with every O(bp) statistics scan contig-sharded
    over the mesh; its `TrainingInfo.raw` bytes equal the C engine's.

    Accepts a metagenome-scale training set (any number of contigs); the
    contigs are joined with the reference's TTAATTAATTAA linker
    (lib.pyx:5536-5543) for the node-level passes, while the background
    AND gene hexamer tallies are computed per contig on the mesh's
    shards and summed, then finalized by the exact C log-ratio
    (`rc_dicodon_finalize`)."""
    contigs = [sequence, *sequences]
    if sequences:
        sequence = _LINKER.join([*contigs, ""])
    seq = Sequence(sequence, mask=mask, mask_size=min_mask)
    tinf = TrainingInfo(seq.gc, start_weight=start_weight,
                        translation_table=translation_table)

    nodes = Nodes()
    nodes.extract(seq, translation_table=translation_table, closed=closed,
                  min_gene=min_gene, min_edge_gene=min_edge_gene)
    nodes.sort()
    gc_plot = seq.max_gc_frame_plot(WINDOW)
    nodes.record_gc_bias(gc_plot, seq.slen, tinf)
    nodes.record_overlapping_starts(tinf, 0, max_overlap)
    ipath = nodes.dynamic_programming(tinf, final=False)

    # ---- contig-sharded O(bp) tallies ----------------------------------
    d = np.asarray(seq.digits, np.uint8)
    slen = seq.slen
    npos = max(slen - 5, 0)
    comp = np.where(d < 4, 3 - d, d)[::-1].astype(np.uint8)
    gene_f, gene_r = _path_gene_hexamer_masks(nodes, ipath, slen)
    bg_valid = np.zeros(slen, bool)
    bg_valid[:npos] = True

    # per-contig owned ranges of the joined sequence (each contig owns its
    # span plus the following linker); reverse-coordinate ranges mirror.
    # Forward and reverse coordinates live side by side in one
    # concatenated source so a single pass tallies both strands, and
    # large contigs are split into balanced position chunks.
    offs = [0]
    for c in contigs:
        offs.append(min(offs[-1] + len(c) + len(_LINKER), slen))
    offs[-1] = slen
    fwd_ranges = [(offs[k], min(offs[k + 1], npos))
                  for k in range(len(contigs))]
    rev_ranges = [(slen + max(slen - offs[k + 1], 0),
                   slen + min(slen - offs[k], npos))
                  for k in range(len(contigs))]

    D = mesh.size
    both = np.concatenate([d, comp])
    bg_valid2 = np.concatenate([bg_valid, bg_valid])
    gene_both = np.concatenate([gene_f, gene_r])
    ranges = _balance(fwd_ranges + rev_ranges, D, 2 * npos)
    bg, gene = _sharded_counts(
        mesh, *_pack_ranges(both, bg_valid2, gene_both, ranges, D))

    s = nodes._struct()
    _native.lib.rc_dicodon_finalize(
        _native.u8(tinf.raw), _native.i64(bg), _native.i64(gene))
    _native.lib.rc_raw_coding_score(
        _native.u8(seq.digits), seq.slen, ctypes.byref(s),
        _native.u8(tinf.raw))
    _native.lib.rc_rbs_score(
        _native.u8(seq.digits), seq.slen, ctypes.byref(s),
        _native.u8(tinf.raw))
    _native.lib.rc_train_starts_sd(
        _native.u8(seq.digits), seq.slen, ctypes.byref(s),
        _native.u8(tinf.raw))
    if force_nonsd:
        tinf.uses_sd = False
    else:
        _native.lib.rc_determine_sd_usage(_native.u8(tinf.raw))
    if not tinf.uses_sd:
        _native.lib.rc_train_starts_nonsd(
            _native.u8(seq.digits), seq.slen, ctypes.byref(s),
            _native.u8(tinf.raw))
    return tinf
