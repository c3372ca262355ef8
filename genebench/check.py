"""The comparison that decides `correct`: what the window's calls
returned against the reference (`reference/engine.py`), worked out again
from the same inputs once the window has closed, once for each distinct
input (pool entry) of the run.

Numbers compared, each against its limit in `checks/<cell>.json`:

* `gene_mismatch`: contigs whose GFF, protein FASTA or nucleotide FASTA
  differ from the reference's (the exact finishing, and the bin chosen),
  in the first call of each pool entry;
* `score_pairs_off`: (contig, bin) pairs the reference scores that no
  device launch scored, or that a launch scored and the reference does
  not (the candidate bins, the packing), in every call of the window,
  over the contigs a launch scored at all: a contig whose geometry the
  mega kernel cannot take goes whole to the exact engine (route "c") and
  has no device score; its genes are compared all the same;
* `score_gap`: the widest gap between a device launch's best path score
  and the reference's, over every (contig, bin) with a path in every
  call of the window, in tenths of the finishing margin 1 + 1e-4 |score|
  (the scoring, the seg-scan, star and DP kernels).  A score that is not
  finite is an infinite gap.

The GFF's program version (`pyrodigal_tpu.v<version>`) is not compared:
it names the release, not a gene.
"""

import math
import re

_VERSION = re.compile(r"pyrodigal_tpu([._])v[0-9][^;\t\"\n]*")


def normalise(text):
    return _VERSION.sub(r"pyrodigal_tpu\1v", text)


def gap(device, exact):
    if device is None or not math.isfinite(device):
        return math.inf
    return abs(device - exact) / (0.1 * (1.0 + 1e-4 * abs(exact)))


def compare(expected, got, device_scores, entry_of):
    """`expected`: {pool entry: [(ref scores {bin: score or None}, ref
    texts or None)]}; `got`: {pool entry: [program texts or None]} of the
    entry's first call; `device_scores`: {(call, contig): {bin: score}};
    `entry_of`: {call: pool entry} for every call of the window.
    Returns ({name: value}, facts): the numbers compared, and what was
    compared, with the widest gaps."""
    out = {"gene_mismatch": 0, "score_pairs_off": 0, "score_gap": 0.0}
    facts = {"entries": len(expected), "calls": len(entry_of),
             "contigs": 0, "pairs": 0, "contigs_without_device_score": 0}
    for e, contigs in expected.items():
        for ci, (_ref_scores, ref_texts) in enumerate(contigs):
            facts["contigs"] += 1
            prog = got[e][ci]
            if ref_texts is not None and (
                    prog is None or tuple(map(normalise, prog))
                    != tuple(map(normalise, ref_texts))):
                out["gene_mismatch"] += 1
    gaps = []
    for call, e in entry_of.items():
        for ci, (ref_scores, _t) in enumerate(expected[e]):
            dev = device_scores.get((call, ci))
            if not dev:
                facts["contigs_without_device_score"] += 1
                continue
            out["score_pairs_off"] += len(set(ref_scores) ^ set(dev))
            top = max((s for s in ref_scores.values() if s is not None),
                      default=None)
            for b, exact in ref_scores.items():
                if exact is not None and b in dev:
                    facts["pairs"] += 1
                    g = gap(dev[b], exact)
                    out["score_gap"] = max(out["score_gap"], g)
                    gaps.append((g, call, ci, b, dev[b], exact, top))
    facts["widest_gaps"] = sorted(gaps, reverse=True)[:8]
    return out, facts


def verdict(numbers, limits):
    """[(name, value, limit, within)] for every limit, in its order."""
    return [(name, numbers.get(name, math.inf), limit,
             numbers.get(name, math.inf) <= limit)
            for name, limit in limits.items()]
