"""The one traffic generator: it reads a mix's parameters
(`genebench/traffic/<mix>.json`) and makes the calls of a run from a
seed, out of the genomes frozen under `genebench/data/`.

A call is a list of contigs, `[(name, sequence)]`.  A run draws a pool
of `pool_calls` calls once, in set-up, and its window cycles through
them in order.  The pool is stratified, so that every seed gets much the
same work in other contents and another order: each recipe gets its
share of the pool exactly, and each of its random choices (rotation,
strand, completeness, contig count) is spread evenly over the recipe's
calls: the rotations of a recipe's k calls fall one in each k-th of the
genome, at seeded places.  The calls of a "genomes" mix are then ordered
so that every stretch of the pool holds each recipe and strand in about
its share (`_interleave`), in seeded order within each.

Two kinds of mix:

* ``"genomes"``: each call is one draw of one recipe, e.g. a MAG;
* ``"stream"``: every recipe is drawn once a pass, the contigs of a pass
  shuffled together, passes joined end to end and cut into calls of
  `contigs_per_call` contigs, e.g. a metagenome assembly streamed in
  batches.

A recipe takes its `source` genome, optionally rotates it at a seeded
offset (`rotate`), reverse-complements it with probability `reverse_p`,
keeps a prefix of the share `keep` = [lo, hi] (drawn uniformly), keeps
only its stretches without N (`non_n`), and cuts each stretch by `cut`:

* ``{"kind": "none"}``: whole;
* ``{"kind": "pieces", "count": [lo, hi], "min_len": m}``: into a count
  drawn uniformly from lo..hi of pieces of at least m bp, cut points
  uniform;
* ``{"kind": "lognormal", "median": x, "sigma": s, "min_len": a,
  "max_len": b}``: end to end into lengths drawn from a lognormal and
  clipped to [a, b] (b may be null); a remainder shorter than a is
  dropped.  With `strand_each`, every piece then gets its own seeded
  strand.
"""

import gzip
import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
TRAFFIC = os.path.join(HERE, "traffic")

_COMPLEMENT = str.maketrans("ACGTUNRYKMBDHVSWacgtunrykmbdhvsw",
                            "TGCAANYRMKVHDBSWtgcaanyrmkvhdbsw")
_CACHE = {}


def revcomp(seq):
    """The reverse complement (IUPAC codes complemented, case kept)."""
    return seq.translate(_COMPLEMENT)[::-1]


def read_source(name):
    """The one record of `genebench/data/<name>` as an upper-case str."""
    if name not in _CACHE:
        with gzip.open(os.path.join(DATA, name), "rt") as f:
            lines = [ln.strip() for ln in f if not ln.startswith(">")]
        _CACHE[name] = "".join(lines).upper()
    return _CACHE[name]


def load_mix(name, directory=TRAFFIC):
    with open(os.path.join(directory, f"{name}.json")) as f:
        return json.load(f)


def rng_for(seed):
    """A generator for any whole number, negative or past 64 bits."""
    seed = int(seed)
    words = []
    seed = seed % (1 << 128)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            break
    return np.random.default_rng(words)


def _spread(rng, n, values):
    """n values taken evenly, in turn, from `values`, in shuffled order."""
    out = [values[i % len(values)] for i in range(n)]
    rng.shuffle(out)
    return out


def _uniform_strata(rng, n, lo, hi):
    """n draws of U(lo, hi), one in each of n equal strata, shuffled."""
    u = (rng.permutation(n) + rng.random(n)) / n
    return lo + (hi - lo) * u


def _non_n(seq):
    """The stretches of seq without N."""
    return [s for s in seq.split("N") if s]


def _cut_pieces(rng, seq, count, min_len):
    L = len(seq)
    count = max(1, min(count, L // min_len)) if min_len else count
    free = L - count * min_len
    cuts = np.sort(rng.integers(0, free + 1, count - 1)) \
        + np.arange(1, count) * min_len
    bounds = [0, *cuts.tolist(), L]
    return [seq[bounds[i]:bounds[i + 1]] for i in range(count)]


def _cut_lognormal(rng, seq, cut):
    lo, hi = cut["min_len"], cut.get("max_len")
    mu = math.log(cut["median"])
    out, pos = [], 0
    while pos < len(seq):
        n = float(rng.lognormal(mu, cut["sigma"]))
        n = max(lo, n if hi is None else min(hi, n))
        n = int(n)
        if len(seq) - pos < lo:
            break                       # a remainder shorter than min_len
        out.append(seq[pos:pos + n])
        pos += n
    return out


def _draw(rng, recipe, reverse=None, keep=None, count=None, turn=None):
    """One draw of a recipe: its contigs, [str].  `turn` in [0, 1) places
    the rotation (drawn here without it)."""
    seq = read_source(recipe["source"])
    if recipe.get("rotate"):
        off = int(rng.integers(0, len(seq))) if turn is None \
            else int(turn * len(seq))
        seq = seq[off:] + seq[:off]
    if reverse is None:
        reverse = bool(rng.random() < recipe.get("reverse_p", 0.0))
    if reverse:
        seq = revcomp(seq)
    if keep is None:
        lo, hi = recipe.get("keep", [1.0, 1.0])
        keep = lo + (hi - lo) * float(rng.random())
    seq = seq[:int(round(keep * len(seq)))]
    stretches = _non_n(seq) if recipe.get("non_n") else [seq]
    cut = recipe.get("cut", {"kind": "none"})
    out = []
    for s in stretches:
        if cut["kind"] == "none":
            out.append(s)
        elif cut["kind"] == "pieces":
            if count is None:
                count = int(rng.integers(cut["count"][0], cut["count"][1] + 1))
            out += _cut_pieces(rng, s, count, cut["min_len"])
        elif cut["kind"] == "lognormal":
            out += _cut_lognormal(rng, s, cut)
        else:
            raise ValueError(f"unknown cut {cut['kind']!r}")
    if recipe.get("strand_each"):
        out = [revcomp(c) if rng.random() < 0.5 else c for c in out]
    return out


def _recipe_counts(mix, n):
    """Calls of each recipe in a pool of n: its share, rounded so that the
    counts add up to n (largest remainders first)."""
    shares = np.array([r.get("share", 1.0) for r in mix["recipes"]], float)
    exact = shares / shares.sum() * n
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts))[:n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def _genome_calls(rng, mix):
    n = mix["pool_calls"]
    calls, strata = [], []
    for ri, (recipe, k) in enumerate(zip(mix["recipes"],
                                         _recipe_counts(mix, n))):
        if k == 0:
            continue
        p = recipe.get("reverse_p", 0.0)
        n_rev = int(round(p * k))
        reverses = [True] * n_rev + [False] * (k - n_rev)
        rng.shuffle(reverses)
        lo, hi = recipe.get("keep", [1.0, 1.0])
        keeps = _uniform_strata(rng, k, lo, hi)
        cut = recipe.get("cut", {"kind": "none"})
        counts = (_spread(rng, k, list(range(cut["count"][0],
                                             cut["count"][1] + 1)))
                  if cut["kind"] == "pieces" else [None] * k)
        turns = _uniform_strata(rng, k, 0.0, 1.0)
        for i in range(k):
            calls.append(_draw(rng, recipe, reverses[i], float(keeps[i]),
                               counts[i], float(turns[i])))
            strata.append((ri, reverses[i]))
    return [calls[i] for i in _interleave(rng, strata)]


def _interleave(rng, strata):
    """An order of the calls in which every stretch holds each stratum in
    about its share: slot by slot the stratum furthest behind its share
    goes next (the first in order on a tie), its calls in seeded order."""
    groups = {}
    for i, key in enumerate(strata):
        groups.setdefault(key, []).append(i)
    keys = list(groups)
    for k in keys:
        groups[k] = [groups[k][j] for j in rng.permutation(len(groups[k]))]
    n, taken, order = len(strata), dict.fromkeys(keys, 0), []
    for t in range(n):
        k = max(keys, key=lambda k: (len(groups[k]) * (t + 1) / n - taken[k],
                                     -keys.index(k)))
        order.append(groups[k][taken[k]])
        taken[k] += 1
    return order


def _stream_calls(rng, mix):
    n, per = mix["pool_calls"], mix["contigs_per_call"]
    stream, calls = [], []
    while len(calls) < n:
        passed = []
        for recipe in mix["recipes"]:
            passed += _draw(rng, recipe)
        order = rng.permutation(len(passed))
        stream += [passed[i] for i in order]
        while len(stream) >= per and len(calls) < n:
            calls.append(stream[:per])
            stream = stream[per:]
    return calls


def make(seed, mix):
    """The pool of calls of a run: [[(name, sequence)]]; the same seed
    gives the same calls."""
    rng = rng_for(seed)
    kind = mix["kind"]
    if kind == "genomes":
        raw = _genome_calls(rng, mix)
    elif kind == "stream":
        raw = _stream_calls(rng, mix)
    else:
        raise ValueError(f"unknown mix kind {kind!r}")
    return [[(f"call{k}_contig{j}", s) for j, s in enumerate(call)]
            for k, call in enumerate(raw)]
