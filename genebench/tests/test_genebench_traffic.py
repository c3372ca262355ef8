"""The traffic generator and the cell's mix: seeds, lengths, proportions,
N content and reverse complements.  Besides the mix in `traffic/`, the
generator's other shapes (a MAG cut into pieces, an assembly streamed in
batches, a draft genome in lognormal contigs) are held to their
parameters, which a later cell's mix file can name."""

import collections
import math

import numpy as np
import pytest

from genebench import generate

GCF = "GCF_001457455.1_NCTC11397_genomic.fna.gz"
MIIJ = "MIIJ01000039.fna.gz"
SEED = 2**31 + 12345


MIXES = {
    "long_contigs": generate.load_mix("long_contigs"),
    # long-read MAGs: 50-100% complete, cut into 1-4 contigs of >= 100 kb
    "mags": {"kind": "genomes", "pool_calls": 32, "recipes": [
        {"share": 0.75, "source": GCF, "rotate": True, "reverse_p": 0.5,
         "keep": [0.5, 1.0],
         "cut": {"kind": "pieces", "count": [1, 4], "min_len": 100000}},
        {"share": 0.25, "source": MIIJ, "reverse_p": 0.5}]},
    # a short-read assembly streamed in calls of 512 contigs
    "short_contigs": {"kind": "stream", "pool_calls": 8,
                      "contigs_per_call": 512, "recipes": [
                          {"source": GCF, "rotate": True, "strand_each": True,
                           "cut": {"kind": "lognormal", "median": 3000,
                                   "sigma": 1.0, "min_len": 500,
                                   "max_len": 49152}},
                          {"source": MIIJ, "non_n": True,
                           "strand_each": True,
                           "cut": {"kind": "lognormal", "median": 3000,
                                   "sigma": 1.0, "min_len": 500,
                                   "max_len": 49152}}]},
    # draft isolate genomes in lognormal contigs
    "drafts": {"kind": "genomes", "pool_calls": 32, "recipes": [
        {"source": GCF, "rotate": True, "reverse_p": 0.5,
         "cut": {"kind": "lognormal", "median": 40000, "sigma": 1.0,
                 "min_len": 500, "max_len": None}}]},
}


@pytest.fixture(scope="module")
def pools():
    return {m: generate.make(SEED, p) for m, p in MIXES.items()}


@pytest.mark.parametrize("mix", list(MIXES))
def test_same_seed_same_calls_other_seed_other_calls(mix, pools):
    params = MIXES[mix]
    again = generate.make(SEED, params)
    assert again == pools[mix]
    other = generate.make(SEED + 1, params)
    assert other != pools[mix]
    assert len(other) == len(again) == params["pool_calls"]


def test_large_and_negative_seeds():
    mix = dict(MIXES["drafts"], pool_calls=2)
    a, b = generate.make(2**64 + 3, mix), generate.make(-3, mix)
    assert a and b and a != b


@pytest.mark.parametrize("mix", list(MIXES))
def test_no_contig_is_mostly_n(mix, pools):
    for call in pools[mix]:
        for _name, s in call:
            assert s.count("N") < len(s) / 2


def test_reverse_complement_is_exact():
    s = "ACGTNRYKMBDHVSWacgtn"
    rc = generate.revcomp(s)
    assert rc == "nacgtWSBDHVKMRYNACGT"
    assert generate.revcomp(rc) == s
    pair = dict(zip("ACGTN", "TGCAN"))
    g = generate.read_source(GCF)[:5000]
    assert generate.revcomp(g) == "".join(pair[c] for c in reversed(g))


def _origin(seq, genome):
    """(strand, offset) of seq in the circular genome."""
    doubled = genome + genome
    i = doubled.find(seq)
    if i >= 0:
        return 1, i
    i = doubled.find(generate.revcomp(seq))
    assert i >= 0, "contig not from the genome"
    return -1, i


def test_long_contigs_genomes(pools):
    """One genome a call: 6 closed GCF chromosomes, each rotated once in
    each sixth of the circle, 3 a strand; 2 MIIJ01000039, 1 a strand."""
    calls = pools["long_contigs"]
    gcf, miij = (generate.read_source(n) for n in (GCF, MIIJ))
    turns, strands = [], collections.Counter()
    for call in calls:
        assert len(call) == 1
        s = call[0][1]
        if len(s) == len(miij):
            assert s in (miij, generate.revcomp(miij))
            strands[("miij", s == miij)] += 1
            continue
        assert len(s) == len(gcf)
        strand, off = _origin(s, gcf)
        strands[("gcf", strand)] += 1
        turns.append(off / len(gcf))
    assert strands[("gcf", 1)] == strands[("gcf", -1)] == 3
    assert strands[("miij", True)] == strands[("miij", False)] == 1
    assert sorted(int(t * 6) for t in turns) == list(range(6))


def test_long_contigs_seeds_share_the_work_not_the_contents():
    a = generate.make(SEED, MIXES["long_contigs"])
    b = generate.make(SEED + 1, MIXES["long_contigs"])
    assert sorted(len(c[0][1]) for c in a) == sorted(len(c[0][1]) for c in b)
    gcf = len(generate.read_source(GCF))
    rot = {c[0][1][:60] for c in a if len(c[0][1]) == gcf}
    assert not rot & {c[0][1][:60] for c in b if len(c[0][1]) == gcf}
    assert [n for n, _s in a[0]] == ["call0_contig0"]


def test_mags_pieces(pools):
    calls = pools["mags"]
    gcf, miij = (generate.read_source(n) for n in (GCF, MIIJ))
    kinds = collections.Counter()
    counts = collections.Counter()
    strands = collections.Counter()
    for call in calls:
        seqs = [s for _n, s in call]
        if len(seqs) == 1 and len(seqs[0]) == len(miij):
            kinds["miij"] += 1
            strands[("miij", seqs[0] == miij)] += 1
            assert seqs[0] in (miij, generate.revcomp(miij))
            continue
        kinds["gcf"] += 1
        counts[len(seqs)] += 1
        assert all(len(s) >= 100_000 for s in seqs)
        total = sum(map(len, seqs))
        assert 0.5 * len(gcf) - 1 <= total <= len(gcf)
        strand, _ = _origin(seqs[0], gcf)
        strands[("gcf", strand)] += 1
        # the pieces are consecutive stretches of one MAG
        joined = "".join(seqs)
        assert _origin(joined, gcf)[0] == strand
    assert kinds == {"gcf": 24, "miij": 8}           # p = 0.75 of 32
    assert counts == {1: 6, 2: 6, 3: 6, 4: 6}        # uniform 1-4
    assert strands[("gcf", 1)] == strands[("gcf", -1)] == 12
    assert strands[("miij", True)] == strands[("miij", False)] == 4


def test_mags_completeness_is_stratified(pools):
    gcf = len(generate.read_source(GCF))
    keeps = sorted(sum(len(s) for _n, s in call) / gcf
                   for call in pools["mags"]
                   if len(call) > 1 or abs(len(call[0][1]) - 869_782) > 0)
    # one completeness in each 1/24 of [0.5, 1.0]
    for i, k in enumerate(keeps):
        assert 0.5 + i / 48 - 1e-6 <= k <= 0.5 + (i + 1) / 48 + 1e-6


def test_short_contigs_assembly(pools):
    calls = pools["short_contigs"]
    assert all(len(call) == 512 for call in calls)
    lens = np.array([len(s) for call in calls for _n, s in call])
    assert lens.min() >= 500 and lens.max() <= 49_152
    # lognormal, median 3 kb, sigma 1.0, clipped to [500, 49,152]
    assert 2700 <= np.median(lens) <= 3300
    assert 0.9 <= np.std(np.log(lens)) <= 1.05
    assert 4300 <= lens.mean() <= 5500
    # both organisms in every call, both strands
    miij = generate.read_source(MIIJ)
    from_miij = sum(1 for call in calls for _n, s in call
                    if s in miij or generate.revcomp(s) in miij)
    share = from_miij / sum(len(c) for c in calls)
    assert 0.10 <= share <= 0.20          # 437 kb of about 2.9 Mbp a pass
    fwd = sum(1 for call in calls[:1] for _n, s in call[:200]
              if s in generate.read_source(GCF) + generate.read_source(GCF))
    assert 60 <= fwd <= 140


def test_drafts_genomes(pools):
    calls = pools["drafts"]
    gcf = generate.read_source(GCF)
    n_contigs = [len(c) for c in calls]
    assert 28 <= np.mean(n_contigs) <= 48
    strands = collections.Counter()
    for call in calls:
        lens = [len(s) for _n, s in call]
        assert min(lens) >= 500
        assert len(gcf) - 500 < sum(lens) <= len(gcf)
        strands[_origin(call[0][1], gcf)[0]] += 1
        joined = "".join(s for _n, s in call)
        assert _origin(joined, gcf)[1] >= 0
    assert strands[1] == strands[-1] == 16
    lens = np.array([len(s) for c in calls for _n, s in c])
    assert 32_000 <= np.median(lens) <= 48_000
    # both sides of the std route's 49,152 bp limit
    assert 0.3 <= (lens > 49_152).mean() <= 0.5
    assert math.isclose(np.std(np.log(lens)), 1.0, abs_tol=0.15)
