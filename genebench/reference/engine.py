"""The reference of the `correct` comparison, for each contig of a call:
the best path score of every candidate bin (`plain.py`) and the three
files a user writes (GFF, protein FASTA, nucleotide FASTA) for the bin
those scores choose (`writer.py`): Prodigal's meta mode in plain NumPy
and Python, sharing no code with the port.  It reads the
configuration's 50 bins from `genebench/data/metagenomic_bins.npz`.

The work runs in spawned worker processes, one contig a task, the
longest first.

`precision="bf16"` is the control: `plain.py` with every node's score
components rounded to bfloat16 before the dynamic programme, the
precision below the float32 that the port's device scoring states.
"""

import os

from . import plain, writer

BINS_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "metagenomic_bins.npz")


class Reference:
    """The reference for one configuration's options (`opts`: closed,
    mask, min_mask, min_gene, min_edge_gene, max_overlap)."""

    def __init__(self, opts):
        self.o = dict(opts)
        self.bins = plain.load_bins(BINS_FILE)

    def scores(self, s, precision="f64"):
        """{bin: best path score, or None without a path} for the
        candidate bins of contig `s`."""
        return plain.meta_best(s, self.bins, self.o, precision)

    def call(self, name, s, num_seq):
        """(scores, the contig's three files) for contig `s`."""
        scores, win = plain.meta_run(s, self.bins, self.o)
        return scores, writer.texts(name, len(s), win, self.bins, self.o,
                                    num_seq)


# -- worker processes --------------------------------------------------------

_REFS = {}


def _ref(opts):
    key = tuple(sorted(opts.items()))
    if key not in _REFS:
        _REFS[key] = Reference(opts)
    return _REFS[key]


def _contig_task(opts, name, s, num_seq, precision, with_texts):
    ref = _ref(opts)
    if with_texts and precision == "f64":
        return ref.call(name, s, num_seq)
    return ref.scores(s, precision), None


def run_meta(ex, opts, calls, precision="f64", with_texts=True):
    """Meta mode over calls [(contigs, num_seq of the first contig)] on
    the executor `ex`: per call, per contig, ({bin: score}, texts or
    None)."""
    tasks = [(len(s), c, j, name, s, num + j)
             for c, (contigs, num) in enumerate(calls)
             for j, (name, s) in enumerate(contigs)]
    tasks.sort(key=lambda t: -t[0])
    futs = [(c, j, ex.submit(_contig_task, opts, name, s, num, precision,
                             with_texts))
            for _n, c, j, name, s, num in tasks]
    out = [[None] * len(contigs) for contigs, _num in calls]
    for c, j, fut in futs:
        out[c][j] = fut.result()
    return out


def executor(workers=None):
    """A pool of worker processes, started fresh (spawn): they import
    the reference and nothing of the port."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        workers or os.cpu_count() or 8,
        mp_context=multiprocessing.get_context("spawn"))
