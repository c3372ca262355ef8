"""Prodigal-compatible command line of the PyTorch port (flag surface:
reference cli.py:64-206; a copy of `pyrodigal_tpu.cli` on the port's
`GeneFinder`).

    python -m pyrodigal_tpu_torch -i genome.fna -o genes.gff
    python -m pyrodigal_tpu_torch -i contigs.fna -p meta -a proteins.faa

The command is organised around an output sink and two mode runners:
single mode trains on the joined contigs (on the exact C engine) then
maps `find_genes` over a worker pool, while meta mode streams contigs
through `GeneFinder.find_genes_batch` so the batched on-device (contig,
bin) sweep is the product path.  `--backend cuda`, the default, needs a
CUDA device and exits with an error without one, in both modes;
`--backend refcore` runs the exact C engine on the CPU.  Single mode
runs the exact C engine on either backend.
"""

import argparse
import os
import sys
import warnings

from .__about__ import __version__
from ._constants import TRANSLATION_TABLES
from .gene_finder import GeneFinder
from .training import TrainingInfo
from .fasta import parse, zopen

#: contigs per device launch group in meta mode
META_BATCH = 512


def argument_parser(
    prog: str = "pyrodigal_tpu_torch",
    version: str = __version__,
    input_required: bool = True,
) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=prog, add_help=False,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("-a", required=False, metavar="trans_file",
                        help="Write protein translations to the selected file.")
    parser.add_argument("-c", required=False, action="store_true", default=False,
                        help="Closed ends. Do not allow genes to run off edges.")
    parser.add_argument("-d", required=False, metavar="nuc_file",
                        help="Write nucleotide sequences of genes to the selected file.")
    parser.add_argument("-f", required=False, metavar="output_type",
                        choices={"gff", "gbk"}, default="gff",
                        help="Select output format.")
    parser.add_argument("-g", required=False, metavar="tr_table", type=int,
                        choices=TRANSLATION_TABLES, default=11,
                        help="Specify a translation table to use.")
    parser.add_argument("-i", metavar="input_file", required=input_required,
                        help="Specify FASTA input file.")
    parser.add_argument("-m", action="store_true", default=False,
                        help="Treat runs of N as masked sequence; don't build genes across them.")
    parser.add_argument("-n", action="store_true", default=False,
                        help="Bypass Shine-Dalgarno trainer and force a full motif scan.")
    parser.add_argument("-o", metavar="output_file", required=False,
                        help="Specify output file.")
    parser.add_argument("-p", required=False, metavar="mode",
                        choices={"single", "meta"}, default="single",
                        help="Select procedure.")
    parser.add_argument("-s", required=False, metavar="start_file",
                        help="Write all potential genes (with scores) to the selected file.")
    parser.add_argument("-t", required=False, metavar="training_file",
                        help="Write a training file (if none exists); otherwise, read and use the specified training file.")
    parser.add_argument("-j", "--jobs", type=int, required=False, default=1,
                        metavar="jobs",
                        help="The number of threads to use if input contains multiple sequences.")
    parser.add_argument("-h", "--help", action="help",
                        help="Show this help message and exit.")
    parser.add_argument("-V", "--version", action="version",
                        version="{} v{}".format(prog, version),
                        help="Show version number and exit.")
    parser.add_argument("--min-gene", required=False, type=int, default=90,
                        help="The minimum gene length.")
    parser.add_argument("--min-edge-gene", required=False, type=int, default=60,
                        help="The minimum edge gene length.")
    parser.add_argument("--max-overlap", required=False, type=int, default=60,
                        help="The maximum number of nucleotides that can overlap between two genes on the same strand. Must be lower or equal to the minimum gene length.")
    parser.add_argument("--no-stop-codon", required=False, action="store_true",
                        default=False,
                        help="Disable translation of stop codons into star characters (*) for complete genes.")
    parser.add_argument("--pool", action="store", choices=("thread", "process"),
                        default="thread",
                        help="The kind of pool used to process sequences in parallel.")
    parser.add_argument("--backend", action="store",
                        choices=("cuda", "refcore"), default="cuda",
                        help="Compute backend: the batched pipeline on a CUDA device, or the exact C engine on the CPU. Single mode is not accelerated: it runs the exact C engine on either backend.")
    parser.add_argument("--meta-batch", type=int, default=META_BATCH,
                        help="Contigs per device launch group in meta mode.")
    return parser


class OutputSink:
    """Owns every output stream of a run and writes one contig's results."""

    def __init__(self, args, stdout):
        self._files = []
        self.format = args.f
        self.include_stop = not args.no_stop_codon
        self.main = stdout if args.o is None else self._open(args.o)
        self.nuc = None if args.d is None else self._open(args.d)
        self.prot = None if args.a is None else self._open(args.a)
        self.scores = None if args.s is None else self._open(args.s)

    def _open(self, path):
        f = open(path, "w")
        self._files.append(f)
        return f

    def emit(self, seq_id, genes):
        if self.format == "gff":
            genes.write_gff(self.main, seq_id)
        else:
            genes.write_genbank(self.main, seq_id)
        if self.nuc is not None:
            genes.write_genes(self.nuc, seq_id)
        if self.prot is not None:
            genes.write_translations(self.prot, seq_id,
                                     include_stop=self.include_stop)
        if self.scores is not None:
            genes.write_scores(self.scores, seq_id)

    def close(self):
        for f in self._files:
            f.close()


def _checked_ids(records):
    for record in records:
        if not record.id:
            warnings.warn("Input file contains a sequence without identifier")
        yield record


def _make_pool(args):
    """A map function over (fn, iterable) honoring -j/--pool."""
    jobs = args.jobs if args.jobs != 0 else (os.cpu_count() or 1)
    if jobs <= 1:
        return None, map
    import multiprocessing.pool

    if args.pool == "thread":
        pool = multiprocessing.pool.ThreadPool(jobs)
    else:
        # workers start from a fresh import: a forked child cannot use the
        # CUDA state its parent initialised when it checked for a card
        pool = multiprocessing.get_context("spawn").Pool(jobs)
    return pool, pool.map


def _run_single(args, finder, records, sink):
    records = list(_checked_ids(records))
    if finder.training_info is None:
        tinf = finder.train(
            *(r.seq for r in records),
            force_nonsd=args.n,
            translation_table=args.g,
        )
        if args.t is not None and not os.path.exists(args.t):
            with open(args.t, "wb") as f:
                tinf.dump(f)
    pool, pmap = _make_pool(args)
    try:
        for record, genes in zip(records,
                                 pmap(finder.find_genes,
                                      (r.seq for r in records))):
            sink.emit(record.id, genes)
    finally:
        if pool is not None:
            pool.terminate()


def _run_meta(args, finder, records, sink):
    """Stream contigs through the batched meta pipeline, `--meta-batch`
    contigs per launch group, preserving input order in the output."""
    records = _checked_ids(records)
    group = []
    while True:
        for record in records:
            group.append(record)
            if len(group) >= args.meta_batch:
                break
        if not group:
            break
        for record, genes in zip(
            group, finder.find_genes_batch([r.seq for r in group])
        ):
            sink.emit(record.id, genes)
        group = []


def main(argv=None, stdout=None, stderr=None, stdin=None):
    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr
    stdin = sys.stdin if stdin is None else stdin
    parser = argument_parser(input_required=stdin.isatty())
    args = parser.parse_args(argv)

    training_info = None
    if args.t is not None:
        if args.p == "meta":
            print("Error: cannot specify metagenomic sequence with a "
                  "training file.", file=stderr)
            return 1
        if os.path.exists(args.t):
            with open(args.t, "rb") as f:
                training_info = TrainingInfo.load(f)

    try:
        finder = GeneFinder(
            meta=args.p == "meta",
            closed=args.c,
            mask=args.m,
            training_info=training_info,
            min_gene=args.min_gene,
            min_edge_gene=args.min_edge_gene,
            max_overlap=args.max_overlap,
            backend=args.backend,
        )
        source = stdin if args.i is None else zopen(args.i)
        sink = OutputSink(args, stdout)
        try:
            records = parse(source)
            if args.p == "meta":
                _run_meta(args, finder, records, sink)
            else:
                _run_single(args, finder, records, sink)
        finally:
            sink.close()
            if source is not stdin:
                source.close()
    except Exception as err:
        print("Error: {}".format(err), file=stderr)
        return getattr(err, "errno", 1)
    return 0


def run():
    """Console-script entry point."""
    raise SystemExit(main())
