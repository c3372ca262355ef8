"""Meta mode: a call is `GeneFinder(meta=True).find_genes_batch` over the
call's contigs; its reference, `reference/engine.py`'s meta mode."""


def finder(config):
    from pyrodigal_tpu_torch import GeneFinder

    return GeneFinder(meta=True, **config["options"])


def call(finder, contigs, recorder, index):
    """One call of the entry: the genes of each contig."""
    recorder.open_call(index)
    return finder.find_genes_batch([s for _n, s in contigs])


def close(finder):
    runner = getattr(finder, "_meta_runner", None)
    if runner is not None:
        runner.close()


def texts(result, contigs):
    """What a user writes of each contig's genes (GFF, protein FASTA,
    nucleotide FASTA), or None per contig for a call that raised."""
    import io

    if result is None:
        return [None] * len(contigs)
    out = []
    for genes, (name, _s) in zip(result, contigs):
        files = []
        for write in (genes.write_gff, genes.write_translations,
                      genes.write_genes):
            buf = io.StringIO()
            write(buf, name)
            files.append(buf.getvalue())
        out.append(tuple(files))
    return out


def reference(ex, config, calls, precision="f64", with_texts=True):
    """The reference of calls [(contigs, num_seq of the first)]: per
    call, per contig, ({bin: score or None}, texts or None)."""
    from genebench.reference import engine

    return engine.run_meta(ex, config["options"], calls, precision,
                           with_texts)
