"""The exact route, `CudaMetaRunner._produce_fallback`: a contig whose
geometry the mega kernel cannot take, swept whole, bin after bin, on the
exact engine: seconds summed over the threads, per Mbp of the window's
input (0 in a traced run where no contig took it)."""


def read(run):
    if not run.window_bp or not any(sp[0] == "prep" for sp in run.spans):
        return None
    return run.span_seconds("fallback") / (run.window_bp / 1e6)
