"""Host prep (`CudaMetaRunner._prepare_contig` on the runner's 8-thread
pool): seconds summed over the threads, per Mbp of the window's input."""


def read(run):
    if not run.window_bp or not any(sp[0] == "prep" for sp in run.spans):
        return None
    return run.span_seconds("prep") / (run.window_bp / 1e6)
