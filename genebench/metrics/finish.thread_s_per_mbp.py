"""Exact finishing on the runner's pool, `CudaMetaRunner._produce_winner`
(the winning bin and its close rivals re-run on the exact engine):
seconds summed over the threads, per Mbp of the window's input."""


def read(run):
    if not run.window_bp or not any(sp[0] == "finish" for sp in run.spans):
        return None
    return run.span_seconds("finish") / (run.window_bp / 1e6)
