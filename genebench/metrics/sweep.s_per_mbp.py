"""Packing and launch (`CudaMetaRunner._sweep_mega_multi` and `_sweep_std`
on the launcher thread, each until its best scores are on the host):
seconds per Mbp of the window's input."""


def read(run):
    if not run.window_bp or not any(sp[0] == "sweep" for sp in run.spans):
        return None
    return run.span_seconds("sweep") / (run.window_bp / 1e6)
