"""DP launches (the port's counter `dp_cuda.LAUNCHES`, mega and std) per
Mbp of the window's input: how finely packing cuts the work."""


def read(run):
    n = run.counts.get("launches.dp_mega", 0) \
        + run.counts.get("launches.dp_std", 0)
    if not run.window_bp or not n:
        return None
    return n / (run.window_bp / 1e6)
