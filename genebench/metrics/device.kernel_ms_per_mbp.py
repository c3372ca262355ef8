"""Device milliseconds of the port's six hand-written kernels (every
entry of `csrc/*.cu`, by name in the trace) per Mbp of the profiled
calls' input."""

PORT_KERNELS = ("dc_chain_", "phase_cumsum_", "star_kernel",
                "dp_mega_kernel", "dp_std_kernel", "seg_scan_")


def read(run):
    t = run.trace
    if t is None or not t.bp:
        return None
    s = t.kernel_seconds(*PORT_KERNELS)
    if s <= 0:
        return None
    return 1e3 * s / (t.bp / 1e6)
