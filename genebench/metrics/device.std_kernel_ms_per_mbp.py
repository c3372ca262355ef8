"""Device milliseconds of the std route's kernels per Mbp of the profiled
calls' input: phase-cumsum's two passes, the seg-scan's rows kernel and
the std DP, named whole (the mega route runs dc-chain, the seg-scan's
chain kernel and the mega DP instead), and the star kernels that ran
inside a std `launch` span of the program (the star kernel serves both
routes).  A kernel belongs to the span that holds its midpoint, the
program's spans moved onto the trace's clock by the offset between each
traced call's `genebench.call` annotation and the program's `call` span.
None without a trace or without the program's spans."""

from genebench import progspans

STD_ONLY = ("phase_cumsum_reduce_kernel", "phase_cumsum_kernel",
            "seg_scan_rows_kernel", "dp_std_kernel")
SHARED = "star_kernel"


def base_name(name):
    """A kernel's name in the trace without its namespace, its return
    type, its template arguments and its arguments: `(anonymous
    namespace)::dp_std_kernel(int const*, ...)` -> `dp_std_kernel`."""
    head = name.split("(anonymous namespace)::")[-1].split("(")[0]
    words = head.split("<")[0].split()
    return words[-1].split("::")[-1] if words else ""


def std_windows(run, st):
    """[(start, end)] in seconds on the trace's clock of the stretch's std
    `launch` spans."""
    marks = run.trace.calls
    if len(marks) != len(st.calls):
        raise RuntimeError(f"{len(st.calls)} program calls in the stretch, "
                           f"{len(marks)} annotations")
    offset = sum(m[0] - c.start * 1e-9
                 for m, c in zip(marks, st.calls)) / len(marks)
    return [(s.start * 1e-9 + offset, s.end * 1e-9 + offset)
            for s in st.named("launch") if s.attrs.get("route") == "std"]


def read(run, st=None):
    t = run.trace
    if t is None or not t.bp:
        return None
    st = progspans.stretch(run) if st is None else st
    if st is None:
        return None
    windows = std_windows(run, st)
    s = 0.0
    for name, a, b in t.kernels:
        k = base_name(name)
        if k in STD_ONLY or (k == SHARED and any(
                w0 <= (a + b) / 2 < w1 for w0, w1 in windows)):
            s += b - a
    if s <= 0:
        return None
    return 1e3 * s / (t.bp / 1e6)
