"""The program's own set-up: the `setup.*` spans (the kernels' build or
load, the C engine's build or load, the runner's construction), which
the program records whether or not tracing is on, in seconds."""

from genebench import progspans


def read(run):
    spans = progspans.program_spans()
    setup = [s for s in spans or () if s.name.startswith("setup.")]
    if not setup:
        return None
    return sum((s.end - s.start) * 1e-9 for s in setup)
