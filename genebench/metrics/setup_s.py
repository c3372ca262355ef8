"""Set-up: from the process's start to the window's start (imports, CUDA,
the port's kernels and C engine, the traffic, the finder, the warm
call)."""


def read(run):
    return run.setup_s
