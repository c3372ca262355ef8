#!/usr/bin/env python3
"""Runs one cell of the benchmark once and prints its result as the last
line of standard output:

    python3 genebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It exits 1 and prints no result without a CUDA card (it never falls
back to the CPU), outside a checkout of the repository, or when a module
of JAX or of the JAX package is loaded."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# import the benchmark as a package from the checkout's root, never its
# modules by their bare names
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from genebench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
