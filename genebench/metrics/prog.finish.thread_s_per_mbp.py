"""Exact finishing as the program records it: the `finish` spans
(`_produce_winner`, the winning bin and its close rivals re-run on the
exact engine, on the runner's pool) of the profiled stretch, seconds
summed over threads, per Mbp of the stretch."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    return None if st is None else st.per_mbp("finish")
