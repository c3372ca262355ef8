"""The exact route as the program records it: the `exact_route` spans
(`_produce_fallback`, a contig the mega kernel cannot take swept whole,
bin after bin, on the exact engine) of the profiled stretch, seconds
summed over threads, per Mbp of the stretch (0 where no contig took
it)."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    return None if st is None else st.per_mbp("exact_route")
