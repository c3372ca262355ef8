"""Host prep as the program records it: the `prep` spans
(`CudaMetaRunner._prepare_contig` on the runner's pool: nodes, geometry,
route) of the profiled stretch, seconds summed over threads, per Mbp of
the stretch."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    return None if st is None else st.per_mbp("prep")
