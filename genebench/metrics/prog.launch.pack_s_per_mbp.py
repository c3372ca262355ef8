"""Host packing of the launches: the `launch.pack` spans
(`pack_geometries_multi` and the buckets of a mega launch, `_std_inputs`
of a std launch, on the launcher thread) of the profiled stretch, per Mbp
of the stretch."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    return None if st is None else st.per_mbp("launch.pack")
