"""The launches' waits on the card: the `launch.wait` spans (every host
sync of a launch: the pull of its scores, `best.cpu()` in each
`parallel.meta_shard` shard, and the syncs before it) of the profiled
stretch, per Mbp of the stretch."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    return None if st is None else st.per_mbp("launch.wait")
