"""How long a call's std launches wait for its preps: the share of each
traced call's wall time before its first std `launch` span opens, over
the calls of the profiled stretch that launched on the std route, in %.
The std launches are packed only once every contig's prep is done
(`CudaMetaRunner._find_genes_batch`), so this reads that barrier."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    if st is None:
        return None
    first = {}
    for s in st.named("launch"):
        if s.attrs.get("route") == "std":
            first[s.call] = min(first.get(s.call, s.start), s.start)
    calls = [c for c in st.calls if c.id in first]
    if not calls:
        return None
    before = sum(first[c.id] - c.start for c in calls)
    return 100.0 * before / sum(c.end - c.start for c in calls)
