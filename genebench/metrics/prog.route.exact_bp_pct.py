"""The share of the profiled stretch's bp that took the exact route: the
bp of the `prep` spans whose `route` is "c" over the stretch's bp, in %.
(Each such span's `route_reason` says which constraint of the mega
kernel the contig broke.)"""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    if st is None:
        return None
    exact = sum(s.attrs["bp"] for s in st.named("prep")
                if s.attrs.get("route") == "c")
    return 100.0 * exact / st.bp
