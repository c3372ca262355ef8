"""How far the exact route's bins run side by side: the `exact_route.bin`
spans of the profiled stretch (one a candidate bin of a contig the mega
kernel cannot take), seconds summed over threads, over the stretch's
`exact_route` seconds (0 where no contig took the route).  Bins swept one
after another inside their contig's span read a little under 1; bins
run beside each other read up to the threads they run on."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    if st is None:
        return None
    exact = st.seconds("exact_route")
    return st.seconds("exact_route.bin") / exact if exact else 0.0
