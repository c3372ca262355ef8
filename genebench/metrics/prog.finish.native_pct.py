"""How much of exact finishing's bin re-runs runs in native code, which
holds no interpreter lock: 100 x the `native_s` of the profiled stretch's
`finish.rerun` spans (the seconds inside each re-run's foreign call) over
those spans' seconds.  None where no span carries `native_s`: a program
that re-runs a bin in many calls from Python, or no re-run."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    if st is None:
        return None
    native = [s.attrs["native_s"] for s in st.named("finish.rerun")
              if "native_s" in s.attrs]
    seconds = st.seconds("finish.rerun")
    if not native or not seconds:
        return None
    return 100.0 * sum(native) / seconds
