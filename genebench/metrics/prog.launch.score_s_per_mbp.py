"""The launches' device scoring on the host: the `launch.score` spans
(`score_device._score_items` inside a launch: the host time that issues
the scoring's work to the card) of the profiled stretch, less their own
`launch.wait` children (the host syncs inside the scoring), per Mbp of
the stretch."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    if st is None:
        return None
    scores = st.named("launch.score")
    if not scores:
        return None
    ids = {s.id for s in scores}
    waits = [s for s in st.named("launch.wait") if s.parent in ids]
    own = sum(s.end - s.start for s in scores) \
        - sum(s.end - s.start for s in waits)
    return own * 1e-9 / (st.bp / 1e6)
