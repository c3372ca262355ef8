"""How full the launches are: real node-rows over bucket node-rows,
summed over the `launch` spans of the profiled stretch, in %.  A mega
launch's real node-rows are each item's nodes times its own bins, against
its node bucket times its bin rows; a std launch's, each work row's
nodes, against its rows times the std node bucket."""

from genebench import progspans


def read(run):
    st = progspans.stretch(run)
    launches = [] if st is None else st.named("launch")
    bucket = sum(s.attrs["node_rows_bucket"] for s in launches)
    if not bucket:
        return None
    return 100.0 * sum(s.attrs["node_rows"] for s in launches) / bucket
