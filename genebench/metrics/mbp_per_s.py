"""Mbp/s: the bp of input of every call the window ran, over the time
from the first call's start to the last call's end (host clock)."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return run.window_bp / 1e6 / run.window_s
