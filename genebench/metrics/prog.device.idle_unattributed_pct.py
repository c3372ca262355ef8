"""The part of the card's idle time that no program span accounts for:
of the profiled stretch's device idle time, the share during which no
span of the program other than `call` is open on any thread, in %
(`progspans.attribute_idle`, on the trace's clock; it raises when the
program's calls and the trace's annotations do not line up)."""

from genebench import progspans


def read(run):
    idle = progspans.attribute_idle(run)
    if not idle:
        return None
    total = sum(idle.values())
    return 100.0 * (idle.get(progspans.CALL_ONLY, 0.0)
                    + idle.get(progspans.OUTSIDE, 0.0)) / total
