"""100 - the busy union of the card's kernels and copies over the traced
stretch (the traffic's `trace` entry: two steps after the first), in % of
the stretch's host-clock length."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.wall_s)
