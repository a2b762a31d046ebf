"""Implicit coupling iterations a window (the surrogate fluid's count),
over the window."""


def read(run):
    its = run.iterations_per_window
    if not its:
        return None
    return sum(its) / len(its)
