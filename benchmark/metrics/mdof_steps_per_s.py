"""Millions of DoF times the steps completed in the window, over the
window's seconds (host clock)."""


def read(run):
    if not run.steps:
        return None
    return run.n_dofs * len(run.steps) / run.window_s / 1e6
