"""The window's seconds over the coupling windows completed in it, each
with all its implicit iterations (host clock)."""


def read(run):
    if not run.attempted:
        return None
    return run.window_s / run.attempted * 1e3
