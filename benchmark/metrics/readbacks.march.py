"""The program's device-to-host read-backs a step (`model.host_syncs`),
over the window; the benchmark's own read of the tip is not counted."""


def read(run):
    if not run.steps:
        return None
    return sum(s["readbacks"] for s in run.steps) / len(run.steps)
