"""The 90th percentile of every step's time in the window: CUDA events
recorded on the card's stream before the step's first launch and after
its closing read-back, so the device's idle waits for the host count
(statistics.quantiles, exclusive method)."""

import statistics


def read(run):
    ms = [s["event_ms"] if s["event_ms"] is not None else s["host_s"] * 1e3
          for s in run.steps]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=10)[-1]
