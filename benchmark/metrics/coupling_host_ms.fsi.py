"""Milliseconds a coupling window outside `model.step`: each window's time
less its steps' (host clock around each call of `model.step` made by
`runner.coupled_run`), averaged over the windows completed, the traced
window left out. It holds the adapter's read, write, checkpoint and
rollback, the surrogate fluid and the wait for the step's last kernels at
the write's read-back."""


def read(run):
    out = [wall - steps for w, (wall, steps) in enumerate(
        zip(run.window_wall_s, run.step_s_per_window))
        if w not in run.traced_windows]
    if not out:
        return None
    return sum(out) / len(out) * 1e3
