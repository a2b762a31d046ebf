"""The coupled time loop — counterpart of `dealii_adapter_tpu/runner.py`,
the framework's equivalent of the two reference `run()` loops
(`linear_elasticity.cc:634-716`, `nonlinear_elasticity.cc:99-167`).

Steered by the participant, not by `t < t_end`: the loop runs while
`isCouplingOngoing()`, checkpoints/rolls back the state (cloned tensors,
`adapter/adapter.py`) when the implicit coupling scheme demands it, and
emits output only on completed time windows. Works with both solver
models (they share the `initial_state()` / `step(state, interface_data)` /
`with_delta_t(dt)` surface) and any participant (real preCICE or the
in-process fakes).

On several ranks (a model with a `device_mesh`) every rank runs this loop
with its own rows of the state; the adapter, built with the model's
`device_mesh`, holds the participant on rank 0 and hands every rank rank
0's steering answers, so every rank takes the same branch, and
`output_cb` fires on every rank with its rows.
"""

from __future__ import annotations

from typing import Callable, Optional

from .adapter.adapter import Adapter
from .time_handler import Time

_EPS = 1e-10


class NewtonDivergedError(RuntimeError):
    """Raised when the nonlinear solve does not converge — the analog of
    the AssertThrow at `nonlinear_elasticity.cc:497-498`."""



def coupled_run(
    model,
    adapter: Adapter,
    output_cb: Optional[Callable] = None,
    strict_dt: bool = True,
    state=None,
):
    """Run the full coupled simulation; returns the final state.

    `output_cb(state, time, info)` fires after each *completed* time window
    whose step index matches the output interval
    (`linear_elasticity.cc:708-710`).

    `strict_dt=True` enforces the reference's constant-timestep contract
    (solver dt == preCICE max window size, `linear_elasticity.cc:666-674`);
    with False the solver subcycles: it advances in chunks of at most its
    own dt until the window closes (the design headroom noted at
    `adapter.h:104-107`).
    """
    params = model.params
    time = Time(params.end_time, params.delta_t)
    if state is None:
        state = model.initial_state()
    adapter.initialize(state.displacement)

    info = None
    while adapter.is_coupling_ongoing():
        adapter.save_current_state_if_required(state, time)

        max_dt = adapter.get_max_time_step_size()
        if strict_dt:
            if abs(params.delta_t - max_dt) > _EPS * max(1.0, params.delta_t):
                raise RuntimeError(
                    "The solver time step differs from the preCICE maximum "
                    f"time step size ({params.delta_t} vs {max_dt}). Adjust "
                    "the config (linear_elasticity.cc:666-674)."
                )
            dt = params.delta_t
        else:
            dt = min(params.delta_t, max_dt)
        if dt == params.delta_t:
            step_model = model
            time.increment()
        else:
            # subcycling: a shortened chunk closes the window with a cached
            # per-dt stepper clone; the step index is recomputed from
            # absolute time (`time_handler.h:63-70`, `adapter.h:104-107`)
            step_model = model.with_delta_t(dt)
            time.set_absolute_time(time.current() + dt)

        interface_data = adapter.read_data(dt)
        state, info = step_model.step(state, interface_data)
        if hasattr(info, "converged") and not bool(info.converged):
            raise NewtonDivergedError(
                f"No convergence in Newton at t={time.current():.6g} "
                f"(residual_rel={float(info.residual_rel):.3e})"
            )

        adapter.advance(state.displacement, dt)
        state = adapter.reload_old_state_if_required(state, time)

        if (
            adapter.is_time_window_complete()
            and time.get_timestep() % params.output_interval == 0
            and output_cb is not None
        ):
            output_cb(state, time, info)

    adapter.finalize()
    return state
