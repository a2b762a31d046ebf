"""Time bookkeeping for the coupled time loop.

Equivalent of `Adapter::Time` (`include/adapter/time_handler.h:21-84`):
tracks the timestep counter, current/end time and step size, and supports
rewinding to an absolute time for implicit-coupling rollback and
solver subcycling (`time_handler.h:63-70`).

A copy of the JAX package's `time_handler.py` (host numpy).
"""

from __future__ import annotations


class Time:
    def __init__(self, time_end: float, delta_t: float):
        self._timestep = 0
        self._time_current = 0.0
        self._time_end = float(time_end)
        self._delta_t = float(delta_t)

    def current(self) -> float:
        return self._time_current

    def end(self) -> float:
        return self._time_end

    def get_delta_t(self) -> float:
        return self._delta_t

    def get_timestep(self) -> int:
        return self._timestep

    def set_absolute_time(self, new_time: float) -> None:
        """Recompute the step index from an absolute time value.

        Rounds to 10 decimal digits to absorb floating-point drift, matching
        the guard in `time_handler.h:63-70`. Needed for checkpoint restore
        and subcycling solvers.
        """
        factor = 10.0 ** 10
        self._timestep = int(round(round((new_time / self._delta_t) * factor) / factor))
        self._time_current = new_time

    def increment(self) -> None:
        self._time_current += self._delta_t
        self._timestep += 1
