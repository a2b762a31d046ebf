"""The surrogate fluid that the `fsi_implicit` traffic couples to the
solid: a copy of the program's `adapter/participant.py:
SurrogateFluidParticipant` (the yardstick's traffic must not change with
the program), with three additions for a timed run:

* it ends the coupling at the first window boundary after `deadline`
  (host clock), so the run measures whole coupling windows;
* a window that reaches `max_iterations` is accepted and counted in
  `capped` instead of raising, so the run goes on and reports it failed;
* it keeps what the check needs: the traction it returned at the last
  read of each window (`accepted_reads`, per completed window), and calls
  `on_window(window index, last read, written displacement)` when a
  window completes.

The participant API surface (the 13 methods preCICE's solver side uses)
is the program's `Participant` protocol.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

_EPS = 1e-12


class TimedSurrogateFluid:
    """Closed-loop in-process fluid: stress = stress_fn(t, coords,
    u_relaxed), with each window repeated until the displacement the solid
    writes converges (||r|| <= eps ||u_tilde||, after at least two
    iterations), Aitken-relaxed:

        r_k         = u_tilde_k - u_relaxed_{k-1}
        omega_1     = initial_relaxation
        omega_k     = -omega_{k-1} <r_{k-1}, r_k - r_{k-1}> / ||r_k - r_{k-1}||^2
        u_relaxed_k = u_relaxed_{k-1} + omega_k r_k
    """

    def __init__(self, dim: int, window_dt: float,
                 stress_fn: Callable[[float, np.ndarray, np.ndarray], np.ndarray],
                 eps: float, max_iterations: int, initial_relaxation: float,
                 deadline: Optional[float] = None, max_windows: Optional[int] = None,
                 on_window: Optional[Callable] = None):
        self.dim = dim
        self.window_dt = float(window_dt)
        self.stress_fn = stress_fn
        self.eps = float(eps)
        self.max_iterations = int(max_iterations)
        self.initial_relaxation = float(initial_relaxation)
        self.deadline = deadline
        self.max_windows = max_windows
        self.on_window = on_window

        self.coords: Optional[np.ndarray] = None
        self.initialized = False
        self.finalized = False
        self.stopped = False
        self.window_start = 0.0
        self.time_in_window = 0.0
        self.iteration = 1
        self._window_complete = False
        self._needs_write_checkpoint = False
        self._needs_read_checkpoint = False
        self._u_relaxed: Optional[np.ndarray] = None
        self._r_prev: Optional[np.ndarray] = None
        self._omega = self.initial_relaxation
        self._last_written: Optional[np.ndarray] = None
        self.last_read: Optional[np.ndarray] = None

        self.iterations_per_window: List[int] = []
        self.capped = 0  # windows accepted at the iteration cap

    @property
    def window(self) -> int:
        """The index of the window being iterated."""
        return len(self.iterations_per_window)

    def getMeshDimensions(self, mesh_name: str) -> int:
        return self.dim

    def setMeshVertices(self, mesh_name: str, coords: np.ndarray) -> np.ndarray:
        coords = np.asarray(coords, dtype=np.float64).reshape(-1, self.dim)
        self.coords = coords
        self._u_relaxed = np.zeros_like(coords)
        return np.arange(coords.shape[0], dtype=np.int32)

    def requiresInitialData(self) -> bool:
        return False

    def initialize(self) -> None:
        if self.coords is None:
            raise RuntimeError("initialize before setMeshVertices")
        self.initialized = True
        self._needs_write_checkpoint = True

    def isCouplingOngoing(self) -> bool:
        return self.initialized and not self.finalized and not self.stopped

    def getMaxTimeStepSize(self) -> float:
        return self.window_dt - self.time_in_window

    def isTimeWindowComplete(self) -> bool:
        return self._window_complete

    def requiresWritingCheckpoint(self) -> bool:
        if self._needs_write_checkpoint:
            self._needs_write_checkpoint = False
            return True
        return False

    def requiresReadingCheckpoint(self) -> bool:
        if self._needs_read_checkpoint:
            self._needs_read_checkpoint = False
            return True
        return False

    def readData(self, mesh_name, data_name, ids, relative_dt) -> np.ndarray:
        t = self.window_start + self.time_in_window + float(relative_dt)
        self.last_read = np.asarray(
            self.stress_fn(t, self.coords[ids], self._u_relaxed[ids]),
            dtype=np.float64)
        return self.last_read

    def writeData(self, mesh_name, data_name, ids, values) -> None:
        vals = np.asarray(values, dtype=np.float64).reshape(-1, self.dim)
        if self._last_written is None:
            self._last_written = np.zeros((len(self.coords), self.dim))
        self._last_written[ids] = vals

    def advance(self, dt: float) -> None:
        self.time_in_window += float(dt)
        self._window_complete = False
        if self.time_in_window < self.window_dt - _EPS:
            return
        u_tilde = self._last_written
        r = u_tilde - self._u_relaxed
        norm_r = float(np.linalg.norm(r))
        norm_u = float(np.linalg.norm(u_tilde))
        converged = self.iteration > 1 and norm_r <= self.eps * max(norm_u, 1e-30)
        capped = not converged and self.iteration >= self.max_iterations
        if converged or capped:
            self.capped += int(capped)
            window = self.window
            self.iterations_per_window.append(self.iteration)
            self._window_complete = True
            self.window_start += self.window_dt
            self.time_in_window = 0.0
            self.iteration = 1
            self._r_prev = None
            self._omega = self.initial_relaxation
            self._u_relaxed = u_tilde.copy()
            if self.on_window is not None:
                self.on_window(window, self.last_read, u_tilde.copy())
            self.stopped = (
                (self.deadline is not None and time.perf_counter() >= self.deadline)
                or (self.max_windows is not None and self.window >= self.max_windows))
            if not self.stopped:
                self._needs_write_checkpoint = True
        else:
            if self._r_prev is not None:
                dr = r - self._r_prev
                denom = float(np.vdot(dr, dr))
                if denom > 0.0:
                    self._omega = -self._omega * float(
                        np.vdot(self._r_prev, dr)) / denom
                    # the program's surrogate keeps the factor in [-10, 10]
                    self._omega = float(np.clip(self._omega, -10.0, 10.0))
            self._u_relaxed = self._u_relaxed + self._omega * r
            self._r_prev = r
            self.iteration += 1
            self.time_in_window = 0.0
            self._needs_read_checkpoint = True

    def finalize(self) -> None:
        self.finalized = True
