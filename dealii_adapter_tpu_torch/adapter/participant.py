"""The coupling-participant API surface and its implementations.

The reference consumes exactly this slice of the preCICE v3 API
(`include/adapter/adapter.h`: constructor :217-225, `getMeshDimensions`
:235-240, `setMeshVertices` :324-326, `requiresInitialData` :329,
`initialize` :341, `readData` :354-358, `writeData` :332-337/377-380,
`advance` :384, `isCouplingOngoing`/`getMaxTimeStepSize`/
`isTimeWindowComplete` and `requiresWriting/ReadingCheckpoint` :447-489 and
the two solver `run()` loops; `finalize` at `linear_elasticity.cc:715`).

`FakeParticipant` is an in-process, scriptable implementation of that
surface: a configurable coupling scheme (explicit or implicit with a fixed
iteration count per window), a time-dependent read-data source standing in
for the fluid partner, and a write-data history — so the implicit-coupling
rollback and subcycling paths are testable without a fluid solver or a
`precice-config.xml` (the test double SURVEY.md §4 calls for).

A copy of the JAX package's `adapter/participant.py` (host numpy).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Protocol, runtime_checkable

import numpy as np

_EPS = 1e-12


@runtime_checkable
class Participant(Protocol):
    """Exactly the 14 methods the reference code path uses."""

    def getMeshDimensions(self, mesh_name: str) -> int: ...

    def setMeshVertices(self, mesh_name: str, coords: np.ndarray) -> np.ndarray: ...

    def requiresInitialData(self) -> bool: ...

    def initialize(self) -> None: ...

    def readData(
        self, mesh_name: str, data_name: str, ids: np.ndarray, relative_dt: float
    ) -> np.ndarray: ...

    def writeData(
        self, mesh_name: str, data_name: str, ids: np.ndarray, values: np.ndarray
    ) -> None: ...

    def advance(self, dt: float) -> None: ...

    def isCouplingOngoing(self) -> bool: ...

    def getMaxTimeStepSize(self) -> float: ...

    def isTimeWindowComplete(self) -> bool: ...

    def requiresWritingCheckpoint(self) -> bool: ...

    def requiresReadingCheckpoint(self) -> bool: ...

    def finalize(self) -> None: ...


class FakeParticipant:
    """Scriptable in-process coupling partner.

    Args:
      dim: coupling mesh dimension.
      window_dt: coupling time-window size (what `getMaxTimeStepSize`
        reports as the remaining window).
      end_time: coupling stops once this much time is completed.
      read_fn: `(t, coords) -> (n_vertices, dim)` data sampled at absolute
        time `t` — the stand-in fluid field. Defaults to zeros.
      implicit_iterations: 1 = explicit coupling; k > 1 = every window is
        repeated k times, exercising the checkpoint write/reload protocol
        exactly like a non-converging implicit scheme.
      requires_initial_data: whether the partner wants data before
        `initialize` (preCICE `<exchange ... initialize="true"/>`).
    """

    def __init__(
        self,
        dim: int,
        window_dt: float,
        end_time: float,
        read_fn: Optional[Callable[[float, np.ndarray], np.ndarray]] = None,
        implicit_iterations: int = 1,
        requires_initial_data: bool = False,
    ):
        self.dim = dim
        self.window_dt = float(window_dt)
        self.end_time = float(end_time)
        self.read_fn = read_fn
        self.implicit_iterations = int(implicit_iterations)
        self._requires_initial_data = requires_initial_data

        self.coords: Optional[np.ndarray] = None
        self.initialized = False
        self.finalized = False
        self.window_start = 0.0
        self.time_in_window = 0.0
        self.iteration = 1  # implicit sub-iteration within current window
        self._window_complete = False
        self._needs_write_checkpoint = False
        self._needs_read_checkpoint = False
        self.write_history: List[tuple] = []  # (t, iteration, values)
        self.read_log: List[float] = []

    # -- mesh access ------------------------------------------------------

    def getMeshDimensions(self, mesh_name: str) -> int:
        return self.dim

    def setMeshVertices(self, mesh_name: str, coords: np.ndarray) -> np.ndarray:
        assert not self.initialized, "setMeshVertices after initialize"
        coords = np.asarray(coords, dtype=np.float64).reshape(-1, self.dim)
        self.coords = coords
        return np.arange(coords.shape[0], dtype=np.int32)

    # -- steering ---------------------------------------------------------

    def requiresInitialData(self) -> bool:
        return self._requires_initial_data and not self.initialized

    def initialize(self) -> None:
        assert self.coords is not None, "initialize before setMeshVertices"
        self.initialized = True
        self._needs_write_checkpoint = self.implicit_iterations > 1

    def isCouplingOngoing(self) -> bool:
        return self.initialized and not self.finalized and (
            self.window_start < self.end_time - _EPS
        )

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

    # -- data -------------------------------------------------------------

    def readData(self, mesh_name, data_name, ids, relative_dt) -> np.ndarray:
        assert self.initialized
        t = self.window_start + self.time_in_window + float(relative_dt)
        self.read_log.append(t)
        if self.read_fn is None:
            return np.zeros((len(ids), self.dim))
        return np.asarray(self.read_fn(t, self.coords[ids]), dtype=np.float64)

    def writeData(self, mesh_name, data_name, ids, values) -> None:
        values = np.asarray(values, dtype=np.float64).reshape(-1, self.dim)
        t = self.window_start + self.time_in_window
        self.write_history.append((t, self.iteration, values.copy()))

    # -- stepping ---------------------------------------------------------

    def advance(self, dt: float) -> None:
        assert self.initialized and not self.finalized
        assert dt <= self.getMaxTimeStepSize() + _EPS, (
            f"dt={dt} exceeds remaining window {self.getMaxTimeStepSize()}"
        )
        self.time_in_window += float(dt)
        self._window_complete = False
        if self.time_in_window >= self.window_dt - _EPS:
            # window boundary reached
            if self.iteration < self.implicit_iterations:
                # repeat the window (non-converged implicit iteration)
                self.iteration += 1
                self.time_in_window = 0.0
                self._needs_read_checkpoint = True
            else:
                self._window_complete = True
                self.window_start += self.window_dt
                self.time_in_window = 0.0
                self.iteration = 1
                if self.implicit_iterations > 1 and self.isCouplingOngoing():
                    self._needs_write_checkpoint = True

    def finalize(self) -> None:
        self.finalized = True


class SurrogateFluidParticipant:
    """Closed-loop in-process coupling partner: a surrogate *fluid* whose
    read data depends on the displacement the solid writes.

    This exercises the physics the reference exists for — two-way implicit
    FSI through the preCICE protocol (`adapter.h:447-489`, README.md:5-10)
    — without libprecice: each coupling window is repeated until a real
    convergence measure on the exchanged displacement is met (preCICE's
    ``<relative-convergence-measure limit="eps">``), optionally accelerated
    with Aitken underrelaxation (``<acceleration:aitken>``), so the number
    of implicit iterations per window is convergence-determined, not fixed.

    The fluid law maps the current interface-displacement estimate to the
    stress the solid reads::

        stress = stress_fn(t, coords, u_relaxed)

    e.g. an added-mass piston / elastic-foundation law
    ``sigma = sigma0(t) - k * u`` creates a genuine two-way fixed point
    ``u* = S(sigma(u*))`` (S = the solid's one-window solve), the kind of
    loop whose stability is why implicit coupling schemes exist.

    Fixed-point iteration with relaxation on the displacement estimate::

        u_tilde_k = written displacement at window end (iteration k)
        r_k       = u_tilde_k - u_relaxed_{k-1}              (residual)
        converged = ||r_k|| <= eps * ||u_tilde_k||  (after >= 2 its)
        omega_k   = initial_relaxation                        (k = 1)
                  = -omega_{k-1} * <r_{k-1}, r_k - r_{k-1}>
                               / ||r_k - r_{k-1}||^2          (Aitken)
        u_relaxed_k = u_relaxed_{k-1} + omega_k * r_k
    """

    def __init__(
        self,
        dim: int,
        window_dt: float,
        end_time: float,
        stress_fn: Callable[[float, np.ndarray, np.ndarray], np.ndarray],
        eps: float = 1e-8,
        max_iterations: int = 50,
        acceleration: str = "aitken",  # "aitken" | "constant"
        initial_relaxation: float = 0.5,
        requires_initial_data: bool = False,
    ):
        assert acceleration in ("aitken", "constant")
        self.dim = dim
        self.window_dt = float(window_dt)
        self.end_time = float(end_time)
        self.stress_fn = stress_fn
        self.eps = float(eps)
        self.max_iterations = int(max_iterations)
        self.acceleration = acceleration
        self.initial_relaxation = float(initial_relaxation)
        self._requires_initial_data = requires_initial_data

        self.coords: Optional[np.ndarray] = None
        self.initialized = False
        self.finalized = False
        self.window_start = 0.0
        self.time_in_window = 0.0
        self.iteration = 1
        self._window_complete = False
        self._needs_write_checkpoint = False
        self._needs_read_checkpoint = False

        self._u_relaxed: Optional[np.ndarray] = None  # current estimate
        self._r_prev: Optional[np.ndarray] = None  # previous residual
        self._omega = self.initial_relaxation
        self._last_written: Optional[np.ndarray] = None

        # per-window implicit iteration counts (test observability)
        self.iterations_per_window: List[int] = []
        self.omega_history: List[float] = []

    # -- mesh access ------------------------------------------------------

    def getMeshDimensions(self, mesh_name: str) -> int:
        return self.dim

    def setMeshVertices(self, mesh_name: str, coords: np.ndarray) -> np.ndarray:
        assert not self.initialized, "setMeshVertices after initialize"
        coords = np.asarray(coords, dtype=np.float64).reshape(-1, self.dim)
        self.coords = coords
        self._u_relaxed = np.zeros_like(coords)
        return np.arange(coords.shape[0], dtype=np.int32)

    # -- steering ---------------------------------------------------------

    def requiresInitialData(self) -> bool:
        return self._requires_initial_data and not self.initialized

    def initialize(self) -> None:
        assert self.coords is not None, "initialize before setMeshVertices"
        self.initialized = True
        self._needs_write_checkpoint = True

    def isCouplingOngoing(self) -> bool:
        return self.initialized and not self.finalized and (
            self.window_start < self.end_time - _EPS
        )

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

    # -- data -------------------------------------------------------------

    def readData(self, mesh_name, data_name, ids, relative_dt) -> np.ndarray:
        assert self.initialized
        t = self.window_start + self.time_in_window + float(relative_dt)
        return np.asarray(
            self.stress_fn(t, self.coords[ids], self._u_relaxed[ids]),
            dtype=np.float64,
        )

    def writeData(self, mesh_name, data_name, ids, values) -> None:
        vals = np.asarray(values, dtype=np.float64).reshape(-1, self.dim)
        if self._last_written is None:
            self._last_written = np.zeros((len(self.coords), self.dim))
        self._last_written[ids] = vals

    # -- stepping ---------------------------------------------------------

    def advance(self, dt: float) -> None:
        assert self.initialized and not self.finalized
        assert dt <= self.getMaxTimeStepSize() + _EPS, (
            f"dt={dt} exceeds remaining window {self.getMaxTimeStepSize()}"
        )
        self.time_in_window += float(dt)
        self._window_complete = False
        if self.time_in_window < self.window_dt - _EPS:
            return  # mid-window subcycle: nothing to decide yet

        # window boundary: convergence measure on the exchanged data
        u_tilde = self._last_written
        assert u_tilde is not None, "advance without writeData"
        r = u_tilde - self._u_relaxed
        norm_r = float(np.linalg.norm(r))
        norm_u = float(np.linalg.norm(u_tilde))
        # preCICE requires at least one repeat before declaring convergence
        # (the measure compares successive iterations)
        converged = self.iteration > 1 and norm_r <= self.eps * max(
            norm_u, 1e-30
        )
        if not converged and self.iteration >= self.max_iterations:
            raise RuntimeError(
                f"implicit coupling did not converge in "
                f"{self.max_iterations} iterations (|r|={norm_r:.3e}, "
                f"rel={norm_r / max(norm_u, 1e-30):.3e})"
            )

        if converged:
            self.iterations_per_window.append(self.iteration)
            self._window_complete = True
            self.window_start += self.window_dt
            self.time_in_window = 0.0
            self.iteration = 1
            self._r_prev = None
            self._omega = self.initial_relaxation
            # the converged displacement seeds the next window's estimate
            self._u_relaxed = u_tilde.copy()
            if self.isCouplingOngoing():
                self._needs_write_checkpoint = True
        else:
            if self.acceleration == "aitken" and self._r_prev is not None:
                dr = r - self._r_prev
                denom = float(np.vdot(dr, dr))
                if denom > 0.0:
                    self._omega = -self._omega * float(
                        np.vdot(self._r_prev, dr)
                    ) / denom
                    # surrogate-only stabilization: keep the factor in a
                    # sane range so a near-orthogonal residual pair can't
                    # blow up the test double. (preCICE itself handles
                    # this differently — it caps the INITIAL factor and
                    # manages sign internally — so do not read this clamp
                    # as Aitken fidelity; the surrogate only needs to
                    # drive the adapter through realistic implicit
                    # windows.)
                    self._omega = float(np.clip(self._omega, -10.0, 10.0))
            self.omega_history.append(self._omega)
            self._u_relaxed = self._u_relaxed + self._omega * r
            self._r_prev = r
            self.iteration += 1
            self.time_in_window = 0.0
            self._needs_read_checkpoint = True

    def finalize(self) -> None:
        self.finalized = True


class PreciceParticipant:
    """Thin binding to real pyprecice (preCICE v3). Import-gated: this
    image has no libprecice; construction raises with guidance unless
    pyprecice is installed (production deployments couple to OpenFOAM etc.
    through this class — same call surface as `FakeParticipant`)."""

    def __init__(self, participant_name: str, config_file: str, rank=0, size=1):
        try:
            import precice
        except ImportError as e:  # pragma: no cover - environment-dependent
            raise ImportError(
                "pyprecice is not installed; use FakeParticipant for "
                "standalone/test runs or install preCICE v3 + pyprecice "
                "for real coupled FSI"
            ) from e
        self._p = precice.Participant(participant_name, config_file, rank, size)

    def __getattr__(self, name):  # delegate the full surface
        return getattr(self._p, name)

    # pyprecice exposes snake_case; map the camelCase surface  ------------
    def getMeshDimensions(self, mesh_name):
        return self._p.get_mesh_dimensions(mesh_name)

    def setMeshVertices(self, mesh_name, coords):
        return self._p.set_mesh_vertices(mesh_name, coords)

    def requiresInitialData(self):
        return self._p.requires_initial_data()

    def initialize(self):
        return self._p.initialize()

    def readData(self, mesh_name, data_name, ids, relative_dt):
        return self._p.read_data(mesh_name, data_name, ids, relative_dt)

    def writeData(self, mesh_name, data_name, ids, values):
        return self._p.write_data(mesh_name, data_name, ids, values)

    def advance(self, dt):
        return self._p.advance(dt)

    def isCouplingOngoing(self):
        return self._p.is_coupling_ongoing()

    def getMaxTimeStepSize(self):
        return self._p.get_max_time_step_size()

    def isTimeWindowComplete(self):
        return self._p.is_time_window_complete()

    def requiresWritingCheckpoint(self):
        return self._p.requires_writing_checkpoint()

    def requiresReadingCheckpoint(self):
        return self._p.requires_reading_checkpoint()

    def finalize(self):
        return self._p.finalize()


def make_participant(params, fake: Optional[FakeParticipant] = None):
    """Participant factory: an explicitly supplied fake (tests/standalone),
    else real pyprecice from the run parameters (the reference constructs
    its participant at solver construction, `adapter.h:217-225`)."""
    if fake is not None:
        return fake
    return PreciceParticipant(params.participant_name, params.config_file)
