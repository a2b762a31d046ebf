"""Output and observability: VTK Lagrange-cell writer, strain
postprocessor, and section wall timers (copies of the JAX package's host
numpy modules)."""

from .postprocessor import compute_nodal_strain
from .timer import TimerOutput
from .vtk import write_vtu

__all__ = ["compute_nodal_strain", "TimerOutput", "write_vtu"]
