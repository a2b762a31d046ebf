"""Q2 structured element operator (kernel K5), the multigrid fine proxy.

Counterpart of `dealii_adapter_tpu/ops/pallas_phase.py`
(`PallasQ2PhaseOperator`, `make_q2_operator_auto`).
`Q2StructuredOperator(u)` computes y = A u for a constant 81 x 81 element
matrix over a 3D Q2 node lattice:

* on a CUDA tensor it launches csrc/q2_structured.cu, which works on the
  nodal lattice directly (no phase split), bf16 or f32 I/O with f32
  accumulation;
* on a CPU tensor it runs the plain version, `ops/structured.py`'s
  `StructuredOperator`, in f32 (f64 for f64 I/O), rounded to the I/O
  dtype.

Other degrees take the plain `StructuredOperator` on every device, as the
JAX package computes them outside any Pallas kernel. 2D Q2 on the card
raises until the 2D kernel (K4b) is ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.dofspace import DofSpace
from .q1_structured import StructuredKernelOperator
from .structured import _grid_shape, structured_operator_from_lattice


class Q2StructuredOperator(StructuredKernelOperator):
    """K5: the Q2 fine-level operator (csrc/q2_structured.cu)."""

    p = 2
    entry = "dat_q2_structured"
    launches = 0


class _PlainDegreeOperator:
    """A degree-p (p != 2) fine operator: the plain `StructuredOperator` on
    every device, computing in f32 (f64 for f64 I/O)."""

    def __init__(self, E, grid_shape, p, dtype, device):
        cdt = torch.float64 if dtype == torch.float64 else torch.float32
        self._op = structured_operator_from_lattice(E, grid_shape, p, cdt, device)
        self.dtype = dtype

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self._op(u.to(self._op.EpT.dtype)).to(u.dtype)

    def diagonal(self) -> torch.Tensor:
        return self._op.diagonal().to(self.dtype)


def make_q2_operator(
    space: DofSpace, E: np.ndarray, dtype=torch.float32, device="cpu"
):
    """MG fine-level operator of a space: `Q2StructuredOperator` at degree
    2, the plain structured operator at any other degree."""
    if space.mesh.degree == 2:
        return Q2StructuredOperator(E, _grid_shape(space), dtype, device)
    return _PlainDegreeOperator(
        E, _grid_shape(space), space.mesh.degree, dtype, device
    )
