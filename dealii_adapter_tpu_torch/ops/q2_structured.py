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

Other degrees, and Q2 in 2D, take the plain `StructuredOperator` on every
device, as the JAX package computes them outside any Pallas kernel (its
phase kernel is 3D only, `pallas_phase.py:pallas_q2_supported`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.dofspace import DofSpace
from .q1_structured import StructuredKernelOperator
from .structured import _grid_shape, structured_operator_from_lattice


class Q2StructuredOperator(StructuredKernelOperator):
    """K5: the 3D Q2 fine-level operator (csrc/q2_structured.cu)."""

    p = 2
    dim = 3
    entry = "dat_q2_structured"
    launches = 0


class _PlainDegreeOperator:
    """A fine operator without a kernel (2D, or degree != 2): the plain
    `StructuredOperator` on every device, computing in f32 (f64 for f64
    I/O). Its element matrix is held in the I/O dtype's precision, as the
    JAX package's `StructuredOperator` holds it (in bf16 for a bf16
    hierarchy): with the f32 element matrix the 2D bf16 V-cycle took
    ~1.7x the reference's CG iterations."""

    def __init__(self, E, grid_shape, p, dtype, device):
        cdt = torch.float64 if dtype == torch.float64 else torch.float32
        E = torch.as_tensor(np.asarray(E, dtype=np.float64)).to(dtype).double()
        self._op = structured_operator_from_lattice(
            E.numpy(), grid_shape, p, cdt, device
        )
        self.dtype = dtype

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self._op(u.to(self._op.EpT.dtype)).to(u.dtype)

    def diagonal(self) -> torch.Tensor:
        return self._op.diagonal().to(self.dtype)


def make_q2_operator(
    space: DofSpace, E: np.ndarray, dtype=torch.float32, device=None
):
    """MG fine-level operator of a space: `Q2StructuredOperator` for 3D Q2,
    the plain structured operator otherwise."""
    if space.mesh.degree == 2 and space.dim == 3:
        return Q2StructuredOperator(E, _grid_shape(space), dtype, device)
    return _PlainDegreeOperator(
        E, _grid_shape(space), space.mesh.degree, dtype, device
    )
