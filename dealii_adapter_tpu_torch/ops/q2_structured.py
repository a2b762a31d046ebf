"""Q2 structured element operator (kernel K5), the multigrid fine proxy.

Counterpart of `dealii_adapter_tpu/ops/pallas_phase.py`
(`PallasQ2PhaseOperator`, `make_q2_operator_auto`).
`Q2StructuredOperator(u)` computes y = A u for a constant 81 x 81 element
matrix over a 3D Q2 node lattice:

* on a CUDA tensor it launches csrc/q2_structured.cu, which works on the
  nodal lattice directly (no phase split): with bf16 input on the tensor
  cores, the element matrix split into two bf16 terms
  (`q2_mma_fragments`), its output bf16 or (the lattice partition's
  slabs) the f32 accumulation; with f32 I/O in f32 FMA; f32 accumulation
  all;
* on a CPU tensor it runs the plain version, `ops/structured.py`'s
  `StructuredOperator`, in f32 (f64 for f64 I/O), rounded to the I/O
  dtype. Called with f64 on the card it raises: K5 has no f64 form.

`q2_lattice_operator` dispatches by degree, dimension and dtype as the JAX
package's `pallas_phase.py:pallas_q2_supported` does: K5 for 3D Q2 in f32
or bf16; other degrees, Q2 in 2D and an f64 fine proxy (an f64 multigrid
hierarchy) take the plain `StructuredOperator` on every device, as the
JAX package computes them with XLA outside any Pallas kernel. That is a
dispatch by dtype, not a fallback: on the CPU both compute the same f64
result bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.dofspace import DofSpace
from .q1_structured import StructuredKernelOperator
from .structured import _grid_shape, structured_operator_from_lattice


# K5's mma tiling: m16n8k16, E^T (K x N = input x output dof) padded to
# 96 x 88: 6 k-steps of 16, 11 n-tiles of 8
Q2_KSTEPS, Q2_NTILES = 6, 11


def q2_split_bf16(E: np.ndarray):
    """(E_hi, E_lo) as f32 arrays of bf16 values: E_hi = bf16(f32(E)), E_lo
    = bf16(f32(E) - E_hi); E - E_hi - E_lo is below 2^-17 |E| elementwise."""
    E32 = torch.as_tensor(np.asarray(E, dtype=np.float32))
    hi = E32.to(torch.bfloat16).float()
    lo = (E32 - hi).to(torch.bfloat16).float()
    return hi.numpy(), lo.numpy()


def q2_mma_fragments(E: np.ndarray) -> np.ndarray:
    """K5's B operand: the bf16 bits of E_hi and E_lo (`q2_split_bf16`) in
    `mma.sync.m16n8k16` B-fragment order, shape (2, 11, 6, 32, 4) uint16
    = (hi/lo, n-tile j, k-step s, lane, element). Lane l = 4 g + t holds
    B[k, n] = E[n, k] for n = 8 j + g and k = 16 s + 2 t + (0, 1, 8, 9);
    rows and columns beyond the 81 element dofs are zero."""
    out = np.zeros((2, Q2_NTILES, Q2_KSTEPS, 32, 4), dtype=np.uint16)
    lane = np.arange(32)
    n = 8 * np.arange(Q2_NTILES)[:, None, None, None] + (lane >> 2)[None, None, :, None]
    k = (16 * np.arange(Q2_KSTEPS)[None, :, None, None]
         + 2 * (lane & 3)[None, None, :, None]
         + np.array([0, 1, 8, 9])[None, None, None, :])
    n, k = np.broadcast_arrays(n, k)
    for h, part in enumerate(q2_split_bf16(E)):
        B = np.zeros((Q2_KSTEPS * 16, Q2_NTILES * 8), dtype=np.float32)
        B[:81, :81] = part.T
        bits = torch.as_tensor(B[k, n]).to(torch.bfloat16).view(torch.int16)
        out[h] = bits.numpy().view(np.uint16)
    return out


class Q2StructuredOperator(StructuredKernelOperator):
    """K5: the 3D Q2 fine-level operator (csrc/q2_structured.cu), f32 and
    bf16 only: an f64 input on the card raises (`q2_lattice_operator`
    gives an f64 fine proxy the plain operator instead, as the JAX
    package's gate does)."""

    p = 2
    dim = 3
    entry = "dat_q2_structured"
    f64_kernel = False
    launches = 0

    def _coefficients(self, E):
        frag = torch.from_numpy(q2_mma_fragments(E).view(np.int16))
        return frag.to(self.device), self.E_dev


class _PlainDegreeOperator:
    """A fine operator without a kernel (2D, degree != 2, or an f64 3D Q2
    proxy, as `pallas_q2_supported` sends those to XLA in the JAX package):
    the plain `StructuredOperator` on every device, computing in the I/O
    dtype as
    the JAX package's `StructuredOperator` does: for a bf16 hierarchy the
    element matrix is held in bf16, the cell products are summed in f32
    and rounded once (`StructuredOperator.__call__`) and the overlap-add
    rounds to bf16 after each slot's add, as XLA computes it on the CPU.
    Computed in f32 and rounded once, the 2D bf16 V-cycle preconditioned
    the Newton CG worse than the JAX package's (39 against 27 CG at the
    63,218-DoF 2D Neo-Hookean step 0 on the CPU)."""

    def __init__(self, E, grid_shape, p, dtype, device):
        self._op = structured_operator_from_lattice(
            np.asarray(E, dtype=np.float64), grid_shape, p, dtype, device
        )
        self.dtype = dtype

    def __call__(self, u: torch.Tensor, out_dtype=None) -> torch.Tensor:
        out_dtype = u.dtype if out_dtype is None else out_dtype
        return self._op(u.to(self.dtype), out_dtype).to(out_dtype)

    def diagonal(self) -> torch.Tensor:
        return self._op.diagonal()


def q2_lattice_operator(E: np.ndarray, grid_shape, p: int,
                        dtype=torch.float32, device=None):
    """MG fine-level operator of a degree-p node lattice (a whole level, or
    one rank's slab of it): `Q2StructuredOperator` (K5) for 3D Q2 in f32 or
    bf16, the plain structured operator otherwise (the JAX package's
    `pallas_q2_supported` gate: f64 is not a K5 dtype)."""
    if p == 2 and len(grid_shape) == 3 and dtype in (torch.float32,
                                                      torch.bfloat16):
        return Q2StructuredOperator(E, grid_shape, dtype, device)
    return _PlainDegreeOperator(E, grid_shape, p, dtype, device)


def make_q2_operator(
    space: DofSpace, E: np.ndarray, dtype=torch.float32, device=None
):
    """MG fine-level operator of a space (`q2_lattice_operator`)."""
    return q2_lattice_operator(E, _grid_shape(space), space.mesh.degree,
                               dtype, device)
