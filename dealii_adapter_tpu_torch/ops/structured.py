"""Structured-grid element operators: gather-free patch formulation.

Counterpart of `dealii_adapter_tpu/ops/structured.py`. The meshes are
lexicographic tensor grids (mesh/generator.py), so a nodal field
`(n_nodes, dim)` is a dense lattice `(nz, ny, nx, dim)` (x fastest) and
the nodes of the cells are strided windows of that lattice: cell (cz, cy,
cx), local node (c, b, a) is `grid[cz*p + c, cy*p + b, cx*p + a]`.

* Cell access is a strided view (`Tensor.unfold` per axis, step p, window
  p + 1) and one copy into the `(dim, npc, n_cells)` patch layout — no
  index arrays.
* The adjoint, overlap-add, adds each local-node slot into a strided slice
  `out[c::p, b::p, a::p]` of a zeroed lattice, in place.

`StructuredOperator` applies one constant element matrix over all cells:
extract -> one (edofs, edofs) @ (edofs, n_cells) matmul -> overlap-add. It
is also the plain PyTorch version of the hand-written Q1 and Q2 kernels
(ops/q1_structured.py, ops/q2_structured.py).

Any spatial dimension of lattice works (the Neumann pull-back extracts
patches of 2D boundary planes and 1D boundary lines).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..fem.dofspace import DofSpace


def _grid_shape(space: DofSpace) -> Tuple[int, ...]:
    """Nodes per axis, slowest-varying first (z, y, x) for reshaping the
    lexicographic (x fastest) node vector."""
    mesh = space.mesh
    n_ax = [mesh.reps[d] * mesh.degree + 1 for d in range(mesh.dim)]
    return tuple(reversed(n_ax))


def _cells_shape(space: DofSpace) -> Tuple[int, ...]:
    return tuple(reversed(space.mesh.reps))


def extract_cell_patches_T(
    u_grid: torch.Tensor, p: int, reps_rev
) -> torch.Tensor:
    """(..lattice.., dim) -> (dim, npc, n_cells): cell-patch values with the
    cell index trailing. `reps_rev` is cells per lattice axis, slowest
    first; local slots are lexicographic with the last lattice axis
    fastest, matching the tabulation."""
    ndim = len(reps_rev)
    dim = u_grid.shape[-1]
    v = u_grid
    for ax in range(ndim):
        # axis ax -> (cells along ax); window of p + 1 nodes appended last
        v = v.unfold(ax, p + 1, p)
    # v: (nc_0, .., nc_{n-1}, dim, w_0, .., w_{n-1})
    perm = (ndim,) + tuple(range(ndim + 1, 2 * ndim + 1)) + tuple(range(ndim))
    n_cells = int(np.prod(reps_rev))
    return v.permute(perm).reshape(dim, (p + 1) ** ndim, n_cells)


def overlap_add_T(rt: torch.Tensor, p: int, reps_rev, grid_shape) -> torch.Tensor:
    """(dim, npc, n_cells) -> (..lattice.., dim): the exact adjoint of
    `extract_cell_patches_T`, as in-place adds of every local slot into a
    strided slice of a zeroed lattice."""
    dim = rt.shape[0]
    ndim = len(reps_rev)
    out = rt.new_zeros(tuple(grid_shape) + (dim,))
    blocks = rt.reshape((dim,) + (p + 1,) * ndim + tuple(reps_rev))
    for off in itertools.product(range(p + 1), repeat=ndim):
        sl = tuple(
            slice(o, o + (nc - 1) * p + 1, p) for o, nc in zip(off, reps_rev)
        )
        out[sl] += blocks[(slice(None),) + off].movedim(0, -1)
    return out


@dataclasses.dataclass(frozen=True)
class StructuredOperator:
    """y = A u for a constant element matrix over all cells of the lattice.
    `EpT` is the element matrix transposed and permuted to component-major
    dof order (index d * npc + n), so the patch tensor flattens into the
    matmul operand without data movement. Any degree p >= 1."""

    EpT: torch.Tensor  # (edofs, edofs), component-major rows/cols
    dim: int
    p: int
    reps_rev: Tuple[int, ...]
    grid_shape: Tuple[int, ...]

    def __call__(self, u: torch.Tensor, out_dtype=None) -> torch.Tensor:
        """y = A u in u's dtype; `out_dtype` float32 with a bf16 u keeps the
        products' f32 sums and overlap-adds them in f32 (the lattice
        partition's slabs)."""
        dim = self.dim
        edofs = self.EpT.shape[0]
        ut = extract_cell_patches_T(
            u.reshape(self.grid_shape + (dim,)), self.p, self.reps_rev
        )
        _, npc, n_cells = ut.shape
        flat = ut.reshape(edofs, n_cells)
        if flat.dtype == torch.bfloat16:
            # bf16 products summed in f32 and rounded once, as one f32
            # product of the widened operands: the JAX package's bf16 dot
            # as XLA computes it. PyTorch's bf16 product sums in another
            # order, and a sum near a rounding boundary then lands on the
            # next bf16 value (4 to 585 of 28,322 entries of one 2D bf16
            # V-cycle at scale 8 on the CPU differed)
            r = self.EpT.float() @ flat.float()
            if out_dtype != torch.float32:
                r = r.to(torch.bfloat16)
        else:
            r = self.EpT @ flat
        r = r.reshape(dim, npc, n_cells)
        out = overlap_add_T(r, self.p, self.reps_rev, self.grid_shape)
        return out.reshape(-1, dim)

    def diagonal(self) -> torch.Tensor:
        npc = self.EpT.shape[0] // self.dim
        n_cells = int(np.prod(self.reps_rev))
        d = torch.diagonal(self.EpT).reshape(self.dim, npc)
        dcell = d[:, :, None].expand(self.dim, npc, n_cells)
        out = overlap_add_T(dcell, self.p, self.reps_rev, self.grid_shape)
        return out.reshape(-1, self.dim)


def structured_operator_from_lattice(
    E: np.ndarray, grid_shape, p: int, dtype=torch.float64, device=None
) -> StructuredOperator:
    """`StructuredOperator` for a node lattice `grid_shape` (slowest first)
    of degree-p cells, on `device` (default: the CUDA card)."""
    device = resolve_device(device)
    dim = len(grid_shape)
    npc = E.shape[0] // dim
    # node-major (n*dim + d) -> component-major (d*npc + n) permutation
    jidx = np.arange(dim * npc)
    jidx = (jidx % npc) * dim + (jidx // npc)
    Ep = np.asarray(E)[np.ix_(jidx, jidx)]
    return StructuredOperator(
        EpT=torch.as_tensor(Ep.T.copy(), dtype=dtype, device=device),
        dim=dim,
        p=p,
        reps_rev=tuple((n - 1) // p for n in grid_shape),
        grid_shape=tuple(grid_shape),
    )


def make_structured_operator(
    space: DofSpace, E: np.ndarray, dtype=torch.float64, device=None
) -> StructuredOperator:
    return structured_operator_from_lattice(
        E, _grid_shape(space), space.mesh.degree, dtype, device
    )
