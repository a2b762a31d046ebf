"""Element matrices, assembly helpers and the gather element backend.

Counterpart of `dealii_adapter_tpu/ops/element_ops.py`. Host-side (numpy,
float64), copied unchanged: the exact constant element matrices of a
uniform axis-aligned cell, the assembled diagonal, the dense assembly
(multigrid coarse solve, tests) and the body-force load. On the device:
the consistent interface-traction load of the linear model
(`FaceLoading`) and the operators of `element_backend="gather"`
(`apply_plan`, `AssembledOperator`, `make_operator`): a gather of the
cells' node values, one product with the element matrix, and the
transpose-gather reduction `flat[plan].sum(1)` into the nodes, which is
deterministic and scatter-free. The structured operators live in
ops/structured.py.

Element DoF ordering: (local node, component), component fastest — i.e.
``edof = local_node * dim + comp``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..fem.dofspace import DofSpace, build_transpose_gather_plan


class ElementMatrices:
    """Exact constant element matrices for a uniform axis-aligned cell.

    K_e: linear elastic stiffness with Lame parameters (lmbda, mu)
         (the weak form of `linear_elasticity.cc:299-321`)
    M_e: consistent mass with density rho (`linear_elasticity.cc:338-345`)
    face_mass[axis]: (npf, npf) face mass matrix including the face area
         Jacobian, for faces orthogonal to `axis`
    body_weights: (npc,) integral of each scalar shape function over a cell
    """

    def __init__(self, space: DofSpace, lmbda: float, mu: float, rho: float):
        tab = space.tab
        dim = space.dim
        h = np.asarray(space.mesh.cell_h, dtype=np.float64)
        detJ = float(np.prod(h))
        npc = tab.n_nodes

        # gradients in physical coords: G[q, n, d] = dN[q, n, d] / h[d]
        G = tab.dN / h[None, None, :]
        w = tab.q_weights * detJ

        # K[(i,ci),(j,cj)] = sum_q w [ lmbda G[q,i,ci] G[q,j,cj]
        #                            + mu    G[q,i,cj] G[q,j,ci]
        #                            + delta_{ci,cj} mu G[q,i,:].G[q,j,:] ]
        t1 = lmbda * np.einsum("q,qia,qjb->iajb", w, G, G)
        t2 = mu * np.einsum("q,qib,qja->iajb", w, G, G)
        lap = mu * np.einsum("q,qid,qjd->ij", w, G, G)
        t3 = np.einsum("ij,ab->iajb", lap, np.eye(dim))
        self.K_e = (t1 + t2 + t3).reshape(npc * dim, npc * dim)

        # M[(i,c),(j,c)] = rho sum_q w N_i N_j
        m_scalar = rho * np.einsum("q,qi,qj->ij", w, tab.N, tab.N)
        self.M_e = np.einsum("ij,ab->iajb", m_scalar, np.eye(dim)).reshape(
            npc * dim, npc * dim
        )

        # face mass per axis: restriction of the volume basis to face nodes
        # at face quadrature points equals the (dim-1)-D tensor basis
        self.face_mass = np.zeros((dim, tab.n_nodes_per_face, tab.n_nodes_per_face))
        for axis in range(dim):
            f = 2 * axis  # both sides share the same face mass
            Nf = tab.face_N[f][:, tab.face_nodes[f]]  # (nqf, npf)
            areaJ = detJ / h[axis]
            self.face_mass[axis] = areaJ * np.einsum(
                "q,qi,qj->ij", tab.face_q_weights, Nf, Nf
            )

        self.body_weights = np.einsum("q,qi->i", w, tab.N)  # (npc,)
        self.dim = dim
        self.npc = npc
        self.detJ = detJ


def assemble_diagonal(space: DofSpace, E: np.ndarray) -> np.ndarray:
    """Host-side (n_nodes, dim) diagonal of the assembled global matrix.
    Setup-time only (Jacobi/Chebyshev preconditioners); avoids building
    device gather plans just to extract a diagonal."""
    dim = space.dim
    npc = space.cells.shape[1]
    d = np.diag(E).reshape(npc, dim)
    out = np.zeros((space.n_nodes, dim))
    np.add.at(out, space.cells, d)
    return out


def assemble_dense(space: DofSpace, E: np.ndarray) -> np.ndarray:
    """Host-side dense assembly of a constant element matrix — the global
    (n_dofs, n_dofs) matrix. Used by the Direct solver (the reference's
    UMFPACK path, `linear_elasticity.cc:556-563`) on small problems and by
    tests as ground truth against the matrix-free action."""
    dim = space.dim
    cells = space.cells
    n_cells, npc = cells.shape
    edofs = npc * dim
    gdof = (cells[:, :, None].astype(np.int64) * dim + np.arange(dim)).reshape(
        n_cells, edofs
    )
    A = np.zeros((space.n_dofs, space.n_dofs))
    rows = np.repeat(gdof, edofs, axis=1).ravel()
    cols = np.tile(gdof, (1, edofs)).ravel()
    np.add.at(A, (rows, cols), np.broadcast_to(E.ravel(), (n_cells, edofs * edofs)).ravel())
    return A


def body_force_vector(
    space: DofSpace, elem: ElementMatrices, rho: float, body_force: Tuple[float, ...]
) -> np.ndarray:
    """(n_nodes, dim) consistent body-force load rho*b tested against shape
    functions (`linear_elasticity.cc:357-373`). Host-side, computed once."""
    n_cells, npc = space.cells.shape
    w = np.broadcast_to(elem.body_weights[None, :, None], (n_cells, npc, 1))
    flat = np.concatenate([w.reshape(-1, 1), np.zeros((1, 1))], axis=0)
    nodal_w = flat[space.plan].sum(axis=1)  # (n_nodes, 1)
    bf = np.asarray(body_force[: space.dim], dtype=np.float64)
    return rho * nodal_w * bf[None, :]


def apply_plan(cell_values: torch.Tensor, plan: torch.Tensor) -> torch.Tensor:
    """Transpose-gather reduction: (n_flat, dim) cell-local values ->
    (n_nodes, dim) global nodal sums. `plan` indexes into cell_values with
    one extra zero sentinel row appended here."""
    dim = cell_values.shape[-1]
    flat = torch.cat([cell_values, cell_values.new_zeros((1, dim))])
    return flat[plan].sum(dim=1)


@dataclasses.dataclass(frozen=True)
class AssembledOperator:
    """Matrix-free action of a constant element matrix over all cells
    through the gather plan: K, M and the stepping matrix of the linear
    model, the mass and preconditioner proxies of the Neo-Hookean model
    under `element_backend="gather"`. The per-cell product `ucell @ E` is
    a plain matmul (in f32 a true f32 one: the package turns TF32 off)."""

    cells: torch.Tensor  # (n_cells, npc) int64
    plan: torch.Tensor  # (n_nodes, max_valence)
    E: torch.Tensor  # (edofs, edofs) element matrix (symmetric)
    dim: int

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        n_cells, npc = self.cells.shape
        ucell = u[self.cells].reshape(n_cells, npc * self.dim)
        rcell = ucell @ self.E
        return apply_plan(rcell.reshape(n_cells * npc, self.dim), self.plan)

    def diagonal(self) -> torch.Tensor:
        """(n_nodes, dim) diagonal of the assembled global matrix."""
        n_cells, npc = self.cells.shape
        d = torch.diagonal(self.E).reshape(npc, self.dim)
        dcell = d.expand(n_cells, npc, self.dim)
        return apply_plan(dcell.reshape(n_cells * npc, self.dim), self.plan)


def make_operator(space: DofSpace, E: np.ndarray, dtype=torch.float64,
                  device=None) -> AssembledOperator:
    device = resolve_device(device)
    return AssembledOperator(
        cells=torch.as_tensor(space.cells, dtype=torch.long, device=device),
        plan=torch.as_tensor(space.plan, dtype=torch.long, device=device),
        E=torch.as_tensor(np.asarray(E), dtype=dtype, device=device),
        dim=space.dim,
    )


@dataclasses.dataclass(frozen=True)
class FaceLoading:
    """Consistent surface-traction integration over the coupling interface
    (`assemble_consistent_loading`, `linear_elasticity.cc:457-521`): the
    nodal interface traction, interpolated on each interface face and
    tested against the shape functions, is one face-mass matmul per face,

        r_face = M_face[axis(face)] @ t[face_nodes],

    summed into the interface nodes by a transpose-gather plan (a gather
    and a fixed-order sum: deterministic on every device, no atomics)."""

    face_nodes: torch.Tensor  # (n_if, npf) global node ids
    face_mass: torch.Tensor  # (n_if, npf, npf) per-face mass (by face axis)
    nodes: torch.Tensor  # (n_iface_nodes,) the distinct interface nodes
    plan: torch.Tensor  # (n_iface_nodes, max_valence) into n_if*npf (+ zero row)
    n_nodes: int

    def __call__(self, traction: torch.Tensor) -> torch.Tensor:
        t = traction[self.face_nodes]  # (n_if, npf, dim)
        r = torch.einsum("fij,fjc->fic", self.face_mass, t)
        n_if, npf, dim = t.shape
        flat = torch.cat([r.reshape(n_if * npf, dim), r.new_zeros((1, dim))])
        out = traction.new_zeros((self.n_nodes, dim))
        out[self.nodes] = flat[self.plan].sum(dim=1)
        return out


def make_face_loading(
    space: DofSpace, elem: ElementMatrices, interface_id: int,
    dtype=torch.float64, device=None,
) -> FaceLoading:
    device = resolve_device(device)
    faces, fnodes = space.interface_faces(interface_id)
    face_mass = elem.face_mass[faces[:, 1] // 2]  # (n_if, npf, npf)
    nodes, local = np.unique(fnodes, return_inverse=True)
    plan, _ = build_transpose_gather_plan(local.reshape(fnodes.shape), len(nodes))
    return FaceLoading(
        face_nodes=torch.as_tensor(fnodes, device=device),
        face_mass=torch.as_tensor(face_mass, dtype=dtype, device=device),
        nodes=torch.as_tensor(nodes, device=device),
        plan=torch.as_tensor(plan, device=device),
        n_nodes=space.n_nodes,
    )
