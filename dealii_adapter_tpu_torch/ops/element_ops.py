"""Host-side (numpy, float64) element matrices and assembly helpers.

The numpy parts of `dealii_adapter_tpu/ops/element_ops.py` that the
structured production path needs, copied unchanged: the exact constant
element matrices of a uniform axis-aligned cell, the assembled diagonal,
the dense assembly (multigrid coarse solve, tests) and the body-force
load. Device-side operators live in ops/structured.py.

Element DoF ordering: (local node, component), component fastest — i.e.
``edof = local_node * dim + comp``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..fem.dofspace import DofSpace


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
