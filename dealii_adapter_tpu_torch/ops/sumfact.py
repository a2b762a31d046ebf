"""Sum-factorized cell operators for tensor-product (Q_p hex) elements.

Counterpart of `dealii_adapter_tpu/ops/sumfact.py`. The displacement
gradient at the cell quadrature points, computed by
`internal_force_cellwise_T` as 9 dense `(q, npc) @ (npc, c)` products
(and 9 more for the adjoint), factorizes because the basis is a tensor
product N = V_z x V_y x V_x (GLL Lagrange x Gauss points):

    t   = V_z u          (interp z)      td  = D_z u
    tV  = V_y t          tD = D_y t      tdV = V_y td
    g_x = D_x tV         g_y = V_x tD    g_z = V_x tdV

and the adjoint (the quadrature-weighted test-function contraction) is
the exact transpose chain, with the 1D Gauss weights absorbed into the
transposed stage matrices. Each stage is one `torch.einsum` of a small
(q1, p1) matrix against one axis of the (z, y, x, cells) patch tensor.
The results agree with the dense tabulation to roundoff (only the
summation order differs).

The Neo-Hookean model uses these in 3D under `use_sumfact` for the f64
internal force and the f64 mass, so the f64 jvp tangent differentiates
through them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..fem.tabulation import gauss_legendre, lagrange_basis
from ..models.material import fsum, kinematics_c
from .structured import (
    _cells_shape,
    _grid_shape,
    extract_cell_patches_T,
    overlap_add_T,
)


@dataclasses.dataclass(frozen=True)
class SumfactBasis:
    """1D stage matrices for sum-factorized cell evaluation (3D).

    V: (q1, p1) 1D shape values at Gauss points; D[e]: (q1, p1) 1D shape
    derivatives scaled by 1/h[e] (physical gradients). Vw/Dw[e]: weighted
    transposes (p1, q1) with the 1D Gauss weights absorbed; the cell
    volume detJ is absorbed into the z-axis transposes once."""

    V: torch.Tensor
    D: Tuple[torch.Tensor, ...]  # per physical axis e = x, y, z
    Vw: torch.Tensor
    Vw_z: torch.Tensor
    Dw: Tuple[torch.Tensor, ...]
    Dw_z: Tuple[torch.Tensor, ...]
    q1: int
    p1: int

    @property
    def n_q(self) -> int:
        return self.q1 ** 3

    @property
    def npc(self) -> int:
        return self.p1 ** 3


def make_sumfact_basis(tab, cell_h, dtype=torch.float64, device=None) -> SumfactBasis:
    """The 1D factors of a 3D `Tabulation` and a uniform cell size, on
    `device` (default: the CUDA card)."""
    assert tab.dim == 3, "sum-factorization path is for the 3D hex elements"
    device = resolve_device(device)
    h = np.asarray(cell_h, dtype=np.float64)
    detJ = float(np.prod(h))
    q1pts, w1 = gauss_legendre(tab.n_q_1d)
    V1, D1 = lagrange_basis(tab.support_1d, q1pts)  # (q1, p1) each
    Vw1 = (V1 * w1[:, None]).T  # (p1, q1)
    Dw1 = [(D1 / h[e] * w1[:, None]).T for e in range(3)]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return SumfactBasis(
        V=t(V1),
        D=tuple(t(D1 / h[e]) for e in range(3)),
        Vw=t(Vw1),
        Vw_z=t(Vw1 * detJ),
        Dw=tuple(t(m) for m in Dw1),
        Dw_z=tuple(t(m * detJ) for m in Dw1),
        q1=tab.n_q_1d,
        p1=tab.degree + 1,
    )


def grad_cellwise(ut: torch.Tensor, sf: SumfactBasis) -> List[List[torch.Tensor]]:
    """(dim, npc, c) cell patches -> grad[d][e] (n_q, c) at the quadrature
    points, by 3 x 8 1D-stage contractions. Local node and q-point order
    is z-major, x fastest (the tabulation's)."""
    dim, _, c = ut.shape
    p1, q1 = sf.p1, sf.q1
    grad: List[List[torch.Tensor]] = []
    for d in range(dim):
        u = ut[d].reshape(p1, p1, p1, c)  # (z, y, x, cells)
        t = torch.einsum("Za,abcn->Zbcn", sf.V, u)
        td = torch.einsum("Za,abcn->Zbcn", sf.D[2], u)
        tV = torch.einsum("Yb,Zbcn->ZYcn", sf.V, t)
        tD = torch.einsum("Yb,Zbcn->ZYcn", sf.D[1], t)
        tdV = torch.einsum("Yb,Zbcn->ZYcn", sf.V, td)
        gx = torch.einsum("Xc,ZYcn->ZYXn", sf.D[0], tV)
        gy = torch.einsum("Xc,ZYcn->ZYXn", sf.V, tD)
        gz = torch.einsum("Xc,ZYcn->ZYXn", sf.V, tdV)
        grad.append([g.reshape(q1 ** 3, c) for g in (gx, gy, gz)])
    return grad


def project_cellwise(P: List[List[torch.Tensor]], sf: SumfactBasis) -> torch.Tensor:
    """The adjoint of `grad_cellwise` with the quadrature weights applied:
    rt[d] (npc, c) = sum_e (weighted gradient test functions) : P[d][e],
    the exact transpose stage chain (weights and detJ live in Vw/Dw)."""
    dim = len(P)
    q1, p1 = sf.q1, sf.p1
    outs = []
    for d in range(dim):
        Px = P[d][0].reshape(q1, q1, q1, -1)
        Py = P[d][1].reshape(q1, q1, q1, -1)
        Pz = P[d][2].reshape(q1, q1, q1, -1)
        # x-stage
        A = torch.einsum("cX,ZYXn->ZYcn", sf.Dw[0], Px)
        B = torch.einsum("cX,ZYXn->ZYcn", sf.Vw, Py)
        C = torch.einsum("cX,ZYXn->ZYcn", sf.Vw, Pz)
        # y-stage (the x and y derivative terms share the rest of the chain)
        AB = torch.einsum("bY,ZYcn->Zbcn", sf.Vw, A) + torch.einsum(
            "bY,ZYcn->Zbcn", sf.Dw[1], B
        )
        C2 = torch.einsum("bY,ZYcn->Zbcn", sf.Vw, C)
        # z-stage
        out = torch.einsum("aZ,Zbcn->abcn", sf.Vw_z, AB) + torch.einsum(
            "aZ,Zbcn->abcn", sf.Dw_z[2], C2
        )
        outs.append(out.reshape(p1 ** 3, -1))
    return torch.stack(outs, dim=0)


def interp_cellwise(ut: torch.Tensor, sf: SumfactBasis) -> torch.Tensor:
    """(dim, npc, c) -> (dim, n_q, c): values at the quadrature points."""
    dim, _, c = ut.shape
    p1, q1 = sf.p1, sf.q1
    u = ut.reshape(dim, p1, p1, p1, c)
    t = torch.einsum("Za,dabcn->dZbcn", sf.V, u)
    t = torch.einsum("Yb,dZbcn->dZYcn", sf.V, t)
    t = torch.einsum("Xc,dZYcn->dZYXn", sf.V, t)
    return t.reshape(dim, q1 ** 3, c)


def interp_adjoint_cellwise(fq: torch.Tensor, sf: SumfactBasis) -> torch.Tensor:
    """(dim, n_q, c) -> (dim, npc, c): the weighted test-function
    contraction (quadrature weights and detJ absorbed)."""
    dim, _, c = fq.shape
    q1, p1 = sf.q1, sf.p1
    f = fq.reshape(dim, q1, q1, q1, c)
    t = torch.einsum("cX,dZYXn->dZYcn", sf.Vw, f)
    t = torch.einsum("bY,dZYcn->dZbcn", sf.Vw, t)
    t = torch.einsum("aZ,dZbcn->dabcn", sf.Vw_z, t)
    return t.reshape(dim, p1 ** 3, c)


def internal_force_cellwise_sumfact(ut, sf: SumfactBasis, material):
    """`models/nonlinear_elasticity.py:internal_force_cellwise_T` on 3D
    structured meshes with sum-factorized contractions: the same (rt,
    min J) contract and physics."""
    dim = ut.shape[0]
    grad = grad_cellwise(ut, sf)
    _, J, F_inv, b_bar = kinematics_c(grad)
    tau = material.tau_c(J, b_bar)
    P = [
        [fsum(tau[d][e] * F_inv[k][e] for e in range(dim)) for k in range(dim)]
        for d in range(dim)
    ]
    return project_cellwise(P, sf), J.min()


@dataclasses.dataclass(frozen=True)
class SumfactMassOperator:
    """The rho-weighted consistent mass action on the structured lattice:
    extract -> 1D interpolation stages -> x (rho w detJ) -> adjoint stages
    -> overlap-add, in place of `StructuredOperator`'s (edofs, edofs)
    element product."""

    sf: SumfactBasis
    rho: float
    p: int
    reps_rev: Tuple[int, ...]
    grid_shape: Tuple[int, ...]
    dim: int = 3

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        dim = self.dim
        ut = extract_cell_patches_T(
            u.reshape(self.grid_shape + (dim,)), self.p, self.reps_rev
        )
        q = interp_cellwise(ut, self.sf)
        rt = interp_adjoint_cellwise(self.rho * q, self.sf)
        return overlap_add_T(rt, self.p, self.reps_rev, self.grid_shape).reshape(
            -1, dim
        )


def make_sumfact_mass_operator(space, rho: float, dtype=torch.float64,
                               device=None) -> SumfactMassOperator:
    sf = make_sumfact_basis(space.tab, space.mesh.cell_h, dtype, device)
    return SumfactMassOperator(
        sf=sf,
        rho=float(rho),
        p=space.mesh.degree,
        reps_rev=_cells_shape(space),
        grid_shape=_grid_shape(space),
        dim=space.dim,
    )
