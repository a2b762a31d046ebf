"""Matrix-free geometric multigrid preconditioner on structured lattices.

Counterpart of `dealii_adapter_tpu/solvers/multigrid.py`:

* level 0: the caller's BC-masked fine operator (the Q2 proxy: kernel K5
  in 3D, the plain structured operator in 2D);
* level 1: Q1 on the same node lattice (FEM-SEM), or at half resolution;
* levels >= 2: aspect-aware semi-coarsened Q1 lattices, down to a dense
  Cholesky coarse solve;
* every Q1 level operator is a hand-written kernel with that level's own
  (anisotropic) element matrix: K3 in 3D and K4b in 2D
  (`ops/q1_structured.py`) under `level_backend` `auto`, `xla` or
  `pallas`, and the assembled stencil K6 (`ops/stencil.py`) under every
  `stencil*` backend; the level diagonal comes from the element matrices'
  diagonals either way;
* transfers: 1D linear interpolation per axis, applied separably;
  restriction is the exact transpose, so the V-cycle stays SPD;
* smoother: Chebyshev on the Jacobi-scaled level operator.

The hierarchy runs in its `dtype` (bf16 on the production path; the
coarse triangular solves stay f32). Each level's lam_max comes from a
12-step power iteration started from a seeded `torch.Generator` vector,
or from the caller (`lam_max=`, one value per level), which is how tests
give it the JAX package's values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..fem.dofspace import DofSpace
from ..mesh.generator import StructuredMesh, subdivided_hyper_rectangle
from ..ops.element_ops import ElementMatrices, assemble_dense, assemble_diagonal
from ..ops.q1_structured import make_q1_operator
from ..ops.stencil import STRATEGIES, make_q1_stencil_operator
from .cg import estimate_lambda_max

# `auto`, `xla` and `pallas` build the Q1 levels on K3 (3D) / K4b (2D);
# every `stencil*` backend on the assembled stencil, K6
LEVEL_BACKENDS = ("auto", "xla", "pallas", "stencil") + tuple(
    "stencil_" + s for s in STRATEGIES
)


def _interp_1d(x_fine: np.ndarray, x_coarse: np.ndarray) -> np.ndarray:
    """(n_fine, n_coarse) linear interpolation matrix: hat functions on the
    coarse 1D grid evaluated at the fine nodes."""
    P = np.zeros((len(x_fine), len(x_coarse)))
    for i, x in enumerate(x_fine):
        j = np.searchsorted(x_coarse, x) - 1
        j = min(max(j, 0), len(x_coarse) - 2)
        t = (x - x_coarse[j]) / (x_coarse[j + 1] - x_coarse[j])
        t = min(max(t, 0.0), 1.0)
        P[i, j] = 1.0 - t
        P[i, j + 1] = t
    return P


def _apply_sep(
    u_grid: torch.Tensor, mats: Sequence[torch.Tensor], minor_first: bool = False
) -> torch.Tensor:
    """Apply one (n_out_ax, n_in_ax) matrix per lattice axis (slowest
    first) to a (..., dim) lattice field. Restriction contracts minor axes
    first (every axis shrinks), prolongation major axes first."""
    ndim = len(mats)
    out = u_grid
    order = reversed(range(ndim)) if minor_first else range(ndim)
    for ax in order:
        out = torch.tensordot(mats[ax], out, dims=([1], [ax])).movedim(0, ax)
    return out


def _boundary_mask(mesh: StructuredMesh, tags: dict) -> np.ndarray:
    """(n_nodes, dim) Dirichlet mask of a level mesh from the raw colorize
    face ids the scenario recorded (`clamped_raw_ids` / `oop_raw_ids`)."""
    space = DofSpace.create(mesh)
    mask = np.ones((space.n_nodes, mesh.dim))
    clamped_ids = tags.get("clamped_raw_ids", [tags.get("clamped")])
    matched = False
    for bid in clamped_ids:
        if bid in space.boundary_nodes:
            mask[space.boundary_nodes[bid], :] = 0.0
            matched = True
    if not matched:
        raise ValueError(
            f"MG level mask: none of the clamped boundary ids {clamped_ids} "
            f"match a boundary set on the level mesh (available: "
            f"{sorted(space.boundary_nodes)}). Pass 'clamped_raw_ids' (raw "
            f"colorize face ids, as recorded by make_scenario_grid) in the "
            f"tags dict when using preconditioner='MG' with a custom mesh."
        )
    if mesh.dim == 3:
        for bid in tags.get("oop_raw_ids", []):
            if bid in space.boundary_nodes:
                mask[space.boundary_nodes[bid], 2] = 0.0
    return mask


@dataclasses.dataclass
class _LevelGeom:
    """dt-independent host-side geometry of one coarse level: mesh, DoF
    space, mask, unit-mu stiffness and unit-rho mass element matrices,
    their diagonals, 1D transfers from the previous (finer) level and, on
    the coarsest level, the dense K/M."""

    m_c: StructuredMesh
    space_c: DofSpace
    mask_c: np.ndarray
    K_e_unit: np.ndarray
    M_e_unit: np.ndarray
    diag_K: np.ndarray
    diag_M: np.ndarray
    P_1d: Tuple[np.ndarray, ...]
    shape_c: Tuple[int, ...]
    K_dense: Optional[np.ndarray] = None
    M_dense: Optional[np.ndarray] = None


def _geometry_skeleton(
    mesh: StructuredMesh, tags: dict, coarse_size: int, fem_sem: bool,
    lmbda: float, mu: float,
) -> List[_LevelGeom]:
    """Coarse-level geometry, cached on the fine mesh object (keyed by the
    ratio lmbda/mu, the coarse size, FEM-SEM and the Dirichlet ids)."""
    if mu <= 0.0:
        raise ValueError(f"multigrid requires a positive shear modulus, got mu={mu}")
    key = (
        coarse_size,
        fem_sem,
        float(lmbda / mu),
        tuple(sorted(tags.get("clamped_raw_ids", [tags.get("clamped")]))),
        tuple(sorted(tags.get("oop_raw_ids", []))),
    )
    cache = mesh.__dict__.setdefault("_mg_geom_cache", {})
    if key in cache:
        return cache[key]

    dim = mesh.dim
    meshes = []
    reps = mesh.reps
    if mesh.degree > 1:
        if fem_sem:
            # FEM-SEM: Q1 on a lattice with the same node count as Q_p
            reps = tuple(r * mesh.degree for r in reps)
        else:
            # combined p+h coarsening: Q1 at half the fine resolution
            reps = tuple(max(1, (r * mesh.degree + 1) // 2) for r in reps)
        meshes.append(subdivided_hyper_rectangle(reps, mesh.p0, mesh.p1, 1))
        if meshes[-1].n_nodes * dim <= coarse_size:
            reps = None
    extent = np.array(mesh.p1, dtype=float) - np.array(mesh.p0, dtype=float)
    while reps is not None and any(r > 1 for r in reps):
        # semi-coarsening: halve only the axes whose spacing is close to
        # the finest, so a point smoother keeps damping
        h = extent / np.array(reps, dtype=float)
        hmin = min(h_d for h_d, r in zip(h, reps) if r > 1)
        new_reps = tuple(
            max(1, (r + 1) // 2) if (r > 1 and h_d <= 1.9 * hmin) else r
            for r, h_d in zip(reps, h)
        )
        if new_reps == reps:
            new_reps = tuple(max(1, (r + 1) // 2) for r in reps)
        reps = new_reps
        meshes.append(subdivided_hyper_rectangle(reps, mesh.p0, mesh.p1, 1))
        if meshes[-1].n_nodes * dim <= coarse_size:
            break

    geoms: List[_LevelGeom] = []
    prev_mesh = mesh
    for li, m_c in enumerate(meshes):
        space_c = DofSpace.create(m_c)
        elem = ElementMatrices(space_c, lmbda / mu, 1.0, 1.0)
        mask_c = _boundary_mask(m_c, tags)
        P_1d = tuple(
            _interp_1d(prev_mesh.axis_coords[d], m_c.axis_coords[d])
            for d in reversed(range(dim))
        )
        shape_c = tuple(reversed([m_c.reps[d] + 1 for d in range(dim)]))
        is_last = li == len(meshes) - 1
        K_dense = M_dense = None
        if is_last and space_c.n_nodes * dim <= 32768:
            K_dense = assemble_dense(space_c, elem.K_e)
            M_dense = assemble_dense(space_c, elem.M_e)
        geoms.append(
            _LevelGeom(
                m_c=m_c, space_c=space_c, mask_c=mask_c,
                K_e_unit=elem.K_e, M_e_unit=elem.M_e,
                diag_K=np.asarray(assemble_diagonal(space_c, elem.K_e)),
                diag_M=np.asarray(assemble_diagonal(space_c, elem.M_e)),
                P_1d=P_1d, shape_c=shape_c, K_dense=K_dense, M_dense=M_dense,
            )
        )
        prev_mesh = m_c
    cache[key] = geoms
    return geoms


@dataclasses.dataclass
class MGLevel:
    operator: Callable  # masked SPD action on (n_nodes, dim)
    diag: torch.Tensor  # masked diagonal (1 on constrained)
    mask: torch.Tensor
    grid_shape: Tuple[int, ...]  # node lattice, slowest first
    lam_max: float  # upper bound of the diag^-1 A spectrum
    P_1d: Optional[Tuple[torch.Tensor, ...]] = None  # fine <- coarse per axis
    R_1d: Optional[Tuple[torch.Tensor, ...]] = None  # transposes
    coarse_solve: Optional[Callable] = None  # coarsest level only


def _coef(c: float, dtype) -> float:
    """A Python scalar rounded to `dtype`, as JAX rounds a weakly typed
    scalar to the array's dtype. PyTorch keeps the scalar of a bf16 op in
    f32; for f32 and f64 tensors it rounds it the same way."""
    return torch.tensor(c, dtype=dtype).item()


def _chebyshev_smooth(level: MGLevel, b, x, degree: int, x_is_zero=False,
                      out_dtype=None):
    """`degree` Chebyshev iterations on [lam_max/4, 1.05 lam_max] of the
    Jacobi-scaled level operator. `x_is_zero` skips the initial residual
    apply. Each operation rounds to the hierarchy dtype, and so do the
    polynomial's coefficients (`_coef`), as in the JAX package's smoother
    run by XLA on the CPU; in f32 and f64 this is PyTorch's own
    arithmetic. `out_dtype` computes the closing update `x + d` in that
    dtype instead (see `GeometricMultigrid.__call__`)."""
    dt = b.dtype
    inv = 1.0 / level.diag
    lmax = level.lam_max * 1.05
    lmin = level.lam_max / 4.0
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    resid = b if x_is_zero else b - level.operator(x)
    d = _coef(1.0 / theta, dt) * (inv * resid)
    sigma = theta / delta
    rho = 1.0 / sigma
    for _ in range(degree):
        x = x + d
        resid = resid - level.operator(d)
        rho_next = 1.0 / (2.0 * sigma - rho)
        d = (_coef(rho_next * rho, dt) * d
             + _coef(2.0 * rho_next / delta, dt) * (inv * resid))
        rho = rho_next
    if out_dtype is not None:
        return x.to(out_dtype) + d.to(out_dtype)
    return x + d


def _masked(op, mk):
    def apply(v):
        return mk * op(mk * v) + (1.0 - mk) * v

    return apply


class GeometricMultigrid:
    """Symmetric V-cycle preconditioner; `__call__(r)` is one V-cycle,
    usable as the `cg_solve` preconditioner."""

    def __init__(
        self,
        mesh: StructuredMesh,
        tags: dict,
        fine_operator: Callable,
        fine_diag: torch.Tensor,
        fine_mask: torch.Tensor,
        lmbda: float,
        mu: float,
        mass_coeff: float = 0.0,
        smooth_degree: int = 2,
        smooth_degree_fine: int = 0,
        coarse_size: int = 4000,
        dtype=torch.float64,
        fem_sem: bool = True,
        skip_fine_smoothing: bool = False,
        level_backend: str = "auto",
        lam_max: Optional[Sequence[float]] = None,
        device=None,
    ):
        """`fine_operator` must already be BC-masked; `mass_coeff` is the
        rho-scaled mass coefficient of the operator (alpha_1 rho for
        Newmark). `lam_max`, when given, holds one value per level (fine
        first) and replaces the power iterations."""
        if level_backend not in LEVEL_BACKENDS:
            raise ValueError(
                f"unknown mg_level_backend {level_backend!r}; expected one of "
                f"{LEVEL_BACKENDS}"
            )
        device = resolve_device(device)
        self.dtype = dtype
        self.smooth_degree = smooth_degree
        self.smooth_degree_fine = smooth_degree_fine or smooth_degree
        self.skip_fine_smoothing = skip_fine_smoothing and fem_sem and (
            mesh.degree > 1
        )
        dim = mesh.dim
        self.dim = dim
        lam_given = list(lam_max) if lam_max is not None else None

        def lam_est(li, op, diag, shape):
            if lam_given is not None:
                return float(lam_given[li])
            return estimate_lambda_max(op, diag, shape)

        fine_shape = tuple(
            reversed([mesh.reps[d] * mesh.degree + 1 for d in range(dim)])
        )
        levels: List[MGLevel] = [
            MGLevel(
                operator=fine_operator,
                diag=fine_diag,
                mask=fine_mask,
                grid_shape=fine_shape,
                lam_max=lam_est(
                    0, fine_operator, fine_diag, (int(np.prod(fine_shape)), dim)
                ),
            )
        ]
        geoms = _geometry_skeleton(mesh, tags, coarse_size, fem_sem, lmbda, mu)
        for li, gm in enumerate(geoms):
            space_c = gm.space_c
            E_c = mu * gm.K_e_unit + mass_coeff * gm.M_e_unit
            mask_c = torch.as_tensor(gm.mask_c, dtype=dtype, device=device)
            if level_backend.startswith("stencil"):
                op_raw = make_q1_stencil_operator(
                    space_c, E_c, dtype,
                    strategy=level_backend[len("stencil_"):] or "shift",
                    device=device,
                )
            else:
                op_raw = make_q1_operator(space_c, E_c, dtype, device)
            op_c = _masked(op_raw, mask_c)
            diag_c = mask_c * torch.as_tensor(
                mu * gm.diag_K + mass_coeff * gm.diag_M, dtype=dtype, device=device
            ) + (1.0 - mask_c)
            P_1d = tuple(
                torch.as_tensor(P, dtype=dtype, device=device) for P in gm.P_1d
            )
            levels[-1].P_1d = P_1d
            levels[-1].R_1d = tuple(P.T.contiguous() for P in P_1d)

            coarse_solve = None
            if li == len(geoms) - 1:
                n_unknowns = space_c.n_nodes * dim
                if gm.K_dense is None:
                    raise ValueError(
                        f"MG coarse level has {n_unknowns} unknowns; the "
                        f"dense Cholesky coarse solve is capped at 32768. "
                        f"Lower mg_coarse_size (got coarse_size={coarse_size})."
                    )
                A_dense = mu * gm.K_dense + mass_coeff * gm.M_dense
                flat_mask = np.asarray(gm.mask_c, dtype=np.float64).reshape(-1)
                A_dense = A_dense * flat_mask[:, None] * flat_mask[None, :]
                np.fill_diagonal(A_dense, np.diag(A_dense) + (1.0 - flat_mask))
                L = np.linalg.cholesky(A_dense)
                # triangular substitutions stay f32 under a bf16 hierarchy
                cdt = torch.float32 if dtype == torch.bfloat16 else dtype
                L_d = torch.as_tensor(L, dtype=cdt, device=device)
                LT_d = torch.as_tensor(L.T.copy(), dtype=cdt, device=device)

                def coarse_solve(b, L_d=L_d, LT_d=LT_d, n=space_c.n_nodes):
                    y = torch.linalg.solve_triangular(
                        L_d, b.reshape(-1, 1).to(L_d.dtype), upper=False
                    )
                    z = torch.linalg.solve_triangular(LT_d, y, upper=True)
                    return z.to(b.dtype).reshape(n, dim)

            levels.append(
                MGLevel(
                    operator=op_c,
                    diag=diag_c,
                    mask=mask_c,
                    grid_shape=gm.shape_c,
                    lam_max=lam_est(li + 1, op_c, diag_c, (space_c.n_nodes, dim)),
                    coarse_solve=coarse_solve,
                )
            )
        self.levels = levels

    def _restrict(self, li: int, r):
        lv = self.levels[li]
        rc = _apply_sep(r.reshape(lv.grid_shape + (self.dim,)), lv.R_1d,
                        minor_first=True)
        return self.levels[li + 1].mask * rc.reshape(-1, self.dim)

    def _prolong(self, li: int, ec):
        lv = self.levels[li]
        ec_grid = ec.reshape(self.levels[li + 1].grid_shape + (self.dim,))
        ef = _apply_sep(ec_grid, lv.P_1d)
        return lv.mask * ef.reshape(-1, self.dim)

    def _vcycle(self, li: int, b, out_dtype=None):
        lv = self.levels[li]
        if li == 0 and self.skip_fine_smoothing:
            return self._prolong(0, self._vcycle(1, self._restrict(0, b)))
        if lv.coarse_solve is not None:
            return lv.coarse_solve(b)
        if li == len(self.levels) - 1:  # coarsest without factorization
            return _chebyshev_smooth(
                lv, b, torch.zeros_like(b), self.smooth_degree * 2,
                x_is_zero=True, out_dtype=out_dtype,
            )
        deg = self.smooth_degree_fine if li == 0 else self.smooth_degree
        x = _chebyshev_smooth(lv, b, torch.zeros_like(b), deg, x_is_zero=True)
        r = b - lv.operator(x)
        ec = self._vcycle(li + 1, self._restrict(li, r))
        x = x + self._prolong(li, ec)
        return _chebyshev_smooth(lv, b, x, deg, out_dtype=out_dtype)

    def __call__(self, r):
        """One symmetric V-cycle in the hierarchy dtype; output in r's
        dtype. A bf16 hierarchy called with an f32 r computes the fine
        post-smoother's closing `x + d` in f32 instead of rounding it to
        bf16, as XLA does in the JAX package's jitted V-cycle on the CPU:
        there the bf16 arithmetic runs in f32 with every line rounded back
        to bf16, except this last one, whose bf16 -> f32 convert pair at the
        program's output XLA removes (`--xla_allow_excess_precision`; with
        an f64 output the rounding stays). Rounded, the bf16 V-cycle
        preconditioned the CG measurably worse than the JAX package's
        (1.68x its CG at the 250,850-DoF 2D Neo-Hookean step 0)."""
        wide = self.dtype == torch.bfloat16 and r.dtype == torch.float32
        z = self._vcycle(0, r.to(self.dtype), out_dtype=r.dtype if wide else None)
        return z.to(r.dtype)
