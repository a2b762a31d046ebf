"""Finite-strain compressible Neo-Hookean dynamics: Newmark-beta + Newton.

Counterpart of `dealii_adapter_tpu/models/nonlinear_elasticity.py`,
restricted to its single-device structured production path. Per time
step Newton solves

    R(delta) = F_ext(u) + F_body - F_int(u) - M a(delta) = 0,   u = u_n + delta

with the Newmark acceleration a = alpha_1 delta - alpha_2 v_n - alpha_3 a_n
and the dual relative/absolute convergence rule of the reference. Each
Newton iteration assembles the per-cell tangents in the solve dtype (f32
on the production path), lays them out for the selected matvec kernel,
and runs a CG whose matvec is extract -> tangent kernel -> overlap-add,
preconditioned by the geometric-multigrid V-cycle (kernels K5 and K3 in
3D, K4b in 2D; K6 on the Q1 levels under a `stencil*`
`mg_level_backend`) or Jacobi/Chebyshev. The tangent kernel follows
`tangent_block_symmetric` and `tangent_matvec_kernel` as the JAX package
picks its Pallas kernel (`tangent_kernel_id`): full storage runs K1 (the
column-major pack; `auto`, `packedt`, `xla`), K1b (`packed`) or K1c
(`blocks`); block-symmetric storage, the upper component blocks only,
runs K2 (`auto`, `packed`, `packedt` with a warning, `xla`) or K2b
(`blocks`). `xla` names a library-form matvec that the port does not
have, so it takes the `auto` kernel.

The CG runs as `cg_loop` says: "graphs" (the default) runs
`solvers/cg.py:ChunkedCG`, fixed-length chunks of guarded CG iterations
captured once per model in CUDA graphs on the card (tangent kernel, the
whole V-cycle, dots; run eagerly on the CPU) with one read-back per
chunk; "host" the host-loop `cg_solve`, one read-back per iteration.
Both give the same bits. The assembly writes the tangent into one
persistent buffer per model (the layouts' `out=`), so the captured matvec
reads each Newton iteration's tangent at the same address.

Differences from the JAX package, all in the host orchestration:
* Newton is a host loop (`lax.while_loop` in JAX): every Newton
  decision reads its scalars back from the device, one sync each, counted
  in `host_syncs` with the CG's read-backs;
* a NaN f32 residual never becomes the noise floor: a non-finite
  calibration leaves the floor uncalibrated (f64 continues), and the
  stall-redo re-calibration keeps the last finite floor (the JAX package
  lets the floor become NaN);
* the f64 inner solve (solve_dtype == dtype) and the Direct solver use the
  assembled tangent too (JAX linearizes the residual with jvp); both are
  the same linearization up to roundoff.

Unported variants raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AllParameters
from ..device import resolve_device
from ..fem.dofspace import DofSpace
from ..mesh.generator import StructuredMesh, make_scenario_grid
from ..ops.assembled_tangent import (
    apply_block_tangents,
    apply_packed_tangents,
    apply_packed_tangents_sym,
    apply_packed_tangents_T,
    apply_sym_block_tangents,
    assemble_cell_tangents,
    assemble_cell_tangents_sym,
    contraction_basis,
    pack_cell_tangents,
    pack_cell_tangents_sym,
    pack_cell_tangents_T,
    tangent_bytes,
)
from ..ops.element_ops import ElementMatrices, assemble_diagonal, body_force_vector
from ..ops.q2_structured import make_q2_operator
from ..ops.structured import (
    _cells_shape,
    _grid_shape,
    extract_cell_patches_T,
    make_structured_operator,
    overlap_add_T,
)
from ..solvers.cg import (
    CG_CHUNK,
    CG_LOOPS,
    chebyshev_preconditioner,
    estimate_lambda_max,
    jacobi_preconditioner,
    make_cg,
)
from .material import NeoHookean, det_and_inv_c, kinematics_c

DIRECT_MAX_UNKNOWNS = 16384  # dense Direct tangent cap (as in the JAX package)


def internal_force_cellwise_T(ut, G, w, material):
    """(dim, npc, c) cell-patch displacements -> ((dim, npc, c) per-cell
    internal-force contributions, min det F): gradients by (q, npc) @
    (npc, c) matmuls, pointwise Kirchhoff stress, and the weighted test
    contraction, with tensor components as separate (q, c) tensors."""
    dim = ut.shape[0]
    grad = [[G[:, :, e] @ ut[d] for e in range(dim)] for d in range(dim)]
    _, J, F_inv, b_bar = kinematics_c(grad)
    tau = material.tau_c(J, b_bar)
    # P[d][k] = (tau F^{-T})[d][k] = sum_e tau[d][e] F_inv[k][e]
    P = [
        [sum(tau[d][e] * F_inv[k][e] for e in range(dim)) for k in range(dim)]
        for d in range(dim)
    ]
    GwT = [(G[:, :, k] * w[:, None]).T for k in range(dim)]
    rt = torch.stack(
        [sum(GwT[k] @ P[d][k] for k in range(dim)) for d in range(dim)], dim=0
    )
    return rt, J.min()


class NonlinearState(NamedTuple):
    """Converged fields at t_n (total displacement, velocity, acceleration),
    each an (n_nodes, dim) tensor."""

    displacement: torch.Tensor
    velocity: torch.Tensor
    acceleration: torch.Tensor


class NewtonInfo(NamedTuple):
    converged: bool
    iterations: int  # Newton iterations taken
    residual_abs: float
    residual_rel: float
    update_abs: float
    update_rel: float
    cg_iterations: int  # total CG iterations across Newton steps
    min_det_F: float
    f64_evals: int = 0  # residual evaluations paid per precision
    f32_evals: int = 0
    tangent_assemblies: int = 0


def _fmax(a: float, b: float) -> float:
    """max that propagates NaN (jnp.maximum)."""
    return math.nan if (math.isnan(a) or math.isnan(b)) else max(a, b)


def _fmin(a: float, b: float) -> float:
    return math.nan if (math.isnan(a) or math.isnan(b)) else min(a, b)


def _div(a: float, b: float) -> float:
    """IEEE division (x/0 = +-inf, 0/0 = nan) of host scalars."""
    return float(np.float64(a) / np.float64(b)) if b == 0.0 else a / b


def _clip(x: float, lo: float, hi: float) -> float:
    return x if math.isnan(x) else min(max(x, lo), hi)


class NonlinearElasticity:
    """Builds mesh, space, operators and preconditioner once on `device`
    (default: the CUDA card); `step(state, stress) -> (state,
    NewtonInfo)`; `residual` and `_residual32` are exposed for tests.
    `cg_loop` ("graphs", the default, or "host") chooses the Krylov loop
    (module docstring); it exists so that both loops can be measured side
    by side, and the model never switches between them itself. `cg_chunk`
    (default `CG_CHUNK`) sets the graphs' chunk length; it exists for
    `tools/cg_chunk_sweep.py`, which measures the lengths on this model."""

    def __init__(
        self,
        params: AllParameters,
        mesh: Optional[StructuredMesh] = None,
        tags: Optional[dict] = None,
        refine: int = 0,
        quasi_static: bool = False,
        device=None,
        mg_lam_max: Optional[Sequence[float]] = None,
        cg_loop: str = "graphs",
        cg_chunk: int = CG_CHUNK,
    ):
        """`mg_lam_max` (one value per MG level, fine first) replaces the
        hierarchy's power-iteration estimates."""
        if not params.data_consistent:
            raise ValueError(
                "The neo-Hookean solid doesn't support 'Force' data reading. "
                "Please switch to 'Stress' data or use the linear model."
            )
        _check_ported(params)
        self.params = params
        self.quasi_static = quasi_static
        self.device = resolve_device(device)
        self.cg_loop = cg_loop
        if cg_loop not in CG_LOOPS:
            raise ValueError(
                f"unknown cg_loop {cg_loop!r}; expected one of {CG_LOOPS}")
        self.cg_chunk = int(cg_chunk)
        dim = params.dim
        if mesh is None:
            mesh, tags = make_scenario_grid(
                params.scenario, dim, params.poly_degree,
                flap_location=params.flap_location, refine=refine,
                solver="neo-Hookean",
            )
        assert tags is not None
        self.mesh = mesh
        self.tags = tags
        self.interface_id = tags["interface"]
        # quadrature degree + 2 per the reference
        self.space = DofSpace.create(mesh, n_q_1d=params.poly_degree + 2)
        if params.type_lin == "Direct" and self.space.n_dofs > DIRECT_MAX_UNKNOWNS:
            raise NotImplementedError(
                f"type_lin='Direct' materializes the dense "
                f"({self.space.n_dofs})^2 tangent; capped at "
                f"{DIRECT_MAX_UNKNOWNS} unknowns (a sparse direct solver is "
                "not ported, ROADMAP Queue 1 item 13)"
            )
        self.dtype = torch.float64 if params.dtype == "float64" else torch.float32
        self.material = NeoHookean(params.mu, params.nu, params.rho)

        # Newmark coefficients
        dt, beta, gamma = params.delta_t, params.beta, params.gamma
        self.alpha_1 = 1.0 / (beta * dt * dt)
        self.alpha_2 = 1.0 / (beta * dt)
        self.alpha_3 = (1.0 - 2.0 * beta) / (2.0 * beta)
        self.alpha_4 = gamma / (beta * dt)
        self.alpha_5 = 1.0 - gamma / beta
        self.alpha_6 = (1.0 - gamma / (2.0 * beta)) * dt
        self.host_syncs = 0
        self._tangent = None  # (persistent tangent, CG solve), at first use
        self._setup_constants(mg_lam_max)

    # ------------------------------------------------------------------

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(
            np.asarray(x), dtype=dtype or self.dtype, device=self.device
        )

    def _setup_constants(self, mg_lam_max):
        params = self.params
        space, tab = self.space, self.space.tab
        dim = space.dim
        h = np.asarray(self.mesh.cell_h)
        detJ = float(np.prod(h))
        dt = self.dtype
        self._grid_shape = _grid_shape(space)
        self._reps_rev = _cells_shape(space)

        self.G = self._tensor(tab.dN / h[None, None, :])  # (q, npc, dim)
        self.w = self._tensor(tab.q_weights * detJ)  # (q,)
        elem = ElementMatrices(space, 0.0, 0.0, params.rho)
        self.M = make_structured_operator(space, elem.M_e, dt, self.device)

        bf = body_force_vector(space, elem, params.rho, params.body_force)
        self.body_force_enabled = bool(np.linalg.norm(params.body_force) > 1e-15)
        self._body_vec = self._tensor(bf)

        # structured Neumann pull-back: every interface side must cover a
        # complete lattice side (true for the scenario meshes)
        faces, _ = space.interface_faces(self.interface_id)
        lf_np = np.asarray(faces[:, 1])
        sides = []
        for f in sorted(set(lf_np.tolist())):
            axis, side01 = f // 2, f % 2
            n_side = int(
                np.prod([r for a2, r in enumerate(self.mesh.reps) if a2 != axis])
            )
            if int((lf_np == f).sum()) != n_side:
                raise NotImplementedError(
                    "interface faces that do not cover complete lattice sides "
                    "need the gather Neumann path, which is not ported "
                    "(ROADMAP Queue 1 item 13)"
                )
            sides.append(
                dict(
                    ga=dim - 1 - axis,  # lattice axes are reversed
                    side=side01,
                    Gf=self._tensor(tab.face_dN[f] / h[None, None, :]),
                    Nf=self._tensor(tab.face_N[f][:, tab.face_nodes[f]]),
                    wf=self._tensor(tab.face_q_weights * (detJ / h[axis])),
                    normal=tuple(float(x) for x in tab.face_normal_ref[f]),
                )
            )
        self._neumann_sides = sides

        self.mask = self._tensor(
            space.dirichlet_mask(self.tags["clamped"], self.tags.get("out_of_plane"))
        )

        # inner-solve dtype: f32 copies of the operator constants (inexact
        # Newton; residual, norms and state stay in `dtype`)
        tdt = torch.float32 if params.solve_dtype == "float32" else dt
        self.solve_dtype = tdt
        self._mixed_tangent = tdt != dt
        self._G_t, self._w_t = self.G.to(tdt), self.w.to(tdt)
        self.mask_t = self.mask.to(tdt)
        self.M_t = (make_structured_operator(space, elem.M_e, tdt, self.device)
                    if self._mixed_tangent else None)
        if self.device.type == "cuda" and tdt != torch.float32:
            raise NotImplementedError(
                "an f64 inner solve (solve_dtype == dtype, the reference's "
                "default) runs the jvp tangent in the JAX package, which is "
                "not ported (ROADMAP Queue 1 item 12); the tangent matvec "
                "kernels (K1, K1b, K1c, K2, K2b) are f32: set "
                "solve_dtype='float32' on CUDA"
            )

        # assembled per-cell tangent in the solve dtype, in the layout of
        # the selected matvec kernel
        self._use_assembled = params.type_lin == "CG"
        self.tangent_kernel = tangent_kernel_id(params)
        if self._use_assembled:
            kb = tangent_bytes(space, tdt, sym=params.tangent_block_symmetric)
            if kb > params.assembled_tangent_max_gb * 1e9:
                raise NotImplementedError(
                    f"the per-cell tangents need {kb / 1e9:.1f} GB (> "
                    f"assembled_tangent_max_gb={params.assembled_tangent_max_gb});"
                    " the jvp tangent that JAX falls back to is not ported "
                    "(ROADMAP Queue 1 item 12)"
                )
        npc = tab.n_nodes
        a1 = 0.0 if self.quasi_static else self.alpha_1
        self._m_scalar = np.asarray(elem.M_e).reshape(npc, dim, npc, dim)[:, 0, :, 0]
        self._tangent_mass = (
            self._tensor(a1 * self._m_scalar, tdt) if a1 != 0.0 else None
        )
        self._S_t = contraction_basis(self._G_t, self._w_t)

        # Jacobi diagonal from the small-strain linearization at F = I plus
        # the Newmark mass term
        lam_eff = self.material.kappa - 2.0 * params.mu / dim
        elemK = ElementMatrices(space, lam_eff, params.mu, params.rho)
        Ke_precond = elemK.K_e + a1 * elem.M_e
        diag = self.mask * self._tensor(assemble_diagonal(space, Ke_precond)) + (
            1.0 - self.mask
        )
        sdt = tdt
        if params.preconditioner == "Chebyshev":
            proxy = make_structured_operator(space, Ke_precond, sdt, self.device)
            mask_s = self.mask.to(sdt)
            diag_s = diag.to(sdt)

            def proxy_bc(v):
                return mask_s * proxy(mask_s * v) + (1.0 - mask_s) * v

            lam = estimate_lambda_max(proxy_bc, diag_s, (space.n_nodes, dim))
            self._precond = chebyshev_preconditioner(
                proxy_bc, diag_s, lam,
                degree=params.cheb_degree, eig_ratio=params.cheb_eig_ratio,
            )
        elif params.preconditioner == "MG":
            from ..solvers.multigrid import GeometricMultigrid

            pdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
                params.precond_dtype, sdt
            )
            # the MG fine proxy: kernel K5 for 3D Q2
            proxy = make_q2_operator(space, Ke_precond, pdt, self.device)
            fmask = self.mask.to(pdt)

            def proxy_bc(v):
                return fmask * proxy(fmask * v) + (1.0 - fmask) * v

            self._precond = GeometricMultigrid(
                self.mesh, self.tags, proxy_bc, diag.to(pdt), fmask,
                lmbda=lam_eff, mu=params.mu, mass_coeff=a1 * params.rho,
                dtype=pdt, smooth_degree=params.mg_smooth_degree,
                smooth_degree_fine=params.mg_fine_smooth_degree,
                coarse_size=params.mg_coarse_size, fem_sem=params.mg_fem_sem,
                skip_fine_smoothing=params.mg_skip_fine_smoothing,
                level_backend=params.mg_level_backend, lam_max=mg_lam_max,
                device=self.device,
            )
        elif params.preconditioner == "None":
            self._precond = None
        else:
            self._precond = jacobi_preconditioner(diag.to(sdt))
        self._max_cg_iter = int(space.n_dofs * params.max_iterations_lin)

    # ------------------------------------------------------------------
    # tangent (assembled; kernels K1, K1b, K1c, K2, K2b)
    # ------------------------------------------------------------------

    def _make_tangent_fns(self):
        """`(assemble_Kt, make_tangent_matvec)`: `assemble_Kt(u_t, out)`
        assembles the per-cell tangents at the solve-dtype iterate in the
        layout `self.tangent_kernel` consumes (the column-major pack KT,
        the row-major pack K, the nested blocks, the symmetric pack or the
        upper blocks), into `out` (an earlier result) if given;
        `make_tangent_matvec(Kt)` is the BC-masked CG operator extract ->
        that kernel -> overlap-add."""
        dim = self.space.dim
        deg = self.mesh.degree
        gs, rr = self._grid_shape, self._reps_rev
        npc = self.space.tab.n_nodes
        mask_t = self.mask_t
        kern = self.tangent_kernel
        sym = kern in ("K2", "K2b")
        assemble = assemble_cell_tangents_sym if sym else assemble_cell_tangents
        # K1c and K2b read the blocks as the assembly returns them
        layout = {
            "K1": pack_cell_tangents_T, "K1b": pack_cell_tangents,
            "K2": pack_cell_tangents_sym,
        }.get(kern)
        apply = {
            "K1": apply_packed_tangents_T, "K1b": apply_packed_tangents,
            "K1c": apply_block_tangents,
            "K2": lambda Kt, u2: apply_packed_tangents_sym(Kt, u2, dim, npc),
            "K2b": lambda Kt, u2: apply_sym_block_tangents(Kt, u2, dim, npc),
        }[kern]

        def assemble_Kt(u_t, out=None):
            ut_p = extract_cell_patches_T(u_t.reshape(gs + (dim,)), deg, rr)
            if layout is None:
                return assemble(
                    ut_p, self._G_t, self._w_t, self.material,
                    mass_term=self._tangent_mass, S=self._S_t, out=out,
                )
            return layout(assemble(
                ut_p, self._G_t, self._w_t, self.material,
                mass_term=self._tangent_mass, S=self._S_t,
            ), out=out)

        def make_tangent_matvec(Kt):
            def K32(v):
                mv = mask_t * v
                pv = extract_cell_patches_T(mv.reshape(gs + (dim,)), deg, rr)
                c = pv.shape[-1]
                o = apply(Kt, pv.reshape(dim * npc, c))
                Kv = overlap_add_T(o.reshape(dim, npc, c), deg, rr, gs)
                return mask_t * Kv.reshape(-1, dim) + (1.0 - mask_t) * v

            return K32

        return assemble_Kt, make_tangent_matvec

    def _dense_tangent(self, delta, state) -> torch.Tensor:
        """Masked global tangent (n_dofs, n_dofs) in `dtype`, assembled from
        the per-cell tangents (the Direct solver)."""
        dim, p = self.space.dim, self.mesh.degree
        gs, rr = self._grid_shape, self._reps_rev
        u = state.displacement + delta
        ut = extract_cell_patches_T(u.reshape(gs + (dim,)), p, rr)
        a1 = 0.0 if self.quasi_static else self.alpha_1
        mass = self._tensor(a1 * self._m_scalar) if a1 != 0.0 else None
        K = assemble_cell_tangents(ut, self.G, self.w, self.material, mass_term=mass)
        npc, _, nc = K[0][0].shape
        # (d, e, i, j, c) -> (c, i, d, j, e): node-major element dofs
        Kc = torch.stack([torch.stack(row, 0) for row in K], 0)
        Kc = Kc.permute(4, 2, 0, 3, 1).reshape(nc, npc * dim, npc * dim)
        cells = torch.as_tensor(self.space.cells, dtype=torch.long, device=self.device)
        gdof = (cells[:, :, None] * dim + torch.arange(dim, device=self.device)).reshape(
            nc, npc * dim
        )
        n = self.space.n_dofs
        A = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        A.index_put_(
            (gdof[:, :, None].expand_as(Kc).reshape(-1),
             gdof[:, None, :].expand_as(Kc).reshape(-1)),
            Kc.reshape(-1), accumulate=True,
        )
        m = self.mask.reshape(-1)
        return m[:, None] * A * m[None, :] + torch.diag(1.0 - m)

    # ------------------------------------------------------------------
    # physics
    # ------------------------------------------------------------------

    def _int_force_t_J(self, u):
        """Internal force and min det F in the solve dtype."""
        dim, p = u.shape[-1], self.mesh.degree
        gs, rr = self._grid_shape, self._reps_rev
        ut = extract_cell_patches_T(u.reshape(gs + (dim,)), p, rr)
        rt, mJ = internal_force_cellwise_T(ut, self._G_t, self._w_t, self.material)
        return overlap_add_T(rt, p, rr, gs).reshape(-1, dim), mJ

    def _internal_force_and_J(self, u: torch.Tensor):
        dim, p = u.shape[-1], self.mesh.degree
        gs, rr = self._grid_shape, self._reps_rev
        ut = extract_cell_patches_T(u.reshape(gs + (dim,)), p, rr)
        rt, min_J = internal_force_cellwise_T(ut, self.G, self.w, self.material)
        return overlap_add_T(rt, p, rr, gs).reshape(-1, dim), min_J

    def external_force(self, u: torch.Tensor, stress: torch.Tensor) -> torch.Tensor:
        """Nanson pull-back surface loading: the spatial interface traction
        scaled by ||J F^{-T} N|| and integrated in the reference
        configuration, per complete lattice side through strided boundary
        slabs. F is detached: the tangent omits the Neumann linearization,
        as the reference does."""
        dim = u.shape[-1]
        p = self.mesh.degree
        gs, rr = self._grid_shape, self._reps_rev
        u_grid = u.reshape(gs + (dim,))
        s_grid = stress.reshape(gs + (dim,))
        out = torch.zeros(gs + (dim,), dtype=u.dtype, device=u.device)
        for side in self._neumann_sides:
            ga, sd = side["ga"], side["side"]
            Gf, Nf, wf, normal = side["Gf"], side["Nf"], side["wf"], side["normal"]
            vol_sl = [slice(None)] * dim
            vol_sl[ga] = slice(0, p + 1) if sd == 0 else slice(-(p + 1), None)
            slab_reps = list(rr)
            slab_reps[ga] = 1
            ut = extract_cell_patches_T(
                u_grid[tuple(vol_sl)], p, tuple(slab_reps)
            ).detach()  # (dim, npc, cs)
            grad = [[Gf[:, :, e] @ ut[d] for e in range(dim)] for d in range(dim)]
            F = [
                [grad[i][j] + (1.0 if i == j else 0.0) for j in range(dim)]
                for i in range(dim)
            ]
            Jf, F_inv = det_and_inv_c(F)
            n_star = [
                Jf * sum(F_inv[k][d] * normal[k] for k in range(dim) if normal[k] != 0.0)
                for d in range(dim)
            ]
            scale = torch.sqrt(sum(n_star[d] ** 2 for d in range(dim)))
            pl_sl = list(vol_sl)
            pl_sl[ga] = 0 if sd == 0 else -1
            plane_shape = tuple(n for a2, n in enumerate(gs) if a2 != ga)
            plane_reps = tuple(r for a2, r in enumerate(rr) if a2 != ga)
            tn = extract_cell_patches_T(s_grid[tuple(pl_sl)], p, plane_reps)
            wscale = wf[:, None] * scale
            rf = torch.stack(
                [Nf.T @ (wscale * (Nf @ tn[d])) for d in range(dim)], dim=0
            )  # (dim, npf, cs)
            out[tuple(pl_sl)] += overlap_add_T(rf, p, plane_reps, plane_shape)
        return out.reshape(-1, dim)

    def _acc(self, delta, state):
        return (
            self.alpha_1 * delta
            - self.alpha_2 * state.velocity
            - self.alpha_3 * state.acceleration
        )

    def residual(self, delta: torch.Tensor, state: NonlinearState, stress: torch.Tensor):
        """Masked system rhs: external + body - internal - inertia.
        Returns (rhs, min_J)."""
        u = state.displacement + delta
        r_int, min_J = self._internal_force_and_J(u)
        rhs = self.external_force(u, stress) - r_int
        if self.body_force_enabled:
            rhs = rhs + self._body_vec
        if not self.quasi_static:
            rhs = rhs - self.M(self._acc(delta, state))
        return self.mask * rhs, min_J

    def _residual32(self, delta: torch.Tensor, state: NonlinearState, stress: torch.Tensor):
        """`residual` with the volume terms in the solve dtype (the surface
        term stays f64); returns (rhs, min_J) in the state dtype."""
        tdt = self.solve_dtype
        u = state.displacement + delta
        r_int, min_J = self._int_force_t_J(u.to(tdt))
        rhs = self.external_force(u, stress).to(tdt) - r_int
        if self.body_force_enabled:
            rhs = rhs + self._body_vec.to(tdt)
        if not self.quasi_static:
            rhs = rhs - self.M_t(self._acc(delta, state).to(tdt))
        return (self.mask_t * rhs).to(self.dtype), min_J.to(self.dtype)

    # ------------------------------------------------------------------

    def initial_state(self) -> NonlinearState:
        z = torch.zeros(
            (self.space.n_nodes, self.space.dim), dtype=self.dtype, device=self.device
        )
        return NonlinearState(z, z, z)

    def _norm(self, v: torch.Tensor) -> float:
        """l2 norm by an f32 reduction of the (f64) vector: norms steer
        decisions only through ratios and thresholds (the JAX package's
        choice, kept for decision parity)."""
        v32 = v.to(torch.float32).reshape(-1)
        self.host_syncs += 1
        return float(torch.sqrt(torch.dot(v32, v32)).to(torch.float64))

    def _scalar(self, x: torch.Tensor) -> float:
        self.host_syncs += 1
        return float(x)

    def _newton_solve(self, state: NonlinearState, stress: torch.Tensor):
        params = self.params
        mask = self.mask
        tol_u, tol_f = params.tol_u, params.tol_f
        max_nr = int(params.max_iterations_NR)
        use_cg = params.type_lin == "CG"
        ew = params.newton_forcing == "ew"
        f64_window = float(params.newton_residual_f64_window)
        mixed_resid = (
            use_cg
            and self._mixed_tangent
            and params.newton_residual == "mixed"
        )
        norm = self._norm

        if params.newton_predictor and not self.quasi_static:
            delta = mask * (
                params.delta_t * state.velocity
                + (0.5 * params.delta_t**2) * state.acceleration
            )
        else:
            delta = torch.zeros_like(state.displacement)

        it, converged = 0, False
        res0 = upd0 = res_abs = res_rel = upd_abs = upd_rel = 1.0
        cg_total, min_J = 0, math.inf
        res_floor, calibrated, want64_next = 0.0, False, False
        n64 = n32 = nasm = 0
        while not converged and it < max_nr:
            if mixed_resid:
                # f64 at iteration 0, before the floor is calibrated, near
                # the floor, or where the last iteration predicted it
                want64 = (
                    it == 0 or not calibrated
                    or res_rel <= f64_window * res_floor or want64_next
                )
                if want64:
                    rhs, mJ = self.residual(delta, state, stress)
                else:
                    rhs, mJ = self._residual32(delta, state, stress)
                was32 = not want64
                res_abs0 = norm(rhs)
                u_nonzero = norm(state.displacement + delta) > 0.0
                floor_denom = res_abs0 if it == 0 else res0
                can_calib = (not was32) and (not calibrated) and u_nonzero
                floor0 = res_floor
                calib_ok = False
                if can_calib:
                    # a non-finite f32 evaluation calibrates nothing: keep
                    # evaluating in f64 and calibrate at the next iterate
                    rhs32, _ = self._residual32(delta, state, stress)
                    fl = _div(norm(rhs32 - rhs), _fmax(floor_denom, 1e-300))
                    calib_ok = math.isfinite(fl)
                    if calib_ok:
                        floor0 = fl
                calibrated = calibrated or calib_ok
                # stall: an f32 iteration that fails to halve the residual
                # (NaN-safe: a NaN residual also hands back to f64)
                stall = was32 and not (res_abs0 <= 0.5 * res_abs)
                res_floor = floor0
                if stall:
                    # re-evaluate this iterate in f64 and re-calibrate the
                    # floor from the difference; a non-finite difference
                    # (NaN f32 residual) keeps the last finite floor
                    rhs64, mJ = self.residual(delta, state, stress)
                    fl = _div(norm(rhs64 - rhs), _fmax(res0, 1e-300))
                    rhs = rhs64
                    if math.isfinite(fl):
                        res_floor = max(fl, floor0)
                calibrated = calibrated or stall
                n64_inc = (0 if was32 else 1) + (1 if stall else 0)
                n32_inc = (1 if was32 else 0) + (1 if can_calib else 0)
            else:
                rhs, mJ = self.residual(delta, state, stress)
                n64_inc, n32_inc = 1, 0
            res_abs_new = res_abs0 if mixed_resid and not stall else norm(rhs)
            if it == 0:
                res0 = _fmax(res_abs_new, 1e-300)
            res_rel_new = _div(res_abs_new, res0)
            ratio = _div(res_abs_new, res_abs)
            eta = params.ew_eta0 if it == 0 else _clip(0.9 * ratio * ratio, 1e-4, 0.5)
            T = _fmax(tol_f * res0, 5e-9)
            if mixed_resid:
                pred = _fmax(eta * res_abs_new, 0.5 * T) if ew else params.tol_lin * res_abs_new
                want64_next = _div(pred, res0) <= f64_window * res_floor
            # dual rel/abs rule
            conv = it > 0 and (upd_rel <= tol_u or upd_abs <= 1e-15) and (
                res_rel_new <= tol_f or res_abs_new <= 5e-9
            )
            cg_its = asm_inc = 0
            if not conv:
                cg_tol = _fmax(eta * res_abs_new, 0.5 * T) if ew else params.tol_lin * res_abs_new
                du, cg_its, asm_inc = self._solve(delta, state, rhs, cg_tol)
                upd_abs_new = norm(mask * du)
                if it == 0:
                    upd0 = _fmax(upd_abs_new, 1e-300)
                upd_abs, upd_rel = upd_abs_new, _div(upd_abs_new, upd0)
                delta = delta + du
                it += 1
            converged = conv
            res_abs, res_rel = res_abs_new, res_rel_new
            cg_total += cg_its
            min_J = _fmin(min_J, self._scalar(mJ))
            n64, n32, nasm = n64 + n64_inc, n32 + n32_inc, nasm + asm_inc
        info = NewtonInfo(
            converged=converged, iterations=it, residual_abs=res_abs,
            residual_rel=res_rel, update_abs=upd_abs, update_rel=upd_rel,
            cg_iterations=cg_total, min_det_F=min_J, f64_evals=n64,
            f32_evals=n32, tangent_assemblies=nasm,
        )
        return delta, info

    def _solve(self, delta, state, rhs, cg_tol):
        """One Newton correction: (du, CG iterations, tangent assemblies).
        The first one assembles the tangent into a new buffer and builds
        the CG solve over it (`cg_loop`); every later one assembles into
        that buffer."""
        if not self._use_assembled:
            A = self._dense_tangent(delta, state)
            du = torch.linalg.solve(A, rhs.reshape(-1)).reshape(rhs.shape)
            return du, 1, 1
        tdt = self.solve_dtype
        u_t = (state.displacement + delta).to(tdt)
        # the assembly closure refers to the model and is not kept: kept,
        # it would make the model, its tangent and its CG graphs a
        # reference cycle that outlives `del model`
        assemble_Kt, make_tangent_matvec = self._make_tangent_fns()
        if self._tangent is None:
            Kt = assemble_Kt(u_t)
            solve = make_cg(self.cg_loop, make_tangent_matvec(Kt),
                            self._precond, self.cg_chunk)
            self._tangent = (Kt, solve)
        else:
            Kt, solve = self._tangent
            assemble_Kt(u_t, out=Kt)
        r = solve(rhs.to(tdt), torch.zeros_like(rhs, dtype=tdt), cg_tol,
                  self._max_cg_iter)
        self.host_syncs += r.host_syncs
        return r.x.to(self.dtype), r.iterations, 1

    def step(
        self, state: NonlinearState, interface_stress: torch.Tensor
    ) -> Tuple[NonlinearState, NewtonInfo]:
        """One Newmark time step: Newton solve + velocity/acceleration
        updates. Checking `info.converged` is the caller's job."""
        delta, info = self._newton_solve(state, interface_stress)
        acc_new = self._acc(delta, state)
        vel_new = (
            self.alpha_4 * delta
            + self.alpha_5 * state.velocity
            + self.alpha_6 * state.acceleration
        )
        return (
            NonlinearState(state.displacement + delta, vel_new, acc_new),
            info,
        )

    def with_delta_t(self, delta_t: float) -> "NonlinearElasticity":
        """A solver clone stepping with a different dt on the same mesh and
        device, memoized per dt (subcycling: a coupling window that is not
        an integer multiple of delta_t is closed with a shortened stepper,
        `adapter.h:104-107`). The Newmark coefficients, the tangent's mass
        term and the preconditioner depend on dt, so the clone rebuilds
        them once (and, under `cg_loop="graphs"`, captures its own CG
        graphs); the multigrid geometry cached on the mesh is shared. The
        clone estimates its own lam_max values by power iteration, as the
        JAX package's clone does: values given to this model as
        `mg_lam_max` belong to its dt."""
        if float(delta_t) == float(self.params.delta_t):
            return self
        cache = self.__dict__.setdefault("_dt_clones", {})
        key = float(delta_t)
        if key not in cache:
            cache[key] = type(self)(
                dataclasses.replace(self.params, delta_t=key),
                mesh=self.mesh, tags=self.tags,
                quasi_static=self.quasi_static, device=self.device,
                cg_loop=self.cg_loop, cg_chunk=self.cg_chunk,
            )
        return cache[key]


def _check_ported(params: AllParameters) -> None:
    """Raise for configurations whose code path is not ported yet."""
    unported = [
        (params.tangent_backend == "jvp", "tangent_backend='jvp'", "Queue 1 item 12"),
        (params.newton_tangent_reuse, "newton_tangent_reuse", "Queue 1 item 13"),
        (params.mg_fine_tangent, "mg_fine_tangent", "Queue 1 item 13"),
        (params.use_sumfact, "use_sumfact", "Queue 1 item 13"),
        (params.element_backend == "gather", "element_backend='gather'",
         "Queue 1 item 13"),
        (params.n_devices > 1, "n_devices > 1", "Queue 1 item 14"),
    ]
    for flag, name, item in unported:
        if flag:
            raise NotImplementedError(
                f"{name} is not ported to the PyTorch package (ROADMAP {item})"
            )


def tangent_kernel_id(params: AllParameters) -> str:
    """The tangent matvec kernel the parameters select, as the JAX package
    selects its Pallas kernel (`models/nonlinear_elasticity.py`, the kinds
    ladder and `_make_tangent_fns`): "K1", "K1b" or "K1c" for full
    storage, "K2" or "K2b" for `tangent_block_symmetric`. `xla` takes the
    `auto` kernel (the port has no library-form matvec); `packedt` has no
    symmetric variant and, as in the JAX package, warns and runs the
    packed one (K2)."""
    kind = params.tangent_matvec_kernel
    if not params.tangent_block_symmetric:
        return {"packed": "K1b", "blocks": "K1c"}.get(kind, "K1")
    if kind == "packedt":
        warnings.warn(
            "tangent_matvec_kernel='packedt' has no block-symmetric variant; "
            "using 'packed' (row-major) instead",
            stacklevel=4,
        )
    return "K2b" if kind == "blocks" else "K2"
