"""Dynamic linear elasticity with one-step theta time integration.

Counterpart of `dealii_adapter_tpu/models/linear_elasticity.py` (the
reference's `Linear_Elasticity::ElastoDynamics`). The unknown of each step
is the velocity V_{n+1}, solved from

    (M + theta^2 dt^2 K) V_{n+1} =  dt theta F_{n+1} + dt (1-theta) F_n
                                  + (M - theta(1-theta) dt^2 K) V_n
                                  - dt K D_n          (`linear_elasticity.cc:398-420`)

followed by D_{n+1} = D_n + dt theta V_{n+1} + dt (1-theta) V_n. F is the
coupling load (the consistent face-traction integration of the nodal
interface stress, or the raw nodal forces for 'Force' data) plus constant
body forces.

K, M and the stepping matrix A = M + (theta dt)^2 K are f64 operators:
structured (`element_backend` `auto`/`structured`) or through the gather
plan (`gather`, `ops/element_ops.py:AssembledOperator`). With a
`device_mesh` (`parallel/partition.py:RankGroup`; `n_devices > 1` builds
one from the initialized process group) they are partitioned as the JAX
package's two SPMD modes partition them: `gather` takes the cell
partition (`parallel/sharded_ops.py`, vectors replicated, MG raises as in
the JAX package), `auto`/`structured` the lattice partition
(`parallel/lattice.py`: vectors distributed by rows, every operator and
the V-cycle on per-rank slabs, inner products all-reduced; the interface
load is integrated on the gathered interface data, and the dense Direct
solve runs whole on every rank on the gathered right-hand side). The solve is the reference's absolute 1e-10 CG contract: f32
preconditioned CG inside f64 defect correction (`ir_cg_solve`) when
`solve_dtype` is float32, plain CG otherwise, or a prefactored dense
Cholesky (`type_lin="Direct"`, up to 16,384 unknowns). The MG
preconditioner's fine proxy is kernel K5 in 3D Q2 (the plain structured
operator in 2D), its Q1 levels kernels K3 (3D) or K4b (2D).

The CG runs as `cg_loop` says: "graphs" (the default) runs
`solvers/cg.py:ChunkedCG`, chunks of guarded CG iterations captured once
per model in CUDA graphs on the card (run eagerly on the CPU), one
read-back per chunk, the inner tolerance of each refinement written to
the solver's tolerance tensor; "host" the host-loop `cg_solve`, one
read-back per iteration. Both give the same bits.

Differences from the JAX package: the step is eager PyTorch with host
loops (the refinement loop, one read-back per refinement; the CG's
read-backs; all counted in `host_syncs`) where JAX jits one step
function.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AllParameters
from ..device import resolve_device
from ..fem.dofspace import DofSpace
from ..mesh.generator import StructuredMesh, make_scenario_grid
from ..ops.element_ops import (
    ElementMatrices,
    assemble_dense,
    assemble_diagonal,
    body_force_vector,
    make_face_loading,
)
from ..ops.q2_structured import make_q2_operator, q2_lattice_operator
from ..parallel.lattice import SlabOperator
from ..parallel.partition import make_device_mesh
from ..parallel.spmd import (
    MG_CELL_PARTITION,
    check_collective_loop,
    element_operators,
)
from ..solvers.cg import (
    CG_CHUNK,
    _dot,
    chebyshev_preconditioner,
    ir_cg_solve,
    jacobi_preconditioner,
    lambda_max,
    make_cg,
)
from ..solvers.direct import DenseCholesky

CG_TOL = 1e-10  # absolute, hardcoded in the reference (`linear_elasticity.cc:542-543`)
DIRECT_MAX_UNKNOWNS = 16384  # dense Direct stepping matrix cap (as in JAX)


class LinearState(NamedTuple):
    """(n_nodes, dim) fields at t_n. `old_load` is the assembled coupling
    load F_n of the previous step (`linear_elasticity.cc:405-409`)."""

    displacement: torch.Tensor
    velocity: torch.Tensor
    old_load: torch.Tensor


class StepInfo(NamedTuple):
    iterations: int  # CG iterations (1 for Direct)
    residual: float  # final absolute residual l2 norm (0 for Direct)
    linf_velocity: float


class LinearElastodynamics:
    """Builds mesh, space, operators and preconditioner once on `device`
    (default: the CUDA card); `step(state, interface_data) -> (state,
    StepInfo)`. `cg_loop` ("graphs", the default, or "host") chooses the
    Krylov loop (module docstring); it exists so that both loops can be
    measured side by side, and the model never switches between them
    itself. With a `device_mesh`, states and interface data are this
    rank's rows (`local_rows`, `global_rows`)."""

    def __init__(
        self,
        params: AllParameters,
        mesh: Optional[StructuredMesh] = None,
        tags: Optional[dict] = None,
        refine: int = 0,
        device=None,
        mg_lam_max: Optional[Sequence[float]] = None,
        cg_loop: str = "graphs",
        device_mesh=None,
    ):
        """`mg_lam_max` (one value per MG level, fine first) replaces the
        hierarchy's power-iteration estimates."""
        self.params = params
        if device_mesh is None and params.n_devices > 1:
            device_mesh = make_device_mesh(params.n_devices, device=device)
        self.device_mesh = device_mesh
        self.device = resolve_device(
            device if device is not None or device_mesh is None
            else device_mesh.device)
        self.cg_loop = cg_loop
        check_collective_loop(device_mesh, self.device, cg_loop)
        dim = params.dim
        if mesh is None:
            mesh, tags = make_scenario_grid(
                params.scenario, dim, params.poly_degree,
                flap_location=params.flap_location, refine=refine,
                solver="linear",
            )
        assert tags is not None
        self.mesh = mesh
        self.tags = tags
        self.interface_id = tags["interface"]
        self.space = space = DofSpace.create(mesh, n_q_1d=params.poly_degree + 1)
        self.dtype = dt_ = torch.float64 if params.dtype == "float64" else torch.float32
        self.host_syncs = 0

        elem = ElementMatrices(space, params.lmbda, params.mu, params.rho)
        dt, theta = params.delta_t, params.theta
        A_e = elem.M_e + (theta * dt) ** 2 * elem.K_e
        dev = self.device
        # f32 Krylov inside f64 defect correction when solve_dtype is f32
        sdt = torch.float32 if params.solve_dtype == "float32" else dt_
        self.solve_dtype = sdt
        self._mixed = sdt != dt_
        mkop, self._lat, cells_mode = element_operators(
            params, space, device_mesh, dev)
        self.K = mkop(elem.K_e, dt_)
        self.M = mkop(elem.M_e, dt_)
        self.A = mkop(A_e, dt_)
        self.A_lo = mkop(A_e, sdt) if self._mixed else self.A
        lat = self._lat
        self._dot = lat.mesh.dot(_dot) if lat is not None else _dot
        self.n_rows = lat.n_owned if lat is not None else space.n_nodes

        mask_np = space.dirichlet_mask(tags["clamped"], tags.get("out_of_plane"))
        self.mask = self.local_rows(torch.as_tensor(mask_np, dtype=dt_, device=dev))
        self.mask_lo = self.mask.to(sdt)
        # Jacobi diagonal of the BC-masked stepping matrix (1 on constrained)
        diag = self.mask * self.local_rows(torch.as_tensor(
            assemble_diagonal(space, A_e), dtype=dt_, device=dev
        )) + (1.0 - self.mask)
        if params.preconditioner == "Chebyshev":
            A_lo_bc = self._masked(self.A_lo, self.mask_lo)
            diag_s = diag.to(sdt)
            lam = lambda_max(A_lo_bc, diag_s, (space.n_nodes, dim), lat)
            self._precond = chebyshev_preconditioner(
                A_lo_bc, diag_s, lam,
                degree=params.cheb_degree, eig_ratio=params.cheb_eig_ratio,
            )
        elif params.preconditioner == "MG":
            if cells_mode:
                raise NotImplementedError(MG_CELL_PARTITION)
            from ..solvers.multigrid import GeometricMultigrid

            c = (theta * dt) ** 2
            pdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
                params.precond_dtype, sdt
            )
            fmask = self.mask.to(pdt)
            fine = (make_q2_operator(space, A_e, pdt, dev) if lat is None else
                    SlabOperator(q2_lattice_operator(
                        A_e, lat.slab_shape, mesh.degree, pdt, dev), lat))
            self._precond = GeometricMultigrid(
                mesh, tags,
                self._masked(fine, fmask),
                diag.to(pdt), fmask,
                lmbda=c * params.lmbda, mu=c * params.mu,
                mass_coeff=params.rho, dtype=pdt,
                smooth_degree=params.mg_smooth_degree,
                smooth_degree_fine=params.mg_fine_smooth_degree,
                coarse_size=params.mg_coarse_size, fem_sem=params.mg_fem_sem,
                skip_fine_smoothing=params.mg_skip_fine_smoothing,
                level_backend=params.mg_level_backend, lam_max=mg_lam_max,
                device=dev, lattice=lat,
            )
        elif params.preconditioner == "None":
            self._precond = None
        else:
            self._precond = jacobi_preconditioner(diag.to(sdt))

        self.face_load = make_face_loading(
            space, elem, self.interface_id, dt_, dev
        )
        bf = body_force_vector(space, elem, params.rho, params.body_force)
        self.body_force_enabled = bool(np.linalg.norm(params.body_force) > 1e-15)
        self._body_vec = self.local_rows(torch.as_tensor(bf, dtype=dt_, device=dev))

        self._direct = None
        if params.type_lin == "Direct":
            if space.n_dofs > DIRECT_MAX_UNKNOWNS:
                raise ValueError(
                    f"type_lin='Direct' assembles the dense ({space.n_dofs}, "
                    f"{space.n_dofs}) stepping matrix on host; capped at "
                    f"{DIRECT_MAX_UNKNOWNS} unknowns. Use type_lin='CG' for "
                    "this size."
                )
            A_dense = assemble_dense(space, A_e)
            flat_mask = mask_np.reshape(-1)
            A_dense = A_dense * flat_mask[:, None] * flat_mask[None, :]
            np.fill_diagonal(A_dense, np.diag(A_dense) + (1.0 - flat_mask))
            self._direct = DenseCholesky(A_dense, dt_, dev)
        self._max_cg_iter = int(space.n_dofs * params.max_iterations_lin)
        # the BC-masked stepping matrix, and the CG solve (the inner solves
        # of the refinement when it runs in f32)
        self._A_bc = self._masked(self.A, self.mask)
        cg_op = (self._masked(self.A_lo, self.mask_lo) if self._mixed
                 else self._A_bc)
        self._cg = make_cg(self.cg_loop, cg_op, self._precond, CG_CHUNK,
                           self._dot)
        self._cg_op = cg_op

    # ------------------------------------------------------------------

    @staticmethod
    def _masked(op, mask):
        """BC-eliminated SPD action: identity on constrained DoFs."""

        def apply(v):
            return mask * op(mask * v) + (1.0 - mask) * v

        return apply

    def local_rows(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (n_nodes, dim) vector (all of them
        on one device and under the cell partition)."""
        return self._lat.local(v) if self._lat is not None else v

    def global_rows(self, v: torch.Tensor) -> torch.Tensor:
        """The global vector of this rank's rows, on every rank."""
        return self._lat.gather(v) if self._lat is not None else v

    def initial_state(self) -> LinearState:
        z = torch.zeros(
            (self.n_rows, self.space.dim), dtype=self.dtype, device=self.device
        )
        return LinearState(displacement=z, velocity=z, old_load=z)

    def assemble_load(self, interface_data: torch.Tensor) -> torch.Tensor:
        """F_{n+1}: coupling load + body force (`linear_elasticity.cc:384-395`)."""
        if self.params.data_consistent:
            # the surface integral on the whole interface data (gathered
            # under the lattice partition: a once-per-step surface term)
            F = self.local_rows(self.face_load(self.global_rows(interface_data)))
        else:
            F = interface_data
        if self.body_force_enabled:
            F = F + self._body_vec
        return F

    def step(
        self, state: LinearState, interface_data: torch.Tensor
    ) -> Tuple[LinearState, StepInfo]:
        """One theta-step. `interface_data` is the (n_nodes, dim) nodal
        coupling field (stress for consistent, forces for conservative
        reads), zero off the interface."""
        params = self.params
        dt, theta = params.delta_t, params.theta
        K, M, mask = self.K, self.M, self.mask
        F_new = self.assemble_load(interface_data)
        rhs = (
            dt * theta * F_new
            + dt * (1.0 - theta) * state.old_load
            + M(state.velocity)
            - (theta * (1.0 - theta) * dt * dt) * K(state.velocity)
            - dt * K(state.displacement)
        )
        rhs = mask * rhs  # zero-valued Dirichlet rows
        if self._direct is not None:
            # the whole system on every rank (one factor each): the gathered
            # right-hand side, this rank's rows of the solution
            v_new = self.local_rows(self._direct.solve(self.global_rows(rhs)))
            iters, resn = 1, 0.0
        else:
            if self._mixed:
                res = ir_cg_solve(
                    self._A_bc, self._cg_op, rhs,
                    mask * state.velocity, tol=CG_TOL,
                    max_iter=self._max_cg_iter, lo_dtype=self.solve_dtype,
                    preconditioner=self._precond, inner_solve=self._cg,
                    dot=self._dot,
                )
            else:
                res = self._cg(rhs, mask * state.velocity, CG_TOL,
                               self._max_cg_iter)
            self.host_syncs += res.host_syncs
            v_new, iters, resn = res.x, res.iterations, res.residual_norm
        d_new = (
            state.displacement
            + dt * theta * v_new
            + dt * (1.0 - theta) * state.velocity
        )
        self.host_syncs += 1
        vmax = v_new.abs().max()
        if self._lat is not None:
            vmax = self._lat.mesh.all_reduce(vmax, "max")
        info = StepInfo(iterations=iters, residual=resn,
                        linf_velocity=float(vmax))
        return LinearState(d_new, v_new, F_new), info

    def with_delta_t(self, delta_t: float) -> "LinearElastodynamics":
        """A solver clone stepping with a different dt on the same mesh and
        device, memoized per dt (subcycling: a coupling window that is not
        an integer multiple of delta_t is closed with a shortened stepper,
        `adapter.h:104-107`). The stepping matrix and its preconditioner
        depend on dt, so the clone rebuilds them once (and, under
        `cg_loop="graphs"`, captures its own CG graphs)."""
        if float(delta_t) == float(self.params.delta_t):
            return self
        cache = self.__dict__.setdefault("_dt_clones", {})
        key = float(delta_t)
        if key not in cache:
            cache[key] = type(self)(
                dataclasses.replace(self.params, delta_t=key),
                mesh=self.mesh, tags=self.tags, device=self.device,
                cg_loop=self.cg_loop, device_mesh=self.device_mesh,
            )
        return cache[key]
