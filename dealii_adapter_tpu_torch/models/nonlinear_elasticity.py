"""Finite-strain compressible Neo-Hookean dynamics: Newmark-beta + Newton.

Counterpart of `dealii_adapter_tpu/models/nonlinear_elasticity.py`. Per
time step Newton solves

    R(delta) = F_ext(u) + F_body - F_int(u) - M a(delta) = 0,   u = u_n + delta

with the Newmark acceleration a = alpha_1 delta - alpha_2 v_n - alpha_3 a_n
and the dual relative/absolute convergence rule of the reference. The
Newton tangent is chosen as the JAX package chooses it:

* assembled, for a mixed CG solve (solve_dtype narrower than dtype) whose
  per-cell tangents fit `assembled_tangent_max_gb` and whose
  `tangent_backend` is `auto` or `assembled`: each Newton iteration
  assembles the per-cell tangents in the solve dtype (f32), lays them out
  for the selected matvec kernel, and the CG's matvec is extract ->
  tangent kernel -> overlap-add. The kernel follows
  `tangent_block_symmetric` and `tangent_matvec_kernel` as the JAX
  package picks its Pallas kernel (`tangent_kernel_id`): full storage
  runs K1 (the column-major pack; `auto`, `packedt`, `xla`), K1b
  (`packed`) or K1c (`blocks`); block-symmetric storage, the upper
  component blocks only, runs K2 (`auto`, `packed`, `packedt` with a
  warning, `xla`) or K2b (`blocks`). `xla` names a library-form matvec
  that the port does not have, so it takes the `auto` kernel.
  `newton_tangent_reuse` freezes it after `tangent_reuse_after`
  iterations (refreshed when stale); `mg_fine_tangent` smooths it on the
  V-cycle's fine level in place of the small-strain proxy;
* jvp otherwise (`_make_jvp_tangent`): the forward-mode derivative
  (`forward_jvp`) of the f32 internal force for a mixed solve
  (`tangent_backend="jvp"`, or tangents above the cap), of the whole f64
  residual for an f64 inner solve (the reference's default
  configuration; formed from the internal force's derivative, the only
  term of the residual that is not constant or linear in the iterate);
* the dense masked tangent for `type_lin="Direct"`.

The element backend (`element_backend`): `auto`/`structured` runs the
gather-free strided patches (`ops/structured.py`), `gather` the cells'
node gathers and the transpose-gather plan (`ops/element_ops.py`), whose
Newton tangent is the jvp one (the assembled tangent needs the lattice),
and whose Neumann pull-back is the per-face gather formulation
(`_external_force_gather`). The gather pull-back also runs on every
backend when an interface side does not cover a whole lattice side.

With a `device_mesh` (`parallel/partition.py:RankGroup`; `n_devices > 1`
builds one from the initialized process group) the model runs the JAX
package's two SPMD modes: `gather` the cell partition (the internal
force with min det F, M and the preconditioner proxies cell-partitioned,
`parallel/sharded_ops.py`; vectors replicated; the mixed residual
schedule evaluates in f64 only, and MG raises, as in the JAX package),
`auto`/`structured` the lattice partition (`parallel/lattice.py`: states,
residuals and the CG's vectors distributed by rows, every structured
operator and kernel, the assembled tangent's K1 and the V-cycle on
per-rank slabs, norms and inner products all-reduced; a Neumann side
along the split axis is evaluated by the rank that holds it, an
interface that covers part of a side on the gathered fields; the dense
Direct tangent is assembled and solved whole on every rank from the
gathered iterate and right-hand side). Every rank reads the same reduced
scalars, so every rank takes the same Newton branch.

The CG is preconditioned by the geometric-multigrid V-cycle (kernels K5
and K3 in 3D, K4b in 2D; K6 on the Q1 levels under a `stencil*`
`mg_level_backend`), Jacobi, Chebyshev or nothing. In 3D `use_sumfact`
computes the f64 internal force and mass by sum factorization
(`ops/sumfact.py`).

The CG is one loop, `solvers/cg.py:ChunkedCG` (`make_cg`): fixed-length
chunks of guarded CG iterations with one read-back per chunk. `cg_loop`
says how the chunks run: "graphs" (the default) captures them once per
model in CUDA graphs on the card (tangent operator, the whole V-cycle,
dots), "host" runs them eagerly (`eager=True`: gloo ranks, whose
collectives cannot be captured); on the CPU both run eagerly. Both give
the same bits, and those of the host-loop `cg_solve`, the oracle. The
tangent's state lives in persistent buffers per model: the assembly
writes into one (the layouts' `out=`), the jvp tangent's linearization
point is copied into others, so the captured operator reads each Newton
iteration's tangent at the same address.

The Newton loop is written once (`_newton_solve`, the JAX package's
`_make_step`): every decision is made on the device in 0-dim f64 tensors
(`_newton_decide`), the CG takes its tolerance as a device tensor, and
the host reads back one packed status a Newton pass (two in a pass whose
f32 residual stalls), which says what to run next. Its bodies (the
residuals, the tangent refill, the decisions and the update) go through
the model's `solvers/graphs.py:GraphRunner`, which follows `cg_loop`:
under "graphs" it replays them from CUDA graphs captured once per model
into the CG graphs' memory pool, under "host" it runs them eagerly, as
the gloo ranks need (their collectives cannot be captured); on the CPU
both run eagerly. Both give the same `NewtonInfo` and iterate bit for
bit. `verbose` prints the reference's per-iteration convergence table
from the status read each pass, at no extra read-back.

One difference in work from the JAX package's loop: an f64 pass before
the noise floor is calibrated evaluates the solve-dtype residual whether
or not u != 0 (the JAX package skips it at u = 0, where the calibration
is discarded), so a step from rest pays one more such evaluation, which
`NewtonInfo.f32_evals` does not count and `uncounted_f32_evals` does; on
the gloo ranks that residual also costs its collectives.

Differences from the JAX package, all in the host orchestration:
* Newton is a host loop (`lax.while_loop` in JAX) that reads a packed
  status back every pass, counted in `host_syncs` with the CG's
  read-backs;
* a NaN f32 residual never becomes the noise floor: a non-finite
  calibration leaves the floor uncalibrated (f64 continues), and the
  stall-redo re-calibration keeps the last finite floor (the JAX package
  lets the floor become NaN);
* the Direct solver assembles the dense tangent from the per-cell
  tangents (JAX stacks jvp columns): the same linearization up to
  roundoff;
* under `newton_tangent_reuse` with `tangent_reuse_after` < 1, the
  model's first Newton iteration assembles (the JAX package applies a
  zero tangent there).
"""

from __future__ import annotations

import dataclasses
import math
import types
import warnings
import weakref
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

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
from ..fem.dofspace import build_transpose_gather_plan
from ..ops.element_ops import (
    ElementMatrices,
    apply_plan,
    assemble_diagonal,
    body_force_vector,
)
from ..ops.q2_structured import make_q2_operator, q2_lattice_operator
from ..ops.structured import (
    _cells_shape,
    _grid_shape,
    extract_cell_patches_T,
    overlap_add_T,
)
from ..ops.sumfact import (
    SumfactMassOperator,
    internal_force_cellwise_sumfact,
    make_sumfact_basis,
)
from ..parallel.lattice import SlabOperator
from ..parallel.partition import make_device_mesh
from ..parallel.sharded_ops import sharded_cellwise_reduction
from ..parallel.spmd import (
    MG_CELL_PARTITION,
    check_collective_loop,
    element_operators,
)
from ..solvers.cg import (
    CG_CHUNK,
    CG_LOOPS,
    _dot,
    chebyshev_preconditioner,
    jacobi_preconditioner,
    lambda_max,
    make_cg,
)
from ..solvers.graphs import GraphRunner
from .material import NeoHookean, det_and_inv_c, fsum, kinematics_c

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
        [fsum(tau[d][e] * F_inv[k][e] for e in range(dim)) for k in range(dim)]
        for d in range(dim)
    ]
    GwT = [(G[:, :, k] * w[:, None]).T for k in range(dim)]
    rt = torch.stack(
        [fsum(GwT[k] @ P[d][k] for k in range(dim)) for d in range(dim)], dim=0
    )
    return rt, J.min()


def forward_jvp(fn, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The derivative of `fn` at `x` in the direction `t` by forward-mode
    AD: one evaluation of `fn` on dual numbers (`torch.autograd.
    forward_ad`, which `torch.func.jvp` wraps: the same operations with
    less host time a call, which the eager CPU tests feel). A
    `.detach()` inside `fn` drops its operand's tangent, as JAX's
    `stop_gradient` does. Launches on the current stream and reads nothing
    back, so a CUDA graph can capture it."""
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(x, t))
        tangent = fwAD.unpack_dual(out).tangent
    return torch.zeros_like(out) if tangent is None else tangent


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


class NonlinearElasticity:
    """Builds mesh, space, operators and preconditioner once on `device`
    (default: the CUDA card); `step(state, stress) -> (state,
    NewtonInfo)` runs `jittable_step()`; `internal_force`, `residual` and
    `_residual32` are exposed for tests. `cg_loop` ("graphs", the
    default, or "host") chooses the Krylov loop and with it how the Newton
    loop's bodies run (module docstring); it exists so that both can be
    measured side by side and for gloo ranks on the card, and the model
    never switches it itself. `cg_chunk` (default `CG_CHUNK`) sets the
    graphs' chunk length; it exists for `tools/cg_chunk_sweep.py`, which
    measures the lengths on this model. With a `device_mesh`, states and
    interface stresses are this rank's rows (`local_rows`,
    `global_rows`). `verbose` prints the per-iteration Newton table (rank
    0 alone on several ranks). `host_syncs` counts the read-backs,
    `cg_host_syncs` the CG's among them, and `uncounted_f32_evals` the
    solve-dtype residuals the loop evaluated and discarded, which
    `NewtonInfo` does not count (module docstring)."""

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
        device_mesh=None,
        verbose: bool = False,
    ):
        """`mg_lam_max` (one value per MG level, fine first) replaces the
        hierarchy's power-iteration estimates."""
        self.verbose = verbose
        if not params.data_consistent:
            raise ValueError(
                "The neo-Hookean solid doesn't support 'Force' data reading. "
                "Please switch to 'Stress' data or use the linear model."
            )
        self.params = params
        self.quasi_static = quasi_static
        if device_mesh is None and params.n_devices > 1:
            device_mesh = make_device_mesh(params.n_devices, device=device)
        self.device_mesh = device_mesh
        self._lead = device_mesh is None or device_mesh.rank == 0
        self.device = resolve_device(
            device if device is not None or device_mesh is None
            else device_mesh.device)
        self.cg_loop = cg_loop
        if cg_loop not in CG_LOOPS:
            raise ValueError(
                f"unknown cg_loop {cg_loop!r}; expected one of {CG_LOOPS}")
        check_collective_loop(device_mesh, self.device, cg_loop)
        self.cg_chunk = int(cg_chunk)
        # the Newton loop's CUDA graphs share the CG graphs' memory pool;
        # beside the eager CG chunks its bodies run eagerly
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._graphs = GraphRunner(self.device, self._pool,
                                   eager=cg_loop == "host")
        self._nb = None  # the Newton loop's buffers, at its first step
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
        n = self.space.n_dofs
        if params.type_lin == "Direct" and n > DIRECT_MAX_UNKNOWNS:
            raise ValueError(
                f"type_lin='Direct' materializes the dense ({n}, {n}) "
                f"tangent; capped at {DIRECT_MAX_UNKNOWNS} unknowns. Use "
                "type_lin='CG' for this size."
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
        self.host_syncs = 0  # device-to-host read-backs, the CG's included
        self.cg_host_syncs = 0  # the CG's read-backs among them
        self.uncounted_f32_evals = 0  # the Newton loop's, at u = 0
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
        dev = self.device
        self._grid_shape = _grid_shape(space)
        self._reps_rev = _cells_shape(space)
        # the element backend and SPMD mode (module docstring): `mkop(E,
        # dtype)` builds its constant-element-matrix operators
        mkop, lat, self._cells = element_operators(
            params, space, self.device_mesh, dev)
        self._lat = lat
        self._structured = params.element_backend in ("auto", "structured")
        # this rank's lattice (its slab under the lattice partition)
        self._gs_loc = lat.slab_shape if lat is not None else self._grid_shape
        self._rr_loc = lat.slab_reps if lat is not None else self._reps_rev
        self.n_rows = lat.n_owned if lat is not None else space.n_nodes
        self._dot = lat.mesh.dot(_dot) if lat is not None else _dot
        self.cells = self.plan = None
        if not self._structured and not self._cells:
            self.cells = torch.as_tensor(space.cells, dtype=torch.long, device=dev)
            self.plan = torch.as_tensor(space.plan, dtype=torch.long, device=dev)

        self.G = self._tensor(tab.dN / h[None, None, :])  # (q, npc, dim)
        self.w = self._tensor(tab.q_weights * detJ)  # (q,)
        elem = ElementMatrices(space, 0.0, 0.0, params.rho)
        # sum-factorized f64 internal force and mass (3D, `use_sumfact`):
        # per-axis 1D stages in place of the dense (q, npc) tabulation
        # products, as in the JAX package (structured backend only)
        self._sumfact = None
        if dim == 3 and params.use_sumfact and self._structured:
            self._sumfact = make_sumfact_basis(tab, h, dt, dev)
            mass = SumfactMassOperator(
                sf=self._sumfact, rho=float(params.rho), p=space.mesh.degree,
                reps_rev=self._rr_loc, grid_shape=self._gs_loc, dim=dim)
            self.M = SlabOperator(mass, lat) if lat is not None else mass
        else:
            self.M = mkop(elem.M_e, dt)
        if self._cells:
            self._sharded_internal = sharded_cellwise_reduction(
                self.M.part, self.device_mesh,
                _cell_kernel(self.G, self.w, self.material), has_min=True)

        bf = body_force_vector(space, elem, params.rho, params.body_force)
        self.body_force_enabled = bool(np.linalg.norm(params.body_force) > 1e-15)
        self._body_vec = self.local_rows(self._tensor(bf))

        # the Neumann pull-back: per complete lattice side through strided
        # boundary slabs (structured backends); the per-face gather
        # formulation for the gather backend, or where a side is partial
        faces, fnodes = space.interface_faces(self.interface_id)
        lf_np = np.asarray(faces[:, 1])
        sides = []
        complete = self._structured and len(lf_np) > 0
        for f in sorted(set(lf_np.tolist())) if complete else ():
            axis, side01 = f // 2, f % 2
            n_side = int(
                np.prod([r for a2, r in enumerate(self.mesh.reps) if a2 != axis])
            )
            if int((lf_np == f).sum()) != n_side:
                complete = False
                break
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
        self._neumann_sides = sides if complete else None
        if not complete:
            self._setup_gather_neumann(faces, fnodes, h, detJ)

        mask = self._tensor(
            space.dirichlet_mask(self.tags["clamped"], self.tags.get("out_of_plane")))
        self.mask = self.local_rows(mask)
        # the dense Direct tangent is assembled and solved whole on every rank
        self._mask_global = mask if params.type_lin == "Direct" else None

        # inner-solve dtype: f32 copies of the operator constants (inexact
        # Newton; residual, norms and state stay in `dtype`)
        tdt = torch.float32 if params.solve_dtype == "float32" else dt
        self.solve_dtype = tdt
        self._mixed_tangent = tdt != dt
        self._G_t, self._w_t = self.G.to(tdt), self.w.to(tdt)
        self.mask_t = self.mask.to(tdt)
        self.M_t = mkop(elem.M_e, tdt) if self._mixed_tangent else None
        if self._cells and self._mixed_tangent:
            self._sharded_internal32 = sharded_cellwise_reduction(
                self.M.part, self.device_mesh,
                _cell_kernel(self._G_t, self._w_t, self.material, with_min=False))

        # the Newton tangent, as the JAX package selects it: the assembled
        # per-cell tangent in the solve dtype, in the layout of the selected
        # matvec kernel, for a mixed CG solve whose tangents fit
        # `assembled_tangent_max_gb`; else the jvp tangent (f32 for a mixed
        # solve, the whole f64 residual's otherwise)
        self.tangent_kernel = tangent_kernel_id(params)
        self._use_assembled = False
        if (params.tangent_backend in ("auto", "assembled")
                and params.type_lin == "CG" and self._mixed_tangent
                and self._structured):
            kb = tangent_bytes(space, tdt, sym=params.tangent_block_symmetric)
            fits = kb <= params.assembled_tangent_max_gb * 1e9
            if not fits and params.tangent_backend == "assembled":
                raise ValueError(
                    f"tangent_backend='assembled' needs {kb / 1e9:.1f} GB for "
                    f"the per-cell tangents (> assembled_tangent_max_gb="
                    f"{params.assembled_tangent_max_gb}); use 'jvp' or raise "
                    "the cap"
                )
            self._use_assembled = fits
            if fits and params.tangent_assembly_precision in ("default",
                                                              "bf16emu"):
                # the JAX package's warning, word for word; "bf16emu"
                # assembles as it does, "default" at full precision
                # (`ops/assembled_tangent.py:_assemble_upper` says why)
                warnings.warn(
                    "tangent_assembly_precision="
                    f"'{params.tangent_assembly_precision}' assembles "
                    "the Newton tangent from single-bf16-pass matmuls "
                    "— measured DIVERGENT at production scale "
                    "(round-4 hardware session). Use 'highest' (or "
                    "'high') for real runs.",
                    stacklevel=3,
                )
        elif params.tangent_backend == "assembled":
            raise ValueError(
                "tangent_backend='assembled' requires type_lin='CG', "
                "solve_dtype narrower than dtype (the mixed-precision inner "
                "solve) and the structured element backend"
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
        diag = self.mask * self.local_rows(
            self._tensor(assemble_diagonal(space, Ke_precond))) + (1.0 - self.mask)
        sdt = tdt
        if params.preconditioner == "Chebyshev":
            proxy = mkop(Ke_precond, sdt)
            mask_s = self.mask.to(sdt)
            diag_s = diag.to(sdt)

            def proxy_bc(v):
                return mask_s * proxy(mask_s * v) + (1.0 - mask_s) * v

            lam = lambda_max(proxy_bc, diag_s, (space.n_nodes, dim), lat)
            self._precond = chebyshev_preconditioner(
                proxy_bc, diag_s, lam,
                degree=params.cheb_degree, eig_ratio=params.cheb_eig_ratio,
            )
        elif params.preconditioner == "MG":
            if self._cells:
                raise NotImplementedError(MG_CELL_PARTITION)
            from ..solvers.multigrid import GeometricMultigrid

            pdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
                params.precond_dtype, sdt
            )
            # the MG fine proxy: kernel K5 for 3D Q2 (on this rank's slab
            # under the lattice partition), whatever the element backend
            proxy = (make_q2_operator(space, Ke_precond, pdt, dev) if lat is None
                     else SlabOperator(q2_lattice_operator(
                         Ke_precond, lat.slab_shape, space.mesh.degree, pdt,
                         dev), lat))
            fmask = self.mask.to(pdt)
            self._fine_proxy = proxy

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
                device=dev, lattice=lat,
            )
        elif params.preconditioner == "None":
            self._precond = None
        else:
            self._precond = jacobi_preconditioner(diag.to(sdt))
        self._max_cg_iter = int(space.n_dofs * params.max_iterations_lin)
        # smooth the assembled tangent on the V-cycle's fine level in place
        # of the small-strain proxy (`_solve`, `with_fine_operator`)
        self._mg_fine_tangent = bool(
            params.mg_fine_tangent and params.preconditioner == "MG"
            and not params.mg_skip_fine_smoothing and self._use_assembled
        )

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
        gs, rr = self._gs_loc, self._rr_loc  # this rank's lattice
        npc = self.space.tab.n_nodes
        mask_t = self.mask_t
        kern = self.tangent_kernel
        slab, own = self._slab, self._own
        precision = self.params.tangent_assembly_precision
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
            ut_p = extract_cell_patches_T(slab(u_t), deg, rr)
            if layout is None:
                return assemble(
                    ut_p, self._G_t, self._w_t, self.material,
                    mass_term=self._tangent_mass, S=self._S_t, out=out,
                    precision=precision,
                )
            return layout(assemble(
                ut_p, self._G_t, self._w_t, self.material,
                mass_term=self._tangent_mass, S=self._S_t,
                precision=precision,
            ), out=out)

        def make_tangent_matvec(Kt):
            def K32(v):
                mv = mask_t * v
                pv = extract_cell_patches_T(slab(mv), deg, rr)
                c = pv.shape[-1]
                o = apply(Kt, pv.reshape(dim * npc, c))
                Kv = own(overlap_add_T(o.reshape(dim, npc, c), deg, rr, gs))
                return mask_t * Kv + (1.0 - mask_t) * v

            return K32

        return assemble_Kt, make_tangent_matvec

    def _dense_tangent(self, delta, state) -> torch.Tensor:
        """Masked global tangent (n_dofs, n_dofs) in `dtype`, assembled from
        the per-cell tangents (the Direct solver). Under the lattice
        partition every rank assembles the whole of it from the gathered
        iterate."""
        dim, p = self.space.dim, self.mesh.degree
        gs, rr = self._grid_shape, self._reps_rev
        u = self.global_rows(state.displacement) + self.global_rows(delta)
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
        m = self._mask_global.reshape(-1)
        return m[:, None] * A * m[None, :] + torch.diag(1.0 - m)

    # ------------------------------------------------------------------
    # tangent (jvp)
    # ------------------------------------------------------------------

    def _make_jvp_tangent(self, delta, state, stress):
        """`(refill, K)`: the jvp tangent operator K at a linearization
        point held in persistent buffers, which `refill(delta, state,
        stress)` overwrites (`copy_`), so a CG captured once over K stays
        valid across Newton iterations. Mixed solve (the JAX package's
        jvp branch of `do_solve`): K32(v) = mask_t * (J_int(mask_t v) +
        a1 M_t(mask_t v)) + (1 - mask_t) v, J_int the derivative of the
        solve-dtype internal force at u_t. Otherwise (its
        `jax.linearize(rhs_fn, delta)`): K(v) = mask * (-J_rhs(mask v)) +
        (1 - mask) v, J_rhs the derivative of `residual` with respect to
        delta, whose detached pull-back F drops the external force's.
        `forward_jvp` recomputes the primal in every application. K holds
        the model through a weak proxy: it lives in the model's CG graphs,
        and a strong reference would make a cycle."""
        model = weakref.proxy(self)
        if self._mixed_tangent:
            u_t = (state.displacement + delta).to(self.solve_dtype)
            mask_t = self.mask_t
            a1 = 0.0 if self.quasi_static else self.alpha_1

            def force(u):
                return model._int_force_t(u)

            def K(v):
                mv = mask_t * v
                Kv = forward_jvp(force, u_t, mv)
                if a1 != 0.0:
                    Kv = Kv + a1 * model.M_t(mv)
                return mask_t * Kv + (1.0 - mask_t) * v

            def refill(delta, state, stress):
                u_t.copy_(state.displacement + delta)

            return refill, K

        # J_rhs(w) = mask * ((-J_int(w)) - M(a1 w)): the pull-back is
        # detached, the body force constant and the inertia linear in
        # delta with the factor a1. So -J_rhs is formed from the internal
        # force's derivative alone, with the same IEEE operations on the
        # same values as the derivative of the whole residual (negation is
        # exact), and the residual's other terms stay off the dual numbers
        u = state.displacement + delta
        mask = self.mask
        a1 = 0.0 if self.quasi_static else self.alpha_1

        def force(u):
            return model._internal_force_and_J(u)[0]

        def K(v):
            mv = mask * v
            Jv = forward_jvp(force, u, mv)
            if a1 != 0.0:
                Jv = Jv + model.M(a1 * mv)
            return mask * (mask * Jv) + (1.0 - mask) * v

        def refill(delta, state, stress):
            torch.add(state.displacement, delta, out=u)

        return refill, K

    # ------------------------------------------------------------------
    # physics
    # ------------------------------------------------------------------

    # the element backend and the partition: this rank's lattice (`_slab`
    # fills its halo, `_own` sums the shared plane back), the global MIN

    def _slab(self, u):
        """This rank's lattice grid of a vector (the slab with its halo
        under the lattice partition)."""
        if self._lat is None:
            return u.reshape(self._grid_shape + (u.shape[-1],))
        return self._lat.fill(u)

    def _own(self, y):
        """This rank's rows of an output computed on its lattice."""
        if self._lat is None:
            return y.reshape(-1, y.shape[-1])
        return self._lat.interface_sum(y)

    def _gmin(self, m):
        return self._lat.mesh.all_reduce(m, "min") if self._lat is not None else m

    def local_rows(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (n_nodes, dim) vector (all of them
        on one device and under the cell partition)."""
        return self._lat.local(v) if self._lat is not None else v

    def global_rows(self, v: torch.Tensor) -> torch.Tensor:
        """The global vector of this rank's rows, on every rank."""
        return self._lat.gather(v) if self._lat is not None else v

    def _cell_force(self, u, G, w, sumfact=None):
        """(internal force, min det F) with the tabulation (G, w) or the
        sum-factorized basis, on the element backend (the cell partition
        has its own sharded reductions)."""
        dim, p = u.shape[-1], self.mesh.degree
        if self.plan is not None:  # gather backend
            n_cells, npc = self.cells.shape
            ut = u[self.cells].permute(2, 1, 0)  # (dim, npc, n_cells)
            rt, mJ = internal_force_cellwise_T(ut, G, w, self.material)
            r = apply_plan(rt.permute(2, 1, 0).reshape(n_cells * npc, dim),
                           self.plan)
            return r, mJ
        gs, rr = self._gs_loc, self._rr_loc
        ut = extract_cell_patches_T(self._slab(u), p, rr)
        if sumfact is not None:
            rt, mJ = internal_force_cellwise_sumfact(ut, sumfact, self.material)
        else:
            rt, mJ = internal_force_cellwise_T(ut, G, w, self.material)
        return self._own(overlap_add_T(rt, p, rr, gs)), self._gmin(mJ)

    def _int_force_t_J(self, u):
        """Internal force and min det F in the solve dtype."""
        return self._cell_force(u, self._G_t, self._w_t)

    def _int_force_t(self, u):
        """The solve-dtype internal force (the mixed jvp tangent's)."""
        if self._cells:
            return self._sharded_internal32(u)
        return self._int_force_t_J(u)[0]

    def internal_force(self, u: torch.Tensor) -> torch.Tensor:
        """F_int[i] = int_Omega0 sym(grad_x N_i) : tau dV, the geometric
        stress term of the residual (`nonlinear_elasticity.cc:980-996`),
        at the total displacement `u` (this rank's rows under a
        `device_mesh`); min det F is `_internal_force_and_J`'s."""
        return self._internal_force_and_J(u)[0]

    def _internal_force_and_J(self, u: torch.Tensor):
        if self._cells:
            return self._sharded_internal(u)
        return self._cell_force(u, self.G, self.w, self._sumfact)

    def external_force(self, u: torch.Tensor, stress: torch.Tensor) -> torch.Tensor:
        """Nanson pull-back surface loading: the spatial interface traction
        scaled by ||J F^{-T} N|| and integrated in the reference
        configuration, per complete lattice side through strided boundary
        slabs (on the lattice partition a side along the split axis by the
        rank that holds it, the others by every rank on its slab), or per
        face through gathers (`_external_force_gather`; on the lattice
        partition on the gathered fields, every rank keeping its rows). F
        is detached:
        the tangent omits the Neumann linearization, as the reference
        does."""
        if self._neumann_sides is None:
            if self._lat is None:
                return self._external_force_gather(u, stress)
            # on the lattice partition: the faces of the gathered fields,
            # this rank's rows of the load
            return self.local_rows(self._external_force_gather(
                self.global_rows(u), self.global_rows(stress)))
        dim = u.shape[-1]
        p = self.mesh.degree
        gs, rr = self._gs_loc, self._rr_loc
        lat = self._lat
        u_grid = self._slab(u)
        s_grid = self._slab(stress)
        out = torch.zeros(gs + (dim,), dtype=u.dtype, device=u.device)
        for side in self._neumann_sides:
            ga, sd = side["ga"], side["side"]
            if lat is not None and ga == lat.axis and (
                    (sd == 0 and lat.rank > 0) or (sd == 1 and lat.top)):
                continue  # another rank holds this side
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
        return self._own(out)

    def _setup_gather_neumann(self, faces, fnodes, h, detJ):
        """The constants of the per-face Neumann pull-back (the JAX
        package's `_setup_device_constants`), component-separated with the
        faces trailing."""
        tab, dt = self.space.tab, self.dtype
        lf = faces[:, 1]
        self.face_nodes = torch.as_tensor(fnodes, device=self.device)
        self.face_cell_conn = torch.as_tensor(
            self.space.cells[faces[:, 0]], dtype=torch.long, device=self.device)
        face_G = tab.face_dN / h[None, None, None, :]  # (2dim, nqf, npc, dim)
        # (dim, nqf, npc, n_if)
        self.face_G_T = self._tensor(np.transpose(face_G[lf], (3, 1, 2, 0)))
        self.face_normal_T = self._tensor(np.transpose(tab.face_normal_ref[lf]))
        self.face_Nf = self._tensor(tab.face_N[0][:, tab.face_nodes[0]])
        areaJ = detJ / h[lf // 2]
        self.face_wJ_T = self._tensor(
            (tab.face_q_weights[None, :] * areaJ[:, None]).T)  # (nqf, n_if)
        fplan, _ = build_transpose_gather_plan(fnodes, self.space.n_nodes)
        self.face_plan = torch.as_tensor(fplan, device=self.device)

    def _external_force_gather(self, u: torch.Tensor,
                               stress: torch.Tensor) -> torch.Tensor:
        """The Nanson pull-back per interface face: the face cells' node
        values gathered, gradients, J F^{-T} N and the traction at the
        face quadrature points in the (nqf, n_if) component layout, and the
        face contributions reduced into the nodes by the faces' transpose-
        gather plan (the JAX package's `_external_force_gather`)."""
        dim = u.shape[-1]
        conn = self.face_cell_conn  # (n_if, npc)
        uc = [u[:, d][conn].T.detach() for d in range(dim)]  # (npc, n_if)
        npc = conn.shape[1]
        grad = [[sum(self.face_G_T[e, :, n, :] * uc[d][n][None, :]
                     for n in range(npc)) for e in range(dim)]
                for d in range(dim)]
        F = [[grad[i][j] + (1.0 if i == j else 0.0) for j in range(dim)]
             for i in range(dim)]
        Jf, F_inv = det_and_inv_c(F)
        n_star = [Jf * sum(F_inv[k][d] * self.face_normal_T[k][None, :]
                           for k in range(dim)) for d in range(dim)]
        scale = torch.sqrt(sum(n_star[d] ** 2 for d in range(dim)))
        tn = [stress[:, d][self.face_nodes].T for d in range(dim)]  # (npf, n_if)
        wscale = self.face_wJ_T * scale
        Nf = self.face_Nf
        rf = [Nf.T @ (wscale * (Nf @ tn[d])) for d in range(dim)]
        n_if, npf = self.face_nodes.shape
        rcell = torch.stack(rf, dim=-1).permute(1, 0, 2)  # (n_if, npf, dim)
        return apply_plan(rcell.reshape(n_if * npf, dim), self.face_plan)

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
            (self.n_rows, self.space.dim), dtype=self.dtype, device=self.device
        )
        return NonlinearState(z, z, z)

    def _norm_t(self, v: torch.Tensor) -> torch.Tensor:
        """l2 norm by an f32 reduction of the (f64) vector, as a 0-dim f64
        tensor: norms steer decisions only through ratios and thresholds
        (the JAX package's choice, kept for decision parity)."""
        v32 = v.to(torch.float32).reshape(-1)
        return torch.sqrt(self._dot(v32, v32)).to(torch.float64)

    # ------------------------------------------------------------------
    # the Newton loop
    # ------------------------------------------------------------------

    # the packed status read back once a Newton pass (`_newton_decide`);
    # `pass_J` is the pass's own min det F (the verbose table's)
    _STATUS = ("stall", "conv", "refresh", "want64", "calibrated", "n64",
               "n32", "res_abs", "res_rel", "upd_abs", "upd_rel", "min_J",
               "pass_J")

    def _newton_buffers(self, state, stress):
        """The Newton loop's static buffers (allocated at the first step):
        the step's inputs, the iterate, the residuals, and the loop's
        scalars as 0-dim f64 (bool for flags) tensors; the step's inputs
        are copied in."""
        b = self._nb
        if b is None:
            dev, f64 = self.device, torch.float64

            def scalar(dtype=f64):
                return torch.zeros((), dtype=dtype, device=dev)

            vec = state.displacement
            b = self._nb = types.SimpleNamespace(
                **{k: torch.empty_like(vec) for k in (
                    "disp", "vel", "acc", "delta", "du", "out64", "out32")},
                stress=torch.empty_like(stress),
                **{k: scalar() for k in (
                    "res0", "upd0", "res_abs", "res_rel", "upd_abs",
                    "upd_rel", "res_floor", "ratio_prev", "min_J", "n64",
                    "n32", "mJ64", "mJ32", "cg_tol")},
                calibrated=scalar(torch.bool), want64_next=scalar(torch.bool),
                tiny=torch.full((), 1e-300, dtype=f64, device=dev),
                floor_T=torch.full((), 5e-9, dtype=f64, device=dev),
                status=torch.zeros(len(self._STATUS), dtype=f64, device=dev),
            )
            b.state = NonlinearState(b.disp, b.vel, b.acc)
        for buf, t in zip((b.disp, b.vel, b.acc, b.stress), (*state, stress)):
            buf.copy_(t)
        return b

    def _newton_start(self, b):
        """The loop's initial values: the predictor iterate and the
        scalars the JAX package's loop starts from."""
        p = self.params
        if p.newton_predictor and not self.quasi_static:
            b.delta.copy_(self.mask * (
                p.delta_t * b.vel + (0.5 * p.delta_t**2) * b.acc))
        else:
            b.delta.zero_()
        for t in (b.res0, b.upd0, b.res_abs, b.res_rel, b.upd_abs, b.upd_rel,
                  b.ratio_prev):
            t.fill_(1.0)
        for t in (b.res_floor, b.n64, b.n32, b.calibrated, b.want64_next):
            t.zero_()
        b.min_J.fill_(math.inf)

    def _newton_residual(self, b, f64):
        """The f64 (`residual`) or solve-dtype (`_residual32`) residual at
        the iterate, into `out64`/`mJ64` or `out32`/`mJ32`."""
        fn = self.residual if f64 else self._residual32
        rhs, mJ = fn(b.delta, b.state, b.stress)
        out, m = (b.out64, b.mJ64) if f64 else (b.out32, b.mJ32)
        out.copy_(rhs)
        m.copy_(mJ)

    def _newton_decide(self, b, it0, was32, calib, redo, refresh_mode, mixed):
        """One pass's decisions after its residuals, on the device: the
        lines of the JAX package's loop body between the residual and the
        solve, on 0-dim f64 tensors (maximum and minimum propagate NaN as
        `jnp.maximum`/`jnp.minimum` do, the division is IEEE's). The
        flags the host knows select the lines: `it0`
        (iteration 0), `was32` (the pass evaluated in the solve dtype),
        `calib` (an f64 pass before the floor is calibrated, which also
        evaluated `out32`; u != 0 is tested here), `redo` (the f64
        re-evaluation after a stall; a `was32` pass that stalls commits
        nothing and asks for it), `refresh_mode` (True, False or "stale":
        tangent reuse's test). Commits the loop's scalars and writes the
        packed status (`_STATUS`)."""
        p, norm = self.params, self._norm_t
        stall = None  # a device flag only where a stall can occur
        calibrated, res_floor = b.calibrated, b.res_floor
        can_calib = None
        if mixed:
            res_abs0 = norm(b.out32 if was32 else b.out64)
            floor0 = res_floor
            if calib:
                u_nonzero = norm(b.disp + b.delta) > 0.0
                can_calib = ~calibrated & u_nonzero
                denom = res_abs0 if it0 else b.res0
                fl = norm(b.out32 - b.out64) / torch.maximum(denom, b.tiny)
                calib_ok = can_calib & torch.isfinite(fl)
                floor0 = torch.where(calib_ok, fl, res_floor)
                calibrated = calibrated | calib_ok
            res_floor = floor0
            if redo:
                fl = norm(b.out64 - b.out32) / torch.maximum(b.res0, b.tiny)
                res_floor = torch.where(torch.isfinite(fl),
                                        torch.maximum(fl, floor0), floor0)
                calibrated = torch.ones_like(calibrated)
                res_abs_new, mJ = norm(b.out64), b.mJ64
            else:
                if was32:
                    stall = ~(res_abs0 <= 0.5 * b.res_abs)
                res_abs_new, mJ = res_abs0, (b.mJ32 if was32 else b.mJ64)
            n64_inc = (0 if was32 else 1) + (1 if redo else 0)
            n32_inc = (1 if was32 else 0) + (
                can_calib.to(torch.float64) if calib else 0)
        else:
            res_abs_new, mJ = norm(b.out64), b.mJ64
            n64_inc, n32_inc = 1, 0
        res0 = torch.maximum(res_abs_new, b.tiny) if it0 else b.res0
        res_rel_new = res_abs_new / res0
        ratio = res_abs_new / b.res_abs
        if it0:
            eta = p.ew_eta0
        else:
            x = 0.9 * ratio * ratio
            eta = torch.where(torch.isnan(x), x, x.clamp(1e-4, 0.5))
        T = torch.maximum(p.tol_f * res0, b.floor_T)
        if p.newton_forcing == "ew":
            cg_tol = torch.maximum(eta * res_abs_new, 0.5 * T)
        else:
            cg_tol = p.tol_lin * res_abs_new
        want64_next = b.want64_next
        if mixed:  # pred equals cg_tol's expression
            want64_next = (cg_tol / res0
                           <= p.newton_residual_f64_window * res_floor)
        if it0:
            conv = torch.zeros((), dtype=torch.bool, device=self.device)
        else:
            conv = (((b.upd_rel <= p.tol_u) | (b.upd_abs <= 1e-15))
                    & ((res_rel_new <= p.tol_f) | (res_abs_new <= 5e-9)))
        if refresh_mode == "stale":
            refresh = ((ratio > 0.5 * b.ratio_prev)
                       & (ratio > p.tangent_refresh_ratio))
        else:
            refresh = torch.full((), bool(refresh_mode), device=self.device)
        if mixed:  # the next pass's precision (never iteration 0)
            want64 = (~calibrated
                      | (res_rel_new <= p.newton_residual_f64_window
                         * res_floor) | want64_next)
        else:
            want64 = torch.ones((), dtype=torch.bool, device=self.device)
        new = (
            (b.res0, res0), (b.res_abs, res_abs_new), (b.res_rel, res_rel_new),
            (b.res_floor, res_floor), (b.calibrated, calibrated),
            (b.want64_next, want64_next), (b.cg_tol, cg_tol),
            (b.ratio_prev, torch.where(conv, b.ratio_prev, ratio)),
            (b.min_J, torch.minimum(b.min_J, mJ)),
            (b.n64, b.n64 + n64_inc), (b.n32, b.n32 + n32_inc),
        )
        for dst, val in new:
            if stall is None:
                dst.copy_(val)
            else:  # a stalled pass commits nothing: the redo decides
                torch.where(stall, dst, val, out=dst)
        for i, val in enumerate((
                stall if stall is not None else False, conv, refresh, want64,
                b.calibrated, b.n64, b.n32, b.res_abs, b.res_rel, b.upd_abs,
                b.upd_rel, b.min_J, mJ)):
            if isinstance(val, torch.Tensor):
                b.status[i].copy_(val)
            else:
                b.status[i].fill_(float(val))

    def _newton_update(self, b, it0):
        """After a correction: its masked norm, the update ratios and
        `delta += du`."""
        upd_abs = self._norm_t(self.mask * b.du)
        if it0:
            b.upd0.copy_(torch.maximum(upd_abs, b.tiny))
        b.upd_rel.copy_(upd_abs / b.upd0)
        b.upd_abs.copy_(upd_abs)
        b.delta.add_(b.du)

    def _read_status(self, b) -> dict:
        self.host_syncs += 1
        return dict(zip(self._STATUS, b.status.tolist()))

    def _newton_solve(self, state: NonlinearState, stress: torch.Tensor):
        """The Newton loop (module docstring): each residual, tangent
        refill, decision and update goes through the model's runner
        (replayed from its CUDA graph under `cg_loop="graphs"` on the
        card, eager otherwise), the CG takes its tolerance as a device
        tensor, and the host reads one packed status a pass, which says
        what to run next (the residual's precision, the calibration, a
        stall's f64 re-evaluation, the tangent refresh, convergence); a
        stall costs a second read. `NewtonInfo` is built from the device's
        scalars. A calibrating pass whose status shows no f32 evaluation
        counted is one at u = 0 (`uncounted_f32_evals`)."""
        params = self.params
        use_cg = params.type_lin == "CG"
        # the cell partition evaluates in f64 only, as the JAX package's
        # shard_map mode does (it has no f32 residual)
        mixed = (use_cg and self._mixed_tangent and not self._cells
                 and params.newton_residual == "mixed")
        # modified Newton: keep the assembled tangent across iterations and
        # refresh it only for the first `tangent_reuse_after` iterations or
        # when it goes stale (the JAX package's rule)
        reuse = bool(params.newton_tangent_reuse and self._use_assembled
                     and use_cg and self._mixed_tangent)
        reuse_after = int(params.tangent_reuse_after)
        max_nr = int(params.max_iterations_NR)
        run = self._graphs
        b = self._newton_buffers(state, stress)
        run("start", lambda: self._newton_start(b))
        it, converged, cg_total, nasm = 0, False, 0, 0
        want64, calibrated = True, False
        st, n32 = None, 0
        while not converged and it < max_nr:
            it0 = it == 0
            was32 = mixed and not want64
            run(("residual", not was32),
                lambda: self._newton_residual(b, not was32))
            calib = mixed and not was32 and not calibrated
            if calib:
                run(("residual", False), lambda: self._newton_residual(b, False))
            refresh_mode = True
            if reuse:
                if it < reuse_after or self._tangent is None:
                    refresh_mode = True
                elif it > reuse_after:
                    refresh_mode = "stale"
                else:
                    refresh_mode = False
            flags = (it0, was32, calib, False, refresh_mode, mixed)
            run(("decide",) + flags, lambda: self._newton_decide(b, *flags))
            st = self._read_status(b)
            if calib:  # n32 grows by 1 exactly where u != 0
                self.uncounted_f32_evals += 1 - (int(st["n32"]) - n32)
            stalled = bool(st["stall"])
            if stalled:
                run(("residual", True), lambda: self._newton_residual(b, True))
                flags = (it0, was32, False, True, refresh_mode, mixed)
                run(("decide",) + flags, lambda: self._newton_decide(b, *flags))
                st = self._read_status(b)
            if self.verbose and self._lead:
                # the reference's per-iteration table
                # (`nonlinear_elasticity.cc:503-542`), the JAX package's line
                print(f"    NR it {it}: RES_F(abs) {st['res_abs']:.4e}  "
                      f"RES_F(rel) {st['res_rel']:.4e}  NU(rel) "
                      f"{st['upd_rel']:.4e}  min J {st['pass_J']:.4f}",
                      flush=True)
            n32 = int(st["n32"])
            converged = bool(st["conv"])
            if not converged:
                refresh = (bool(st["refresh"]) if refresh_mode == "stale"
                           else refresh_mode)
                rhs = b.out32 if was32 and not stalled else b.out64
                du, cg_its, asm_inc = self._solve(b.delta, b.state, b.stress,
                                                  rhs, b.cg_tol, refresh)
                b.du.copy_(du)
                run(("update", it0), lambda: self._newton_update(b, it0))
                it += 1
                cg_total += cg_its
                nasm += asm_inc
            want64, calibrated = bool(st["want64"]), bool(st["calibrated"])
        if st is None:  # no pass (max_iterations_NR < 1)
            st = dict(res_abs=1.0, res_rel=1.0, upd_abs=1.0, upd_rel=1.0,
                      min_J=math.inf, n64=0, n32=0)
        elif not converged:  # the last correction's update ratios
            self.host_syncs += 1
            st["upd_abs"], st["upd_rel"] = torch.stack(
                [b.upd_abs, b.upd_rel]).tolist()
        info = NewtonInfo(
            converged=converged, iterations=it, residual_abs=st["res_abs"],
            residual_rel=st["res_rel"], update_abs=st["upd_abs"],
            update_rel=st["upd_rel"], cg_iterations=cg_total,
            min_det_F=st["min_J"], f64_evals=int(st["n64"]),
            f32_evals=int(st["n32"]), tangent_assemblies=nasm,
        )
        return b.delta.clone(), info

    def _solve(self, delta, state, stress, rhs, cg_tol, refresh=True):
        """One Newton correction: (du, CG iterations, tangent assemblies).
        The first one builds the tangent's persistent buffers and the CG
        solve over them (`cg_loop`); every later one refills the buffers
        (assembles into the tangent buffer, or copies the jvp tangent's
        linearization point into its buffers) unless `refresh` is False, a
        frozen iteration of `newton_tangent_reuse`, which leaves them and
        so the captured CG graphs' operator as they are."""
        if self.params.type_lin != "CG":
            # the dense problem whole on every rank: the gathered right-hand
            # side, the one-device solve, this rank's rows of the solution
            A = self._dense_tangent(delta, state)
            b = self.global_rows(rhs)
            du = torch.linalg.solve(A, b.reshape(-1)).reshape(b.shape)
            return self.local_rows(du), 1, 1
        tdt = self.solve_dtype
        if self._use_assembled:
            # the assembly closure refers to the model and is not kept:
            # kept, it would make the model, its tangent and its CG graphs
            # a reference cycle that outlives `del model`
            assemble_Kt, make_tangent_matvec = self._make_tangent_fns()
            if self._tangent is None:
                Kt = assemble_Kt((state.displacement + delta).to(tdt))
                K = make_tangent_matvec(Kt)
                self._tangent = (Kt, self._make_cg(K))
            elif refresh:
                Kt = self._tangent[0]
                self._graphs("assemble", lambda: assemble_Kt(
                    (state.displacement + delta).to(tdt), out=Kt))
        elif self._tangent is None:
            refill, K = self._make_jvp_tangent(delta, state, stress)
            self._tangent = (refill, self._make_cg(K))
        else:
            refill = self._tangent[0]
            self._graphs("refill", lambda: refill(delta, state, stress))
        solve = self._tangent[1]
        r = solve(rhs.to(tdt), torch.zeros_like(rhs, dtype=tdt), cg_tol,
                  self._max_cg_iter)
        self.host_syncs += r.host_syncs
        self.cg_host_syncs += r.host_syncs
        return r.x.to(self.dtype), r.iterations, int(refresh)

    def _make_cg(self, K):
        """The CG solve over the tangent operator K, preconditioned as the
        parameters say; under `mg_fine_tangent` by a V-cycle whose fine
        level smooths K itself (`with_fine_operator`)."""
        precond = self._precond
        if self._mg_fine_tangent:
            tdt, pdt = self.solve_dtype, precond.dtype

            def fine_tangent_op(v):
                return K(v.to(tdt)).to(pdt)

            precond = precond.with_fine_operator(fine_tangent_op)
        return make_cg(self.cg_loop, K, precond, self.cg_chunk, self._dot,
                       self._pool)

    def _make_step(self):
        def step(state: NonlinearState, interface_stress: torch.Tensor):
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

        return step

    def step(
        self, state: NonlinearState, interface_stress: torch.Tensor
    ) -> Tuple[NonlinearState, NewtonInfo]:
        """One Newmark time step: Newton solve + velocity/acceleration
        updates. Checking `info.converged` is the caller's job."""
        return self.jittable_step()(state, interface_stress)

    def jittable_step(self):
        """The step function `(state, stress) -> (state, info)` that `step`
        runs (the JAX package's, which it wraps in `jax.jit`; the port has
        no such transform). "Jittable" means here: the function whose
        residuals, decisions, updates and CG chunks the model replays from
        its CUDA graphs under `cg_loop="graphs"`, and that every rank of a
        `device_mesh` calls in lockstep. The model does not hold it, so
        holding it keeps the model alive and dropping it frees nothing."""
        return self._make_step()

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
                device_mesh=self.device_mesh, verbose=self.verbose,
            )
        return cache[key]


def _cell_kernel(G, w, material, with_min=True):
    """The internal force on a cell block of the cell partition (`cells`,
    (cpd, npc)): (cpd * npc, dim) per-cell values, and min det F
    `with_min`."""

    def kernel(u, cells):
        cpd, npc = cells.shape
        ut = u[cells].permute(2, 1, 0)  # (dim, npc, cpd)
        rt, mJ = internal_force_cellwise_T(ut, G, w, material)
        r = rt.permute(2, 1, 0).reshape(cpd * npc, u.shape[-1])
        return (r, mJ) if with_min else r

    return kernel


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
