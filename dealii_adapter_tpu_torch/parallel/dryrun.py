"""`dryrun_multichip`: the production configuration on N ranks.

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`: one
Newmark step of the 3D Q2 Neo-Hookean flap at scale 2 (14,235 DoF) with
the production solver (MG with a bf16 V-cycle, f32 CG on the assembled
tangent, Eisenstat-Walker forcing, the Newmark predictor) on the lattice
partition over `n_devices` spawned ranks. The caller names the device;
nothing re-executes on the CPU by itself. On the card the kernels are
built once, before the ranks start, and each rank launches them on its
slab; a gloo world on the card runs its CG eagerly (`cg_loop="host"`),
an NCCL world (a card per rank) in CUDA graphs.

    python -c "from dealii_adapter_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2, 'cuda')"
"""

from __future__ import annotations

import numpy as np
import torch

from .partition import choose_backend, spawn


def flap_params(n_devices: int = 1):
    """The JAX package's `_flap_params(dim=3, degree=2, dtype="float64")`."""
    from ..config import AllParameters

    return AllParameters(
        model="neo-Hookean", type_lin="CG", scenario="PF", dim=3,
        poly_degree=2, delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0,
        tol_lin=1e-6, tol_u=1e-6, tol_f=1e-8, max_iterations_NR=8,
        dtype="float64", preconditioner="MG", precond_dtype="bfloat16",
        mg_smooth_degree=3, mg_fine_smooth_degree=1, solve_dtype="float32",
        newton_forcing="ew", ew_eta0=0.3, newton_predictor=True,
        use_pallas=True, n_devices=n_devices,
    )


def _rank_step(mesh, n_devices, scale):
    from ..kernels import counters
    from ..mesh.generator import make_scenario_grid
    from ..models.nonlinear_elasticity import NonlinearElasticity

    grid, tags = make_scenario_grid("PF", 3, 2, scale=scale, solver="neo-Hookean")
    loop = ("host" if mesh.backend == "gloo" and mesh.device.type == "cuda"
            else "graphs")
    model = NonlinearElasticity(flap_params(n_devices), mesh=grid, tags=tags,
                                device_mesh=mesh, cg_loop=loop)
    stress = np.zeros((model.space.n_nodes, 3))
    stress[model.space.boundary_nodes[model.interface_id], 0] = 1000.0
    stress = torch.as_tensor(stress, dtype=model.dtype, device=model.device)
    state0, load = model.initial_state(), model.local_rows(stress)
    # the step's own launches and collectives, not the build's (the
    # hierarchy's power iterations)
    counters.restart(model.device)
    for k in mesh.calls:
        mesh.calls[k] = 0
    state, info = model.step(state0, load)
    launches, calls = counters.launch_counts(), dict(mesh.calls)
    u = model.global_rows(state.displacement)
    return dict(info._asdict(), max_u=float(u.abs().max()), cg_loop=loop,
                backend=mesh.backend, n_dofs=model.space.n_dofs,
                calls=calls, launches=launches)


def dryrun_multichip(n_devices: int, device, scale: int = 2,
                     backend=None) -> dict:
    """One production step on `n_devices` spawned ranks on `device`
    ("cuda" or "cpu"), over `backend` (by default `choose_backend`'s:
    NCCL with a card per rank); asserts that Newton converged with det F
    > 0 everywhere, prints the JAX function's line, and returns rank 0's
    NewtonInfo fields with max|u|, the CG loop, the backend, the step's
    collectives and every rank's kernel launches in the step (`launches`,
    a list; the model build's are not counted)."""
    device = torch.device(device)
    if device.type == "cuda":
        from ..kernels import _build

        _build.load_library()  # build once, before the ranks start
    backend = backend or choose_backend(device, n_devices)
    out = spawn(_rank_step, n_devices, device, n_devices, scale,
                backend=backend)
    info = dict(out[0], launches=[o["launches"] for o in out])
    assert all(o["converged"] for o in out), "sharded Newton step did not converge"
    assert info["min_det_F"] > 0.0
    print(
        f"dryrun_multichip({n_devices}): OK — newton_its={info['iterations']}, "
        f"cg_its={info['cg_iterations']}, max|u|={info['max_u']:.3e}"
    )
    return info
