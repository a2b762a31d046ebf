"""The Neo-Hookean Newton loop with its decisions on the device
(`newton_loop="graphs"`; on the CPU its residuals, refills, decisions and
updates run eagerly) against the host loop (`newton_loop="host"`): the
same `NewtonInfo` and the same iterate bit for bit, with one read-back a
Newton pass outside the CG, on the 3D benchmark configuration at scale 1
(2,331 DoF) under f64 residuals, the mixed schedule through a stall,
tangent reuse at traction 30,000 (two stalls), the jvp tangent and the
gather backend; and the JAX package's counts where the host loop has
them."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_adapter_tpu.models.nonlinear_elasticity as jax_nl
from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
)

torch.set_num_threads(1)

# bench.py's production configuration
PRODUCTION = dict(
    model="neo-Hookean", type_lin="CG", scenario="PF", dim=3, poly_degree=2,
    delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0, tol_lin=1e-6, tol_u=1e-6,
    tol_f=1e-9, max_iterations_NR=10, max_iterations_lin=1.0,
    dtype="float64", preconditioner="MG", precond_dtype="bfloat16",
    solve_dtype="float32", newton_forcing="ew", mg_smooth_degree=3,
    mg_fine_smooth_degree=1, newton_predictor=True, ew_eta0=0.3,
)
# (traction, steps, parameters, stalls the device loop must meet)
CASES = {
    "f64_residuals": (1000.0, 2, dict(newton_residual="f64"), 0),
    "mixed_stall": (20000.0, 3, dict(max_iterations_NR=12), 1),
    "reuse_30000": (30000.0, 2, dict(newton_tangent_reuse=True,
                                     max_iterations_NR=12,
                                     max_iterations_lin=10.0), 2),
    "jvp": (1000.0, 2, dict(tangent_backend="jvp"), 0),
    "gather": (1000.0, 2, dict(element_backend="gather"), 0),
}


@pytest.fixture(scope="module")
def mesh_tags():
    return make_scenario_grid("PF", 3, 2, scale=1, solver="neo-Hookean")


def _stress(model, magnitude):
    s = np.zeros((model.space.n_nodes, 3))
    s[model.space.boundary_nodes[model.interface_id], 0] = magnitude
    return s


def _models(mesh_tags, kw):
    params = AllParameters(**dict(PRODUCTION, **kw))
    mesh, tags = mesh_tags
    host = NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu",
                               newton_loop="host")
    lam = ([lv.lam_max for lv in host._precond.levels]
           if params.preconditioner == "MG" else None)
    dev = NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu",
                              mg_lam_max=lam)
    assert (host.newton_loop, dev.newton_loop) == ("host", "graphs")
    return host, dev


def _record(model):
    """Counts of the device loop's passes: [decisions, stall redos, CG
    read-backs, f64 residuals, solve-dtype residuals]."""
    counts = [0, 0, 0, 0, 0]
    decide, solve = model._newton_decide, model._solve
    residual = model._newton_residual

    def recorded_residual(b, f64):
        counts[3 if f64 else 4] += 1
        return residual(b, f64)

    def recorded_decide(b, *flags):
        counts[0] += 1
        counts[1] += bool(flags[3])
        return decide(b, *flags)

    def recorded_solve(*args):
        syncs = model.host_syncs
        out = solve(*args)
        counts[2] += model.host_syncs - syncs
        return out

    model._newton_decide, model._solve = recorded_decide, recorded_solve
    model._newton_residual = recorded_residual
    return counts


@pytest.mark.parametrize("case", list(CASES))
def test_device_newton_loop_equals_the_host_loop(mesh_tags, case):
    traction, n_steps, kw, stalls = CASES[case]
    host, dev = _models(mesh_tags, kw)
    counts = _record(dev)
    stress = torch.as_tensor(_stress(host, traction))
    sh, sd = host.initial_state(), dev.initial_state()
    for _ in range(n_steps):
        syncs, (decided, redos, cg_syncs, n64, n32) = dev.host_syncs, counts[:]
        uncounted = dev.uncounted_f32_evals
        sh, ih = host.step(sh, stress)
        sd, idev = dev.step(sd, stress)
        assert ih.converged
        assert idev == ih
        assert all(torch.equal(a, b) for a, b in zip(sd, sh))
        # one read-back a pass outside the CG, one more a stall
        passes = counts[0] - decided - (counts[1] - redos)
        outside = dev.host_syncs - syncs - (counts[2] - cg_syncs)
        assert passes == ih.iterations + 1
        assert outside == passes + counts[1] - redos
        # the residuals evaluated are the ones counted, the solve-dtype
        # ones discarded at u = 0 apart
        assert counts[3] - n64 == ih.f64_evals
        assert counts[4] - n32 == (ih.f32_evals
                                   + dev.uncounted_f32_evals - uncounted)
    assert counts[1] == stalls
    # only the calibrating pass at rest, step 0's first, evaluates a
    # residual it does not count, and only under the mixed schedule
    mixed = dev.params.newton_residual == "mixed" and dev._mixed_tangent
    assert dev.uncounted_f32_evals == int(mixed and not dev._cells)


def test_device_newton_loop_counts_match_jax():
    """The 2D flap at scale 1 under the mixed schedule at traction 1000
    (2D: the JAX package's step compiles in a third of the 3D one's time):
    the device loop's Newton, f64 and f32 counts equal the JAX package's
    in every step, as the host loop's do (tests/test_torch_nonlinear.py),
    and the fields agree to 1e-9."""
    params = dict(PRODUCTION, dim=2)
    jmesh, jtags = jax_grid("PF", 2, 2, scale=1, solver="neo-Hookean")
    jm = jax_nl.NonlinearElasticity(JaxParams(**params), mesh=jmesh,
                                    tags=jtags)
    mesh, tags = make_scenario_grid("PF", 2, 2, scale=1, solver="neo-Hookean")
    tm = NonlinearElasticity(
        AllParameters(**params), mesh=mesh, tags=tags, device="cpu",
        mg_lam_max=[lv.lam_max for lv in jm._precond.levels])
    assert tm.newton_loop == "graphs"
    stress = np.zeros((tm.space.n_nodes, 2))
    stress[tm.space.boundary_nodes[tm.interface_id], 0] = 1000.0
    js, ts = jm.initial_state(), tm.initial_state()
    for _ in range(2):
        js, ji = jm.step(js, jnp.asarray(stress))
        ts, ti = tm.step(ts, torch.as_tensor(stress))
        assert bool(ji.converged) and ti.converged
        assert (ti.iterations, ti.f64_evals, ti.f32_evals) == (
            int(ji.iterations), int(ji.f64_evals), int(ji.f32_evals))
        np.testing.assert_allclose(ts.displacement.numpy(),
                                   np.asarray(js.displacement), rtol=0,
                                   atol=1e-9 * np.abs(js.displacement).max())


def test_newton_loop_option(mesh_tags):
    """`newton_loop` follows `cg_loop` by default; "graphs" beside the host
    CG loop, and an unknown loop, raise."""
    mesh, tags = mesh_tags
    params = AllParameters(**PRODUCTION)
    host = NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu",
                               cg_loop="host")
    assert host.newton_loop == "host"
    assert host.with_delta_t(0.02).newton_loop == "host"
    with pytest.raises(ValueError, match="needs cg_loop='graphs'"):
        NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu",
                            cg_loop="host", newton_loop="graphs")
    with pytest.raises(ValueError, match="unknown newton_loop"):
        NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu",
                            newton_loop="device")
