"""The PyTorch package's Neo-Hookean Newmark/Newton model against the JAX
package: residuals at a random state (f64 rtol 1e-12, f32 rtol 1e-5),
three production-configuration steps of the 3D flap, and the 2D
production configuration on the recorded golden tip trajectory."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.models.nonlinear_elasticity import (
    NonlinearElasticity as JaxModel,
)
from dealii_adapter_tpu.models.nonlinear_elasticity import (
    NonlinearState as JaxState,
)
from dealii_adapter_tpu_torch.convert import (
    params_from_jax,
    state_from_numpy,
    state_to_numpy,
)
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
)

torch.set_num_threads(1)
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_trajectories.json")

# bench.py's production configuration (at scale 1: 2,331 DoF in 3D)
PRODUCTION = dict(
    model="neo-Hookean", type_lin="CG", scenario="PF", poly_degree=2,
    delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0, tol_lin=1e-6, tol_u=1e-6,
    tol_f=1e-9, max_iterations_lin=1.0, dtype="float64",
    preconditioner="MG", precond_dtype="bfloat16", solve_dtype="float32",
    newton_forcing="ew", mg_smooth_degree=3, mg_fine_smooth_degree=1,
    newton_predictor=True, ew_eta0=0.3, use_pallas=True,
)


def _stress(n_nodes, dim, iface, magnitude):
    s = np.zeros((n_nodes, dim))
    s[iface, 0] = magnitude
    return s


@pytest.fixture(scope="module")
def models_3d():
    """The JAX and ported 3D production models; the port takes the JAX
    hierarchy's lam_max values (its own come from another start vector)."""
    jp = JaxParams(dim=3, max_iterations_NR=10, **PRODUCTION)
    jm = JaxModel(jp)
    tm = NonlinearElasticity(
        params_from_jax(jp),
        mg_lam_max=[lv.lam_max for lv in jm._precond.levels], device="cpu",
    )
    return jm, tm


def test_residuals_match_jax(models_3d):
    jm, tm = models_3d
    rng = np.random.default_rng(0)
    n, dim = tm.space.n_nodes, 3
    fields = [1e-4 * rng.standard_normal((n, dim)) for _ in range(4)]
    u, v, a, delta = fields
    a = 1e3 * a
    stress = _stress(n, dim, tm.space.boundary_nodes[tm.interface_id], 1e3)
    js = JaxState(jnp.asarray(u), jnp.asarray(v), jnp.asarray(a))
    ts = state_from_numpy(u, v, a, device="cpu")
    for name, rtol in (("residual", 1e-12), ("_residual32", 1e-5)):
        rj, mj = jax.jit(getattr(jm, name))(
            jnp.asarray(delta), js, jnp.asarray(stress)
        )
        rt, mt = getattr(tm, name)(
            torch.as_tensor(delta), ts, torch.as_tensor(stress)
        )
        rj = np.asarray(rj)
        assert rt.dtype == torch.float64 and np.isfinite(rj).all()
        np.testing.assert_allclose(rt.numpy(), rj, rtol=rtol,
                                   atol=rtol * np.abs(rj).max())
        np.testing.assert_allclose(float(mt), float(mj), rtol=rtol)


def test_production_steps_3d_match_jax(models_3d):
    """Three Newmark steps: same Newton iterations, CG totals within +-2
    per step, max |u| and ||u||^2 within rtol 1e-5."""
    jm, tm = models_3d
    stress = _stress(tm.space.n_nodes, 3,
                     tm.space.boundary_nodes[tm.interface_id], 1000.0)
    js, ts = jm.initial_state(), tm.initial_state()
    for _ in range(3):
        js, ji = jm.step(js, jnp.asarray(stress))
        ts, ti = tm.step(ts, torch.as_tensor(stress))
        assert bool(ji.converged) and ti.converged
        assert ti.iterations == int(ji.iterations)
        assert abs(ti.cg_iterations - int(ji.cg_iterations)) <= 2
        uj = np.asarray(js.displacement)
        ut = state_to_numpy(ts)[0]
        np.testing.assert_allclose(np.abs(ut).max(), np.abs(uj).max(), rtol=1e-5)
        np.testing.assert_allclose((ut * ut).sum(), (uj * uj).sum(), rtol=1e-5)
    assert ti.tangent_assemblies == int(ji.tangent_assemblies)
    assert ti.f64_evals + ti.f32_evals >= ti.iterations


@pytest.mark.parametrize("solver", ["production", "direct"])
def test_2d_on_golden_trajectory(solver):
    """The production path (EW forcing, predictor, f32 CG, bf16 MG) and the
    dense Direct solve on the 2D flap land on the recorded `nonlinear_pf_q2`
    trajectory, at the tolerance of the JAX package's own production-config
    golden test."""
    kw = dict(PRODUCTION, max_iterations_lin=10.0)
    if solver == "direct":
        kw.update(type_lin="Direct", preconditioner="Jacobi", solve_dtype="")
    p = params_from_jax(JaxParams(
        dim=2, max_iterations_NR=12, mg_coarse_size=4000, **kw
    ))
    model = NonlinearElasticity(p, device="cpu")
    nodes = model.space.mesh.nodes
    target = np.zeros(2)
    target[1] = nodes[:, 1].max()
    tip = int(np.argmin(((nodes - target) ** 2).sum(axis=1)))
    stress = torch.as_tensor(_stress(
        model.space.n_nodes, 2, model.space.boundary_nodes[model.interface_id],
        5000.0,
    ))
    state = model.initial_state()
    traj = []
    for _ in range(5):
        state, info = model.step(state, stress)
        assert info.converged
        traj.append(float(state.displacement[tip, 0]))
    with open(GOLDEN_PATH) as fh:
        golden = json.load(fh)["nonlinear_pf_q2"][:5]
    np.testing.assert_allclose(traj, golden, rtol=2e-5)


def test_transient_nan_f32_residual_keeps_a_finite_floor():
    """A NaN f32 residual mid-step hands back to f64 (NaN-safe stall test)
    and the re-calibration keeps the last finite noise floor, so the step
    converges to the same solution with the same Newton iterations."""
    p = params_from_jax(JaxParams(
        dim=2, max_iterations_NR=12, **dict(PRODUCTION, max_iterations_lin=10.0),
    ))

    def run(nan_call):
        model = NonlinearElasticity(p, device="cpu")
        f32_residual, calls = model._residual32, [0]

        def residual32(*args):
            calls[0] += 1
            rhs, min_j = f32_residual(*args)
            return (rhs * float("nan") if calls[0] == nan_call else rhs), min_j

        model._residual32 = residual32
        stress = torch.as_tensor(_stress(
            model.space.n_nodes, 2,
            model.space.boundary_nodes[model.interface_id], 5000.0,
        ))
        state, its = model.initial_state(), []
        for _ in range(2):
            state, info = model.step(state, stress)
            assert info.converged
            its.append(info.iterations)
        return state.displacement.numpy(), its

    u_ref, its_ref = run(nan_call=0)
    # f32 call 3 is step 1's floor calibration, call 4 its first f32 iterate
    for nan_call in (3, 4):
        u_nan, its_nan = run(nan_call)
        assert its_nan == its_ref, nan_call
        np.testing.assert_allclose(u_nan, u_ref, rtol=1e-6, atol=1e-9)
