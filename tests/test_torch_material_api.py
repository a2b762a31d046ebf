"""The port's public model and material functions against the JAX
package's on the CPU, in 2D and 3D, on the same seeded numpy inputs: the
batched `det_and_inv`, `kinematics`, `NeoHookean.psi` and `NeoHookean.tau`
(within f64 roundoff, `RTOL`; the component-wise hot-path forms agree
with them); tau = P F^T with P = dPsi/dF by `torch.autograd` (the port of
tests/test_nonlinear.py's energy-conjugacy test); the derivative of
`NonlinearElasticity.internal_force` by `torch.func.jvp` at u = 0 equal to
the linear stiffness with the small-strain moduli (the port of its
small-strain test) and to the JAX package's `jax.linearize`, and at a
non-zero u to the assembled tangent's matvec;
`LinearElastodynamics.masked_operator`; and `jittable_step()` equal to
`step()` bit for bit on both models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu.models import material as jmat
from dealii_adapter_tpu.models.linear_elasticity import (
    LinearElastodynamics as JaxLinear,
)
from dealii_adapter_tpu.models.nonlinear_elasticity import (
    NonlinearElasticity as JaxNonlinear,
)
from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.models import material as tmat
from dealii_adapter_tpu_torch.models.linear_elasticity import (
    LinearElastodynamics,
)
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
)
from dealii_adapter_tpu_torch.ops.element_ops import (
    ElementMatrices,
    make_operator,
)

torch.set_num_threads(1)
MU, NU, RHO = 0.5e6, 0.4, 1000.0
RTOL = 1e-12  # f64 roundoff of a few dozen operations a value
DIMS = [2, 3]
# tests/test_nonlinear.py's solver, Q1 (its small-strain test's degree)
NL = dict(scenario="PF", model="neo-Hookean", mu=MU, nu=NU, rho=RHO,
          poly_degree=1, delta_t=0.01, type_lin="CG", tol_lin=1e-6,
          max_iterations_lin=10.0, max_iterations_NR=12)
LIN = dict(scenario="PF", model="linear", mu=MU, nu=NU, rho=RHO,
           poly_degree=2, delta_t=0.01, type_lin="CG")


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _grad_u(dim, seed=7, n=6):
    """n seeded (dim, dim) displacement gradients, as numpy."""
    return 0.2 * np.random.default_rng(seed).normal(size=(n, dim, dim))


def _nonlinear(dim, **kw):
    """(the JAX package's, the port's) NonlinearElasticity of `NL` on the
    scale-1 flap."""
    p = dict(NL, dim=dim, **kw)
    jmesh, jtags = jax_grid("PF", dim, 1, scale=1, solver="neo-Hookean")
    mesh, tags = make_scenario_grid("PF", dim, 1, scale=1, solver="neo-Hookean")
    return (JaxNonlinear(JaxParams(**p), mesh=jmesh, tags=jtags),
            NonlinearElasticity(AllParameters(**p), mesh=mesh, tags=tags,
                                device="cpu"))


@pytest.mark.parametrize("dim", DIMS)
def test_det_and_inv_and_kinematics_match_jax(dim):
    """`det_and_inv` and `kinematics` on (n, dim, dim) batches: the JAX
    package's values within `RTOL`, the determinant and inverse numpy's
    within 1e-10, and b_bar unimodular."""
    g = _grad_u(dim)
    F = g + np.eye(dim)
    det, inv = tmat.det_and_inv(torch.as_tensor(F))
    jdet, jinv = jmat.det_and_inv(jnp.asarray(F))
    _close(det, jdet)
    _close(inv, jinv)
    np.testing.assert_allclose(det.numpy(), np.linalg.det(F), rtol=1e-10)
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(F), rtol=1e-10)
    ours = tmat.kinematics(torch.as_tensor(g))
    theirs = jmat.kinematics(jnp.asarray(g))
    for a, b in zip(ours, theirs):
        _close(a, b)
    detb, _ = tmat.det_and_inv(ours[3])
    np.testing.assert_allclose(detb.numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("dim", DIMS)
def test_psi_and_tau_match_jax(dim):
    """`psi` and `tau` on the same batch as the JAX package's within
    `RTOL`; the hot path's component-wise `tau_c` (with `kinematics_c`)
    gives the batched `tau` within `RTOL`; both vanish at F = I."""
    g = _grad_u(dim, seed=3)
    mat, jm = tmat.NeoHookean(MU, NU, RHO), jmat.NeoHookean(MU, NU, RHO)
    _, J, _, b_bar = tmat.kinematics(torch.as_tensor(g))
    _, jJ, _, jb_bar = jmat.kinematics(jnp.asarray(g))
    _close(mat.psi(J, b_bar), jm.psi(jJ, jb_bar))
    tau = mat.tau(J, b_bar)
    _close(tau, jm.tau(jJ, jb_bar))
    gc = [[torch.as_tensor(g[:, i, j]) for j in range(dim)] for i in range(dim)]
    _, Jc, _, bc = tmat.kinematics_c(gc)
    tc = mat.tau_c(Jc, bc)
    _close(torch.stack([torch.stack(row, -1) for row in tc], -2), tau)
    _, J0, _, b0 = tmat.kinematics(torch.zeros(dim, dim, dtype=torch.float64))
    assert float(mat.psi(J0, b0)) == 0.0
    np.testing.assert_allclose(mat.tau(J0, b0).numpy(), 0.0, atol=1e-9)


@pytest.mark.parametrize("dim", DIMS)
def test_tau_is_energy_conjugate(dim):
    """tau = P F^T with P = dPsi/dF by `torch.autograd` of the port's own
    strain energy (rtol 1e-9, atol 1e-6, as the JAX package's test), and
    tau is symmetric."""
    mat = tmat.NeoHookean(MU, NU, RHO)
    g = torch.as_tensor(_grad_u(dim, seed=7, n=1)[0])
    F = (g + torch.eye(dim, dtype=torch.float64)).requires_grad_(True)
    J, _ = tmat.det_and_inv(F)
    b_bar = J ** (-2.0 / dim) * (F @ F.T)
    (P,) = torch.autograd.grad(mat.psi(J, b_bar), F)
    tau_ad = (P @ F.T).detach()
    _, J, _, b_bar = tmat.kinematics(g)
    tau = mat.tau(J, b_bar)
    np.testing.assert_allclose(tau_ad.numpy(), tau.numpy(), rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(tau.numpy(), tau.numpy().T, atol=1e-8)


@pytest.mark.parametrize("dim", DIMS)
def test_internal_force_linearization(dim):
    """`internal_force` against the JAX package's at a seeded u (`RTOL`);
    its `torch.func.jvp` at u = 0 equals the linear stiffness with the
    small-strain moduli (lambda_eff = kappa - 2 mu / dim; rtol 1e-9, atol
    1e-3, as the JAX package's test) and the JAX package's
    `jax.linearize` (`RTOL`); at a non-zero u, masked as the CG's operator,
    the assembled f64 tangent's matvec (1e-10 of the largest entry)."""
    jm, tm = _nonlinear(dim)
    space, n = tm.space, tm.space.n_nodes
    rng = np.random.default_rng(3)
    v = rng.normal(size=(n, dim))
    u = 1e-3 * rng.normal(size=(n, dim))
    _close(tm.internal_force(torch.as_tensor(u)),
           jm.internal_force(jnp.asarray(u)))
    zero = torch.zeros(n, dim, dtype=torch.float64)
    _, jvp0 = torch.func.jvp(tm.internal_force, (zero,), (torch.as_tensor(v),))
    _, jlin = jax.linearize(jm.internal_force, jnp.zeros((n, dim)))
    _close(jvp0, jlin(jnp.asarray(v)))
    lam_eff = tm.material.kappa - 2 * MU / dim
    K = make_operator(space, ElementMatrices(space, lam_eff, MU, RHO).K_e,
                      device="cpu")
    np.testing.assert_allclose(jvp0.numpy(), K(torch.as_tensor(v)).numpy(),
                               rtol=1e-9, atol=1e-3)
    # the CG's operator at u: the f64 assembled tangent (no inertia)
    qs = NonlinearElasticity(
        AllParameters(**dict(NL, dim=dim, solve_dtype="")), mesh=tm.mesh,
        tags=tm.tags, quasi_static=True, device="cpu")
    assemble_Kt, make_matvec = qs._make_tangent_fns()
    ut, vt = torch.as_tensor(u), torch.as_tensor(v)
    Kv = make_matvec(assemble_Kt(ut))(vt)
    mask = qs.mask
    _, jv = torch.func.jvp(qs.internal_force, (ut,), (mask * vt,))
    want = mask * jv + (1.0 - mask) * vt
    np.testing.assert_allclose(Kv.numpy(), want.numpy(), rtol=0,
                               atol=1e-10 * np.abs(want.numpy()).max())


@pytest.mark.parametrize("dim", DIMS)
def test_masked_operator_matches_jax(dim):
    """`LinearElastodynamics.masked_operator` of the model's stiffness:
    the JAX package's within `RTOL`, identity on the constrained rows."""
    p = dict(LIN, dim=dim)
    jmesh, jtags = jax_grid("PF", dim, 2, scale=1, solver="linear")
    mesh, tags = make_scenario_grid("PF", dim, 2, scale=1, solver="linear")
    jm = JaxLinear(JaxParams(**p), mesh=jmesh, tags=jtags)
    tm = LinearElastodynamics(AllParameters(**p), mesh=mesh, tags=tags,
                              device="cpu")
    v = np.random.default_rng(5).normal(size=(tm.space.n_nodes, dim))
    got = tm.masked_operator(tm.K)(torch.as_tensor(v))
    _close(got, jm.masked_operator(jm.K)(jnp.asarray(v)))
    fixed = tm.mask.numpy() == 0.0
    assert fixed.any()
    np.testing.assert_array_equal(got.numpy()[fixed], v[fixed])


@pytest.mark.parametrize("dim", DIMS)
def test_jittable_step_equals_step(dim):
    """`jittable_step()(state, data)` equals `step(state, data)` bit for
    bit on both models (a step from rest)."""
    _, nl = _nonlinear(dim)
    mesh, tags = make_scenario_grid("PF", dim, 2, scale=1, solver="linear")
    lin = LinearElastodynamics(AllParameters(**dict(LIN, dim=dim)), mesh=mesh,
                               tags=tags, device="cpu")
    for model in (nl, lin):
        s = np.zeros((model.space.n_nodes, dim))
        s[model.space.boundary_nodes[model.interface_id], 0] = 1000.0
        data = torch.as_tensor(s)
        state = model.initial_state()
        a, ia = model.step(state, data)
        b, ib = model.jittable_step()(state, data)
        assert ia == ib
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert a[0].abs().max() > 0
