"""The PyTorch package's `element_backend="gather"` against the JAX
package's, on one device (the CPU): the gather-plan operators K, M and A
of `ops/element_ops.py` and their diagonals (rtol 1e-12: the same sums in
another order), a linear step in 2D and in 3D at scale 2 and a
Neo-Hookean step in 2D and in 3D against the JAX package's gather step
(the tolerances of tests/test_sharding.py; the 3D Neo-Hookean step on
the scenario's own 2,331-DoF mesh, since the JAX package's gather step
with multigrid compiles for over a minute at scale 2), and the Neumann
pull-back of a mesh whose
interface covers only part of a lattice side, which takes the gather
formulation on every backend (rtol 1e-12 against the JAX package's
`_external_force_gather`). Inputs come from numpy seeds."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxSpace
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu.models.linear_elasticity import (
    LinearElastodynamics as JaxLinear,
)
from dealii_adapter_tpu.models.nonlinear_elasticity import (
    NonlinearElasticity as JaxNonlinear,
)
from dealii_adapter_tpu.ops.element_ops import (
    ElementMatrices as JaxElementMatrices,
    make_operator as jax_make_operator,
)
from dealii_adapter_tpu_torch.convert import params_from_jax
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
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

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(2)

LINEAR = dict(model="linear", type_lin="CG", scenario="PF", delta_t=0.01,
              poly_degree=2, mu=0.5e6, nu=0.4, rho=1000.0,
              element_backend="gather")
# tests/test_sharding.py's Neo-Hookean case (2D Q1, f64 Jacobi CG)
NONLINEAR_2D = dict(model="neo-Hookean", type_lin="CG", scenario="PF",
                    delta_t=0.01, poly_degree=1, mu=0.5e6, nu=0.4, rho=1000.0,
                    tol_lin=1e-8, element_backend="gather")
# the production solver (the JAX package's dryrun configuration) in 3D Q2
PRODUCTION_3D = dict(model="neo-Hookean", type_lin="CG", scenario="PF", dim=3,
                     poly_degree=2, delta_t=0.01, mu=0.5e6, nu=0.4,
                     rho=1000.0, tol_lin=1e-6, tol_u=1e-6, tol_f=1e-8,
                     max_iterations_NR=8, preconditioner="MG",
                     precond_dtype="bfloat16", solve_dtype="float32",
                     newton_forcing="ew", ew_eta0=0.3, newton_predictor=True,
                     mg_smooth_degree=3, mg_fine_smooth_degree=1,
                     element_backend="gather")


@contextlib.contextmanager
def _jax_takes_lam_max(values):
    """The JAX package's multigrid hierarchies built inside take `values`
    (one per level, fine first) in place of their power iterations (in 3D
    ~10 s of XLA compilation and run a hierarchy on the CPU)."""
    from dealii_adapter_tpu.solvers import cg as jcg

    it = iter(values)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcg, "estimate_lambda_max", lambda *a, **k: next(it))
        yield


def _stress(space, interface_id, magnitude):
    s = np.zeros((space.n_nodes, space.dim))
    s[space.boundary_nodes[interface_id], 0] = magnitude
    return s


@pytest.mark.parametrize("dim,degree", [(2, 2), (3, 2)])
@pytest.mark.parametrize("matrix", ["K", "M", "A"])
def test_gather_operators_match_jax(dim, degree, matrix):
    """K, M and A = M + (theta dt)^2 K through the gather plan, and their
    diagonals, against the JAX package's `make_operator` (rtol 1e-12)."""
    jm, _ = jax_grid("PF", dim, degree, solver="linear")
    tm, _ = make_scenario_grid("PF", dim, degree, solver="linear")
    js, ts = JaxSpace.create(jm), DofSpace.create(tm)
    je = JaxElementMatrices(js, 1.2e6, 0.5e6, 1000.0)
    te = ElementMatrices(ts, 1.2e6, 0.5e6, 1000.0)
    pick = {"K": lambda e: e.K_e, "M": lambda e: e.M_e,
            "A": lambda e: e.M_e + (0.5 * 0.01) ** 2 * e.K_e}[matrix]
    jop = jax_make_operator(js, np.asarray(pick(je)))
    top = make_operator(ts, pick(te), torch.float64, "cpu")
    u = np.random.default_rng(dim * 10 + degree).standard_normal((js.n_nodes, dim))
    np.testing.assert_allclose(top(torch.as_tensor(u)).numpy(),
                               np.asarray(jop(jnp.asarray(u))),
                               rtol=1e-12, atol=1e-12 * np.abs(pick(te)).max())
    np.testing.assert_allclose(top.diagonal().numpy(),
                               np.asarray(jop.diagonal()), rtol=1e-12)


@pytest.mark.parametrize("dim,scale", [(2, None), (3, 2)])
def test_gather_linear_step_matches_jax(dim, scale):
    """The linear theta-step on the gather backend (f64 Jacobi CG) against
    the JAX package's: displacement rtol 1e-9 (atol 1e-14), CG within 2."""
    kw = dict(LINEAR, dim=dim)
    jp = JaxParams(**kw)
    mesh_kw = {} if scale is None else dict(scale=scale)
    jmesh, jtags = jax_grid("PF", dim, 2, solver="linear", **mesh_kw)
    tmesh, ttags = make_scenario_grid("PF", dim, 2, solver="linear", **mesh_kw)
    jm = JaxLinear(jp, mesh=jmesh, tags=jtags)
    tm = LinearElastodynamics(params_from_jax(jp), mesh=tmesh, tags=ttags,
                              device="cpu")
    assert tm.K.plan is not None
    st = _stress(tm.space, tm.interface_id, 1000.0)
    sj, ij = jm.step(jm.initial_state(), jnp.asarray(st))
    s, i = tm.step(tm.initial_state(), torch.as_tensor(st))
    assert abs(i.iterations - int(ij.iterations)) <= 2
    np.testing.assert_allclose(s.displacement.numpy(),
                               np.asarray(sj.displacement), rtol=1e-9, atol=1e-14)


@pytest.mark.parametrize("case", ["2d", "3d_production"])
def test_gather_nonlinear_step_matches_jax(case):
    """The Neo-Hookean step on the gather backend (its jvp tangent) against
    the JAX package's gather step: Newton counts equal, CG within 2 a
    Newton iteration; 2D (f64 Jacobi CG) to rtol 1e-7 (atol 1e-12), the 3D
    production solver (f32 CG, bf16 V-cycle, both hierarchies on the
    port's lam_max estimates) to 1e-8 of max|u| (tests/test_sharding.py's)."""
    if case == "2d":
        jp = JaxParams(**NONLINEAR_2D)
        jm = JaxNonlinear(jp)
        tm = NonlinearElasticity(params_from_jax(jp), device="cpu")
        mag = 5000.0
    else:
        jp = JaxParams(**PRODUCTION_3D)
        tm = NonlinearElasticity(params_from_jax(jp), device="cpu")
        lam = [lv.lam_max for lv in tm._precond.levels]
        with _jax_takes_lam_max(lam):
            jm = JaxNonlinear(jp)
        assert [lv.lam_max for lv in jm._precond.levels] == lam
        mag = 1000.0
    assert tm.plan is not None and not tm._use_assembled
    st = _stress(tm.space, tm.interface_id, mag)
    sj, ij = jm.step(jm.initial_state(), jnp.asarray(st))
    s, i = tm.step(tm.initial_state(), torch.as_tensor(st))
    assert bool(ij.converged) and i.converged
    assert i.iterations == int(ij.iterations)
    assert abs(i.cg_iterations - int(ij.cg_iterations)) <= 2 * i.iterations
    ref = np.asarray(sj.displacement)
    if case == "2d":
        np.testing.assert_allclose(s.displacement.numpy(), ref, rtol=1e-7,
                                   atol=1e-12)
    else:
        np.testing.assert_allclose(s.displacement.numpy(), ref, rtol=0,
                                   atol=1e-8 * np.abs(ref).max())


def _partial_interface(mesh, interface_id):
    """The mesh with the interface faces of each side whose cell lies in
    the upper half of the side's cells relabelled to another id, so that
    the interface covers only part of its lattice sides."""
    faces = mesh.boundary_faces[interface_id]
    keep = np.zeros(len(faces), dtype=bool)
    for f in np.unique(faces[:, 1]):
        idx = np.nonzero(faces[:, 1] == f)[0]
        keep[idx[: len(idx) // 2]] = True
    bf = dict(mesh.boundary_faces)
    bf[interface_id] = faces[keep]
    bf[99] = faces[~keep]
    return dataclasses.replace(mesh, boundary_faces=bf)


@pytest.mark.parametrize("backend", ["auto", "gather"])
def test_partial_side_neumann_matches_jax_gather(backend):
    """An interface covering only part of its lattice sides: the port's
    model takes the gather pull-back on either backend (the JAX package's
    fallback rule), and its `external_force` at a seeded deformation and
    traction equals the JAX package's `_external_force_gather` (rtol
    1e-12); a whole step on it (f32 CG, f32 V-cycle) runs and converges."""
    kw = dict(model="neo-Hookean", type_lin="CG", scenario="PF", dim=3,
              poly_degree=2, delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0,
              element_backend=backend)
    solver = dict(preconditioner="MG", precond_dtype="float32",
                  solve_dtype="float32", newton_forcing="ew")
    jmesh, jtags = jax_grid("PF", 3, 2, solver="neo-Hookean")
    tmesh, ttags = make_scenario_grid("PF", 3, 2, solver="neo-Hookean")
    iid = ttags["interface"]
    jmesh, tmesh = _partial_interface(jmesh, iid), _partial_interface(tmesh, iid)
    jm = JaxNonlinear(JaxParams(**kw), mesh=jmesh, tags=jtags)
    tm = NonlinearElasticity(params_from_jax(JaxParams(**kw, **solver)),
                             mesh=tmesh, tags=ttags, device="cpu")
    assert jm._neumann_sides is None and tm._neumann_sides is None
    rng = np.random.default_rng(3)
    n = tm.space.n_nodes
    u = 1e-3 * rng.standard_normal((n, 3))
    stress = np.zeros((n, 3))
    iface = tm.space.boundary_nodes[iid]
    stress[iface] = 1e3 * rng.standard_normal((len(iface), 3))
    ref = np.asarray(jm._external_force_gather(jnp.asarray(u), jnp.asarray(stress)))
    got = tm.external_force(torch.as_tensor(u), torch.as_tensor(stress)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    assert np.abs(ref).max() > 0
    state, info = tm.step(tm.initial_state(), torch.as_tensor(
        _stress(tm.space, iid, 1000.0)))
    assert info.converged and bool(torch.isfinite(state.displacement).all())
