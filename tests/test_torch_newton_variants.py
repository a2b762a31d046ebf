"""The PyTorch package's Newton-solve variants against the JAX package's:
modified Newton with tangent reuse (the trajectory and Newton counts, and
the stale-tangent safeguard at a large load), the V-cycle with the
tangent on its fine level (`with_fine_operator`, `mg_fine_tangent`), and
the sum-factorized f64 internal force and mass (`ops/sumfact.py`, against
the JAX package's and the dense tabulation, and a `use_sumfact` step)."""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_adapter_tpu.models.nonlinear_elasticity as jax_nl
from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxDofSpace
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu.mesh.generator import (
    subdivided_hyper_rectangle as jax_rectangle,
)
from dealii_adapter_tpu.models.material import NeoHookean as JaxNeoHookean
from dealii_adapter_tpu.ops import sumfact as jax_sumfact
from dealii_adapter_tpu.ops.structured import (
    extract_cell_patches_T as jax_extract,
)
from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.convert import params_from_jax, state_to_numpy
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import (
    make_scenario_grid,
    subdivided_hyper_rectangle,
)
from dealii_adapter_tpu_torch.models.material import NeoHookean
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
    internal_force_cellwise_T,
)
from dealii_adapter_tpu_torch.ops.element_ops import ElementMatrices
from dealii_adapter_tpu_torch.ops.structured import (
    _cells_shape,
    _grid_shape,
    extract_cell_patches_T,
    make_structured_operator,
)
from dealii_adapter_tpu_torch.ops.sumfact import (
    internal_force_cellwise_sumfact,
    make_sumfact_basis,
    make_sumfact_mass_operator,
)

torch.set_num_threads(1)

# bench.py's production configuration (3D scale 1: 2,331 DoF)
PRODUCTION = dict(
    model="neo-Hookean", type_lin="CG", scenario="PF", dim=3, poly_degree=2,
    delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0, tol_lin=1e-6, tol_u=1e-6,
    tol_f=1e-9, max_iterations_NR=10, max_iterations_lin=1.0,
    dtype="float64", preconditioner="MG", precond_dtype="bfloat16",
    solve_dtype="float32", newton_forcing="ew", mg_smooth_degree=3,
    mg_fine_smooth_degree=1, newton_predictor=True, ew_eta0=0.3,
)


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


def _pair(**kw):
    """The JAX and ported models of `PRODUCTION` with `kw` (3D unless `kw`
    says `dim`) on the same scale-1 flap and one set of lam_max values,
    the port's estimates."""
    jp = JaxParams(**dict(PRODUCTION, **kw))
    mesh, tags = make_scenario_grid("PF", jp.dim, 2, scale=1,
                                    solver="neo-Hookean")
    tm = NonlinearElasticity(params_from_jax(jp), mesh=mesh, tags=tags,
                             device="cpu")
    lam = [lv.lam_max for lv in tm._precond.levels]
    jmesh, jtags = jax_grid("PF", jp.dim, 2, scale=1, solver="neo-Hookean")
    with _jax_takes_lam_max(lam):
        jm = jax_nl.NonlinearElasticity(jp, mesh=jmesh, tags=jtags)
    assert [lv.lam_max for lv in jm._precond.levels] == lam
    return jm, tm


def _stress(model, magnitude):
    s = np.zeros((model.space.n_nodes, model.space.dim))
    s[model.space.boundary_nodes[model.interface_id], 0] = magnitude
    return s


def _run(model, stress, n_steps, jax_model=False):
    """(displacement, [NewtonInfo fields per step]) after `n_steps`."""
    state = model.initial_state()
    infos = []
    for _ in range(n_steps):
        if jax_model:
            state, info = model.step(state, jnp.asarray(stress))
            info = {k: np.asarray(v).item() for k, v in info._asdict().items()}
            disp = np.asarray(state.displacement)
        else:
            state, info = model.step(state, torch.as_tensor(stress))
            info = info._asdict()
            disp = state_to_numpy(state)[0]
        assert info["converged"], info
        infos.append(info)
    return disp, infos


@pytest.fixture(scope="module")
def reuse_pair():
    """The JAX package's tests/test_nonlinear.py:_run_production_steps
    configuration (12 Newton iterations, CG capped at 10 n_dofs)."""
    return _pair(newton_tangent_reuse=True, max_iterations_NR=12,
                 max_iterations_lin=10.0)


@pytest.mark.parametrize("traction,n_steps", [(5000.0, 3), (30000.0, 2)],
                         ids=["production", "safeguard"])
def test_newton_tangent_reuse_matches_jax(reuse_pair, traction, n_steps):
    """Modified Newton (`newton_tangent_reuse`: the tangent assembled for
    the first iteration, then frozen unless it goes stale) takes the JAX
    package's Newton iterations in every step, and its displacement
    agrees within 1e-5; against the port's exact Newton it stays within
    1e-6 (1e-5 at traction 30,000) at most 2 iterations a step dearer (the
    JAX package's tests/test_nonlinear.py:426-470). At traction 5,000 it
    also assembles when the JAX package does. At 30,000 the safeguard
    refreshes the stale tangent (more assemblies than steps) but not
    always at the JAX package's iterations: the stale test compares
    residual ratios of CGs that differ by a few iterations (on the CPU
    with one thread 189 against 181 CG in step 1, 7 against 8
    assemblies)."""
    jm, tm = reuse_pair
    stress = _stress(tm, traction)
    u_jax, info_jax = _run(jm, stress, n_steps, jax_model=True)
    u_reuse, info_reuse = _run(tm, stress, n_steps)
    keys = ("iterations", "tangent_assemblies", "cg_iterations")
    for name, infos in (("port", info_reuse), ("JAX", info_jax)):
        print(f"{name}: (Newton, assemblies, CG) per step "
              f"{[tuple(i[k] for k in keys) for i in infos]}")
    for got, want in zip(info_reuse, info_jax):
        assert got["iterations"] == want["iterations"]
        if traction == 5000.0:
            assert got["tangent_assemblies"] == want["tangent_assemblies"]
    assert sum(i["tangent_assemblies"] for i in info_reuse) > n_steps
    np.testing.assert_allclose(np.abs(u_reuse).max(), np.abs(u_jax).max(),
                               rtol=1e-5)
    n_reuse = sum(i["iterations"] for i in info_reuse)
    assert sum(i["tangent_assemblies"] for i in info_reuse) < n_reuse
    exact = dataclasses.replace(tm.params, newton_tangent_reuse=False)
    tm_exact = NonlinearElasticity(
        exact, mesh=tm.mesh, tags=tm.tags, device="cpu",
        mg_lam_max=[lv.lam_max for lv in tm._precond.levels])
    u_exact, info_exact = _run(tm_exact, stress, n_steps)
    rtol = 1e-6 if traction == 5000.0 else 1e-5
    np.testing.assert_allclose(np.abs(u_reuse).max(), np.abs(u_exact).max(),
                               rtol=rtol)
    assert n_reuse <= sum(i["iterations"] for i in info_exact) + 2 * n_steps


def test_with_fine_operator_shares_every_level():
    """`with_fine_operator` clones the hierarchy: every level but the
    first is the same object, level 0 has the new operator, the proxy's
    diagonal and its lam_max times 1.1; the original is untouched."""
    mesh, tags = make_scenario_grid("PF", 3, 2, scale=1, solver="neo-Hookean")
    mg = NonlinearElasticity(AllParameters(**PRODUCTION), mesh=mesh, tags=tags,
                             device="cpu")._precond

    def op(v):
        return 2.0 * v

    clone = mg.with_fine_operator(op)
    assert clone is not mg and len(clone.levels) == len(mg.levels)
    assert all(a is b for a, b in zip(clone.levels[1:], mg.levels[1:]))
    lv0, new0 = mg.levels[0], clone.levels[0]
    assert new0.operator is op and lv0.operator is not op
    assert new0.diag is lv0.diag and new0.mask is lv0.mask
    assert new0.lam_max == lv0.lam_max * 1.1
    assert clone.with_fine_operator(op, lam_margin=1.0).levels[0].lam_max == (
        new0.lam_max)


def test_mg_fine_tangent_step_matches_jax():
    """`mg_fine_tangent`: two production steps with the assembled tangent
    as the V-cycle's fine operator take the JAX package's Newton
    iterations, CG counts within 2 a step (the bound of the production
    steps' parity, tests/test_torch_nonlinear.py: the port's tangent
    contraction sums in f64, the JAX package's in f32, and here the
    V-cycle applies that tangent too), and the displacement agrees within
    1e-6. On the 2D flap (518 DoF; 4-5 Newton iterations and 12-13 CG a
    step, the tangent refilled into the V-cycle's fine level at each):
    the JAX package's 2D step compiles in about a fifth of its 3D step's
    time, and the fine-level tangent is the same code in both."""
    jm, tm = _pair(mg_fine_tangent=True, dim=2)
    assert tm._mg_fine_tangent and tm._use_assembled
    stress = _stress(tm, 1000.0)
    u_jax, info_jax = _run(jm, stress, 2, jax_model=True)
    u_port, info_port = _run(tm, stress, 2)
    print(f"CG per step, port {[i['cg_iterations'] for i in info_port]}, JAX "
          f"{[i['cg_iterations'] for i in info_jax]}")
    for got, want in zip(info_port, info_jax):
        assert got["iterations"] == want["iterations"]
        assert abs(got["cg_iterations"] - want["cg_iterations"]) <= 2
    assert np.linalg.norm(u_port - u_jax) / np.linalg.norm(u_jax) < 1e-6
    solve = tm._tangent[1]
    assert solve.M.levels[0].operator is not tm._precond.levels[0].operator


def _rectangle_setup(degree, reps=(3, 2, 2)):
    args = (reps, [0.0, 0.0, 0.0], [0.3, 0.5, 1.1], degree)
    mesh = subdivided_hyper_rectangle(*args)
    jmesh = jax_rectangle(*args)
    return (mesh, DofSpace.create(mesh, n_q_1d=degree + 2),
            JaxDofSpace.create(jmesh, n_q_1d=degree + 2))


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_sumfact_internal_force_matches_jax_and_dense(degree):
    """The sum-factorized internal force equals the JAX package's and the
    dense-tabulation form (`internal_force_cellwise_T`) to rtol 1e-12
    (the JAX package's tests/test_sumfact.py:41)."""
    mesh, space, jspace = _rectangle_setup(degree)
    tab = space.tab
    h = np.asarray(mesh.cell_h)
    mat = NeoHookean(0.5e6, 0.4, 1000.0)
    rng = np.random.default_rng(degree)
    u = rng.standard_normal((space.n_nodes, 3)) * 1e-3
    grid = _grid_shape(space) + (3,)
    ut = extract_cell_patches_T(torch.as_tensor(u).reshape(grid), degree,
                                _cells_shape(space))
    sf = make_sumfact_basis(tab, h, torch.float64, device="cpu")
    rt, J = internal_force_cellwise_sumfact(ut, sf, mat)
    G = torch.as_tensor(tab.dN / h[None, None, :])
    w = torch.as_tensor(tab.q_weights * float(np.prod(h)))
    rt_dense, J_dense = internal_force_cellwise_T(ut, G, w, mat)
    jsf = jax_sumfact.make_sumfact_basis(jspace.tab, h, jnp.float64)
    jut = jax_extract(jnp.asarray(u).reshape(grid), degree, _cells_shape(space))
    rt_jax, J_jax = jax_sumfact.internal_force_cellwise_sumfact(
        jut, jsf, JaxNeoHookean(0.5e6, 0.4, 1000.0))
    scale = float(rt_dense.abs().max())
    for want, wJ in ((rt_dense.numpy(), float(J_dense)),
                     (np.asarray(rt_jax), float(J_jax))):
        np.testing.assert_allclose(rt.numpy(), want, rtol=0, atol=1e-12 * scale)
        assert abs(float(J) - wJ) < 1e-12


@pytest.mark.parametrize("degree", [1, 2])
def test_sumfact_mass_matches_jax_and_element_matrix(degree):
    """The sum-factorized mass equals the JAX package's and the element
    matrix's `StructuredOperator` to rtol 1e-12 (tests/test_sumfact.py:64)."""
    _, space, jspace = _rectangle_setup(degree)
    rho = 1234.5
    M_sf = make_sumfact_mass_operator(space, rho, torch.float64, device="cpu")
    elem = ElementMatrices(space, 0.0, 0.0, rho)
    M_dense = make_structured_operator(space, elem.M_e, torch.float64, "cpu")
    u = np.random.default_rng(7).standard_normal((space.n_nodes, 3))
    a = M_sf(torch.as_tensor(u)).numpy()
    b = M_dense(torch.as_tensor(u)).numpy()
    c = np.asarray(jax_sumfact.make_sumfact_mass_operator(
        jspace, rho, jnp.float64)(jnp.asarray(u)))
    for want in (b, c):
        np.testing.assert_allclose(a, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


def test_use_sumfact_f64_step_matches_jax():
    """`use_sumfact` with an f64 inner solve (the f64 jvp tangent of the
    sum-factorized residual, under an f32 V-cycle): two steps take the
    JAX package's Newton iterations and the displacement agrees within
    1e-8."""
    jm, tm = _pair(use_sumfact=True, solve_dtype="", precond_dtype="float32")
    assert tm._sumfact is not None and not tm._use_assembled
    stress = _stress(tm, 1000.0)
    u_jax, info_jax = _run(jm, stress, 2, jax_model=True)
    u_port, info_port = _run(tm, stress, 2)
    for got, want in zip(info_port, info_jax):
        assert got["iterations"] == want["iterations"]
        assert abs(got["cg_iterations"] - want["cg_iterations"]) <= 2
    assert np.linalg.norm(u_port - u_jax) / np.linalg.norm(u_jax) < 1e-8
