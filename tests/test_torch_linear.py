"""The PyTorch package's linear theta-scheme model against the JAX package:
the interface-traction load (rtol 1e-13), the mixed-precision refinement
solver (equal iterations, solution within 1e-10), five steps of the model
in 2D and 3D for the Jacobi/f64, MG/bf16 + f32 refinement and Direct
solvers, the chunked CG's steps against the host loop's (bit for bit),
the subcycling clone, and the recorded golden tip trajectories
`linear_pf_q2` and `linear_pf_q3` (rtol 1e-9)."""

import contextlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxDofSpace
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu.models.linear_elasticity import (
    LinearElastodynamics as JaxModel,
)
from dealii_adapter_tpu.ops.element_ops import ElementMatrices as JaxElem
from dealii_adapter_tpu.ops.element_ops import make_face_loading as jax_face_loading
from dealii_adapter_tpu.ops.structured import (
    make_structured_operator as jax_structured,
)
from dealii_adapter_tpu.solvers import cg as jcg
from dealii_adapter_tpu_torch.convert import (
    linear_state_from_numpy,
    linear_state_to_numpy,
    params_from_jax,
)
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.models.linear_elasticity import (
    LinearElastodynamics,
)
from dealii_adapter_tpu_torch.ops.element_ops import (
    ElementMatrices,
    assemble_diagonal,
    make_face_loading,
)
from dealii_adapter_tpu_torch.ops.structured import make_structured_operator
from dealii_adapter_tpu_torch.solvers import cg as tcg

torch.set_num_threads(1)
GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden_trajectories.json")
MU, NU, RHO = 0.5e6, 0.4, 1000.0

# tests/test_golden_trajectory.py's linear configuration
GOLDEN = dict(
    model="linear", type_lin="CG", scenario="PF", dim=2, poly_degree=2,
    delta_t=0.005, theta=0.5, mu=MU, nu=NU, rho=RHO, max_iterations_lin=10.0,
)
SOLVERS = {
    # (parameter overrides, rtol on the fields, CG counts compared)
    "jacobi_f64": (dict(), 1e-9, True),
    "mg_bf16_ir": (dict(preconditioner="MG", precond_dtype="bfloat16",
                        solve_dtype="float32", mg_smooth_degree=3,
                        mg_fine_smooth_degree=2), 1e-6, False),
    "direct": (dict(type_lin="Direct"), 1e-10, True),
}


def _stress(model, magnitude=1000.0):
    s = np.zeros((model.space.n_nodes, model.space.dim))
    s[model.space.boundary_nodes[model.interface_id], 0] = magnitude
    return s


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


@pytest.fixture(scope="module")
def models():
    """`models(**kw)`: the JAX and ported models of `GOLDEN` with `kw`,
    built once a configuration for the module (a model keeps no state
    from one step to the next, so one JAX compilation serves every test
    of a configuration)."""
    pairs = {}

    def get(**kw):
        key = tuple(sorted(dict(GOLDEN, **kw).items()))
        if key not in pairs:
            pairs[key] = _models(**kw)
        return pairs[key]

    return get


def _models(**kw):
    """The JAX and ported models of `GOLDEN` with `kw`; a multigrid
    hierarchy takes the port's lam_max estimates on both."""
    jp = JaxParams(**dict(GOLDEN, **kw))
    tm = LinearElastodynamics(params_from_jax(jp), device="cpu")
    if jp.preconditioner != "MG":
        return JaxModel(jp), tm
    lam = [lv.lam_max for lv in tm._precond.levels]
    with _jax_takes_lam_max(lam):
        jm = JaxModel(jp)
    assert [lv.lam_max for lv in jm._precond.levels] == lam
    return jm, tm


def _assert_fields_close(ts, js, rtol):
    for a, b in zip(linear_state_to_numpy(ts), js):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("dim,degree", [(2, 2), (3, 2), (2, 3)])
def test_face_loading_matches_jax(dim, degree):
    jmesh, jtags = jax_grid("PF", dim, degree)
    tmesh, ttags = make_scenario_grid("PF", dim, degree)
    js, ts = JaxDofSpace.create(jmesh), DofSpace.create(tmesh)
    jfl = jax_face_loading(js, JaxElem(js, 1.0, MU, RHO), jtags["interface"])
    tfl = make_face_loading(ts, ElementMatrices(ts, 1.0, MU, RHO),
                            ttags["interface"], device="cpu")
    t = np.random.default_rng(dim + 10 * degree).standard_normal(
        (ts.n_nodes, dim))
    a = np.asarray(jfl(jnp.asarray(t)))
    b = tfl(torch.from_numpy(t)).numpy()
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=1e-13, atol=1e-13 * np.abs(a).max())


def test_ir_cg_solve_matches_jax():
    """f32 Jacobi CG inside f64 refinement on the masked 2D stepping matrix
    M + (theta dt)^2 K: the same inner iterations, and solutions within
    1e-10 of each other. dt is 0.001: at the golden test's 0.005 the inner
    solves take ~200 f32 iterations, and XLA's and PyTorch's f32 summation
    orders then end them an iteration or two apart."""
    jmesh, jtags = jax_grid("PF", 2, 2, solver="linear")
    tmesh, _ = make_scenario_grid("PF", 2, 2, solver="linear")
    js, ts = JaxDofSpace.create(jmesh), DofSpace.create(tmesh)
    el = ElementMatrices(ts, 2 * MU * NU / (1 - 2 * NU), MU, RHO)
    A_e = el.M_e + (0.5 * 0.001) ** 2 * el.K_e
    mask = ts.dirichlet_mask(jtags["clamped"])
    diag = mask * assemble_diagonal(ts, A_e) + (1 - mask)
    b = mask * np.random.default_rng(0).standard_normal((ts.n_nodes, 2))

    def masked(op, m):
        return lambda v: m * op(m * v) + (1 - m) * v

    jm32 = jnp.asarray(mask, jnp.float32)
    jr = jcg.ir_cg_solve(
        masked(jax_structured(js, A_e, jnp.float64), jnp.asarray(mask)),
        masked(jax_structured(js, A_e, jnp.float32), jm32),
        jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)), tol=1e-10,
        max_iter=20000, lo_dtype=jnp.float32,
        preconditioner=jcg.jacobi_preconditioner(jnp.asarray(diag, jnp.float32)),
    )
    tm32 = torch.as_tensor(mask, dtype=torch.float32)
    tr = tcg.ir_cg_solve(
        masked(make_structured_operator(ts, A_e, torch.float64, "cpu"),
               torch.as_tensor(mask)),
        masked(make_structured_operator(ts, A_e, torch.float32, "cpu"), tm32),
        torch.as_tensor(b), torch.zeros(b.shape, dtype=torch.float64),
        tol=1e-10, max_iter=20000,
        preconditioner=tcg.jacobi_preconditioner(
            torch.as_tensor(diag, dtype=torch.float32)),
    )
    assert bool(jr.converged) and tr.converged
    assert tr.residual_norm <= 1e-10
    assert tr.iterations == int(jr.iterations)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("solver", list(SOLVERS))
@pytest.mark.parametrize("dim", [2, 3])
def test_steps_match_jax(models, dim, solver):
    """Five theta-steps from the same state under a constant traction.

    The Jacobi f64 solves take ~200 CG iterations to the absolute 1e-10,
    and in that many iterations the two packages' f64 summation orders
    drift apart (measured on the 2D flap from one right-hand side: residual
    norms agree to 3e-15 relative at iteration 20, 1e-8 at 50, 1e-2 at
    150), so where the residual norm hovers near the tolerance the last
    iteration falls a few apart (seen: 2 of 195 in 3D). Counts must agree
    within 3; the fields within rtol."""
    kw, rtol, same_counts = SOLVERS[solver]
    jm, tm = models(dim=dim, **kw)
    stress = _stress(tm)
    js, ts = jm.initial_state(), tm.initial_state()
    for _ in range(5):
        js, ji = jm.step(js, jnp.asarray(stress))
        ts, ti = tm.step(ts, torch.as_tensor(stress))
        if solver != "direct":
            assert ti.residual <= 1e-10
        if same_counts:
            assert abs(ti.iterations - int(ji.iterations)) <= 3
        _assert_fields_close(ts, js, rtol)
        np.testing.assert_allclose(ti.linf_velocity, float(ji.linf_velocity),
                                   rtol=rtol)


@pytest.mark.parametrize("solver", ["jacobi_f64", "mg_bf16_ir"])
def test_chunked_cg_step_equals_the_host_loop(solver):
    """Three theta-steps with the CG in chunks of 3 (`cg_loop="graphs"`,
    run eagerly on the CPU; the refinement's inner tolerance written to
    the solver's tolerance tensor each round) give the `cg_loop="host"`
    step's `StepInfo` and state bit for bit (the one step, its bodies
    eager, chunks of 1), and its clone keeps the loop. Both read back
    once a chunk plus at most once a step: the host form at most its CG
    iterations + 1, the chunks of 3 fewer than the CG iterations. The
    chunk is set on the built solver, so that masked iterations run."""
    kw = SOLVERS[solver][0]
    params = params_from_jax(JaxParams(**dict(GOLDEN, **kw)))
    models = [LinearElastodynamics(params, device="cpu", cg_loop=loop)
              for loop in ("host", "graphs")]
    models[1]._cg.chunk = 3
    stress = torch.as_tensor(_stress(models[0]))
    states = [m.initial_state() for m in models]
    for _ in range(3):
        syncs = [m.host_syncs for m in models]
        (host, hi), (chunked, ci) = (m.step(st, stress)
                                     for m, st in zip(models, states))
        assert ci == hi and hi.residual <= 1e-10
        assert all(torch.equal(a, b) for a, b in zip(chunked, host))
        dsyncs = [m.host_syncs - s for m, s in zip(models, syncs)]
        assert dsyncs[0] <= hi.iterations + 1
        assert dsyncs[1] < hi.iterations
        states = [host, chunked]
    clone = models[1].with_delta_t(0.0025)
    assert clone.cg_loop == "graphs" and isinstance(clone._cg, tcg.ChunkedCG)


def test_step_from_a_carried_state_matches_jax(models):
    """A step from a random state handed to both packages (the state
    carry-over of `convert.py`)."""
    jm, tm = models()
    rng = np.random.default_rng(3)
    fields = [rng.standard_normal((tm.space.n_nodes, 2)) * s
              for s in (1e-3, 1e-1, 10.0)]
    js = type(jm.initial_state())(*(jnp.asarray(f) for f in fields))
    ts = linear_state_from_numpy(*fields, device="cpu")
    _assert_fields_close(ts, js, 0)
    stress = _stress(tm)
    js, ji = jm.step(js, jnp.asarray(stress))
    ts, ti = tm.step(ts, torch.as_tensor(stress))
    assert abs(ti.iterations - int(ji.iterations)) <= 3  # see test_steps_match_jax
    _assert_fields_close(ts, js, 1e-9)


def test_with_delta_t_is_a_memoized_clone_matching_jax(models):
    jm, tm = models()
    assert tm.with_delta_t(tm.params.delta_t) is tm
    clone = tm.with_delta_t(0.0025)
    assert clone is tm.with_delta_t(0.0025) and clone is not tm
    assert clone.params.delta_t == 0.0025 and clone.mesh is tm.mesh
    assert clone.device == tm.device
    jclone = jm.with_delta_t(0.0025)
    stress = _stress(tm)
    js, ji = jclone.step(jclone.initial_state(), jnp.asarray(stress))
    ts, ti = clone.step(clone.initial_state(), torch.as_tensor(stress))
    assert abs(ti.iterations - int(ji.iterations)) <= 3  # see test_steps_match_jax
    _assert_fields_close(ts, js, 1e-9)


@pytest.mark.parametrize("key,degree", [("linear_pf_q2", 2), ("linear_pf_q3", 3)])
def test_golden_tip_trajectory(key, degree):
    """20 steps of tests/test_golden_trajectory.py's linear configuration
    land on the recorded tip trajectory at that test's tolerance."""
    model = LinearElastodynamics(
        params_from_jax(JaxParams(**dict(GOLDEN, poly_degree=degree))),
        device="cpu",
    )
    nodes = model.space.mesh.nodes
    target = np.zeros(2)
    target[1] = nodes[:, 1].max()
    tip = int(np.argmin(((nodes - target) ** 2).sum(axis=1)))
    stress = torch.as_tensor(_stress(model))
    state, traj = model.initial_state(), []
    for _ in range(20):
        state, info = model.step(state, stress)
        assert info.residual <= 1e-10
        traj.append(float(state.displacement[tip, 0]))
    with open(GOLDEN_PATH) as fh:
        golden = json.load(fh)[key]
    np.testing.assert_allclose(traj, golden, rtol=1e-9)


# bench.py's linear parameters on the 2D flap with the bf16 hierarchy (the
# configuration of chip_smoke.py's vcycle_bf16 phase)
LINEAR_BF16 = dict(
    model="linear", type_lin="CG", scenario="PF", dim=2, poly_degree=2,
    delta_t=0.005, theta=0.5, mu=MU, nu=NU, rho=RHO, dtype="float64",
    preconditioner="MG", precond_dtype="bfloat16", solve_dtype="float32",
    mg_smooth_degree=3, mg_fine_smooth_degree=2,
)
# step 0's CG iterations of the JAX package on the CPU at scale 16:
#   JAX_PLATFORMS=cpu python tools/jax_reference_2d.py linear --scale 16 \
#       --steps 1 --precond-dtype bfloat16
JAX_BF16_CG_SCALE16 = 72


def test_bf16_hierarchy_cg_iterations_match_jax():
    """The bf16 V-cycle preconditions as the JAX package's does: step 0 at
    scale 16 (111,938 DoF) takes at most 1.1x the JAX package's CG
    iterations (75 here; 88-90 while the 2D fine proxy applied its element
    matrix in f32 where the JAX package holds it in bf16)."""
    mesh, tags = make_scenario_grid("PF", 2, 2, scale=16, solver="linear")
    model = LinearElastodynamics(
        params_from_jax(JaxParams(**LINEAR_BF16)), mesh=mesh, tags=tags,
        device="cpu",
    )
    _, info = model.step(model.initial_state(),
                         torch.as_tensor(_stress(model)))
    assert info.residual <= 1e-10
    assert info.iterations <= 1.1 * JAX_BF16_CG_SCALE16
