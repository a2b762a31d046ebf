"""The Neo-Hookean model's one Newton loop (its decisions on the device)
under `cg_loop="host"` (its bodies and its CG, `ChunkedCG`, run eagerly)
and under `cg_loop="graphs"` (the bodies go through the graph runner and
the CG chunks are captured on a card; both eager on the CPU), each held
against the oracle: the same model under `"host"` with its CG replaced
by the host-loop `cg_solve` (`cg_solve_oracle`, built here; the
package builds no such solve): the same `NewtonInfo`, the same iterate
bit for bit and the same passes, with one read-back a Newton pass
outside the CG and the CG's read-backs exact (k + 1 a solve of k
iterations on `cg_solve`, max(1, k) on the chunks of 1), on the 3D
benchmark configuration at scale 1 (2,331 DoF) under f64 residuals, the
mixed schedule through a stall, tangent reuse at traction 30,000 (two
stalls), the jvp tangent and the gather backend; the JAX package's counts
in 2D; the dense Direct solve and the per-iteration Newton table
(`verbose`) against the JAX package's, in 2D too."""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dealii_adapter_tpu.models.nonlinear_elasticity as jax_nl
import dealii_adapter_tpu_torch.models.nonlinear_elasticity as nl
from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
)
from dealii_adapter_tpu_torch.solvers.cg import ChunkedCG, cg_solve

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
# (traction, steps, parameters, stalls the device loop must meet); the
# mixed schedule and tangent reuse run several steps (their stalls and
# refreshes, and steps from a state not at rest), the other cases one
# step from rest (4-5 Newton passes)
CASES = {
    "f64_residuals": (1000.0, 1, dict(newton_residual="f64"), 0),
    "mixed_stall": (20000.0, 3, dict(max_iterations_NR=12), 1),
    "reuse_30000": (30000.0, 2, dict(newton_tangent_reuse=True,
                                     max_iterations_NR=12,
                                     max_iterations_lin=10.0), 2),
    "jvp": (1000.0, 1, dict(tangent_backend="jvp"), 0),
    "gather": (1000.0, 1, dict(element_backend="gather"), 0),
}


@pytest.fixture(scope="module")
def mesh_tags():
    return make_scenario_grid("PF", 3, 2, scale=1, solver="neo-Hookean")


@contextlib.contextmanager
def _jax_takes_lam_max(values):
    """The JAX package's multigrid hierarchies built inside take `values`
    (one per level, fine first) in place of their power iterations (in 2D
    ~7 s of XLA compilation and run a hierarchy on the CPU)."""
    from dealii_adapter_tpu.solvers import cg as jcg

    it = iter(values)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcg, "estimate_lambda_max", lambda *a, **k: next(it))
        yield


def _stress(model, magnitude):
    s = np.zeros((model.space.n_nodes, model.space.dim))
    s[model.space.boundary_nodes[model.interface_id], 0] = magnitude
    return s


def _make_cg_solve(loop, operator, preconditioner=None, chunk=None,
                   dot=nl._dot, pool=None):
    """`make_cg`'s signature, returning the host-loop `cg_solve` over the
    model's operator, preconditioner and inner product: the oracle."""
    assert loop == "host"

    def solve(b, x0, tol, max_iter):
        return cg_solve(operator, b, x0, tol, max_iter, preconditioner, dot)

    return solve


def cg_solve_oracle(model):
    """`model` (`cg_loop="host"`) with its CG the host-loop `cg_solve` in
    place of the eager `ChunkedCG`: the model imports `make_cg` by name
    and builds its CG at its first solve, so its steps run with that
    name replaced (the package builds no such solve)."""
    assert model.cg_loop == "host"
    step = model.step

    def oracle_step(*args):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(nl, "make_cg", _make_cg_solve)
            return step(*args)

    model.step = oracle_step
    return model


def _models(mesh_tags, kw):
    """(the oracle: `cg_loop="host"` with `cg_solve` as its CG, the host
    loop's model, the CG graphs' model) on one mesh and one set of
    lam_max values."""
    params = AllParameters(**dict(PRODUCTION, **kw))
    mesh, tags = mesh_tags
    host = NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu",
                               cg_loop="host")
    lam = ([lv.lam_max for lv in host._precond.levels]
           if params.preconditioner == "MG" else None)
    dev = NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu",
                              mg_lam_max=lam)
    oracle = cg_solve_oracle(NonlinearElasticity(
        params, mesh=mesh, tags=tags, device="cpu", cg_loop="host",
        mg_lam_max=lam))
    assert (oracle.cg_loop, host.cg_loop, dev.cg_loop) == (
        "host", "host", "graphs")
    assert oracle._graphs.eager and host._graphs.eager
    assert not dev._graphs.eager
    return oracle, host, dev


def _record(model):
    """Counts of the Newton loop's passes: [decisions, stall redos, CG
    read-backs, f64 residuals, solve-dtype residuals, [(CG iterations,
    the CG's read-backs) of each solve]]."""
    counts = [0, 0, 0, 0, 0, []]
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
        syncs, cg_syncs = model.host_syncs, model.cg_host_syncs
        out = solve(*args)
        counts[2] += model.host_syncs - syncs
        counts[5].append((out[1], model.cg_host_syncs - cg_syncs))
        return out

    model._newton_decide, model._solve = recorded_decide, recorded_solve
    model._newton_residual = recorded_residual
    return counts


@pytest.mark.parametrize("case", list(CASES))
def test_device_newton_loop_equals_the_host_loop(mesh_tags, case):
    """The one Newton loop under `cg_loop="host"` (its bodies and CG chunks
    eager) and under `"graphs"` each equal it beside the host-loop
    `cg_solve` (the oracle): `NewtonInfo`, states, the passes, the stall
    redos and the residuals evaluated, and each reads back once a pass
    outside the CG (once more a stall); the CG reads back k + 1 times a
    solve of k iterations on the oracle and max(1, k) on the chunks."""
    traction, n_steps, kw, stalls = CASES[case]
    models = _models(mesh_tags, kw)
    counts = [_record(m) for m in models]
    stress = torch.as_tensor(_stress(models[0], traction))
    states = [m.initial_state() for m in models]
    for _ in range(n_steps):
        before = [(m.host_syncs, c[:5], m.uncounted_f32_evals)
                  for m, c in zip(models, counts)]
        out = [m.step(st, stress) for m, st in zip(models, states)]
        (so, io_), *others = out
        assert io_.converged
        for st, info in others:
            assert info == io_
            assert all(torch.equal(a, b) for a, b in zip(st, so))
        states = [st for st, _ in out]
        for m, c, (syncs, (decided, redos, cg_syncs, n64, n32),
                   uncounted) in zip(models, counts, before):
            # one read-back a pass outside the CG, one more a stall
            passes = c[0] - decided - (c[1] - redos)
            outside = m.host_syncs - syncs - (c[2] - cg_syncs)
            assert passes == io_.iterations + 1
            assert outside == passes + c[1] - redos
            # the residuals evaluated are the ones counted, the
            # solve-dtype ones discarded at u = 0 apart
            assert c[3] - n64 == io_.f64_evals
            assert c[4] - n32 == (io_.f32_evals
                                  + m.uncounted_f32_evals - uncounted)
    # the same passes, redos, residuals and CG solves; the CG read-backs
    # differ by one a solve that iterates (one an iteration and one more
    # on `cg_solve`, one a chunk of 1 iteration on `ChunkedCG`)
    oracle, host, dev = models
    assert isinstance(host._tangent[1], ChunkedCG) and host._tangent[1].eager
    assert not isinstance(oracle._tangent[1], ChunkedCG)
    its = [k for k, _ in counts[0][5]]
    assert all([k for k, _ in c[5]] == its for c in counts)
    assert [n for _, n in counts[0][5]] == [k + 1 for k in its]
    for c in counts[1:]:
        assert [n for _, n in c[5]] == [max(1, k) for k in its]
        assert counts[0][:2] + counts[0][3:5] == c[:2] + c[3:5]
        assert counts[0][2] - c[2] == sum(k > 0 for k in its)
    assert counts[2][1] == stalls
    # only the calibrating pass at rest, step 0's first, evaluates a
    # residual it does not count, and only under the mixed schedule
    mixed = dev.params.newton_residual == "mixed" and dev._mixed_tangent
    for m in models:
        assert m.uncounted_f32_evals == int(mixed and not dev._cells)


def test_device_newton_loop_counts_match_jax():
    """The 2D flap at scale 1 under the mixed schedule at traction 1000
    (2D: the JAX package's step compiles in a third of the 3D one's time):
    the device loop's Newton, f64 and f32 counts equal the JAX package's
    in every step, as the host loop's do (tests/test_torch_nonlinear.py),
    and the fields agree to 1e-9. Both hierarchies take the port's
    lam_max estimates."""
    params = dict(PRODUCTION, dim=2)
    mesh, tags = make_scenario_grid("PF", 2, 2, scale=1, solver="neo-Hookean")
    tm = NonlinearElasticity(AllParameters(**params), mesh=mesh, tags=tags,
                             device="cpu")
    lam = [lv.lam_max for lv in tm._precond.levels]
    jmesh, jtags = jax_grid("PF", 2, 2, scale=1, solver="neo-Hookean")
    with _jax_takes_lam_max(lam):
        jm = jax_nl.NonlinearElasticity(JaxParams(**params), mesh=jmesh,
                                        tags=jtags)
    assert [lv.lam_max for lv in jm._precond.levels] == lam
    assert tm.cg_loop == "graphs"
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
    """There is one Newton loop and one CG loop: the `newton_loop` keyword
    is gone, how the loop's bodies and CG chunks run follows `cg_loop`
    (both models build a `ChunkedCG`, eager under "host"), and a
    `with_delta_t` clone keeps the model's `cg_loop`."""
    mesh, tags = mesh_tags
    # the Jacobi-preconditioned f32 solve: no multigrid hierarchy to build
    params = AllParameters(**dict(PRODUCTION, preconditioner="Jacobi",
                                  precond_dtype=""))
    for loop in ("graphs", "host"):
        with pytest.raises(TypeError, match="newton_loop"):
            NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu",
                                cg_loop=loop, newton_loop=loop)
    host = NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu",
                               cg_loop="host")
    clone = host.with_delta_t(0.02)
    assert clone is not host and clone.cg_loop == "host"
    assert clone._graphs.eager and host._graphs.eager
    graphs = NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu")
    clone = graphs.with_delta_t(0.02)
    assert clone.cg_loop == "graphs" and not clone._graphs.eager
    assert not hasattr(graphs, "newton_loop")
    for model, eager in ((host, True), (graphs, False)):
        solve = model._make_cg(lambda v: v)
        assert type(solve) is ChunkedCG and solve.eager is eager


# the dense Direct solve on the 2D flap at scale 1 (518 DoF, f64
# throughout): the JAX package's 2D step compiles in about a fifth of its
# 3D step's time, and the Direct branch and the Newton table are the same
# code in both
DIRECT = dict(PRODUCTION, dim=2, type_lin="Direct", preconditioner="Jacobi",
              solve_dtype="", precond_dtype="")
_NR_LINE = re.compile(
    r"^    NR it (\d+): RES_F\(abs\) (\S+)  RES_F\(rel\) (\S+)  "
    r"NU\(rel\) (\S+)  min J (\S+)$")


def _table(text):
    """The Newton table's rows in printed text: [(it, abs, rel, nu, J)]."""
    rows = [_NR_LINE.match(line) for line in text.splitlines()]
    assert all(rows), text
    return [(int(m[1]),) + tuple(float(x) for x in m.groups()[1:])
            for m in rows]


@pytest.fixture(scope="module")
def direct_runs():
    """One step from rest of `DIRECT` at traction 1000 with the Newton
    table on (`verbose`): the JAX package's (its `jax.debug.print` lines
    captured) and the port's beside the host CG loop and beside the CG
    graphs: {name: (NewtonInfo, displacement, printed text)}."""
    jmesh, jtags = jax_grid("PF", 2, 2, scale=1, solver="neo-Hookean")
    jm = jax_nl.NonlinearElasticity(JaxParams(**DIRECT), mesh=jmesh,
                                    tags=jtags, verbose=True)
    stress = _stress(jm, 1000.0)
    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        js, ji = jm.step(jm.initial_state(), jnp.asarray(stress))
        jax.block_until_ready(js)
        jax.effects_barrier()
    out["jax"] = (ji, np.asarray(js.displacement), buf.getvalue())
    mesh, tags = make_scenario_grid("PF", 2, 2, scale=1, solver="neo-Hookean")
    for loop in ("host", "graphs"):
        model = NonlinearElasticity(AllParameters(**DIRECT), mesh=mesh,
                                    tags=tags, device="cpu", cg_loop=loop,
                                    verbose=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            st, info = model.step(model.initial_state(),
                                  torch.as_tensor(stress))
        out[loop] = (info, st, buf.getvalue())
    return out


def test_direct_one_loop_matches_jax(direct_runs):
    """`type_lin="Direct"` through the one loop: beside the host CG loop
    and beside the CG graphs the same `NewtonInfo` and state bit for bit;
    against the JAX package's dense Direct step, the same Newton count,
    residual evaluations and solves, and the displacement within the
    tolerance of `test_device_newton_loop_counts_match_jax`."""
    (ih, sh, _), (ig, sg, _) = direct_runs["host"], direct_runs["graphs"]
    assert ih.converged and ig == ih
    assert all(torch.equal(a, b) for a, b in zip(sg, sh))
    ji, ju, _ = direct_runs["jax"]
    assert bool(ji.converged)
    assert (ih.iterations, ih.cg_iterations, ih.f64_evals, ih.f32_evals,
            ih.tangent_assemblies) == tuple(int(x) for x in (
                ji.iterations, ji.cg_iterations, ji.f64_evals,
                ji.f32_evals, ji.tangent_assemblies))
    assert ih.min_det_F == pytest.approx(float(ji.min_det_F), rel=1e-12)
    np.testing.assert_allclose(sh.displacement.numpy(), ju, rtol=0,
                               atol=1e-9 * np.abs(ju).max())


def test_verbose_newton_table_matches_jax(direct_runs):
    """`verbose=True` prints the JAX package's per-iteration Newton table
    (`NR it`, RES_F abs and rel, NU rel, min J), one line a pass, from the
    status the loop reads anyway: the same lines under both CG loops, and
    against the JAX package's the same count and `NR it` values, the
    residuals within 1e-9 of the first (the tolerance of
    `test_device_newton_loop_counts_match_jax`, relative to the largest
    value), NU and min J as printed."""
    (ih, _, th), (_, _, tg) = direct_runs["host"], direct_runs["graphs"]
    ours, theirs = _table(th), _table(direct_runs["jax"][2])
    assert th == tg
    assert len(ours) == len(theirs) == ih.iterations + 1
    assert [r[0] for r in ours] == [r[0] for r in theirs] == list(
        range(ih.iterations + 1))
    res0 = theirs[0][1]
    for (_, a, r, nu, mj), (_, ja, jr, jnu, jmj) in zip(ours, theirs):
        assert abs(a - ja) <= 1e-9 * res0 + 1e-4 * ja  # 5 printed digits
        assert abs(r - jr) <= 1e-9 + 1e-4 * jr
        assert nu == pytest.approx(jnu, rel=1e-4) and mj == jmj
