"""The linear theta-step, written once (`LinearElastodynamics._step`):
against an oracle step built from the model's public pieces alone
(`assemble_load`, `masked_operator`, the host-loop `cg_solve` /
`ir_cg_solve` or the dense Cholesky, the theta update) bit for bit, for
every solver at chunks of 1 and 3 over three steps and a clone step; its
replayed (`cg_loop="graphs"`; on the CPU its bodies run eagerly) and
eager (`cg_loop="host"`) forms as one function with the same bits and
read-backs; and the defect-correction loop on the device
(`solvers/cg.py:ChunkedIRCG`) against `ir_cg_solve` bit for bit, at
chunks of 1 and 3 iterations, where the tolerance is met at the start,
where the refinement cap ends the loop and with a bf16-preconditioned
f32 inner CG; on the 2D flap of the golden configuration (518 DoF). No
JAX: the host loops are the oracles here; `tests/test_torch_linear.py`
holds the step against the JAX package."""

import numpy as np
import pytest
import torch

from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.models.linear_elasticity import (
    CG_TOL,
    LinearElastodynamics,
    LinearState,
    StepInfo,
)
from dealii_adapter_tpu_torch.ops.element_ops import (
    ElementMatrices,
    assemble_dense,
)
from dealii_adapter_tpu_torch.solvers import cg as tcg
from dealii_adapter_tpu_torch.solvers.direct import DenseCholesky

torch.set_num_threads(1)

# tests/test_golden_trajectory.py's linear configuration
GOLDEN = dict(
    model="linear", type_lin="CG", scenario="PF", dim=2, poly_degree=2,
    delta_t=0.005, theta=0.5, mu=0.5e6, nu=0.4, rho=1000.0,
    max_iterations_lin=10.0,
)
# tests/test_torch_linear.py's solvers
SOLVERS = {
    "jacobi_f64": dict(),
    "mg_bf16_ir": dict(preconditioner="MG", precond_dtype="bfloat16",
                       solve_dtype="float32", mg_smooth_degree=3,
                       mg_fine_smooth_degree=2),
    "direct": dict(type_lin="Direct"),
}
# the refinement cases: (the model's parameters, whose operators and
# preconditioner the solve takes: Jacobi in f32, or the bf16 V-cycle;
# the tolerance as a multiple of the start's residual norm, 0 for the
# model's CG_TOL; max_refinements)
IR_CASES = {
    "met_at_start": (dict(solve_dtype="float32"), 2.0, 6),
    "cap": (dict(solve_dtype="float32"), 0.0, 1),
    "bf16_mg": (SOLVERS["mg_bf16_ir"], 0.0, 6),
}


def _stress(model, magnitude=1000.0):
    s = torch.zeros((model.space.n_nodes, model.space.dim),
                    dtype=torch.float64)
    s[torch.as_tensor(model.space.boundary_nodes[model.interface_id]), 0] = (
        magnitude)
    return s


@pytest.fixture(scope="module")
def models():
    """{solver: {"host": model, chunk: model under "graphs"}}, built once
    for the module."""
    def build(kw, **model_kw):
        return LinearElastodynamics(AllParameters(**dict(GOLDEN, **kw)),
                                    device="cpu", **model_kw)

    return {name: {"host": build(kw, cg_loop="host"),
                   **{c: build(kw, cg_chunk=c) for c in (1, 3)}}
            for name, kw in SOLVERS.items()}


@pytest.mark.parametrize("guess", ["estimate", "always_end", "never_end"])
@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("case", list(IR_CASES))
def test_device_refinement_equals_ir_cg_solve(case, chunk, guess,
                                              monkeypatch):
    """`ChunkedIRCG` against `ir_cg_solve` (host CG inside): the same
    iterate, iterations, residual and convergence bit for bit, whatever
    the host guesses about the loop's end (its estimate, or a guess
    forced to "ends here" or "goes on"); its `x_stat` the max norm of the
    result; at most one read-back besides one per chunk run; with the
    estimate, at chunks of 1, at most one besides one per inner CG
    iteration, and fewer at chunks of 3."""
    kw, tol_factor, max_ref = IR_CASES[case]
    model = LinearElastodynamics(AllParameters(**dict(GOLDEN, **kw)),
                                 device="cpu", cg_loop="host")
    A_hi, A_lo, M = model._A_bc, model._cg_op, model._precond
    g = torch.Generator().manual_seed(7)
    b = model.mask * torch.randn(model.space.n_nodes, 2, generator=g,
                                 dtype=torch.float64)
    x0 = model.mask * torch.randn(model.space.n_nodes, 2, generator=g,
                                  dtype=torch.float64) * 1e-3
    tol = tol_factor * float(torch.linalg.vector_norm(b - A_hi(x0))) or CG_TOL
    max_iter = model._max_cg_iter
    host = tcg.ir_cg_solve(A_hi, A_lo, b, x0, tol, max_iter,
                           preconditioner=M, max_refinements=max_ref)
    dev = tcg.ChunkedIRCG(A_hi, A_lo, M, chunk=chunk,
                          max_refinements=max_ref,
                          x_stat=lambda x: x.abs().max())
    if guess != "estimate":
        monkeypatch.setattr(dev, "_expect_end",
                            lambda *a: guess == "always_end")
    chunks, run = [0], dev.inner._run

    def counted(which):
        chunks[0] += which
        run(which)

    monkeypatch.setattr(dev.inner, "_run", counted)
    for _ in range(2):  # the second solve reuses the buffers
        chunks[0] = 0
        r = dev(b, x0, tol, max_iter)
        assert torch.equal(r.x, host.x)
        assert (r.iterations, r.residual_norm, r.converged) == (
            host.iterations, host.residual_norm, host.converged)
        assert r.x_stat == float(host.x.abs().max())
        assert r.host_syncs <= chunks[0] + 1
    if guess != "estimate":
        return
    if case == "met_at_start":
        assert host.iterations == 0 and host.converged and r.host_syncs == 1
    elif case == "cap":
        assert not host.converged and host.residual_norm > tol
    else:
        assert host.converged and host.host_syncs > host.iterations + 3
    if chunk == 1:
        assert r.host_syncs <= host.iterations + 1
    elif case != "met_at_start":
        assert r.host_syncs < host.iterations


def _dense_direct(model):
    """The Direct solve of `model`'s stepping matrix, from public pieces:
    the dense BC-masked matrix (identity on the constrained rows),
    factored once."""
    p, space = model.params, model.space
    elem = ElementMatrices(space, p.lmbda, p.mu, p.rho)
    A = assemble_dense(space, elem.M_e + (p.theta * p.delta_t) ** 2 * elem.K_e)
    m = model.mask.numpy().reshape(-1)
    A = A * m[:, None] * m[None, :]
    A[np.diag_indices_from(A)] += 1.0 - m
    return DenseCholesky(A, model.dtype, "cpu")


def _oracle_step(model, state, data, direct=None):
    """One theta-step of `model` from its public pieces (the JAX package's
    `_make_step` line by line): the load, the right-hand side, the solve
    (`ir_cg_solve` in f32 defect correction, `cg_solve`, or `direct`),
    the update; `StepInfo` as the model reports it."""
    p = model.params
    dt, theta = p.delta_t, p.theta
    mask, K, M = model.mask, model.K, model.M
    disp, vel, old = state
    F = model.assemble_load(data)
    rhs = mask * (dt * theta * F + dt * (1.0 - theta) * old + M(vel)
                  - (theta * (1.0 - theta) * dt * dt) * K(vel)
                  - dt * K(disp))
    max_iter = int(model.space.n_dofs * p.max_iterations_lin)
    A_hi = model.masked_operator(model.A)
    if direct is not None:
        v, its, resn = direct.solve(rhs), 1, 0.0
    else:
        if model.solve_dtype != model.dtype:
            r = tcg.ir_cg_solve(
                A_hi, model.masked_operator(model.A_lo, model.mask_lo), rhs,
                mask * vel, CG_TOL, max_iter, lo_dtype=model.solve_dtype,
                preconditioner=model.preconditioner)
        else:
            r = tcg.cg_solve(A_hi, rhs, mask * vel, CG_TOL, max_iter,
                             model.preconditioner)
        v, its, resn = r.x, r.iterations, r.residual_norm
    d = disp + dt * theta * v + dt * (1.0 - theta) * vel
    return (LinearState(d, v, F),
            StepInfo(its, resn, float(v.abs().max())))


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_step_equals_the_public_function_oracle(models, solver, chunk):
    """Three steps of the one step (`cg_loop="graphs"`, eager on the CPU)
    and a step of its subcycling clone give the oracle step's `StepInfo`
    and state bit for bit: every solver branch (the f32 refinement around
    the bf16-preconditioned CG, the f64 Jacobi CG, the Direct solve) at
    chunks of 1 and 3 (masked iterations)."""
    model = models[solver][chunk]
    assert model._cg.chunk == chunk
    direct = _dense_direct(model) if solver == "direct" else None
    stress = _stress(model)
    st = ost = model.initial_state()
    for _ in range(3):
        (st, info), (ost, oinfo) = (model.step(st, stress),
                                    _oracle_step(model, ost, stress, direct))
        assert info == oinfo and type(info.iterations) is int
        assert isinstance(info.residual, float)
        assert all(torch.equal(a, b) for a, b in zip(st, ost))
        if solver != "direct":
            assert info.residual <= CG_TOL
    clone = model.with_delta_t(0.0025)
    direct = _dense_direct(clone) if solver == "direct" else None
    (st, info), (ost, oinfo) = (clone.step(st, stress),
                                _oracle_step(clone, ost, stress, direct))
    assert info == oinfo
    assert all(torch.equal(a, b) for a, b in zip(st, ost))


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_device_steps_equal_the_host_loop(models, solver, chunk):
    """The step replayed (`cg_loop="graphs"`) and eager (`cg_loop=
    "host"`, chunks of 1) is one function (`jittable_step()`): three steps
    give the same `StepInfo` and state bit for bit, and both read back
    once a CG chunk plus at most once a step (the Direct solve once), so
    at chunks of 1 equally often, at chunks of 3 the replayed form less;
    the subcycling clone keeps the loop, its chunk and its result."""
    host, dev = models[solver]["host"], models[solver][chunk]
    assert dev.cg_loop == "graphs" and dev._cg.chunk == chunk
    assert host._graphs.eager and host._cg.eager
    assert not dev._graphs.eager and not dev._cg.eager
    assert (host.jittable_step().__func__ is dev.jittable_step().__func__
            is LinearElastodynamics._step)
    stress = _stress(host)
    states = [host.initial_state(), dev.initial_state()]
    for _ in range(3):
        syncs = [host.host_syncs, dev.host_syncs]
        (sh, ih), (sd, idv) = (m.step(st, stress)
                               for m, st in zip((host, dev), states))
        assert idv == ih
        assert all(torch.equal(a, b) for a, b in zip(sd, sh))
        dsyncs = [host.host_syncs - syncs[0], dev.host_syncs - syncs[1]]
        if solver == "direct":
            assert dsyncs[1] == dsyncs[0] == 1
        else:
            assert ih.residual <= CG_TOL
            assert dsyncs[0] <= ih.iterations + 1
            if chunk == 1:
                assert dsyncs[1] == dsyncs[0]
            else:
                assert dsyncs[1] < ih.iterations
        states = [sh, sd]
    clones = [m.with_delta_t(0.0025) for m in (host, dev)]
    assert [c.cg_loop for c in clones] == ["host", "graphs"]
    assert clones[0]._graphs.eager and clones[0]._cg.eager
    assert [c._cg.chunk for c in clones] == [1, chunk]
    if solver == "mg_bf16_ir":
        assert all(isinstance(c._solve, tcg.ChunkedIRCG) for c in clones)
    (sh, ih), (sd, idv) = (c.step(st, stress) for c, st in zip(clones, states))
    assert idv == ih
    assert all(torch.equal(a, b) for a, b in zip(sd, sh))


def test_device_step_rejects_other_input_shapes(models):
    """The device step's buffers are fixed at its first step: a state of
    another dtype raises rather than being cast."""
    dev = models["jacobi_f64"][1]
    st = dev.initial_state()
    dev.step(st, _stress(dev))
    with pytest.raises(ValueError, match="buffers"):
        dev.step(type(st)(*(t.float() for t in st)), _stress(dev))
