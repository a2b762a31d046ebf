"""Krylov and multigrid solvers of the PyTorch package against the JAX
package: CG iteration counts on an f64 SPD structured problem, the
power-iteration lam_max from the same start vector, one V-cycle of the
f64 multigrid hierarchy (rtol 1e-10) and of the bf16 one (relative L2
3e-2), and the bf16 rounding rules of the hierarchy; and the chunked CG
(`ChunkedCG`, run eagerly on the CPU) against the host loop, bit for
bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxDofSpace
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu.ops.structured import (
    make_structured_operator as jax_structured,
)
from dealii_adapter_tpu.solvers import cg as jcg
from dealii_adapter_tpu.solvers.multigrid import GeometricMultigrid as JaxMG
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.ops.element_ops import (
    ElementMatrices,
    assemble_dense,
    assemble_diagonal,
)
from dealii_adapter_tpu_torch.ops.q2_structured import make_q2_operator
from dealii_adapter_tpu_torch.ops.structured import make_structured_operator
from dealii_adapter_tpu_torch.solvers import cg as tcg
from dealii_adapter_tpu_torch.solvers import multigrid as tmg_mod
from dealii_adapter_tpu_torch.solvers.direct import DenseCholesky
from dealii_adapter_tpu_torch.solvers.multigrid import GeometricMultigrid

torch.set_num_threads(1)
MU, NU, RHO = 0.5e6, 0.4, 1000.0
LAM = 2 * MU * NU / (1 - 2 * NU)
A1 = 1.0 / (0.25 * 0.01**2)  # Newmark alpha_1 at dt = 0.01


def _problem(dim, degree, scale=1):
    """Masked K + alpha_1 M on the PF flap, in both packages (f64)."""
    jm, jtags = jax_grid("PF", dim, degree, scale=scale, solver="neo-Hookean")
    tm, ttags = make_scenario_grid("PF", dim, degree, scale=scale,
                                   solver="neo-Hookean")
    js, ts = JaxDofSpace.create(jm), DofSpace.create(tm)
    el = ElementMatrices(ts, LAM, MU, RHO)
    E = el.K_e + A1 * el.M_e
    mask_np = ts.dirichlet_mask(ttags["clamped"], ttags.get("out_of_plane"))
    diag_np = mask_np * assemble_diagonal(ts, E) + (1 - mask_np)

    jop_raw = jax_structured(js, E, jnp.float64)
    jmask = jnp.asarray(mask_np)

    def jop(v):
        return jmask * jop_raw(jmask * v) + (1 - jmask) * v

    top_raw = make_structured_operator(ts, E, torch.float64, "cpu")
    tmask = torch.as_tensor(mask_np)

    def top(v):
        return tmask * top_raw(tmask * v) + (1 - tmask) * v

    return dict(
        jm=jm, jtags=jtags, tm=tm, ttags=ttags, ts=ts, E=E, el=el,
        jop=jop, top=top, jmask=jmask, tmask=tmask,
        jdiag=jnp.asarray(diag_np), tdiag=torch.as_tensor(diag_np),
    )


@pytest.mark.parametrize("precond", ["jacobi", "chebyshev"])
def test_cg_iterations_match_jax(precond):
    P = _problem(3, 2)
    rng = np.random.default_rng(0)
    b = np.asarray(P["tmask"]) * rng.standard_normal((P["ts"].n_nodes, 3))
    tol = 1e-8 * np.linalg.norm(b)
    if precond == "jacobi":
        jM = jcg.jacobi_preconditioner(P["jdiag"])
        tM = tcg.jacobi_preconditioner(P["tdiag"])
    else:
        # one bound for both packages: the polynomial is what is compared
        lam = 1.1 * float(jcg.estimate_lambda_max(P["jop"], P["jdiag"], b.shape))
        jM = jcg.chebyshev_preconditioner(P["jop"], P["jdiag"], lam, degree=3)
        tM = tcg.chebyshev_preconditioner(P["top"], P["tdiag"], lam, degree=3)
    jr = jcg.cg_solve(P["jop"], jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
                      tol=tol, max_iter=5000, preconditioner=jM)
    tr = tcg.cg_solve(P["top"], torch.as_tensor(b), torch.zeros(b.shape,
                      dtype=torch.float64), tol=tol, max_iter=5000,
                      preconditioner=tM)
    assert bool(jr.converged) and tr.converged
    assert tr.iterations == int(jr.iterations)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(jr.x)).max())
    # the chunked loop takes the JAX loop's count too (and the host loop's
    # bits: test_chunked_cg_equals_the_host_loop)
    cr = tcg.ChunkedCG(P["top"], tM, chunk=4)(
        torch.as_tensor(b), torch.zeros(b.shape, dtype=torch.float64), tol,
        5000)
    assert cr.iterations == int(jr.iterations) and cr.converged
    assert torch.equal(cr.x, tr.x)


@functools.lru_cache(maxsize=None)
def _chunk_problem(precond):
    """An f32 system of the 3D PF flap at scale 1 (the masked K + alpha_1 M
    in f32) with a preconditioner: none, Jacobi, or the models' bf16
    V-cycle (K5's and K3's plain versions on the CPU)."""
    P = _problem(3, 2)
    top = make_structured_operator(P["ts"], P["E"], torch.float32, "cpu")
    mk = P["tmask"].float()

    def op(v):
        return mk * top(mk * v) + (1.0 - mk) * v

    diag = P["tdiag"].float()
    if precond == "none":
        M = None
    elif precond == "jacobi":
        M = tcg.jacobi_preconditioner(diag)
    else:
        proxy = make_q2_operator(P["ts"], P["E"], torch.bfloat16, "cpu")
        bk = mk.to(torch.bfloat16)
        M = GeometricMultigrid(
            P["tm"], P["ttags"], lambda v: bk * proxy(bk * v) + (1.0 - bk) * v,
            diag.to(torch.bfloat16), bk, lmbda=LAM, mu=MU,
            mass_coeff=A1 * RHO, smooth_degree=3, smooth_degree_fine=1,
            coarse_size=300, dtype=torch.bfloat16, device="cpu",
        )
    b = torch.from_numpy(
        (np.random.default_rng(5).standard_normal((P["ts"].n_nodes, 3))
         * np.asarray(P["tmask"])).astype(np.float32))
    return op, M, b


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("form", ["graphs", "eager", "tensor_tol"])
@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("case", ["converges", "cap", "b_zero", "exact_start"])
@pytest.mark.parametrize("precond", ["none", "jacobi", "vcycle_bf16"])
def test_chunked_cg_equals_the_host_loop(precond, case, chunk, form):
    """`ChunkedCG` run eagerly on the CPU against the host-loop `cg_solve`:
    the iterate, iteration count, residual and convergence flag bit for
    bit, for solves that end inside a chunk, at the `max_iter` cap, with
    b = 0 and from the exact solution (r = p = 0, where the masked
    iterations compute 0/0: the state must stay finite). `form`: the
    solver the models build under `cg_loop="graphs"` (captured on a card,
    eager here), the one they build under `"host"` (`make_cg`,
    `eager=True`), and the latter given its tolerance as a 0-dim tensor,
    as the Newton loop does (both loops then read it as a tensor)."""
    op, M, b = _chunk_problem(precond)
    x0 = torch.zeros_like(b)
    tol, max_iter = 1e-4 * float(torch.linalg.vector_norm(b)), 500
    if case == "cap":
        max_iter = 5
    elif case == "b_zero":
        b = torch.zeros_like(b)
    elif case == "exact_start":
        # any x0 is the exact solution of b = op(x0), bit for bit
        x0 = torch.from_numpy(np.random.default_rng(6).standard_normal(
            tuple(b.shape)).astype(np.float32))
        b = op(x0)
    if form == "tensor_tol":
        tol = torch.tensor(tol, dtype=torch.float64)
    host = tcg.cg_solve(op, b, x0, tol, max_iter, M)
    if form == "graphs":
        solve = tcg.make_cg("graphs", op, M, chunk)
        assert not solve.eager
    else:
        solve = tcg.make_cg("host", op, M, chunk)
        assert isinstance(solve, tcg.ChunkedCG) and solve.eager
    for _ in range(2):  # a second solve reuses the buffers
        r = solve(b, x0, tol, max_iter)
        assert torch.equal(_bits(r.x), _bits(host.x))
        assert (r.iterations, r.residual_norm, r.converged) == (
            host.iterations, host.residual_norm, host.converged)
        assert r.host_syncs == max(1, -(-host.iterations // chunk))
    assert bool(torch.isfinite(r.x).all())
    if case == "converges":
        assert host.converged and host.iterations > chunk
    elif case == "cap":
        assert not host.converged and host.iterations == max_iter
    else:
        assert host.iterations == 0 and host.converged
    with pytest.raises(ValueError, match="buffers"):
        solve(b[:-1], x0[:-1], tol, max_iter)


def test_make_cg_builds_one_chunked_loop():
    """Both `cg_loop` values build a `ChunkedCG` (eager under "host", where
    gloo ranks cannot capture their collectives): one CG loop in the
    models, `cg_solve` left as the oracle. At chunks of 1 a solve of k
    iterations reads back k times, one fewer than `cg_solve`'s k + 1."""
    op, M, b = _chunk_problem("jacobi")
    tol = 1e-4 * float(torch.linalg.vector_norm(b))
    for loop, eager in (("graphs", False), ("host", True)):
        solve = tcg.make_cg(loop, op, M, 1)
        assert type(solve) is tcg.ChunkedCG and solve.eager is eager
        assert (solve.operator, solve.chunk) == (op, 1)
        r = solve(b, torch.zeros_like(b), tol, 500)
        host = tcg.cg_solve(op, b, torch.zeros_like(b), tol, 500, M)
        assert r.iterations == host.iterations > 1
        assert r.host_syncs == host.host_syncs - 1 == host.iterations
    with pytest.raises(ValueError, match="cg_loop"):
        tcg.make_cg("device", op, M)


def test_lambda_max_from_jax_start_vector():
    P = _problem(3, 2)
    shape = (P["ts"].n_nodes, 3)
    lj = float(jcg.estimate_lambda_max(P["jop"], P["jdiag"], shape))
    v0 = np.array(jax.random.normal(jax.random.PRNGKey(0), shape,
                                      dtype=jnp.float64))
    lt = tcg.estimate_lambda_max(P["top"], P["tdiag"], shape,
                                 v0=torch.as_tensor(v0))
    np.testing.assert_allclose(lt, lj, rtol=1e-10)
    # the default start vector is seeded and reproducible
    a = tcg.estimate_lambda_max(P["top"], P["tdiag"], shape)
    assert a == tcg.estimate_lambda_max(P["top"], P["tdiag"], shape)
    np.testing.assert_allclose(a, lj, rtol=0.05)


@pytest.mark.parametrize("dim,coarse_size", [(3, 300), (2, 100)])
def test_vcycle_matches_jax(dim, coarse_size):
    """One V-cycle of the f64 hierarchy (FEM-SEM level, semi-coarsened Q1
    levels, dense Cholesky coarse solve) on a random vector."""
    P = _problem(dim, 2)
    kw = dict(
        lmbda=LAM, mu=MU, mass_coeff=A1 * RHO, smooth_degree=3,
        smooth_degree_fine=1, coarse_size=coarse_size,
    )
    jmg = JaxMG(P["jm"], P["jtags"], P["jop"], P["jdiag"], P["jmask"],
                dtype=jnp.float64, use_pallas=False, level_backend="xla", **kw)
    assert len(jmg.levels) >= 3  # semi-coarsened levels are exercised
    tmg = GeometricMultigrid(
        P["tm"], P["ttags"], P["top"], P["tdiag"], P["tmask"],
        dtype=torch.float64, lam_max=[lv.lam_max for lv in jmg.levels],
        device="cpu", **kw
    )
    assert [lv.grid_shape for lv in tmg.levels] == [
        lv.grid_shape for lv in jmg.levels
    ]
    r = np.random.default_rng(1).standard_normal((P["ts"].n_nodes, dim))
    a = np.asarray(jmg(jnp.asarray(r)))
    b = tmg(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10 * np.abs(a).max())
    # the hierarchy's own power iterations land near JAX's estimates
    own = GeometricMultigrid(P["tm"], P["ttags"], P["top"], P["tdiag"],
                             P["tmask"], dtype=torch.float64, device="cpu",
                             **kw)
    np.testing.assert_allclose(
        [lv.lam_max for lv in own.levels], [lv.lam_max for lv in jmg.levels],
        rtol=0.05,
    )


@pytest.mark.parametrize("dim,coarse_size", [(3, 300), (2, 100)])
def test_vcycle_bf16_matches_jax(dim, coarse_size, monkeypatch):
    """One V-cycle of the bf16 hierarchy, as the models build it (the fine
    proxy from `make_q2_operator`), against the JAX package's bf16 V-cycle
    (`level_backend="xla"`, the XLA operators the JAX package runs off the
    TPU), both with one set of lam_max values: the port's estimates, handed
    to the JAX hierarchy in place of its own power iterations (which take
    ~18 s in 3D on the CPU). Tolerance: relative L2 3e-2; the two round to
    bf16 (unit roundoff 2^-8 = 3.9e-3) at different places over a few
    dozen stages, and each lands 0.5-1.3e-2 from the f64 V-cycle."""
    P = _problem(dim, 2)
    kw = dict(
        lmbda=LAM, mu=MU, mass_coeff=A1 * RHO, smooth_degree=3,
        smooth_degree_fine=1, coarse_size=coarse_size,
    )
    top = make_q2_operator(P["ts"], P["E"], torch.bfloat16, "cpu")
    tmk = P["tmask"].to(torch.bfloat16)
    tmg = GeometricMultigrid(
        P["tm"], P["ttags"], lambda v: tmk * top(tmk * v) + (1.0 - tmk) * v,
        P["tdiag"].to(torch.bfloat16), tmk, dtype=torch.bfloat16,
        device="cpu", **kw,
    )
    lam = iter([lv.lam_max for lv in tmg.levels])
    # the JAX hierarchy imports it from its cg module at each estimate
    monkeypatch.setattr(jcg, "estimate_lambda_max", lambda *a, **k: next(lam))
    bf = jnp.bfloat16
    jop = jax_structured(JaxDofSpace.create(P["jm"]), P["E"], bf,
                         precision="default")
    jmk = P["jmask"].astype(bf)
    jmg = JaxMG(P["jm"], P["jtags"],
                lambda v: jmk * jop(jmk * v) + (1.0 - jmk) * v,
                P["jdiag"].astype(bf), jmk, dtype=bf, use_pallas=False,
                level_backend="xla", **kw)
    assert [lv.lam_max for lv in jmg.levels] == [lv.lam_max for lv in tmg.levels]
    r = (np.random.default_rng(1).standard_normal((P["ts"].n_nodes, dim))
         * np.asarray(P["tmask"])).astype(np.float32)
    a = np.asarray(jmg(jnp.asarray(r)), np.float64)
    b = tmg(torch.from_numpy(r))
    assert b.dtype == torch.float32  # the caller's dtype
    b = b.double().numpy()
    assert np.isfinite(b).all()
    assert np.linalg.norm(b - a) / np.linalg.norm(a) <= 3e-2


def test_bf16_hierarchy_rounds_as_the_reference():
    """The rounding rules of the bf16 hierarchy: cuBLAS may not reduce bf16
    or fp16 products in reduced precision (the transfers are bf16 matrix
    products; PyTorch on the CPU and XLA sum them in f32); a fine proxy
    without a kernel computes in bf16 as the JAX package's
    `StructuredOperator` does (element matrix in bf16, one bf16 matrix
    product, overlap-add rounded after each slot; with the f32 element
    matrix the 2D linear step took ~1.7x the JAX package's CG iterations
    at 250,850 DoF, computed in f32 and rounded once the 2D Neo-Hookean
    step 0 took 39 against 27 at 63,218); the Chebyshev polynomial's
    coefficients round to the hierarchy dtype, as JAX rounds weakly typed
    scalars (PyTorch keeps a bf16 op's scalar in f32), and the smoother's
    closing update is computed in `out_dtype` when the V-cycle asks for
    it; f32 and f64 hierarchies compute as before."""
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    assert torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction is False
    P = _problem(2, 2)
    v = torch.from_numpy(
        np.random.default_rng(3).standard_normal((P["ts"].n_nodes, 2))
    ).to(torch.bfloat16)
    ref = make_structured_operator(P["ts"], P["E"], torch.bfloat16, "cpu")
    assert ref.EpT.dtype == torch.bfloat16
    out = make_q2_operator(P["ts"], P["E"], torch.bfloat16, "cpu")(v)
    torch.testing.assert_close(out, ref(v), rtol=0, atol=0)
    for dt in (torch.float32, torch.float64):
        ref = make_structured_operator(P["ts"], P["E"], dt, "cpu")
        torch.testing.assert_close(
            make_q2_operator(P["ts"], P["E"], dt, "cpu")(v.to(dt)),
            ref(v.to(dt)), rtol=0, atol=0)
    # one Chebyshev sweep: every operation rounds to the dtype, and so do
    # the polynomial's coefficients
    diag = torch.full((P["ts"].n_nodes, 2), 3.0)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (P["ts"].n_nodes, 2)))
    lmax, lmin = 0.7 * 1.05, 0.7 / 4.0
    theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho1 = 1.0 / (2.0 * sigma - 1.0 / sigma)
    for dt in (torch.bfloat16, torch.float32):
        level = tmg_mod.MGLevel(operator=lambda x: 2.0 * x, diag=diag.to(dt),
                                mask=torch.ones_like(diag), grid_shape=(),
                                lam_max=0.7)
        got = tmg_mod._chebyshev_smooth(
            level, b.to(dt), torch.zeros_like(b, dtype=dt), 1, x_is_zero=True)
        c = [torch.tensor(x, dtype=dt).item()
             for x in (1.0 / theta, rho1 / sigma, 2.0 * rho1 / delta)]
        inv = 1.0 / diag.to(dt)
        d = c[0] * (inv * b.to(dt))
        d2 = c[1] * d + c[2] * (inv * (b.to(dt) - 2.0 * d))
        torch.testing.assert_close(got, d + d2, rtol=0, atol=0)
        wide = tmg_mod._chebyshev_smooth(
            level, b.to(dt), torch.zeros_like(b, dtype=dt), 1, x_is_zero=True,
            out_dtype=torch.float32)
        assert wide.dtype == torch.float32
        torch.testing.assert_close(wide, d.float() + d2.float(), rtol=0, atol=0)
    assert c[0] == torch.tensor(1.0 / theta, dtype=torch.float32).item()


def test_dense_cholesky_solves():
    P = _problem(2, 1)
    A = assemble_dense(P["ts"], P["E"])
    m = np.asarray(P["tmask"]).reshape(-1)
    A = A * m[:, None] * m[None, :] + np.diag(1 - m)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    x = DenseCholesky(A, device="cpu").solve(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-10,
                               atol=1e-12 * np.abs(x).max())
