"""The PyTorch package's jvp tangent against the JAX package's: the f64
operator (forward-mode AD of the whole residual) against
`jax.linearize(rhs_fn)` and against the f64 assembled tangent, the f32
operator against the JAX package's `K32` jvp branch, the tangent
selection (the oversize fallback and the `ValueError`s), the chunked CG
over each jvp operator against the host loop (bit for bit), a TF32
emulation of the f32 operator's matrix products, and whole steps: the
reference's own Neo-Hookean configuration (FSI3, Q4, f64 Jacobi CG) for
three steps, and `tangent_backend="jvp"` against `"assembled"` and the
JAX jvp path."""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.overrides import TorchFunctionMode

import dealii_adapter_tpu as jdat
import dealii_adapter_tpu.models.nonlinear_elasticity as jax_nl
from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu.models.nonlinear_elasticity import (
    NonlinearState as JaxState,
)
from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.convert import (
    params_from_jax,
    state_from_numpy,
    state_to_numpy,
)
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
    forward_jvp,
)
from dealii_adapter_tpu_torch.ops.assembled_tangent import tangent_bytes
from test_torch_newton_device import cg_solve_oracle

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE = dict(
    model="neo-Hookean", type_lin="CG", scenario="PF", poly_degree=2,
    delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0, dtype="float64",
)
# bench.py's production configuration (3D scale 1: 2,331 DoF)
PRODUCTION = dict(
    BASE, dim=3, tol_lin=1e-6, tol_u=1e-6, tol_f=1e-9, max_iterations_NR=10,
    max_iterations_lin=1.0, preconditioner="MG", precond_dtype="bfloat16",
    solve_dtype="float32", newton_forcing="ew", mg_smooth_degree=3,
    mg_fine_smooth_degree=1, newton_predictor=True, ew_eta0=0.3,
)


def _models(dim, scale, **kw):
    """The JAX and ported models of one configuration on the PF flap."""
    jp = JaxParams(**dict(BASE, dim=dim, **kw))
    jmesh, jtags = jax_grid("PF", dim, 2, scale=scale, solver="neo-Hookean")
    mesh, tags = make_scenario_grid("PF", dim, 2, scale=scale,
                                    solver="neo-Hookean")
    jm = jax_nl.NonlinearElasticity(jp, mesh=jmesh, tags=jtags)
    tm = NonlinearElasticity(params_from_jax(jp), mesh=mesh, tags=tags,
                             device="cpu")
    return jm, tm


def _stress(model, magnitude, dim):
    s = np.zeros((model.space.n_nodes, dim))
    s[model.space.boundary_nodes[model.interface_id], 0] = magnitude
    return s


def _point(tm, seed):
    """A random iterate: (state arrays, delta, direction, stress); the
    displacements small enough that det F > 0 at every quadrature point."""
    rng = np.random.default_rng(seed)
    n, dim = tm.space.n_nodes, tm.space.dim
    mask = tm.mask.numpy()
    u = 1e-4 * rng.standard_normal((n, dim)) * mask
    vel = 0.01 * rng.standard_normal((n, dim))
    acc = 0.01 * rng.standard_normal((n, dim))
    delta = 1e-4 * rng.standard_normal((n, dim)) * mask
    v = rng.standard_normal((n, dim))
    return (u, vel, acc), delta, v, _stress(tm, 500.0, dim)


def test_forward_jvp_drops_a_detached_tangent():
    """`forward_jvp` is forward-mode AD in which `.detach()` drops the
    tangent, as JAX's `stop_gradient` does: the f64 jvp tangent relies on
    it to leave out the Neumann pull-back's linearization."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(50, generator=g, dtype=torch.float64)
    t = torch.randn(50, generator=g, dtype=torch.float64)
    got = forward_jvp(lambda y: 3.0 * y.detach() + y * y, x, t)
    assert torch.equal(got, 2.0 * x * t)
    assert torch.equal(forward_jvp(lambda y: y.detach() * 2.0, x, t),
                       torch.zeros_like(x))


@pytest.mark.parametrize("dim,scale", [(2, 1), (2, 2), (3, 1)])
def test_f64_jvp_operator_matches_jax(dim, scale):
    """The f64 jvp operator K(v) = mask (-J_rhs(mask v)) + (1 - mask) v at
    a random iterate equals the JAX package's (`jax.linearize` of its
    residual) to rtol 1e-12 and the f64 assembled tangent's matvec to
    1e-10; the external force contributes no derivative (its pull-back is
    detached), so the operator of the residual without it is the same."""
    jm, tm = _models(dim, scale, solve_dtype="", preconditioner="Jacobi")
    assert not tm._use_assembled and not tm._mixed_tangent
    (u, vel, acc), delta, v, stress = _point(tm, seed=dim + scale)
    js = JaxState(jnp.asarray(u), jnp.asarray(vel), jnp.asarray(acc))
    mask = np.asarray(jm.mask)

    def rhs_fn(d):
        return jm.residual(d, js, jnp.asarray(stress))[0]

    _, jvp = jax.linearize(rhs_fn, jnp.asarray(delta))
    want = mask * (-np.asarray(jvp(jnp.asarray(mask * v)))) + (1.0 - mask) * v
    assert np.isfinite(want).all()

    ts = state_from_numpy(u, vel, acc, device="cpu")
    d_t, v_t, s_t = (torch.as_tensor(x) for x in (delta, v, stress))
    _, K = tm._make_jvp_tangent(d_t, ts, s_t)
    got = K(v_t).numpy()
    scale_ = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale_)

    assemble_Kt, make_tangent_matvec = tm._make_tangent_fns()
    K_asm = make_tangent_matvec(assemble_Kt(ts.displacement + d_t))
    np.testing.assert_allclose(K_asm(v_t).numpy(), got, rtol=1e-10,
                               atol=1e-10 * scale_)

    def ext(d):
        return tm.external_force(ts.displacement + d, s_t)

    def rhs_without_ext(d):
        return tm.residual(d, ts, s_t)[0] - tm.mask * ext(d)

    assert not torch.any(forward_jvp(ext, d_t, v_t))
    mv = tm.mask * v_t
    K_noext = tm.mask * (-forward_jvp(rhs_without_ext, d_t, mv)) + (1.0 - tm.mask) * v_t
    np.testing.assert_allclose(K_noext.numpy(), got, rtol=0, atol=1e-12 * scale_)


@pytest.mark.parametrize("dim", [2, 3])
def test_f32_jvp_operator_matches_jax(dim):
    """The f32 jvp operator (a mixed solve with `tangent_backend="jvp"`)
    K32(v) = mask_t (J_int(mask_t v) + a1 M_t(mask_t v)) + (1 - mask_t) v
    equals the JAX package's jvp branch of `do_solve` to rtol 1e-5."""
    jm, tm = _models(dim, 1, solve_dtype="float32", tangent_backend="jvp",
                     preconditioner="Jacobi")
    assert not tm._use_assembled and tm._mixed_tangent
    (u, vel, acc), delta, v, stress = _point(tm, seed=10 + dim)
    u_t = jnp.asarray(u + delta).astype(jnp.float32)
    _, jvp_int = jax.linearize(jm._int_force_t, u_t)
    mask_t = jm.mask_t
    mv = mask_t * jnp.asarray(v, dtype=jnp.float32)
    want = np.asarray(mask_t * (jvp_int(mv) + jm.alpha_1 * jm.M_t(mv))
                      + (1.0 - mask_t) * jnp.asarray(v, dtype=jnp.float32))
    assert np.isfinite(want).all()

    ts = state_from_numpy(u, vel, acc, device="cpu")
    _, K = tm._make_jvp_tangent(torch.as_tensor(delta), ts,
                                torch.as_tensor(stress))
    got = K(torch.as_tensor(v, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_auto_falls_back_when_tangent_too_big():
    params = AllParameters(**dict(PRODUCTION, assembled_tangent_max_gb=1e-6))
    mesh, tags = make_scenario_grid("PF", 3, 2, scale=1, solver="neo-Hookean")
    model = NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu")
    assert not model._use_assembled and model._mixed_tangent
    assert tangent_bytes(model.space, torch.float32) > 1e3


@pytest.mark.parametrize(
    "override,match",
    [(dict(solve_dtype=""), "requires type_lin='CG', solve_dtype narrower"),
     (dict(assembled_tangent_max_gb=1e-6), "GB for the per-cell tangents")],
    ids=["f64_solve", "too_big"],
)
def test_assembled_rejected(override, match):
    """`tangent_backend="assembled"` without a mixed solve, or with
    tangents above the cap, raises ValueError as in the JAX package."""
    params = AllParameters(**dict(PRODUCTION, tangent_backend="assembled",
                                  **override))
    mesh, tags = make_scenario_grid("PF", 3, 2, scale=1, solver="neo-Hookean")
    with pytest.raises(ValueError, match=match):
        NonlinearElasticity(params, mesh=mesh, tags=tags, device="cpu")


@pytest.mark.parametrize(
    "kw,steps",
    [(dict(dim=2, solve_dtype="", precond_dtype="float32"), 1),
     (dict(dim=3, tangent_backend="jvp"), 1),
     (dict(dim=2, solve_dtype="", preconditioner="Chebyshev"), 1),
     (dict(dim=2, solve_dtype="", preconditioner="None"), 1)],
    ids=["f64_jvp_2d_mg", "f32_jvp_3d_mg", "f64_jvp_2d_chebyshev",
         "f64_jvp_2d_none"],
)
def test_chunked_cg_on_jvp_equals_the_host_loop(kw, steps):
    """A production step with the CG in chunks of 3 (`cg_loop="graphs"`,
    eager on the CPU) over each jvp operator (f64 under an f32 V-cycle, a
    Chebyshev smoother or none in 2D, f32 under the bf16 V-cycle in 3D)
    gives the `NewtonInfo` and state of the same model with the host-loop
    `cg_solve` as its CG (the oracle,
    `test_torch_newton_device.cg_solve_oracle`) bit for bit; the
    linearization point lives in persistent buffers that every Newton
    iteration refills (a step from rest takes at least 4 Newton
    iterations here, so at least 3 refills)."""
    p = AllParameters(**dict(PRODUCTION, **kw))
    mesh, tags = make_scenario_grid("PF", p.dim, 2, scale=1,
                                    solver="neo-Hookean")
    host = cg_solve_oracle(NonlinearElasticity(
        p, mesh=mesh, tags=tags, device="cpu", cg_loop="host"))
    lam = ([lv.lam_max for lv in host._precond.levels]
           if p.preconditioner == "MG" else None)
    chunked = NonlinearElasticity(p, mesh=mesh, tags=tags, device="cpu",
                                  mg_lam_max=lam, cg_chunk=3)
    assert not chunked._use_assembled and chunked.cg_loop == "graphs"
    stress = torch.as_tensor(_stress(host, 1000.0, p.dim))
    states = [host.initial_state(), chunked.initial_state()]
    for _ in range(steps):
        (sh, ih), (sc, ic) = (m.step(st, stress)
                              for m, st in zip((host, chunked), states))
        assert ih.converged and ic == ih and ih.iterations >= 4
        assert all(torch.equal(a, b) for a, b in zip(sc, sh))
        states = [sh, sc]
    assert chunked.host_syncs < host.host_syncs


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """An f32 tensor rounded to TF32's 10-bit mantissa (to nearest, ties
    to even), as the tensor cores round matrix-product inputs under TF32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _TF32Products(TorchFunctionMode):
    """Rounds both operands of every f32 matrix product to TF32, primal and
    tangent alike (JAX's `bf16emu` tier does the same for one bf16
    pass, `dealii_adapter_tpu/ops/assembled_tangent.py:144-170`)."""

    PRODUCTS = ("matmul", "__matmul__", "mm", "bmm")  # `a @ b` is "matmul"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in self.PRODUCTS:
            args = tuple(self._round(a) for a in args)
        return func(*args, **(kwargs or {}))

    @staticmethod
    def _round(a):
        if not isinstance(a, torch.Tensor) or a.dtype != torch.float32:
            return a
        primal, tangent = fwAD.unpack_dual(a)
        if tangent is None:
            return _tf32(primal)
        return fwAD.make_dual(_tf32(primal), _tf32(tangent))


def test_tf32_products_would_spoil_the_f32_jvp_operator():
    """What the precision policy (TF32 off, `dealii_adapter_tpu_torch/
    __init__.py`) prevents: with the matrix products of the f32 jvp
    operator rounded to TF32, its error against the exact (f64) tangent
    grows from the f32 level (< 1e-5) by more than 30x, past the 1e-5
    bound the f32 operator parity tests hold."""
    p = AllParameters(**dict(PRODUCTION, tangent_backend="jvp"))
    mesh, tags = make_scenario_grid("PF", 3, 2, scale=1, solver="neo-Hookean")
    tm = NonlinearElasticity(p, mesh=mesh, tags=tags, device="cpu")
    (u, vel, acc), delta, v, stress = _point(tm, seed=21)
    ts = state_from_numpy(u, vel, acc, device="cpu")
    d_t, v_t = torch.as_tensor(delta), torch.as_tensor(v)
    _, K32 = tm._make_jvp_tangent(d_t, ts, torch.as_tensor(stress))
    u64, mv = ts.displacement + d_t, tm.mask * v_t
    Jv = forward_jvp(lambda x: tm._internal_force_and_J(x)[0], u64, mv)
    exact = tm.mask * (Jv + tm.alpha_1 * tm.M(mv)) + (1.0 - tm.mask) * v_t

    def err(K):
        got = K(v_t.to(torch.float32)).to(torch.float64)
        return float(torch.linalg.vector_norm(got - exact)
                     / torch.linalg.vector_norm(exact))

    e32 = err(K32)
    with _TF32Products():
        e_tf32 = err(K32)
    print(f"f32 jvp operator error against the exact tangent: {e32:.3e} "
          f"(f32 products), {e_tf32:.3e} (TF32 products)")
    assert e32 < 1e-5
    assert e_tf32 > 30 * e32 and e_tf32 > 1e-5, (e32, e_tf32)


def test_reference_default_steps_match_jax(monkeypatch):
    """The reference's own Neo-Hookean configuration
    (examples/nonlinear_elasticity.prm: FSI3 flap, Q4, 1,898 DoF, an f64
    CG with Jacobi on the f64 jvp tangent) for three steps of traction
    2000: the same Newton iterations as the JAX package, the fields within
    1e-9. Every Newton correction's CG count is within 3 of the JAX
    package's, except each step's last: those CGs end at the f64 floor
    (the tolerance tol_lin times a residual already at ~1e-10 relative),
    where the two summation orders make the CG stagnate for different
    lengths (the port's 756 against 684 and 776 against 838 iterations in
    steps 1 and 2, printed below), so there both only converge."""
    jp = jdat.parse_prm(os.path.join(REPO, "examples", "nonlinear_elasticity.prm"))
    jax_its = []
    cg_solve = jax_nl.cg_solve

    def recorded_cg(*args, **kw):
        r = cg_solve(*args, **kw)
        jax.debug.callback(lambda k: jax_its.append(int(k)), r.iterations)
        return r

    monkeypatch.setattr(jax_nl, "cg_solve", recorded_cg)
    jm = jax_nl.NonlinearElasticity(jp)
    tm = NonlinearElasticity(params_from_jax(jp), device="cpu")
    assert (tm.space.n_dofs, tm.solve_dtype) == (1898, torch.float64)
    assert not tm._use_assembled and tm.params.preconditioner == "Jacobi"
    port_its = []
    solve = tm._solve

    def recorded_solve(*args, **kw):
        du, its, asm = solve(*args, **kw)
        port_its.append(its)
        return du, its, asm

    tm._solve = recorded_solve
    stress = _stress(tm, 2000.0, 2)
    js, ts = jm.initial_state(), tm.initial_state()
    for _ in range(3):
        js, ji = jm.step(js, jnp.asarray(stress))
        ts, ti = tm.step(ts, torch.as_tensor(stress))
        assert bool(ji.converged) and ti.converged
        assert ti.iterations == int(ji.iterations)
        assert ti.tangent_assemblies == int(ji.tangent_assemblies)
        for got, want in zip(state_to_numpy(ts), (js.displacement, js.velocity,
                                                   js.acceleration)):
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-9 * np.abs(want).max())
    print(f"CG per Newton correction, port {port_its}, JAX {jax_its}")
    assert len(port_its) == len(jax_its) == 15
    last = {4, 9, 14}
    for i, (a, b) in enumerate(zip(port_its, jax_its)):
        if i not in last:
            assert abs(a - b) <= 3, (i, port_its, jax_its)


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


def _production(tangent_backend, **kw):
    """The production configuration with `kw` and its JAX model, whose
    hierarchy takes the port's lam_max estimates."""
    jp = JaxParams(**dict(PRODUCTION, tangent_backend=tangent_backend, **kw))
    mesh, tags = make_scenario_grid("PF", jp.dim, 2, scale=1,
                                    solver="neo-Hookean")
    lam = [lv.lam_max for lv in NonlinearElasticity(
        params_from_jax(jp), mesh=mesh, tags=tags, device="cpu"
    )._precond.levels]
    jmesh, jtags = jax_grid("PF", jp.dim, 2, scale=1, solver="neo-Hookean")
    with _jax_takes_lam_max(lam):
        jm = jax_nl.NonlinearElasticity(jp, mesh=jmesh, tags=jtags)
    assert [lv.lam_max for lv in jm._precond.levels] == lam
    return jp, jm


def _port(jp, jm, **kw):
    mesh, tags = make_scenario_grid("PF", jp.dim, 2, scale=1,
                                    solver="neo-Hookean")
    p = dataclasses.replace(params_from_jax(jp), **kw)
    return NonlinearElasticity(p, mesh=mesh, tags=tags, device="cpu",
                               mg_lam_max=[lv.lam_max for lv in jm._precond.levels])


def test_jvp_backend_steps_match_assembled_and_jax():
    """Two production steps with `tangent_backend="jvp"` (the f32 jvp
    tangent) take the Newton iterations of the port's assembled tangent
    and of the JAX package's jvp path, and their displacements agree
    within 1e-6 relative (the JAX package's
    test_model_step_equivalent_backends). On the 2D flap (518 DoF; 4-5
    Newton iterations a step, the jvp tangent's linearization point
    refilled at each): the JAX package's 2D step compiles in about a
    fifth of its 3D step's time, and the f32 jvp tangent in 3D is held
    against the JAX package's by `test_f32_jvp_operator_matches_jax[3]`
    and `test_chunked_cg_on_jvp_equals_the_host_loop[f32_jvp_3d_mg]`."""
    jp, jm = _production("jvp", dim=2)
    assert not jm._use_assembled
    models = {b: _port(jp, jm, tangent_backend=b) for b in ("jvp", "assembled")}
    for b, m in models.items():
        assert m._use_assembled == (b == "assembled")
    stress = _stress(jm, 1000.0, 2)
    js = jm.initial_state()
    states = {b: m.initial_state() for b, m in models.items()}
    for _ in range(2):
        js, ji = jm.step(js, jnp.asarray(stress))
        infos = {}
        for b, m in models.items():
            states[b], infos[b] = m.step(states[b], torch.as_tensor(stress))
            assert infos[b].converged
        assert infos["jvp"].iterations == infos["assembled"].iterations
        assert infos["jvp"].iterations == int(ji.iterations)
    u_jvp = states["jvp"].displacement.numpy()
    for other in (states["assembled"].displacement.numpy(),
                  np.asarray(js.displacement)):
        assert np.linalg.norm(u_jvp - other) / np.linalg.norm(other) < 1e-6


def test_tf32_products_would_spoil_the_linear_stepping_matrix():
    """The same emulation on the linear model's f32 stepping matrix
    A = M + (theta dt)^2 K (the f32 inner solve's operator,
    `StructuredOperator`'s one product; tests/test_golden_trajectory.py's
    linear configuration with the f32 solve, 2D Q2, 518 DoF): against the
    f64 matrix on the same f32 vector its error is f32 rounding (~1e-7,
    within the 1e-5 bound of the f32 parity tests) with TF32 off, and
    with TF32 products past that bound (~2.5e-4)."""
    from dealii_adapter_tpu_torch.models.linear_elasticity import (
        LinearElastodynamics,
    )

    p = AllParameters(model="linear", type_lin="CG", scenario="PF", dim=2,
                      poly_degree=2, delta_t=0.005, theta=0.5, mu=0.5e6,
                      nu=0.4, rho=1000.0, solve_dtype="float32")
    m = LinearElastodynamics(p, device="cpu")
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (m.space.n_nodes, 2)), dtype=torch.float32)
    exact = m.A(v.double())

    def err():
        got = m.A_lo(v).double()
        return float((got - exact).abs().max() / exact.abs().max())

    e32 = err()
    with _TF32Products():
        e_tf32 = err()
    print(f"f32 stepping matrix error: {e32:.3e} (f32 products), "
          f"{e_tf32:.3e} (TF32 products)")
    assert e32 < 1e-6
    assert e_tf32 > 1e-5, (e32, e_tf32)


def test_tf32_products_would_spoil_the_tangent_assembly():
    """The same emulation on the f32 tangent assembly
    (`ops/assembled_tangent.py:assemble_cell_tangents`, 2D Q2 flap): the
    gradient products are f32 (the contraction sums in f64, which TF32
    does not touch). At a deformation with grad u ~ 0.1 the f32 blocks are
    within f32 rounding of the f64 ones (~1.6e-7 of the largest entry)
    with TF32 off, and past the 1e-5 bound of the assembly parity tests
    (tests/test_torch_assembled_tangent.py) with TF32 products (~2e-4).
    At grad u ~ 1e-2 TF32 stays inside that bound (~4e-6)."""
    from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
    from dealii_adapter_tpu_torch.models.material import NeoHookean
    from dealii_adapter_tpu_torch.ops import assembled_tangent as tat

    mesh, _ = make_scenario_grid("PF", 2, 2, solver="neo-Hookean")
    space = DofSpace.create(mesh, n_q_1d=4)
    h = np.asarray(mesh.cell_h)
    G = space.tab.dN / h[None, None, :]
    w = space.tab.q_weights * float(np.prod(h))
    ut = 1e-3 * np.random.default_rng(0).standard_normal(
        (2, space.tab.n_nodes, int(np.prod(mesh.reps))))
    material = NeoHookean(0.5e6, 0.4, 1000.0)

    def blocks(dtype):
        K = tat.assemble_cell_tangents(
            *(torch.as_tensor(x, dtype=dtype) for x in (ut, G, w)), material)
        return torch.stack([K[d][e] for d in range(2) for e in range(2)])

    exact = blocks(torch.float64)

    def err():
        got = blocks(torch.float32).double()
        return float((got - exact).abs().max() / exact.abs().max())

    e32 = err()
    with _TF32Products():
        e_tf32 = err()
    print(f"f32 tangent assembly error: {e32:.3e} (f32 products), "
          f"{e_tf32:.3e} (TF32 products)")
    assert e32 < 1e-6
    assert e_tf32 > 1e-5, (e32, e_tf32)
