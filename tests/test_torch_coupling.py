"""The coupling and output modules of the PyTorch package against the JAX
package: the copied host modules (time handler, participants, timer,
strain postprocessor, VTU writer) behave and write identically; the
port's `coupled_run` reproduces the JAX package's participant write
histories (rtol 1e-9 linear, 1e-6 Neo-Hookean) for explicit coupling,
implicit coupling with rollback, fractional-window subcycling and the
closed-loop surrogate fluid; checkpoints are clones; `with_delta_t`
clones are memoized; and a 3D Neo-Hookean step with the stencil multigrid
levels matches the JAX package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.adapter import Adapter as JaxAdapter
from dealii_adapter_tpu.adapter import FakeParticipant as JaxFake
from dealii_adapter_tpu.adapter.participant import (
    PreciceParticipant as JaxPrecice,
)
from dealii_adapter_tpu.adapter.participant import (
    SurrogateFluidParticipant as JaxSurrogate,
)
from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxDofSpace
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu.models.linear_elasticity import (
    LinearElastodynamics as JaxLinear,
)
from dealii_adapter_tpu.models.nonlinear_elasticity import (
    NonlinearElasticity as JaxNonlinear,
)
from dealii_adapter_tpu.runner import coupled_run as jax_coupled_run
from dealii_adapter_tpu.time_handler import Time as JaxTime
from dealii_adapter_tpu.utils import TimerOutput as JaxTimer
from dealii_adapter_tpu.utils import compute_nodal_strain as jax_strain
from dealii_adapter_tpu.utils import write_vtu as jax_write_vtu
from dealii_adapter_tpu_torch.adapter import (
    Adapter,
    FakeParticipant,
    PreciceParticipant,
    SurrogateFluidParticipant,
    make_participant,
)
from dealii_adapter_tpu_torch.convert import params_from_jax, state_to_numpy
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.models.linear_elasticity import (
    LinearElastodynamics,
)
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
)
from dealii_adapter_tpu_torch.runner import NewtonDivergedError, coupled_run
from dealii_adapter_tpu_torch.time_handler import Time
from dealii_adapter_tpu_torch.utils import (
    TimerOutput,
    compute_nodal_strain,
    write_vtu,
)

torch.set_num_threads(1)

LINEAR = dict(model="linear", type_lin="CG", scenario="PF", delta_t=0.01,
              end_time=0.03, poly_degree=2, mu=0.5e6, nu=0.4, rho=1000.0,
              theta=0.5)
NEO_HOOKEAN = dict(LINEAR, model="neo-Hookean", poly_degree=1, end_time=0.02,
                   tol_lin=1e-8)


def _traction(t, xy):
    return np.stack([np.full(len(xy), 1e3 * min(t, 0.02) / 0.02),
                     np.zeros(len(xy))], axis=1)


# ---------------------------------------------------------------------------
# the copied host modules
# ---------------------------------------------------------------------------


def test_time_handler_copy():
    a, b = JaxTime(1.0, 0.01), Time(1.0, 0.01)
    for op in ("inc", "inc", "inc", ("set", 0.015), "inc", ("set", 0.05),
               "inc", ("set", 0.0999999999999)):
        for t in (a, b):
            if op == "inc":
                t.increment()
            else:
                t.set_absolute_time(op[1])
        assert (a.current(), a.get_timestep(), a.end(), a.get_delta_t()) == (
            b.current(), b.get_timestep(), b.end(), b.get_delta_t())


def _drive(p, dt_seq, u_fn):
    """The participant protocol as the runner drives it; returns the
    observable trace."""
    trace = []
    ids = p.setMeshVertices("m", np.linspace(0, 1, 8).reshape(4, 2))
    p.initialize()
    k = 0
    while p.isCouplingOngoing() and k < 40:
        trace.append(("w", p.requiresWritingCheckpoint()))
        dt = min(dt_seq[k % len(dt_seq)], p.getMaxTimeStepSize())
        trace.append(("r", np.asarray(p.readData("m", "s", ids, dt)).tolist()))
        p.writeData("m", "d", ids, u_fn(k))
        p.advance(dt)
        trace.append(("c", p.requiresReadingCheckpoint(),
                      p.isTimeWindowComplete(), p.getMaxTimeStepSize()))
        k += 1
    p.finalize()
    return trace


def test_participant_copies():
    """FakeParticipant (explicit, implicit, subcycled) and
    SurrogateFluidParticipant (Aitken and constant relaxation) give the
    same protocol trace and histories as the JAX package's; the preCICE
    binding and the factory behave alike."""

    def u_fn(k):
        return np.full((4, 2), 1e-3 / (k + 1))

    def sfn(t, x, u):
        return np.stack([np.full(len(x), 1e3 * t), -2.0 * u[:, 0]], axis=1)

    for kw, dts in ((dict(), [0.01]), (dict(implicit_iterations=3), [0.01]),
                    (dict(window_dt=0.015), [0.01]),
                    (dict(requires_initial_data=True), [0.005])):
        base = dict(dim=2, window_dt=0.01, end_time=0.03,
                    read_fn=lambda t, x: np.outer(np.ones(len(x)), [t, 2 * t]))
        base.update(kw)
        a, b = JaxFake(**base), FakeParticipant(**base)
        assert a.requiresInitialData() == b.requiresInitialData()
        assert _drive(a, dts, u_fn) == _drive(b, dts, u_fn)
        assert a.read_log == b.read_log
        assert len(a.write_history) == len(b.write_history)
        for x, y in zip(a.write_history, b.write_history):
            assert x[:2] == y[:2]
            np.testing.assert_array_equal(x[2], y[2])
    for accel in ("aitken", "constant"):
        kw = dict(dim=2, window_dt=0.01, end_time=0.02, stress_fn=sfn,
                  eps=1e-3, acceleration=accel, max_iterations=30)
        a, b = JaxSurrogate(**kw), SurrogateFluidParticipant(**kw)

        def u_of(k, p):
            u = p._u_relaxed if p._u_relaxed is not None else np.zeros((4, 2))
            return 0.5 * u + 1e-3

        ta = _drive(a, [0.01], lambda k: u_of(k, a))
        tb = _drive(b, [0.01], lambda k: u_of(k, b))
        assert ta == tb
        assert a.iterations_per_window == b.iterations_per_window
        assert a.omega_history == b.omega_history
    params = JaxParams()
    fake = FakeParticipant(dim=2, window_dt=0.1, end_time=0.1)
    assert make_participant(params, fake=fake) is fake
    try:
        import precice  # noqa: F401
    except ImportError:
        for cls in (JaxPrecice, PreciceParticipant):
            with pytest.raises(ImportError, match="pyprecice"):
                cls("Solid", "precice-config.xml")


def test_timer_copy():
    a, b = JaxTimer("run"), TimerOutput("run")
    for t in (a, b):
        for name in ("Output results", "Coupled run", "Output results"):
            with t.section(name):
                pass
    assert {k: v[1] for k, v in a.sections.items()} == {
        k: v[1] for k, v in b.sections.items()}
    la, lb = a.summary().splitlines(), b.summary().splitlines()
    assert len(la) == len(lb)
    assert [x.split("|")[1] for x in la[5:-1]] == [x.split("|")[1] for x in lb[5:-1]]


@pytest.mark.parametrize("dim,degree", [(2, 2), (3, 1)])
def test_postprocessor_and_vtu_copies(dim, degree, tmp_path):
    """The same nodal strain, and VTU files byte for byte, from the same
    fields; the port's writer also takes tensors."""
    jm, _ = jax_grid("PF", dim, degree, solver="linear")
    tm, _ = make_scenario_grid("PF", dim, degree, solver="linear")
    js, ts = JaxDofSpace.create(jm), DofSpace.create(tm)
    rng = np.random.default_rng(3)
    u = 1e-3 * rng.standard_normal((ts.n_nodes, dim))
    v = rng.standard_normal((ts.n_nodes, dim))
    np.testing.assert_array_equal(compute_nodal_strain(ts, u), jax_strain(js, u))
    pa, pb, pc = (str(tmp_path / f"{n}.vtu") for n in "abc")
    jax_write_vtu(pa, js, u, extra_point_data={"velocity": v})
    write_vtu(pb, ts, u, extra_point_data={"velocity": v})
    write_vtu(pc, ts, torch.as_tensor(u),
              extra_point_data={"velocity": torch.as_tensor(v)})
    with open(pa, "rb") as fa, open(pb, "rb") as fb, open(pc, "rb") as fc:
        ref = fa.read()
        assert fb.read() == ref and fc.read() == ref


# ---------------------------------------------------------------------------
# coupled runs against the JAX package
# ---------------------------------------------------------------------------


def _pair(kw, neo, fake_kw, surrogate=None):
    """The JAX and ported model, participant and adapter for one run."""
    jp = JaxParams(**kw)
    jcls, tcls = (JaxNonlinear, NonlinearElasticity) if neo else (
        JaxLinear, LinearElastodynamics)
    jm, tm = jcls(jp), tcls(params_from_jax(jp), device="cpu")
    out = []
    for pkg, m, Fake, Surr, Ad in (
        ("jax", jm, JaxFake, _recording(JaxSurrogate), JaxAdapter),
        ("torch", tm, FakeParticipant, _recording(SurrogateFluidParticipant),
         Adapter),
    ):
        base = dict(dim=jp.dim, window_dt=jp.delta_t, end_time=jp.end_time)
        if surrogate is None:
            part = Fake(**dict(base, **fake_kw))
        else:
            part = Surr(**dict(base, **surrogate))
        extra = {} if pkg == "jax" else {"device": "cpu"}
        ad = Ad(jp if pkg == "jax" else params_from_jax(jp), m.interface_id,
                m.space, participant=part, dtype=m.dtype, **extra)
        out.append((m, part, ad))
    return out


def _recording(cls):
    """The participant class with a write history (t, iteration, values)
    like the fake's."""

    class Recording(cls):
        def writeData(self, mesh_name, data_name, ids, values):
            self.write_history = getattr(self, "write_history", [])
            self.write_history.append(
                (self.window_start + self.time_in_window, self.iteration,
                 np.array(values, dtype=np.float64)))
            super().writeData(mesh_name, data_name, ids, values)

    return Recording


def _compare_histories(ja, tb, rtol):
    assert len(ja.write_history) == len(tb.write_history) > 0
    for (t1, i1, x), (t2, i2, y) in zip(ja.write_history, tb.write_history):
        assert i1 == i2 and t1 == pytest.approx(t2)
        np.testing.assert_allclose(y, x, rtol=rtol, atol=rtol * np.abs(x).max())


@pytest.mark.parametrize(
    "case",
    ["explicit_linear", "implicit_linear", "subcycling_linear",
     "implicit_neo_hookean", "surrogate_neo_hookean"],
)
def test_coupled_run_matches_jax(case):
    neo = case.endswith("neo_hookean")
    kw = dict(NEO_HOOKEAN if neo else LINEAR)
    fake_kw, surrogate, strict = dict(read_fn=_traction), None, True
    if case == "implicit_linear":
        fake_kw["implicit_iterations"] = 3
    elif case == "subcycling_linear":
        fake_kw["window_dt"] = 0.015  # closes each window with dt 0.005
        strict = False
    elif case == "implicit_neo_hookean":
        fake_kw["implicit_iterations"] = 2
    elif case == "surrogate_neo_hookean":
        kw.update(end_time=0.01, tol_u=1e-9, tol_f=1e-11)

        def stress_fn(t, coords, u):
            sig = np.zeros_like(u)
            sig[:, 0] = 2000.0
            return sig - 2.0e7 * u

        surrogate = dict(stress_fn=stress_fn, eps=1e-6, acceleration="aitken")
    (jm, jpart, jad), (tm, tpart, tad) = _pair(kw, neo, fake_kw, surrogate)
    outs = {"jax": [], "torch": []}
    js = jax_coupled_run(jm, jad, strict_dt=strict,
                         output_cb=lambda s, t, i: outs["jax"].append(t.current()))
    ts = coupled_run(tm, tad, strict_dt=strict,
                     output_cb=lambda s, t, i: outs["torch"].append(t.current()))
    assert tpart.finalized and outs["torch"] == pytest.approx(outs["jax"])
    rtol = 1e-6 if neo else 1e-9
    _compare_histories(jpart, tpart, rtol)
    if surrogate is not None:
        assert tpart.iterations_per_window == jpart.iterations_per_window
        assert tpart.iterations_per_window[0] >= 3
    uj = np.asarray(js.displacement)
    np.testing.assert_allclose(ts.displacement.numpy(), uj, rtol=rtol,
                               atol=rtol * np.abs(uj).max())
    if case == "subcycling_linear":
        assert list(tm._dt_clones) == [pytest.approx(0.005)]


def test_checkpoints_are_clones():
    """A checkpoint survives an in-place change of the state it was taken
    from, and every reload hands out a fresh copy of it."""
    p = params_from_jax(JaxParams(**LINEAR))
    m = LinearElastodynamics(p, device="cpu")
    fake = FakeParticipant(dim=2, window_dt=0.01, end_time=0.02,
                           implicit_iterations=2)
    ad = Adapter(p, m.interface_id, m.space, participant=fake,
                 dtype=m.dtype, device="cpu")
    st = m.initial_state()
    st = type(st)(*(torch.full_like(t, float(i + 1)) for i, t in enumerate(st)))
    ad.initialize(st.displacement)
    time = Time(p.end_time, p.delta_t)
    assert ad.save_current_state_if_required(st, time)
    saved = [t.clone() for t in st]
    for t in st:
        t.mul_(-7.0)  # a model updating its state in place
    time.increment()
    ad.advance(st.displacement, 0.01)  # window repeated: rollback requested
    back = ad.reload_old_state_if_required(st, time)
    assert time.current() == 0.0 and time.get_timestep() == 0
    for t, s in zip(back, saved):
        torch.testing.assert_close(t, s, rtol=0, atol=0)
    back.displacement.zero_()
    fake._needs_read_checkpoint = True
    again = ad.reload_old_state_if_required(st, time)
    torch.testing.assert_close(again.displacement, saved[0], rtol=0, atol=0)
    # the interface rows leave the device as float64, fields come back
    # on the model's device in its dtype
    field = ad.read_data(0.01)
    assert field.dtype == m.dtype and field.device.type == "cpu"
    assert ad._gather(st.displacement).dtype == np.float64


def test_with_delta_t_identity_and_cache():
    for cls, kw in ((NonlinearElasticity, NEO_HOOKEAN),
                    (LinearElastodynamics, LINEAR)):
        model = cls(params_from_jax(JaxParams(**kw)), device="cpu")
        assert model.with_delta_t(0.01) is model
        c1, c2 = model.with_delta_t(0.005), model.with_delta_t(0.005)
        assert c1 is c2 and c1.params.delta_t == 0.005
        assert c1.mesh is model.mesh and c1.device == model.device
        assert dataclasses.replace(c1.params, delta_t=0.01) == model.params
        if cls is NonlinearElasticity:  # Newmark coefficients of the new dt
            assert c1.alpha_1 == pytest.approx(1.0 / (c1.params.beta * 0.005**2))


def test_newton_divergence_raises():
    p = params_from_jax(JaxParams(**dict(NEO_HOOKEAN, max_iterations_NR=1)))
    m = NonlinearElasticity(p, device="cpu")
    fake = FakeParticipant(dim=2, window_dt=0.01, end_time=0.01,
                           read_fn=lambda t, x: np.tile([5e4, 0.0], (len(x), 1)))
    ad = Adapter(p, m.interface_id, m.space, participant=fake,
                 dtype=m.dtype, device="cpu")
    with pytest.raises(NewtonDivergedError, match="No convergence"):
        coupled_run(m, ad)


def test_stencil_levels_3d_step_matches_jax(monkeypatch):
    """One 3D Neo-Hookean production step (bf16 multigrid with Q1 levels
    above the coarse solve, f32 CG) with `mg_level_backend=
    "stencil_vmem"`: the same Newton count, CG within +-2, ||u||^2 within
    rtol 1e-6 of the JAX package's step. The JAX model runs its per-cell
    XLA level operators (`xla`): the stencil backends compute the same
    assembled matrix (tests/test_stencil.py), and in its jitted step they
    cost minutes of XLA compilation on the CPU (the port against the JAX
    vmem V-cycle itself: tests/test_torch_stencil.py::
    test_vcycle_stencil_vmem_matches_jax). Both take the port's lam_max
    estimates (the JAX power iterations would add ~20 s)."""
    from dealii_adapter_tpu.solvers import cg as jcg

    kw = dict(
        model="neo-Hookean", type_lin="CG", scenario="PF", dim=3,
        poly_degree=2, delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0,
        tol_lin=1e-6, tol_u=1e-6, tol_f=1e-9, max_iterations_lin=1.0,
        max_iterations_NR=10, dtype="float64", preconditioner="MG",
        precond_dtype="bfloat16", solve_dtype="float32",
        newton_forcing="ew", mg_smooth_degree=3, mg_fine_smooth_degree=1,
        newton_predictor=True, ew_eta0=0.3, mg_coarse_size=300,
        mg_level_backend="stencil_vmem",
    )
    jp = JaxParams(**kw)
    tm = NonlinearElasticity(params_from_jax(jp), device="cpu")
    assert len(tm._precond.levels) >= 3
    lam = iter([lv.lam_max for lv in tm._precond.levels])
    # the JAX hierarchy imports it from its cg module at each estimate
    monkeypatch.setattr(jcg, "estimate_lambda_max", lambda *a, **k: next(lam))
    jm = JaxNonlinear(dataclasses.replace(jp, mg_level_backend="xla"))
    assert [lv.lam_max for lv in jm._precond.levels] == [
        lv.lam_max for lv in tm._precond.levels]
    stress = np.zeros((tm.space.n_nodes, 3))
    stress[tm.space.boundary_nodes[tm.interface_id], 0] = 1000.0
    js, ji = jm.step(jm.initial_state(), jnp.asarray(stress))
    ts, ti = tm.step(tm.initial_state(), torch.as_tensor(stress))
    assert bool(ji.converged) and ti.converged
    assert ti.iterations == int(ji.iterations)
    assert abs(ti.cg_iterations - int(ji.cg_iterations)) <= 2
    uj, ut = np.asarray(js.displacement), state_to_numpy(ts)[0]
    np.testing.assert_allclose((ut * ut).sum(), (uj * uj).sum(), rtol=1e-6)
