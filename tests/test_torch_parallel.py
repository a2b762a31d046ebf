"""The PyTorch package on several ranks against the JAX package on one
device, on the CPU: gloo process groups of 2, 3 and 4 ranks (one spawn of
each per module, `parallel/partition.py:spawn`, initialized through a file
in a temporary directory, so that test workers never share a port), each
running every case of its world once; the cases are parametrized here.

* The cell partition (`element_backend="gather"`, 2 and 3 ranks): the
  partition covers every cell; the sharded matvec and diagonal equal the
  unsharded ones (rtol 1e-12, as tests/test_sharding.py), also with more
  ranks than cells; the linear and the Neo-Hookean step against the JAX
  package's single-device gather step (its tolerances: rtol 1e-9 and
  1e-7, CG within 2 a solve, Newton counts equal); the f64 jvp operator
  on 2 ranks against one rank (rtol 1e-12), whose all-reduce carries the
  tangent.
* The lattice partition (`auto`, 2 and 4 ranks): the structured operator
  on tests/test_sharding.py's (6, 10, 31) lattice (rtol 1e-13, atol 1e-13
  of the largest entry); its MG linear step and its production
  configuration (MG, bf16 V-cycle, f32 CG, EW, predictor), and on 2 ranks
  also its Jacobi linear and f64 Neo-Hookean steps, against the JAX
  package's single-device steps, with its count rules and tolerances
  (both hierarchies on one device's lam_max estimates); the dense Direct
  solve of both models (whole on every rank) and a Neumann interface that
  covers part of its lattice sides, each also against one device (1e-12);
  on 2 ranks the production step with the host CG loop (the Newton
  loop's bodies eager, as gloo ranks on the card run it) bit for bit the
  same ranks' step with the CG graphs' loop, and against one device;
  on 2 ranks the linear MG step with the f32 defect correction on the
  device (`ChunkedIRCG`) under the host loop, its bodies eager, against
  one device (the same decisions and read-backs on every rank); and on
  2 ranks the linear step with the f64 solve on the f64 hierarchy
  (VCYCLE_F64) under the host loop against one device.
* The coupled run on 2 ranks, on both partitions (rank 0 holds the
  participant): tests/test_torch_coupling.py's implicit linear and
  Neo-Hookean runs, whose every window rolls back, against the JAX
  package's one-device run (rtol 1e-9 and 1e-6); and the CLI with
  `--devices 2` inside the world against one rank.
* The halo exchanges on every world (2, 3 and 4 ranks): the send/recv
  form the lattice partition runs on gloo CPU ranks (`fill`, `extend`
  with a grid transfer's halos, `interface_sum`) bit for bit the slot
  all-reduce's, values and forward-mode tangents, in f64 and bf16.

This module imports jax only inside its fixtures: the spawned ranks
import it by name and must not."""

import concurrent.futures
import contextlib
import dataclasses
import io
import os
import re

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from dealii_adapter_tpu_torch import cli
from dealii_adapter_tpu_torch.adapter import Adapter, FakeParticipant
from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import (
    make_scenario_grid,
    subdivided_hyper_rectangle,
)
from dealii_adapter_tpu_torch.models.linear_elasticity import (
    LinearElastodynamics,
)
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
    NonlinearState,
)
from dealii_adapter_tpu_torch.ops.element_ops import ElementMatrices, make_operator
from dealii_adapter_tpu_torch.ops.structured import structured_operator_from_lattice
from dealii_adapter_tpu_torch.parallel import (
    CellPartition,
    choose_backend,
    make_device_mesh,
    make_sharded_operator,
    spawn,
)
from dealii_adapter_tpu_torch.parallel import partition
from dealii_adapter_tpu_torch.parallel.lattice import (
    SlabLayout,
    SlabOperator,
    axis_transfer,
    split_axis,
)
from dealii_adapter_tpu_torch.solvers.graphs import capture
from dealii_adapter_tpu_torch.solvers.multigrid import GeometricMultigrid
from dealii_adapter_tpu_torch.runner import coupled_run

torch.set_num_threads(1)

# tests/test_sharding.py's configurations
LIN = dict(model="linear", type_lin="CG", scenario="PF", delta_t=0.01,
           poly_degree=2, mu=0.5e6, nu=0.4, rho=1000.0)
NL = dict(model="neo-Hookean", type_lin="CG", scenario="PF", delta_t=0.01,
          poly_degree=1, mu=0.5e6, nu=0.4, rho=1000.0, tol_lin=1e-8)
LIN_MG = dict(LIN, dim=2, preconditioner="MG")
PRODUCTION = dict(model="neo-Hookean", type_lin="CG", scenario="PF", dim=3,
                  poly_degree=1, delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0,
                  tol_lin=1e-6, tol_u=1e-6, tol_f=1e-8, max_iterations_NR=8,
                  preconditioner="MG", precond_dtype="bfloat16",
                  solve_dtype="float32", newton_forcing="ew",
                  newton_predictor=True, mg_smooth_degree=3)
# (configuration, traction) of each step case; `_gather` runs the cell
# partition, the others the lattice partition
STEPS = {
    "linear_gather": (dict(LIN, element_backend="gather"), 1000.0),
    "nonlinear_gather": (dict(NL, element_backend="gather"), 5000.0),
    "linear": (LIN, 1000.0),
    "nonlinear": (NL, 5000.0),
    "linear_mg": (LIN_MG, 1000.0),
    "production": (PRODUCTION, 1000.0),
    "linear_direct": (dict(LIN, type_lin="Direct"), 1000.0),
    "nonlinear_direct": (dict(NL, type_lin="Direct"), 5000.0),
    # NL, Direct, on a mesh whose interface covers half of each of its
    # sides
    "nonlinear_partial": (dict(NL, type_lin="Direct"), 5000.0),
}
CELL_STEPS = ("linear_gather", "nonlinear_gather")
# the lattice steps of each world: tests/test_sharding.py's MG linear and
# production steps on 2 and 4 ranks, its Jacobi linear and f64 jvp
# Neo-Hookean steps (the tangent through the halo fill and the interface
# sum), the Direct steps of both models and the partial-side Neumann step
# on 2
LATTICE_STEPS = {2: ("linear", "nonlinear", "linear_mg", "production",
                     "linear_direct", "nonlinear_direct", "nonlinear_partial"),
                 4: ("linear_mg", "production")}
# the steps that must also equal one device's (1e-12)
ONE_DEVICE_STEPS = ("linear_direct", "nonlinear_direct", "nonlinear_partial")
# the linear MG step with the f32 solve: the defect-correction loop on the
# device (`ChunkedIRCG`) on 2 ranks under the host loop (its bodies eager,
# as gloo ranks on the card run it)
LIN_IR = dict(LIN_MG, solve_dtype="float32")
# tests/test_torch_coupling.py's implicit runs, the linear one cut to two
# windows of 2 iterations and the Neo-Hookean one on Direct solves (its jvp CG's
# collectives cost ~10 ms an iteration on 2 gloo ranks; the steps above
# run it): (configuration, implicit iterations a window); a `_gather`
# case runs the cell partition
COUPLED = {
    "coupled_linear": (dict(model="linear", type_lin="CG", scenario="PF",
                            delta_t=0.01, end_time=0.02, poly_degree=2,
                            mu=0.5e6, nu=0.4, rho=1000.0, theta=0.5), 2),
    "coupled_neo_hookean": (dict(model="neo-Hookean", type_lin="Direct",
                                 scenario="PF", delta_t=0.01, end_time=0.02,
                                 poly_degree=1, mu=0.5e6, nu=0.4, rho=1000.0,
                                 theta=0.5, tol_lin=1e-8), 2),
}
COUPLED_CASES = ("coupled_linear", "coupled_neo_hookean",
                 "coupled_linear_gather", "coupled_neo_hookean_gather")
# tests/test_torch_cli.py's case
CLI_PRM = """
subsection Time
  set End time = 0.02
  set Time step size = 0.01
  set Output interval = 1
  set Output folder = {out}
end
subsection System properties
  set Shear modulus = 0.5e6
  set Poisson's ratio = 0.4
  set rho = 1000
end
subsection Solver
  set Model = neo-Hookean
  set Solver type = CG
end
subsection Discretization
  set Polynomial degree = 1
end
subsection precice configuration
  set Scenario = PF
end
"""
MATVECS = ("q3", "six_cells", "two_cells")
# a bf16 hierarchy whose distributed level (19, 4) restricts across the
# split axis into the replicated coarse level (10, 3)
VCYCLE = dict(PRODUCTION, dim=2)
# the linear model's f64 hierarchy in 3D (the f64 solve's, no
# `precond_dtype`), its coarse size cut so that two Q1 levels are
# distributed (K3 on each rank's slab, `SlabOperator`) above the
# replicated coarse one
VCYCLE_F64 = dict(LIN, dim=3, preconditioner="MG", mg_coarse_size=500)


def _matvec_space(case):
    """(space, element matrix) of a matvec case: the 2D flap in Q3,
    tests/test_sharding.py's 6-cell mesh, and a 2-cell mesh (more ranks
    than cells with 3)."""
    if case == "q3":
        mesh, _ = make_scenario_grid("PF", 2, 3, solver="linear")
        space = DofSpace.create(mesh)
        return space, ElementMatrices(space, 1.2e6, 0.5e6, 1000.0).K_e
    reps = (3, 2) if case == "six_cells" else (2, 1)
    space = DofSpace.create(subdivided_hyper_rectangle(reps, (0, 0), (1.0, 0.5), 1))
    return space, ElementMatrices(space, 1.0, 1.0, 1.0).M_e


def _interface_stress(model, magnitude):
    s = np.zeros((model.space.n_nodes, model.space.dim))
    s[model.space.boundary_nodes[model.interface_id], 0] = magnitude
    return torch.as_tensor(s)


def _partial_interface(mesh, interface_id):
    """The mesh with the interface faces of each side whose cell lies in
    the upper half of the side's cells relabelled to another id, so that
    the interface covers only part of its lattice sides
    (tests/test_torch_gather_backend.py's)."""
    faces = mesh.boundary_faces[interface_id]
    keep = np.zeros(len(faces), dtype=bool)
    for f in np.unique(faces[:, 1]):
        idx = np.nonzero(faces[:, 1] == f)[0]
        keep[idx[: len(idx) // 2]] = True
    bf = dict(mesh.boundary_faces)
    bf[interface_id] = faces[keep]
    bf[99] = faces[~keep]
    return dataclasses.replace(mesh, boundary_faces=bf)


def _mesh_kw(name, kw, grid):
    """The `mesh` and `tags` keywords of a step case (the partial-side
    interface's), built with the package's `grid` (make_scenario_grid)."""
    if not name.endswith("_partial"):
        return {}
    mesh, tags = grid(kw["scenario"], 2, kw["poly_degree"], solver=kw["model"])
    return dict(mesh=_partial_interface(mesh, tags["interface"]), tags=tags)


def _step(mesh, name, lam_max, cg_loop="graphs"):
    kw, mag = STEPS[name]
    cls = LinearElastodynamics if kw["model"] == "linear" else NonlinearElasticity
    extra = {"mg_lam_max": lam_max[name]} if name in lam_max else {}
    extra.update(_mesh_kw(name, kw, make_scenario_grid))
    model = cls(AllParameters(**kw), device="cpu", device_mesh=mesh,
                cg_loop=cg_loop, **extra)
    if mesh is not None:
        assert (model._lat is None) == name.endswith("_gather")
    if name.endswith("_partial"):
        assert model._neumann_sides is None  # the gather pull-back
    state, info = model.step(model.initial_state(),
                             model.local_rows(_interface_stress(model, mag)))
    out = model.global_rows(state.displacement).numpy(), tuple(info)
    if name.endswith("_partial"):  # the load at a seeded deformation
        rng = np.random.default_rng(5)
        n = model.space.n_nodes
        u = torch.as_tensor(1e-3 * rng.standard_normal((n, 2)))
        s = _interface_stress(model, 1.0) * torch.as_tensor(
            1e3 * rng.standard_normal((n, 2)))
        load = model.external_force(model.local_rows(u), model.local_rows(s))
        out = out + (model.global_rows(load).numpy(),)
    return out


def _traction(t, xy):
    return np.stack([np.full(len(xy), 1e3 * min(t, 0.02) / 0.02),
                     np.zeros(len(xy))], axis=1)


def _coupled(mesh, name):
    """A coupled run of COUPLED's case `name` on `mesh` (None: one device):
    (rank 0's write history (t, iteration, values), else None; the final
    displacement, gathered; the output callback's times)."""
    kw, its = COUPLED[name.removesuffix("_gather")]
    if name.endswith("_gather"):
        kw = dict(kw, element_backend="gather")
    params = AllParameters(**kw)
    cls = LinearElastodynamics if kw["model"] == "linear" else NonlinearElasticity
    model = cls(params, device="cpu", device_mesh=mesh)
    if mesh is not None:
        assert (model._lat is None) == name.endswith("_gather")
    fake = FakeParticipant(dim=2, window_dt=params.delta_t,
                           end_time=params.end_time, read_fn=_traction,
                           implicit_iterations=its)
    ad = Adapter(params, model.interface_id, model.space, participant=fake,
                 dtype=model.dtype, device="cpu", device_mesh=mesh)
    lead = mesh is None or mesh.rank == 0
    assert (ad.precice is fake) == lead and (ad.precice is None) != lead
    times = []
    st = coupled_run(model, ad, output_cb=lambda s, t, i: times.append(t.current()))
    u = model.global_rows(st.displacement).numpy()
    if not lead:
        assert fake.write_history == [] and not fake.finalized
        return None, u, times
    assert fake.finalized
    return [(t, i, np.asarray(v)) for t, i, v in fake.write_history], u, times


def _final_u2(text):
    return float(re.search(r"final \|\|u\|\|\^2: (\S+)", text).group(1))


def _cli(mesh, root):
    """The CLI on CLI_PRM, on `mesh`'s world with `--devices` (one process
    without): (its exit code, what it printed, the files of its output
    folder)."""
    tag = "ranks" if mesh is not None else "one"
    out = os.path.join(root, f"out_{tag}")
    prm = os.path.join(root, f"case_{tag}.prm")
    if mesh is None or mesh.rank == 0:
        with open(prm, "w") as f:
            f.write(CLI_PRM.format(out=out))
    argv = [prm, "--standalone", "--traction", "2000", "0", "--device", "cpu"]
    if mesh is not None:
        mesh.all_reduce(torch.zeros(1))  # rank 0 has written the file
        argv += ["--devices", str(mesh.world)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    return rc, buf.getvalue(), files


def _jvp_point(model):
    """The f64 jvp tangent of `model` at a seeded point, applied to a
    seeded direction (replicated vectors: one device or the cell
    partition)."""
    rng = np.random.default_rng(7)
    n, dim = model.space.n_nodes, model.space.dim
    vecs = [torch.as_tensor(1e-4 * rng.standard_normal((n, dim))) for _ in range(4)]
    stress = _interface_stress(model, 5000.0)
    _, K = model._make_jvp_tangent(vecs[0], NonlinearState(*vecs[1:4]), stress)
    v = torch.as_tensor(rng.standard_normal((n, dim)))
    return K(v).numpy()


def _structured_op(mesh):
    grid = (32, 11, 7)  # subdivided_hyper_rectangle((6, 10, 31)) node planes
    space = DofSpace.create(subdivided_hyper_rectangle(
        (6, 10, 31), (0.0, 0.0, 0.0), (6.0, 10.0, 31.0), 1))
    E = ElementMatrices(space, 2e6, 0.5e6, 1000.0).K_e
    lay = SlabLayout(grid, 1, split_axis(grid, 1, mesh.world), mesh)
    op = SlabOperator(structured_operator_from_lattice(
        E, lay.slab_shape, 1, torch.float64, "cpu"), lay)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal((space.n_nodes, 3)))
    return lay.gather(op(lay.local(u))).numpy()


def _vcycle_bf16(mesh, lam_max):
    """VCYCLE's bf16 V-cycle applied to a seeded f32 vector, and the
    restriction of a seeded bf16 vector from the last distributed level
    into the replicated coarse one, both gathered (one device with `mesh`
    None); lam_max is the one-device hierarchy's."""
    model = NonlinearElasticity(AllParameters(**VCYCLE), device="cpu",
                                device_mesh=mesh, mg_lam_max=lam_max)
    mg = model._precond
    rng = np.random.default_rng(3)
    r = torch.as_tensor(rng.standard_normal((model.space.n_nodes, 2)),
                        dtype=torch.float32)
    z = model.global_rows(mg(model.local_rows(r))).numpy()
    li = len(mg.levels) - 2
    lv = mg.levels[li]
    assert mg.levels[li + 1].coarse_solve is not None
    g = torch.as_tensor(rng.standard_normal((int(np.prod(lv.grid_shape)), 2)),
                        dtype=torch.bfloat16)
    if mesh is not None:
        assert lv.layout is not None and mg.levels[li + 1].layout is None
        g = lv.layout.local(g)
    return z, mg._restrict(li, g).float().numpy()


def _vcycle_f64(mesh, lam_max):
    """VCYCLE_F64's f64 V-cycle applied to a seeded f64 vector, gathered,
    and the lattices of its distributed Q1 levels (one device with `mesh`
    None); lam_max is the one-device hierarchy's."""
    model = LinearElastodynamics(AllParameters(**VCYCLE_F64), device="cpu",
                                 device_mesh=mesh, mg_lam_max=lam_max)
    mg = model._precond
    assert mg.dtype == torch.float64
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (model.space.n_nodes, 3)))
    z = model.global_rows(mg(model.local_rows(r))).numpy()
    return z, [lv.grid_shape for lv in mg.levels[1:]
               if isinstance(lv.raw, SlabOperator)]


def _linear_host(mesh, lam_max, steps=2, kw=LIN_IR):
    """`steps` steps of the linear configuration `kw` (LIN_IR unless
    given) under `cg_loop="host"` on `mesh` (None: one device): (||u||^2
    and `StepInfo` of each step, the read-backs of each step)."""
    model = LinearElastodynamics(AllParameters(**kw), device="cpu",
                                 device_mesh=mesh, cg_loop="host",
                                 mg_lam_max=lam_max)
    assert model._graphs.eager and model._cg.eager
    stress = model.local_rows(_interface_stress(model, 1000.0))
    state, out, syncs = model.initial_state(), [], []
    for _ in range(steps):
        before = model.host_syncs
        state, info = model.step(state, stress)
        syncs.append(model.host_syncs - before)
        u = model.global_rows(state.displacement)
        out.append((float((u * u).sum()), tuple(info)))
    return out, syncs


# the lattice of the exchange cases and its next coarser level (every
# second node plane along the split axis)
EXCHANGE_GRID, EXCHANGE_COARSE = (13, 5, 4), (7, 5, 4)


def _prolongation_1d(n_coarse):
    """Linear interpolation from n_coarse nodes to 2 n_coarse - 1."""
    P = np.zeros((2 * n_coarse - 1, n_coarse))
    for i in range(n_coarse):
        P[2 * i, i] = 1.0
        if i + 1 < n_coarse:
            P[2 * i + 1, i] = P[2 * i + 1, i + 1] = 0.5
    return P


def _exchange_forms(mesh):
    """{dtype: whether the send/recv form of each exchange equals the slot
    all-reduce's bit for bit, values and forward-mode tangents}, and the
    form the rule picks: `fill` and `interface_sum` on the fine lattice,
    `extend` with the halos of the restriction into the coarse level and
    of the prolongation out of it (`axis_transfer`'s)."""
    fine = SlabLayout(EXCHANGE_GRID, 1, 0, mesh)
    coarse = GeometricMultigrid._level_layout(fine, EXCHANGE_COARSE, False)
    P = _prolongation_1d(EXCHANGE_COARSE[0])
    restrict = axis_transfer(P.T, lambda q: coarse.owned[q], fine)[:3]
    prolong = axis_transfer(P, lambda q: fine.owned[q], coarse)[:3]
    rng = np.random.default_rng(10 + mesh.rank)

    def draw(shape, dtype):
        return torch.as_tensor(rng.standard_normal(shape)).to(dtype)

    out = {"form": mesh.exchange_form(torch.zeros(1))}
    for dtype in (torch.float64, torch.bfloat16):
        v = draw((fine.n_owned, 3), dtype)
        y = draw(fine.slab_shape + (3,), dtype)
        c = draw(coarse.owned_shape + (3,), dtype)
        tangents = [draw(x.shape, dtype) for x in (v, y, c)]
        got = {}
        for slots in (False, True):  # the rule's form, then the slots
            mesh.slot_exchange = slots
            form = mesh.exchange_form(v)
            with fwAD.dual_level():
                vd, yd, cd = (fwAD.make_dual(x, t)
                              for x, t in zip((v, y, c), tangents))
                g = vd.reshape(fine.owned_shape + (3,))
                res = [fine.fill(vd), fine.interface_sum(yd),
                       fine.extend(g, *restrict),
                       coarse.extend(cd, *prolong)]
                got[form] = [t for r in res for t in fwAD.unpack_dual(r)[:2]]
        mesh.slot_exchange = False
        out[str(dtype)] = all(
            a is not None and torch.equal(a, b)
            for a, b in zip(got["p2p"], got["all_reduce"]))
    return out


def _world_cases(mesh, cells, lattice, lam_max, root):
    """Every case of one world on one rank (the spawned function); `root`
    is a directory for the CLI's files."""
    out = {"exchange": _exchange_forms(mesh)}
    if cells:
        for case in MATVECS:
            space, E = _matvec_space(case)
            op = make_sharded_operator(space, E, mesh)
            u = torch.as_tensor(np.random.default_rng(1).standard_normal(
                (space.n_nodes, space.dim)))
            out[case] = (op(u).numpy(), op.diagonal().numpy())
        for name in CELL_STEPS:
            out[name] = _step(mesh, name, lam_max)
        if mesh.world == 2:
            model = NonlinearElasticity(
                AllParameters(**STEPS["nonlinear_gather"][0]), device="cpu",
                device_mesh=mesh)
            out["jvp"] = _jvp_point(model)
    if lattice:
        out["structured"] = _structured_op(mesh)
        if mesh.world == 2:
            out["vcycle_bf16"] = _vcycle_bf16(mesh, lam_max["vcycle_bf16"])
            out["vcycle_f64"] = _vcycle_f64(mesh, lam_max["vcycle_f64"])
        for name in LATTICE_STEPS[mesh.world]:
            out[name] = _step(mesh, name, lam_max)
        if mesh.world == 2:
            out["production_host"] = _step(mesh, "production", lam_max,
                                           cg_loop="host")
            out["linear_ir_host"] = _linear_host(mesh, lam_max["linear_ir"])
            out["f64_mg_host"] = _linear_host(
                mesh, lam_max["vcycle_f64"], kw=VCYCLE_F64)
    if cells and lattice:
        for name in COUPLED_CASES:
            out[name] = _coupled(mesh, name)
        out["cli"] = _cli(mesh, root)
    out["calls"] = dict(mesh.calls)
    return out


def _jax_imports():
    import jax

    from dealii_adapter_tpu.config import AllParameters as JaxParams
    from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
    from dealii_adapter_tpu.models.linear_elasticity import (
        LinearElastodynamics as JaxLinear,
    )
    from dealii_adapter_tpu.models.nonlinear_elasticity import (
        NonlinearElasticity as JaxNonlinear,
    )

    jax.config.update("jax_enable_x64", True)
    return JaxParams, jax_grid, JaxLinear, JaxNonlinear


def _jax_models():
    """The JAX package's model of each step case, and the lam_max values
    of the multigrid hierarchies: one device's estimates on the port,
    which the JAX hierarchies take in place of their power iterations and
    the ranks are given."""
    from dealii_adapter_tpu.solvers import cg as jcg

    JaxParams, jax_grid, JaxLinear, JaxNonlinear = _jax_imports()
    models, lam_max = {}, {}
    for name, (kw, _) in STEPS.items():
        cls = JaxLinear if kw["model"] == "linear" else JaxNonlinear
        with pytest.MonkeyPatch.context() as mp:
            if kw.get("preconditioner") == "MG":
                port = (LinearElastodynamics if kw["model"] == "linear"
                        else NonlinearElasticity)(AllParameters(**kw),
                                                  device="cpu")
                lam = lam_max[name] = [lv.lam_max
                                       for lv in port._precond.levels]
                it = iter(lam)
                mp.setattr(jcg, "estimate_lambda_max",
                           lambda *a, **k: next(it))
            m = models[name] = cls(JaxParams(**kw),
                                   **_mesh_kw(name, kw, jax_grid))
        if name in lam_max:
            assert [lv.lam_max for lv in m._precond.levels] == lam_max[name]
    return models, lam_max


def _jax_steps(models):
    """The JAX package's single-device steps, structured operator and
    coupled runs."""
    import jax.numpy as jnp

    from dealii_adapter_tpu.adapter import Adapter as JaxAdapter
    from dealii_adapter_tpu.adapter import FakeParticipant as JaxFake
    from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxSpace
    from dealii_adapter_tpu.mesh.generator import (
        subdivided_hyper_rectangle as jax_box,
    )
    from dealii_adapter_tpu.ops.element_ops import (
        ElementMatrices as JaxElementMatrices,
    )
    from dealii_adapter_tpu.ops.structured import make_structured_operator
    from dealii_adapter_tpu.runner import coupled_run as jax_coupled_run

    JaxParams, _, JaxLinear, JaxNonlinear = _jax_imports()
    refs = {}
    for name, m in models.items():
        s = np.zeros((m.space.n_nodes, m.space.dim))
        s[m.space.boundary_nodes[m.interface_id], 0] = STEPS[name][1]
        st, info = m.step(m.initial_state(), jnp.asarray(s))
        refs[name] = (np.asarray(st.displacement), info)
    space = JaxSpace.create(jax_box((6, 10, 31), (0.0, 0.0, 0.0), (6.0, 10.0, 31.0), 1))
    E = JaxElementMatrices(space, 2e6, 0.5e6, 1000.0).K_e
    u = np.random.default_rng(0).standard_normal((space.n_nodes, 3))
    refs["structured"] = np.asarray(
        make_structured_operator(space, E, jnp.float64)(jnp.asarray(u)))
    for name, (kw, its) in COUPLED.items():
        jp = JaxParams(**kw)
        m = (JaxLinear if kw["model"] == "linear" else JaxNonlinear)(jp)
        fake = JaxFake(dim=2, window_dt=jp.delta_t, end_time=jp.end_time,
                       read_fn=_traction, implicit_iterations=its)
        ad = JaxAdapter(jp, m.interface_id, m.space, participant=fake,
                        dtype=m.dtype)
        times = []
        st = jax_coupled_run(m, ad, output_cb=lambda s, t, i: times.append(
            t.current()))
        refs[name] = (fake.write_history, np.asarray(st.displacement), times)
    return refs


def _vcycle_lam_max():
    model = NonlinearElasticity(AllParameters(**VCYCLE), device="cpu")
    return [lv.lam_max for lv in model._precond.levels]


def _vcycle_f64_lam_max():
    model = LinearElastodynamics(AllParameters(**VCYCLE_F64), device="cpu")
    return [lv.lam_max for lv in model._precond.levels]


def _linear_ir_lam_max():
    model = LinearElastodynamics(AllParameters(**LIN_IR), device="cpu")
    return [lv.lam_max for lv in model._precond.levels]


@pytest.fixture(scope="module")
def worlds_and_refs(tmp_path_factory):
    """({world size: every rank's results}, (the JAX package's references,
    the lam_max values)). 2 ranks run the cell and the lattice cases, 3
    the cell cases, 4 the lattice cases, one world after the other on a
    thread of this process, while this thread computes the JAX package's
    single-device steps and coupled runs (its XLA compilations release the
    interpreter; the ranks are processes of their own)."""
    models, jax_lam = _jax_models()
    lam_max = dict(jax_lam, vcycle_bf16=_vcycle_lam_max(),
                   vcycle_f64=_vcycle_f64_lam_max(),
                   linear_ir=_linear_ir_lam_max())
    roots = {n: tmp_path_factory.mktemp(f"world{n}") for n in (2, 3, 4)}

    def run_worlds():
        return {n: spawn(_world_cases, n, "cpu", cells, lattice, lam_max,
                         str(roots[n]), init_dir=roots[n], threads=1)
                for n, cells, lattice in ((2, True, True), (3, True, False),
                                          (4, False, True))}

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_worlds)
        refs = _jax_steps(models)
        return ranks.result(), (refs, jax_lam)


@pytest.fixture(scope="module")
def jax_refs(worlds_and_refs):
    """The JAX package's single-device steps (and the lam_max values of
    its multigrid hierarchies), its structured operator and coupled
    runs."""
    return worlds_and_refs[1]


@pytest.fixture(scope="module")
def worlds(worlds_and_refs):
    """{world size: every rank's results} (`worlds_and_refs`)."""
    return worlds_and_refs[0]


def test_backend_rule_and_launch_hint():
    """gloo on the CPU and for ranks sharing one card, NCCL only for a card
    per rank; without a process group `n_devices > 1` raises and says how
    to launch."""
    assert choose_backend("cpu", 2) == "gloo"
    if torch.cuda.device_count() < 2:
        assert choose_backend("cuda", 2) == "gloo"
    with pytest.raises(RuntimeError, match="torchrun"):
        make_device_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="spawn"):
        LinearElastodynamics(AllParameters(**dict(LIN, n_devices=2)), device="cpu")


@pytest.mark.parametrize("backend,local,device,expected", [
    ("nccl", 3, None, 3), ("nccl", 1, "cuda", 1), ("gloo", 2, None, 0)])
def test_device_mesh_makes_the_rank_card_current(monkeypatch, backend, local,
                                                 device, expected):
    """`make_device_mesh` in a (mocked) world of 4: under NCCL the card of
    the rank's local index, also for a bare "cuda", under gloo the first
    card (ranks share it), each with its index and made the current
    device, the one place every launch route goes through."""
    current = []
    dist = partition.dist
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setenv("LOCAL_RANK", str(local))
    mesh = make_device_mesh(4, device=device)
    assert mesh.device == torch.device("cuda", expected)
    assert current == [torch.device("cuda", expected)]
    assert mesh.backend == backend and mesh.world == 4
    # a run on the CPU makes no card current
    current.clear()
    assert make_device_mesh(4, device="cpu").device == torch.device("cpu")
    assert current == []


def test_close_resets_the_captured_graphs_then_destroys_the_group(
        monkeypatch):
    """`RankGroup.close` resets each CUDA graph that captured one of the
    group's collectives (an all-reduce or a neighbour exchange), and no
    graph that captured none or another group's, then destroys the group:
    a graph holding captured NCCL work keeps the communicators, which the
    destroy waits for. Mocked: a capture that records nothing, collectives
    that move nothing."""

    class Graph:
        def __init__(self):
            self.resets = 0

        def reset(self):
            self.resets += 1

    destroyed = []
    monkeypatch.setattr(partition.dist, "all_reduce", lambda *a, **k: None)
    monkeypatch.setattr(partition.dist, "destroy_process_group",
                        destroyed.append)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())

    def group():
        return partition.RankGroup(group=None, rank=0, world=1,
                                   device=torch.device("cpu"), backend="gloo")

    mesh, other = group(), group()
    reduced, exchanged, idle, elsewhere = (Graph() for _ in range(4))
    x = torch.ones(3)
    with capture(reduced):
        mesh.all_reduce(x)
    with capture(exchanged):
        mesh.exchange(x[:0], x)
    with capture(idle):
        x * 2
    with capture(elsewhere):
        other.all_reduce(x)
    mesh.all_reduce(x, "max")  # not captured: nothing kept
    mesh.close()
    assert [g.resets for g in (reduced, exchanged, idle, elsewhere)] == [
        1, 1, 0, 0]
    assert destroyed == [None]


@pytest.mark.parametrize("world", [2, 3, 4])
def test_p2p_exchanges_equal_the_slot_all_reduce(worlds, world):
    """On gloo CPU ranks the lattice partition's exchanges go between
    neighbours (send/recv, the rule's choice for a CPU tensor on gloo);
    the halo fill, the interface sum and the halo extensions of a grid
    transfer in both directions equal the slot all-reduce's bit for bit,
    values and forward-mode tangents, in f64 and bf16, on every rank."""
    for rank in worlds[world]:
        ex = rank["exchange"]
        assert ex["form"] == "p2p"
        assert ex["torch.float64"] and ex["torch.bfloat16"], ex
        assert rank["calls"]["p2p"] > 0


@pytest.mark.parametrize("n", [2, 3, 8])
def test_cell_partition_covers_all_cells(n):
    """Every real cell exactly once, in order (tests/test_sharding.py)."""
    mesh, _ = make_scenario_grid("PF", 2, 2, solver="linear")
    space = DofSpace.create(mesh)
    part = CellPartition.create(space.cells, space.n_nodes, n)
    assert int(part.n_valid.sum()) == space.cells.shape[0]
    rebuilt = np.concatenate([part.cells[d, : part.n_valid[d]] for d in range(n)])
    np.testing.assert_array_equal(rebuilt, space.cells)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", MATVECS)
def test_sharded_matvec_matches_unsharded(worlds, world, case):
    space, E = _matvec_space(case)
    ref = make_operator(space, E, torch.float64, "cpu")
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (space.n_nodes, space.dim)))
    if case == "two_cells" and world == 3:
        assert space.cells.shape[0] < world  # an empty shard
    for rank in worlds[world]:
        got, diag = rank[case]
        np.testing.assert_allclose(got, ref(u).numpy(), rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(diag, ref.diagonal().numpy(), rtol=1e-12,
                                   atol=1e-12)


def _check_step(name, result, ref, world):
    (u, info), (u_ref, info_ref) = result[:2], ref
    if STEPS[name][0]["model"] == "linear":
        assert abs(info[0] - int(info_ref.iterations)) <= 2, (world, info)
        np.testing.assert_allclose(u, u_ref, rtol=1e-9, atol=1e-14)
        return
    assert info[0] and bool(info_ref.converged)
    assert info[1] == int(info_ref.iterations), (world, info)
    assert abs(info[6] - int(info_ref.cg_iterations)) <= 2 * info[1]
    if name == "production":
        np.testing.assert_allclose(u, u_ref, rtol=0,
                                   atol=1e-8 * max(np.abs(u_ref).max(), 1e-6))
    else:
        np.testing.assert_allclose(u, u_ref, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", CELL_STEPS)
def test_cell_partition_step_matches_jax(worlds, jax_refs, world, name):
    """The cell partition's step against the JAX package's single-device
    gather step; every rank holds the same replicated result."""
    ranks = worlds[world]
    for rank in ranks:
        _check_step(name, rank[name], jax_refs[0][name], world)
        np.testing.assert_array_equal(rank[name][0], ranks[0][name][0])
    assert ranks[0]["calls"]["all_reduce"] > 0


def test_f64_jvp_operator_two_ranks_equals_one(worlds):
    """The f64 jvp tangent (forward-mode AD of the whole residual through
    the cell partition's all-reduces) on 2 ranks against the single-device
    gather model's at the same point (rtol 1e-12)."""
    model = NonlinearElasticity(AllParameters(**STEPS["nonlinear_gather"][0]),
                                device="cpu")
    ref = _jvp_point(model)
    for rank in worlds[2]:
        np.testing.assert_allclose(rank["jvp"], ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
    assert np.abs(ref).max() > 0


@pytest.mark.parametrize("world", [2, 4])
def test_lattice_structured_operator_matches_jax(worlds, jax_refs, world):
    """The structured operator on per-rank slabs of tests/test_sharding.py's
    (6, 10, 31) lattice, gathered, against the JAX package's: rtol 1e-13
    and atol 1e-13 of the largest entry. (The JAX test needs no atol: its
    GSPMD program sums in the single-device order. Here an entry of an
    interface plane is the sum of two ranks' partial sums, and the few
    that cancel to ~1e-5 of the largest entry keep only their absolute
    accuracy: 4e-11 relative, 1e-15 of the largest.)"""
    ref = jax_refs[0]["structured"]
    for rank in worlds[world]:
        np.testing.assert_allclose(rank["structured"], ref, rtol=1e-13,
                                   atol=1e-13 * np.abs(ref).max())
        assert rank["calls"]["halo"] > 0 and rank["calls"]["interface_sum"] > 0
        assert rank["exchange"]["form"] == "p2p"  # what the steps ran


@pytest.mark.parametrize("world,name", [(w, n) for w, names in LATTICE_STEPS.items()
                                        for n in names])
def test_lattice_step_matches_jax(worlds, jax_refs, world, name):
    """The lattice partition's step (`auto`: every structured operator, the
    kernels' plain versions and the V-cycle on slabs) against the JAX
    package's single-device step; every rank reads the same reduced
    values and so returns the same field."""
    ranks = worlds[world]
    for rank in ranks:
        _check_step(name, rank[name], jax_refs[0][name], world)
        np.testing.assert_array_equal(rank[name][0], ranks[0][name][0])
        assert rank[name][1] == ranks[0][name][1]


def _bf16_ulp(x):
    """One bf16 ulp (8 significand bits) of each entry of x."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def test_bf16_restriction_to_a_replicated_level_rounds_once(worlds):
    """The restriction of a bf16 vector from a distributed level into the
    replicated coarse level on 2 ranks against one device: each rank's
    split-axis partial sums stay f32 through the all-reduce and are
    rounded once, so every entry is within one bf16 ulp of its own
    (rounding each rank's partial to bf16 first was 2 ulps off)."""
    _, ref = _vcycle_bf16(None, _vcycle_lam_max())
    for rank in worlds[2]:
        got = rank["vcycle_bf16"][1]
        assert np.all(np.abs(got - ref) <= _bf16_ulp(ref)), np.abs(got - ref).max()


def test_bf16_vcycle_two_ranks_within_one_ulp(worlds):
    """The bf16 V-cycle on 2 ranks (slab kernels' plain versions in their
    bf16-in/f32-out mode, interface sums in f32) against one device, on
    the same lam_max: within one bf16 ulp of the largest entry."""
    ref, _ = _vcycle_bf16(None, _vcycle_lam_max())
    for rank in worlds[2]:
        got = rank["vcycle_bf16"][0]
        assert np.abs(got - ref).max() <= _bf16_ulp(np.abs(ref).max())


def test_f64_vcycle_two_ranks_equals_one_device(worlds):
    """The f64 hierarchy on the lattice partition (the 3D linear model
    without `precond_dtype`): its V-cycle on 2 ranks, with two Q1 levels
    on each rank's slab (`SlabOperator` over K3 in f64) and f64 transfers
    across the split and into the replicated coarse level, against one
    device on the same lam_max: f64 roundoff in another summation order
    (1e-12 relative L2)."""
    ref, _ = _vcycle_f64(None, _vcycle_f64_lam_max())
    for rank in worlds[2]:
        got, slabs = rank["vcycle_f64"]
        assert len(slabs) == 2, slabs
        assert np.linalg.norm(got - ref) <= 1e-12 * np.linalg.norm(ref)


@pytest.mark.parametrize("name", ONE_DEVICE_STEPS)
def test_lattice_step_equals_one_device(worlds, name):
    """The dense Direct steps of both models (the gathered right-hand side
    solved whole on every rank) and the Neo-Hookean step on an interface
    that covers part of its lattice sides (the gather pull-back on the
    gathered fields) on 2 ranks against one device: displacement within
    1e-12, the same counts; the partial-side load at a seeded deformation
    and traction within f64 roundoff (1e-12)."""
    ref = _step(None, name, {})
    for rank in worlds[2]:
        got = rank[name]
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-12,
                                   atol=1e-12 * np.abs(ref[0]).max())
        assert got[1][0] == ref[1][0]  # converged / CG iterations
        if STEPS[name][0]["model"] != "linear":
            assert got[1][1] == ref[1][1] and got[1][6] == ref[1][6]
        if name.endswith("_partial"):
            np.testing.assert_allclose(got[2], ref[2], rtol=1e-12,
                                       atol=1e-12 * np.abs(ref[2]).max())
            assert np.abs(ref[2]).max() > 0
    assert np.abs(ref[0]).max() > 0


def test_one_loop_on_gloo_ranks_equals_one_device(worlds, jax_refs):
    """The production step on 2 ranks with the host CG loop, whose Newton
    loop runs its bodies eagerly (gloo collectives cannot be captured):
    on every rank bit for bit the same ranks' step beside the CG graphs'
    loop (the same `NewtonInfo`), and against one device with the host CG
    loop, the production step's limits (Newton equal, CG within 2 a
    solve, displacement within 1e-8 of the largest)."""
    lam = jax_refs[1]
    u_ref, info_ref = _step(None, "production", lam, cg_loop="host")[:2]
    for rank in worlds[2]:
        (u, info), (u_graphs, info_graphs) = (rank["production_host"],
                                              rank["production"])
        np.testing.assert_array_equal(u, u_graphs)
        assert info == info_graphs and info[0]
        assert info[1] == info_ref[1]
        assert abs(info[6] - info_ref[6]) <= 2 * info[1]
        np.testing.assert_allclose(u, u_ref, rtol=0,
                                   atol=1e-8 * np.abs(u_ref).max())


def test_linear_refinement_on_gloo_ranks_equals_one_device(worlds):
    """The linear step with the f32 defect correction on the device
    (`ChunkedIRCG`) under `cg_loop="host"` on 2 gloo ranks, two steps:
    every rank takes the same decisions (its end-of-loop guess reads
    all-reduced residuals) and so reads back equally often, at most its
    CG iterations + 2 a step; the `StepInfo` is one device's (the same
    CG iterations, the max norm and ||u||^2 within 1e-12). The final
    residual, a few 1e-14 here, is met on both, but its digits are the
    summation order's (its two values differ by ~5%)."""
    ref, _ = _linear_host(None, _linear_ir_lam_max())
    ranks = [r["linear_ir_host"] for r in worlds[2]]
    assert ranks[0][1] == ranks[1][1]
    for steps, syncs in ranks:
        assert steps == ranks[0][0]
        for (u2, info), (u2_ref, info_ref), n in zip(steps, ref, syncs):
            assert info[0] == info_ref[0] and n <= info[0] + 2
            assert info[1] <= 1e-10 and info_ref[1] <= 1e-10
            assert info[2] == pytest.approx(info_ref[2], rel=1e-12)
            assert u2 == pytest.approx(u2_ref, rel=1e-12) and u2 > 0


def test_f64_hierarchy_step_on_gloo_ranks_equals_one_device(worlds):
    """The linear step with the f64 solve and the f64 multigrid hierarchy
    (VCYCLE_F64: two Q1 levels on each rank's slab, K3 in f64 on the
    card) under `cg_loop="host"` (the f64 `ChunkedCG` run eagerly, as
    gloo ranks on the card run it) on 2 gloo ranks, two steps, against
    one device on the same lam_max: every rank takes the same steps, the
    same CG iterations a step as one device (the all-reduced inner
    products sum in another order, which these solves do not feel), every
    residual within the reference's 1e-10, ||u||^2 within 1e-12
    relative, and one read-back a CG chunk of 1 iteration (CG + 1 a
    step: the f64 solve runs no refinement loop)."""
    ref, _ = _linear_host(None, _vcycle_f64_lam_max(), kw=VCYCLE_F64)
    ranks = [r["f64_mg_host"] for r in worlds[2]]
    assert ranks[0][1] == ranks[1][1]
    for steps, syncs in ranks:
        assert steps == ranks[0][0]
        for (u2, info), (u2_ref, info_ref), n in zip(steps, ref, syncs):
            assert info[0] == info_ref[0] > 0 and n == info[0] + 1
            assert info[1] <= 1e-10 and info_ref[1] <= 1e-10
            assert u2 == pytest.approx(u2_ref, rel=1e-12) and u2 > 0


@pytest.mark.parametrize("name", COUPLED_CASES)
def test_coupled_run_two_ranks_matches_jax(worlds, jax_refs, name):
    """The coupled run on 2 ranks (lattice partition, and `_gather`: the
    cell partition), implicit coupling with a rollback in every window,
    against the JAX package's one-device run: rank 0's participant wrote
    the JAX write history (same times and iterations; values within rtol
    1e-9 linear, 1e-6 Neo-Hookean), rank 1 holds no participant, the
    output times agree and the final displacement matches on every
    rank."""
    hist_ref, u_ref, times_ref = jax_refs[0][name.removesuffix("_gather")]
    rtol = 1e-9 if "linear" in name else 1e-6
    ranks = worlds[2]
    hist = ranks[0][name][0]
    assert len(hist) == len(hist_ref) > 0 and ranks[1][name][0] is None
    assert max(i for _, i, _ in hist) >= 1  # windows were repeated
    for (t1, i1, x), (t2, i2, y) in zip(hist_ref, hist):
        assert i1 == i2 and t1 == pytest.approx(t2)
        np.testing.assert_allclose(y, x, rtol=rtol, atol=rtol * np.abs(x).max())
    for rank in ranks:
        _, u, times = rank[name]
        assert times == pytest.approx(times_ref)
        np.testing.assert_allclose(u, u_ref, rtol=rtol,
                                   atol=rtol * np.abs(u_ref).max())


def test_cli_two_ranks_equals_one(worlds, tmp_path):
    """`cli.main([..., "--devices", "2", "--device", "cpu"])` on the
    world's ranks: exit 0 on both, rank 0 alone prints (a banner naming
    the 2 ranks) and writes each VTU file once, and the final ||u||^2
    equals one rank's run within 1e-9."""
    rc, text, files = _cli(None, str(tmp_path))
    assert rc == 0
    (rc0, text0, files0), (rc1, text1, _) = (r["cli"] for r in worlds[2])
    assert rc0 == rc1 == 0 and text1 == ""
    assert "2 ranks over gloo; CG loop: graphs" in text0
    assert files0 == files == ["solution-2d-1.vtu", "solution-2d-2.vtu"]
    assert "2 VTU files" in text0
    assert _final_u2(text0) == pytest.approx(_final_u2(text), rel=1e-9)
    assert _final_u2(text) > 0
