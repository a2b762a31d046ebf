"""The assembled-stencil Q1 operator (kernel K6's module) and the
plane-marching Q1 factory (kernel K4's) of the PyTorch package against the
JAX package: the stencil tables bitwise, the operator against
`make_q1_stencil_operator` (strategy `vmem`, its Pallas kernel in
interpret mode, in 3D; `shift` in 2D) in f64 (atol 1e-12 x max) and bf16
(relative L2 1e-2), its diagonal (1e-12), the folded per-class tables K6
reads (a numpy mirror of the kernel's loop, 1e-12) and K3 and K4b read
in f32 and f64 (against the JAX `StructuredOperator`, 1e-6 and 1e-13; at
every level of a 3D and a 2D hierarchy), the K4 factory against
`make_pallas_q1_operator(..., interpret=True)` (1e-13) and a V-cycle with
`level_backend="stencil_vmem"` (atol 1e-11 x max). K4 and K6 against
their plain versions on the card: tests/test_torch_package.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxDofSpace
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu.mesh.generator import (
    subdivided_hyper_rectangle as jax_rect,
)
from dealii_adapter_tpu.ops.pallas_structured import make_pallas_q1_operator
from dealii_adapter_tpu.ops.stencil import make_q1_stencil_operator as jax_stencil
from dealii_adapter_tpu.ops.stencil import q1_stencil_tables as jax_tables
from dealii_adapter_tpu.ops.structured import (
    make_structured_operator as jax_structured,
)
from dealii_adapter_tpu.solvers.multigrid import GeometricMultigrid as JaxMG
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.mesh.generator import subdivided_hyper_rectangle
from dealii_adapter_tpu_torch.ops.element_ops import (
    ElementMatrices,
    assemble_diagonal,
)
from dealii_adapter_tpu_torch.ops.q1_structured import (
    Q1PlaneOperator,
    Q1StructuredOperator,
    Q1StructuredOperator2D,
    make_q1_plane_operator,
)
from dealii_adapter_tpu_torch.ops.stencil import (
    STRATEGIES,
    StencilQ1Operator,
    make_q1_stencil_operator,
    q1_stencil_tables,
)
from dealii_adapter_tpu_torch.ops.structured import make_structured_operator
from dealii_adapter_tpu_torch.solvers.multigrid import (
    GeometricMultigrid,
    _geometry_skeleton,
)

torch.set_num_threads(1)

# (dim, reps): anisotropic lattices, every node on a corner or edge
# (1, 1, 1), one-cell-thick slabs (an axis of 2 nodes: reps 1)
CASES = [
    (2, (3, 2)),
    (2, (1, 4)),
    (3, (3, 2, 4)),
    (3, (1, 1, 1)),
    (3, (2, 1, 3)),
]


def _setup(dim, reps, lmbda=1.3, mu=0.7, rho=2.1):
    """Both packages' DoF spaces of an anisotropic Q1 box and its element
    matrix (from the port's copy of the host code; the copies are pinned
    in test_torch_mesh_fem.py)."""
    p1 = tuple(0.7 * r for r in reps)
    space = DofSpace.create(subdivided_hyper_rectangle(reps, (0.0,) * dim, p1, 1))
    jspace = JaxDofSpace.create(jax_rect(reps, (0.0,) * dim, p1, 1))
    el = ElementMatrices(space, lmbda, mu, rho)
    return space, jspace, el.K_e + el.M_e


def _jax_op(jspace, E, dtype):
    strategy = "vmem" if jspace.dim == 3 else "shift"
    return jax_stencil(jspace, E, dtype, strategy=strategy)


def _jax_apply(jspace, E, dtype, u):
    """The JAX stencil applied once, jitted (one compile of the
    interpreted kernel instead of one per primitive)."""
    return np.asarray(jax.jit(_jax_op(jspace, E, dtype))(u), dtype=np.float64)


def _class_apply(tables, shape, u):
    """K6's (and K3's) loop in numpy, in f64: every node applies its
    class's folded table to its in-lattice neighbours (the zero padding
    of the plain version)."""
    nd, dim = len(shape), u.shape[-1]
    g = u.reshape(shape + (dim,))
    gp = np.zeros(tuple(n + 2 for n in shape) + (dim,))
    gp[(slice(1, -1),) * nd] = g
    idx = np.indices(shape)
    cls = np.zeros(shape, dtype=np.int64)
    for ax in range(nd):
        c = np.where(idx[ax] == 0, 0, np.where(idx[ax] == shape[ax] - 1, 2, 1))
        cls = cls * 3 + c
    out = np.zeros(shape + (dim,))
    for o, delta in enumerate(np.ndindex(*(3,) * nd)):
        win = gp[tuple(slice(d, d + n) for d, n in zip(delta, shape))]
        out += np.einsum("...de,...e->...d", tables[cls, o], win)
    return out.reshape(-1, dim)


@pytest.mark.parametrize("dim,reps", CASES)
def test_stencil_tables_identical(dim, reps):
    _, _, E = _setup(dim, reps)
    ours, ref = q1_stencil_tables(E, dim, dim), jax_tables(E, dim, dim)
    np.testing.assert_array_equal(ours[0], ref[0])
    for a, b in zip(ours[1:], ref[1:]):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dim,reps", CASES)
def test_stencil_matches_jax_f64(dim, reps):
    """The plain version, and K6's folded tables applied as the kernel
    applies them, against the JAX stencil; the diagonal too."""
    space, jspace, E = _setup(dim, reps)
    u = np.random.default_rng(11).standard_normal((space.n_nodes, dim))
    ref = _jax_apply(jspace, E, jnp.float64, jnp.asarray(u))
    op = make_q1_stencil_operator(space, E, torch.float64, device="cpu")
    atol = 1e-12 * np.abs(ref).max()
    np.testing.assert_allclose(op(torch.as_tensor(u)).numpy(), ref, rtol=0,
                               atol=atol)
    np.testing.assert_allclose(_class_apply(op.class_tables, op.grid_shape, u),
                               ref, rtol=0, atol=atol)
    dref = np.asarray(_jax_op(jspace, E, jnp.float64).diagonal())
    np.testing.assert_allclose(op.diagonal().numpy(), dref, rtol=1e-12,
                               atol=1e-12 * np.abs(dref).max())


def _k3_table_check(E, shape, jspace, seed):
    """K3 (3D) and K4b (2D) read K6's tables: the class tables four values
    a row (3D: each row of 3 source components padded with a zero; 2D:
    the 2 x 2 block), bitwise the table K6 itself reads of the same dtype.
    In f32 (one float4 a row), applied by the kernels' loop (in f64, from
    the f32 table), they match the JAX package's f64 `StructuredOperator`
    (the per-cell form, K3's and K4b's plain version) to 1e-6 relative L2:
    one f32 rounding per coefficient (2^-24), summed over 27 x 3 (9 x 2)
    terms a component. The f64 operators' tables (the kernels' f64
    instantiation) hold `class_tables` bit for bit and match the same
    reference to 1e-13: f64 roundoff over those terms."""
    dim = len(shape)
    cls = Q1StructuredOperator if dim == 3 else Q1StructuredOperator2D
    n_cls = 3**dim
    u = np.random.default_rng(seed).standard_normal((int(np.prod(shape)), dim))
    ref = np.asarray(jax_structured(jspace, E, jnp.float64)(jnp.asarray(u)))
    for dtype, npdt, rtol in ((torch.float32, np.float32, 1e-6),
                              (torch.float64, np.float64, 1e-13)):
        table = cls(E, shape, dtype, "cpu")._coef[0].numpy()
        k6 = StencilQ1Operator(E, shape, dtype, device="cpu")
        np.testing.assert_array_equal(table, k6._tables_dev.numpy())
        assert table.dtype == npdt
        if dim == 3:
            assert table.shape == (n_cls, n_cls, 3, 4)
            assert not table[..., 3].any()  # the row padding
            folded = table[..., :3]
        else:
            assert table.shape == (n_cls, n_cls, 4)
            folded = table.reshape(n_cls, n_cls, 2, 2)
        np.testing.assert_array_equal(folded, k6.class_tables.astype(npdt))
        got = _class_apply(folded.astype(np.float64), shape, u)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= rtol


@pytest.mark.parametrize("reps", [(1, 1, 1), (1, 2, 4), (3, 1, 2), (4, 3, 5),
                                  (1, 1), (1, 5), (4, 1), (7, 6)])
def test_k3_folded_stencil_matches_jax_structured_operator(reps):
    """K3's table (3D reps) and K4b's (2D reps) on lattices with 2-node
    axes (reps 1) and on the interior of a larger one
    (`_k3_table_check`)."""
    space, jspace, E = _setup(len(reps), reps)
    _k3_table_check(E, tuple(r + 1 for r in reversed(reps)), jspace,
                    sum(reps))


def test_k3_tables_at_every_level_of_a_hierarchy():
    """K3's table (`_k3_table_check`) at every 3D Q1 level shape of the
    bench flap's hierarchy at scale 1 (the FEM-SEM level and the
    semi-coarsened ones), with the level's own anisotropic element
    matrix, as the multigrid builds K3."""
    mesh, tags = make_scenario_grid("PF", 3, 2, solver="neo-Hookean")
    geoms = _geometry_skeleton(mesh, tags, 300, True, 1.9e6, 0.5e6)
    assert len(geoms) >= 3
    for li, gm in enumerate(geoms):
        m = gm.m_c
        _k3_table_check(0.5e6 * gm.K_e_unit + 4.0e7 * gm.M_e_unit, gm.shape_c,
                        JaxDofSpace.create(jax_rect(m.reps, m.p0, m.p1, 1)), li)


def test_k4b_tables_at_every_level_of_a_hierarchy():
    """K4b's table (`_k3_table_check`) at every 2D Q1 level shape of the
    tutorial flap's hierarchy at scale 4 (the FEM-SEM level and the
    semi-coarsened ones, down to the coarse level), with the level's own
    anisotropic element matrix, as the multigrid builds K4b."""
    mesh, tags = make_scenario_grid("PF", 2, 2, scale=4, solver="linear")
    geoms = _geometry_skeleton(mesh, tags, 300, True, 2.0e6, 0.5e6)
    assert len(geoms) >= 4
    for li, gm in enumerate(geoms):
        m = gm.m_c
        _k3_table_check(0.5e6 * gm.K_e_unit + 4.0e7 * gm.M_e_unit, gm.shape_c,
                        JaxDofSpace.create(jax_rect(m.reps, m.p0, m.p1, 1)), li)


@pytest.mark.parametrize("dim,reps", [(2, (5, 3)), (3, (3, 2, 4))])
def test_stencil_bf16_matches_jax(dim, reps):
    """bf16 I/O: relative L2 1e-2 (one output rounding, 2^-8, plus the JAX
    vmem kernel's extra rounding of its interior pass to bf16)."""
    space, jspace, E = _setup(dim, reps)
    u = np.random.default_rng(5).standard_normal((space.n_nodes, dim))
    ub = torch.as_tensor(u).to(torch.bfloat16)
    ref = _jax_apply(jspace, E, jnp.bfloat16,
                     jnp.asarray(ub.float().numpy(), dtype=jnp.bfloat16))
    out = make_q1_stencil_operator(space, E, torch.bfloat16, device="cpu")(ub)
    assert out.dtype == torch.bfloat16
    out = out.double().numpy()
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) <= 1e-2


def test_every_strategy_is_one_formulation():
    """Every JAX strategy name is accepted and computes the same thing
    (one formulation: on the card each launches K6); others raise."""
    space, _, E = _setup(3, (2, 3, 2))
    u = torch.as_tensor(np.random.default_rng(1).standard_normal((space.n_nodes, 3)))
    outs = [make_q1_stencil_operator(space, E, torch.float64, strategy=s,
                                     device="cpu")(u) for s in STRATEGIES]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="strategy"):
        make_q1_stencil_operator(space, E, strategy="lanes", device="cpu")


@pytest.mark.parametrize("dim,reps", [(3, (6, 5, 4)), (3, (9, 23, 7)),
                                      (2, (7, 5))])
def test_plane_factory_matches_jax(dim, reps):
    """`make_q1_plane_operator` (K4 in 3D, K4b in 2D; their plain version
    on the CPU) against the JAX package's `make_pallas_q1_operator`, whose
    Pallas kernel runs in interpret mode, as tests/test_pallas_ops.py runs
    it."""
    p1 = tuple(float(r) for r in reps)
    space = DofSpace.create(subdivided_hyper_rectangle(reps, (0.0,) * dim, p1, 1))
    jspace = JaxDofSpace.create(jax_rect(reps, (0.0,) * dim, p1, 1))
    el = ElementMatrices(space, 2e6, 0.5e6, 1000.0)
    E = el.K_e + 3.3e4 * el.M_e
    op = make_q1_plane_operator(space, E, torch.float64, "cpu")
    assert type(op) is (Q1PlaneOperator if dim == 3 else Q1StructuredOperator2D)
    pal = make_pallas_q1_operator(jspace, E, jnp.float64, interpret=True)
    u = np.random.default_rng(0).standard_normal((space.n_nodes, dim))
    ref = np.asarray(pal(jnp.asarray(u)))
    out = op(torch.as_tensor(u)).numpy()
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-13
    dref = np.asarray(pal.diagonal())
    assert np.abs(op.diagonal().numpy() - dref).max() < 1e-8 * np.abs(dref).max()


def test_vcycle_stencil_vmem_matches_jax(monkeypatch):
    """One V-cycle with `level_backend="stencil_vmem"` (3D, so the JAX
    package runs its vmem Pallas kernel in interpret mode) on the setup of
    tests/test_multigrid.py::test_vmem_backend_matches_default_hierarchy,
    with a coarse size that leaves Q1 levels above the coarse solve. Both
    hierarchies take one set of lam_max values, the port's estimates
    (power iterations through the interpreted kernel would take the JAX
    package ~30 s here)."""
    from dealii_adapter_tpu.solvers import cg as jcg

    mu, nu, rho = 0.5e6, 0.4, 1000.0
    lmbda = 2 * mu * nu / (1 - 2 * nu)
    c = (0.5 * 0.01) ** 2
    jmesh, jtags = jax_grid("PF", 3, 2, scale=1, solver="linear")
    mesh, tags = make_scenario_grid("PF", 3, 2, scale=1, solver="linear")
    space = DofSpace.create(mesh)
    el = ElementMatrices(space, lmbda, mu, rho)
    A_e = c * el.K_e + el.M_e
    mask_np = space.dirichlet_mask(tags["clamped"], tags.get("out_of_plane"))
    diag_np = mask_np * assemble_diagonal(space, A_e) + (1 - mask_np)
    kw = dict(lmbda=c * lmbda, mu=c * mu, mass_coeff=rho, coarse_size=300,
              level_backend="stencil_vmem")

    traw = make_structured_operator(space, A_e, torch.float64, "cpu")
    tmask = torch.as_tensor(mask_np)
    tmg = GeometricMultigrid(
        mesh, tags, lambda v: tmask * traw(tmask * v) + (1 - tmask) * v,
        torch.as_tensor(diag_np), tmask, dtype=torch.float64, device="cpu",
        **kw,
    )
    lam = iter([lv.lam_max for lv in tmg.levels])
    # the JAX hierarchy imports it from its cg module at each estimate
    monkeypatch.setattr(jcg, "estimate_lambda_max", lambda *a, **k: next(lam))
    jraw = jax_structured(JaxDofSpace.create(jmesh), A_e)
    jmask = jnp.asarray(mask_np)
    jmg = JaxMG(jmesh, jtags, lambda v: jmask * jraw(jmask * v) + (1 - jmask) * v,
                jnp.asarray(diag_np), jmask, **kw)
    assert [lv.lam_max for lv in jmg.levels] == [lv.lam_max for lv in tmg.levels]
    assert len(tmg.levels) >= 3
    assert [lv.grid_shape for lv in tmg.levels] == [lv.grid_shape for lv in jmg.levels]
    for lv in jmg.levels:  # one compile per level operator, not per call
        lv.operator = jax.jit(lv.operator)
    r = mask_np * np.random.default_rng(5).standard_normal((space.n_nodes, 3))
    a = np.asarray(jmg(jnp.asarray(r)))
    b = tmg(torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-11 * np.abs(a).max())


def test_unknown_level_backend_rejected():
    mesh, tags = make_scenario_grid("PF", 2, 1, scale=1, solver="linear")
    v = torch.ones((DofSpace.create(mesh).n_nodes, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="mg_level_backend"):
        GeometricMultigrid(mesh, tags, lambda x: x, v, v, 1.0, 1.0,
                           level_backend="stencilflat", device="cpu")
