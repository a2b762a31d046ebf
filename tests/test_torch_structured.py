"""Structured cell access, overlap-add and structured operators of the
PyTorch package against the JAX package (f64, rtol 1e-12), and the plain
versions of the Q1 (K3 in 3D, K4b in 2D) and Q2 (K5) kernels against the
JAX operators they replace."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxDofSpace
from dealii_adapter_tpu.mesh.generator import make_scenario_grid as jax_grid
from dealii_adapter_tpu.ops import structured as jst
from dealii_adapter_tpu.ops.element_ops import ElementMatrices as JaxElem
from dealii_adapter_tpu.ops.pallas_structured import (
    make_pallas_q1_operator,
    make_pallas_q1_slab_operator,
)
from dealii_adapter_tpu_torch.convert import element_matrix_from_jax
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.ops import structured as tst
from dealii_adapter_tpu_torch.ops.element_ops import ElementMatrices
from dealii_adapter_tpu_torch.ops.q1_structured import (
    Q1StructuredOperator,
    Q1StructuredOperator2D,
    make_q1_operator,
)
from dealii_adapter_tpu_torch.ops.q2_structured import (
    Q2StructuredOperator,
    _PlainDegreeOperator,
    make_q2_operator,
)

torch.set_num_threads(1)
RTOL = 1e-12  # f64: only the summation order may differ


def _spaces(dim, degree):
    jm, _ = jax_grid("PF", dim, degree, solver="neo-Hookean")
    tm, _ = make_scenario_grid("PF", dim, degree, solver="neo-Hookean")
    return JaxDofSpace.create(jm), DofSpace.create(tm)


def _E(space, elem_cls):
    el = elem_cls(space, 1.3e6, 0.5e6, 1000.0)
    return el.K_e + 4.0e7 * el.M_e


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("degree", [1, 2, 4])
def test_extract_overlap_and_operator_match_jax(dim, degree):
    js, ts = _spaces(dim, degree)
    gs, rr = tst._grid_shape(ts), tst._cells_shape(ts)
    assert gs == jst._grid_shape(js) and rr == jst._cells_shape(js)
    rng = np.random.default_rng(10 * dim + degree)
    u = rng.standard_normal(gs + (dim,))
    a = np.asarray(jst.extract_cell_patches_T(jnp.asarray(u), degree, rr))
    b = tst.extract_cell_patches_T(torch.from_numpy(u), degree, rr).numpy()
    np.testing.assert_array_equal(a, b)  # pure data movement

    rt = rng.standard_normal(b.shape)
    a = np.asarray(jst.overlap_add_T(jnp.asarray(rt), degree, rr, gs))
    b = tst.overlap_add_T(torch.from_numpy(rt), degree, rr, gs).numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * np.abs(a).max())

    E = _E(ts, ElementMatrices)
    np.testing.assert_array_equal(E, element_matrix_from_jax(_E(js, JaxElem)))
    jop = jst.make_structured_operator(js, E, jnp.float64)
    top = tst.make_structured_operator(ts, E, torch.float64, "cpu")
    v = rng.standard_normal((ts.n_nodes, dim))
    a = np.asarray(jop(jnp.asarray(v)))
    b = top(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * np.abs(a).max())
    np.testing.assert_allclose(
        top.diagonal().numpy(), np.asarray(jop.diagonal()), rtol=RTOL
    )


def test_plain_q1_matches_pallas_slab_interpret():
    """K3's plain version against the Pallas slab kernel it replaces, run
    in interpret mode, on a 3D Q1 lattice with an anisotropic E."""
    js, ts = _spaces(3, 1)
    E = _E(ts, ElementMatrices)
    jop = make_pallas_q1_slab_operator(js, E, jnp.float64, interpret=True)
    top = make_q1_operator(ts, E, torch.float64, "cpu")
    v = np.random.default_rng(3).standard_normal((ts.n_nodes, 3))
    a = np.asarray(jop(jnp.asarray(v)))
    Q1StructuredOperator.launches = 0
    b = top(torch.from_numpy(v)).numpy()
    assert Q1StructuredOperator.launches == 0  # CPU tensor: plain version
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * np.abs(a).max())
    np.testing.assert_allclose(
        top.diagonal().numpy(), np.asarray(jop.diagonal()), rtol=RTOL
    )


@pytest.mark.parametrize("dim", [2, 3])
def test_plain_q2_matches_structured(dim):
    """The Q2 fine operator against the JAX structured Q2 operator: the f64
    fine operator is the plain operator without a kernel in 2D and 3D
    (the JAX package's `pallas_q2_supported` admits f32 and bf16 only, and
    it has no 2D Q2 kernel), and K5's plain version in 3D (the Pallas
    phase kernel's interpret run is slow; both compute this)."""
    js, ts = _spaces(dim, 2)
    E = _E(ts, ElementMatrices)
    jop = jst.make_structured_operator(js, E, jnp.float64)
    top = make_q2_operator(ts, E, torch.float64, "cpu")
    assert isinstance(top, _PlainDegreeOperator)
    ops = [top]
    if dim == 3:
        ops.append(Q2StructuredOperator(E, tst._grid_shape(ts), torch.float64,
                                        "cpu"))
    v = np.random.default_rng(4).standard_normal((ts.n_nodes, dim))
    a = np.asarray(jop(jnp.asarray(v)))
    Q2StructuredOperator.launches = 0
    for op in ops:
        b = op(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * np.abs(a).max())
        np.testing.assert_allclose(
            op.diagonal().numpy(), np.asarray(jop.diagonal()), rtol=RTOL
        )
    assert Q2StructuredOperator.launches == 0


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
def test_plain_versions_compute_in_f32_and_round_to_io_dtype(io):
    """The plain K3/K5 path computes in f32 and rounds once to the I/O
    dtype, as the kernels do."""
    _, ts = _spaces(3, 2)
    E = _E(ts, ElementMatrices)
    op = make_q2_operator(ts, E, io, "cpu")
    v = torch.from_numpy(
        np.random.default_rng(5).standard_normal((ts.n_nodes, 3))
    ).to(io)
    ref = tst.make_structured_operator(ts, E, torch.float32, "cpu")(
        v.float()).to(io)
    out = op(v)
    assert out.dtype == io
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_plain_q1_2d_matches_pallas_interpret():
    """K4b's plain version against the 2D Pallas kernel it replaces
    (`PallasQ1Operator` over `_make_kernel_2d`), run in interpret mode, on a
    2D Q1 lattice with an anisotropic E."""
    js, ts = _spaces(2, 1)
    E = _E(ts, ElementMatrices)
    jop = make_pallas_q1_operator(js, E, jnp.float64, interpret=True)
    top = make_q1_operator(ts, E, torch.float64, "cpu")
    assert isinstance(top, Q1StructuredOperator2D)
    v = np.random.default_rng(6).standard_normal((ts.n_nodes, 2))
    a = np.asarray(jop(jnp.asarray(v)))
    Q1StructuredOperator2D.launches = 0
    b = top(torch.from_numpy(v)).numpy()
    assert Q1StructuredOperator2D.launches == 0  # CPU tensor: plain version
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * np.abs(a).max())
    np.testing.assert_allclose(
        top.diagonal().numpy(), np.asarray(jop.diagonal()), rtol=RTOL
    )


@pytest.mark.parametrize("io", [torch.float32, torch.bfloat16])
def test_plain_q1_2d_computes_in_f32_and_rounds_to_io_dtype(io):
    """The plain K4b path computes in f32 and rounds once to the I/O dtype,
    as the kernel does."""
    _, ts = _spaces(2, 1)
    E = _E(ts, ElementMatrices)
    op = make_q1_operator(ts, E, io, "cpu")
    v = torch.from_numpy(
        np.random.default_rng(7).standard_normal((ts.n_nodes, 2))
    ).to(io)
    ref = tst.make_structured_operator(ts, E, torch.float32, "cpu")(
        v.float()).to(io)
    out = op(v)
    assert out.dtype == io and out.shape == (ts.n_nodes, 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
