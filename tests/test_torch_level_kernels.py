"""The host-side preparation that the redesigned kernel K5 (3D Q2 fine
proxy, tensor cores) reads, pinned to the JAX package's
`StructuredOperator` in f64 through a numpy mirror of the kernel's
arithmetic: `q2_mma_fragments`, unpacked by the PTX ISA's m16n8k16
B-fragment layout, gives back E_hi + E_lo with zero padding, E - E_hi -
E_lo is below 2^-17 |E| elementwise (plus f32's 2^-24), and the mirror
product (E_hi + E_lo) u for bf16-exact u is within 2e-5 relative L2 of
the JAX f64 operator. K3 reads K6's tables (tests/test_torch_stencil.py).

The kernels themselves run only on the card: tests/test_torch_package.py
(`-m cuda`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.fem.dofspace import DofSpace as JaxDofSpace
from dealii_adapter_tpu.mesh.generator import (
    subdivided_hyper_rectangle as jax_rect,
)
from dealii_adapter_tpu.ops.structured import (
    make_structured_operator as jax_structured,
)
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import subdivided_hyper_rectangle
from dealii_adapter_tpu_torch.ops.element_ops import ElementMatrices
from dealii_adapter_tpu_torch.ops.q2_structured import (
    Q2_KSTEPS,
    Q2_NTILES,
    Q2StructuredOperator,
    q2_mma_fragments,
    q2_split_bf16,
)

torch.set_num_threads(1)


def _box(reps, p, h=(0.7, 0.5, 0.9), coeffs=(1.3, 0.7, 2.1)):
    """Both packages' DoF spaces of an anisotropic degree-p box and its
    K + M element matrix."""
    p1 = tuple(hi * r for hi, r in zip(h, reps))
    space = DofSpace.create(subdivided_hyper_rectangle(reps, (0.0,) * 3, p1, p))
    jspace = JaxDofSpace.create(jax_rect(reps, (0.0,) * 3, p1, p))
    el = ElementMatrices(space, *coeffs)
    return space, jspace, el.K_e + el.M_e


def _jax_apply(jspace, E, u):
    return np.asarray(jax_structured(jspace, E, jnp.float64)(jnp.asarray(u)))


def _unpack_fragments(frag):
    """B (2, 96, 88) from K5's fragments, by the m16n8k16 B layout: lane
    4 g + t holds column n = g, rows k = 2 t, 2 t + 1 (register 0) and
    2 t + 8, 2 t + 9 (register 1) of each 16 x 8 tile."""
    bits = torch.from_numpy(frag.view(np.int16).copy()).view(torch.bfloat16)
    vals = bits.float().numpy()
    B = np.full((2, 16 * Q2_KSTEPS, 8 * Q2_NTILES), np.nan)
    for h, j, s, lane, q in np.ndindex(*frag.shape):
        g, t = divmod(lane, 4)
        k = 16 * s + 2 * t + (q & 1) + 8 * (q >> 1)
        B[h, k, 8 * j + g] = vals[h, j, s, lane, q]
    return B


def test_k5_fragments_hold_the_split_element_matrix():
    _, _, E = _box((1, 1, 1), 2)
    frag = q2_mma_fragments(E)
    assert frag.dtype == np.uint16
    assert frag.shape == (2, Q2_NTILES, Q2_KSTEPS, 32, 4)
    B = _unpack_fragments(frag)
    assert not np.isnan(B).any()  # every position written exactly once
    assert not B[:, 81:, :].any() and not B[:, :, 81:].any()  # padding
    hi, lo = q2_split_bf16(E)
    np.testing.assert_array_equal(B[0, :81, :81].T, hi)
    np.testing.assert_array_equal(B[1, :81, :81].T, lo)
    E32 = E.astype(np.float32).astype(np.float64)
    assert np.all(np.abs(E32 - hi - lo) <= 2.0**-17 * np.abs(E32))
    assert np.all(np.abs(E - E32) <= 2.0**-24 * np.abs(E))


@pytest.mark.parametrize("reps", [(1, 1, 1), (2, 3, 1), (4, 2, 3)])
def test_k5_mirror_product_matches_jax_structured_operator(reps):
    """(E_hi + E_lo) u, summed in f64, with u exact in bf16 as on the
    kernel's bf16 path, against the JAX f64 operator with E."""
    space, jspace, E = _box(reps, 2)
    B = _unpack_fragments(q2_mma_fragments(E))
    E_rec = (B[0] + B[1])[:81, :81].T
    grid = tuple(2 * r + 1 for r in reversed(reps))
    u = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (space.n_nodes, 3))).to(torch.bfloat16).double().numpy()
    ref = _jax_apply(jspace, E, u)
    op = Q2StructuredOperator(E_rec, grid, torch.float64, "cpu")
    got = op(torch.from_numpy(u)).numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 2e-5
    # the wrapper holds the same fragments and the f32 matrix for the f32 path
    op = Q2StructuredOperator(E, grid, torch.float32, "cpu")
    np.testing.assert_array_equal(
        op._coef[0].numpy().view(np.uint16), q2_mma_fragments(E))
    np.testing.assert_array_equal(op._coef[1].numpy(), E.astype(np.float32))
