"""Assembled per-cell tangent of the PyTorch package against the JAX
package (f64 rtol 1e-10, f32 rtol 1e-5), the plain version of K1 against
the Pallas kernel it replaces (interpret mode), and K1 against
`torch.func.jvp` of the ported internal force."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.models.material import NeoHookean as JaxNeoHookean
from dealii_adapter_tpu.ops import assembled_tangent as jat
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.models.material import NeoHookean
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    internal_force_cellwise_T,
)
from dealii_adapter_tpu_torch.ops import assembled_tangent as tat
from dealii_adapter_tpu_torch.ops.element_ops import ElementMatrices
from dealii_adapter_tpu_torch.ops.structured import (
    _cells_shape,
    _grid_shape,
    extract_cell_patches_T,
    overlap_add_T,
)

torch.set_num_threads(1)
MU, NU, RHO = 0.5e6, 0.4, 1000.0
RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _setup(dim, degree, dtype, seed=0):
    mesh, _ = make_scenario_grid("PF", dim, degree, solver="neo-Hookean")
    space = DofSpace.create(mesh, n_q_1d=degree + 2)
    h = np.asarray(mesh.cell_h)
    G = space.tab.dN / h[None, None, :]
    w = space.tab.q_weights * float(np.prod(h))
    rng = np.random.default_rng(seed)
    npc = space.tab.n_nodes
    n_cells = int(np.prod(mesh.reps))
    # small enough that det F stays near 1 (grad u ~ 1e-2)
    ut = 1e-4 * rng.standard_normal((dim, npc, n_cells))
    m = np.asarray(ElementMatrices(space, 0.0, 0.0, RHO).M_e)
    mass = 4.0e4 * m.reshape(npc, dim, npc, dim)[:, 0, :, 0]
    np_arrays = dict(G=G, w=w, ut=ut, mass=mass)
    t = {k: torch.as_tensor(v, dtype=dtype) for k, v in np_arrays.items()}
    j = {k: jnp.asarray(v, dtype=JDT[dtype]) for k, v in np_arrays.items()}
    return space, t, j


def _close(b, a, rtol):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * np.abs(a).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim", [2, 3])
def test_piola_tangent_blocks_match_jax(dtype, dim):
    rng = np.random.default_rng(dim)
    g = 0.05 * rng.standard_normal((dim, dim, 7, 11))
    jc = jat.piola_tangent_blocks(
        [[jnp.asarray(g[i, j], JDT[dtype]) for j in range(dim)] for i in range(dim)],
        JaxNeoHookean(MU, NU, RHO),
    )
    tc = tat.piola_tangent_blocks(
        [[torch.as_tensor(g[i, j], dtype=dtype) for j in range(dim)]
         for i in range(dim)],
        NeoHookean(MU, NU, RHO),
    )
    assert sorted(jc) == sorted(tc)
    for key in jc:
        _close(tc[key].numpy(), jc[key], RTOL[dtype])
    # the stacked spatial tangent J c of the material, for API parity
    F = np.eye(dim)[:, :, None, None] + g
    J = np.linalg.det(np.moveaxis(F, (0, 1), (-2, -1)))
    b = np.einsum("ikqc,jkqc->qcij", F, F) * (J ** (-2.0 / dim))[..., None, None]
    _close(
        NeoHookean(MU, NU, RHO).Jc(
            torch.as_tensor(J, dtype=dtype), torch.as_tensor(b, dtype=dtype)
        ).numpy(),
        JaxNeoHookean(MU, NU, RHO).Jc(
            jnp.asarray(J, JDT[dtype]), jnp.asarray(b, JDT[dtype])
        ),
        RTOL[dtype],
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim", [2, 3])
def test_assemble_and_pack_match_jax(dtype, dim):
    space, t, j = _setup(dim, 2, dtype)
    Kj = jat.assemble_cell_tangents(
        j["ut"], j["G"], j["w"], JaxNeoHookean(MU, NU, RHO),
        mass_term=j["mass"], precision="highest",
    )
    Kt = tat.assemble_cell_tangents(
        t["ut"], t["G"], t["w"], NeoHookean(MU, NU, RHO), mass_term=t["mass"]
    )
    for d in range(dim):
        for e in range(dim):
            _close(Kt[d][e].numpy(), Kj[d][e], RTOL[dtype])
    KTj = jat.pack_cell_tangents_T(Kj)
    KTt = tat.pack_cell_tangents_T(Kt)
    _close(KTt.numpy(), KTj, RTOL[dtype])
    # the pack of the port is the exact column-major rearrangement
    npc = space.tab.n_nodes
    for d in range(dim):
        for e in range(dim):
            torch.testing.assert_close(
                KTt[e * npc:(e + 1) * npc, d * npc:(d + 1) * npc],
                Kt[d][e].transpose(0, 1), rtol=0, atol=0,
            )


def test_plain_k1_matches_pallas_interpret():
    """K1's plain version against `apply_packed_tangents_T_pallas`
    (interpret mode) on an assembled, packed tangent."""
    _, t, _ = _setup(3, 2, torch.float64, seed=1)
    bc = 64
    n_cells = t["ut"].shape[-1]
    Kt = tat.assemble_cell_tangents(
        t["ut"], t["G"], t["w"], NeoHookean(MU, NU, RHO), mass_term=t["mass"]
    )
    KT = tat.pack_cell_tangents_T(Kt)
    pad = (-n_cells) % bc
    KT_p = torch.nn.functional.pad(KT, (0, pad))
    v = np.random.default_rng(2).standard_normal((KT.shape[0], n_cells + pad))
    a = jat.apply_packed_tangents_T_pallas(
        jnp.asarray(KT_p.numpy()), jnp.asarray(v), block_c=bc, interpret=True
    )
    tat.apply_packed_tangents_T.launches = 0
    b = tat.apply_packed_tangents_T(KT_p, torch.from_numpy(v))
    assert tat.apply_packed_tangents_T.launches == 0  # CPU: plain version
    _close(b.numpy(), a, 1e-12)
    # the nested-list apply computes the same product
    npc = KT.shape[0] // 3
    nested = tat.apply_cell_tangents(
        Kt, torch.from_numpy(v[:, :n_cells]).reshape(3, npc, n_cells)
    )
    _close(nested.reshape(3 * npc, n_cells).numpy(),
           np.asarray(a)[:, :n_cells], 1e-12)
    # the kernel needs no padding: the unpadded apply is the same prefix
    b0 = tat.apply_packed_tangents_T(KT, torch.from_numpy(v[:, :n_cells]))
    _close(b0.numpy(), np.asarray(a)[:, :n_cells], 1e-12)


@pytest.mark.parametrize("dim", [2, 3])
def test_k1_equals_jvp_of_internal_force(dim):
    """extract -> K1 -> overlap-add with the assembled tangent equals the
    forward-mode derivative of the ported internal force."""
    space, t, _ = _setup(dim, 2, torch.float64, seed=3)
    gs, rr, p = _grid_shape(space), _cells_shape(space), 2
    material = NeoHookean(MU, NU, RHO)
    rng = np.random.default_rng(4)
    u = torch.as_tensor(1e-4 * rng.standard_normal(gs + (dim,)))
    v = torch.as_tensor(rng.standard_normal(gs + (dim,)))

    def f_int(x):
        rt, _ = internal_force_cellwise_T(
            extract_cell_patches_T(x, p, rr), t["G"], t["w"], material
        )
        return overlap_add_T(rt, p, rr, gs)

    _, jv = torch.func.jvp(f_int, (u,), (v,))
    ut = extract_cell_patches_T(u, p, rr)
    KT = tat.pack_cell_tangents_T(
        tat.assemble_cell_tangents(ut, t["G"], t["w"], material)
    )
    pv = extract_cell_patches_T(v, p, rr)
    _, npc, c = pv.shape
    o = tat.apply_packed_tangents_T(KT, pv.reshape(dim * npc, c))
    Kv = overlap_add_T(o.reshape(dim, npc, c), p, rr, gs)
    _close(Kv.numpy(), jv.numpy(), 1e-10)
