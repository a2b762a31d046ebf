"""Assembled per-cell tangent of the PyTorch package against the JAX
package (f64 rtol 1e-10, f32 rtol 1e-5), full and block-symmetric; the
plain versions of K1, K1b, K1c, K2 and K2b against the Pallas kernels they
replace (interpret mode, f64 rtol 1e-12); K1 against `torch.func.jvp`
of the ported internal force; and the f32 tangent's action on rigid
translations against the f64 tangent's (2e-5)."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_adapter_tpu.config import AllParameters as JaxParams
from dealii_adapter_tpu.models.material import NeoHookean as JaxNeoHookean
from dealii_adapter_tpu.models.nonlinear_elasticity import (
    NonlinearElasticity as JaxModel,
)
from dealii_adapter_tpu.ops import assembled_tangent as jat
from dealii_adapter_tpu_torch.convert import params_from_jax, state_to_numpy
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
from dealii_adapter_tpu_torch.models.material import NeoHookean
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
    internal_force_cellwise_T,
    tangent_kernel_id,
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


@pytest.mark.parametrize("kernel", ["K1", "K1b", "K1c", "K2", "K2b"])
def test_layouts_write_into_out(kernel):
    """Each tangent layout, assembled again with `out=` an earlier result,
    keeps the earlier tensors (the address a captured CG graph reads) and
    holds the new tangent bit for bit as a fresh assembly; a buffer of
    another shape raises."""
    space, t, _ = _setup(3, 2, torch.float32)
    mat = NeoHookean(MU, NU, RHO)
    sym = kernel in ("K2", "K2b")
    assemble = tat.assemble_cell_tangents_sym if sym else tat.assemble_cell_tangents
    pack = {"K1": tat.pack_cell_tangents_T, "K1b": tat.pack_cell_tangents,
            "K2": tat.pack_cell_tangents_sym}.get(kernel)

    def layout(ut, out=None):
        if pack is None:
            return assemble(ut, t["G"], t["w"], mat, mass_term=t["mass"],
                            out=out)
        return pack(assemble(ut, t["G"], t["w"], mat, mass_term=t["mass"]),
                    out=out)

    def flat(K):
        if torch.is_tensor(K):
            return [K]
        return [b for row in K for b in (row if isinstance(row, list) else [row])]

    first = layout(t["ut"])
    ptrs = [b.data_ptr() for b in flat(first)]
    ut2 = 1.5 * t["ut"]
    again = layout(ut2, out=first)
    fresh = layout(ut2)
    assert [b.data_ptr() for b in flat(again)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(flat(again), flat(fresh)))
    assert not torch.equal(flat(first)[0], flat(layout(t["ut"]))[0])
    with pytest.raises(ValueError, match="out"):
        if pack is None:
            assemble(t["ut"], t["G"], t["w"], mat,
                     out=[b[:-1] for b in flat(first)][:len(tat.upper_blocks(3))]
                     if sym else [[b[:-1] for b in row] for row in first])
        else:
            layout(t["ut"], out=first[:-1])


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


def _padded(x, bc):
    """Pad the trailing cell axis to a multiple of `bc` (the JAX Pallas
    kernels' lane blocks; the port's kernels take any cell count)."""
    return np.pad(np.asarray(x), [(0, 0)] * (x.ndim - 1) + [(0, (-x.shape[-1]) % bc)])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kernel", ["K1b", "K1c", "K2", "K2b"])
def test_plain_tangent_kernels_match_pallas_interpret(kernel, dim):
    """The plain versions of K1b, K1c, K2 and K2b against the Pallas kernels
    they replace (interpret mode) on an assembled tangent, padded to the
    kernels' lane block on the JAX side only (f64, rtol 1e-12); on CPU
    tensors the wrappers launch nothing."""
    _, t, _ = _setup(dim, 2, torch.float64, seed=5)
    bc = 64
    npc, c = t["ut"].shape[1], t["ut"].shape[-1]
    args = (t["ut"], t["G"], t["w"], NeoHookean(MU, NU, RHO))
    v = np.random.default_rng(6).standard_normal((dim * npc, c))
    vj = jnp.asarray(_padded(v, bc))
    u2 = torch.from_numpy(v)
    if kernel in ("K1b", "K1c"):
        K = tat.assemble_cell_tangents(*args, mass_term=t["mass"])
        Kj = [[jnp.asarray(_padded(K[d][e].numpy(), bc)) for e in range(dim)]
              for d in range(dim)]
        if kernel == "K1b":
            a = jat.apply_packed_tangents_pallas(
                jat.pack_cell_tangents(Kj), vj, block_c=bc, interpret=True)
            wrapper = tat.apply_packed_tangents
            b = wrapper(tat.pack_cell_tangents(K), u2)
        else:
            a = jat.apply_block_tangents_pallas(Kj, vj, block_c=bc,
                                                interpret=True)
            wrapper = tat.apply_block_tangents
            b = wrapper(K, u2)
    else:
        Ku = tat.assemble_cell_tangents_sym(*args, mass_term=t["mass"])
        Kuj = [jnp.asarray(_padded(k.numpy(), bc)) for k in Ku]
        if kernel == "K2":
            a = jat.apply_packed_tangents_sym_pallas(
                jat.pack_cell_tangents_sym(Kuj), vj, dim, npc, block_c=bc,
                interpret=True)
            wrapper = tat.apply_packed_tangents_sym
            b = wrapper(tat.pack_cell_tangents_sym(Ku), u2, dim, npc)
        else:
            a = jat.apply_sym_block_tangents_pallas(Kuj, vj, dim, npc,
                                                    block_c=bc, interpret=True)
            wrapper = tat.apply_sym_block_tangents
            b = wrapper(Ku, u2, dim, npc)
    assert wrapper.launches == 0  # CPU tensors: the plain version
    _close(b.numpy(), np.asarray(a)[:, :c], 1e-12)
    # every layout applies the one tangent
    full = tat.apply_cell_tangents(
        tat.assemble_cell_tangents(*args, mass_term=t["mass"]),
        u2.reshape(dim, npc, c))
    _close(b.numpy(), full.reshape(dim * npc, c).numpy(), 1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim", [2, 3])
def test_assemble_and_pack_sym_match_jax(dtype, dim):
    """`assemble_cell_tangents_sym` and `pack_cell_tangents_sym` against the
    JAX package's (f64 rtol 1e-10, f32 rtol 1e-5); the upper blocks are
    those of the full assembly, bitwise."""
    _, t, j = _setup(dim, 2, dtype, seed=7)
    Kuj = jat.assemble_cell_tangents_sym(
        j["ut"], j["G"], j["w"], JaxNeoHookean(MU, NU, RHO),
        mass_term=j["mass"], precision="highest",
    )
    Kut = tat.assemble_cell_tangents_sym(
        t["ut"], t["G"], t["w"], NeoHookean(MU, NU, RHO), mass_term=t["mass"]
    )
    assert len(Kut) == len(tat.upper_blocks(dim)) == len(Kuj)
    for a, b in zip(Kuj, Kut):
        assert b.is_contiguous()
        _close(b.numpy(), a, RTOL[dtype])
    _close(tat.pack_cell_tangents_sym(Kut).numpy(),
           jat.pack_cell_tangents_sym(Kuj), RTOL[dtype])
    K = tat.assemble_cell_tangents(
        t["ut"], t["G"], t["w"], NeoHookean(MU, NU, RHO), mass_term=t["mass"]
    )
    for (d, e), b in zip(tat.upper_blocks(dim), Kut):
        torch.testing.assert_close(b, K[d][e], rtol=0, atol=0)
    # the full row-major pack, as the JAX package's
    Kj = jat.assemble_cell_tangents(
        j["ut"], j["G"], j["w"], JaxNeoHookean(MU, NU, RHO),
        mass_term=j["mass"], precision="highest",
    )
    _close(tat.pack_cell_tangents(K).numpy(), jat.pack_cell_tangents(Kj),
           RTOL[dtype])


def test_sym_storage_counts_its_bytes():
    """`tangent_bytes` counts the stored blocks: 6 of 9 in 3D, 3 of 4 in
    2D."""
    for dim, frac in ((3, 6 / 9), (2, 3 / 4)):
        mesh, _ = make_scenario_grid("PF", dim, 2, solver="neo-Hookean")
        space = DofSpace.create(mesh, n_q_1d=4)
        full = tat.tangent_bytes(space, torch.float32)
        assert tat.tangent_bytes(space, torch.float32, sym=True) == full * frac
        assert full == (dim * space.tab.n_nodes) ** 2 * np.prod(mesh.reps) * 4


# bench.py's production configuration in 2D, with an f32 hierarchy so that
# the two packages' CG counts agree and the comparison isolates the tangent
NONLINEAR_2D = dict(
    model="neo-Hookean", type_lin="CG", scenario="PF", dim=2, poly_degree=2,
    delta_t=0.01, mu=MU, nu=NU, rho=RHO, tol_lin=1e-6, tol_u=1e-6,
    tol_f=1e-9, max_iterations_lin=1.0, max_iterations_NR=10,
    dtype="float64", preconditioner="MG", precond_dtype="float32",
    solve_dtype="float32", newton_forcing="ew", mg_smooth_degree=3,
    mg_fine_smooth_degree=1, newton_predictor=True, ew_eta0=0.3,
)
KERNEL_OF = {  # (tangent_block_symmetric, tangent_matvec_kernel) -> kernel
    (False, "auto"): "K1", (False, "packedt"): "K1", (False, "xla"): "K1",
    (False, "packed"): "K1b", (False, "blocks"): "K1c",
    (True, "auto"): "K2", (True, "packed"): "K2", (True, "xla"): "K2",
    (True, "blocks"): "K2b",
}


def test_tangent_kernel_dispatch():
    """The knobs pick the kernels as the JAX package picks its Pallas
    kernels; 'packedt' with symmetric storage warns and runs K2."""
    for (sym, kind), kern in KERNEL_OF.items():
        p = JaxParams(tangent_block_symmetric=sym, tangent_matvec_kernel=kind)
        assert tangent_kernel_id(params_from_jax(p)) == kern
    p = params_from_jax(JaxParams(tangent_block_symmetric=True,
                                  tangent_matvec_kernel="packedt"))
    with pytest.warns(UserWarning, match="no block-symmetric variant"):
        assert tangent_kernel_id(p) == "K2"


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


@pytest.mark.parametrize("sym", [False, True])
def test_2d_steps_match_jax_for_every_tangent_kernel(sym):
    """Two Newmark steps of the 2D flap: the port with each kernel of the
    storage (`tangent_block_symmetric=sym`) against one JAX run (off the
    TPU the JAX result does not depend on the kernel knob): the same
    Newton iterations, displacements within rtol 1e-6. Every hierarchy
    takes the port's lam_max estimates (the fine proxy's, the same for
    every kernel)."""
    jp = JaxParams(tangent_block_symmetric=sym, **NONLINEAR_2D)
    lam = [lv.lam_max for lv in NonlinearElasticity(
        params_from_jax(jp), device="cpu")._precond.levels]
    with _jax_takes_lam_max(lam):
        jm = JaxModel(jp)
    assert [lv.lam_max for lv in jm._precond.levels] == lam
    stress = np.zeros((jm.space.n_nodes, 2))
    stress[jm.space.boundary_nodes[jm.interface_id], 0] = 1000.0
    js, jits = jm.initial_state(), []
    for _ in range(2):
        js, ji = jm.step(js, jnp.asarray(stress))
        assert bool(ji.converged)
        jits.append(int(ji.iterations))
    uj = np.asarray(js.displacement)
    for (s, kind), kern in KERNEL_OF.items():
        if s != sym or kind in ("packedt", "xla"):
            continue
        tm = NonlinearElasticity(
            params_from_jax(JaxParams(tangent_block_symmetric=sym,
                                      tangent_matvec_kernel=kind,
                                      **NONLINEAR_2D)),
            mg_lam_max=lam, device="cpu",
        )
        assert tm.tangent_kernel == kern
        ts, tits = tm.initial_state(), []
        for _ in range(2):
            ts, ti = tm.step(ts, torch.as_tensor(stress))
            assert ti.converged
            tits.append(ti.iterations)
        assert tits == jits, kern
        ut = state_to_numpy(ts)[0]
        np.testing.assert_allclose(ut, uj, rtol=1e-6,
                                   atol=1e-6 * np.abs(uj).max(), err_msg=kern)


def test_f32_tangent_keeps_rigid_translations_nearly_free():
    """The f32 Newton tangent at u = 0 (the benchmark configuration at
    scale 1, 2,331 DoF) acts on each rigid translation as the same
    model's f64 tangent does, to 2e-5 relative: the element tangents
    are contracted with a sum in f64 and rounded once to f32
    (`ops/assembled_tangent.py:_assemble_upper`), so the stiffness that
    cancels on a translation stays cancelled to about the rounding of
    the entries (measured: 1.0e-5, 7.7e-7, 4.5e-7 for x, y, z). Contracted
    as one f32 product, the defect here was 3.9e-5, 3.5e-6, 2.3e-6; at
    the benchmark's full size it reached 2.3e-4 between the card and the
    CPU and the card's Newton CG took 59 iterations in the first step
    instead of 31 (ROADMAP Queue 3, fixed)."""
    def params(solve_dtype):
        return params_from_jax(JaxParams(
            model="neo-Hookean", dim=3, poly_degree=2, scenario="PF",
            type_lin="CG", preconditioner="Jacobi", solve_dtype=solve_dtype,
            mu=MU, nu=NU, rho=RHO, delta_t=0.01,
        ))

    m32 = NonlinearElasticity(params("float32"), device="cpu")
    m64 = NonlinearElasticity(params("float64"), mesh=m32.mesh, tags=m32.tags,
                              device="cpu")
    n = m32.space.n_nodes
    for comp in range(3):
        t = torch.zeros(n, 3, dtype=torch.float64)
        t[:, comp] = 1.0
        ys = []
        for m in (m32, m64):
            assemble, make = m._make_tangent_fns()
            K = assemble(torch.zeros(n, 3, dtype=m.solve_dtype))
            ys.append(make(K)(t.to(m.solve_dtype)).double())
        rel = float((ys[0] - ys[1]).norm() / ys[1].norm())
        assert rel <= 2e-5, (comp, rel)


@pytest.mark.parametrize("sym", [False, True])
def test_bf16emu_assembly_matches_jax(sym):
    """`tangent_assembly_precision="bf16emu"`: both operands of each
    assembly product rounded to bf16, accumulated in f32, as the JAX
    package's `_pdot` does, on a 2D Q2 f32 case against its
    `assemble_cell_tangents(..., precision="bf16emu")` (and the `_sym`
    form): within 2e-4 of the largest entry. The two sum their f32
    products in other orders, so a pointwise tangent entry near a bf16
    rounding boundary can round to its neighbour (one bf16 ulp of one
    term); the bf16 emulation itself moves the tangent 1e-3 to 1e-2 of
    its largest entry from the full-precision one, which the test also
    requires, so the limit tells the tiers apart."""
    _, t, j = _setup(2, 2, torch.float32)
    mat_j, mat_t = JaxNeoHookean(MU, NU, RHO), NeoHookean(MU, NU, RHO)
    jf = jat.assemble_cell_tangents_sym if sym else jat.assemble_cell_tangents
    tf = tat.assemble_cell_tangents_sym if sym else tat.assemble_cell_tangents
    Kj = jf(j["ut"], j["G"], j["w"], mat_j, mass_term=j["mass"],
            precision="bf16emu")
    Kt = tf(t["ut"], t["G"], t["w"], mat_t, mass_term=t["mass"],
            precision="bf16emu")
    Kh = tf(t["ut"], t["G"], t["w"], mat_t, mass_term=t["mass"])
    flat = (lambda K: K) if sym else (lambda K: [b for row in K for b in row])
    for a, b, h in zip(flat(Kj), flat(Kt), flat(Kh)):
        a = np.asarray(a, dtype=np.float64)
        scale = np.abs(a).max()
        assert np.abs(b.numpy() - a).max() <= 2e-4 * scale
        assert np.abs(h.numpy() - a).max() >= 1e-3 * scale


@pytest.mark.parametrize("tier", ["default", "bf16emu"])
def test_reduced_assembly_tiers_warn(tier, monkeypatch, recwarn):
    """Both reduced tiers warn with the JAX package's words where the
    assembled tangent is in use; "highest" does not; the tier reaches the
    assembly."""
    import dealii_adapter_tpu_torch.models.nonlinear_elasticity as tne

    kw = dict(model="neo-Hookean", type_lin="CG", scenario="PF", dim=2,
              poly_degree=2, delta_t=0.01, mu=MU, nu=NU, rho=RHO,
              solve_dtype="float32", preconditioner="Jacobi")
    NonlinearElasticity(params_from_jax(JaxParams(**kw)), device="cpu")
    assert not [w for w in recwarn if "tangent_assembly_precision" in str(w.message)]
    with pytest.warns(UserWarning, match=(
            f"tangent_assembly_precision='{tier}' assembles the Newton "
            "tangent from single-bf16-pass matmuls — measured DIVERGENT")):
        model = NonlinearElasticity(params_from_jax(JaxParams(
            **kw, tangent_assembly_precision=tier)), device="cpu")
    assert model._use_assembled
    seen = []

    def spy(*a, **k):
        seen.append(k.get("precision"))
        return tat.assemble_cell_tangents(*a, **k)

    monkeypatch.setattr(tne, "assemble_cell_tangents", spy)
    assemble_Kt, _ = model._make_tangent_fns()
    assemble_Kt(torch.zeros((model.n_rows, 2), dtype=torch.float32))
    assert seen == [tier]
