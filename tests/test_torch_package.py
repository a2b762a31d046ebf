"""Package-level guarantees of the PyTorch port: it never imports jax, its
models run on the CUDA card unless asked for the CPU, its kernel wrappers
(the five tangent matvecs K1, K1b, K1c, K2, K2b, and K3, K4, K4b, K5, K6)
take the plain version only for CPU tensors, unported variants raise, the
kernel build needs nvcc and binds every entry point, the launch counters
name every wrapper, and chip_smoke.py fails without a GPU. The tests
marked `cuda` compare the kernels with their plain versions (and K6 with
K3 and K4b) on the card; they skip where there is none."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.kernels import _build
from dealii_adapter_tpu_torch.models.linear_elasticity import (
    LinearElastodynamics,
)
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
)
from dealii_adapter_tpu_torch.ops import assembled_tangent as at
from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
from dealii_adapter_tpu_torch.kernels import counters
from dealii_adapter_tpu_torch.mesh.generator import subdivided_hyper_rectangle
from dealii_adapter_tpu_torch.ops.element_ops import ElementMatrices
from dealii_adapter_tpu_torch.ops.q1_structured import (
    Q1PlaneOperator,
    Q1StructuredOperator,
    Q1StructuredOperator2D,
    make_q1_operator,
    make_q1_plane_operator,
)
from dealii_adapter_tpu_torch.ops.q2_structured import Q2StructuredOperator
from dealii_adapter_tpu_torch.ops.stencil import (
    StencilQ1Operator,
    make_q1_stencil_operator,
)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=REPO, timeout=300):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_package_never_imports_jax():
    """Every module of the package (`__main__` runs the CLI, whose module
    is imported here) and chip_smoke.py import neither jax nor the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dealii_adapter_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    if not name.endswith('.__main__'):\n"
        "        importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert 'dealii_adapter_tpu' not in sys.modules\n"
        "print(' '.join(sorted(names)))\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    pkg = "dealii_adapter_tpu_torch."
    assert {pkg + m for m in (
        "ops.stencil", "adapter.adapter", "adapter.participant", "runner",
        "cli", "__main__", "time_handler", "utils.vtk", "utils.timer",
        "utils.postprocessor", "kernels.counters", "parallel.partition",
        "parallel.sharded_ops", "parallel.lattice", "parallel.dryrun")} <= names


def test_precision_policy_is_set():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _small_inputs(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    KT = torch.randn(81, 81, 37, generator=g).to(dtype)
    u2 = torch.randn(81, 37, generator=g).to(dtype)
    lattice = (5, 7, 9)
    E1 = np.random.default_rng(seed).standard_normal((24, 24))
    E2 = np.random.default_rng(seed).standard_normal((81, 81))
    u = torch.randn(int(np.prod(lattice)), 3, generator=g).to(dtype)
    return KT, u2, lattice, E1 + E1.T, E2 + E2.T, u


def _small_inputs_2d(dtype=torch.float32, seed=0):
    """A 2D Q1 lattice (with an odd row count: the ragged last block) and a
    symmetric 8 x 8 element matrix."""
    lattice = (7, 13)
    E = np.random.default_rng(seed).standard_normal((8, 8))
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(int(np.prod(lattice)), 2, generator=g).to(dtype)
    return lattice, E + E.T, u


def _tangent_calls(KT, u2):
    """Every tangent kernel's wrapper and plain version on the layouts
    derived from KT's leading blocks (3D Q2: npc 27)."""
    npc, dim = 27, 3
    Ku = [KT[d * npc:(d + 1) * npc, e * npc:(e + 1) * npc].contiguous()
          for d, e in at.upper_blocks(dim)]
    K = [[None] * dim for _ in range(dim)]
    for (d, e), b in zip(at.upper_blocks(dim), Ku):
        K[d][e], K[e][d] = b, b.transpose(0, 1)
    Kp = at.pack_cell_tangents_sym(Ku)
    return [
        (at.apply_packed_tangents_T, at.apply_packed_tangents_T_plain, (KT, u2)),
        (at.apply_packed_tangents, at.apply_packed_tangents_plain, (KT, u2)),
        (at.apply_block_tangents, at.apply_block_tangents_plain, (K, u2)),
        (at.apply_packed_tangents_sym, at.apply_packed_tangents_sym_plain,
         (Kp, u2, dim, npc)),
        (at.apply_sym_block_tangents, at.apply_sym_block_tangents_plain,
         (Ku, u2, dim, npc)),
    ]


def _to(args, dev):
    """`args` with every tensor (also inside nested lists) moved to `dev`."""
    if isinstance(args, torch.Tensor):
        return args.to(dev)
    if isinstance(args, (list, tuple)):
        return type(args)(_to(a, dev) for a in args)
    return args


def test_cpu_tensors_take_the_plain_path():
    KT, u2, lattice, E1, E2, u = _small_inputs()
    for wrapper, plain, args in _tangent_calls(KT, u2):
        wrapper.launches = 0
        torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0, atol=0)
        assert wrapper.launches == 0
    at.apply_packed_tangents_T.launches = 0
    Q1StructuredOperator.launches = Q2StructuredOperator.launches = 0
    torch.testing.assert_close(
        at.apply_packed_tangents_T(KT, u2), at.apply_packed_tangents_T_plain(KT, u2)
    )
    for cls, E in ((Q1StructuredOperator, E1), (Q2StructuredOperator, E2)):
        op = cls(E, lattice, torch.float32, "cpu")
        torch.testing.assert_close(op(u), op.plain(u), rtol=0, atol=0)
    lattice2, E, u2d = _small_inputs_2d()
    Q1StructuredOperator2D.launches = 0
    op = Q1StructuredOperator2D(E, lattice2, torch.float32, "cpu")
    torch.testing.assert_close(op(u2d), op.plain(u2d), rtol=0, atol=0)
    assert at.apply_packed_tangents_T.launches == 0
    assert Q1StructuredOperator.launches == Q2StructuredOperator.launches == 0
    assert Q1StructuredOperator2D.launches == 0
    Q1PlaneOperator.launches = StencilQ1Operator.launches = 0
    for op, v in ((Q1PlaneOperator(E1, lattice, torch.float32, "cpu"), u),
                  (StencilQ1Operator(E1, lattice, torch.float32, device="cpu"), u),
                  (StencilQ1Operator(E, lattice2, torch.float32, device="cpu"), u2d)):
        torch.testing.assert_close(op(v), op.plain(v), rtol=0, atol=0)
    assert Q1PlaneOperator.launches == StencilQ1Operator.launches == 0


def _level_ops(device):
    """(wrapper, input) of every level and fine kernel that takes the
    bf16-in/f32-out mode: K3, K4, K5, K6 in 3D and 2D, K4b."""
    _, _, lattice, E1, E2, u = _small_inputs()
    lattice2, E, u2d = _small_inputs_2d()
    bf16 = torch.bfloat16
    return [
        (Q1StructuredOperator(E1, lattice, bf16, device), u),
        (Q1PlaneOperator(E1, lattice, bf16, device), u),
        (Q2StructuredOperator(E2, lattice, bf16, device), u),
        (StencilQ1Operator(E1, lattice, bf16, device=device), u),
        (Q1StructuredOperator2D(E, lattice2, bf16, device), u2d),
        (StencilQ1Operator(E, lattice2, bf16, device=device), u2d),
    ]


def test_bf16_in_f32_out_mode_on_the_cpu():
    """`op(u, out_dtype=torch.float32)` on a bf16 u (the lattice
    partition's slabs) returns the plain version's f32 sums unrounded,
    which round to the bf16 output bit for bit; the kernels' I/O modes
    are f32, bf16 and bf16 -> f32 only."""
    for op, u in _level_ops("cpu"):
        x = u.to(torch.bfloat16)
        y = op(x, out_dtype=torch.float32)
        assert y.dtype == torch.float32
        torch.testing.assert_close(y, op.plain(x, torch.float32), rtol=0, atol=0)
        assert torch.equal(y.to(torch.bfloat16), op(x))
        assert not torch.equal(y, y.to(torch.bfloat16).float())
    f32, bf16 = torch.float32, torch.bfloat16
    assert [_build.io_mode(*io) for io in ((f32, f32), (bf16, bf16), (bf16, f32))] \
        == [0, 1, 2]
    with pytest.raises(TypeError):
        _build.io_mode(f32, bf16)


def test_non_cpu_non_cuda_tensors_raise():
    """A tensor that is neither on the CPU nor on a CUDA device never falls
    back to the plain version."""
    KT, u2, lattice, E1, _, u = _small_inputs()
    for wrapper, _, args in _tangent_calls(KT, u2):
        with pytest.raises(ValueError):
            wrapper(*_to(args, "meta"))
    with pytest.raises(ValueError):
        Q1StructuredOperator(E1, lattice, torch.float32, "cpu")(u.to("meta"))
    with pytest.raises(ValueError):
        Q1PlaneOperator(E1, lattice, torch.float32, "cpu")(u.to("meta"))
    with pytest.raises(ValueError):
        StencilQ1Operator(E1, lattice, torch.float32, device="cpu")(u.to("meta"))


def test_launch_counters_name_every_wrapper():
    """`kernels.counters` lists each kernel's wrapper once, and `reset`
    sets every count to 0."""
    objs = counters.counters()
    assert len(objs) == 12 and len({id(o) for o in objs.values()}) == 12
    assert objs["K4 q1_plane"] is Q1PlaneOperator
    assert objs["K6 q1_stencil"] is StencilQ1Operator
    StencilQ1Operator.launches = 3
    counters.reset()
    assert set(counters.launch_counts().values()) == {0}


def test_counts_under_replay_are_the_captured_launches():
    """A CUDA-graph capture hands the launches its wrappers counted to the
    graph (`captured`: the counts go back, since nothing ran) and every
    replay adds them again (`add`)."""
    counters.reset()
    Q1StructuredOperator.launches = 5
    before = counters.launch_counts()
    Q1StructuredOperator.launches += 37  # the wrappers, while capturing
    at.apply_packed_tangents_T.launches += 4
    per_replay = counters.captured(before)
    assert per_replay == {"K3 q1_structured": 37, "K1 tangent_matvec": 4}
    assert counters.launch_counts() == before
    counters.add(per_replay, times=3)
    assert Q1StructuredOperator.launches == 5 + 3 * 37
    assert at.apply_packed_tangents_T.launches == 3 * 4
    counters.reset()


def _two_ranks():
    """This process as rank 0 of 2 (no process group: for checks that
    raise before any collective runs)."""
    from dealii_adapter_tpu_torch.parallel import RankGroup

    return RankGroup(group=None, rank=0, world=2, device=torch.device("cpu"),
                     backend="gloo")


@pytest.mark.parametrize("case", ["mg_cell_partition", "type_lin"])
def test_unported_variants_raise(case):
    """What raises on the Neo-Hookean model, as in the JAX package: MG
    under the cell partition and a dense Direct tangent above its cap
    (ValueError, the JAX package's wording)."""
    kw = dict(model="neo-Hookean", type_lin="CG", scenario="PF", dim=2,
              poly_degree=2, preconditioner="MG", solve_dtype="float32")
    if case == "mg_cell_partition":
        params = AllParameters(**dict(kw, element_backend="gather"))
        with pytest.raises(NotImplementedError,
                           match="MG with the shard_map cell-partition backend"):
            NonlinearElasticity(params, device="cpu", device_mesh=_two_ranks())
    else:
        params = AllParameters(**dict(kw, type_lin="Direct", dim=3, poly_degree=5))
        with pytest.raises(ValueError, match=re.escape(
                "capped at 16384 unknowns. Use type_lin='CG' for this size.")):
            NonlinearElasticity(params, device="cpu")


_MODELS = {
    "linear": (LinearElastodynamics, dict(model="linear", type_lin="CG")),
    "neo-Hookean": (NonlinearElasticity, dict(
        model="neo-Hookean", type_lin="CG", preconditioner="MG",
        solve_dtype="float32")),
}


@pytest.mark.parametrize("model", list(_MODELS))
def test_models_run_on_the_card_unless_asked_for_the_cpu(model):
    """Without `device` a model goes to the CUDA card; on a host without one
    it raises, naming CUDA, instead of falling back to the CPU."""
    cls, kw = _MODELS[model]
    params = AllParameters(scenario="PF", dim=2, poly_degree=2, **kw)
    if torch.cuda.is_available():
        assert cls(params).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(params)
    m = cls(params, device="cpu")
    assert m.device.type == "cpu" and m.initial_state()[0].device.type == "cpu"
    stress = torch.zeros((m.space.n_nodes, 2), dtype=torch.float64)
    state, _ = m.step(m.initial_state(), stress)
    assert state.displacement.device.type == "cpu"


@pytest.mark.parametrize("case", ["mg_cell_partition", "cli_n_devices"])
def test_linear_unported_variants_raise(case, tmp_path):
    """What raises on the linear model: MG under the cell partition (the
    JAX package's message), and the CLI with `--devices 2` outside a
    process group and outside torchrun (RuntimeError, saying how to
    launch)."""
    kw = dict(model="linear", type_lin="CG", scenario="PF", dim=2,
              poly_degree=2)
    if case == "mg_cell_partition":
        params = AllParameters(**kw, preconditioner="MG", element_backend="gather")
        with pytest.raises(NotImplementedError,
                           match="MG with the shard_map cell-partition backend"):
            LinearElastodynamics(params, device="cpu", device_mesh=_two_ranks())
    else:
        from dealii_adapter_tpu_torch import cli

        prm = tmp_path / "case.prm"
        prm.write_text("subsection Finite element system\n"
                       "  set Polynomial degree = 1\nend\n")
        with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
            cli.main([str(prm), "--standalone", "--devices", "2", "--lenient",
                      "--device", "cpu"])


def test_build_binds_every_entry_point():
    """The C entry points of the library: K1, K1b, K1c, K2/K2b, K3, K4, K5,
    the 2D K4b, K6, the C1/C2 health-check kernels, K4's first design and
    the empty kernel of the launch floor, each defined in a source under
    csrc/."""
    names = set(_build._SIGNATURES)
    assert {"dat_tangent_matvec_f32", "dat_tangent_matvec_rows_f32",
            "dat_tangent_matvec_blocks_f32", "dat_tangent_matvec_sym_f32",
            "dat_q1_structured", "dat_q1_plane", "dat_q2_structured",
            "dat_q1_structured_2d", "dat_q1_stencil", "dat_health_scale",
            "dat_health_add_one", "dat_q1_plane_marching",
            "dat_launch_floor"} <= names
    sources = "".join(p.read_text() for p in _build._sources())
    for name in names:
        assert f'extern "C" cudaError_t {name}(' in sources, name


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build" / _build.LIB_NAME).exists()


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: chip_smoke.py would run for real")
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "torch.cuda.is_available() is False" in r.stderr
    # alone, without the package beside it, it fails too
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Run on the card: `python -m pytest -m cuda tests/test_torch_package.py`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    KT, u2, lattice, E1, E2, u = _small_inputs()
    dev = torch.device("cuda")
    for wrapper, plain, args in _tangent_calls(KT.to(dev), u2.to(dev)):
        before = wrapper.launches
        torch.testing.assert_close(wrapper(*args), plain(*args),
                                   rtol=1e-5, atol=1e-4)
        assert wrapper.launches == before + 1
        # a wrong dtype or a tensor on the CPU raises; nothing falls back
        with pytest.raises(TypeError):
            wrapper(*_to(args, torch.float64))
        with pytest.raises(ValueError):
            wrapper(*args[:1], args[1].cpu(), *args[2:])
    # a wrong shape raises; the symmetric kernel names its element limit
    KTd, u2d = KT.to(dev), u2.to(dev)
    with pytest.raises(ValueError):
        at.apply_packed_tangents(KTd, u2d[:-1])
    with pytest.raises(ValueError, match="Q1-Q4"):
        at.apply_sym_block_tangents(
            [KTd[:6, :6].contiguous()] * 6, u2d[:18], 3, 6)
    lattice2, E4, u4 = _small_inputs_2d()
    for cls, E, grid, v in ((Q1StructuredOperator, E1, lattice, u),
                            (Q2StructuredOperator, E2, lattice, u),
                            (Q1StructuredOperator2D, E4, lattice2, u4)):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            op = cls(E, grid, dtype, dev)
            x = v.to(dev, dtype)
            before = cls.launches
            out, ref = op(x).double(), op.plain(x).double()
            assert cls.launches == before + 1
            assert ((out - ref).norm() / ref.norm()).item() <= tol
    # C1/C2 passed when the library was loaded; they stay exact
    assert _build.health["mismatches"] == {"C1": 0, "C2": 0}
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(1)).to(dev)
    assert torch.equal(_build.health_scale(x, 1.5), x * 1.5)
    assert torch.equal(_build.health_add_one(x), x + 1.0)


def _q1_box(reps):
    """A degree-1 box with anisotropic cells and its K + M element
    matrix."""
    dim = len(reps)
    p1 = tuple(0.7 * r for r in reps)
    space = DofSpace.create(subdivided_hyper_rectangle(reps, (0.0,) * dim, p1, 1))
    el = ElementMatrices(space, 1.3, 0.7, 2.1)
    return space, el.K_e + el.M_e


@pytest.mark.cuda
def test_k4_k6_match_plain_on_card():
    """Run on the card: `python -m pytest --noconftest -m cuda
    tests/test_torch_package.py`. K6 (3D and 2D, with lattices of a
    2-node axis) and K4 against their plain versions and against K3 / K4b
    on the same input, bf16 and f32 I/O; f64 I/O and lattices the kernels
    do not take raise. K4 launches K3's kernel with K3's tables, so at
    every 3D level lattice of the main path it equals K3 bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    E = _cell_E(1, (0.7, 0.4, 1.1))
    for lattice in MAIN3D_Q1_LATTICES:
        u = torch.randn(int(np.prod(lattice)), 3,
                        generator=torch.Generator().manual_seed(3))
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x = u.to(dev, dtype)
            k4 = Q1PlaneOperator(E, lattice, dtype, dev)
            before = Q1PlaneOperator.launches
            out = k4(x)
            torch.cuda.synchronize()
            assert Q1PlaneOperator.launches == before + 1
            assert torch.equal(out, Q1StructuredOperator(E, lattice, dtype,
                                                         dev)(x)), lattice
            assert _rel_l2(out, k4.plain(x)) <= tol
    for reps in ((3, 2), (1, 4), (3, 2, 4), (1, 1, 1), (2, 1, 3), (7, 9, 5),
                 (40, 37)):
        space, E = _q1_box(reps)
        dim = len(reps)
        u = torch.randn(space.n_nodes, dim,
                        generator=torch.Generator().manual_seed(2))
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x = u.to(dev, dtype)
            ref = make_q1_operator(space, E, dtype, dev)(x).double()
            ops = [make_q1_stencil_operator(space, E, dtype, device=dev),
                   make_q1_plane_operator(space, E, dtype, dev)]
            for op in ops:
                before = type(op).launches
                out, plain = op(x).double(), op.plain(x).double()
                torch.cuda.synchronize()
                assert type(op).launches == before + 1
                assert ((out - plain).norm() / plain.norm()).item() <= tol
                assert ((out - ref).norm() / ref.norm()).item() <= tol
        with pytest.raises(TypeError):
            make_q1_stencil_operator(space, E, torch.float64, device=dev)(
                u.to(dev, torch.float64))
        with pytest.raises(ValueError):
            make_q1_stencil_operator(space, E, torch.float32, device=dev)(
                u.to(dev)[:-1])


def _cell_E(p, h):
    """K + M element matrix of one degree-p cell of edges h (3D)."""
    m = subdivided_hyper_rectangle((1, 1, 1), (0.0,) * 3, h, p)
    el = ElementMatrices(DofSpace.create(m), 1.3, 0.7, 2.1)
    return el.K_e + el.M_e


# the main path's five Q1 level lattices, ragged small ones (2-node axes,
# partial tiles, nx within one tile of 8, 16 or 32) and the Q2 fine lattice
# with ragged Q2 ones (z beyond one block of 9 cells, partial y/x tiles)
MAIN3D_Q1_LATTICES = ((19, 325, 55), (19, 163, 28), (19, 82, 15), (19, 42, 8),
                      (10, 22, 5))
K3_LATTICES = MAIN3D_Q1_LATTICES + ((2, 2, 2), (2, 5, 3), (3, 2, 9),
                                    (7, 9, 5), (5, 37, 33), (11, 6, 17))
K5_LATTICES = ((19, 325, 55), (3, 3, 3), (5, 7, 9), (21, 11, 9), (3, 19, 13),
               (23, 5, 61))


# K5's bf16 limit (chip_smoke.py's K5_BF16_RTOL): between the sound
# kernel's largest error over these lattices and the smallest of the
# planted fault below (E_lo's MMA dropped), both read on the card
K5_BF16_RTOL = 5e-4


def _rel_l2(out, ref):
    ref = ref.double()
    return ((out.double() - ref).norm() / ref.norm()).item()


@pytest.mark.cuda
def test_k3_k5_match_plain_on_card():
    """Run on the card: `python -m pytest --noconftest -m cuda
    tests/test_torch_package.py`. The redesigned K3 (folded stencil) and
    K5 (tensor cores for bf16 I/O, f32 FMA for f32) against their plain
    versions at the main path's lattices and ragged small ones, bf16 and
    f32 I/O (relative L2 1e-2 and 1e-5: one output rounding, 2^-9, plus
    the summation order, and f32 roundoff over a few hundred terms; K5 in
    bf16 at `K5_BF16_RTOL`, since both outputs round the same f32-accurate
    sums and differ only where a sum lies near a rounding boundary); each
    launch counted once; two launches give the same bits. A planted fault
    shows that K5's bf16 limit holds E's split: with E_lo's fragments
    zeroed, as if its MMA were dropped, K5 errs by E_hi's bf16 rounding
    (2^-9 a coefficient) and fails the limit at every lattice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    for cls, p, lattices in ((Q1StructuredOperator, 1, K3_LATTICES),
                             (Q2StructuredOperator, 2, K5_LATTICES)):
        E = _cell_E(p, (0.004, 0.006, 0.02))
        bf16_tol = K5_BF16_RTOL if p == 2 else 1e-2
        for grid in lattices:
            u = torch.randn(int(np.prod(grid)), 3, generator=g)
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, bf16_tol)):
                op = cls(E, grid, dtype, dev)
                x = u.to(dev, dtype)
                before = cls.launches
                out = op(x)
                again = op(x)
                torch.cuda.synchronize()
                assert cls.launches == before + 2
                assert torch.equal(out, again), (cls.__name__, grid, dtype)
                rel = _rel_l2(out, op.plain(x))
                print(f"{cls.__name__} {grid} {dtype}: rel_l2 {rel:.3e}")
                assert rel <= tol, (cls.__name__, grid, dtype, rel)
                if p == 2 and dtype == torch.bfloat16:
                    faulty = cls(E, grid, dtype, dev)
                    faulty._coef[0][1].zero_()  # E_lo's B fragments
                    fault = _rel_l2(faulty(x), op.plain(x))
                    print(f"  E_lo = 0 (planted fault): rel_l2 {fault:.3e}")
                    assert fault > tol, (grid, fault)
        with pytest.raises(ValueError):
            cls(E, lattices[1], torch.float32, dev)(
                torch.zeros(7, 3, device=dev))


def _slab_shapes(grid, p, world):
    """Every rank's slab lattice of `grid` (degree p) under the lattice
    partition over `world` ranks (`parallel/lattice.py`), and the main
    path's Q2 split as the Q1 levels of 19 planes inherit it."""
    from dealii_adapter_tpu_torch.parallel import RankGroup
    from dealii_adapter_tpu_torch.parallel.lattice import SlabLayout, split_axis

    fine = (19, 325, 55)
    shapes = []
    for r in range(world):
        mesh = RankGroup(None, r, world, torch.device("cpu"), "gloo")
        ax = split_axis(fine, 2, world)
        q2 = SlabLayout(fine, 2, ax, mesh)
        bounds = q2.node_bounds if grid[ax] == fine[ax] else None
        shapes.append(SlabLayout(grid, p, ax, mesh, bounds).slab_shape)
    return shapes


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_k1_k3_k5_on_slabs_match_plain_on_card(world):
    """Run on the card: `python -m pytest --noconftest -m cuda
    tests/test_torch_package.py`. K5, K3 and K1 at the slab shapes the
    lattice partition gives each of `world` ranks on the main path (K5 on
    the Q2 fine lattice (19, 325, 55), K3 on its Q1 levels, K1 at each
    rank's cells) against their plain versions: bf16 in and f32 out, the
    variant the partition runs for the bf16 V-cycle, and f32 I/O,
    relative L2 1e-5 (f32 accumulation; K5's split E is ~2.3e-6
    relative); bf16 I/O at phase 3's limits. A slab is a smaller box with
    fewer, odd plane counts; each launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(world)
    cases = [(Q2StructuredOperator, 2, K5_BF16_RTOL, s)
             for s in _slab_shapes((19, 325, 55), 2, world)]
    cases += [(Q1StructuredOperator, 1, 1e-2, s) for grid in MAIN3D_Q1_LATTICES
              for s in _slab_shapes(grid, 1, world)]
    for cls, p, bf16_tol, grid in cases:
        E = _cell_E(p, (0.004, 0.006, 0.02))
        u = torch.randn(int(np.prod(grid)), 3, generator=g)
        f32, bf16 = torch.float32, torch.bfloat16
        for dtype, out, tol in ((f32, f32, 1e-5), (bf16, f32, 1e-5),
                                (bf16, bf16, bf16_tol)):
            op = cls(E, grid, dtype, dev)
            x = u.to(dev, dtype)
            before = cls.launches
            y = op(x, out_dtype=out)
            assert y.dtype == out and cls.launches == before + 1
            rel = _rel_l2(y, op.plain(x, out))
            print(f"{cls.__name__} slab {grid} {dtype}->{out}: rel_l2 {rel:.3e}")
            assert rel <= tol, (cls.__name__, grid, dtype, out, rel)
    for grid in _slab_shapes((19, 325, 55), 2, world):
        n_cells = int(np.prod([(n - 1) // 2 for n in grid]))
        KT = torch.randn(81, 81, n_cells, generator=g).to(dev)
        u2 = torch.randn(81, n_cells, generator=g).to(dev)
        before = at.apply_packed_tangents_T.launches
        rel = _rel_l2(at.apply_packed_tangents_T(KT, u2),
                      at.apply_packed_tangents_T_plain(KT, u2))
        assert at.apply_packed_tangents_T.launches == before + 1
        print(f"K1 at {n_cells} cells: rel_l2 {rel:.3e}")
        assert rel <= 1e-5, (n_cells, rel)


# the 2D paths' Q1 level lattices (the tutorial flap at scale 48; the bf16
# paths at scale 24 run the same shapes from the second on) and ragged
# ones: 2-node axes, partial tiles, nx within one tile of 8, 16 or 32
K4B_LATTICES = ((1729, 289), (865, 145), (433, 73), (217, 37), (109, 19),
                (55, 10), (2, 2), (3, 2), (2, 9), (7, 5), (2, 33), (5, 17),
                (40, 37), (33, 16), (130, 9), (6, 300))


@pytest.mark.cuda
def test_k4b_matches_plain_on_card():
    """Run on the card: `python -m pytest --noconftest -m cuda
    tests/test_torch_package.py`. The redesigned K4b (the folded 9-point
    stencil, `q1_level_kernel_2d`) against its plain version at every 2D
    level lattice of the paths and at ragged ones, f32 and bf16 I/O
    (relative L2 1e-5 and 1e-2: f32 roundoff over 18 terms a component
    and the folded coefficients rounded once to f32; one output rounding,
    2^-9, plus the order); each launch counted once; two launches give
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(6)
    E = _q1_box((1, 1))[1]
    for grid in K4B_LATTICES:
        u = torch.randn(int(np.prod(grid)), 2, generator=g)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            op = Q1StructuredOperator2D(E, grid, dtype, dev)
            x = u.to(dev, dtype)
            before = Q1StructuredOperator2D.launches
            out = op(x)
            again = op(x)
            torch.cuda.synchronize()
            assert Q1StructuredOperator2D.launches == before + 2
            assert torch.equal(out, again), (grid, dtype)
            rel = _rel_l2(out, op.plain(x))
            print(f"K4b {grid} {dtype}: rel_l2 {rel:.3e}")
            assert rel <= tol, (grid, dtype, rel)


@pytest.mark.cuda
def test_bf16_in_f32_out_mode_on_card():
    """Run on the card: `python -m pytest --noconftest -m cuda
    tests/test_torch_package.py`. The level and fine kernels' bf16-in/f32-out
    mode (the lattice partition's slabs): the f32 output rounds to the
    bf16 mode's output bit for bit (the same accumulation, one store
    apart), is within 1e-5 relative L2 of the plain f32 sums (K5's split E
    is ~2.3e-6 relative), and counts one launch; an f32 input with a bf16
    output raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for op, u in _level_ops(dev):
        x = u.to(dev, torch.bfloat16)
        before = type(op).launches
        y = op(x, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert y.dtype == torch.float32 and type(op).launches == before + 1
        assert torch.equal(y.to(torch.bfloat16), op(x)), type(op).__name__
        rel = _rel_l2(y, op.plain(x, torch.float32))
        print(f"{type(op).__name__} {op.grid_shape} bf16->f32: rel_l2 {rel:.3e}")
        assert rel <= 1e-5, (type(op).__name__, rel)
        with pytest.raises(TypeError):
            op(x.float(), out_dtype=torch.bfloat16)


@pytest.mark.cuda
def test_k6_equals_the_level_kernels_on_card():
    """Run on the card: `python -m pytest --noconftest -m cuda
    tests/test_torch_package.py`. K6 launches the level kernels with the
    same tables: in 3D its output equals K3's bit for bit, in 2D K4b's, on
    the same input (f32 and bf16), each wrapper counting its own launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    for grid in ((19, 325, 55), (19, 42, 8), (2, 5, 3), (1729, 289), (55, 10),
                 (2, 9)):
        dim = len(grid)
        E = _q1_box((1,) * dim)[1]
        u = torch.randn(int(np.prod(grid)), dim, generator=g)
        for dtype in (torch.float32, torch.bfloat16):
            x = u.to(dev, dtype)
            level = (Q1StructuredOperator if dim == 3
                     else Q1StructuredOperator2D)(E, grid, dtype, dev)
            k6 = StencilQ1Operator(E, grid, dtype, device=dev)
            before = (type(level).launches, StencilQ1Operator.launches)
            assert torch.equal(k6(x), level(x)), (grid, dtype)
            torch.cuda.synchronize()
            assert (type(level).launches, StencilQ1Operator.launches) == (
                before[0] + 1, before[1] + 1)


# bench.py's production configuration (the 3D benchmark step)
PRODUCTION_3D = dict(
    model="neo-Hookean", type_lin="CG", scenario="PF", dim=3, poly_degree=2,
    delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0, tol_lin=1e-6, tol_u=1e-6,
    tol_f=1e-9, max_iterations_lin=1.0, dtype="float64",
    preconditioner="MG", precond_dtype="bfloat16", solve_dtype="float32",
    newton_forcing="ew", mg_smooth_degree=3, mg_fine_smooth_degree=1,
    newton_predictor=True, ew_eta0=0.3, max_iterations_NR=10,
)


@pytest.mark.cuda
def test_cg_graphs_equal_the_eager_chunks_on_card(monkeypatch):
    """Run on the card: `python -m pytest --noconftest -m cuda
    tests/test_torch_package.py`. The 3D production model at scale 2 on the
    card (14,235 DoF: K1, and the bf16 V-cycle's K5, K3 on its Q1 level and
    the coarse triangular pair): two steps with the CG in
    CUDA graphs (chunks of 3) give the host loop's `NewtonInfo` and state
    bit for bit; one more solve by graph replay equals the same chunks run
    eagerly on the card and the host loop bit for bit; and the launch
    counts after it are the launches each capture recorded times the
    replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from dealii_adapter_tpu_torch.solvers.cg import ChunkedCG, cg_solve

    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid

    dev = torch.device("cuda")
    params = AllParameters(**PRODUCTION_3D)
    mesh, tags = make_scenario_grid("PF", 3, 2, scale=2, solver="neo-Hookean")
    host = NonlinearElasticity(params, mesh=mesh, tags=tags, device=dev,
                               cg_loop="host")
    lam = [lv.lam_max for lv in host._precond.levels]
    graphs = NonlinearElasticity(params, mesh=mesh, tags=tags, device=dev,
                                 mg_lam_max=lam, cg_chunk=3)
    assert graphs.cg_loop == "graphs"
    stress = torch.zeros((host.space.n_nodes, 3), dtype=torch.float64,
                         device=dev)
    stress[host.space.boundary_nodes[host.interface_id], 0] = 1000.0
    states = [host.initial_state(), graphs.initial_state()]
    for _ in range(2):
        (sh, ih), (sg, ig) = (m.step(st, stress)
                              for m, st in zip((host, graphs), states))
        assert ih.converged and ig == ih
        assert all(torch.equal(a, b) for a, b in zip(sg, sh))
        states = [sh, sg]
    solve = graphs._tangent[1]
    assert isinstance(solve, ChunkedCG) and solve._graphs is not None
    b = graphs.mask_t * torch.randn(
        graphs.space.n_nodes, 3, generator=torch.Generator().manual_seed(4)
    ).to(dev)
    x0 = torch.zeros_like(b)
    tol = 1e-5 * float(torch.linalg.vector_norm(b))
    counters.reset()
    r = solve(b, x0, tol, 1000)
    torch.cuda.synchronize()
    assert r.converged and r.iterations > 3
    (_, per_start), (_, per_chunk) = solve._graphs
    assert per_start["K1 tangent_matvec"] == 1
    assert per_chunk["K1 tangent_matvec"] == 3
    for name in ("K3 q1_structured", "K5 q2_structured"):
        assert per_chunk[name] == 3 * per_start[name] > 0
    launched = {k: n for k, n in counters.launch_counts().items()
                if n and not k.startswith("C")}
    assert launched == {k: per_start.get(k, 0) + r.host_syncs * per_chunk[k]
                        for k in per_chunk}
    eager = ChunkedCG(solve.operator, solve.M, solve.chunk)
    monkeypatch.setattr(eager, "_capture", lambda: None)
    e = eager(b, x0, tol, 1000)
    h = cg_solve(solve.operator, b, x0, tol, 1000, solve.M)
    for other in (e, h):
        assert torch.equal(other.x, r.x)
        assert (other.iterations, other.residual_norm) == (
            r.iterations, r.residual_norm)
    assert eager._graphs is None


@pytest.mark.cuda
def test_jvp_tangent_on_card():
    """Run on the card (see above). The 3D f64 jvp tangent at scale 1
    (2,331 DoF): forward-mode AD drops a detached operand's tangent on
    the card's torch; the operator captured in a CUDA graph equals the
    eager operator bit for bit, and after the linearization point is
    refilled the replay follows it; an f64 multigrid hierarchy raises,
    naming `precond_dtype`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
        NonlinearState,
        forward_jvp,
    )

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, generator=g, dtype=torch.float64).to(dev)
    t = torch.randn(64, generator=g, dtype=torch.float64).to(dev)
    assert torch.equal(forward_jvp(lambda y: 3.0 * y.detach() + y * y, x, t),
                       2.0 * x * t)
    mesh, tags = make_scenario_grid("PF", 3, 2, scale=1, solver="neo-Hookean")
    params = AllParameters(**dict(PRODUCTION_3D, solve_dtype=""))
    model = NonlinearElasticity(params, mesh=mesh, tags=tags, device=dev)
    n = model.space.n_nodes

    def field(scale):
        return scale * torch.randn(n, 3, generator=g, dtype=torch.float64).to(dev)

    state = NonlinearState(model.mask * field(1e-4), field(1e-2), field(1e-2))
    stress = field(1e3)
    refill, K = model._make_jvp_tangent(model.mask * field(1e-4), state, stress)
    v = field(1.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K(v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K(v)
    for _ in range(2):
        graph.replay()
        assert torch.equal(out, K(v))
        refill(model.mask * field(1e-4), state, stress)
    with pytest.raises(ValueError, match="precond_dtype"):
        NonlinearElasticity(AllParameters(**dict(
            PRODUCTION_3D, solve_dtype="", precond_dtype="")),
            mesh=mesh, tags=tags, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [{}, {"tangent_backend": "jvp"}],
                         ids=["assembled", "jvp"])
def test_newton_graphs_replay_as_the_host_loop_on_card(overrides):
    """Run on the card (see above). The 3D production step at scale 1
    (2,331 DoF) with the Newton loop replayed from CUDA graphs
    (`newton_loop="graphs"`) and on the host, on one model and so on the
    same CG graphs, three steps from rest each: the same `NewtonInfo` and
    states bit for bit; the device loop reads back at most its Newton
    iterations + 1 a step outside the CG, and it replays graphs (residuals,
    decisions, update, tangent refill) from its second step on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid

    dev = torch.device("cuda")
    mesh, tags = make_scenario_grid("PF", 3, 2, scale=1, solver="neo-Hookean")
    model = NonlinearElasticity(
        AllParameters(**dict(PRODUCTION_3D, **overrides)), mesh=mesh,
        tags=tags, device=dev)
    assert model.newton_loop == "graphs"
    n = model.space.n_nodes
    stress = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    stress[torch.as_tensor(model.space.boundary_nodes[model.interface_id],
                           device=dev), 0] = 1000.0
    runs = {}
    for loop in ("graphs", "host"):
        model.newton_loop = loop
        state, out = model.initial_state(), []
        for _ in range(3):
            syncs, cg = model.host_syncs, model.cg_host_syncs
            state, info = model.step(state, stress)
            outside = (model.host_syncs - syncs) - (model.cg_host_syncs - cg)
            out.append((info, [t.clone() for t in state], outside))
        runs[loop] = out
    assert len(model._graphs) >= 4
    for (ig, sg, og), (ih, sh, oh) in zip(runs["graphs"], runs["host"]):
        assert ig.converged and ig == ih
        assert all(torch.equal(a, b) for a, b in zip(sg, sh))
        assert og <= ig.iterations + 1 < oh
