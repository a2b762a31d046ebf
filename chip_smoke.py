#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (each prints on its own lines; a failing phase raises and the
script exits non-zero without printing a result):

1. device  — require CUDA; print `nvidia-smi --query-gpu=name,power.limit`.
2. build   — compile the package's CUDA kernels (sm_90a) from csrc/; the
   library's C1/C2 health check (y = x * salt, y = x + 1, compared
   exactly) runs as it loads.
3. kernels — each hand-written kernel against its plain PyTorch version
   on seeded random inputs at the paths' shapes, with CUDA-event times
   (median of 25 applications after warmup) of both and of one PyTorch
   library call computing the same function (`library_ms`: a batched
   matmul for K1, a CSR SpMV of the assembled level matrix for K3, K4b
   and K5), and the least time the card could take (`bound_ms`: bytes at
   3.35 TB/s against f32 operations at 67 TFLOP/s, the larger).
   Limits: relative L2 error <= 1e-5 for f32 output (only the summation
   order differs), <= 1e-2 for bf16 output (one output rounding, 2^-8,
   plus order); C1/C2 exact.
4. main    — `NonlinearElasticity` with the benchmark configuration of
   `bench.py` (3D Neo-Hookean perpendicular flap, Q2, scale 9:
   1,018,875 DoF), traction 1000 in x on the interface, 1 warmup and 3
   timed Newmark steps. Every step must converge and the checksum ||u||^2
   must lie within rtol 1e-4 of the JAX package's 49.05486138743322
   (Newton's tol_u of 1e-6 bounds the spread near 1e-5).
5. linear2d — `LinearElastodynamics` with `bench.py:build_linear_model`'s
   parameters in 2D (the perpendicular flap, Q2, scale 48: 999,362 DoF;
   MG, f32 CG inside f64 refinement) but an f32 multigrid hierarchy
   (`LINEAR_2D`: with bf16 the CG stalls at this size), the same
   traction, 1 warmup and 3 timed theta-steps. Every step's residual must
   be <= 1e-10 (the reference's absolute contract) and ||u||^2 within rtol
   1e-6 of the JAX package's value. Then the recorded golden tip
   trajectory `linear_pf_q2` (20 steps, tests/golden_trajectories.json)
   at rtol 1e-9.
6. nonlinear2d — `NonlinearElasticity` with the configuration of phase 4
   in 2D at scale 48 (999,362 DoF) and, as in phase 5, an f32 hierarchy
   (`NONLINEAR_2D`), same traction and steps; every step
   converged, ||u||^2 within rtol 1e-4 of the JAX package's value.

In phases 4-6 the kernel launch counts are set to 0 after the model is
built and read after its steps; every kernel of the path (C1/C2, whose
check runs again as the path's first kernel call loads the library, and
K1, K3, K4b, K5 as the path uses them) must have launched. `--profile`
adds one step of each path under torch.profiler and prints its
device-time table.

The line before the last is the JSON kernel record; the last line is
`{"ok": true, "device": {...}}`.
"""

import argparse
import json
import math
import statistics
import subprocess
import time

CHECKSUM_REF = 49.05486138743322  # JAX package, BENCH_r05.json tail
CHECKSUM_RTOL = 1e-4
# ||u||^2 after 4 steps of the JAX package on the CPU, same parameters
# (LINEAR_2D, NONLINEAR_2D below) and traction:
#   JAX_PLATFORMS=cpu python tools/jax_reference_2d.py linear --scale 48
LINEAR2D_REF = 4.903851331703004
LINEAR2D_RTOL = 1e-6  # both solves meet the absolute 1e-10 residual
#   JAX_PLATFORMS=cpu python tools/jax_reference_2d.py nonlinear --scale 48
NONLINEAR2D_REF = 72.16762520558771
NONLINEAR2D_RTOL = 1e-4
GOLDEN_RTOL = 1e-9  # tests/test_golden_trajectory.py's linear tolerance
F32_RTOL = 1e-5
BF16_RTOL = 1e-2
SCALE = 9  # 3D main path: 1,018,875 DoF
SCALE_2D = 48  # 2D paths: 999,362 DoF
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores

# bench.py's build_model with its environment defaults (the 3D benchmark
# step), without `dim`
NONLINEAR = dict(
    model="neo-Hookean", type_lin="CG", scenario="PF",
    poly_degree=2, delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0,
    tol_lin=1e-6, tol_u=1e-6, tol_f=1e-9, max_iterations_NR=10,
    max_iterations_lin=1.0, dtype="float64", preconditioner="MG",
    precond_dtype="bfloat16", solve_dtype="float32",
    newton_forcing="ew", mg_smooth_degree=3, mg_fine_smooth_degree=1,
    newton_predictor=True, ew_eta0=0.3, use_pallas=True,
    mg_fine_tangent=False, tangent_assembly_precision="highest",
    tangent_block_symmetric=False, tangent_matvec_kernel="auto",
    newton_tangent_reuse=False, tangent_reuse_after=1,
    tangent_refresh_ratio=0.02, newton_residual_f64_window=30.0,
    use_sumfact=False,
)
# bench.py's build_linear_model with its environment defaults, without `dim`
LINEAR = dict(
    model="linear", type_lin="CG", scenario="PF", poly_degree=2,
    delta_t=0.005, theta=0.5, mu=0.5e6, nu=0.4, rho=1000.0, dtype="float64",
    preconditioner="MG", precond_dtype="bfloat16", solve_dtype="float32",
    mg_smooth_degree=3, mg_fine_smooth_degree=2, use_pallas=True,
)
# The 2D paths run the configurations above with an f32 multigrid
# hierarchy: with the bf16 one the f32 CG on the card stalls at this size
# (2D flap, 999,362 DoF: the linear model's first inner solve stood at
# 1.3e-4 after 2,000 iterations against a tolerance of 9.1e-8; one
# nonlinear step did not finish in 300 s), while the f32 hierarchy takes
# 10 iterations per inner solve (PERF.md, Findings; measured with
# tools/port_cg_by_size.py).
LINEAR_2D = dict(LINEAR, dim=2, precond_dtype="float32")
NONLINEAR_2D = dict(NONLINEAR, dim=2, precond_dtype="float32")
# tests/test_golden_trajectory.py's linear configuration (`linear_pf_q2`)
GOLDEN_LINEAR = dict(
    model="linear", type_lin="CG", scenario="PF", dim=2, poly_degree=2,
    delta_t=0.005, theta=0.5, mu=0.5e6, nu=0.4, rho=1000.0,
    max_iterations_lin=10.0,
)
# which kernels each path must launch
PATH_KERNELS = {
    "main3d": ("C1 health_scale", "C2 health_add_one", "K1 tangent_matvec",
               "K3 q1_structured", "K5 q2_structured"),
    "linear2d": ("C1 health_scale", "C2 health_add_one",
                 "K4b q1_structured_2d"),
    "nonlinear2d": ("C1 health_scale", "C2 health_add_one",
                    "K1 tangent_matvec", "K4b q1_structured_2d"),
}


def log(msg):
    print(msg, flush=True)


def require(cond, what):
    """A check of the run's result (raises; unlike assert, never stripped)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps=25, warmup=3):
    """Median CUDA-event milliseconds of one call of `fn`."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(out, ref):
    d = (out.double() - ref.double())
    max_abs = d.abs().max().item()
    rel = (d.norm() / ref.double().norm()).item()
    return max_abs, rel


def bound(n_bytes, flops):
    """(ms, what bounds it): the least time for moving `n_bytes` once and
    doing `flops` f32 operations on the card."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_work(grid_shape, p, io_bytes):
    """Bytes (u read once, y written once, E) and f32 operations (each
    cell's element matrix applied once) of a structured gather apply."""
    dim = len(grid_shape)
    n_nodes = math.prod(grid_shape)
    n_cells = math.prod((n - 1) // p for n in grid_shape)
    ed = (p + 1) ** dim * dim
    return 2 * n_nodes * dim * io_bytes + ed * ed * 4, 2 * n_cells * ed * ed


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    log(card)
    return card


def phase_build():
    from dealii_adapter_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s, "
        f"one process per source) -> {_build.BUILD_DIR / _build.LIB_NAME}")
    h = _build.health
    require(h is not None and not any(h["mismatches"].values()), f"health {h}")
    log(f"build: C1/C2 health check passed: {h}")


def lattice_E(p, h, lmbda, mu, mass_coeff):
    """Element matrix mu*K + mass_coeff*M of one degree-p cell of edges h
    (2D or 3D)."""
    from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
    from dealii_adapter_tpu_torch.mesh.generator import subdivided_hyper_rectangle
    from dealii_adapter_tpu_torch.ops.element_ops import ElementMatrices

    m = subdivided_hyper_rectangle((1,) * len(h), (0.0,) * len(h), h, p)
    el = ElementMatrices(DofSpace.create(m), lmbda / mu, 1.0, 1.0)
    return mu * el.K_e + mass_coeff * el.M_e


def assembled_csr(E, grid_shape, p, dev):
    """The assembled global matrix of a constant element matrix over a
    lattice of degree-p cells, as an f32 CSR tensor on the card (node-major
    dofs, the layout the kernels read)."""
    import torch

    from dealii_adapter_tpu_torch.ops.structured import extract_cell_patches_T

    dim = len(grid_shape)
    reps = tuple((n - 1) // p for n in grid_shape)
    n_cells = math.prod(reps)
    ids = torch.arange(math.prod(grid_shape), device=dev).reshape(
        tuple(grid_shape) + (1,))
    cell_nodes = extract_cell_patches_T(ids, p, reps)[0].T  # (cells, npc)
    gd = (cell_nodes[:, :, None] * dim
          + torch.arange(dim, device=dev)).reshape(n_cells, -1)
    del cell_nodes, ids
    ed = gd.shape[1]
    idx = torch.stack([gd[:, :, None].expand(-1, ed, ed).reshape(-1),
                       gd[:, None, :].expand(-1, ed, ed).reshape(-1)])
    del gd
    vals = torch.as_tensor(E, dtype=torch.float32, device=dev).expand(
        n_cells, ed, ed).reshape(-1)
    n = math.prod(grid_shape) * dim
    A = torch.sparse_coo_tensor(idx, vals, (n, n)).coalesce()
    del idx, vals
    return A.to_sparse_csr()


def library_spmv_ms(E, grid_shape, p, dev):
    """CUDA-event time of one CSR SpMV (f32) of the assembled matrix."""
    import torch

    A = assembled_csr(E, grid_shape, p, dev)
    x = torch.randn(A.shape[1], 1, device=dev)
    ms = cuda_ms(lambda: A @ x)
    del A, x
    torch.cuda.empty_cache()
    return ms


def check_gather(op, u, limit):
    """One structured-kernel check: error against the plain version,
    kernel and plain times, bound."""
    mx, rel = compare(op(u), op.plain(u))
    b_ms, b_by = bound(*gather_work(op.grid_shape, op.p, u.element_size()))
    chk = dict(
        dtype=str(u.dtype).replace("torch.", ""), max_abs_err=mx,
        rel_l2_err=rel, limit=limit, ms=cuda_ms(lambda: op(u)),
        plain_ms=cuda_ms(lambda: op.plain(u)), bound_ms=b_ms, bound_by=b_by,
    )
    require(rel <= limit, chk)
    return chk


def phase_kernels():
    import numpy as np
    import torch

    from dealii_adapter_tpu_torch.kernels import _build
    from dealii_adapter_tpu_torch.ops import assembled_tangent as at
    from dealii_adapter_tpu_torch.ops.q1_structured import (
        Q1StructuredOperator,
        Q1StructuredOperator2D,
    )
    from dealii_adapter_tpu_torch.ops.q2_structured import Q2StructuredOperator

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, dtype=torch.float32).to(dev, dtype)

    records = []

    # K1: assembled-tangent matvec, f32, at the 3D main path's shape
    # (39,366 Q2 cells, 81 element dofs) and the 2D paths' (124,416 cells,
    # 18 element dofs)
    k1 = []
    for n_cells, edofs in ((27 * 162 * 9, 81), (144 * 864, 18)):
        KT = randn(edofs, edofs, n_cells)
        u2 = randn(edofs, n_cells)
        mx, rel = compare(at.apply_packed_tangents_T(KT, u2),
                          at.apply_packed_tangents_T_plain(KT, u2))
        b_ms, b_by = bound(4 * (edofs * edofs * n_cells + 2 * edofs * n_cells),
                           2 * edofs * edofs * n_cells)
        chk = dict(
            shape=f"KT {edofs}x{edofs}x{n_cells} f32", max_abs_err=mx,
            rel_l2_err=rel, limit=F32_RTOL,
            ms=cuda_ms(lambda: at.apply_packed_tangents_T(KT, u2)),
            plain_ms=cuda_ms(lambda: at.apply_packed_tangents_T_plain(KT, u2)),
            bound_ms=b_ms, bound_by=b_by,
            # one batched product over the cells (PyTorch lays the
            # operands out for it itself)
            library_ms=cuda_ms(lambda: torch.bmm(
                KT.permute(2, 1, 0), u2.T.unsqueeze(-1))),
        )
        log(f"kernel K1 {chk['shape']}: rel_l2 {rel:.3e} max_abs {mx:.3e}  "
            f"{chk['ms']:.4f} ms vs plain {chk['plain_ms']:.4f}, library "
            f"(bmm) {chk['library_ms']:.4f}, bound {b_ms:.4f} ms ({b_by})")
        require(rel <= F32_RTOL, chk)
        k1.append(chk)
        del KT, u2
        torch.cuda.empty_cache()
    records.append(dict(
        name="K1 tangent_matvec", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/tangent_matvec.cu",
        replaces="dealii_adapter_tpu/ops/assembled_tangent.py:510",
        library_call="torch.bmm", **k1[0], other_checks=k1[1:],
    ))

    # K3: 3D Q1 level operator on the FEM-SEM lattice of the main path with
    # the anisotropic E of the first semi-coarsened level (cells
    # 27 x 162 x 18 of the 0.1 x 1.0 x 0.3 flap), bf16 (main path) and f32
    mu, nu, rho, dt, beta = 0.5e6, 0.4, 1000.0, 0.01, 0.25
    kappa = 2 * mu * (1 + nu) / (3 * (1 - 2 * nu))
    lam_eff = kappa - 2.0 * mu / 3
    mass = rho / (beta * dt * dt)
    lattice = (19, 325, 55)
    n_nodes = math.prod(lattice)
    E1 = lattice_E(1, (0.1 / 27, 1.0 / 162, 0.3 / 18), lam_eff, mu, mass)
    checks = []
    for dtype, lim in ((torch.bfloat16, BF16_RTOL), (torch.float32, F32_RTOL)):
        chk = check_gather(Q1StructuredOperator(E1, lattice, dtype, dev),
                           randn(n_nodes, 3, dtype=dtype), lim)
        log(f"kernel K3 {chk['dtype']}: rel_l2 {chk['rel_l2_err']:.3e} max_abs "
            f"{chk['max_abs_err']:.3e}  {chk['ms']:.4f} ms vs plain "
            f"{chk['plain_ms']:.4f}, bound {chk['bound_ms']:.4f} ms "
            f"({chk['bound_by']})")
        checks.append(chk)
    lib = library_spmv_ms(E1, lattice, 1, dev)
    log(f"kernel K3 library (CSR SpMV f32 of the assembled level): {lib:.4f} ms")
    records.append(dict(
        name="K3 q1_structured", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q1_structured.cu",
        replaces="dealii_adapter_tpu/ops/pallas_structured.py:345",
        shape=f"lattice {lattice} x 3, E 24x24", library_ms=lib,
        library_call="CSR SpMV (torch sparse, f32)",
        **checks[0], other_checks=checks[1:],
    ))

    # K4b: 2D Q1 level operator on the FEM-SEM lattice of the 2D paths
    # (the Q2 node lattice of the 144 x 864-cell flap) with the anisotropic
    # E of the first semi-coarsened 2D level (cells 144 x 864 of the
    # 0.1 x 1.0 flap), with the linear model's coefficients
    c = (0.5 * 0.005) ** 2
    lam = 2 * mu * nu / (1 - 2 * nu)
    lattice2 = (1729, 289)
    E4 = lattice_E(1, (0.1 / 144, 1.0 / 864), c * lam, c * mu, rho)
    checks = []
    for dtype, lim in ((torch.bfloat16, BF16_RTOL), (torch.float32, F32_RTOL)):
        chk = check_gather(Q1StructuredOperator2D(E4, lattice2, dtype, dev),
                           randn(math.prod(lattice2), 2, dtype=dtype), lim)
        log(f"kernel K4b {chk['dtype']}: rel_l2 {chk['rel_l2_err']:.3e} max_abs "
            f"{chk['max_abs_err']:.3e}  {chk['ms']:.4f} ms vs plain "
            f"{chk['plain_ms']:.4f}, bound {chk['bound_ms']:.4f} ms "
            f"({chk['bound_by']})")
        checks.append(chk)
    lib = library_spmv_ms(E4, lattice2, 1, dev)
    log(f"kernel K4b library (CSR SpMV f32 of the assembled level): {lib:.4f} ms")
    records.append(dict(
        name="K4b q1_structured_2d", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q1_structured.cu",
        replaces="dealii_adapter_tpu/ops/pallas_structured.py:488",
        shape=f"lattice {lattice2} x 2, E 8x8", library_ms=lib,
        library_call="CSR SpMV (torch sparse, f32)",
        **checks[0], other_checks=checks[1:],
    ))

    # K5: 3D Q2 fine proxy, bf16, with the small-strain proxy element matrix
    E2 = lattice_E(2, (0.1 / 27, 1.0 / 162, 0.3 / 9), lam_eff, mu, mass)
    chk = check_gather(Q2StructuredOperator(E2, lattice, torch.bfloat16, dev),
                       randn(n_nodes, 3, dtype=torch.bfloat16), BF16_RTOL)
    lib = library_spmv_ms(E2, lattice, 2, dev)
    log(f"kernel K5 bf16: rel_l2 {chk['rel_l2_err']:.3e} max_abs "
        f"{chk['max_abs_err']:.3e}  {chk['ms']:.4f} ms vs plain "
        f"{chk['plain_ms']:.4f}, library (CSR SpMV f32) {lib:.4f}, bound "
        f"{chk['bound_ms']:.4f} ms ({chk['bound_by']})")
    records.append(dict(
        name="K5 q2_structured", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q2_structured.cu",
        replaces="dealii_adapter_tpu/ops/pallas_phase.py:121",
        shape=f"lattice {lattice} x 3, E 81x81", library_ms=lib,
        library_call="CSR SpMV (torch sparse, f32)", **chk,
    ))

    # C1/C2: the health-check kernels at their 8 x 128 f32 block (exact)
    x = randn(8, 128)
    salt = 1.0 + 37.0 / 1024.0
    b_ms, b_by = bound(2 * x.numel() * 4, x.numel())
    for name, replaces, fn, plain in (
        ("C1 health_scale", "dealii_adapter_tpu/utils/tunecache.py:136",
         lambda: _build.health_scale(x, salt), lambda: x * salt),
        ("C2 health_add_one", "dealii_adapter_tpu/utils/tunecache.py:414",
         lambda: _build.health_add_one(x), lambda: x + 1.0),
    ):
        mx, _ = compare(fn(), plain())
        rec = dict(
            name=name, route="cuda",
            source="dealii_adapter_tpu_torch/csrc/health.cu", replaces=replaces,
            shape="(8, 128) f32", max_abs_err=mx, limit=0.0,
            ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=b_ms,
            bound_by=b_by, library_ms=None,
        )
        log(f"kernel {name}: max_abs {mx!r}  {rec['ms']:.4f} ms vs plain "
            f"{rec['plain_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        require(mx == 0.0, rec)
        records.append(rec)
    return records


def counters():
    from dealii_adapter_tpu_torch.kernels import _build
    from dealii_adapter_tpu_torch.ops import assembled_tangent as at
    from dealii_adapter_tpu_torch.ops.q1_structured import (
        Q1StructuredOperator,
        Q1StructuredOperator2D,
    )
    from dealii_adapter_tpu_torch.ops.q2_structured import Q2StructuredOperator

    return {
        "C1 health_scale": _build.health_scale,
        "C2 health_add_one": _build.health_add_one,
        "K1 tangent_matvec": at.apply_packed_tangents_T,
        "K3 q1_structured": Q1StructuredOperator,
        "K4b q1_structured_2d": Q1StructuredOperator2D,
        "K5 q2_structured": Q2StructuredOperator,
    }


def start_counts():
    """Forget the bound library (the path's first kernel call loads it again
    and runs the C1/C2 check) and set every launch count to 0."""
    from dealii_adapter_tpu_torch.kernels import _build

    _build.unload()
    for obj in counters().values():
        obj.launches = 0


def read_counts(path):
    launches = {k: obj.launches for k, obj in counters().items()}
    missing = [k for k in PATH_KERNELS[path] if launches[k] <= 0]
    require(not missing, f"{path}: kernels launched on the path: missing {missing}")
    return launches


def build_model(device, dim=3, scale=None):
    """`NonlinearElasticity` on the port: the benchmark configuration of
    bench.py's build_model (its environment defaults) in 3D, `NONLINEAR_2D`
    in 2D."""
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
        NonlinearElasticity,
    )

    mesh, tags = make_scenario_grid(
        "PF", dim, 2, scale=SCALE if scale is None else scale,
        solver="neo-Hookean",
    )
    params = NONLINEAR_2D if dim == 2 else dict(NONLINEAR, dim=dim)
    return NonlinearElasticity(AllParameters(**params), mesh=mesh, tags=tags,
                               device=device)


def build_linear_model(device, scale=None):
    """`LinearElastodynamics` with `LINEAR_2D` on the 2D flap, on the
    port."""
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.linear_elasticity import (
        LinearElastodynamics,
    )

    mesh, tags = make_scenario_grid(
        "PF", 2, 2, scale=SCALE_2D if scale is None else scale, solver="linear",
    )
    return LinearElastodynamics(AllParameters(**LINEAR_2D), mesh=mesh,
                                tags=tags, device=device)


def interface_traction(model, magnitude=1000.0):
    import torch

    dim = model.space.dim
    s = torch.zeros((model.space.n_nodes, dim), dtype=torch.float64,
                    device=model.device)
    iface = torch.as_tensor(model.space.boundary_nodes[model.interface_id],
                            device=model.device)
    s[iface, 0] = magnitude
    return s


def describe(tag, model, t_build):
    levels = model._precond.levels
    log(f"{tag}: model built in {t_build:.1f} s, {model.space.n_dofs} DoF, "
        f"{len(levels)} MG levels {[lv.grid_shape for lv in levels]}, lam_max "
        f"{[round(lv.lam_max, 6) for lv in levels]}")


def run_steps(tag, model, stress, fmt):
    """1 warmup + 3 timed steps from rest; returns (state, infos, times,
    checksum)."""
    import torch

    state = model.initial_state()
    infos, times = [], []
    for i in range(4):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        u = state.displacement
        checksum = torch.dot(u.reshape(-1), u.reshape(-1)).item()
        times.append(time.perf_counter() - ts)
        infos.append(info)
        log(f"{tag}: step {i} ({'warmup' if i == 0 else 'timed'}) "
            f"{times[-1]:.4f} s: {fmt(info)}")
    u = state.displacement
    require(tuple(u.shape) == (model.space.n_nodes, model.space.dim),
            f"{tag}: shape {tuple(u.shape)}")
    require(bool(torch.isfinite(u).all()), f"{tag}: non-finite displacement")
    timed = times[1:]
    log(f"{tag}: timed steps {timed} s; mean {statistics.mean(timed):.4f} "
        f"s/step, {model.space.n_dofs / 1e6 * len(timed) / sum(timed):.4f} "
        f"MDoF*steps/s; host syncs {model.host_syncs} over 4 steps; max_u "
        f"{u.abs().max().item()!r} checksum {checksum!r}")
    return state, infos, times, checksum


def check_checksum(tag, checksum, ref, rtol):
    rel = abs(checksum - ref) / ref
    log(f"{tag}: checksum {checksum!r} rel. difference to the JAX package's "
        f"{ref!r}: {rel:.3e} (limit {rtol})")
    require(rel <= rtol, f"{tag}: checksum {checksum!r} vs {ref!r}")


def profile_step(tag, model, state, stress):
    """One more step under torch.profiler: device-time table and busy share
    of the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        ts = time.perf_counter()
        model.step(state, stress)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
    ka = p.key_averages()
    # kernels only: the aten ops that launched them carry the same time
    dev_us = sum(
        e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA
    )
    log(ka.table(sort_by="self_device_time_total", row_limit=30))
    log(f"{tag} profile: step wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{dev_us / 1e3:.1f} ms = {dev_us / 1e4 / wall:.1f}% of the wall")


def newton_fmt(info):
    return (f"newton {info.iterations} cg {info.cg_iterations} f64 "
            f"{info.f64_evals} f32 {info.f32_evals} asm "
            f"{info.tangent_assemblies} converged {info.converged}")


def phase_main(profile):
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(dev)
    torch.cuda.synchronize()
    describe("main", model, time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    stress = interface_traction(model)
    start_counts()
    state, infos, _, checksum = run_steps("main", model, stress, newton_fmt)
    launches = read_counts("main3d")
    log(f"main: launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last step "
        f"min_det_F {infos[-1].min_det_F!r}")
    require(all(i.converged for i in infos), "every step converged")
    check_checksum("main", checksum, CHECKSUM_REF, CHECKSUM_RTOL)
    if profile:
        profile_step("main", model, state, stress)
    return launches


def golden_linear_pf_q2(dev):
    """20 steps of the golden linear configuration; the tip's x
    displacement against `linear_pf_q2`."""
    import pathlib

    import numpy as np

    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.models.linear_elasticity import (
        LinearElastodynamics,
    )

    path = pathlib.Path(__file__).resolve().parent / "tests" / "golden_trajectories.json"
    golden = json.loads(path.read_text())["linear_pf_q2"]
    model = LinearElastodynamics(AllParameters(**GOLDEN_LINEAR), device=dev)
    nodes = model.space.mesh.nodes
    target = np.zeros(2)
    target[1] = nodes[:, 1].max()
    tip = int(np.argmin(((nodes - target) ** 2).sum(axis=1)))
    stress = interface_traction(model)
    state, traj = model.initial_state(), []
    for _ in range(len(golden)):
        state, info = model.step(state, stress)
        require(info.residual <= 1e-10, f"golden: residual {info.residual}")
        traj.append(float(state.displacement[tip, 0]))
    rel = float(np.max(np.abs(np.subtract(traj, golden)) / np.abs(golden)))
    log(f"linear2d: golden linear_pf_q2 ({len(golden)} steps, "
        f"{model.space.n_dofs} DoF): max rel. difference {rel:.3e} (limit "
        f"{GOLDEN_RTOL}); tip {traj[-1]!r} vs {golden[-1]!r}")
    require(rel <= GOLDEN_RTOL, "golden linear_pf_q2 trajectory")


def phase_linear2d(profile):
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_linear_model(dev)
    torch.cuda.synchronize()
    describe("linear2d", model, time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    stress = interface_traction(model)
    start_counts()
    state, infos, _, checksum = run_steps(
        "linear2d", model, stress,
        lambda i: f"cg {i.iterations} residual {i.residual!r} "
                  f"linf_velocity {i.linf_velocity!r}",
    )
    launches = read_counts("linear2d")
    log(f"linear2d: launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(all(i.residual <= 1e-10 for i in infos),
            "every step's residual <= 1e-10")
    check_checksum("linear2d", checksum, LINEAR2D_REF, LINEAR2D_RTOL)
    if profile:
        profile_step("linear2d", model, state, stress)
    del model, state
    golden_linear_pf_q2(dev)
    return launches


def phase_nonlinear2d(profile):
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(dev, dim=2, scale=SCALE_2D)
    torch.cuda.synchronize()
    describe("nonlinear2d", model, time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    stress = interface_traction(model)
    start_counts()
    state, infos, _, checksum = run_steps("nonlinear2d", model, stress,
                                          newton_fmt)
    launches = read_counts("nonlinear2d")
    log(f"nonlinear2d: launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(all(i.converged for i in infos), "every step converged")
    check_checksum("nonlinear2d", checksum, NONLINEAR2D_REF, NONLINEAR2D_RTOL)
    if profile:
        profile_step("nonlinear2d", model, state, stress)
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step of each path after its checks")
    args = ap.parse_args()

    import torch

    phase_device()
    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)

    phase_build()
    records = phase_kernels()
    by_path = {
        "main3d": phase_main(args.profile),
        "linear2d": phase_linear2d(args.profile),
        "nonlinear2d": phase_nonlinear2d(args.profile),
    }
    for rec in records:
        per_path = {p: n[rec["name"]] for p, n in by_path.items()
                    if rec["name"] in PATH_KERNELS[p]}
        rec["launches"] = sum(per_path.values())
        rec["launches_by_path"] = per_path
        for k, v in list(rec.items()):
            if isinstance(v, float) and not math.isfinite(v):
                raise RuntimeError(f"non-finite {k} in {rec['name']}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
