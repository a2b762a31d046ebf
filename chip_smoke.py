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
   matmul over the full materialized tangent for K1, K1b, K1c, K2 and K2b
   (no single call consumes the upper-block layout of K2/K2b), a CSR SpMV
   of the assembled level matrix for K3, K4b and K5, the elementwise
   `x * salt` and `x + 1` for C1/C2), and the least time the card could
   take (`bound_ms`: the bytes of the stored operands read once and the
   output written once at 3.35 TB/s against f32 operations at 67 TFLOP/s,
   the larger).
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
   (`LINEAR_2D`: with bf16 the CG takes ~20x the iterations), the same
   traction, 1 warmup and 3 timed theta-steps. Every step's residual must
   be <= 1e-10 (the reference's absolute contract) and ||u||^2 within rtol
   1e-6 of the JAX package's value. Then the recorded golden tip
   trajectory `linear_pf_q2` (20 steps, tests/golden_trajectories.json)
   at rtol 1e-9.
6. nonlinear2d — `NonlinearElasticity` with the configuration of phase 4
   in 2D at scale 48 (999,362 DoF) and, as in phase 5, an f32 hierarchy
   (`NONLINEAR_2D`), same traction and steps; every step
   converged, ||u||^2 within rtol 1e-4 of the JAX package's value.

7. tangent3d — phase 4's configuration and mesh, once for each tangent
   storage and matvec kernel pair (`tangent_block_symmetric`,
   `tangent_matvec_kernel`) in (False, packed) -> K1b, (False, blocks) ->
   K1c, (True, auto) -> K2, (True, blocks) -> K2b, with phase 4's lam_max
   values, 1 warmup and 3 timed steps each: every step converged, ||u||^2
   within rtol 1e-4 of the JAX package's value; prints per-step times, CG
   and Newton counts, peak device memory and the checksum's difference
   from phase 4's (the K1 path).
8. vcycle_bf16 — the 2D linear model of phase 5 at scale 24 (250,850 DoF)
   with the bf16 multigrid hierarchy, step 0 with each inner CG capped at
   `VCYCLE_BF16_CAP`: its CG count must be at most 1.25x the JAX
   package's on the CPU (`VCYCLE_BF16_REF`), residual <= 1e-10.

In phases 4-8 the kernel launch counts are set to 0 after the model is
built and read after its steps; every kernel of the path (C1/C2, whose
check runs again as the path's first kernel call loads the library, and
K1, K1b, K1c, K2, K2b, K3, K4b, K5 as the path uses them) must have
launched. `--profile` adds one step of each of phases 4-6 under
torch.profiler and prints its device-time table.

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
# CG iterations of the linear model's step 0 with the bf16 hierarchy at
# scale 24 (LINEAR_2D with precond_dtype="bfloat16"), JAX package on the CPU:
#   JAX_PLATFORMS=cpu python tools/jax_reference_2d.py linear --scale 24 \
#       --steps 1 --precond-dtype bfloat16
VCYCLE_BF16_REF = 160
VCYCLE_BF16_RATIO = 1.25
VCYCLE_BF16_SCALE = 24
VCYCLE_BF16_CAP = 2000  # per inner solve, so that a stall ends the phase
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
# hierarchy: with the bf16 one the CG takes far more iterations at this
# size (2D flap, 999,362 DoF: 788 in the linear model's first step, as
# the JAX package's 823, and ~2,800 in the Neo-Hookean one, against 40
# and 33 with f32; PERF.md, Findings; measured with
# tools/port_cg_by_size.py).
LINEAR_2D = dict(LINEAR, dim=2, precond_dtype="float32")
NONLINEAR_2D = dict(NONLINEAR, dim=2, precond_dtype="float32")
# tests/test_golden_trajectory.py's linear configuration (`linear_pf_q2`)
GOLDEN_LINEAR = dict(
    model="linear", type_lin="CG", scenario="PF", dim=2, poly_degree=2,
    delta_t=0.005, theta=0.5, mu=0.5e6, nu=0.4, rho=1000.0,
    max_iterations_lin=10.0,
)
# (cells, nodes per cell, dim) of the tangent kernels' checks: the 3D main
# path's Q2 cells and the 2D paths'
TANGENT_SHAPES = ((27 * 162 * 9, 27, 3), (144 * 864, 9, 2))
# the tangent3d variants: (tangent_block_symmetric, tangent_matvec_kernel)
# and the kernel each runs in place of K1
TANGENT_VARIANTS = (
    (False, "packed", "K1b tangent_matvec_rows"),
    (False, "blocks", "K1c tangent_matvec_blocks"),
    (True, "auto", "K2 tangent_matvec_sym"),
    (True, "blocks", "K2b tangent_matvec_sym_blocks"),
)
_HEALTH = ("C1 health_scale", "C2 health_add_one")
_MG3D = ("K3 q1_structured", "K5 q2_structured")
# which kernels each path must launch
PATH_KERNELS = {
    "main3d": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
    **{f"tangent3d {sym} {kind}": _HEALTH + (kern,) + _MG3D
       for sym, kind, kern in TANGENT_VARIANTS},
    "linear2d": _HEALTH + ("K4b q1_structured_2d",),
    "nonlinear2d": _HEALTH + ("K1 tangent_matvec", "K4b q1_structured_2d"),
    "vcycle_bf16": _HEALTH + ("K4b q1_structured_2d",),
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


def tangent_check(name, shape, fn, plain, stored_bytes, edofs, n_cells,
                  K_rows, u2):
    """One tangent-kernel check: error against the plain version, kernel
    and plain times, bound (the stored blocks, u and out moved once) and
    the batched product over the full row-major tangent `K_rows`."""
    import torch

    mx, rel = compare(fn(), plain())
    b_ms, b_by = bound(stored_bytes + 2 * 4 * edofs * n_cells,
                       2 * edofs * edofs * n_cells)
    chk = dict(
        shape=shape, max_abs_err=mx, rel_l2_err=rel, limit=F32_RTOL,
        ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
        # one batched product over the cells (PyTorch lays the operands out
        # for it itself)
        library_ms=cuda_ms(lambda: torch.bmm(K_rows.permute(2, 0, 1),
                                             u2.T.unsqueeze(-1))),
    )
    log(f"kernel {name} {shape}: rel_l2 {rel:.3e} max_abs {mx:.3e}  "
        f"{chk['ms']:.4f} ms vs plain {chk['plain_ms']:.4f}, library (bmm) "
        f"{chk['library_ms']:.4f}, bound {b_ms:.4f} ms ({b_by})")
    require(rel <= F32_RTOL, chk)
    return chk


def tangent_kernel_records(randn, dev):
    """K1, K1b, K1c, K2 and K2b, f32, at the 3D main path's shape (39,366
    Q2 cells, npc 27, 81 element dofs) and the 2D paths' (124,416 cells,
    npc 9, 18 element dofs). K1's inputs come from `randn`; the others'
    from their own seeded generator: random upper blocks, the lower ones
    their transposed views, as the assembly gives them."""
    import torch

    from dealii_adapter_tpu_torch.ops import assembled_tangent as at

    g2 = torch.Generator(device="cpu").manual_seed(4321)

    def randn2(*shape):
        return torch.randn(*shape, generator=g2).to(dev)

    checks = {name: [] for name in (
        "K1 tangent_matvec", "K1b tangent_matvec_rows",
        "K1c tangent_matvec_blocks", "K2 tangent_matvec_sym",
        "K2b tangent_matvec_sym_blocks")}
    for n_cells, npc, dim in TANGENT_SHAPES:
        edofs = dim * npc
        full = 4 * edofs * edofs * n_cells
        KT = randn(edofs, edofs, n_cells)
        u2 = randn(edofs, n_cells)
        checks["K1 tangent_matvec"].append(tangent_check(
            "K1", f"KT {edofs}x{edofs}x{n_cells} f32",
            lambda: at.apply_packed_tangents_T(KT, u2),
            lambda: at.apply_packed_tangents_T_plain(KT, u2),
            full, edofs, n_cells, KT.transpose(0, 1), u2))
        del KT
        u2 = randn2(edofs, n_cells)
        Ku = [randn2(npc, npc, n_cells) for _ in at.upper_blocks(dim)]
        K = [[None] * dim for _ in range(dim)]
        for (d, e), b in zip(at.upper_blocks(dim), Ku):
            K[d][e], K[e][d] = b, b.transpose(0, 1)
        K_rows = at.pack_cell_tangents(K)
        Kpack = at.pack_cell_tangents_sym(Ku)
        sym = 4 * len(Ku) * npc * npc * n_cells
        for name, shape, fn, plain, stored in (
            ("K1b tangent_matvec_rows", f"K {edofs}x{edofs}x{n_cells} f32",
             lambda: at.apply_packed_tangents(K_rows, u2),
             lambda: at.apply_packed_tangents_plain(K_rows, u2), full),
            ("K1c tangent_matvec_blocks",
             f"{dim}x{dim} blocks {npc}x{npc}x{n_cells} f32",
             lambda: at.apply_block_tangents(K, u2),
             lambda: at.apply_block_tangents_plain(K, u2), full),
            ("K2 tangent_matvec_sym",
             f"Kpack {len(Ku) * npc}x{npc}x{n_cells} f32",
             lambda: at.apply_packed_tangents_sym(Kpack, u2, dim, npc),
             lambda: at.apply_packed_tangents_sym_plain(Kpack, u2, dim, npc),
             sym),
            ("K2b tangent_matvec_sym_blocks",
             f"{len(Ku)} blocks {npc}x{npc}x{n_cells} f32",
             lambda: at.apply_sym_block_tangents(Ku, u2, dim, npc),
             lambda: at.apply_sym_block_tangents_plain(Ku, u2, dim, npc), sym),
        ):
            checks[name].append(tangent_check(
                name.split()[0], shape, fn, plain, stored, edofs, n_cells,
                K_rows, u2))
        del u2, Ku, K, K_rows, Kpack
        torch.cuda.empty_cache()
    meta = {
        "K1 tangent_matvec": ("tangent_matvec.cu", 510),
        "K1b tangent_matvec_rows": ("tangent_matvec.cu", 552),
        "K1c tangent_matvec_blocks": ("tangent_matvec.cu", 597),
        "K2 tangent_matvec_sym": ("tangent_matvec_sym.cu", 445),
        "K2b tangent_matvec_sym_blocks": ("tangent_matvec_sym.cu", 644),
    }
    return [
        dict(name=name, route="cuda",
             source=f"dealii_adapter_tpu_torch/csrc/{meta[name][0]}",
             replaces=f"dealii_adapter_tpu/ops/assembled_tangent.py:{meta[name][1]}",
             library_call="torch.bmm over the full (E, E, C) tangent"
             + ("; no single call consumes the upper-block layout"
                if name.startswith("K2") else ""),
             **c3d, other_checks=[c2d])
        for name, (c3d, c2d) in checks.items()
    ]


def phase_kernels():
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

    records += tangent_kernel_records(randn, dev)

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
    for name, replaces, fn, plain, library_call in (
        ("C1 health_scale", "dealii_adapter_tpu/utils/tunecache.py:136",
         lambda: _build.health_scale(x, salt), lambda: x * salt, "x * salt"),
        ("C2 health_add_one", "dealii_adapter_tpu/utils/tunecache.py:414",
         lambda: _build.health_add_one(x), lambda: x + 1.0, "x + 1"),
    ):
        mx, _ = compare(fn(), plain())
        rec = dict(
            name=name, route="cuda",
            source="dealii_adapter_tpu_torch/csrc/health.cu", replaces=replaces,
            shape="(8, 128) f32", max_abs_err=mx, limit=0.0,
            ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=b_ms,
            bound_by=b_by,
            # the same one elementwise PyTorch call, timed on its own
            library_ms=cuda_ms(plain), library_call=library_call,
        )
        log(f"kernel {name}: max_abs {mx!r}  {rec['ms']:.4f} ms vs plain "
            f"{rec['plain_ms']:.4f} ms, library ({library_call}) "
            f"{rec['library_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
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
        "K1b tangent_matvec_rows": at.apply_packed_tangents,
        "K1c tangent_matvec_blocks": at.apply_block_tangents,
        "K2 tangent_matvec_sym": at.apply_packed_tangents_sym,
        "K2b tangent_matvec_sym_blocks": at.apply_sym_block_tangents,
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


def build_model(device, dim=3, scale=None, mesh_tags=None, mg_lam_max=None,
                **overrides):
    """`NonlinearElasticity` on the port: the benchmark configuration of
    bench.py's build_model (its environment defaults) in 3D, `NONLINEAR_2D`
    in 2D, with `overrides`; `mesh_tags` reuses a mesh (and the multigrid
    geometry cached on it), `mg_lam_max` a hierarchy's lam_max values."""
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
        NonlinearElasticity,
    )

    mesh, tags = mesh_tags or make_scenario_grid(
        "PF", dim, 2, scale=SCALE if scale is None else scale,
        solver="neo-Hookean",
    )
    params = NONLINEAR_2D if dim == 2 else dict(NONLINEAR, dim=dim)
    return NonlinearElasticity(AllParameters(**dict(params, **overrides)),
                               mesh=mesh, tags=tags, device=device,
                               mg_lam_max=mg_lam_max)


def build_linear_model(device, scale=None, **overrides):
    """`LinearElastodynamics` with `LINEAR_2D` and `overrides` on the 2D
    flap, on the port."""
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.linear_elasticity import (
        LinearElastodynamics,
    )

    mesh, tags = make_scenario_grid(
        "PF", 2, 2, scale=SCALE_2D if scale is None else scale, solver="linear",
    )
    return LinearElastodynamics(AllParameters(**dict(LINEAR_2D, **overrides)),
                                mesh=mesh, tags=tags, device=device)


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
    return launches, dict(
        mesh_tags=(model.mesh, model.tags), checksum=checksum,
        lam_max=[lv.lam_max for lv in model._precond.levels],
    )


def phase_tangent3d(main):
    """The main configuration with each tangent storage and kernel of
    `TANGENT_VARIANTS`, on the main path's mesh and lam_max values; returns
    {path: launches}."""
    import torch

    from dealii_adapter_tpu_torch.ops.assembled_tangent import tangent_bytes

    dev = torch.device("cuda")
    by_path = {}
    for sym, kind, kern in TANGENT_VARIANTS:
        tag = f"tangent3d {sym} {kind}"
        t0 = time.perf_counter()
        model = build_model(
            dev, mesh_tags=main["mesh_tags"], mg_lam_max=main["lam_max"],
            tangent_block_symmetric=sym, tangent_matvec_kernel=kind,
        )
        torch.cuda.synchronize()
        log(f"{tag}: model built in {time.perf_counter() - t0:.1f} s, kernel "
            f"{model.tangent_kernel}, stored tangent "
            f"{tangent_bytes(model.space, torch.float32, sym=sym) / 1e9:.3f} GB")
        require(kern.startswith(model.tangent_kernel + " "),
                f"{tag}: kernel {model.tangent_kernel}, expected {kern}")
        torch.cuda.reset_peak_memory_stats()
        stress = interface_traction(model)
        start_counts()
        _, infos, _, checksum = run_steps(tag, model, stress, newton_fmt)
        by_path[tag] = read_counts(tag)
        log(f"{tag}: launches {by_path[tag]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; checksum "
            f"rel. difference to the K1 path's: "
            f"{abs(checksum - main['checksum']) / main['checksum']:.3e}")
        require(all(i.converged for i in infos), f"{tag}: every step converged")
        check_checksum(tag, checksum, CHECKSUM_REF, CHECKSUM_RTOL)
        del model
        torch.cuda.empty_cache()
    return by_path


def phase_vcycle_bf16():
    """Step 0 of the 2D linear model at `VCYCLE_BF16_SCALE` with the bf16
    hierarchy: CG iterations against the JAX package's on the CPU."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_linear_model(dev, scale=VCYCLE_BF16_SCALE,
                               precond_dtype="bfloat16")
    torch.cuda.synchronize()
    describe("vcycle_bf16", model, time.perf_counter() - t0)
    model._max_cg_iter = VCYCLE_BF16_CAP
    stress = interface_traction(model)
    start_counts()
    torch.cuda.synchronize()
    ts = time.perf_counter()
    _, info = model.step(model.initial_state(), stress)
    torch.cuda.synchronize()
    launches = read_counts("vcycle_bf16")
    limit = VCYCLE_BF16_RATIO * VCYCLE_BF16_REF
    log(f"vcycle_bf16: step 0 at {model.space.n_dofs} DoF in "
        f"{time.perf_counter() - ts:.4f} s: cg {info.iterations} (JAX package "
        f"on the CPU: {VCYCLE_BF16_REF}; limit {limit:g}), residual "
        f"{info.residual!r}; launches {launches}")
    require(info.residual <= 1e-10, f"vcycle_bf16: residual {info.residual}")
    require(info.iterations <= limit,
            f"vcycle_bf16: {info.iterations} CG > {limit:g}")
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
    by_path = {}
    by_path["main3d"], main_run = phase_main(args.profile)
    by_path.update(phase_tangent3d(main_run))
    del main_run
    by_path["linear2d"] = phase_linear2d(args.profile)
    by_path["nonlinear2d"] = phase_nonlinear2d(args.profile)
    by_path["vcycle_bf16"] = phase_vcycle_bf16()
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
