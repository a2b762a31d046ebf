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
   on seeded random inputs at the paths' shapes, with the kernel's device
   time (`ms`: torch.profiler's CUDA time over 20 launches after 30 ms of
   back-to-back launches, each kernel's mean duration: `device_ms`, also
   used by the level tables; `graph_ms` beside it for the Q1/Q2 operators:
   CUDA events around replays of a CUDA graph of 20 calls), its
   time per call from the host (`call_ms`: CUDA events around one call,
   median of 15 after warmup, the launch cost included), the same
   per-call time of the plain version, and the device time of one
   PyTorch library call computing the same function (`library_ms`: a batched
   matmul over the full materialized tangent for K1, K1b, K1c, K2 and K2b
   (no single call consumes the upper-block layout of K2/K2b), a CSR SpMV
   of the assembled level matrix for K3, K4, K4b, K5 and K6, the elementwise
   `x * salt` and `x + 1` for C1/C2), and the least time the card could
   take (`bound_ms`: the bytes of the stored operands read once and the
   output written once at 3.35 TB/s against f32 operations at 67 TFLOP/s,
   the larger; the Q1 operators K3, K4, K4b and K6 all at the assembled
   stencil's count, 243 FMA per node in 3D and 36 in 2D; beside it the
   launch floor, the device time of an empty kernel (`launch_floor_ms`),
   and `bound_with_floor_ms`, the larger of the two).
   Limits: relative L2 error <= 1e-5 for f32 output (only the summation
   order differs), <= 1e-2 for bf16 output (one output rounding, 2^-8,
   plus order), K5's bf16 output <= 5e-4 (`K5_BF16_RTOL`, set on the card
   between the sound kernel's error and a planted fault's); C1/C2 exact.
   K4 and K6 are also held against K3's output on the same input (K6 in 2D
   against K4b's) with the same limits, and both must equal K3 (K4b in 2D)
   bit for bit: they launch the same kernel with the same tables. K3, K4,
   K4b, K5 and K6 (redesigned) are also timed in turns (old, new, new, old)
   against their first design on the same input (`old_design`: the gather
   kernels of K3, K4b and K5, K4's plane-marching kernel, K6's pointwise
   kernel); K5's bf16 bound is
   its tensor-core design's (bf16 products at 989 TFLOP/s against the
   bytes), with the f32-FMA bound beside it.
4. main    — `NonlinearElasticity` with the benchmark configuration of
   `bench.py` (3D Neo-Hookean perpendicular flap, Q2, scale 9:
   1,018,875 DoF), traction 1000 in x on the interface, 1 warmup and 3
   timed Newmark steps, with the CG in CUDA graphs (`cg_loop="graphs"`,
   the default on the card), then the same with the host loop
   (`cg_loop="host"`, path `main3d host`), then 3 more timed steps of
   each in the reverse order (host loop, graphs), both models on the card.
   Every step must converge and the checksum ||u||^2 after step 3 must
   lie within rtol 1e-4 of the JAX package's 49.05486138743322 (Newton's
   tol_u of 1e-6 bounds the spread near 1e-5); the two loops must take
   the same CG and Newton counts in every step and their checksums after
   steps 3 and 6 agree within 1e-12 relative (`LOOPS_RTOL`). For each
   loop: every step's time (unrounded), host syncs and kernel launches,
   the peak device memory of its first 4 steps (the other model's bytes
   left out), and, after all timed steps, the device busy share of one
   more step under torch.profiler tracing the card only (`--profile`
   prints its kernel table).
5. linear2d — `LinearElastodynamics` with `bench.py:build_linear_model`'s
   parameters in 2D (the perpendicular flap, Q2, scale 48: 999,362 DoF;
   MG, f32 CG inside f64 refinement) but an f32 multigrid hierarchy
   (`LINEAR_2D`: with bf16 the CG takes ~20x the iterations), the same
   traction, 1 warmup and 3 timed theta-steps. Every step's residual must
   be <= 1e-10 (the reference's absolute contract) and ||u||^2 within rtol
   1e-6 of the JAX package's value. Then the recorded golden tip
   trajectory `linear_pf_q2` (20 steps, tests/golden_trajectories.json)
   at rtol 1e-9. Then the 2D level table (`level_table_2d`): at every 2D Q1
   level lattice of the model's hierarchy, with that level's element
   matrix, in f32 and bf16, K4b against its gather design and K6 against
   its pointwise design, each pair in turns, K4b and K6 bitwise equal and
   within the limits of the plain version; per-call times, the bound and
   the CSR SpMV library time.
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
8. vcycle_bf16 — the 2D linear model of phase 5 and the 2D Neo-Hookean
   model of phase 6 at scale 24 (250,850 DoF) with the bf16 multigrid
   hierarchy, step 0 with each CG capped at `VCYCLE_BF16_CAP`: each CG
   count (over the Newton iterations for the Neo-Hookean step) must be at
   most 1.25x the JAX package's on the CPU (`VCYCLE_BF16_REF`,
   `VCYCLE_BF16_NL_REF`); linear residual <= 1e-10, Neo-Hookean converged.
9. stencil3d — phase 4's configuration with `mg_level_backend=
   "stencil_vmem"` (every 3D Q1 level on the assembled stencil, K6) on
   phase 4's mesh and lam_max values, 1 warmup and 3 timed steps: every
   step converged, ||u||^2 within rtol 1e-4 of the JAX package's; K6, K5,
   K1 and C1/C2 launched and K3 not at all. Then the level table: at every
   3D Q1 level shape of the hierarchy, with that level's element matrix
   (bf16, the hierarchy's dtype), K3 against its first (gather) design,
   K6 against its first (pointwise) design and K6 against K3, each pair
   timed in turns, K6 bitwise equal to K3; per-call times, the bound and
   the CSR SpMV library time.
10. coupled3d — `runner.coupled_run` on phase 9's model through the
   port's `Adapter` and a `FakeParticipant` (window 0.01, end time 0.04, a
   constant read field (1000, 0, 0) — `interface_traction`'s load —,
   two implicit iterations per window, so 4 windows of 2 steps with a
   rollback between): ||u||^2 within rtol 1e-10 of phase 9's 4-step
   checksum; per-window write-history norms and times; one VTU of the last
   window written to a temporary directory (size, write time).
11. cli — `python -m dealii_adapter_tpu_torch` in a subprocess on a small
   2D linear case (`CLI_PRM`: Q1, refined 4 times, 28,322 DoF, MG in f32
   with f32 CG), 2 windows: exit code 0, a banner naming the card, both
   VTU files written; its closing `kernel launches` line gives the path's
   counts.

Every path but `main3d host` runs its CG in CUDA graphs; a graph replay
adds the launches its capture recorded to the counts (`kernels/
counters.py`), so the counts are device launches, the masked iterations
of each solve's last chunk included.
In phases 4-11 the kernel launch counts are set to 0 after the model is
built (for `cli`: in its own process) and read after its steps; every
kernel of the path (C1/C2, whose check runs again as the library is
bound anew at the path's start, and K1, K1b, K1c, K2, K2b, K3, K4b, K5, K6
as the path uses them) must have launched. K4 (the 3D Q1 operator of
`make_q1_plane_operator`) is on no path, as in the JAX package; phase 3
checks and times it beside K3. `--profile` prints the kernel device-time
table of phase 4's profiled steps and adds one profiled step to each of
phases 5 and 6.

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
# the same for the Neo-Hookean model (NONLINEAR_2D with the bf16
# hierarchy): CG over step 0's Newton iterations, and those iterations
#   JAX_PLATFORMS=cpu python tools/jax_reference_2d.py nonlinear \
#       --scale 24 --steps 1 --precond-dtype bfloat16
VCYCLE_BF16_NL_REF = 200
VCYCLE_BF16_NL_NEWTON = 5
VCYCLE_BF16_RATIO = 1.25
VCYCLE_BF16_SCALE = 24
VCYCLE_BF16_CAP = 2000  # per inner solve, so that a stall ends the phase
F32_RTOL = 1e-5
BF16_RTOL = 1e-2
# K5 in bf16: both outputs round f32-accurate sums (E split into E_hi +
# E_lo), so they differ only where a sum lies near a rounding boundary;
# the limit lies between the sound kernel's largest error and that of a
# planted fault, E_lo's MMA dropped (tests/test_torch_package.py)
K5_BF16_RTOL = 5e-4
SCALE = 9  # 3D main path: 1,018,875 DoF
SCALE_2D = 48  # 2D paths: 999,362 DoF
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores

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
_STENCIL3D = _HEALTH + ("K1 tangent_matvec", "K5 q2_structured", "K6 q1_stencil")
# which kernels each path must launch
PATH_KERNELS = {
    "main3d": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
    "main3d host": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
    **{f"tangent3d {sym} {kind}": _HEALTH + (kern,) + _MG3D
       for sym, kind, kern in TANGENT_VARIANTS},
    "linear2d": _HEALTH + ("K4b q1_structured_2d",),
    "nonlinear2d": _HEALTH + ("K1 tangent_matvec", "K4b q1_structured_2d"),
    "vcycle_bf16": _HEALTH + ("K4b q1_structured_2d",),
    "vcycle_bf16 nonlinear": _HEALTH + ("K1 tangent_matvec",
                                        "K4b q1_structured_2d"),
    "stencil3d": _STENCIL3D,
    "coupled3d": _STENCIL3D,
    "cli": _HEALTH + ("K4b q1_structured_2d",),
}
# kernels a path must NOT launch: the stencil paths replace K3 with K6
PATH_EXCLUDES = {"stencil3d": ("K3 q1_structured",),
                 "coupled3d": ("K3 q1_structured",)}
# the coupled3d phase: window, end time, implicit iterations per window
COUPLED_WINDOW, COUPLED_END, COUPLED_ITERATIONS = 0.01, 0.04, 2
COUPLED_RTOL = 1e-10  # against stencil3d's checksum: the same 4 steps
# main3d's checksum under CUDA graphs against the host loop's: the same
# kernels on the same inputs, so they should agree bit for bit
LOOPS_RTOL = 1e-12
# the cli phase: tests/test_cli.py's case, refined so that the multigrid
# hierarchy has a Q1 level above its coarse solve (MG in f32, f32 CG)
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
  set Model = linear
  set Solver type = CG
end
subsection Discretization
  set Polynomial degree = 1
end
subsection precice configuration
  set Scenario = PF
end
subsection TPU
  set Preconditioner = MG
  set Solve dtype = float32
  set Preconditioner dtype = float32
end
"""
CLI_REFINE = 4


def log(msg):
    print(msg, flush=True)


def require(cond, what):
    """A check of the run's result (raises; unlike assert, never stripped)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps=15, warmup=3):
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


def device_ms(fn, reps=20, warmup_s=0.03):
    """Mean device time in ms of the kernels one call of `fn` launches,
    from torch.profiler's CUDA activity: the kernel's own duration,
    without the host's launch cost (which `cuda_ms` includes). The
    profiled `reps` calls follow `warmup_s` seconds of back-to-back calls,
    so that the card's clocks and L2 are in the state the paths run in.
    A session may miss some kernels (seen on the H100: a kernel recorded
    fewer than `reps` times), so the time per call is each kernel's mean
    duration times the times a call launches it (its count over `reps`,
    rounded, at least 1), not the session's total over `reps`; kernels
    missed are counted in `MISSED_KERNELS`. Every device time of the
    kernel record and of the level tables is taken this way; where three
    sessions in a row record nothing (seen on the H100 late in a run),
    the time is `graph_ms`'s instead, counted in `GRAPH_FALLBACKS`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count > 0]
        us = sum(e.self_device_time_total for e in kernels)
        if us <= 0:
            continue
        per_call = 0.0
        for e in kernels:
            launches = max(1, round(e.count / reps))
            per_call += e.self_device_time_total / e.count * launches
            MISSED_KERNELS[0] += max(0, launches * reps - e.count)
        return per_call / 1e3
    GRAPH_FALLBACKS[0] += 1
    return graph_ms(fn, reps)


def graph_ms(fn, reps=20, replays=5):
    """Device time in ms of one call of `fn` from CUDA events around
    replays of a CUDA graph that holds `reps` calls, so that no host
    launch cost lies between the kernels (the wrappers launch on the
    current stream, allocate with `torch.empty` and never synchronise,
    so they can be captured)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (replays * reps)


MISSED_KERNELS = [0]  # kernels the profiled sessions did not record
GRAPH_FALLBACKS = [0]  # device times taken by `graph_ms` instead


def in_turns(old, new):
    """Device times of two implementations of one function, taken in turns
    old, new, new, old in one process on one card (the fair comparison):
    (old mean, new mean, [the four times])."""
    t = [device_ms(old), device_ms(new), device_ms(new), device_ms(old)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def first_design(op, entry):
    """A call of the first design of K3, K4, K4b, K5 or K6, `entry` in the
    kernel library, on `op`'s lattice: the gather kernels
    (`dat_q*_structured*_gather`) and K4's plane-marching kernel
    (`dat_q1_plane_marching`) with the element matrix, K6's pointwise
    kernel (`dat_q1_stencil_pointwise`) with the unpadded f32 class
    tables. The old kernel is timed in turns with the new one. Not a
    wrapper: it counts nothing."""
    import torch

    from dealii_adapter_tpu_torch.kernels import _build

    fn = getattr(_build.load_library(), entry)
    if entry == "dat_q1_stencil_pointwise":
        coef = torch.as_tensor(op.class_tables, dtype=torch.float32,
                               device=op.device).contiguous()
        nz = op.grid_shape[0] if op.ndim == 3 else 1
        lattice = (nz, *op.grid_shape[-2:], op.ndim)
    else:
        coef, lattice = op.E_dev, op.grid_shape

    def run(u):
        y = torch.empty_like(u)
        _build.check(fn(u.data_ptr(), y.data_ptr(), coef.data_ptr(),
                        *lattice, int(u.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream), entry)
        return y

    return run


def launch_floor_ms():
    """(device time, CUDA-graph time) in ms of one launch of an empty
    kernel of one block (`dat_launch_floor`, csrc/health.cu): the card's
    floor for any launch, the third term of the bounds in PERF.md. Not a
    wrapper: it counts nothing."""
    import torch

    from dealii_adapter_tpu_torch.kernels import _build

    fn = _build.load_library().dat_launch_floor

    def run():
        _build.check(fn(torch.cuda.current_stream().cuda_stream),
                     "dat_launch_floor")

    return device_ms(run), graph_ms(run)


def sm_clock():
    """The card's SM clock now, as nvidia-smi reads it (MHz)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip()


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


def operator_work(grid_shape, p, io_bytes):
    """Bytes and f32 operations that a structured operator apply needs.
    Q1 (K3, K4, K4b, K6): the assembled stencil's, 3^dim neighbours x dim^2
    FMA per node (fewer than each cell's element matrix applied once).
    Q2 (K5): u read once, y written once, E, and each cell's element matrix
    applied once."""
    if p == 1:
        return stencil_work(grid_shape, io_bytes)
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
    for src, report in sorted((_build.ptxas_report or {}).items()):
        for line in report.splitlines():  # -Xptxas -v: per kernel
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"build: ptxas {src}: {line.strip()}")


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
    """Device time of one CSR SpMV (f32) of the assembled matrix."""
    import torch

    A = assembled_csr(E, grid_shape, p, dev)
    x = torch.randn(A.shape[1], 1, device=dev)
    ms = device_ms(lambda: A @ x)
    del A, x
    torch.cuda.empty_cache()
    return ms


def check_gather(op, u, limit, ref_op=None):
    """One structured-kernel check: error against the plain version (and
    against `ref_op`, another kernel of the same function, on the same
    input), kernel and plain times, bound (`operator_work`)."""
    import torch

    out = op(u)
    mx, rel = compare(out, op.plain(u))
    b_ms, b_by = bound(*operator_work(op.grid_shape, op.p, u.element_size()))
    chk = dict(
        dtype=str(u.dtype).replace("torch.", ""), max_abs_err=mx,
        rel_l2_err=rel, limit=limit, ms=device_ms(lambda: op(u)),
        graph_ms=graph_ms(lambda: op(u)),
        call_ms=cuda_ms(lambda: op(u)), plain_ms=cuda_ms(lambda: op.plain(u)),
        bound_ms=b_ms, bound_by=b_by,
    )
    chk["share_of_bound"] = b_ms / chk["ms"]
    if ref_op is not None:
        ref_out = ref_op(u)
        chk["rel_l2_vs_ref_kernel"] = compare(out, ref_out)[1]
        chk["equal_to_ref_kernel"] = bool(torch.equal(out, ref_out))
    require(rel <= limit and chk.get("rel_l2_vs_ref_kernel", 0.0) <= limit, chk)
    return chk


def old_design(op, u, limit, entry):
    """The first design of K3, K4, K4b, K5 or K6 (`first_design`) on the same
    operator and input: its error against the plain version, and both
    designs' device times taken in turns (`in_turns`)."""
    old, new = first_design(op, entry), (lambda: op(u))
    mx, rel = compare(old(u), op.plain(u))
    require(rel <= limit, f"{entry}: rel_l2 {rel}")
    old_ms, new_ms, turns = in_turns(lambda: old(u), new)
    return dict(entry=entry, rel_l2_err=rel, max_abs_err=mx, ms=old_ms,
                new_ms_in_turns=new_ms, turns_old_new_new_old=turns)


def fmt_old(o):
    return (f"old design {o['ms']:.4f} ms vs new {o['new_ms_in_turns']:.4f} "
            f"in turns {[round(t, 4) for t in o['turns_old_new_new_old']]}")


def stencil_work(grid_shape, io_bytes):
    """Bytes (u read once, y written once, the class tables) and f32
    operations (3^dim neighbours x dim^2 FMA per node: 243 in 3D, 36 in
    2D) of one assembled-stencil apply."""
    dim = len(grid_shape)
    n_nodes = math.prod(grid_shape)
    n_off = 3**dim
    return (2 * n_nodes * dim * io_bytes + 4 * n_off * n_off * dim * dim,
            2 * n_nodes * n_off * dim * dim)


def q1_level_records(randn, dev, E1, lattice, E4, lattice2, lib3, lib2):
    """K4 (3D) and K6 (3D and 2D) on the paths' Q1 level shapes, each held
    against its plain version and against K3 / K4b on the same input
    (bitwise: the same kernel and tables), each also timed in turns
    against its first design (K4 plane marching, K6 pointwise);
    `lib3`/`lib2` are the CSR SpMV times of the same level matrices."""
    import torch

    from dealii_adapter_tpu_torch.ops.q1_structured import (
        Q1PlaneOperator,
        Q1StructuredOperator,
        Q1StructuredOperator2D,
    )
    from dealii_adapter_tpu_torch.ops.stencil import StencilQ1Operator

    records = []
    k4, k6, k6_2d = [], [], []
    for dtype, lim in ((torch.bfloat16, BF16_RTOL), (torch.float32, F32_RTOL)):
        u = randn(math.prod(lattice), 3, dtype=dtype)
        k3 = Q1StructuredOperator(E1, lattice, dtype, dev)
        op = Q1PlaneOperator(E1, lattice, dtype, dev)
        chk = check_gather(op, u, lim, ref_op=k3)
        require(chk["equal_to_ref_kernel"],
                f"K4 {lattice} {dtype}: not bitwise K3's output")
        chk["old_design"] = old_design(op, u, lim, "dat_q1_plane_marching")
        k4.append(chk)
        for checks, lat, E, v, ref in (
                (k6, lattice, E1, u, k3),
                (k6_2d, lattice2, E4,
                 randn(math.prod(lattice2), 2, dtype=dtype),
                 Q1StructuredOperator2D(E4, lattice2, dtype, dev))):
            op = StencilQ1Operator(E, lat, dtype, device=dev)
            chk = check_gather(op, v, lim, ref)
            require(chk["equal_to_ref_kernel"],
                    f"K6 {lat} {dtype}: not bitwise K3's / K4b's output")
            chk["old_design"] = old_design(op, v, lim,
                                           "dat_q1_stencil_pointwise")
            checks.append(chk)
        k6_2d[-1]["shape"] = f"lattice {lattice2} x 2, 9-point"
        k6_2d[-1]["library_ms"] = lib2
    for name, checks in (("K4", k4), ("K6 3D", k6), ("K6 2D", k6_2d)):
        for c in checks:
            log(f"kernel {name} {c['dtype']}: rel_l2 {c['rel_l2_err']:.3e} "
                f"(vs K3/K4b {c['rel_l2_vs_ref_kernel']:.3e}, bitwise "
                f"{c['equal_to_ref_kernel']}) max_abs "
                f"{c['max_abs_err']:.3e}  {c['ms']:.4f} ms (per call {c['call_ms']:.4f}) vs plain "
                f"{c['plain_ms']:.4f}, bound {c['bound_ms']:.4f} ms "
                f"({c['bound_by']}, {c['share_of_bound']:.1%} of it)"
                + (f"; {fmt_old(c['old_design'])}" if "old_design" in c else ""))
    records.append(dict(
        name="K4 q1_plane", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q1_structured.cu",
        replaces="dealii_adapter_tpu/ops/pallas_structured.py:445",
        shape=f"lattice {lattice} x 3, 27-point (K3's kernel)",
        library_ms=lib3,
        library_call="CSR SpMV (torch sparse, f32)",
        **k4[0], other_checks=k4[1:],
    ))
    records.append(dict(
        name="K6 q1_stencil", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q1_stencil.cu",
        replaces="dealii_adapter_tpu/ops/stencil.py:244",
        shape=f"lattice {lattice} x 3, 27-point", library_ms=lib3,
        library_call="CSR SpMV (torch sparse, f32)",
        **k6[0], other_checks=k6[1:] + k6_2d,
    ))
    return records


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
        ms=device_ms(fn), call_ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
        bound_ms=b_ms, bound_by=b_by,
        # one batched product over the cells (PyTorch lays the operands out
        # for it itself)
        library_ms=device_ms(lambda: torch.bmm(K_rows.permute(2, 0, 1),
                                             u2.T.unsqueeze(-1))),
    )
    log(f"kernel {name} {shape}: rel_l2 {rel:.3e} max_abs {mx:.3e}  "
        f"{chk['ms']:.4f} ms (per call {chk['call_ms']:.4f}) vs plain {chk['plain_ms']:.4f}, library (bmm) "
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
    log(f"kernels: SM clock {sm_clock()} before K3")
    checks = []
    for dtype, lim in ((torch.bfloat16, BF16_RTOL), (torch.float32, F32_RTOL)):
        op = Q1StructuredOperator(E1, lattice, dtype, dev)
        u = randn(n_nodes, 3, dtype=dtype)
        chk = check_gather(op, u, lim)
        chk["old_design"] = old_design(op, u, lim, "dat_q1_structured_gather")
        log(f"kernel K3 {chk['dtype']}: rel_l2 {chk['rel_l2_err']:.3e} max_abs "
            f"{chk['max_abs_err']:.3e}  {chk['ms']:.4f} ms (per call {chk['call_ms']:.4f}) vs plain "
            f"{chk['plain_ms']:.4f}, bound {chk['bound_ms']:.4f} ms "
            f"({chk['bound_by']}); {fmt_old(chk['old_design'])}")
        checks.append(chk)
    lib3 = library_spmv_ms(E1, lattice, 1, dev)
    log(f"kernel K3 library (CSR SpMV f32 of the assembled level): {lib3:.4f} ms")
    records.append(dict(
        name="K3 q1_structured", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q1_structured.cu",
        replaces="dealii_adapter_tpu/ops/pallas_structured.py:345",
        shape=f"lattice {lattice} x 3, E 24x24", library_ms=lib3,
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
        op = Q1StructuredOperator2D(E4, lattice2, dtype, dev)
        u2 = randn(math.prod(lattice2), 2, dtype=dtype)
        chk = check_gather(op, u2, lim)
        chk["old_design"] = old_design(op, u2, lim,
                                       "dat_q1_structured_2d_gather")
        log(f"kernel K4b {chk['dtype']}: rel_l2 {chk['rel_l2_err']:.3e} max_abs "
            f"{chk['max_abs_err']:.3e}  {chk['ms']:.4f} ms (per call {chk['call_ms']:.4f}) vs plain "
            f"{chk['plain_ms']:.4f}, bound {chk['bound_ms']:.4f} ms "
            f"({chk['bound_by']}); {fmt_old(chk['old_design'])}")
        checks.append(chk)
    lib2 = library_spmv_ms(E4, lattice2, 1, dev)
    log(f"kernel K4b library (CSR SpMV f32 of the assembled level): {lib2:.4f} ms")
    records.append(dict(
        name="K4b q1_structured_2d", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q1_structured.cu",
        replaces="dealii_adapter_tpu/ops/pallas_structured.py:488",
        shape=f"lattice {lattice2} x 2, 9-point", library_ms=lib2,
        library_call="CSR SpMV (torch sparse, f32)",
        **checks[0], other_checks=checks[1:],
    ))

    # K4 and K6 at the same 3D level shape and element matrix as K3, K6
    # also at K4b's 2D shape
    records += q1_level_records(randn, dev, E1, lattice, E4, lattice2, lib3,
                                lib2)

    # K5: 3D Q2 fine proxy with the small-strain proxy element matrix, bf16
    # (every 3D path) on the tensor cores and f32 in f32 FMA
    E2 = lattice_E(2, (0.1 / 27, 1.0 / 162, 0.3 / 9), lam_eff, mu, mass)
    log(f"kernels: SM clock {sm_clock()} before K5")
    checks = []
    for dtype, lim in ((torch.bfloat16, K5_BF16_RTOL), (torch.float32, F32_RTOL)):
        op = Q2StructuredOperator(E2, lattice, dtype, dev)
        u = randn(n_nodes, 3, dtype=dtype)
        chk = check_gather(op, u, lim)
        chk["old_design"] = old_design(op, u, lim, "dat_q2_structured_gather")
        if dtype == torch.bfloat16:
            # the tensor-core design's bound: bf16 products at 989 TFLOP/s
            # (E_hi and E_lo: two per element-matrix entry and cell) against
            # the bytes; the f32-FMA bound stays beside it
            n_bytes, flops = operator_work(lattice, 2, 2)
            chk["bound_f32_fma_ms"] = chk["bound_ms"]
            t_tc = 2 * flops / BF16_TC_FLOPS * 1e3
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            chk["bound_ms"], chk["bound_by"] = (
                (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations"))
        log(f"kernel K5 {chk['dtype']}: rel_l2 {chk['rel_l2_err']:.3e} max_abs "
            f"{chk['max_abs_err']:.3e}  {chk['ms']:.4f} ms (per call "
            f"{chk['call_ms']:.4f}) vs plain {chk['plain_ms']:.4f}, bound "
            f"{chk['bound_ms']:.4f} ms ({chk['bound_by']}); "
            f"{fmt_old(chk['old_design'])}")
        checks.append(chk)
    lib = library_spmv_ms(E2, lattice, 2, dev)
    log(f"kernel K5 library (CSR SpMV f32 of the assembled fine operator): "
        f"{lib:.4f} ms")
    records.append(dict(
        name="K5 q2_structured", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q2_structured.cu",
        replaces="dealii_adapter_tpu/ops/pallas_phase.py:121",
        shape=f"lattice {lattice} x 3, E 81x81", library_ms=lib,
        library_call="CSR SpMV (torch sparse, f32)",
        **checks[0], other_checks=checks[1:],
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
            ms=device_ms(fn), call_ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
            bound_ms=b_ms,
            bound_by=b_by,
            # the same one elementwise PyTorch call, timed on its own
            library_ms=device_ms(plain), library_call=library_call,
        )
        log(f"kernel {name}: max_abs {mx!r}  {rec['ms']:.4f} ms (per call {rec['call_ms']:.4f}) vs plain "
            f"{rec['plain_ms']:.4f} ms, library ({library_call}) "
            f"{rec['library_ms']:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        require(mx == 0.0, rec)
        records.append(rec)

    # the launch floor: no kernel takes less than an empty one
    floor, floor_graph = launch_floor_ms()
    log(f"kernels: launch floor (an empty kernel): {floor:.4f} ms device "
        f"time, {floor_graph:.4f} ms per launch in a CUDA graph")
    for rec in records:
        for c in [rec] + rec.get("other_checks", []):
            c["floor_ms"] = floor
            c["bound_with_floor_ms"] = max(c["bound_ms"], floor)
    return records


def start_counts():
    """Set every launch count to 0 and bind the library again, which runs
    the C1/C2 check, so that every path counts it (a path that only replays
    CUDA graphs calls no wrapper that would bind it)."""
    from dealii_adapter_tpu_torch.kernels import _build, counters

    counters.reset()
    _build.unload()
    _build.load_library()


def read_counts(path, launches=None):
    """The launch counts of `path` (this process's, unless given); every
    kernel of the path must have launched, and none it excludes."""
    from dealii_adapter_tpu_torch.kernels import counters

    if launches is None:
        launches = counters.launch_counts()
    missing = [k for k in PATH_KERNELS[path] if launches.get(k, 0) <= 0]
    require(not missing, f"{path}: kernels launched on the path: missing {missing}")
    extra = [k for k in PATH_EXCLUDES.get(path, ()) if launches.get(k, 0)]
    require(not extra, f"{path}: launched {extra}, which the path replaces")
    return launches


def build_model(device, dim=3, scale=None, mesh_tags=None, mg_lam_max=None,
                cg_loop=None, cg_chunk=None, **overrides):
    """`NonlinearElasticity` on the port: the benchmark configuration of
    bench.py's build_model (its environment defaults) in 3D, `NONLINEAR_2D`
    in 2D, with `overrides`; `mesh_tags` reuses a mesh (and the multigrid
    geometry cached on it), `mg_lam_max` a hierarchy's lam_max values;
    `cg_loop` and `cg_chunk`, when given, the model's Krylov loop."""
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
    loop = {k: v for k, v in (("cg_loop", cg_loop), ("cg_chunk", cg_chunk))
            if v is not None}
    return NonlinearElasticity(AllParameters(**dict(params, **overrides)),
                               mesh=mesh, tags=tags, device=device,
                               mg_lam_max=mg_lam_max, **loop)


def build_linear_model(device, scale=None, cg_loop=None, **overrides):
    """`LinearElastodynamics` with `LINEAR_2D` and `overrides` on the 2D
    flap, on the port (`cg_loop`, when given, its Krylov loop)."""
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.linear_elasticity import (
        LinearElastodynamics,
    )

    mesh, tags = make_scenario_grid(
        "PF", 2, 2, scale=SCALE_2D if scale is None else scale, solver="linear",
    )
    loop = {} if cg_loop is None else {"cg_loop": cg_loop}
    return LinearElastodynamics(AllParameters(**dict(LINEAR_2D, **overrides)),
                                mesh=mesh, tags=tags, device=device, **loop)


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
    from dealii_adapter_tpu_torch.solvers.cg import CG_CHUNK

    levels = model._precond.levels
    log(f"{tag}: model built in {t_build:.1f} s, {model.space.n_dofs} DoF, "
        f"{len(levels)} MG levels {[lv.grid_shape for lv in levels]}, lam_max "
        f"{[round(lv.lam_max, 6) for lv in levels]}; CG loop {model.cg_loop}"
        + (f" (chunks of {getattr(model, 'cg_chunk', CG_CHUNK)})"
           if model.cg_loop == "graphs" else ""))


def run_steps(tag, model, stress, fmt, state=None, first=0, n=4):
    """`n` steps; returns (state, infos, per-step {times, host syncs, kernel
    launches}, checksum). With no `state`: 1 warmup + `n` - 1 timed steps
    from rest, step 0 capturing the CG graphs (`cg_loop="graphs"`); from
    `state` (after step `first` - 1): `n` timed steps."""
    import torch

    from dealii_adapter_tpu_torch.kernels import counters

    warmup = state is None
    if warmup:
        state = model.initial_state()
    infos = []
    steps = dict(times=[], syncs=[], launches=[])
    for i in range(first, first + n):
        torch.cuda.synchronize()
        syncs0 = model.host_syncs
        launches0 = sum(counters.launch_counts().values())
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        u = state.displacement
        checksum = torch.dot(u.reshape(-1), u.reshape(-1)).item()
        steps["times"].append(time.perf_counter() - ts)
        steps["syncs"].append(model.host_syncs - syncs0)
        steps["launches"].append(
            sum(counters.launch_counts().values()) - launches0)
        infos.append(info)
        log(f"{tag}: step {i} ({'warmup' if warmup and i == 0 else 'timed'}) "
            f"{steps['times'][-1]!r} s: {fmt(info)}; host syncs "
            f"{steps['syncs'][-1]}, kernel launches {steps['launches'][-1]}")
    times = steps["times"]
    u = state.displacement
    require(tuple(u.shape) == (model.space.n_nodes, model.space.dim),
            f"{tag}: shape {tuple(u.shape)}")
    require(bool(torch.isfinite(u).all()), f"{tag}: non-finite displacement")
    timed = times[1:] if warmup else times
    log(f"{tag}: timed steps {timed} s; mean {statistics.mean(timed):.4f} "
        f"s/step, {model.space.n_dofs / 1e6 * len(timed) / sum(timed):.4f} "
        f"MDoF*steps/s; host syncs {model.host_syncs} over {first + n} steps; max_u "
        f"{u.abs().max().item()!r} checksum {checksum!r}")
    return state, infos, steps, checksum


def check_checksum(tag, checksum, ref, rtol):
    rel = abs(checksum - ref) / ref
    log(f"{tag}: checksum {checksum!r} rel. difference to the JAX package's "
        f"{ref!r}: {rel:.3e} (limit {rtol})")
    require(rel <= rtol, f"{tag}: checksum {checksum!r} vs {ref!r}")


def profile_step(tag, model, state, stress, table=True):
    """One more step under torch.profiler, tracing the card's activity
    only (host-side tracing slows the step it records): the kernels'
    device-time table (`table`) and the busy share of the step's wall
    time, which it returns (the kernels' summed device time over the wall,
    so overlapping kernels could count twice; the paths run on one
    stream)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    t_session = time.perf_counter()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        ts = time.perf_counter()
        model.step(state, stress)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
    ka = p.key_averages()
    t_session = time.perf_counter() - t_session
    dev_us = sum(
        e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA
    )
    if table:
        log(ka.table(sort_by="self_device_time_total", row_limit=30))
    log(f"{tag} profile: step wall {wall * 1e3:.1f} ms (profiled), device busy "
        f"{dev_us / 1e3:.1f} ms = {dev_us / 1e4 / wall:.1f}% of the wall; the "
        f"session with its key_averages took {t_session:.2f} s")
    return dev_us / 1e6 / wall


def newton_fmt(info):
    return (f"newton {info.iterations} cg {info.cg_iterations} f64 "
            f"{info.f64_evals} f32 {info.f32_evals} asm "
            f"{info.tangent_assemblies} converged {info.converged}")


def main_run(tag, path, model, other=0):
    """`run_steps` on a main-configuration model (1 warmup + 3 timed steps
    from rest); returns (launches, {state, stress, CG and Newton per step,
    checksum, per-step times, syncs and launches, peak memory}). `other`
    is the bytes another model holds, idle meanwhile, which the peak
    leaves out."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    stress = interface_traction(model)
    start_counts()
    state, infos, steps, checksum = run_steps(tag, model, stress, newton_fmt)
    launches = read_counts(path)
    peak = (torch.cuda.max_memory_allocated() - other) / 2**30
    log(f"{tag}: launches {launches}; peak device memory {peak:.2f} GiB; "
        f"last step min_det_F {infos[-1].min_det_F!r}")
    require(all(i.converged for i in infos), f"{tag}: every step converged")
    check_checksum(tag, checksum, CHECKSUM_REF, CHECKSUM_RTOL)
    return launches, dict(
        state=state, stress=stress, cg=[i.cg_iterations for i in infos],
        newton=[i.iterations for i in infos], checksum=checksum, steps=steps,
        peak_gib=peak)


def phase_main(profile):
    """The main configuration with the CG in CUDA graphs (the default on the
    card) and with the host loop, on the same mesh and lam_max values, both
    models on the card: round 1 runs graphs then host loop (1 warmup + 3
    timed steps from rest each), round 2 host loop then graphs (3 more
    timed steps each, from each model's state), so that neither loop
    always runs first; one profiled step of each only after both rounds.
    Identical CG and Newton counts in every step, checksums within
    `LOOPS_RTOL` after each round; every step's time, host syncs and
    launches, the peak memory of each model's round 1 and the busy share
    of its profiled step."""
    import torch

    dev = torch.device("cuda")
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(dev)
    torch.cuda.synchronize()
    describe("main", model, time.perf_counter() - t0)
    require(model.cg_loop == "graphs", "main: the CG runs in CUDA graphs")
    launches, graphs = main_run("main", "main3d", model)
    mesh_tags = (model.mesh, model.tags)
    lam_max = [lv.lam_max for lv in model._precond.levels]
    other = torch.cuda.memory_allocated() - base  # the graphs model's bytes
    t0 = time.perf_counter()
    host_model = build_model(dev, mesh_tags=mesh_tags, mg_lam_max=lam_max,
                             cg_loop="host")
    torch.cuda.synchronize()
    describe("main host", host_model, time.perf_counter() - t0)
    host_launches, host = main_run("main host", "main3d host", host_model,
                                   other)
    runs = (("graphs", "main", model, graphs),
            ("host loop", "main host", host_model, host))
    for _, tag, m, r in runs[::-1]:  # round 2: host loop first
        r["state"], infos, r["steps2"], r["checksum2"] = run_steps(
            tag, m, r["stress"], newton_fmt, state=r["state"], first=4, n=3)
        r["cg"] += [i.cg_iterations for i in infos]
        r["newton"] += [i.iterations for i in infos]
        require(all(i.converged for i in infos), f"{tag}: every step converged")
    for _, tag, m, r in runs:
        r["busy"] = profile_step(tag, m, r["state"], r["stress"], table=profile)
    del model, host_model, runs
    torch.cuda.empty_cache()
    for tag, r in (("graphs", graphs), ("host loop", host)):
        st, st2 = r["steps"], r["steps2"]
        log(f"main A/B {tag}: step times round 1 {st['times']} s, round 2 "
            f"{st2['times']} s (timed means "
            f"{statistics.mean(st['times'][1:])!r} / "
            f"{statistics.mean(st2['times'])!r} s), CG {r['cg']}, Newton "
            f"{r['newton']}, host syncs {st['syncs'] + st2['syncs']}, kernel "
            f"launches {st['launches'] + st2['launches']} per step, peak "
            f"device memory {r['peak_gib']:.3f} GiB, busy {r['busy']:.1%} of "
            f"a profiled step")
    rels = [abs(graphs[k] - host[k]) / host[k] for k in ("checksum", "checksum2")]
    log(f"main A/B: checksums graphs {graphs['checksum']!r} / "
        f"{graphs['checksum2']!r} host loop {host['checksum']!r} / "
        f"{host['checksum2']!r} after steps 3 / 6, rel. differences "
        f"{rels[0]:.3e} / {rels[1]:.3e} (limit {LOOPS_RTOL}); bitwise "
        f"{graphs['checksum'] == host['checksum'] and graphs['checksum2'] == host['checksum2']}")
    require(graphs["cg"] == host["cg"] and graphs["newton"] == host["newton"],
            "main: the graphs' CG and Newton counts equal the host loop's")
    require(max(rels) <= LOOPS_RTOL,
            "main: graphs' checksums against the host loop's")
    return {"main3d": launches, "main3d host": host_launches}, dict(
        mesh_tags=mesh_tags, checksum=graphs["checksum"], lam_max=lam_max,
        cg=graphs["cg"][:4], newton=graphs["newton"][:4],
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


def level_row(level, E, shape, dtype, dev, g, coarse=False, lib_ms=None):
    """One row of a level table at the Q1 level lattice `shape` (3D or 2D)
    with the level's element matrix E, in `dtype`: the level operator (K3
    in 3D, K4b in 2D) against its first (gather) design, K6 against its
    first (pointwise) design and K6 against the level operator, each pair
    timed in turns (`in_turns`, device time); K6 must give the level
    operator's output bit for bit and both designs stay within the limits
    of the plain version; per-call times (`cuda_ms`), the bound and its
    share, and the CSR SpMV library time (`lib_ms` when already taken)."""
    import torch

    from dealii_adapter_tpu_torch.ops.q1_structured import (
        Q1StructuredOperator,
        Q1StructuredOperator2D,
    )
    from dealii_adapter_tpu_torch.ops.stencil import StencilQ1Operator

    dim = len(shape)
    name, cls, gather = (
        ("K3", Q1StructuredOperator, "dat_q1_structured_gather") if dim == 3
        else ("K4b", Q1StructuredOperator2D, "dat_q1_structured_2d_gather"))
    lim = BF16_RTOL if dtype == torch.bfloat16 else F32_RTOL
    u = torch.randn(math.prod(shape), dim, generator=g).to(dev, dtype)
    lv = cls(E, shape, dtype, dev)
    k6 = StencilQ1Operator(E, shape, dtype, device=dev)
    old_lv, old_k6 = first_design(lv, gather), first_design(k6, "dat_q1_stencil_pointwise")
    y = lv(u)
    rel = {"plain": compare(y, lv.plain(u))[1],
           f"old {name}": compare(old_lv(u), y)[1],
           "old K6": compare(old_k6(u), y)[1]}
    require(max(rel.values()) <= lim and torch.equal(k6(u), y),
            f"level {level} {shape} {dtype}: rel_l2 to {name} {rel}, K6 "
            f"bitwise {torch.equal(k6(u), y)}")
    old_ms, ms, turns = in_turns(lambda: old_lv(u), lambda: lv(u))
    k6_old_ms, k6_ms, k6_turns = in_turns(lambda: old_k6(u), lambda: k6(u))
    lv_ms_vs, k6_ms_vs, vs_turns = in_turns(lambda: lv(u), lambda: k6(u))
    b_ms, b_by = bound(*stencil_work(shape, u.element_size()))
    if lib_ms is None:
        lib_ms = library_spmv_ms(E, shape, 1, dev)
    row = dict(level=level, lattice=tuple(shape), kernel=name,
               dtype=str(dtype).replace("torch.", ""), coarse=coarse,
               ms=ms, old_ms=old_ms, turns_old_new_new_old=turns,
               k6_ms=k6_ms, k6_old_ms=k6_old_ms, k6_turns=k6_turns,
               vs_k6_turns=vs_turns, call_ms=cuda_ms(lambda: lv(u)),
               k6_call_ms=cuda_ms(lambda: k6(u)), bound_ms=b_ms,
               bound_by=b_by, share_of_bound=b_ms / ms, library_ms=lib_ms,
               rel_l2=rel)
    log(f"level table: level {level} {tuple(shape)} {row['dtype']}"
        f"{' (coarse solve)' if coarse else ''}: {name} {ms:.4f} ms "
        f"({b_ms / ms:.0%} of the {b_by} bound {b_ms:.4f}), its old design "
        f"{old_ms:.4f} (in turns {[round(t, 4) for t in turns]}); K6 "
        f"{k6_ms:.4f}, its old design {k6_old_ms:.4f} (in turns "
        f"{[round(t, 4) for t in k6_turns]}); {name} vs K6 in turns "
        f"{[round(t, 4) for t in vs_turns]}; per call {name} "
        f"{row['call_ms']:.4f} / K6 {row['k6_call_ms']:.4f}; library "
        f"{lib_ms:.4f}; rel_l2 {({k: float(f'{v:.3e}') for k, v in rel.items()})}")
    return row


def level_table(model):
    """`level_row` at every 3D Q1 level shape of `model`'s hierarchy (bf16,
    the hierarchy's dtype), with that level's element matrix."""
    import torch

    from dealii_adapter_tpu_torch.solvers.multigrid import _geometry_skeleton

    p, dev = model.params, model.device
    lam_eff = model.material.kappa - 2.0 * p.mu / 3
    mass = model.alpha_1 * p.rho
    geoms = _geometry_skeleton(model.mesh, model.tags, p.mg_coarse_size,
                               p.mg_fem_sem, lam_eff, p.mu)
    g = torch.Generator(device="cpu").manual_seed(99)
    log(f"level table: SM clock {sm_clock()}")
    return [level_row(li + 1, p.mu * gm.K_e_unit + mass * gm.M_e_unit,
                      gm.shape_c, torch.bfloat16, dev, g,
                      coarse=li == len(geoms) - 1)
            for li, gm in enumerate(geoms)]


def level_table_2d(model):
    """`level_row` at every 2D Q1 level shape of the linear `model`'s
    hierarchy (that of every 2D path at scale 48; the bf16 paths at scale
    24 run its levels 2 and below), with that level's element matrix, in
    f32 (linear2d, nonlinear2d) and bf16 (vcycle_bf16)."""
    import torch

    from dealii_adapter_tpu_torch.solvers.multigrid import _geometry_skeleton

    p, dev = model.params, model.device
    c = (p.theta * p.delta_t) ** 2
    geoms = _geometry_skeleton(model.mesh, model.tags, p.mg_coarse_size,
                               p.mg_fem_sem, c * p.lmbda, c * p.mu)
    g = torch.Generator(device="cpu").manual_seed(98)
    log(f"level table 2D: SM clock {sm_clock()}")
    rows = []
    for li, gm in enumerate(geoms):
        E = c * p.mu * gm.K_e_unit + p.rho * gm.M_e_unit
        lib_ms = None
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(level_row(li + 1, E, gm.shape_c, dtype, dev, g,
                                  coarse=li == len(geoms) - 1, lib_ms=lib_ms))
            lib_ms = rows[-1]["library_ms"]
    return rows


def phase_stencil3d(main):
    """The main configuration with every 3D Q1 level on K6, on the main
    path's mesh and lam_max values; returns (launches, model, checksum)."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(dev, mesh_tags=main["mesh_tags"],
                        mg_lam_max=main["lam_max"],
                        mg_level_backend="stencil_vmem", end_time=COUPLED_END)
    torch.cuda.synchronize()
    describe("stencil3d", model, time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    stress = interface_traction(model)
    start_counts()
    _, infos, _, checksum = run_steps("stencil3d", model, stress, newton_fmt)
    launches = read_counts("stencil3d")
    log(f"stencil3d: launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"stencil3d: CG per step {[i.cg_iterations for i in infos]}, Newton "
        f"{[i.iterations for i in infos]}; main path (K3 levels): CG "
        f"{main['cg']}, Newton {main['newton']}; checksum rel. difference to "
        f"the main path's {abs(checksum - main['checksum']) / main['checksum']:.3e}")
    require(all(i.converged for i in infos), "stencil3d: every step converged")
    check_checksum("stencil3d", checksum, CHECKSUM_REF, CHECKSUM_RTOL)
    level_table(model)
    return launches, model, checksum


def phase_coupled3d(model, stencil_checksum):
    """`coupled_run` on the stencil3d model: 4 windows x 2 implicit
    iterations against stencil3d's 4 steps; one VTU of the last window."""
    import os
    import tempfile

    import numpy as np
    import torch

    from dealii_adapter_tpu_torch.adapter import Adapter, FakeParticipant
    from dealii_adapter_tpu_torch.runner import coupled_run
    from dealii_adapter_tpu_torch.utils import write_vtu

    load = np.array([1000.0, 0.0, 0.0])  # interface_traction's load
    fake = FakeParticipant(
        dim=3, window_dt=COUPLED_WINDOW, end_time=COUPLED_END,
        read_fn=lambda t, coords: np.tile(load, (len(coords), 1)),
        implicit_iterations=COUPLED_ITERATIONS,
    )
    adapter = Adapter(model.params, model.interface_id, model.space,
                      participant=fake, dtype=model.dtype, device=model.device)
    windows = []
    marks = [time.perf_counter()]

    def output_cb(state, t, info):
        now = time.perf_counter()
        windows.append(dict(t=t.current(), seconds=now - marks[-1],
                            newton=info.iterations, cg=info.cg_iterations))
        marks.append(now)

    start_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = coupled_run(model, adapter, output_cb=output_cb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts("coupled3d")
    u = state.displacement
    checksum = torch.dot(u.reshape(-1), u.reshape(-1)).item()
    n_windows = round(COUPLED_END / COUPLED_WINDOW)
    log(f"coupled3d: {n_windows} windows x {COUPLED_ITERATIONS} implicit "
        f"iterations in {wall:.3f} s; per window {windows}")
    log(f"coupled3d: write history (t, iteration, ||values||): "
        f"{[(round(h[0], 10), h[1], float(np.linalg.norm(h[2]))) for h in fake.write_history]}")
    log(f"coupled3d: launches {launches}")
    require(fake.finalized and len(windows) == n_windows,
            f"coupled3d: {len(windows)} windows completed")
    require(len(fake.write_history) == n_windows * COUPLED_ITERATIONS,
            f"coupled3d: {len(fake.write_history)} writes")
    require(bool(torch.isfinite(u).all()), "coupled3d: non-finite displacement")
    rel = abs(checksum - stencil_checksum) / stencil_checksum
    log(f"coupled3d: checksum {checksum!r}, rel. difference to stencil3d's "
        f"{rel:.3e} (limit {COUPLED_RTOL})")
    require(rel <= COUPLED_RTOL, "coupled3d: checksum against stencil3d's")
    check_checksum("coupled3d", checksum, CHECKSUM_REF, CHECKSUM_RTOL)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "solution-3d-4.vtu")
        ts = time.perf_counter()
        write_vtu(path, model.space, state.displacement,
                  extra_point_data={"velocity": state.velocity})
        log(f"coupled3d: VTU of the last window {os.path.getsize(path)} bytes "
            f"written in {time.perf_counter() - ts:.3f} s")
    return launches


def phase_cli():
    """`python -m dealii_adapter_tpu_torch` on `CLI_PRM` in a subprocess;
    returns the launch counts it prints."""
    import ast
    import os
    import pathlib
    import sys
    import tempfile

    import torch

    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        prm = os.path.join(tmp, "case.prm")
        pathlib.Path(prm).write_text(CLI_PRM.format(out=out))
        env = dict(os.environ, PYTHONPATH=str(root))
        ts = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "dealii_adapter_tpu_torch", prm,
             "--standalone", "--traction", "1000", "0", "--refine",
             str(CLI_REFINE)],
            cwd=root, env=env, capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - ts
        for line in r.stdout.splitlines():
            log(f"cli| {line}")
        require(r.returncode == 0, f"cli: exit code {r.returncode}: {r.stderr[-2000:]}")
        files = sorted(os.listdir(out))
        log(f"cli: exit code 0 in {wall:.1f} s (process start included), "
            f"VTU files {[(f, os.path.getsize(os.path.join(out, f))) for f in files]}")
    require(torch.cuda.get_device_name(0) in r.stdout, "cli: banner names the card")
    require(files == ["solution-2d-1.vtu", "solution-2d-2.vtu"], f"cli: files {files}")
    line = next(x for x in r.stdout.splitlines() if x.startswith("kernel launches: "))
    return read_counts("cli", ast.literal_eval(line[len("kernel launches: "):]))


def phase_vcycle_bf16():
    """Step 0 of the 2D linear and Neo-Hookean models at `VCYCLE_BF16_SCALE`
    with the bf16 hierarchy: CG iterations against the JAX package's on
    the CPU; returns {path: launches}."""
    import torch

    dev = torch.device("cuda")
    by_path = {}
    for path, build, ref in (
        ("vcycle_bf16", lambda: build_linear_model(
            dev, scale=VCYCLE_BF16_SCALE, precond_dtype="bfloat16"),
         VCYCLE_BF16_REF),
        ("vcycle_bf16 nonlinear", lambda: build_model(
            dev, dim=2, scale=VCYCLE_BF16_SCALE, precond_dtype="bfloat16"),
         VCYCLE_BF16_NL_REF),
    ):
        t0 = time.perf_counter()
        model = build()
        torch.cuda.synchronize()
        describe(path, model, time.perf_counter() - t0)
        model._max_cg_iter = VCYCLE_BF16_CAP
        stress = interface_traction(model)
        start_counts()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        _, info = model.step(model.initial_state(), stress)
        torch.cuda.synchronize()
        by_path[path] = read_counts(path)
        limit = VCYCLE_BF16_RATIO * ref
        nonlinear = path.endswith("nonlinear")
        cg = info.cg_iterations if nonlinear else info.iterations
        log(f"{path}: step 0 at {model.space.n_dofs} DoF in "
            f"{time.perf_counter() - ts:.4f} s: cg {cg}"
            + (f", newton {info.iterations}" if nonlinear else "")
            + f" (JAX package on the CPU: {ref}"
            + (f" / {VCYCLE_BF16_NL_NEWTON}" if nonlinear else "")
            + f"; limit {limit:g}), "
            + (f"converged {info.converged}" if nonlinear
               else f"residual {info.residual!r}")
            + f"; launches {by_path[path]}")
        if nonlinear:
            require(info.converged, f"{path}: step 0 converged")
        else:
            require(info.residual <= 1e-10, f"{path}: residual {info.residual}")
        require(cg <= limit, f"{path}: {cg} CG > {limit:g}")
        del model
        torch.cuda.empty_cache()
    return by_path


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
    del state
    level_table_2d(model)
    del model
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

    t_script = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"{name}: phase took {time.perf_counter() - t0:.1f} s")
        return out

    timed("build", phase_build)
    records = timed("kernels", phase_kernels)
    by_path = {}
    paths, main_run = timed("main", phase_main, args.profile)
    by_path.update(paths)
    by_path.update(timed("tangent3d", phase_tangent3d, main_run))
    by_path["stencil3d"], model, checksum = timed(
        "stencil3d", phase_stencil3d, main_run)
    del main_run
    by_path["coupled3d"] = timed("coupled3d", phase_coupled3d, model, checksum)
    del model
    torch.cuda.empty_cache()
    by_path["linear2d"] = timed("linear2d", phase_linear2d, args.profile)
    by_path["nonlinear2d"] = timed("nonlinear2d", phase_nonlinear2d, args.profile)
    by_path.update(timed("vcycle_bf16", phase_vcycle_bf16))
    by_path["cli"] = timed("cli", phase_cli)
    log(f"all phases after the device check: {time.perf_counter() - t_script:.1f} s")
    log(f"kernels the device-time sessions missed: {MISSED_KERNELS[0]}; "
        f"device times taken from CUDA-graph replays instead: "
        f"{GRAPH_FALLBACKS[0]}")
    for rec in records:
        per_path = {p: n.get(rec["name"], 0) for p, n in by_path.items()
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
