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
   K1 is also held at the Q4 bench cell's shape (E = 375, 3,456 cells,
   `Q4_TANGENT_SHAPE`). Limits: relative L2 error <= 1e-5 for f32 output (only the summation
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
4. main    — `NonlinearElasticity` with the benchmark configuration
   (`bench_torch.py:build_model`, bench.py's: 3D Neo-Hookean perpendicular
   flap, Q2, scale 9: 1,018,875 DoF), traction 1000 in x on the
   interface, its CG in CUDA graphs, on one model with its Newton loop on
   the host (`newton_loop="host"`, path `main3d newton host`: the parent's
   loop) and on the device (`newton_loop="graphs"`, the default: its
   residuals, tangent assembly, decisions and update replayed from CUDA
   graphs, one read-back a Newton pass), in turns: 1 warmup and 3 timed
   Newmark steps from rest with each (host, then graphs), then 3 more
   timed steps of each in the reverse order.
   Every step must converge and the checksum ||u||^2 after step 3 must
   lie within rtol 1e-4 of the JAX package's 49.05486138743322 (Newton's
   tol_u of 1e-6 bounds the spread near 1e-5); the two loops must give the
   same `NewtonInfo` in every step and their checksums after steps 3 and
   6 agree within 1e-12 relative (`LOOPS_RTOL`), and the device loop must
   read back at most its Newton iterations + 1 a step outside the CG. For
   each loop: every step's time (unrounded), host syncs (the CG's apart)
   and kernel launches, the peak device memory of its first 4 steps, and,
   after all timed steps, the device busy share of one more step under
   torch.profiler tracing the card only (`--profile` prints its kernel
   table). Then a model of its own with the host CG loop (`cg_loop=
   "host"`, and so the host Newton loop: path `main3d host`), on the same
   mesh and lam_max values, 1 warmup and 1 timed step from rest
   (`MAIN_HOST_STEPS`): the same `NewtonInfo` as main3d's in both steps
   and ||u||^2 within `LOOPS_RTOL` of main3d's after step 1.
   bench — `bench_torch.py`'s other cells (`BENCH_CELLS`: the Neo-Hookean
   Q4 model at scale 4, 722,211 DoF; the linear model at Q2 scale 4,
   97,875 DoF, and Q3 scale 3, 136,920 DoF) through its functions, 1
   warmup and 3 timed steps each, with its checks (converged, residual <=
   1e-10, ||u||^2 against the JAX package's where `bench_torch.REFERENCES`
   has it); per-step counts, times and launches.
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
   Then the jvp paths (`JVP_PATHS`), each phase 4's configuration on its
   mesh and lam_max values, 1 warmup and 3 timed steps, every step
   converged; first a check that forward-mode AD drops a detached
   operand's tangent on the card (the f64 jvp tangent's external force):
   - f64jvp3d — `solve_dtype=""` and `use_sumfact=True`: the CG in f64
     on the f64 jvp tangent (the derivative of the whole residual, sum
     factorized), bf16 V-cycle; ||u||^2 within rtol 1e-4 of the JAX
     package's value; K3 and K5 launched, K1 not;
   - jvp3d — `assembled_tangent_max_gb=0.5` (the f32 tangents need 1.03
     GB), so `auto` falls back to the f32 jvp tangent; no assembled
     tangent and K1 not launched, Newton counts equal to phase 4's in
     every step, ||u||^2 within rtol 1e-6 (`JVP_RTOL`) of phase 4's;
   - reuse_fine3d — `newton_tangent_reuse` and `mg_fine_tangent`: Newton
     counts at most phase 4's + 2 a step, ||u||^2 within rtol 1e-4 of the
     JAX package's value, fewer tangent assemblies than Newton iterations
     over the timed steps, K1 (CG and fine level) and K3 launched, K5
     not.
   Each prints CG and Newton counts per step against phase 4's, tangent
   assemblies and host syncs per step; f64jvp3d and jvp3d also the device
   time of one application of their CG operator (one per CG iteration;
   torch.profiler's and a CUDA graph's) and, at the same iterate, that of
   the f32 assembled tangent's matvec (K1) and of its assembly.
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
12. cli_nl — `python -m dealii_adapter_tpu_torch` in a subprocess on the
   reference's own Neo-Hookean configuration (`NL_DEFAULT_PRM`: FSI3, Q4,
   1,898 DoF, f64 CG with Jacobi on the f64 jvp tangent), 3 steps under
   `--traction 2000 0`: exit code 0 (every window converged), a VTU file
   of each step, and the final ||u||^2 the CLI prints within rtol 1e-7
   of the JAX package's on the CPU (`NL_DEFAULT_REF`); it launches C1/C2
   and no other kernel.
13. the gather backend and several ranks, each on phase 4's configuration
   and lam_max values (this card is one H100, so the multi-rank phases put
   their ranks on it; a time of two ranks sharing it is not a scaling
   result):
   - gather3d — `element_backend="gather"` (the jvp tangent of the
     gather-plan internal force, bf16 V-cycle with K5 and K3), 1 warmup
     and 3 timed steps: Newton counts equal to jvp3d's in every step,
     ||u||^2 within rtol 1e-6 (`JVP_RTOL`) of jvp3d's;
   - shard3d — the lattice partition (`parallel/lattice.py`) at full
     size on `SHARD_RANKS` ranks spawned on the card over gloo (the
     kernels built once before the spawn), the host CG loop (gloo cannot
     be captured); each rank first holds K5, K3 (every distributed level)
     and K1 at its slab's shapes against their plain versions, then runs
     `SHARD3D_STEPS` steps (1 warmup and 1 timed: cut from 4 steps, ~6.5 s
     each, to keep the script within its time): every step converged,
     Newton counts equal to phase 4's, CG within +-2 (`SHARD_CG_SLACK`) a
     step, ||u||^2 after the last step within rtol 1e-7 (`SHARD_RTOL`,
     tests/test_sharding.py's field tolerance) of phase 4's after the same
     step; each rank's launches, its halo fills, interface sums and
     all-reduces a step, and its per-step times;
   - shard3d_nccl1 — the same as a world of one on NCCL with the CG in
     CUDA graphs (NCCL all-reduces captured): CG, Newton and ||u||^2 bit
     for bit phase 4's; then, on that world, the cell partition's
     configuration of shard_cells, its one-rank reference;
   - shard_cells — the cell partition (`element_backend="gather"`,
     Chebyshev, the jvp tangent) on `SHARD_RANKS` gloo ranks at scale
     `SHARD_CELLS_SCALE`, `SHARD_CELLS_STEPS` steps: Chebyshev alone takes
     some hundreds of CG a step at this scale already and its count grows
     with the resolution, so the full size would take minutes; Newton
     counts equal to the one-rank reference's, CG within +-2 a solve,
     ||u||^2 within `SHARD_RTOL`;
   - dryrun — `parallel/dryrun.py:dryrun_multichip(SHARD_RANKS, "cuda")`:
     converged, det F > 0, K1, K3 and K5 launched on every rank.
14. the coupled run and the CLI on several ranks, and the Neo-Hookean
   golden trajectories:
   - coupled_shard — phase 10's coupled run (phase 9's configuration, K6
     on every Q1 level, phase 4's lam_max values) on the lattice partition
     on `SHARD_RANKS` gloo ranks sharing the card, the host CG loop, cut
     to its first window (window 0.01, 2 implicit iterations, so one
     rollback; 2 steps of ~6.5 s: the 4 windows would cost about a
     minute); rank 0 alone holds the participant: the window's time and
     write count equal phase 10's first window, rank 0's write-history
     norms and ||u||^2 within `SHARD_RTOL` of it; each rank's launches,
     collectives and seconds a window;
   - coupled_nccl1 — the same window on a world of one over NCCL in the
     script's own process, with the CG graphs and the device Newton loop:
     the write history and ||u||^2 bit for bit phase 10's first window;
   - cli_ranks — `torchrun --standalone --nproc-per-node 2 -m
     dealii_adapter_tpu_torch` on `CLI_PRM` with `--devices 2` in a
     subprocess (gloo ranks sharing the card, the host CG loop): exit code
     0, one banner, naming the card, 2 ranks and the host CG loop, each
     VTU file written once, the final ||u||^2 within 1e-9
     (`CLI_RANKS_RTOL`) of phase 11's; rank 0's closing `kernel
     launches` line gives the path's counts;
   - golden_nl — the recorded Neo-Hookean golden tip trajectories
     (`nonlinear_pf_q2`: 2D PF, Q2, the f64 Jacobi CG on the f64 jvp
     tangent, 518 DoF, traction 5000; `nonlinear_pf_q4`: Q4, dense Direct
     Newton solves, 1,898 DoF, traction 2000; tests/test_golden_trajectory.py's
     configuration), 20 steps each, every step converged and the tip
     within rtol 1e-7 of tests/golden_trajectories.json; C1/C2 and no
     other kernel launched.

Every path but `main3d host`, shard3d, shard_cells, dryrun,
coupled_shard and cli_ranks (the host CG and Newton loops; all but the
first on gloo ranks) runs its CG in CUDA
graphs and its Newton loop on the device (`newton_loop="graphs"`); f64jvp3d, jvp3d, reuse_fine3d and
gather3d then run their 4 steps again from rest on the host Newton loop
(`newton_host_twin`): the same `NewtonInfo` in every step, ||u||^2 within
`LOOPS_RTOL`. A graph replay adds the launches its capture recorded to
the counts (`kernels/counters.py`), so the counts are device launches,
the masked iterations of each solve's last chunk included.
In phases 4-12 the kernel launch counts are set to 0 after the model is
built (for `cli` and `cli_nl`: in its own process) and read after its steps; every
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
import os
import statistics
import subprocess
import tempfile
import time

import bench_torch  # stdlib-only at import, as this script

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

# bench_torch.py's cells: bench.py's build_model and build_linear_model
# with their environment defaults (`nonlinear_config`, `linear_config`,
# the one definition of the configuration), without `dim`
NONLINEAR = {k: v for k, v in bench_torch.nonlinear_config().items()
             if k != "dim"}
LINEAR = {k: v for k, v in bench_torch.linear_config().items() if k != "dim"}
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
# K1's shape on the Q4 bench cell (3D Q4, scale 4: 12 x 72 x 4 cells of
# 125 nodes, E = 375)
Q4_TANGENT_SHAPE = (12 * 72 * 4, 125, 3)
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
    "main3d newton host": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
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
# the jvp paths: main3d with an f64 inner solve (the f64 jvp tangent) and
# sum factorization; with the tangents capped below their 1.03 GB, so that
# `auto` falls back to the f32 jvp; with Newton tangent reuse and the
# tangent as the V-cycle's fine operator
JVP_PATHS = {
    "f64jvp3d": dict(solve_dtype="", use_sumfact=True),
    "jvp3d": dict(assembled_tangent_max_gb=0.5),
    "reuse_fine3d": dict(newton_tangent_reuse=True, mg_fine_tangent=True),
}
# jvp3d against main3d's own checksum in the same run: the bound of the
# JAX package's tests/test_assembled_tangent.py::
# test_model_step_equivalent_backends (the same linearization)
JVP_RTOL = 1e-6
# bench_torch.py's cells other than main3d (its default cell), each
# (model, degree, scale) at full size with bench_torch.py's checks
BENCH_CELLS = {
    "bench_q4": ("nonlinear", 4, 4),
    "bench_linear_q2": ("linear", 2, 4),
    "bench_linear_q3": ("linear", 3, 3),
}
PATH_KERNELS.update({
    "bench_q4": _HEALTH + ("K1 tangent_matvec", "K3 q1_structured"),
    "bench_linear_q2": _HEALTH + _MG3D,
    "bench_linear_q3": _HEALTH + ("K3 q1_structured",),
    "gather3d": _HEALTH + _MG3D,
    "shard3d": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
    "shard3d_nccl1": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
    "shard_cells": _HEALTH,
    "dryrun": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
    "f64jvp3d": _HEALTH + _MG3D,
    "jvp3d": _HEALTH + _MG3D,
    "reuse_fine3d": _HEALTH + ("K1 tangent_matvec", "K3 q1_structured"),
    "cli_nl": _HEALTH,
    "coupled_shard": _STENCIL3D,
    "coupled_nccl1": _STENCIL3D,
    "cli_ranks": _HEALTH + ("K4b q1_structured_2d",),
    "golden_nl": _HEALTH,
})
# kernels a path must NOT launch: the stencil paths replace K3 with K6, the
# jvp paths have no assembled tangent, reuse_fine3d smooths the tangent
# (K1) on the fine level in place of the proxy (K5), and cli_nl's Jacobi
# CG on the jvp tangent launches no kernel but C1/C2
PATH_EXCLUDES = {"bench_q4": ("K5 q2_structured",),
                 "bench_linear_q2": ("K1 tangent_matvec",),
                 "bench_linear_q3": ("K1 tangent_matvec", "K5 q2_structured"),
                 "gather3d": ("K1 tangent_matvec",),
                 "shard_cells": ("K1 tangent_matvec", "K3 q1_structured",
                                 "K5 q2_structured"),
                 "stencil3d": ("K3 q1_structured",),
                 "coupled3d": ("K3 q1_structured",),
                 "f64jvp3d": ("K1 tangent_matvec",),
                 "jvp3d": ("K1 tangent_matvec",),
                 "reuse_fine3d": ("K5 q2_structured",),
                 "cli_nl": ("K1 tangent_matvec", "K3 q1_structured",
                            "K5 q2_structured", "K4b q1_structured_2d"),
                 "coupled_shard": ("K3 q1_structured",),
                 "coupled_nccl1": ("K3 q1_structured",),
                 "golden_nl": ("K1 tangent_matvec", "K3 q1_structured",
                               "K5 q2_structured", "K4b q1_structured_2d")}
# ||u||^2 after cli_nl's 3 steps, the JAX package on the CPU:
#   JAX_PLATFORMS=cpu python tools/jax_reference_nl_default.py
NL_DEFAULT_REF = 0.10160554980143784
NL_DEFAULT_RTOL = 1e-7
# the coupled3d phase: window, end time, implicit iterations per window
COUPLED_WINDOW, COUPLED_END, COUPLED_ITERATIONS = 0.01, 0.04, 2
COUPLED_RTOL = 1e-10  # against stencil3d's checksum: the same 4 steps
# main3d's checksum under CUDA graphs against the host loop's: the same
# kernels on the same inputs, so they should agree bit for bit
LOOPS_RTOL = 1e-12
# the steps of `main3d host` (the host CG loop), 1 warmup included: cut
# from main3d's 7 to keep the script's time
MAIN_HOST_STEPS = 2
# the multi-rank phases (13): ranks sharing the card; shard3d's CG may
# differ from phase 4's by this many a step (tests/test_sharding.py:109);
# ||u||^2 against phase 4's within tests/test_sharding.py's field rtol;
# shard_cells' reduced scale and steps (phase 13's docstring)
SHARD_RANKS = 2
SHARD_CG_SLACK = 2
SHARD_RTOL = 1e-7
SHARD_CELLS_SCALE = 2
SHARD_CELLS_STEPS = 2
SHARD3D_STEPS = 2  # shard3d's steps (phase 13's docstring)
# cli_ranks (phase 14): the cli phase's case on this many ranks under
# torchrun; its final ||u||^2 against the cli phase's
CLI_RANKS = 2
CLI_RANKS_RTOL = 1e-9
# golden_nl (phase 14): tests/test_golden_trajectory.py's Neo-Hookean
# configuration, and each trajectory's changes to it and traction
GOLDEN_NONLINEAR = dict(
    model="neo-Hookean", type_lin="CG", scenario="PF", dim=2, poly_degree=2,
    delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0, tol_lin=1e-6, tol_u=1e-6,
    tol_f=1e-9, max_iterations_NR=12, max_iterations_lin=10.0,
)
GOLDEN_NL_CASES = {
    "nonlinear_pf_q2": ({}, 5000.0),
    "nonlinear_pf_q4": (dict(poly_degree=4, type_lin="Direct"), 2000.0),
}
GOLDEN_NL_RTOL = 1e-7  # tests/test_golden_trajectory.py's
SHARD_CELLS = dict(element_backend="gather", preconditioner="Chebyshev")
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
# the cli_nl phase: the reference's own Neo-Hookean configuration
# (examples/nonlinear_elasticity.prm: FSI3, Q4, f64 Jacobi CG on the jvp
# tangent) for 3 steps under a constant traction
NL_DEFAULT_PRM = "examples/nonlinear_elasticity.prm"
NL_DEFAULT_END = 0.03
NL_DEFAULT_TRACTION = ("2000", "0")


def nl_default_prm(text, out):
    """The text of `NL_DEFAULT_PRM` with End time `NL_DEFAULT_END` and a
    VTU file of every step written into `out`."""
    import re

    for key, value in (("End time", NL_DEFAULT_END), ("Output interval", 1),
                       ("Output folder", out)):
        text = re.sub(rf"(set {key}\s*=).*", rf"\g<1> {value}", text)
    return text


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

    from dealii_adapter_tpu_torch.solvers.graphs import capture

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capture(graph):
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
    card = bench_torch.card_name(torch.device("cuda"))
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
    # K1 at the Q4 cell's shape (bench_torch.py's BENCH_DEGREE=4
    # BENCH_SCALE=4: the Q4 Neo-Hookean model's assembled tangent)
    n_cells, npc, dim = Q4_TANGENT_SHAPE
    edofs = dim * npc
    KT = randn(edofs, edofs, n_cells)
    u2 = randn(edofs, n_cells)
    checks["K1 tangent_matvec"].append(tangent_check(
        "K1", f"KT {edofs}x{edofs}x{n_cells} f32 (Q4)",
        lambda: at.apply_packed_tangents_T(KT, u2),
        lambda: at.apply_packed_tangents_T_plain(KT, u2),
        4 * edofs * edofs * n_cells, edofs, n_cells, KT.transpose(0, 1), u2))
    del KT, u2
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
             **c3d, other_checks=others)
        for name, (c3d, *others) in checks.items()
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
    from dealii_adapter_tpu_torch.kernels import counters

    counters.restart("cuda")


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
                cg_loop=None, cg_chunk=None, device_mesh=None,
                newton_loop=None, **overrides):
    """`NonlinearElasticity` on the port: `bench_torch.py:build_model`
    (the benchmark configuration of bench.py's build_model) in 3D,
    `NONLINEAR_2D` in 2D, with `overrides`; `mesh_tags` reuses a mesh (and
    the multigrid geometry cached on it), `mg_lam_max` a hierarchy's
    lam_max values; `cg_loop`, `cg_chunk` and `newton_loop`, when given,
    the model's Krylov and Newton loops; `device_mesh` this rank's
    `RankGroup` (several ranks)."""
    if dim == 2:
        overrides = dict(NONLINEAR_2D, **overrides)
    kw = {k: v for k, v in (("cg_loop", cg_loop), ("cg_chunk", cg_chunk),
                            ("newton_loop", newton_loop)) if v is not None}
    return bench_torch.build_model(
        SCALE if scale is None else scale,
        NONLINEAR["dtype"], NONLINEAR["poly_degree"], device=device,
        mesh_tags=mesh_tags, overrides=overrides, mg_lam_max=mg_lam_max,
        device_mesh=device_mesh, **kw)


def build_linear_model(device, scale=None, cg_loop=None, **overrides):
    """`LinearElastodynamics` with `LINEAR_2D` and `overrides` on the 2D
    flap, on the port (`bench_torch.py:build_linear_model`; `cg_loop`,
    when given, its Krylov loop)."""
    loop = {} if cg_loop is None else {"cg_loop": cg_loop}
    return bench_torch.build_linear_model(
        SCALE_2D if scale is None else scale, LINEAR["dtype"],
        LINEAR["poly_degree"], device=device,
        overrides=dict(LINEAR_2D, **overrides), **loop)


# traction 1000 in x on the interface, as bench_torch.py loads its cells
interface_traction = bench_torch.interface_traction


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
    steps = dict(times=[], syncs=[], cg_syncs=[], launches=[], checksums=[])
    for i in range(first, first + n):
        torch.cuda.synchronize()
        syncs0 = model.host_syncs
        cg_syncs0 = getattr(model, "cg_host_syncs", 0)
        launches0 = sum(counters.launch_counts().values())
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        u = state.displacement
        checksum = torch.dot(u.reshape(-1), u.reshape(-1)).item()
        steps["times"].append(time.perf_counter() - ts)
        steps["checksums"].append(checksum)
        steps["syncs"].append(model.host_syncs - syncs0)
        steps["cg_syncs"].append(getattr(model, "cg_host_syncs", 0) - cg_syncs0)
        steps["launches"].append(
            sum(counters.launch_counts().values()) - launches0)
        infos.append(info)
        log(f"{tag}: step {i} ({'warmup' if warmup and i == 0 else 'timed'}) "
            f"{steps['times'][-1]!r} s: {fmt(info)}; host syncs "
            f"{steps['syncs'][-1]} (CG {steps['cg_syncs'][-1]}), kernel "
            f"launches {steps['launches'][-1]}")
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


def main_run(tag, path, model, loop, stress):
    """`run_steps` of the main-configuration model with its Newton loop
    `loop` (1 warmup + 3 timed steps from rest); returns (launches, {state,
    NewtonInfo per step, checksum, per-step times, syncs and launches, peak
    memory})."""
    import torch

    model.newton_loop = loop
    torch.cuda.reset_peak_memory_stats()
    start_counts()
    state, infos, steps, checksum = run_steps(tag, model, stress, newton_fmt)
    launches = read_counts(path)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag}: launches {launches}; peak device memory {peak:.2f} GiB; "
        f"last step min_det_F {infos[-1].min_det_F!r}")
    require(all(i.converged for i in infos), f"{tag}: every step converged")
    check_checksum(tag, checksum, CHECKSUM_REF, CHECKSUM_RTOL)
    return launches, dict(state=state, infos=infos, checksum=checksum,
                          steps=steps, peak_gib=peak)


def phase_main(profile):
    """The main configuration, its CG in CUDA graphs, with its Newton loop
    on the device (`newton_loop="graphs"`, the default) and on the host
    (`"host"`, the parent's loop), both on one model and so on the same CG
    graphs, in turns: round 1 host then graphs (1 warmup + 3 timed steps
    from rest each), round 2 graphs then host (3 more timed steps each,
    from each loop's state); one profiled step of each only after both
    rounds. The same `NewtonInfo` in every step, checksums within
    `LOOPS_RTOL` after each round; the device loop's read-backs outside
    the CG at most its Newton iterations + 1 a step; every step's time,
    host syncs (the CG's apart) and launches, the peak memory of each
    loop's round 1 and the busy share of its profiled step."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(dev)
    torch.cuda.synchronize()
    describe("main", model, time.perf_counter() - t0)
    require(model.cg_loop == "graphs" and model.newton_loop == "graphs",
            "main: the CG and the Newton loop run in CUDA graphs")
    stress = interface_traction(model)
    tags = {"graphs": ("main", "main3d"),
            "host": ("main newton host", "main3d newton host")}
    runs, launches = {}, {}
    for loop in ("host", "graphs"):  # round 1
        tag, path = tags[loop]
        launches[path], runs[loop] = main_run(tag, path, model, loop, stress)
    for loop in ("graphs", "host"):  # round 2
        r = runs[loop]
        model.newton_loop = loop
        r["state"], infos, r["steps2"], r["checksum2"] = run_steps(
            tags[loop][0], model, stress, newton_fmt, state=r["state"],
            first=4, n=3)
        r["infos"] += infos
        require(all(i.converged for i in infos),
                f"{tags[loop][0]}: every step converged")
    for loop in ("graphs", "host"):
        model.newton_loop = loop
        r = runs[loop]
        r["busy"] = profile_step(tags[loop][0], model, r["state"], stress,
                                 table=profile)
    model.newton_loop = "graphs"
    graphs, host = runs["graphs"], runs["host"]
    for loop, r in runs.items():
        st, st2 = r["steps"], r["steps2"]
        outside = [a - b for a, b in zip(st["syncs"] + st2["syncs"],
                                         st["cg_syncs"] + st2["cg_syncs"])]
        r["outside"] = outside
        log(f"main A/B newton {loop}: step times round 1 {st['times']} s, "
            f"round 2 {st2['times']} s (timed means "
            f"{statistics.mean(st['times'][1:])!r} / "
            f"{statistics.mean(st2['times'])!r} s), CG "
            f"{[i.cg_iterations for i in r['infos']]}, Newton "
            f"{[i.iterations for i in r['infos']]}, host syncs "
            f"{st['syncs'] + st2['syncs']} of which outside the CG "
            f"{outside}, kernel launches {st['launches'] + st2['launches']} "
            f"per step, peak device memory {r['peak_gib']:.3f} GiB, busy "
            f"{r['busy']:.1%} of a profiled step")
    rels = [abs(graphs[k] - host[k]) / host[k] for k in ("checksum", "checksum2")]
    log(f"main A/B: checksums newton graphs {graphs['checksum']!r} / "
        f"{graphs['checksum2']!r} host {host['checksum']!r} / "
        f"{host['checksum2']!r} after steps 3 / 6, rel. differences "
        f"{rels[0]:.3e} / {rels[1]:.3e} (limit {LOOPS_RTOL}); bitwise "
        f"{graphs['checksum'] == host['checksum'] and graphs['checksum2'] == host['checksum2']}")
    require(graphs["infos"] == host["infos"],
            "main: the device Newton loop's NewtonInfo equals the host loop's")
    require(max(rels) <= LOOPS_RTOL,
            "main: the device Newton loop's checksums against the host loop's")
    require(all(o <= i.iterations + 1 for o, i in zip(graphs["outside"],
                                                      graphs["infos"])),
            "main: the device Newton loop reads back at most its Newton "
            "iterations + 1 a step outside the CG")
    infos, checksum = graphs["infos"][:4], graphs["checksum"]
    checksums = graphs["steps"]["checksums"]
    mesh_tags = (model.mesh, model.tags)
    lam_max = [lv.lam_max for lv in model._precond.levels]
    del model, runs, graphs, host
    torch.cuda.empty_cache()
    launches["main3d host"] = main_host_cg(mesh_tags, lam_max, infos,
                                           checksums)
    return launches, dict(
        mesh_tags=mesh_tags, checksum=checksum, checksums=checksums,
        lam_max=lam_max, cg=[i.cg_iterations for i in infos],
        newton=[i.iterations for i in infos],
    )


def main_host_cg(mesh_tags, lam_max, infos, checksums):
    """The main configuration with its CG loop on the host (`cg_loop=
    "host"`, and so the host Newton loop: path `main3d host`), on main3d's
    mesh and lam_max values, `MAIN_HOST_STEPS` steps from rest (1 warmup):
    the same `NewtonInfo` as main3d's (`infos`) in every step and ||u||^2
    within `LOOPS_RTOL` of main3d's after the same step (`checksums`), so
    that the CG graphs stay held against their plain loop at full size;
    returns the path's launches."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(dev, mesh_tags=mesh_tags, mg_lam_max=lam_max,
                        cg_loop="host")
    torch.cuda.synchronize()
    describe("main host", model, time.perf_counter() - t0)
    require(model.cg_loop == "host" and model.newton_loop == "host",
            "main host: the CG and the Newton loop run on the host")
    stress = interface_traction(model)
    start_counts()
    _, host_infos, steps, checksum = run_steps(
        "main host", model, stress, newton_fmt, n=MAIN_HOST_STEPS)
    launches = read_counts("main3d host")
    ref = checksums[MAIN_HOST_STEPS - 1]
    rel = abs(checksum - ref) / ref
    log(f"main host: launches {launches}; NewtonInfo equal main3d's "
        f"{host_infos == infos[:MAIN_HOST_STEPS]}; checksum {checksum!r} "
        f"against main3d's {ref!r} after step {MAIN_HOST_STEPS - 1}: rel. "
        f"difference {rel:.3e} (limit {LOOPS_RTOL}), bitwise {checksum == ref}")
    require(all(i.converged for i in host_infos),
            "main host: every step converged")
    require(host_infos == infos[:MAIN_HOST_STEPS],
            "main host: the host CG loop's NewtonInfo equals main3d's")
    require(rel <= LOOPS_RTOL,
            "main host: the host CG loop's checksum against main3d's")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_bench():
    """bench_torch.py's cells other than main3d (`BENCH_CELLS`) at full
    size through its functions: 1 warmup and 3 timed steps each with its
    checks (every Neo-Hookean step converged, every linear residual <=
    1e-10, ||u||^2 against the JAX package's where recorded); returns
    {path: launches}."""
    import torch

    dev = torch.device("cuda")
    by_path = {}
    for path, (kind, degree, scale) in BENCH_CELLS.items():
        build = (bench_torch.build_model if kind == "nonlinear"
                 else bench_torch.build_linear_model)
        t0 = time.perf_counter()
        model = build(scale, "float64", degree, device=dev)
        torch.cuda.synchronize()
        log(f"{path}: {kind} degree {degree} scale {scale}, "
            f"{model.space.n_dofs} DoF, built in "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        start_counts()
        _, _, diags = bench_torch.run_steps(model, 3)
        by_path[path] = read_counts(path)
        for d in diags:
            log(f"{path}: step {d['step']}: " + ", ".join(
                f"{k} {v!r}" for k, v in d.items() if k != "step"))
        timed = [d["s"] for d in diags[1:]]
        log(f"{path}: launches {by_path[path]}; timed steps {timed} s, "
            f"{model.space.n_dofs / 1e6 * len(timed) / sum(timed)!r} "
            f"MDoF*steps/s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        fails = bench_torch.check(kind, diags, (kind, degree, scale), True)
        require(not fails, f"{path}: {fails}")
        del model
        torch.cuda.empty_cache()
    return by_path


def newton_host_twin(tag, model, stress, infos, checksum):
    """The path's 4 steps again from rest with the Newton loop on the host
    (`newton_loop="host"`, on the same model and CG graphs): the same
    `NewtonInfo` in every step, ||u||^2 within `LOOPS_RTOL`."""
    model.newton_loop = "host"
    _, host_infos, steps, host_checksum = run_steps(
        f"{tag} newton host", model, stress, newton_fmt)
    model.newton_loop = "graphs"
    rel = abs(checksum - host_checksum) / host_checksum
    log(f"{tag}: newton graphs against host: NewtonInfo equal "
        f"{host_infos == infos}, checksum rel. difference {rel:.3e} (limit "
        f"{LOOPS_RTOL}); the host loop's syncs outside the CG a step "
        f"{[a - b for a, b in zip(steps['syncs'], steps['cg_syncs'])]}")
    require(host_infos == infos,
            f"{tag}: the device Newton loop's NewtonInfo equals the host loop's")
    require(rel <= LOOPS_RTOL, f"{tag}: checksum against the host Newton loop's")


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


def coupled_participant(end_time):
    """Phase 10's `FakeParticipant`: windows of `COUPLED_WINDOW` to
    `end_time`, `COUPLED_ITERATIONS` implicit iterations each, the
    constant read field (1000, 0, 0) (`interface_traction`'s load)."""
    import numpy as np

    from dealii_adapter_tpu_torch.adapter import FakeParticipant

    load = np.array([1000.0, 0.0, 0.0])
    return FakeParticipant(
        dim=3, window_dt=COUPLED_WINDOW, end_time=end_time,
        read_fn=lambda t, coords: np.tile(load, (len(coords), 1)),
        implicit_iterations=COUPLED_ITERATIONS,
    )


def coupled_window(model, mesh=None):
    """`coupled_run` on `model` (with `mesh`, the ranks' `RankGroup`, on
    several ranks) through `coupled_participant(COUPLED_END)`, or its
    first window alone on several ranks, from `start_counts`; returns its
    windows (time, seconds, Newton, CG, ||u||^2 of the gathered field),
    the write history (rank 0's; [] elsewhere), the launches, the
    collectives, the seconds, the final state and whether the participant
    finished."""
    import torch

    from dealii_adapter_tpu_torch.adapter import Adapter
    from dealii_adapter_tpu_torch.kernels import counters
    from dealii_adapter_tpu_torch.runner import coupled_run

    fake = coupled_participant(COUPLED_END if mesh is None else COUPLED_WINDOW)
    adapter = Adapter(model.params, model.interface_id, model.space,
                      participant=fake, dtype=model.dtype, device=model.device,
                      device_mesh=mesh)
    windows = []
    marks = []

    def output_cb(state, t, info):
        u = model.global_rows(state.displacement).reshape(-1)
        u2 = torch.dot(u, u).item()
        now = time.perf_counter()
        windows.append(dict(t=t.current(), seconds=now - marks[-1],
                            newton=info.iterations, cg=info.cg_iterations,
                            checksum=u2))
        marks.append(now)

    start_counts()
    calls0 = dict(mesh.calls) if mesh is not None else {}
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    t0 = marks[0]
    state = coupled_run(model, adapter, output_cb=output_cb)
    torch.cuda.synchronize()
    lead = mesh is None or mesh.rank == 0
    return dict(
        windows=windows, seconds=time.perf_counter() - t0,
        writes=[(h[0], h[1], h[2].copy()) for h in fake.write_history]
        if lead else [],
        finalized=fake.finalized if lead else True,
        launches=counters.launch_counts(),
        calls={k: mesh.calls[k] - calls0[k] for k in calls0}), state


def phase_coupled3d(model, stencil_checksum):
    """`coupled_run` on the stencil3d model: 4 windows x 2 implicit
    iterations against stencil3d's 4 steps; one VTU of the last window.
    Returns (launches, the first window: phase 14's reference)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from dealii_adapter_tpu_torch.utils import write_vtu

    run, state = coupled_window(model)
    windows, wall, writes = run["windows"], run["seconds"], run["writes"]
    launches = read_counts("coupled3d", run["launches"])
    u = state.displacement
    checksum = torch.dot(u.reshape(-1), u.reshape(-1)).item()
    n_windows = round(COUPLED_END / COUPLED_WINDOW)
    log(f"coupled3d: {n_windows} windows x {COUPLED_ITERATIONS} implicit "
        f"iterations in {wall:.3f} s; per window {windows}")
    log(f"coupled3d: write history (t, iteration, ||values||): "
        f"{[(round(h[0], 10), h[1], float(np.linalg.norm(h[2]))) for h in writes]}")
    log(f"coupled3d: launches {launches}")
    require(run["finalized"] and len(windows) == n_windows,
            f"coupled3d: {len(windows)} windows completed")
    require(len(writes) == n_windows * COUPLED_ITERATIONS,
            f"coupled3d: {len(writes)} writes")
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
    first = dict(window=windows[0], writes=writes[:COUPLED_ITERATIONS],
                 lam_max=[lv.lam_max for lv in model._precond.levels])
    return launches, first


def _coupled_shard_rank(mesh, lam_max):
    """One rank of coupled_shard (a spawned process): phase 10's model on
    the lattice partition with the host CG loop, its first window."""
    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)

    t0 = time.perf_counter()
    model = build_model(mesh.device, mg_lam_max=lam_max, cg_loop="host",
                        device_mesh=mesh, mg_level_backend="stencil_vmem",
                        end_time=COUPLED_END)
    build_s = time.perf_counter() - t0
    run, _ = coupled_window(model, mesh)
    return dict(run, rank=mesh.rank, build_s=build_s)


def check_first_window(tag, run, ref, rtol):
    """`run`'s window against phase 10's first (`ref`): the window's time,
    rank 0's write count and write norms and ||u||^2 within `rtol` (0:
    bit for bit, the written values too)."""
    import numpy as np

    w, rw = run["windows"], ref["window"]
    require(len(w) == 1 and w[0]["t"] == rw["t"],
            f"{tag}: windows {[x['t'] for x in w]} against {rw['t']}")
    rel = abs(w[0]["checksum"] - rw["checksum"]) / rw["checksum"]
    log(f"{tag}: window t={w[0]['t']} in {w[0]['seconds']!r} s, Newton "
        f"{w[0]['newton']}, CG {w[0]['cg']} (phase 10: {rw['newton']}, "
        f"{rw['cg']}); ||u||^2 {w[0]['checksum']!r} against phase 10's "
        f"{rw['checksum']!r}: rel. difference {rel:.3e} (limit {rtol})")
    require(rel <= rtol, f"{tag}: ||u||^2 against phase 10's first window")
    if not run["writes"]:
        return
    writes, refs = run["writes"], ref["writes"]
    require(len(writes) == len(refs) == COUPLED_ITERATIONS,
            f"{tag}: {len(writes)} writes against {len(refs)}")
    for (t, it, x), (t0, it0, x0) in zip(writes, refs):
        n, n0 = float(np.linalg.norm(x)), float(np.linalg.norm(x0))
        rel = abs(n - n0) / n0
        log(f"{tag}: write (t={t}, iteration {it}) norm {n!r} against "
            f"{n0!r}: rel. difference {rel:.3e}; bitwise "
            f"{bool(np.array_equal(x, x0))}")
        require(t == t0 and it == it0 and rel <= rtol,
                f"{tag}: write history against phase 10's")
        require(rtol > 0 or np.array_equal(x, x0),
                f"{tag}: write values bit for bit phase 10's")


def phase_coupled_shard(parallel):
    """coupled_shard (phase 14): phase 10's first window on `SHARD_RANKS`
    gloo ranks sharing the card; returns the launches of all ranks."""
    from dealii_adapter_tpu_torch.parallel import spawn

    ref = parallel["coupled"]
    t0 = time.perf_counter()
    out = spawn(_coupled_shard_rank, SHARD_RANKS, "cuda", ref["lam_max"],
                backend="gloo")
    log(f"coupled_shard: {SHARD_RANKS} ranks on the card over gloo, host CG "
        f"loop, ran in {time.perf_counter() - t0:.1f} s (spawn, build and "
        "window)")
    total = {}
    for r in out:
        tag = f"coupled_shard rank {r['rank']}"
        log(f"{tag}: model built in {r['build_s']:.1f} s; window seconds "
            f"{[w['seconds'] for w in r['windows']]}; collectives in the run "
            f"{r['calls']}; launches {r['launches']}; participant "
            f"{'held' if r['writes'] else 'none'}")
        read_counts("coupled_shard", r["launches"])
        check_first_window(tag, r, ref, SHARD_RTOL)
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    require(bool(out[0]["writes"]) and not any(r["writes"] for r in out[1:]),
            "coupled_shard: rank 0 alone holds the participant")
    require(all([w["checksum"] for w in r["windows"]]
                == [w["checksum"] for w in out[0]["windows"]] for r in out),
            "coupled_shard: every rank read the same field")
    return total


def coupled_nccl1(mesh, parallel):
    """coupled_nccl1 (phase 14): phase 10's first window on `mesh`, a world
    of one over NCCL, with the CG graphs and the device Newton loop; bit
    for bit phase 10's first window. Returns the launches."""
    import torch

    ref = parallel["coupled"]
    t0 = time.perf_counter()
    model = build_model(mesh.device, mesh_tags=parallel["mesh_tags"],
                        mg_lam_max=ref["lam_max"], device_mesh=mesh,
                        mg_level_backend="stencil_vmem", end_time=COUPLED_END)
    require(model.cg_loop == "graphs" and model.newton_loop == "graphs",
            "coupled_nccl1: CG graphs and the device Newton loop")
    build_s = time.perf_counter() - t0
    run, _ = coupled_window(model, mesh)
    log(f"coupled_nccl1: model built in {build_s:.1f} s; window in "
        f"{run['seconds']:.3f} s; collectives {run['calls']}; launches "
        f"{run['launches']}")
    launches = read_counts("coupled_nccl1", run["launches"])
    check_first_window("coupled_nccl1", run, ref, 0.0)
    del model
    torch.cuda.empty_cache()
    return launches


def tangent_operator_ms(tag, model, state):
    """Device ms of one application of `model`'s CG operator (one per CG
    iteration) at the iterate `state` leaves it: torch.profiler's and a
    CUDA graph's. For the f32 jvp model, also the f32 assembled tangent's
    matvec (K1) and its assembly at the same iterate."""
    import torch

    dev = model.device
    g = torch.Generator().manual_seed(8)
    K = model._tangent[1].operator
    v = model.mask_t * torch.randn(model.space.n_nodes, model.space.dim,
                                   generator=g).to(dev, model.solve_dtype)
    out = dict(operator_ms=device_ms(lambda: K(v), reps=5, warmup_s=0.1),
               operator_graph_ms=graph_ms(lambda: K(v), reps=5, replays=3))
    jvp32 = not model._use_assembled and model._mixed_tangent
    if jvp32:
        assemble_Kt, make_tangent_matvec = model._make_tangent_fns()
        u32 = state.displacement.to(torch.float32)
        Kt = assemble_Kt(u32)
        K1 = make_tangent_matvec(Kt)
        v32 = v.to(torch.float32)
        out.update(
            assembly_ms=device_ms(lambda: assemble_Kt(u32, out=Kt), reps=3),
            k1_operator_ms=device_ms(lambda: K1(v32), reps=5),
        )
        del Kt, K1
        torch.cuda.empty_cache()
    kind = ("assembled " + model.tangent_kernel if model._use_assembled
            else "jvp")
    log(f"{tag}: CG operator ({kind}, "
        f"{str(model.solve_dtype).replace('torch.', '')}) device time per "
        f"application (= per CG iteration) {out['operator_ms']!r} ms "
        f"(profiler), {out['operator_graph_ms']!r} ms (CUDA graph of 5)"
        + ("" if not jvp32 else
           f"; at the same iterate the f32 assembled tangent's matvec "
           f"(extract -> K1 -> overlap-add, masked) {out['k1_operator_ms']!r} "
           f"ms and its assembly {out['assembly_ms']!r} ms once per Newton "
           f"iteration"))


def phase_jvp(main):
    """The jvp paths (`JVP_PATHS`) on the main path's mesh and lam_max
    values, 1 warmup and 3 timed steps each, with their checks; returns
    {path: launches}."""
    import torch

    from dealii_adapter_tpu_torch.models.nonlinear_elasticity import forward_jvp
    from dealii_adapter_tpu_torch.ops.assembled_tangent import tangent_bytes

    dev = torch.device("cuda")
    x = torch.randn(4096, dtype=torch.float64, device=dev)
    t = torch.randn_like(x)
    # the f64 jvp tangent drops the external force's derivative by
    # detaching its F: pin that forward-mode AD drops a detached tangent
    # on this card's torch
    got = forward_jvp(lambda y: 3.0 * y.detach() + y * y, x, t)
    require(torch.equal(got, 2.0 * x * t),
            "forward_jvp drops the tangent of a detached operand")
    by_path = {}
    for path, overrides in JVP_PATHS.items():
        t0 = time.perf_counter()
        model = build_model(dev, mesh_tags=main["mesh_tags"],
                            mg_lam_max=main["lam_max"], **overrides)
        torch.cuda.synchronize()
        describe(path, model, time.perf_counter() - t0)
        log(f"{path}: tangent "
            f"{'assembled ' + model.tangent_kernel if model._use_assembled else 'jvp'}"
            f", CG in {str(model.solve_dtype).replace('torch.', '')}, sum "
            f"factorization {model._sumfact is not None}, tangent on the "
            f"fine level {model._mg_fine_tangent}; the f32 tangents would "
            f"need {tangent_bytes(model.space, torch.float32) / 1e9:.3f} GB "
            f"(cap {model.params.assembled_tangent_max_gb} GB)")
        torch.cuda.reset_peak_memory_stats()
        stress = interface_traction(model)
        start_counts()
        state, infos, steps, checksum = run_steps(path, model, stress,
                                                  newton_fmt)
        by_path[path] = read_counts(path)
        cg = [i.cg_iterations for i in infos]
        newton = [i.iterations for i in infos]
        rel_main = abs(checksum - main["checksum"]) / main["checksum"]
        log(f"{path}: launches {by_path[path]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"{path}: CG per step {cg}, Newton {newton}, tangent assemblies "
            f"{[i.tangent_assemblies for i in infos]}, host syncs "
            f"{steps['syncs']}; main3d: CG {main['cg']}, Newton "
            f"{main['newton']}; checksum rel. difference to main3d's "
            f"{rel_main:.3e}")
        require(all(i.converged for i in infos), f"{path}: every step converged")
        if path == "jvp3d":
            require(not model._use_assembled,
                    "jvp3d: auto falls back to the jvp tangent")
            require(newton == main["newton"],
                    "jvp3d: Newton counts equal main3d's in every step")
            log(f"jvp3d: checksum {checksum!r} against main3d's "
                f"{main['checksum']!r} (limit {JVP_RTOL})")
            require(rel_main <= JVP_RTOL, "jvp3d: checksum against main3d's")
            main["jvp3d"] = dict(newton=newton, cg=cg, checksum=checksum)
        else:
            check_checksum(path, checksum, CHECKSUM_REF, CHECKSUM_RTOL)
        if path == "f64jvp3d":
            require(model.solve_dtype == torch.float64
                    and not model._use_assembled and model._sumfact is not None,
                    "f64jvp3d: the f64 jvp tangent with sum factorization")
        if path == "reuse_fine3d":
            require(all(n <= m + 2 for n, m in zip(newton, main["newton"])),
                    "reuse_fine3d: Newton counts at most main3d's + 2 a step")
            asm = sum(i.tangent_assemblies for i in infos[1:])
            log(f"reuse_fine3d: tangent assemblies in the timed steps {asm} "
                f"against {sum(newton[1:])} Newton iterations")
            require(asm < sum(newton[1:]),
                    "reuse_fine3d: fewer assemblies than Newton iterations")
        else:
            tangent_operator_ms(path, model, state)
        newton_host_twin(path, model, stress, infos, checksum)
        del model, state
        torch.cuda.empty_cache()
    return by_path


def phase_cli_nl():
    """`python -m dealii_adapter_tpu_torch` on the reference's own
    Neo-Hookean configuration (`NL_DEFAULT_PRM` cut to 3 steps by
    `nl_default_prm`) in a subprocess: every window converged (else the
    CLI exits non-zero), a VTU file of each, and the final ||u||^2 against
    the JAX package's; returns the launch counts it prints."""
    import ast
    import os
    import pathlib
    import sys
    import tempfile

    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        prm = os.path.join(tmp, "nonlinear_elasticity.prm")
        pathlib.Path(prm).write_text(
            nl_default_prm((root / NL_DEFAULT_PRM).read_text(), out))
        env = dict(os.environ, PYTHONPATH=str(root))
        ts = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "dealii_adapter_tpu_torch", prm,
             "--standalone", "--traction", *NL_DEFAULT_TRACTION],
            cwd=root, env=env, capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - ts
        for line in r.stdout.splitlines():
            log(f"cli_nl| {line}")
        require(r.returncode == 0,
                f"cli_nl: exit code {r.returncode}: {r.stderr[-2000:]}")
        files = sorted(os.listdir(out))
        log(f"cli_nl: exit code 0 in {wall:.1f} s (process start included), "
            f"VTU files {files}")
    n_steps = round(NL_DEFAULT_END / 0.01)
    require(files == [f"solution-2d-{i}.vtu" for i in range(1, n_steps + 1)],
            f"cli_nl: files {files}")
    lines = r.stdout.splitlines()
    checksum = float(next(x for x in lines if x.startswith("final ||u||^2: "))
                     .split(": ")[1])
    rel = abs(checksum - NL_DEFAULT_REF) / NL_DEFAULT_REF
    log(f"cli_nl: final ||u||^2 {checksum!r}, rel. difference to the JAX "
        f"package's {NL_DEFAULT_REF!r}: {rel:.3e} (limit {NL_DEFAULT_RTOL})")
    require(rel <= NL_DEFAULT_RTOL, "cli_nl: final ||u||^2 against the JAX package's")
    line = next(x for x in lines if x.startswith("kernel launches: "))
    return read_counts("cli_nl", ast.literal_eval(line[len("kernel launches: "):]))


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
    launches = read_counts("cli", ast.literal_eval(line[len("kernel launches: "):]))
    return launches, final_u2(r.stdout)


def final_u2(text):
    """The CLI's closing `final ||u||^2:` value."""
    line = next(x for x in text.splitlines() if x.startswith("final ||u||^2: "))
    return float(line[len("final ||u||^2: "):])


def phase_cli_ranks(cli_u2):
    """cli_ranks (phase 14): `CLI_PRM` under `torchrun --standalone
    --nproc-per-node CLI_RANKS -m dealii_adapter_tpu_torch ... --devices
    CLI_RANKS` in a subprocess; returns rank 0's launch counts."""
    import ast
    import pathlib
    import sys

    import torch

    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        prm = os.path.join(tmp, "case.prm")
        pathlib.Path(prm).write_text(CLI_PRM.format(out=out))
        env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
        ts = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(CLI_RANKS), "-m",
             "dealii_adapter_tpu_torch", prm, "--standalone", "--traction",
             "1000", "0", "--refine", str(CLI_REFINE), "--devices",
             str(CLI_RANKS)],
            cwd=root, env=env, capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - ts
        for line in r.stdout.splitlines():
            log(f"cli_ranks| {line}")
        require(r.returncode == 0,
                f"cli_ranks: exit code {r.returncode}: {r.stderr[-3000:]}")
        files = sorted(os.listdir(out))
        log(f"cli_ranks: exit code 0 in {wall:.1f} s (torchrun and both "
            f"ranks' start included), VTU files "
            f"{[(f, os.path.getsize(os.path.join(out, f))) for f in files]}")
    text = r.stdout
    require(text.count("running dealii_adapter_tpu_torch") == 1,
            "cli_ranks: one banner (rank 0's)")
    require(torch.cuda.get_device_name(0) in text, "cli_ranks: banner names the card")
    require(f"{CLI_RANKS} ranks over gloo; CG loop: host" in text,
            "cli_ranks: banner names the ranks and the host CG loop")
    require(files == ["solution-2d-1.vtu", "solution-2d-2.vtu"]
            and "2 VTU files" in text, f"cli_ranks: files {files}")
    u2 = final_u2(text)
    rel = abs(u2 - cli_u2) / cli_u2
    log(f"cli_ranks: final ||u||^2 {u2!r} against the cli phase's {cli_u2!r}: "
        f"rel. difference {rel:.3e} (limit {CLI_RANKS_RTOL})")
    require(rel <= CLI_RANKS_RTOL, "cli_ranks: final ||u||^2 against cli's")
    line = next(x for x in text.splitlines() if x.startswith("kernel launches: "))
    return read_counts("cli_ranks", ast.literal_eval(line[len("kernel launches: "):]))


def phase_golden_nl():
    """golden_nl (phase 14): the Neo-Hookean golden tip trajectories on the
    card (`GOLDEN_NL_CASES`); returns the launches."""
    import pathlib

    import numpy as np
    import torch

    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
        NonlinearElasticity,
    )

    path = pathlib.Path(__file__).resolve().parent / "tests" / "golden_trajectories.json"
    goldens = json.loads(path.read_text())
    dev = torch.device("cuda")
    start_counts()
    for key, (changes, magnitude) in GOLDEN_NL_CASES.items():
        golden = goldens[key]
        t0 = time.perf_counter()
        model = NonlinearElasticity(
            AllParameters(**dict(GOLDEN_NONLINEAR, **changes)), device=dev)
        nodes = model.space.mesh.nodes
        target = np.zeros(2)
        target[1] = nodes[:, 1].max()
        tip = int(np.argmin(((nodes - target) ** 2).sum(axis=1)))
        stress = np.zeros((model.space.n_nodes, 2))
        stress[model.space.boundary_nodes[model.interface_id], 0] = magnitude
        stress = torch.as_tensor(stress, dtype=model.dtype, device=dev)
        state, traj, newton, cg = model.initial_state(), [], 0, 0
        for _ in range(len(golden)):
            state, info = model.step(state, stress)
            require(info.converged, f"golden_nl {key}: a step converged")
            traj.append(float(state.displacement[tip, 0]))
            newton += info.iterations
            cg += info.cg_iterations
        rel = float(np.max(np.abs(np.subtract(traj, golden)) / np.abs(golden)))
        log(f"golden_nl: {key} ({len(golden)} steps, {model.space.n_dofs} DoF, "
            f"{model.params.type_lin}, {newton} Newton and {cg} CG "
            f"iterations) in {time.perf_counter() - t0:.1f} s: max rel. "
            f"difference {rel:.3e} (limit {GOLDEN_NL_RTOL}); tip {traj[-1]!r} "
            f"vs {golden[-1]!r}")
        require(rel <= GOLDEN_NL_RTOL, f"golden_nl: {key} trajectory")
        del model, state
    return read_counts("golden_nl")


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


def phase_gather3d(main):
    """Phase 4's configuration with `element_backend="gather"` on its mesh
    and lam_max values (phase 13); returns its launches."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(dev, mesh_tags=main["mesh_tags"],
                        mg_lam_max=main["lam_max"], element_backend="gather")
    torch.cuda.synchronize()
    describe("gather3d", model, time.perf_counter() - t0)
    require(not model._use_assembled and model.plan is not None,
            "gather3d: the gather plan with the jvp tangent")
    stress = interface_traction(model)
    start_counts()
    _, infos, steps, checksum = run_steps("gather3d", model, stress, newton_fmt)
    launches = read_counts("gather3d")
    ref = main["jvp3d"]
    newton = [i.iterations for i in infos]
    rel = abs(checksum - ref["checksum"]) / ref["checksum"]
    log(f"gather3d: launches {launches}; CG per step "
        f"{[i.cg_iterations for i in infos]}, Newton {newton}; jvp3d: CG "
        f"{ref['cg']}, Newton {ref['newton']}; checksum {checksum!r} against "
        f"jvp3d's {ref['checksum']!r}: rel. difference {rel:.3e} (limit "
        f"{JVP_RTOL})")
    require(all(i.converged for i in infos), "gather3d: every step converged")
    require(newton == ref["newton"], "gather3d: Newton counts equal jvp3d's")
    require(rel <= JVP_RTOL, "gather3d: checksum against jvp3d's")
    newton_host_twin("gather3d", model, stress, infos, checksum)
    del model
    torch.cuda.empty_cache()
    return launches


def slab_kernel_checks(model, seed):
    """K5 (the fine proxy), K3 (each distributed Q1 level) and K1 at this
    rank's slab shapes against their plain versions, on seeded random
    inputs: bf16 in and f32 out, the variant the lattice partition runs
    for the bf16 V-cycle (its partial sums stay f32), limit 1e-5 (the f32
    accumulation; K5's split E is ~2.3e-6 relative); and f32 and bf16 I/O
    at phase 3's limits. Not counted."""
    import torch

    from dealii_adapter_tpu_torch.ops import assembled_tangent as at
    from dealii_adapter_tpu_torch.parallel.lattice import SlabOperator

    dev = model.device
    g = torch.Generator(device=dev).manual_seed(seed)
    ops = [("K5 q2_structured", model._fine_proxy.op, K5_BF16_RTOL)]
    ops += [("K3 q1_structured", lv.raw.op, 1e-2)
            for lv in model._precond.levels[1:] if isinstance(lv.raw, SlabOperator)]
    rows = []
    f32, bf16 = torch.float32, torch.bfloat16
    for name, op, bf16_tol in ops:
        for dtype, out, tol in ((bf16, f32, 1e-5), (f32, f32, 1e-5),
                                (bf16, bf16, bf16_tol)):
            x = torch.randn(op._u_shape, generator=g, device=dev).to(dtype)
            max_abs, rel = compare(op(x, out_dtype=out), op.plain(x, out))
            io = "->".join(str(t).replace("torch.", "") for t in (dtype, out))
            rows.append(dict(name=name, shape=list(op.grid_shape), dtype=io,
                             max_abs_err=max_abs, rel_l2_err=rel, limit=tol,
                             ms=cuda_ms(lambda: op(x, out_dtype=out))))
            require(rel <= tol, f"{name} at the slab {op.grid_shape} {io}: "
                    f"rel. L2 error {rel:.3e} > {tol}")
    edofs = 3 * model.space.tab.n_nodes
    n_cells = math.prod(model._lat.slab_reps)
    KT = torch.randn((edofs, edofs, n_cells), generator=g, device=dev)
    u2 = torch.randn((edofs, n_cells), generator=g, device=dev)
    max_abs, rel = compare(at.apply_packed_tangents_T(KT, u2),
                           at.apply_packed_tangents_T_plain(KT, u2))
    rows.append(dict(name="K1 tangent_matvec", shape=[edofs, edofs, n_cells],
                     dtype="float32", max_abs_err=max_abs, rel_l2_err=rel,
                     limit=1e-5,
                     ms=cuda_ms(lambda: at.apply_packed_tangents_T(KT, u2))))
    require(rel <= 1e-5, f"K1 at {n_cells} cells: rel. L2 error {rel:.3e}")
    return rows


def _shard3d_rank(mesh, lam_max, n_steps, scale=None):
    """One rank of shard3d (a spawned process): the slab checks, then
    `n_steps` steps of phase 4's configuration (at `scale`, by default
    phase 4's) on the lattice partition with the host CG loop; returns
    what the parent checks and logs (also `tools/port_shard_steps.py`'s,
    which runs it on the CPU too)."""
    import torch

    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
    from dealii_adapter_tpu_torch.kernels import counters

    dev = mesh.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    model = build_model(dev, scale=scale, mg_lam_max=lam_max, cg_loop="host",
                        device_mesh=mesh)
    lat = model._lat
    out = dict(rank=mesh.rank, build_s=time.perf_counter() - t0,
               axis=lat.axis, slab=lat.slab_shape, owned=(lat.lo, lat.hi),
               levels=[(lv.grid_shape, lv.layout.slab_shape if lv.layout else None)
                       for lv in model._precond.levels],
               checks=slab_kernel_checks(model, 11 + mesh.rank))
    stress = model.local_rows(interface_traction(model))
    if cuda:
        start_counts()
    else:  # the CPU rehearsal: no library to bind
        counters.reset()
    state = model.initial_state()
    for k in ("newton", "cg", "converged", "min_det_F", "times", "checksums",
              "calls"):
        out[k] = []
    for _ in range(n_steps):
        sync()
        calls0 = dict(mesh.calls)
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        sync()
        out["times"].append(time.perf_counter() - ts)
        out["calls"].append({k: mesh.calls[k] - calls0[k] for k in calls0})
        u = state.displacement.reshape(-1)
        out["checksums"].append(float(mesh.all_reduce(torch.dot(u, u))))
        out["newton"].append(info.iterations)
        out["cg"].append(info.cg_iterations)
        out["converged"].append(info.converged)
        out["min_det_F"].append(info.min_det_F)
    out["launches"] = counters.launch_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    return out


def phase_shard3d(main, records):
    """shard3d (phase 13): the lattice partition at full size on
    `SHARD_RANKS` gloo ranks sharing the card; the slab checks go into the
    kernel records (`slab_checks`); returns the launches of all ranks."""
    from dealii_adapter_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    out = spawn(_shard3d_rank, SHARD_RANKS, "cuda", main["lam_max"],
                SHARD3D_STEPS, backend="gloo")
    ref = main["checksums"][SHARD3D_STEPS - 1]  # main3d's after that step
    log(f"shard3d: {SHARD_RANKS} ranks on the card over gloo, host CG loop, "
        f"ran in {time.perf_counter() - t0:.1f} s (spawn, build and steps)")
    by_name = {rec["name"]: rec for rec in records}
    total = {}
    for r in out:
        tag = f"shard3d rank {r['rank']}"
        log(f"{tag}: model built in {r['build_s']:.1f} s; split axis "
            f"{r['axis']}, owned planes {r['owned']}, slab {r['slab']}; levels "
            f"(lattice, slab or None = replicated) {r['levels']}")
        for c in r["checks"]:
            log(f"{tag}: {c['name']} at the slab {c['shape']} {c['dtype']}: "
                f"max abs err {c['max_abs_err']:.3e}, rel. L2 "
                f"{c['rel_l2_err']:.3e} (limit {c['limit']}); {c['ms']:.4f} ms "
                "a call (CUDA events, median of 15; ranks share the card)")
            by_name[c["name"]].setdefault("slab_checks", []).append(
                dict(c, rank=r["rank"], ranks=SHARD_RANKS))
        log(f"{tag}: step times {r['times']} s (ranks sharing one card, not "
            f"a scaling result); Newton {r['newton']}, CG {r['cg']} (main3d: "
            f"{main['newton']}, {main['cg']}); min_det_F {r['min_det_F']}; "
            f"collectives a step {r['calls']}; checksums {r['checksums']}; "
            f"peak device memory {r['peak_gib']:.2f} GiB")
        read_counts("shard3d", r["launches"])
        log(f"{tag}: launches {r['launches']}")
        rel = abs(r["checksums"][-1] - ref) / ref
        log(f"{tag}: checksum {r['checksums'][-1]!r} against main3d's "
            f"{ref!r} after step {SHARD3D_STEPS - 1}: rel. difference "
            f"{rel:.3e} (limit {SHARD_RTOL})")
        require(all(r["converged"]), f"{tag}: every step converged")
        require(r["newton"] == main["newton"][:SHARD3D_STEPS],
                f"{tag}: Newton counts equal main3d's")
        require(all(abs(a - b) <= SHARD_CG_SLACK for a, b in zip(r["cg"], main["cg"])),
                f"{tag}: CG within {SHARD_CG_SLACK} a step of main3d's")
        require(rel <= SHARD_RTOL, f"{tag}: checksum against main3d's")
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    require(all(r["checksums"] == out[0]["checksums"]
                and r["newton"] == out[0]["newton"] for r in out),
            "shard3d: every rank read the same reduced values")
    return total


def phase_shard3d_nccl1(main):
    """shard3d_nccl1 (phase 13): a world of one on NCCL in this process,
    the CG in CUDA graphs, bit for bit phase 4; then shard_cells'
    configuration on that world, its one-rank reference, and phase 14's
    coupled_nccl1. Returns (launches, the reference, coupled_nccl1's
    launches)."""
    import torch
    import torch.distributed as dist

    from dealii_adapter_tpu_torch.parallel import make_device_mesh

    dev = torch.device("cuda", 0)
    init = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_nccl1_"), "init")
    dist.init_process_group("nccl", init_method="file://" + init,
                            world_size=1, rank=0)
    try:
        mesh = make_device_mesh(1, device=dev)
        t0 = time.perf_counter()
        model = build_model(dev, mesh_tags=main["mesh_tags"],
                            mg_lam_max=main["lam_max"], device_mesh=mesh)
        torch.cuda.synchronize()
        describe("shard3d_nccl1", model, time.perf_counter() - t0)
        require(model.cg_loop == "graphs" and mesh.backend == "nccl",
                "shard3d_nccl1: NCCL, the CG in CUDA graphs")
        stress = model.local_rows(interface_traction(model))
        start_counts()
        _, infos, _, checksum = run_steps("shard3d_nccl1", model, stress,
                                          newton_fmt)
        launches = read_counts("shard3d_nccl1")
        newton = [i.iterations for i in infos]
        cg = [i.cg_iterations for i in infos]
        log(f"shard3d_nccl1: launches {launches}; CG {cg}, Newton {newton}; "
            f"checksum {checksum!r}, main3d's {main['checksum']!r}; bitwise "
            f"{checksum == main['checksum']}; collectives {mesh.calls} (Python "
            f"calls: those in the CG graphs counted once, at capture)")
        require(newton == main["newton"] and cg == main["cg"]
                and checksum == main["checksum"],
                "shard3d_nccl1: CG, Newton and checksum bit for bit main3d's")
        del model
        torch.cuda.empty_cache()
        model = build_model(dev, scale=SHARD_CELLS_SCALE, device_mesh=mesh,
                            **SHARD_CELLS)
        stress = model.local_rows(interface_traction(model))
        state, infos, steps, cells = run_steps(
            "shard_cells one rank", model, stress, newton_fmt,
            state=model.initial_state(), n=SHARD_CELLS_STEPS)
        ref = dict(checksum=cells, newton=[i.iterations for i in infos],
                   cg=[i.cg_iterations for i in infos], times=steps["times"],
                   n_dofs=model.space.n_dofs)
        del model, state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        coupled = coupled_nccl1(mesh, main)
        log(f"coupled_nccl1: took {time.perf_counter() - t0:.1f} s")
    finally:
        dist.destroy_process_group()
    return launches, ref, coupled


def _shard_cells_rank(mesh):
    import torch

    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
    from dealii_adapter_tpu_torch.kernels import counters

    model = build_model(mesh.device, scale=SHARD_CELLS_SCALE, cg_loop="host",
                        device_mesh=mesh, **SHARD_CELLS)
    stress = model.local_rows(interface_traction(model))
    start_counts()
    state = model.initial_state()
    out = dict(rank=mesh.rank, newton=[], cg=[], times=[], converged=[])
    for _ in range(SHARD_CELLS_STEPS):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        torch.cuda.synchronize()
        out["times"].append(time.perf_counter() - ts)
        out["newton"].append(info.iterations)
        out["cg"].append(info.cg_iterations)
        out["converged"].append(info.converged)
    u = state.displacement.reshape(-1)
    out["checksum"] = float(torch.dot(u, u))  # replicated
    out["launches"] = counters.launch_counts()
    out["calls"] = dict(mesh.calls)
    return out


def phase_shard_cells(ref):
    """shard_cells (phase 13): the cell partition on `SHARD_RANKS` gloo
    ranks sharing the card against its one-rank reference; returns the
    launches of all ranks."""
    from dealii_adapter_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    out = spawn(_shard_cells_rank, SHARD_RANKS, "cuda", backend="gloo")
    log(f"shard_cells: {SHARD_RANKS} ranks over gloo at scale "
        f"{SHARD_CELLS_SCALE} ({ref['n_dofs']} DoF), host CG loop, ran in "
        f"{time.perf_counter() - t0:.1f} s (spawn, build and steps)")
    total = {}
    for r in out:
        tag = f"shard_cells rank {r['rank']}"
        rel = abs(r["checksum"] - ref["checksum"]) / ref["checksum"]
        log(f"{tag}: step times {r['times']} s; Newton {r['newton']}, CG "
            f"{r['cg']} (one rank: {ref['newton']}, {ref['cg']}, "
            f"{ref['times']} s); collectives {r['calls']}; checksum "
            f"{r['checksum']!r} against one rank's {ref['checksum']!r}: rel. "
            f"difference {rel:.3e} (limit {SHARD_RTOL})")
        read_counts("shard_cells", r["launches"])
        require(all(r["converged"]), f"{tag}: every step converged")
        require(r["newton"] == ref["newton"], f"{tag}: Newton counts equal")
        require(all(abs(a - b) <= SHARD_CG_SLACK * n
                    for a, b, n in zip(r["cg"], ref["cg"], r["newton"])),
                f"{tag}: CG within {SHARD_CG_SLACK} a solve")
        require(rel <= SHARD_RTOL, f"{tag}: checksum against one rank's")
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def phase_dryrun():
    """dryrun (phase 13): `dryrun_multichip(SHARD_RANKS, "cuda")`; returns
    the launches of all ranks."""
    from dealii_adapter_tpu_torch.parallel.dryrun import dryrun_multichip

    info = dryrun_multichip(SHARD_RANKS, "cuda")
    log(f"dryrun: {info}")
    total = {}
    for launches in info["launches"]:
        read_counts("dryrun", launches)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


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
    by_path.update(timed("bench", phase_bench))
    by_path.update(timed("tangent3d", phase_tangent3d, main_run))
    by_path.update(timed("jvp", phase_jvp, main_run))
    by_path["stencil3d"], model, checksum = timed(
        "stencil3d", phase_stencil3d, main_run)
    parallel = {k: main_run[k] for k in ("mesh_tags", "lam_max", "checksum",
                                         "checksums", "cg", "newton", "jvp3d")}
    del main_run
    by_path["coupled3d"], parallel["coupled"] = timed(
        "coupled3d", phase_coupled3d, model, checksum)
    del model
    torch.cuda.empty_cache()
    by_path["linear2d"] = timed("linear2d", phase_linear2d, args.profile)
    by_path["nonlinear2d"] = timed("nonlinear2d", phase_nonlinear2d, args.profile)
    by_path.update(timed("vcycle_bf16", phase_vcycle_bf16))
    by_path["cli"], cli_u2 = timed("cli", phase_cli)
    by_path["cli_nl"] = timed("cli_nl", phase_cli_nl)
    by_path["cli_ranks"] = timed("cli_ranks", phase_cli_ranks, cli_u2)
    by_path["golden_nl"] = timed("golden_nl", phase_golden_nl)
    by_path["gather3d"] = timed("gather3d", phase_gather3d, parallel)
    by_path["shard3d"] = timed("shard3d", phase_shard3d, parallel, records)
    by_path["shard3d_nccl1"], cells_ref, by_path["coupled_nccl1"] = timed(
        "shard3d_nccl1", phase_shard3d_nccl1, parallel)
    by_path["shard_cells"] = timed("shard_cells", phase_shard_cells, cells_ref)
    by_path["dryrun"] = timed("dryrun", phase_dryrun)
    by_path["coupled_shard"] = timed("coupled_shard", phase_coupled_shard,
                                     parallel)
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
