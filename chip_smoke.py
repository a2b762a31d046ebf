#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU, and its
multi-rank paths on 2 and up to 4 cards where the machine has them.

    python3 chip_smoke.py [--profile] [--cards N]

`--cards N` runs the device, build and kernels phases, the one-card
references of the separate-card phases (main, stencil3d, coupled3d,
f64mg, cli and shard3d_nccl1), cli_ranks and dryrun (the two shared-card
phases that would pick NCCL on several cards were they not pinned to gloo
and card 0) and the separate-card phases (17) at worlds 2 and N; it fails
where fewer than N cards are visible. Without it every
phase runs, the separate-card phases at worlds 2 and min(4, cards) where
2 or more cards are visible; on one card they print a line saying so and
do not run.

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
   bytes), with the f32-FMA bound beside it. The f64 instantiation of the
   Q1 level kernels (`f64_level_records`: records `K3 q1_structured f64`,
   `K4 q1_plane f64`, `K4b q1_structured_2d f64`, `K6 q1_stencil f64`)
   at every Q1 level lattice of the f64 paths (`F64_LEVELS_3D`,
   `F64_LEVELS_2D`) on seeded f64 inputs: within 1e-12 relative L2 of
   the plain version (`F64_RTOL`), K4 and K6 bit for bit K3's (K4b's);
   device and per-call times; the bound at f64's 34 TFLOP/s
   (`F64_FLOPS`) and the f64 CSR SpMV library time.
4. main    — `NonlinearElasticity` with the benchmark configuration
   (`bench_torch.py:build_model`, bench.py's: 3D Neo-Hookean perpendicular
   flap, Q2, scale 9: 1,018,875 DoF), traction 1000 in x on the
   interface, its CG in CUDA graphs, on one model with the bodies of its
   one Newton loop (residuals, tangent assembly, decisions and update;
   one read-back a Newton pass) replayed from CUDA graphs (path main3d)
   and run eagerly (path `main3d newton eager`: the runner's `eager`
   switch, the CG still in its graphs), in turns: 1 warmup and 3 timed
   Newmark steps from rest with each (eager, then graphs), then 3 more
   timed steps of each in the reverse order.
   Every step must converge and the checksum ||u||^2 after step 3 must
   lie within rtol 1e-4 of the JAX package's 49.05486138743322 (Newton's
   tol_u of 1e-6 bounds the spread near 1e-5); the two must give the
   same `NewtonInfo` in every step and their checksums after steps 3 and
   6 agree within 1e-12 relative (`LOOPS_RTOL`), and both must read back
   at most their Newton iterations + 1 a step outside the CG. For each:
   every step's time (unrounded), host syncs (the CG's apart) and kernel
   launches, the peak device memory of its first 4 steps, and, after all
   timed steps, the device busy share of one more step under
   torch.profiler tracing the card only (`--profile` prints its kernel
   table). Then a model of its own with `cg_loop="host"` (the Newton
   loop's bodies and the CG chunks, the same `ChunkedCG`, run eagerly;
   path `main3d host`), on the same mesh and lam_max values, 1 warmup
   and 1 timed step from rest (`MAIN_HOST_STEPS`): the same `NewtonInfo`
   as main3d's in both steps, ||u||^2 within `LOOPS_RTOL` of main3d's
   after step 1 (bit for bit expected; logged), and at most Newton
   iterations + 2 read-backs a step outside the CG (`host_outside`).
   Then the same once more with the host-loop `cg_solve` as the model's
   CG (path `main3d oracle`: `cg_solve_oracle` replaces the `make_cg`
   the model's module imported while the model steps; the package builds
   no such solve), so that the CG graphs stay held against the plain
   loop at full size: the same `NewtonInfo` as main3d's, ||u||^2 within
   `LOOPS_RTOL`.
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
     not;
   - f64mg3d — f64jvp3d with the f64 multigrid hierarchy (`F64_MG`:
     `precond_dtype=""`) on its own lam_max estimates: K3's f64
     instantiation on every Q1 level (levels among phase 3's lattices),
     the plain f64 fine proxy (K5, K1 and K3's f32/bf16 form not
     launched); ||u||^2 within rtol 1e-4 of the JAX package's value, CG
     and Newton counts beside f64jvp3d's; one V-cycle of the hierarchy on
     a seeded vector within 1e-12 relative L2 of the same hierarchy built
     on the CPU from the same lam_max values (`f64_hierarchy_check`),
     with its device time.
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
   and lam_max values (the shared-card phases put their gloo ranks on
   card 0, and cli_ranks' torchrun sees card 0 alone, so that they run
   the path their name says on any machine; a time of two ranks sharing
   a card is not a scaling result):
   - gather3d — `element_backend="gather"` (the jvp tangent of the
     gather-plan internal force, bf16 V-cycle with K5 and K3), 1 warmup
     and 3 timed steps: Newton counts equal to jvp3d's in every step,
     ||u||^2 within rtol 1e-6 (`JVP_RTOL`) of jvp3d's;
   - shard3d — the lattice partition (`parallel/lattice.py`) at full
     size on `SHARD_RANKS` ranks spawned on the card over gloo (the
     kernels built once before the spawn), the eager CG (gloo cannot
     be captured); each rank first holds K5, K3 (every distributed level,
     also in f64) and K1 at its slab's shapes against their plain
     versions, then runs `SHARD3D_STEPS` steps (1 warmup and 1 timed:
     cut from 4 steps, ~6.5 s each, to keep the script within its time):
     every step converged,
     Newton counts equal to phase 4's, CG within +-2 (`SHARD_CG_SLACK`) a
     step, ||u||^2 after every step within rtol 1e-7 (`SHARD_RTOL`,
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
   - dryrun — `parallel/dryrun.py:dryrun_multichip(SHARD_RANKS, "cuda",
     backend="gloo")`: converged, det F > 0, K1, K3 and K5 launched on
     every rank.
14. the coupled run and the CLI on several ranks, and the Neo-Hookean
   golden trajectories:
   - coupled_shard — phase 10's coupled run (phase 9's configuration, K6
     on every Q1 level, phase 4's lam_max values) on the lattice partition
     on `SHARD_RANKS` gloo ranks sharing the card, the eager CG, cut
     to its first window (window 0.01, 2 implicit iterations, so one
     rollback; 2 steps of ~6.5 s: the 4 windows would cost about a
     minute); rank 0 alone holds the participant: the window's time and
     write count equal phase 10's first window, rank 0's write-history
     norms and ||u||^2 within `SHARD_RTOL` of it; each rank's launches,
     collectives and seconds a window;
   - coupled_nccl1 — the same window on a world of one over NCCL in the
     script's own process, with the CG and the Newton loop's bodies in
     CUDA graphs:
     the write history and ||u||^2 bit for bit phase 10's first window;
   - cli_ranks — `torchrun --standalone --nproc-per-node 2 -m
     dealii_adapter_tpu_torch` on `CLI_PRM` with `--devices 2` in a
     subprocess (gloo ranks sharing the card, the eager CG): exit code
     0, one banner, naming the card, 2 ranks and `CG loop: host`, each
     VTU file written once, at most CG iterations + 2 read-backs a step
     (the step lines' `read_backs`, printed), the final ||u||^2 within
     1e-9 (`CLI_RANKS_RTOL`) of phase 11's; rank 0's closing `kernel
     launches` line gives the path's counts;
   - golden_nl — the recorded Neo-Hookean golden tip trajectories
     (`nonlinear_pf_q2`: 2D PF, Q2, the f64 Jacobi CG on the f64 jvp
     tangent, 518 DoF, traction 5000; `nonlinear_pf_q4`: Q4, dense Direct
     Newton solves, 1,898 DoF, traction 2000; tests/test_golden_trajectory.py's
     configuration), 20 steps each, every step converged and the tip
     within rtol 1e-7 of tests/golden_trajectories.json; C1/C2 and no
     other kernel launched.
15. linear_loops (run after linear2d) — the one linear step (one
   function, `LinearElastodynamics._step`) replayed (`cg_loop="graphs"`,
   the default of every linear path: its right-hand side, the
   defect-correction loop around the CG chunks and the update from CUDA
   graphs, the refinement decisions on the card) against the same step
   eager (`cg_loop="host"`: the same bodies run eagerly, nothing
   captured, as gloo ranks run it) on each of `LINEAR_CELLS`
   (bench_linear_q2, bench_linear_q3, linear2d) at full size, two models
   on one mesh: 1 warmup and 3 timed steps each, then one profiled step
   of each (`profile_timeline`: device time by kernel group, launches,
   busy share, read-backs and the idle gaps after them): the same
   `StepInfo` in every step and the states bit for bit, every residual
   <= 1e-10, each form's read-backs at most its CG iterations + 2 a step
   (one a chunk of 1 iteration, plus at most one masked chunk where the
   host guessed that the refinements go on and they ended, plus at most
   one read after a refinement where it guessed the end; CG + 1 where
   the guess is right); each form's step times and read-backs (paths
   `linear_loops <cell>` and `linear_loops <cell> eager`); then the first
   step from rest against `oracle_linear_step` (the public host loops
   `ir_cg_solve` around `cg_solve`, on the card): the same `StepInfo`
   and the velocity bit for bit; then one step of the replayed model's
   subcycling clone (half the step), with the peak device memory before
   and after it.
16. f64mg (run after linear_loops) — the linear model with the f64
   multigrid hierarchy (`phase_f64mg`): f64mg2d (`LINEAR_2D`, 999,362
   DoF, K4b in f64 on every Q1 level, replayed and eager on one mesh,
   bit for bit, ||u||^2 against the JAX package's `F64MG2D_REF`) and
   f64mg_stencil (bench_linear_q2, 97,875 DoF, `mg_level_backend=
   "stencil"`: K6 in f64 on every Q1 level, K3 never; against the same
   cell on K3 in f64 within 1e-10 and the JAX package's
   `F64MG_STENCIL_REF`), 1 warmup and 3 timed steps each, every residual
   <= 1e-10. The K3 twin (`f64mg_stencil auto`) is the one-device
   reference of the f64 hierarchy on the lattice partition:
   - f64mg_nccl1 (run in shard3d_nccl1's world of one on NCCL, in the
     script's own process) — the same cell, mesh and lam_max values,
     the CG and the step's bodies in CUDA graphs (the f64 all-reduces
     captured): `StepInfo` and ||u||^2 after every step bit for bit
     `f64mg_stencil auto`'s;
   - f64mg_shard (run after shard_cells) — the same cell on
     `SHARD_RANKS` gloo ranks sharing the card (`cg_loop="host"`: the
     step's bodies and the f64 `ChunkedCG` eager), each rank's hierarchy
     on its own lam_max estimates (the power iterations through the
     all-reduced inner product), within `F64MG_LAM_RTOL` of one
     device's; each rank first holds K3's f64 instantiation at its
     slabs' shapes against the plain version (`slab_f64_checks`,
     `F64_RTOL`; into the kernel record's `slab_checks`), then runs 1
     warmup and 3 timed steps: every residual <= 1e-10, CG within
     `SHARD_CG_SLACK` a step of `f64mg_stencil auto`'s and ||u||^2
     within `F64MG_SHARD_RTOL` of its after every step; each rank's
     launches (K3 f64 and C1/C2, no other), collectives a step, step
     times and read-backs.
17. the separate-card phases (at least 2 cards visible; worlds 2 and
   min(4, cards), or 2 and `--cards N`): ranks spawned one a card over
   NCCL, each on its own card (made current by `make_device_mesh`), the
   lattice partition's halo exchanges as NCCL send/recv between
   neighbours, every CG chunk and Newton or linear body replayed from
   CUDA graphs (the collectives captured). One spawn a world runs, in
   order on every rank (`_cards_rank`):
   - shard3d_cards — main3d's configuration (1,018,875 DoF) on the
     lattice partition, the slab checks first, 1 warmup and 3 timed steps
     (`CARD_STEPS`): Newton equal to main3d's a step, CG within
     `SHARD_CG_SLACK`, ||u||^2 after every step within `SHARD_RTOL`; the
     per-card step time (median of the timed steps, each rank) beside
     main3d's from this run, read-backs and collectives a step, peak
     memory per card; then the same steps with the halo exchanges as the
     slot all-reduce (path `shard3d_cards <w> all_reduce`,
     `RankGroup.slot_exchange`): the same rules, NewtonInfo equal to the
     p2p run's and ||u||^2 within `LOOPS_RTOL` (bitwise logged), its
     per-card step time beside p2p's; then the same world with
     `cg_loop="host"` (path
     `shard3d_cards <w> host`, `CARD_HOST_STEPS`): NewtonInfo equal to
     the graphs run's and ||u||^2 within `LOOPS_RTOL` (bitwise logged);
   - exchange_cards — on shard3d_cards' model, one halo fill and one
     interface sum at the fine lattice and at the FEM-SEM level (the
     first Q1 level, same nodes), p2p against the slot all-reduce on the
     same input: bit for bit; each one's bytes and CUDA-event time
     (median of 15, the slowest rank), eager and replayed from a CUDA
     graph (the replay bit for bit the eager call);
   - f64mg_cards — f64mg_shard's cell on the CUDA graphs: CG equal to one
     device's a step, ||u||^2 within `F64MG_CARDS_RTOL`;
   - shard_cells_cards — the cell partition against shard_cells' one-rank
     reference, shard_cells' rules;
   - coupled_cards — coupled_shard's window, its rules (rank 0 holds the
     participant);
   then, at the largest world, cli_cards (`torchrun --nproc-per-node W -m
   dealii_adapter_tpu_torch ... --devices W`: the banner says NCCL and
   the CUDA graphs, ||u||^2 within `CLI_RANKS_RTOL` of the cli phase's)
   and dryrun_cards (`dryrun_multichip(W, "cuda")`, NCCL, the CG graphs).
   Each path's launches are each rank's, counted from `start_counts`.

Every path but `main3d host`, `main3d oracle`, shard3d, shard_cells,
dryrun, coupled_shard, cli_ranks, f64mg_shard, f64mg2d eager and the
eager forms of linear_loops (`cg_loop="host"`: the Newton loop's or the
linear step's bodies and the CG chunks run eagerly, `main3d oracle`'s CG
the host-loop `cg_solve`; all but the first two, f64mg2d eager and
linear_loops on gloo ranks) runs its CG
in CUDA graphs and its Newton loop's or linear step's bodies replayed
from CUDA graphs; f64jvp3d,
jvp3d, reuse_fine3d, f64mg3d and gather3d then run their 4 steps again
from rest
with the Newton loop's bodies run eagerly on the same model and CG graphs
(`newton_eager_twin`): the same `NewtonInfo` in every step, ||u||^2
within `LOOPS_RTOL`. On the eager CG paths the Neo-Hookean steps read
back at most Newton iterations + 2 times a step outside the CG (one a
pass, one more where an f32 residual stalls), logged a step with the
step times (shard3d, shard_cells, coupled_shard per rank). A graph replay adds the launches its capture recorded to
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
import re
import signal
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
# ||u||^2 after 4 steps of the f64 multigrid paths (F64_MG), JAX package on
# the CPU, at LINEAR2D_RTOL (every solve meets the absolute 1e-10 residual):
# f64mg2d, LINEAR_2D with the f64 solve and hierarchy,
#   JAX_PLATFORMS=cpu python tools/jax_reference_2d.py linear --scale 48 \
#       --solve-dtype "" --precond-dtype ""
F64MG2D_REF = 4.903851334663094
# f64mg_stencil, bench_linear_q2 (3D Q2, scale 4) with the f64 solve and
# hierarchy (the JAX package's levels on XLA: the same operator),
#   BENCH_SOLVE_DTYPE= BENCH_PRECOND_DTYPE= JAX_PLATFORMS=cpu \
#       python tools/jax_reference_bench.py linear --degree 2 --scale 4
F64MG_STENCIL_REF = 0.3215443820392788
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
F64_FLOPS = 34e12  # H100 SXM f64 outside the tensor cores (half the f32 rate)
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
# the f64 paths launch neither the tangent kernel (the f64 jvp tangent, the
# linear model's matrix-free operator) nor K5 (the f64 fine proxy is the
# plain operator), nor a level kernel's f32/bf16 form
_F64_EXCLUDES = ("K1 tangent_matvec", "K5 q2_structured")
# which kernels each path must launch
PATH_KERNELS = {
    "main3d": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
    "main3d newton eager": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
    "main3d host": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
    "main3d oracle": _HEALTH + ("K1 tangent_matvec",) + _MG3D,
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
# The f64 multigrid hierarchy: the solve and the hierarchy in the model's
# f64 (the JAX package's MG for an f64 solve without `precond_dtype`)
F64_MG = dict(solve_dtype="", precond_dtype="")
JVP_PATHS = {
    "f64jvp3d": dict(solve_dtype="", use_sumfact=True),
    "jvp3d": dict(assembled_tangent_max_gb=0.5),
    "reuse_fine3d": dict(newton_tangent_reuse=True, mg_fine_tangent=True),
    # f64jvp3d with the f64 hierarchy (its own lam_max estimates): K3's f64
    # instantiation on every Q1 level, the plain f64 fine proxy
    "f64mg3d": dict(F64_MG, use_sumfact=True),
}
# Every Q1 level lattice of the f64 paths, where phase 3 holds the f64
# level kernels against their plain versions: f64mg3d's (main3d's
# hierarchy, scale 9), f64mg_stencil's (bench_linear_q2, 3D Q2 scale 4)
# and f64mg2d's (the 2D flap at scale 48); each f64 path requires its
# hierarchy's lattices to be among them
F64_LEVELS_3D = ((19, 325, 55), (19, 163, 28), (19, 82, 15), (19, 42, 8),
                 (10, 22, 5), (9, 145, 25), (9, 73, 13), (9, 37, 7),
                 (9, 19, 4))
F64_LEVELS_2D = ((1729, 289), (865, 145), (433, 73), (217, 37), (109, 19),
                 (55, 10))
# an f64 level kernel against its plain version, the f64 V-cycle on the
# card against the CPU's: f64 roundoff in another summation order
F64_RTOL = 1e-12
# f64mg_stencil (K6 on every Q1 level) against the same cell on K3 in the
# same run: the same kernel and tables, so the same bits are expected
F64_STENCIL_RTOL = 1e-10
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
# the linear model's cells of the linear_loops phase and of
# tools/linear_step_profile.py: bench_torch.py's two linear cells and
# linear2d's configuration, name -> (dim, degree, scale)
LINEAR_CELLS = {
    "bench_linear_q2": (3, 2, 4),
    "bench_linear_q3": (3, 3, 3),
    "linear2d": (2, 2, SCALE_2D),
}
PATH_KERNELS.update({
    "f64mg_shard": _HEALTH + ("K3 q1_structured f64",),
    "f64mg_nccl1": _HEALTH + ("K3 q1_structured f64",),
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
    "f64mg3d": _HEALTH + ("K3 q1_structured f64",),
    "f64mg2d": _HEALTH + ("K4b q1_structured_2d f64",),
    "f64mg2d eager": _HEALTH + ("K4b q1_structured_2d f64",),
    "f64mg_stencil": _HEALTH + ("K6 q1_stencil f64",),
    "f64mg_stencil auto": _HEALTH + ("K3 q1_structured f64",),
    "linear_loops bench_linear_q2": _HEALTH + _MG3D,
    "linear_loops bench_linear_q3": _HEALTH + ("K3 q1_structured",),
    "linear_loops linear2d": _HEALTH + ("K4b q1_structured_2d",),
})
# the eager form of each linear_loops cell launches the kernels of its
# replayed form
for _cell in LINEAR_CELLS:
    PATH_KERNELS[f"linear_loops {_cell} eager"] = PATH_KERNELS[
        f"linear_loops {_cell}"]
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
                               "K5 q2_structured", "K4b q1_structured_2d"),
                 "linear_loops bench_linear_q2": ("K1 tangent_matvec",),
                 "linear_loops bench_linear_q3": ("K1 tangent_matvec",
                                                  "K5 q2_structured"),
                 "f64mg3d": _F64_EXCLUDES + ("K3 q1_structured",),
                 "f64mg2d": _F64_EXCLUDES + ("K4b q1_structured_2d",),
                 "f64mg2d eager": _F64_EXCLUDES + ("K4b q1_structured_2d",),
                 "f64mg_stencil": _F64_EXCLUDES + (
                     "K3 q1_structured", "K3 q1_structured f64",
                     "K6 q1_stencil"),
                 "f64mg_stencil auto": _F64_EXCLUDES + (
                     "K3 q1_structured", "K6 q1_stencil",
                     "K6 q1_stencil f64")}
for _path in ("f64mg_shard", "f64mg_nccl1"):
    PATH_EXCLUDES[_path] = PATH_EXCLUDES["f64mg_stencil auto"]
# the separate-card paths (phase 17) of each world: each launches and
# leaves out the kernels of its shared-card counterpart
for _w in (2, 3, 4):
    for _path, _twin in ((f"shard3d_cards {_w}", "shard3d"),
                         (f"shard3d_cards {_w} all_reduce", "shard3d"),
                         (f"shard3d_cards {_w} host", "shard3d"),
                         (f"f64mg_cards {_w}", "f64mg_shard"),
                         (f"shard_cells_cards {_w}", "shard_cells"),
                         (f"coupled_cards {_w}", "coupled_shard"),
                         (f"cli_cards {_w}", "cli_ranks"),
                         (f"dryrun_cards {_w}", "dryrun")):
        PATH_KERNELS[_path] = PATH_KERNELS[_twin]
        if _twin in PATH_EXCLUDES:
            PATH_EXCLUDES[_path] = PATH_EXCLUDES[_twin]
for _cell in LINEAR_CELLS:
    if f"linear_loops {_cell}" in PATH_EXCLUDES:
        PATH_EXCLUDES[f"linear_loops {_cell} eager"] = PATH_EXCLUDES[
            f"linear_loops {_cell}"]
# ||u||^2 after cli_nl's 3 steps, the JAX package on the CPU:
#   JAX_PLATFORMS=cpu python tools/jax_reference_nl_default.py
NL_DEFAULT_REF = 0.10160554980143784
NL_DEFAULT_RTOL = 1e-7
# the coupled3d phase: window, end time, implicit iterations per window
COUPLED_WINDOW, COUPLED_END, COUPLED_ITERATIONS = 0.01, 0.04, 2
COUPLED_RTOL = 1e-10  # against stencil3d's checksum: the same 4 steps
# main3d's checksum under CUDA graphs against the eager CG's and the
# host-loop `cg_solve`'s: the same kernels on the same inputs, so they
# should agree bit for bit
LOOPS_RTOL = 1e-12
# the steps of `main3d host` and `main3d oracle`, 1 warmup included: cut
# from main3d's 7 to keep the script's time
MAIN_HOST_STEPS = 2
# read-backs a Neo-Hookean step outside the CG beyond its Newton
# iterations: one a pass, one more where an f32 residual stalls
NEWTON_SYNC_SLACK = 2
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
# f64mg_shard (phase 16): the f64 hierarchy's linear cell on SHARD_RANKS
# gloo ranks against `f64mg_stencil auto` on one device: ||u||^2 after
# every step (every solve meets the absolute 1e-10 residual, the
# inner products sum in another order), and each rank's lam_max
# estimates (the power iterations through the all-reduced inner product
# from the same start vector: f64 roundoff)
F64MG_SHARD_CELL = "bench_linear_q2"
F64MG_SHARD_RTOL = 1e-9
F64MG_LAM_RTOL = 1e-9
# the separate-card phases (17): shard3d_cards' steps on the CUDA graphs
# (1 warmup + 3 timed, main3d's), those of its host-loop twin (1 warmup
# + 1 timed), held bit for bit against the first two; f64mg_cards'
# ||u||^2 against one device's (f64mg_shard's gloo ranks measured 1.9e-15
# in their first run); the exchange timing's calls; the spawn's limit
CARD_STEPS = 4
CARD_HOST_STEPS = 2
F64MG_CARDS_RTOL = 1e-14
EXCHANGE_FORMS = ("p2p", "all_reduce")
CARDS_TIMEOUT_S = 360
# cli_ranks (phase 14): the cli phase's case on this many ranks under
# torchrun; its final ||u||^2 against the cli phase's
CLI_RANKS = 2
CLI_RANKS_RTOL = 1e-9
CLI_RANKS_TIMEOUT_S = 240  # cli_ranks took 36 s, cli_cards' run 20-30 s
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


def bound(n_bytes, flops, flops_per_s=F32_FLOPS):
    """(ms, what bounds it): the least time for moving `n_bytes` once and
    doing `flops` operations on the card (f32 unless `flops_per_s` says
    otherwise)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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


def assembled_csr(E, grid_shape, p, dev, dtype=None):
    """The assembled global matrix of a constant element matrix over a
    lattice of degree-p cells, as a CSR tensor on the card (node-major
    dofs, the layout the kernels read), f32 unless `dtype` is given."""
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
    vals = torch.as_tensor(E, dtype=dtype or torch.float32,
                           device=dev).expand(n_cells, ed, ed).reshape(-1)
    n = math.prod(grid_shape) * dim
    A = torch.sparse_coo_tensor(idx, vals, (n, n)).coalesce()
    del idx, vals
    return A.to_sparse_csr()


def library_spmv_ms(E, grid_shape, p, dev, dtype=None):
    """Device time of one CSR SpMV (f32 unless `dtype` is given) of the
    assembled matrix."""
    import torch

    A = assembled_csr(E, grid_shape, p, dev, dtype)
    x = torch.randn(A.shape[1], 1, device=dev, dtype=A.dtype)
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


def stencil_work(grid_shape, io_bytes, table_bytes=4):
    """Bytes (u read once, y written once, the class tables, f32 unless
    `table_bytes` says otherwise) and operations (3^dim neighbours x dim^2
    FMA per node: 243 in 3D, 36 in 2D) of one assembled-stencil apply."""
    dim = len(grid_shape)
    n_nodes = math.prod(grid_shape)
    n_off = 3**dim
    return (2 * n_nodes * dim * io_bytes
            + table_bytes * n_off * n_off * dim * dim,
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


def f64_level_records(dev, E1, E4):
    """The Q1 level kernels' f64 instantiation (io mode 3, f64 tables): K3,
    K4 and K6 at every 3D Q1 level lattice of the f64 paths
    (`F64_LEVELS_3D`, with E1), K4b and K6 at every 2D one
    (`F64_LEVELS_2D`, with E4), on seeded f64 inputs: each within
    `F64_RTOL` relative L2 of its plain version, K4 and K6 bit for bit K3's
    (K6 in 2D K4b's) output, each lattice's device time (`device_ms`) and
    time per call (`cuda_ms`); at the largest lattice of each the plain
    version's time per call, the bound (bytes at 3.35 TB/s against f64
    operations at 34 TFLOP/s, the larger) and the device time of an f64
    CSR SpMV of the assembled level matrix (`library_ms`). One record per
    kernel, named as its f64 launch count (`K3 q1_structured f64`, ...)."""
    import torch

    from dealii_adapter_tpu_torch.ops.q1_structured import (
        Q1PlaneOperator,
        Q1StructuredOperator,
        Q1StructuredOperator2D,
    )
    from dealii_adapter_tpu_torch.ops.stencil import StencilQ1Operator

    f64 = torch.float64
    g = torch.Generator(device="cpu").manual_seed(64)
    log(f"kernels: SM clock {sm_clock()} before the f64 level kernels")
    checks = {"K3": [], "K4": [], "K4b": [], "K6": []}
    for lattices, E, dim in ((F64_LEVELS_3D, E1, 3), (F64_LEVELS_2D, E4, 2)):
        for i, lat in enumerate(lattices):
            u = torch.randn(math.prod(lat), dim, generator=g,
                            dtype=f64).to(dev)
            level = (Q1StructuredOperator if dim == 3
                     else Q1StructuredOperator2D)(E, lat, f64, dev)
            ref = level(u)
            ops = {"K3" if dim == 3 else "K4b": level,
                   "K6": StencilQ1Operator(E, lat, f64, device=dev)}
            if dim == 3:
                ops["K4"] = Q1PlaneOperator(E, lat, f64, dev)
            for name, op in ops.items():
                out = op(u)
                mx, rel = compare(out, op.plain(u))
                chk = dict(dtype="float64", lattice=tuple(lat),
                           max_abs_err=mx, rel_l2_err=rel, limit=F64_RTOL,
                           equal_to_level_kernel=bool(torch.equal(out, ref)),
                           ms=device_ms(lambda: op(u)),
                           call_ms=cuda_ms(lambda: op(u)))
                b_ms, b_by = bound(*stencil_work(lat, 8, table_bytes=8),
                                   flops_per_s=F64_FLOPS)
                chk.update(bound_ms=b_ms, bound_by=b_by,
                           share_of_bound=b_ms / chk["ms"])
                if i == 0:
                    chk["plain_ms"] = cuda_ms(lambda: op.plain(u))
                require(rel <= F64_RTOL and chk["equal_to_level_kernel"],
                        f"{name} f64 {lat}: {chk}")
                checks[name].append(chk)
                log(f"kernel {name} f64 {lat}: rel_l2 {rel:.3e} max_abs "
                    f"{mx:.3e} (bitwise the level kernel's "
                    f"{chk['equal_to_level_kernel']})  {chk['ms']:.4f} ms "
                    f"(per call {chk['call_ms']:.4f})"
                    + (f" vs plain {chk['plain_ms']:.4f}" if i == 0 else "")
                    + f", bound {b_ms:.4f} ms ({b_by}, "
                    f"{chk['share_of_bound']:.1%} of it)")
    lib3 = library_spmv_ms(E1, F64_LEVELS_3D[0], 1, dev, f64)
    lib2 = library_spmv_ms(E4, F64_LEVELS_2D[0], 1, dev, f64)
    log(f"kernels: f64 CSR SpMV of the assembled level: {lib3:.4f} ms at "
        f"{F64_LEVELS_3D[0]}, {lib2:.4f} ms at {F64_LEVELS_2D[0]}")
    records = []
    for name, kernel, replaces, lattices, lib in (
            ("K3", "q1_structured", "ops/pallas_structured.py:345",
             F64_LEVELS_3D, lib3),
            ("K4", "q1_plane", "ops/pallas_structured.py:445",
             F64_LEVELS_3D, lib3),
            ("K4b", "q1_structured_2d", "ops/pallas_structured.py:488",
             F64_LEVELS_2D, lib2),
            ("K6", "q1_stencil", "ops/stencil.py:244", F64_LEVELS_3D, lib3)):
        first, *rest = checks[name]
        records.append(dict(
            name=f"{name} {kernel} f64", route="cuda",
            source="dealii_adapter_tpu_torch/csrc/q1_structured.cu",
            replaces=f"dealii_adapter_tpu/{replaces}",
            shape=f"lattice {lattices[0]} x {len(lattices[0])}, "
                  f"{3 ** len(lattices[0])}-point, f64 I/O and tables",
            library_ms=lib, library_call="CSR SpMV (torch sparse, f64)",
            **first, other_checks=rest))
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
    # the f64 instantiation of K3, K4, K4b and K6 at the f64 paths' levels
    records += f64_level_records(dev, E1, E4)

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
                cg_loop=None, cg_chunk=None, device_mesh=None, **overrides):
    """`NonlinearElasticity` on the port: `bench_torch.py:build_model`
    (the benchmark configuration of bench.py's build_model) in 3D,
    `NONLINEAR_2D` in 2D, with `overrides`; `mesh_tags` reuses a mesh (and
    the multigrid geometry cached on it), `mg_lam_max` a hierarchy's
    lam_max values; `cg_loop` and `cg_chunk`, when given, the model's
    Krylov loop (and with it how the Newton loop's bodies run);
    `device_mesh` this rank's `RankGroup` (several ranks)."""
    if dim == 2:
        overrides = dict(NONLINEAR_2D, **overrides)
    kw = {k: v for k, v in (("cg_loop", cg_loop), ("cg_chunk", cg_chunk))
          if v is not None}
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


def build_linear_cell(name, device, scale=None, mesh_tags=None,
                      overrides=None, **model_kw):
    """The linear cell `name` of `LINEAR_CELLS` (at its full scale unless
    given), `bench_torch.py:build_linear_model` with `overrides` of its
    parameters and `model_kw` for the constructor (`cg_loop`,
    `mg_lam_max`, ...)."""
    dim, degree, full = LINEAR_CELLS[name]
    return bench_torch.build_linear_model(
        full if scale is None else scale, LINEAR["dtype"], degree,
        device=device, mesh_tags=mesh_tags,
        overrides=dict(LINEAR_2D if dim == 2 else {}, **(overrides or {})),
        **model_kw)


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


def require_newton_syncs(tag, outside, newton):
    """At most Newton iterations + `NEWTON_SYNC_SLACK` read-backs outside
    the CG in each step (`outside`, `newton`: per step)."""
    require(all(o <= n + NEWTON_SYNC_SLACK for o, n in zip(outside, newton)),
            f"{tag}: read-backs outside the CG {outside} a step, at most "
            f"Newton {newton} + {NEWTON_SYNC_SLACK}")


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


_HAND_KERNEL = re.compile(
    r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?"
    r"(?:void\s+)?(\w+)\s*\(")


def hand_kernel_names():
    """The `__global__` functions of the package's CUDA sources."""
    import glob

    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dealii_adapter_tpu_torch", "csrc")
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu*")):
        with open(path) as fh:
            names.update(_HAND_KERNEL.findall(fh.read()))
    return names


def kernel_group(name, hand):
    """The device-time group of a profiled kernel or copy: `hand` (this
    package's kernels), `trsv` (the coarse triangular pair), `cublas`
    (the other cuBLAS kernels), `elementwise` (PyTorch's elementwise
    kernels), `reduce` (its reductions), `memcpy`, `memset` or `other`."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    if any(h in name for h in hand):
        return "hand"
    low = name.lower()
    if "trsv" in low or "trsm" in low:
        return "trsv"
    if any(s in low for s in ("gemm", "gemv", "cublas", "xmma", "cutlass")):
        return "cublas"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def profile_timeline(tag, model, state, stress):
    """One step under torch.profiler tracing the card's activity only:
    (state, summary). The summary holds the step's wall time (host clock,
    ending in a synchronize), device time by `kernel_group`, the kernel
    launches, the busy share (the union of the device's kernel and copy
    intervals over the wall), the read-backs (device-to-host copies) and
    the idle gaps on the device: after each read-back (until the next
    device work: the host's turn-around) and the others. Prints one line
    and the ten kernels with most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    hand = hand_kernel_names()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        ts = time.perf_counter()
        state, _ = model.step(state, stress)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - ts) * 1e6
    events = sorted(
        ((e.time_range.start, e.time_range.end, e.name) for e in p.events()
         if e.device_type == DeviceType.CUDA), key=lambda e: e[0])
    groups, by_name = {}, {}
    for t0, t1, name in events:
        g = kernel_group(name, hand)
        groups[g] = groups.get(g, 0.0) + (t1 - t0) / 1e3
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
    busy_us, end, last = 0.0, None, None
    after_readback, other_gaps = [], []
    for t0, t1, name in events:
        if end is not None and t0 > end:
            (after_readback if last.startswith("Memcpy DtoH") else
             other_gaps).append(t0 - end)
        if end is None or t0 > end:
            busy_us += t1 - t0
            end, last = t1, name
        elif t1 > end:
            busy_us += t1 - end
            end, last = t1, name
    launches = sum(1 for *_, n in events
                   if kernel_group(n, hand) not in ("memcpy", "memset"))
    readbacks = sum(1 for *_, n in events if n.startswith("Memcpy DtoH"))
    out = dict(
        wall_ms=wall_us / 1e3, busy_ms=busy_us / 1e3,
        busy_share=busy_us / wall_us,
        device_ms={g: groups[g] for g in sorted(groups)},
        launches=launches, readbacks=readbacks,
        gaps_after_readback_ms=sum(after_readback) / 1e3,
        gap_after_readback_median_us=(statistics.median(after_readback)
                                      if after_readback else 0.0),
        other_gaps_ms=sum(other_gaps) / 1e3, other_gaps=len(other_gaps))
    log(f"{tag} profile: " + json.dumps(out))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(f"{tag} profile top kernels (ms): " + "; ".join(
        f"{n[:90]} {ms:.3f}" for n, ms in top))
    return state, out


def linear_fmt(info):
    return (f"cg {info.iterations} residual {info.residual!r} "
            f"linf_velocity {info.linf_velocity!r}")


def newton_fmt(info):
    return (f"newton {info.iterations} cg {info.cg_iterations} f64 "
            f"{info.f64_evals} f32 {info.f32_evals} asm "
            f"{info.tangent_assemblies} converged {info.converged}")


def newton_bodies(model, how):
    """From `model`'s next step on, run its Newton loop's bodies replayed
    from their CUDA graphs (`how="graphs"`) or eagerly ("eager": the graph
    runner's switch); the CG stays as `cg_loop` says."""
    model._graphs.eager = how == "eager"


def outside_cg(steps):
    """Read-backs outside the CG in each step of `run_steps`' record."""
    return [a - b for a, b in zip(steps["syncs"], steps["cg_syncs"])]


def main_run(tag, path, model, how, stress):
    """`run_steps` of the main-configuration model with its Newton loop's
    bodies run as `how` says (`newton_bodies`; 1 warmup + 3 timed steps
    from rest); returns (launches, {state, NewtonInfo per step, checksum,
    per-step times, syncs and launches, peak memory})."""
    import torch

    newton_bodies(model, how)
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
    """The main configuration, its CG in CUDA graphs, with its Newton
    loop's bodies replayed from CUDA graphs (the default) and run eagerly
    (`newton_bodies`), both on one model and so on the same CG graphs, in
    turns: round 1 eager then graphs (1 warmup + 3 timed steps from rest
    each), round 2 graphs then eager (3 more timed steps each, from each
    one's state); one profiled step of each only after both rounds. The
    same `NewtonInfo` in every step, checksums within `LOOPS_RTOL` after
    each round; read-backs outside the CG at most the Newton iterations +
    1 a step; every step's time, host syncs (the CG's apart) and
    launches, the peak memory of each one's round 1 and the busy share of
    its profiled step."""
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(dev)
    torch.cuda.synchronize()
    describe("main", model, time.perf_counter() - t0)
    require(model.cg_loop == "graphs" and not model._graphs.eager,
            "main: the CG and the Newton loop's bodies run in CUDA graphs")
    stress = interface_traction(model)
    tags = {"graphs": ("main", "main3d"),
            "eager": ("main newton eager", "main3d newton eager")}
    runs, launches = {}, {}
    for how in ("eager", "graphs"):  # round 1
        tag, path = tags[how]
        launches[path], runs[how] = main_run(tag, path, model, how, stress)
    for how in ("graphs", "eager"):  # round 2
        r = runs[how]
        newton_bodies(model, how)
        r["state"], infos, r["steps2"], r["checksum2"] = run_steps(
            tags[how][0], model, stress, newton_fmt, state=r["state"],
            first=4, n=3)
        r["infos"] += infos
        require(all(i.converged for i in infos),
                f"{tags[how][0]}: every step converged")
    for how in ("graphs", "eager"):
        newton_bodies(model, how)
        r = runs[how]
        r["busy"] = profile_step(tags[how][0], model, r["state"], stress,
                                 table=profile)
    newton_bodies(model, "graphs")
    graphs, eager = runs["graphs"], runs["eager"]
    for how, r in runs.items():
        st, st2 = r["steps"], r["steps2"]
        outside = outside_cg(st) + outside_cg(st2)
        r["outside"] = outside
        log(f"main A/B newton bodies {how}: step times round 1 {st['times']} s, "
            f"round 2 {st2['times']} s (timed means "
            f"{statistics.mean(st['times'][1:])!r} / "
            f"{statistics.mean(st2['times'])!r} s), CG "
            f"{[i.cg_iterations for i in r['infos']]}, Newton "
            f"{[i.iterations for i in r['infos']]}, host syncs "
            f"{st['syncs'] + st2['syncs']} of which outside the CG "
            f"{outside}, kernel launches {st['launches'] + st2['launches']} "
            f"per step, peak device memory {r['peak_gib']:.3f} GiB, busy "
            f"{r['busy']:.1%} of a profiled step")
    rels = [abs(graphs[k] - eager[k]) / eager[k] for k in ("checksum", "checksum2")]
    log(f"main A/B: checksums newton bodies graphs {graphs['checksum']!r} / "
        f"{graphs['checksum2']!r} eager {eager['checksum']!r} / "
        f"{eager['checksum2']!r} after steps 3 / 6, rel. differences "
        f"{rels[0]:.3e} / {rels[1]:.3e} (limit {LOOPS_RTOL}); bitwise "
        f"{graphs['checksum'] == eager['checksum'] and graphs['checksum2'] == eager['checksum2']}")
    require(graphs["infos"] == eager["infos"],
            "main: the replayed Newton loop's NewtonInfo equals the eager one's")
    require(max(rels) <= LOOPS_RTOL,
            "main: the replayed Newton loop's checksums against the eager one's")
    for r in runs.values():
        require(all(o <= i.iterations + 1
                    for o, i in zip(r["outside"], r["infos"])),
                "main: the Newton loop reads back at most its Newton "
                "iterations + 1 a step outside the CG")
    infos, checksum = graphs["infos"][:4], graphs["checksum"]
    checksums = graphs["steps"]["checksums"]
    main_times = graphs["steps"]["times"][1:]  # round 1's timed steps
    mesh_tags = (model.mesh, model.tags)
    lam_max = [lv.lam_max for lv in model._precond.levels]
    del model, runs, graphs, eager
    torch.cuda.empty_cache()
    launches["main3d host"] = main_host_cg(mesh_tags, lam_max, infos,
                                           checksums)
    launches["main3d oracle"] = main_host_cg(mesh_tags, lam_max, infos,
                                             checksums, oracle=True)
    return launches, dict(
        mesh_tags=mesh_tags, checksum=checksum, checksums=checksums,
        lam_max=lam_max, cg=[i.cg_iterations for i in infos],
        newton=[i.iterations for i in infos], times=main_times,
    )


def cg_solve_oracle(model):
    """`model` (`cg_loop="host"`) with the host-loop `cg_solve` as its CG
    in place of the eager `ChunkedCG`: the model builds its CG at its
    first solve from the `make_cg` its module imported by name, so each
    of its steps runs with that name replaced by a builder of `cg_solve`
    over the same operator, preconditioner and inner product. The
    package builds no such solve; `cg_solve` is the oracle."""
    import dealii_adapter_tpu_torch.models.nonlinear_elasticity as nl
    from dealii_adapter_tpu_torch.solvers.cg import cg_solve

    def make_cg_solve(loop, operator, preconditioner=None, chunk=None,
                      dot=nl._dot, pool=None):
        def solve(b, x0, tol, max_iter):
            return cg_solve(operator, b, x0, tol, max_iter, preconditioner,
                            dot)

        return solve

    step = model.step

    def oracle_step(*args):
        real, nl.make_cg = nl.make_cg, make_cg_solve
        try:
            return step(*args)
        finally:
            nl.make_cg = real

    model.step = oracle_step
    return model


def main_host_cg(mesh_tags, lam_max, infos, checksums, oracle=False):
    """The main configuration with `cg_loop="host"` (the Newton loop's
    bodies and the CG chunks eager: path `main3d host`), or with the
    host-loop `cg_solve` as its CG (`oracle`: path `main3d oracle`,
    `cg_solve_oracle`), on main3d's mesh and lam_max values,
    `MAIN_HOST_STEPS` steps from rest (1 warmup): the same `NewtonInfo`
    as main3d's (`infos`) in every step, ||u||^2 within `LOOPS_RTOL` of
    main3d's after the same step (`checksums`; bit for bit expected,
    logged), so that the CG graphs stay held against the eager chunks
    and against their plain loop at full size, and at most Newton
    iterations + `NEWTON_SYNC_SLACK` read-backs a step outside the CG;
    returns the path's launches."""
    import torch

    from dealii_adapter_tpu_torch.solvers.cg import ChunkedCG

    tag, path = (("main oracle", "main3d oracle") if oracle
                 else ("main host", "main3d host"))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(dev, mesh_tags=mesh_tags, mg_lam_max=lam_max,
                        cg_loop="host")
    if oracle:
        cg_solve_oracle(model)
    torch.cuda.synchronize()
    describe(tag, model, time.perf_counter() - t0)
    require(model.cg_loop == "host" and model._graphs.eager,
            f"{tag}: the CG chunks and the Newton loop's bodies eager")
    stress = interface_traction(model)
    start_counts()
    _, host_infos, steps, checksum = run_steps(
        tag, model, stress, newton_fmt, n=MAIN_HOST_STEPS)
    launches = read_counts(path)
    solve = model._tangent[1]
    require(not isinstance(solve, ChunkedCG) if oracle else (
        isinstance(solve, ChunkedCG) and solve.eager and solve._graphs is None),
        f"{tag}: the CG is " + ("the host-loop cg_solve" if oracle
                                else "the eager ChunkedCG"))
    ref = checksums[MAIN_HOST_STEPS - 1]
    rel = abs(checksum - ref) / ref
    outside = outside_cg(steps)
    log(f"{tag}: launches {launches}; NewtonInfo equal main3d's "
        f"{host_infos == infos[:MAIN_HOST_STEPS]}; checksum {checksum!r} "
        f"against main3d's {ref!r} after step {MAIN_HOST_STEPS - 1}: rel. "
        f"difference {rel:.3e} (limit {LOOPS_RTOL}), bitwise {checksum == ref}"
        f"; step times {steps['times']} s, Newton "
        f"{[i.iterations for i in host_infos]}, CG "
        f"{[i.cg_iterations for i in host_infos]}, read-backs outside the CG "
        f"{outside} a step (the CG's {steps['cg_syncs']})")
    require(all(o <= i.iterations + NEWTON_SYNC_SLACK
                for o, i in zip(outside, host_infos)),
            f"{tag}: at most Newton iterations + {NEWTON_SYNC_SLACK} "
            "read-backs a step outside the CG")
    require(all(i.converged for i in host_infos),
            f"{tag}: every step converged")
    require(host_infos == infos[:MAIN_HOST_STEPS],
            f"{tag}: the NewtonInfo equals main3d's")
    require(rel <= LOOPS_RTOL, f"{tag}: the checksum against main3d's")
    del model, solve
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


def newton_eager_twin(tag, model, stress, infos, checksum):
    """The path's 4 steps again from rest with the Newton loop's bodies run
    eagerly (`newton_bodies`, on the same model and CG graphs): the same
    `NewtonInfo` in every step as the replayed loop's, ||u||^2 within
    `LOOPS_RTOL`."""
    newton_bodies(model, "eager")
    _, eager_infos, steps, eager_checksum = run_steps(
        f"{tag} newton eager", model, stress, newton_fmt)
    newton_bodies(model, "graphs")
    rel = abs(checksum - eager_checksum) / eager_checksum
    log(f"{tag}: newton bodies replayed against eager: NewtonInfo equal "
        f"{eager_infos == infos}, checksum rel. difference {rel:.3e} (limit "
        f"{LOOPS_RTOL}); the eager loop's syncs outside the CG a step "
        f"{outside_cg(steps)}")
    require(eager_infos == infos,
            f"{tag}: the replayed Newton loop's NewtonInfo equals the eager "
            "one's")
    require(rel <= LOOPS_RTOL, f"{tag}: checksum against the eager Newton "
            "loop's")


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


def _coupled_shard_rank(mesh, lam_max, cg_loop="host"):
    """One rank of coupled_shard (a spawned process): phase 10's model on
    the lattice partition with the eager CG (coupled_cards: `cg_loop=
    "graphs"`, the CG and the Newton bodies in CUDA graphs), its first
    window."""
    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)

    t0 = time.perf_counter()
    model = build_model(mesh.device, mg_lam_max=lam_max, cg_loop=cg_loop,
                        device_mesh=mesh, mg_level_backend="stencil_vmem",
                        end_time=COUPLED_END)
    build_s = time.perf_counter() - t0
    steps, step = [], model.step

    def recorded(state, data):  # each step's time and read-backs
        import torch

        torch.cuda.synchronize()
        outside0 = model.host_syncs - model.cg_host_syncs
        ts = time.perf_counter()
        out = step(state, data)
        torch.cuda.synchronize()
        steps.append(dict(seconds=time.perf_counter() - ts,
                          newton=out[1].iterations,
                          outside=model.host_syncs - model.cg_host_syncs
                          - outside0))
        return out

    model.step = recorded
    run, _ = coupled_window(model, mesh)
    return dict(run, rank=mesh.rank, build_s=build_s, steps=steps)


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
    gloo ranks sharing card 0; returns the launches of all ranks."""
    from dealii_adapter_tpu_torch.parallel import spawn

    ref = parallel["coupled"]
    t0 = time.perf_counter()
    out = spawn(_coupled_shard_rank, SHARD_RANKS, "cuda:0", ref["lam_max"],
                backend="gloo")
    log(f"coupled_shard: {SHARD_RANKS} ranks on card 0 over gloo, eager "
        f"CG, ran in {time.perf_counter() - t0:.1f} s (spawn, build and "
        "window)")
    return check_coupled_shard("coupled_shard", out, ref)


def check_coupled_shard(path, out, ref):
    """Log and check the ranks' results `out` of `_coupled_shard_rank`
    against phase 10's first window `ref` (`check_first_window`, within
    `SHARD_RTOL`): rank 0 alone holds the participant, every rank read the
    same field; returns the launches of all ranks."""
    total = {}
    for r in out:
        tag = f"{path} rank {r['rank']}"
        log(f"{tag}: model built in {r['build_s']:.1f} s; window seconds "
            f"{[w['seconds'] for w in r['windows']]}; step times "
            f"{[x['seconds'] for x in r['steps']]} s, Newton "
            f"{[x['newton'] for x in r['steps']]}, read-backs outside the CG "
            f"{[x['outside'] for x in r['steps']]} a step; collectives in "
            f"the run {r['calls']}; launches {r['launches']}; participant "
            f"{'held' if r['writes'] else 'none'}")
        read_counts(path, r["launches"])
        require_newton_syncs(tag, [x["outside"] for x in r["steps"]],
                             [x["newton"] for x in r["steps"]])
        check_first_window(tag, r, ref, SHARD_RTOL)
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    require(bool(out[0]["writes"]) and not any(r["writes"] for r in out[1:]),
            f"{path}: rank 0 alone holds the participant")
    require(all([w["checksum"] for w in r["windows"]]
                == [w["checksum"] for w in out[0]["windows"]] for r in out),
            f"{path}: every rank read the same field")
    return total


def coupled_nccl1(mesh, parallel):
    """coupled_nccl1 (phase 14): phase 10's first window on `mesh`, a world
    of one over NCCL, with the CG and the Newton bodies in CUDA graphs; bit
    for bit phase 10's first window. Returns the launches."""
    import torch

    ref = parallel["coupled"]
    t0 = time.perf_counter()
    model = build_model(mesh.device, mesh_tags=parallel["mesh_tags"],
                        mg_lam_max=ref["lam_max"], device_mesh=mesh,
                        mg_level_backend="stencil_vmem", end_time=COUPLED_END)
    require(model.cg_loop == "graphs" and not model._graphs.eager,
            "coupled_nccl1: the CG and the Newton bodies in CUDA graphs")
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


def f64_hierarchy_check(tag, model, lattices, cpu_twin=None):
    """The f64 hierarchy of a model on the card: f64 on every level, a
    plain f64 fine proxy (no K5), every Q1 level lattice among `lattices`
    (those phase 3 held the f64 kernels at). With `cpu_twin` (lam_max
    values -> the same model built on the CPU), one V-cycle on a seeded
    masked f64 vector against the same hierarchy built on the CPU from the
    same lam_max values, where the plain versions run, within `F64_RTOL`
    relative L2, with the card's device time of the V-cycle."""
    import torch

    from dealii_adapter_tpu_torch.ops.q2_structured import _PlainDegreeOperator

    mg = model._precond
    shapes = [lv.grid_shape for lv in mg.levels[1:]]
    require(mg.dtype == torch.float64
            and all(lv.diag.dtype == torch.float64 for lv in mg.levels),
            f"{tag}: every level of the hierarchy in f64")
    require(all(s in lattices for s in shapes),
            f"{tag}: Q1 levels {shapes} among phase 3's {lattices}")
    if getattr(model, "_fine_proxy", None) is not None:
        require(isinstance(model._fine_proxy, _PlainDegreeOperator),
                f"{tag}: the fine proxy is the plain operator")
    lam = [lv.lam_max for lv in mg.levels]
    log(f"{tag}: f64 hierarchy, levels {[lv.grid_shape for lv in mg.levels]}, "
        f"lam_max {lam}")
    if cpu_twin is None:
        return
    t0 = time.perf_counter()
    cpu = cpu_twin(lam)
    t_build = time.perf_counter() - t0
    g = torch.Generator().manual_seed(31)
    r = cpu.mask * torch.randn(cpu.space.n_nodes, cpu.space.dim, generator=g,
                               dtype=torch.float64)
    t0 = time.perf_counter()
    z_cpu = cpu._precond(r)
    t_cpu = time.perf_counter() - t0
    r_dev = r.to(model.device)
    z_dev = mg(r_dev).cpu()
    mx, rel = compare(z_dev, z_cpu)
    ms = device_ms(lambda: mg(r_dev), reps=5, warmup_s=0.1)
    log(f"{tag}: one V-cycle on the card against the same hierarchy on the "
        f"CPU (built in {t_build:.1f} s, its V-cycle {t_cpu:.2f} s on the "
        f"host): rel_l2 {rel:.3e} max_abs {mx:.3e} (limit {F64_RTOL}); "
        f"device time {ms!r} ms a V-cycle")
    require(rel <= F64_RTOL, f"{tag}: the f64 V-cycle against the CPU's: {rel}")


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
    by_path, counts = {}, {}
    for path, overrides in JVP_PATHS.items():
        t0 = time.perf_counter()
        # f64mg3d's f64 hierarchy takes its own lam_max estimates
        model = build_model(dev, mesh_tags=main["mesh_tags"],
                            mg_lam_max=(None if path == "f64mg3d"
                                        else main["lam_max"]), **overrides)
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
        counts[path] = dict(cg=cg, newton=newton)
        if path in ("f64jvp3d", "f64mg3d"):
            require(model.solve_dtype == torch.float64
                    and not model._use_assembled and model._sumfact is not None,
                    f"{path}: the f64 jvp tangent with sum factorization")
        if path == "f64mg3d":
            f64_hierarchy_check(
                path, model, F64_LEVELS_3D,
                lambda lam: build_model(torch.device("cpu"),
                                        mesh_tags=main["mesh_tags"],
                                        mg_lam_max=lam, **overrides))
            log(f"f64mg3d: CG per step {cg} and Newton {newton} with the f64 "
                f"hierarchy; f64jvp3d's (bf16 hierarchy) CG "
                f"{counts['f64jvp3d']['cg']}, Newton "
                f"{counts['f64jvp3d']['newton']}")
        if path == "reuse_fine3d":
            require(all(n <= m + 2 for n, m in zip(newton, main["newton"])),
                    "reuse_fine3d: Newton counts at most main3d's + 2 a step")
            asm = sum(i.tangent_assemblies for i in infos[1:])
            log(f"reuse_fine3d: tangent assemblies in the timed steps {asm} "
                f"against {sum(newton[1:])} Newton iterations")
            require(asm < sum(newton[1:]),
                    "reuse_fine3d: fewer assemblies than Newton iterations")
        elif path != "f64mg3d":  # f64jvp3d's operator
            tangent_operator_ms(path, model, state)
        newton_eager_twin(path, model, stress, infos, checksum)
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
    log(f"cli: (CG iterations, read-backs) a step {step_read_backs(r.stdout)}")
    require(torch.cuda.get_device_name(0) in r.stdout, "cli: banner names the card")
    require(files == ["solution-2d-1.vtu", "solution-2d-2.vtu"], f"cli: files {files}")
    line = next(x for x in r.stdout.splitlines() if x.startswith("kernel launches: "))
    launches = read_counts("cli", ast.literal_eval(line[len("kernel launches: "):]))
    return launches, final_u2(r.stdout)


def final_u2(text):
    """The CLI's closing `final ||u||^2:` value."""
    line = next(x for x in text.splitlines() if x.startswith("final ||u||^2: "))
    return float(line[len("final ||u||^2: "):])


def step_read_backs(text):
    """[(CG iterations, read-backs)] of the linear CLI's step lines."""
    return [(int(cg), int(n)) for cg, n in re.findall(
        r"cg_its=(\d+) .*read_backs=(\d+)", text)]


def first_visible_card():
    """The `CUDA_VISIBLE_DEVICES` entry of this process's card 0."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").strip()
    return visible.split(",")[0] if visible else "0"


def phase_cli_ranks(cli_u2, n_ranks=CLI_RANKS, cards=False):
    """cli_ranks (phase 14): `CLI_PRM` under `torchrun --standalone
    --nproc-per-node CLI_RANKS -m dealii_adapter_tpu_torch ... --devices
    CLI_RANKS` in a subprocess that sees card 0 alone, so that its ranks
    share it over gloo (the eager CG); cli_cards (`cards=True`): `n_ranks`
    ranks that see every card, one a rank over NCCL (the CG in CUDA
    graphs). Returns rank 0's launch counts."""
    import ast
    import pathlib
    import sys

    import torch

    path = f"cli_cards {n_ranks}" if cards else "cli_ranks"
    root = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        prm = os.path.join(tmp, "case.prm")
        pathlib.Path(prm).write_text(CLI_PRM.format(out=out))
        env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
        if not cards:
            env["CUDA_VISIBLE_DEVICES"] = first_visible_card()
        ts = time.perf_counter()
        # a session of its own, so that a run past its limit is stopped
        # with every rank torchrun started
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n_ranks), "-m",
             "dealii_adapter_tpu_torch", prm, "--standalone", "--traction",
             "1000", "0", "--refine", str(CLI_REFINE), "--devices",
             str(n_ranks)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=CLI_RANKS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            stdout, stderr = proc.communicate()
        wall = time.perf_counter() - ts
        for line in stdout.splitlines():
            log(f"{path}| {line}")
        require(proc.returncode == 0,
                f"{path}: exit code {proc.returncode} after {wall:.1f} s "
                f"(limit {CLI_RANKS_TIMEOUT_S} s): {stderr[-3000:]}")
        files = sorted(os.listdir(out))
        log(f"{path}: exit code 0 in {wall:.1f} s (torchrun and the "
            f"ranks' start included), VTU files "
            f"{[(f, os.path.getsize(os.path.join(out, f))) for f in files]}")
    text = stdout
    require(text.count("running dealii_adapter_tpu_torch") == 1,
            f"{path}: one banner (rank 0's)")
    require(torch.cuda.get_device_name(0) in text, f"{path}: banner names the card")
    banner = (f"{n_ranks} ranks over nccl; CG loop: graphs" if cards
              else f"{n_ranks} ranks over gloo; CG loop: host")
    require(banner in text,
            f"{path}: banner names the ranks, the backend and the CG loop")
    require(files == ["solution-2d-1.vtu", "solution-2d-2.vtu"]
            and "2 VTU files" in text, f"{path}: files {files}")
    steps = step_read_backs(text)
    log(f"{path}: (CG iterations, read-backs) a step {steps}")
    require(steps and all(n <= cg + 2 for cg, n in steps),
            f"{path}: at most CG iterations + 2 read-backs a step")
    u2 = final_u2(text)
    rel = abs(u2 - cli_u2) / cli_u2
    log(f"{path}: final ||u||^2 {u2!r} against the cli phase's {cli_u2!r}: "
        f"rel. difference {rel:.3e} (limit {CLI_RANKS_RTOL})")
    require(rel <= CLI_RANKS_RTOL, f"{path}: final ||u||^2 against cli's")
    line = next(x for x in text.splitlines() if x.startswith("kernel launches: "))
    return read_counts(path, ast.literal_eval(line[len("kernel launches: "):]))


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
    state, infos, _, checksum = run_steps("linear2d", model, stress,
                                          linear_fmt)
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


def oracle_linear_step(model, state, data):
    """One linear theta-step of `model` from its public pieces with the
    host loops, the JAX package's `_make_step` line by line: the load
    (`assemble_load`), the right-hand side from `K`, `M` and the mask, the
    solve (`solvers/cg.py:ir_cg_solve` around `cg_solve` for an f32 solve,
    else `cg_solve`), the theta update; (state, StepInfo). The oracle of
    the one step (tests/test_torch_linear_device.py holds the same on the
    CPU, with the Direct solve too)."""
    from dealii_adapter_tpu_torch.models.linear_elasticity import (
        CG_TOL,
        LinearState,
        StepInfo,
    )
    from dealii_adapter_tpu_torch.solvers import cg

    p = model.params
    require(p.type_lin == "CG", "oracle_linear_step: a CG configuration")
    dt, theta = p.delta_t, p.theta
    mask, K, M = model.mask, model.K, model.M
    disp, vel, old = state
    F = model.assemble_load(data)
    rhs = mask * (dt * theta * F + dt * (1.0 - theta) * old + M(vel)
                  - (theta * (1.0 - theta) * dt * dt) * K(vel)
                  - dt * K(disp))
    max_iter = int(model.space.n_dofs * p.max_iterations_lin)
    A_hi = model.masked_operator(model.A)
    if model.solve_dtype != model.dtype:
        r = cg.ir_cg_solve(
            A_hi, model.masked_operator(model.A_lo, model.mask_lo), rhs,
            mask * vel, CG_TOL, max_iter, lo_dtype=model.solve_dtype,
            preconditioner=model.preconditioner)
    else:
        r = cg.cg_solve(A_hi, rhs, mask * vel, CG_TOL, max_iter,
                        model.preconditioner)
    v = r.x
    d = disp + dt * theta * v + dt * (1.0 - theta) * vel
    return (LinearState(d, v, F),
            StepInfo(r.iterations, r.residual_norm, float(v.abs().max())))


def phase_linear_loops():
    """The one linear step replayed (`cg_loop="graphs"`, the default: its
    right-hand side, defect-correction loop, CG chunks and update from
    CUDA graphs) against the same step eager (`cg_loop="host"`: the same
    bodies run eagerly, nothing captured) on each of `LINEAR_CELLS` at
    full size, two models on one mesh with the same lam_max values: 1
    warmup and 3 timed steps from rest each (eager first), then one
    profiled step of each (`profile_timeline`). The same `StepInfo` in
    every step and the states bit for bit, every residual <= 1e-10, and
    both forms' read-backs at most their CG iterations + 2 a step (module
    docstring); each form's step times and read-backs. Then the first
    step from rest against `oracle_linear_step` (the host loops
    `ir_cg_solve` and `cg_solve` on the card): the same `StepInfo`, the
    velocity bit for bit. Then one step of the replayed model's
    subcycling clone (half the step), with the peak device memory before
    and after it. Returns {path: launches} (the replayed form's under the
    cell's path, the eager form's under it + " eager")."""
    import torch

    dev = torch.device("cuda")
    by_path = {}
    forms = (("host", "eager"), ("graphs", "replayed"))
    for cell in LINEAR_CELLS:
        runs, mesh_tags, lam_max = {}, None, None
        for loop, form in reversed(forms):
            t0 = time.perf_counter()
            model = build_linear_cell(cell, dev, mesh_tags=mesh_tags,
                                      mg_lam_max=lam_max, cg_loop=loop)
            torch.cuda.synchronize()
            log(f"linear_loops {cell}: {form} (cg_loop={loop}) built in "
                f"{time.perf_counter() - t0:.1f} s, {model.space.n_dofs} DoF")
            if mesh_tags is None:
                mesh_tags = (model.mesh, model.tags)
                lam_max = [lv.lam_max for lv in model._precond.levels]
            runs[form] = model
        require(runs["eager"].jittable_step().__func__
                is runs["replayed"].jittable_step().__func__,
                f"linear_loops {cell}: one step function under both loops")
        stress = interface_traction(runs["eager"])
        out, path = {}, f"linear_loops {cell}"
        for loop, form in forms:
            model = runs[form]
            torch.cuda.reset_peak_memory_stats()
            start_counts()
            state, infos, steps, checksum = run_steps(
                f"{path} {form}", model, stress, linear_fmt)
            launches = read_counts(path if form == "replayed"
                                   else f"{path} eager")
            out[form] = dict(state=state, infos=infos, steps=steps,
                             checksum=checksum, launches=launches,
                             peak=torch.cuda.max_memory_allocated() / 2**30)
            require(all(i.residual <= 1e-10 for i in infos),
                    f"{path} {form}: every step's residual <= 1e-10")
        g, h = out["replayed"], out["eager"]
        same = all(torch.equal(a, b) for a, b in zip(g["state"], h["state"]))
        for _, form in forms:
            out[form]["state"], out[form]["profile"] = profile_timeline(
                f"{path} {form}", runs[form], out[form]["state"], stress)
        for form, r in out.items():
            st = r["steps"]
            log(f"{path} {form}: step times {st['times']} s (timed mean "
                f"{statistics.mean(st['times'][1:])!r} s), CG "
                f"{[i.iterations for i in r['infos']]}, read-backs "
                f"{st['syncs']} (less the CG iterations "
                f"{[y - i.iterations for y, i in zip(st['syncs'], r['infos'])]}"
                f"), kernel launches {st['launches']}, peak device memory "
                f"{r['peak']:.3f} GiB; launches {r['launches']}")
        log(f"{path}: checksums replayed {g['checksum']!r} eager "
            f"{h['checksum']!r}; states bitwise {same}; StepInfo equal "
            f"{g['infos'] == h['infos']}; the eager step over the replayed "
            f"one {statistics.mean(h['steps']['times'][1:]) - statistics.mean(g['steps']['times'][1:])!r} s (timed means)")
        require(g["infos"] == h["infos"],
                f"{path}: the replayed step's StepInfo equals the eager one's")
        require(same, f"{path}: the replayed step's state equals the eager "
                "one's bit for bit")
        for form, r in out.items():
            extra = [y - i.iterations for y, i in zip(r["steps"]["syncs"],
                                                      r["infos"])]
            require(max(extra) <= 2, f"{path} {form}: at most CG "
                    "iterations + 2 read-backs a step")
        model = runs["replayed"]
        t0 = time.perf_counter()
        (s1, i1), (so, io) = (model.step(model.initial_state(), stress),
                              oracle_linear_step(model, model.initial_state(),
                                                 stress))
        torch.cuda.synchronize()
        log(f"{path}: first step against the ir_cg_solve oracle (both in "
            f"{time.perf_counter() - t0:.2f} s): step {linear_fmt(i1)}; "
            f"oracle {linear_fmt(io)}; velocity bitwise "
            f"{torch.equal(s1.velocity, so.velocity)}, displacement bitwise "
            f"{torch.equal(s1.displacement, so.displacement)}")
        require(i1 == io == g["infos"][0],
                f"{path}: the first step's StepInfo equals the oracle's")
        require(torch.equal(s1.velocity, so.velocity),
                f"{path}: the first step's velocity equals the oracle's bit "
                "for bit")
        del runs
        peak0 = torch.cuda.max_memory_allocated() / 2**30
        clone = model.with_delta_t(model.params.delta_t / 2)
        _, info = clone.step(g["state"], stress)
        torch.cuda.synchronize()
        log(f"{path}: subcycling clone (dt {clone.params.delta_t}): "
            f"{linear_fmt(info)}; peak device memory {peak0:.3f} GiB before "
            f"its step, {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
            f"after")
        require(info.residual <= 1e-10, f"{path}: the clone's residual")
        by_path[path] = g["launches"]
        by_path[f"{path} eager"] = h["launches"]
        del model, clone, out, g, h, s1, so
        torch.cuda.empty_cache()
    return by_path


def phase_f64mg():
    """The linear model's f64 multigrid paths (`F64_MG`; returns {path:
    launches}):
    - f64mg2d: `LINEAR_2D` (the 2D flap, scale 48) replayed
      (`cg_loop="graphs"`) and the same step eager (`cg_loop="host"`),
      two models on one mesh with the same lam_max values, 1 warmup and 3
      timed steps each: K4b's f64 instantiation on every Q1 level; the
      same `StepInfo` and states bit for bit, every residual <= 1e-10,
      ||u||^2 within `LINEAR2D_RTOL` of the JAX package's
      (`F64MG2D_REF`);
    - f64mg_stencil: bench_linear_q2 (3D Q2, scale 4) with
      `mg_level_backend="stencil"` (K6's f64 instantiation on every Q1
      level, K3 never) and the same cell with `"auto"` (K3 in f64, path
      `f64mg_stencil auto`), 1 warmup and 3 timed steps each: every
      residual <= 1e-10, the two checksums within `F64_STENCIL_RTOL` and
      the stencil's within `LINEAR2D_RTOL` of the JAX package's
      (`F64MG_STENCIL_REF`).
    Each model's hierarchy passes `f64_hierarchy_check` (f64 throughout,
    levels among phase 3's lattices). Returns ({path: launches}, the run
    of `f64mg_stencil auto`: the reference of f64mg_shard and f64mg_nccl1:
    its `StepInfo`s, ||u||^2 after every step, lam_max values and mesh)."""
    import torch

    dev = torch.device("cuda")
    by_path, runs = {}, {}
    mesh_tags, lam_max = None, None
    for path, cell, model_kw in (
            ("f64mg2d", "linear2d", dict(cg_loop="graphs")),
            ("f64mg2d eager", "linear2d", dict(cg_loop="host")),
            ("f64mg_stencil", "bench_linear_q2", {}),
            ("f64mg_stencil auto", "bench_linear_q2", {})):
        if path == "f64mg_stencil":
            mesh_tags = lam_max = None
        overrides = dict(F64_MG, mg_level_backend=(
            "stencil" if path == "f64mg_stencil" else "auto"))
        t0 = time.perf_counter()
        model = build_linear_cell(cell, dev, mesh_tags=mesh_tags,
                                  overrides=overrides, mg_lam_max=lam_max,
                                  **model_kw)
        torch.cuda.synchronize()
        describe(path, model, time.perf_counter() - t0)
        f64_hierarchy_check(path, model, F64_LEVELS_2D if cell == "linear2d"
                            else F64_LEVELS_3D)
        if path == "f64mg2d":
            mesh_tags = (model.mesh, model.tags)
            lam_max = [lv.lam_max for lv in model._precond.levels]
        stress = interface_traction(model)
        start_counts()
        state, infos, steps, checksum = run_steps(path, model, stress,
                                                  linear_fmt)
        by_path[path] = read_counts(path)
        log(f"{path}: launches {by_path[path]}")
        require(all(i.residual <= 1e-10 for i in infos),
                f"{path}: every step's residual <= 1e-10")
        runs[path] = dict(state=state, infos=infos, checksum=checksum,
                          checksums=steps["checksums"],
                          lam_max=[lv.lam_max for lv in model._precond.levels],
                          mesh_tags=(model.mesh, model.tags))
        del model
        torch.cuda.empty_cache()
    g, h = runs["f64mg2d"], runs["f64mg2d eager"]
    same = all(torch.equal(a, b) for a, b in zip(g["state"], h["state"]))
    log(f"f64mg2d: replayed against eager: StepInfo equal "
        f"{g['infos'] == h['infos']}, states bitwise {same}")
    require(g["infos"] == h["infos"] and same,
            "f64mg2d: the replayed step equals the eager one bit for bit")
    check_checksum("f64mg2d", g["checksum"], F64MG2D_REF, LINEAR2D_RTOL)
    k6, k3 = runs["f64mg_stencil"], runs["f64mg_stencil auto"]
    rel = abs(k6["checksum"] - k3["checksum"]) / k3["checksum"]
    log(f"f64mg_stencil: checksum {k6['checksum']!r} against the K3 "
        f"hierarchy's {k3['checksum']!r}: rel. difference {rel:.3e} (limit "
        f"{F64_STENCIL_RTOL}); CG {[i.iterations for i in k6['infos']]} "
        f"against {[i.iterations for i in k3['infos']]}")
    require(rel <= F64_STENCIL_RTOL,
            "f64mg_stencil: checksum against the K3 hierarchy's")
    check_checksum("f64mg_stencil", k6["checksum"], F64MG_STENCIL_REF,
                   LINEAR2D_RTOL)
    return by_path, {k: k3[k] for k in ("infos", "checksums", "lam_max",
                                        "mesh_tags")}


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
    newton_eager_twin("gather3d", model, stress, infos, checksum)
    del model
    torch.cuda.empty_cache()
    return launches


def slab_kernel_checks(model, seed):
    """K5 (the fine proxy), K3 (each distributed Q1 level) and K1 at this
    rank's slab shapes against their plain versions, on seeded random
    inputs: bf16 in and f32 out, the variant the lattice partition runs
    for the bf16 V-cycle (its partial sums stay f32), limit 1e-5 (the f32
    accumulation; K5's split E is ~2.3e-6 relative); and f32 and bf16 I/O
    at phase 3's limits; K3's f64 instantiation at the same slab shapes
    with each level's element matrix (`F64_RTOL`). Not counted."""
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
    rows += slab_f64_checks([op for _, op, _ in ops[1:]], g)
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


def slab_f64_checks(ops, g):
    """K3's f64 instantiation at the slab shapes of the level operators
    `ops` (each distributed level's operator on this rank's slab) with
    each level's element matrix, on seeded f64 inputs from `g`, against
    its plain version (`F64_RTOL`); the time of a call on the card (None
    on the CPU, where both are the plain version). Not counted."""
    import torch

    from dealii_adapter_tpu_torch.ops.q1_structured import q1_lattice_operator

    rows = []
    f64 = torch.float64
    for op in ops:
        dev = g.device
        k3 = q1_lattice_operator(op.E_host, op.grid_shape, f64, dev)
        x = torch.randn(op._u_shape, generator=g, device=dev, dtype=f64)
        max_abs, rel = compare(k3(x), k3.plain(x))
        rows.append(dict(name="K3 q1_structured f64", shape=list(op.grid_shape),
                         dtype="float64", max_abs_err=max_abs, rel_l2_err=rel,
                         limit=F64_RTOL, ms=cuda_ms(lambda: k3(x))
                         if dev.type == "cuda" else None))
        require(rel <= F64_RTOL, f"K3 f64 at the slab {op.grid_shape}: rel. "
                f"L2 error {rel:.3e} > {F64_RTOL}")
    return rows


def _shard3d_rank(mesh, lam_max, n_steps, scale=None, cg_loop="host",
                  after=None, checks=True):
    """One rank of shard3d (a spawned process): the slab checks (unless
    `checks` is False), then `n_steps` steps of phase 4's configuration (at
    `scale`, by default phase 4's) on the lattice partition with the CG
    loop `cg_loop` (the eager CG by default; shard3d_cards replays it
    from CUDA graphs), then `after(model)`, whose result goes under
    "after"; returns what the parent checks and logs (also
    `tools/port_shard_steps.py`'s, which runs it on the CPU too)."""
    import torch

    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
    from dealii_adapter_tpu_torch.kernels import counters

    dev = mesh.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    model = build_model(dev, scale=scale, mg_lam_max=lam_max, cg_loop=cg_loop,
                        device_mesh=mesh)
    lat = model._lat
    out = dict(rank=mesh.rank, build_s=time.perf_counter() - t0,
               axis=lat.axis, slab=lat.slab_shape, owned=(lat.lo, lat.hi),
               levels=[(lv.grid_shape, lv.layout.slab_shape if lv.layout else None)
                       for lv in model._precond.levels],
               checks=slab_kernel_checks(model, 11 + mesh.rank) if checks else [],
               cg_loop=model.cg_loop, eager=bool(model._graphs.eager),
               device=str(dev), backend=mesh.backend,
               current=torch.cuda.current_device() if cuda else None)
    stress = model.local_rows(interface_traction(model))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        start_counts()
    else:  # the CPU rehearsal: no library to bind
        counters.reset()
    state = model.initial_state()
    for k in ("newton", "cg", "converged", "min_det_F", "times", "checksums",
              "calls", "outside", "syncs", "infos"):
        out[k] = []
    for _ in range(n_steps):
        sync()
        calls0 = dict(mesh.calls)
        syncs0 = model.host_syncs
        outside0 = model.host_syncs - model.cg_host_syncs
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        sync()
        out["times"].append(time.perf_counter() - ts)
        out["syncs"].append(model.host_syncs - syncs0)
        out["outside"].append(model.host_syncs - model.cg_host_syncs - outside0)
        out["calls"].append({k: mesh.calls[k] - calls0[k] for k in calls0})
        u = state.displacement.reshape(-1)
        out["checksums"].append(float(mesh.all_reduce(torch.dot(u, u))))
        out["newton"].append(info.iterations)
        out["cg"].append(info.cg_iterations)
        out["converged"].append(info.converged)
        out["min_det_F"].append(info.min_det_F)
        out["infos"].append(tuple(info))
    out["launches"] = counters.launch_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    out["after"] = after(model) if after is not None else None
    return out


def phase_shard3d(main, records):
    """shard3d (phase 13): the lattice partition at full size on
    `SHARD_RANKS` gloo ranks sharing card 0; the slab checks go into the
    kernel records (`slab_checks`); returns the launches of all ranks."""
    from dealii_adapter_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    out = spawn(_shard3d_rank, SHARD_RANKS, "cuda:0", main["lam_max"],
                SHARD3D_STEPS, backend="gloo")
    log(f"shard3d: {SHARD_RANKS} ranks on card 0 over gloo, eager CG, "
        f"ran in {time.perf_counter() - t0:.1f} s (spawn, build and steps)")
    return check_shard3d("shard3d", "shard3d", out, main, records,
                         "ranks sharing one card, not a scaling result")


def check_shard3d(tag0, path, out, main, records, note):
    """Log and check the ranks' results `out` of `_shard3d_rank` against
    main3d's (`main`) after as many steps: every step converged, Newton
    counts equal, CG within `SHARD_CG_SLACK` a step, ||u||^2 after every
    step within `SHARD_RTOL`, every rank the same reduced values, at most
    Newton + `NEWTON_SYNC_SLACK` read-backs outside the CG a step; the
    slab checks go into the kernel records; returns the launches of all
    ranks (`path`'s kernels, each rank's)."""
    n = len(out[0]["checksums"])
    by_name = {rec["name"]: rec for rec in records}
    total = {}
    for r in out:
        tag = f"{tag0} rank {r['rank']}"
        log(f"{tag}: on {r['device']} over {r['backend']}, CG loop "
            f"{r['cg_loop']}; model built in {r['build_s']:.1f} s; split axis "
            f"{r['axis']}, owned planes {r['owned']}, slab {r['slab']}; levels "
            f"(lattice, slab or None = replicated) {r['levels']}")
        for c in r["checks"]:
            log(f"{tag}: {c['name']} at the slab {c['shape']} {c['dtype']}: "
                f"max abs err {c['max_abs_err']:.3e}, rel. L2 "
                f"{c['rel_l2_err']:.3e} (limit {c['limit']}); "
                + (f"{c['ms']:.4f} ms a call (CUDA events, median of 15; "
                   f"{note})" if c["ms"] is not None else "not timed"))
            by_name[c["name"]].setdefault("slab_checks", []).append(
                dict(c, rank=r["rank"], ranks=len(out), path=path))
        rels = [abs(a - b) / b for a, b in zip(r["checksums"],
                                               main["checksums"])]
        log(f"{tag}: step times {r['times']} s ({note}); Newton "
            f"{r['newton']}, CG {r['cg']} (main3d: {main['newton']}, "
            f"{main['cg']}); read-backs {r['syncs']} a step, outside the CG "
            f"{r['outside']}; min_det_F {r['min_det_F']}; collectives a step "
            f"{r['calls']}; checksums {r['checksums']} against main3d's "
            f"{main['checksums'][:n]}: rel. differences "
            f"{[f'{x:.3e}' for x in rels]} (limit {SHARD_RTOL}); peak device "
            f"memory {r['peak_gib']:.2f} GiB")
        read_counts(path, r["launches"])
        log(f"{tag}: launches {r['launches']}")
        require(all(r["converged"]), f"{tag}: every step converged")
        require(r["newton"] == main["newton"][:n],
                f"{tag}: Newton counts equal main3d's")
        require_newton_syncs(tag, r["outside"], r["newton"])
        require(all(abs(a - b) <= SHARD_CG_SLACK for a, b in zip(r["cg"], main["cg"])),
                f"{tag}: CG within {SHARD_CG_SLACK} a step of main3d's")
        require(max(rels) <= SHARD_RTOL, f"{tag}: checksums against main3d's")
        for k, m in r["launches"].items():
            total[k] = total.get(k, 0) + m
    require(all(r["checksums"] == out[0]["checksums"]
                and r["newton"] == out[0]["newton"] for r in out),
            f"{tag0}: every rank read the same reduced values")
    return total


def phase_shard3d_nccl1(main, f64_ref):
    """shard3d_nccl1 (phase 13): a world of one on NCCL in this process,
    the CG in CUDA graphs, bit for bit phase 4; then shard_cells'
    configuration on that world, its one-rank reference, phase 14's
    coupled_nccl1 and phase 16's f64mg_nccl1 (against `f64_ref`). Returns
    (launches, the reference, coupled_nccl1's launches, f64mg_nccl1's)."""
    import torch
    import torch.distributed as dist

    from dealii_adapter_tpu_torch.parallel import make_device_mesh

    dev = torch.device("cuda", 0)
    init = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_nccl1_"), "init")
    dist.init_process_group("nccl", init_method="file://" + init,
                            world_size=1, rank=0)
    mesh = None
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
        t0 = time.perf_counter()
        f64 = f64mg_nccl1(mesh, f64_ref)
        log(f"f64mg_nccl1: took {time.perf_counter() - t0:.1f} s")
    finally:
        if mesh is not None:
            mesh.close()  # resets the graphs that captured NCCL work first
        else:
            dist.destroy_process_group()
    return launches, ref, coupled, f64


def _f64mg_shard_rank(mesh, n_steps, scale=None, cg_loop="host"):
    """One rank of f64mg_shard (a spawned process): `F64MG_SHARD_CELL` (at
    `scale`, by default its own) with the f64 hierarchy (`F64_MG`, K3 on
    every Q1 level) on the lattice partition, `cg_loop="host"` (f64mg_cards:
    "graphs"), on its own lam_max estimates; the slab checks of K3 f64,
    then `n_steps` steps from rest. Returns what the parent checks and logs (on the CPU too,
    where the kernels run their plain versions and nothing is counted)."""
    import torch

    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
    from dealii_adapter_tpu_torch.kernels import counters
    from dealii_adapter_tpu_torch.parallel.lattice import SlabOperator

    dev = mesh.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    model = build_linear_cell(
        F64MG_SHARD_CELL, dev, scale=scale, cg_loop=cg_loop, device_mesh=mesh,
        overrides=dict(F64_MG, mg_level_backend="auto"))
    mg = model._precond
    slabs = [lv.raw.op for lv in mg.levels[1:]
             if isinstance(lv.raw, SlabOperator)]
    g = torch.Generator(device=dev).manual_seed(41 + mesh.rank)
    out = dict(rank=mesh.rank, build_s=time.perf_counter() - t0,
               n_dofs=model.space.n_dofs, eager=bool(
                   model._graphs.eager and model._cg.eager),
               levels=[(lv.grid_shape, lv.layout.slab_shape if lv.layout
                        else None, str(lv.diag.dtype)) for lv in mg.levels],
               dtype=str(mg.dtype), lam_max=[lv.lam_max for lv in mg.levels],
               checks=slab_f64_checks(slabs, g))
    stress = model.local_rows(interface_traction(model))
    if cuda:
        start_counts()
    else:  # the CPU rehearsal: no library to bind
        counters.reset()
    state = model.initial_state()
    for k in ("cg", "residual", "times", "checksums", "calls", "syncs"):
        out[k] = []
    for _ in range(n_steps):
        sync()
        calls0, syncs0 = dict(mesh.calls), model.host_syncs
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        sync()
        out["times"].append(time.perf_counter() - ts)
        out["syncs"].append(model.host_syncs - syncs0)
        out["calls"].append({k: mesh.calls[k] - calls0[k] for k in calls0})
        u = state.displacement.reshape(-1)
        out["checksums"].append(float(mesh.all_reduce(torch.dot(u, u))))
        out["cg"].append(info.iterations)
        out["residual"].append(info.residual)
    out["launches"] = counters.launch_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    return out


def phase_f64mg_shard(ref, records, device="cuda:0", scale=None):
    """f64mg_shard (phase 16): `F64MG_SHARD_CELL` with the f64 hierarchy on
    `SHARD_RANKS` gloo ranks sharing card 0, against `ref`, the run of
    `f64mg_stencil auto` on one device (`phase_f64mg`); the slab checks go
    into the kernel records (`slab_checks`); returns the launches of all
    ranks. `device="cpu"` with a small `scale` (and a reference of that
    scale) rehearses it on the CPU."""
    import torch

    from dealii_adapter_tpu_torch.parallel import spawn

    n_steps = len(ref["checksums"])
    t0 = time.perf_counter()
    out = spawn(_f64mg_shard_rank, SHARD_RANKS, device, n_steps, scale,
                backend="gloo")
    log(f"f64mg_shard: {SHARD_RANKS} ranks on the {device} device over gloo, "
        f"eager CG, {out[0]['n_dofs']} DoF, ran in "
        f"{time.perf_counter() - t0:.1f} s (spawn, build and steps)")
    return check_f64mg_shard("f64mg_shard", out, ref, records,
                             torch.device(device).type == "cuda", eager=True,
                             rtol=F64MG_SHARD_RTOL, cg_slack=SHARD_CG_SLACK,
                             note="ranks sharing one card, not a scaling "
                                  "result")


def check_f64mg_shard(path, out, ref, records, cuda, eager, rtol, cg_slack,
                      note):
    """Log and check the ranks' results `out` of `_f64mg_shard_rank`
    against `ref` (`f64mg_stencil auto`'s run on one device): the bodies
    and CG eager (`eager`) or replayed, f64 throughout, lam_max within
    `F64MG_LAM_RTOL`, every residual <= 1e-10, CG within `cg_slack` a
    step, ||u||^2 after every step within `rtol`, every rank the same
    reduced values; returns the launches of all ranks."""
    by_name = {rec["name"]: rec for rec in records}
    ref_cg = [i.iterations for i in ref["infos"]]
    total = {}
    for r in out:
        tag = f"{path} rank {r['rank']}"
        lam_rel = max(abs(a - b) / abs(b)
                      for a, b in zip(r["lam_max"], ref["lam_max"]))
        log(f"{tag}: model built in {r['build_s']:.1f} s; hierarchy "
            f"{r['dtype']}, levels (lattice, slab or None = replicated, "
            f"dtype) {r['levels']}; lam_max {r['lam_max']} (one device: "
            f"{ref['lam_max']}, largest rel. difference {lam_rel:.3e}, limit "
            f"{F64MG_LAM_RTOL})")
        for c in r["checks"]:
            log(f"{tag}: {c['name']} at the slab {c['shape']} {c['dtype']}: "
                f"max abs err {c['max_abs_err']:.3e}, rel. L2 "
                f"{c['rel_l2_err']:.3e} (limit {c['limit']}); "
                + (f"{c['ms']:.4f} ms a call (CUDA events, median of 15; "
                   f"{note})" if c["ms"] is not None else "not timed"))
            if c["name"] in by_name:
                by_name[c["name"]].setdefault("slab_checks", []).append(
                    dict(c, rank=r["rank"], ranks=len(out), path=path))
        rels = [abs(a - b) / b for a, b in zip(r["checksums"],
                                               ref["checksums"])]
        log(f"{tag}: step times {r['times']} s ({note}); CG {r['cg']} (one "
            f"device: {ref_cg}); residuals {r['residual']}; read-backs "
            f"{r['syncs']} a step; collectives a step {r['calls']}; checksums "
            f"{r['checksums']} against one device's {ref['checksums']}: rel. "
            f"differences {[f'{x:.3e}' for x in rels]} (limit {rtol}); peak "
            f"device memory {r['peak_gib']:.2f} GiB")
        if cuda:
            read_counts(path, r["launches"])
            log(f"{tag}: launches {r['launches']}")
        require(r["eager"] == eager, f"{tag}: the step's bodies and CG run "
                + ("eagerly" if eager else "replayed from CUDA graphs"))
        require(r["dtype"] == "torch.float64"
                and all(d == "torch.float64" for _, _, d in r["levels"]),
                f"{tag}: every level of the hierarchy in f64")
        require(any(sl is not None for _, sl, _ in r["levels"][1:])
                and r["checks"], f"{tag}: a Q1 level on the rank's slab")
        if cuda:
            require(all(shape in F64_LEVELS_3D
                        for shape, _, _ in r["levels"][1:]),
                    f"{tag}: Q1 levels among phase 3's lattices")
        require(lam_rel <= F64MG_LAM_RTOL,
                f"{tag}: lam_max against one device's")
        require(all(x <= 1e-10 for x in r["residual"]),
                f"{tag}: every step's residual <= 1e-10")
        require(all(abs(a - b) <= cg_slack for a, b in zip(r["cg"], ref_cg)),
                f"{tag}: CG within {cg_slack} a step of one device's")
        require(max(rels) <= rtol, f"{tag}: checksums against one device's")
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    require(all(r["checksums"] == out[0]["checksums"]
                and r["cg"] == out[0]["cg"] for r in out),
            f"{path}: every rank read the same reduced values")
    return total


def f64mg_nccl1(mesh, ref):
    """f64mg_nccl1 (phase 16): `f64mg_stencil auto`'s cell, mesh and lam_max
    values on the world of one `mesh` (NCCL, this process), the CG and the
    step's bodies in CUDA graphs: `StepInfo` and ||u||^2 after every step
    bit for bit `ref`'s; returns the path's launches."""
    import torch

    dev = mesh.device
    t0 = time.perf_counter()
    model = build_linear_cell(
        F64MG_SHARD_CELL, dev, mesh_tags=ref["mesh_tags"],
        mg_lam_max=ref["lam_max"], device_mesh=mesh,
        overrides=dict(F64_MG, mg_level_backend="auto"))
    torch.cuda.synchronize()
    describe("f64mg_nccl1", model, time.perf_counter() - t0)
    require(model.cg_loop == "graphs" and mesh.backend == "nccl"
            and not model._graphs.eager,
            "f64mg_nccl1: NCCL, the CG and the step's bodies in CUDA graphs")
    f64_hierarchy_check("f64mg_nccl1", model, F64_LEVELS_3D)
    stress = model.local_rows(interface_traction(model))
    start_counts()
    _, infos, steps, _ = run_steps("f64mg_nccl1", model, stress, linear_fmt,
                                   n=len(ref["checksums"]))
    launches = read_counts("f64mg_nccl1")
    same = (infos == ref["infos"] and steps["checksums"] == ref["checksums"])
    log(f"f64mg_nccl1: launches {launches}; CG "
        f"{[i.iterations for i in infos]}, checksums {steps['checksums']} "
        f"against f64mg_stencil auto's {ref['checksums']}; bitwise {same}; "
        f"collectives {mesh.calls} (Python calls: those in the CUDA graphs "
        "counted once, at capture)")
    require(same, "f64mg_nccl1: StepInfo and checksums bit for bit "
            "f64mg_stencil auto's")
    del model
    torch.cuda.empty_cache()
    return launches


def _shard_cells_rank(mesh, cg_loop="host"):
    """One rank of shard_cells (`cg_loop="host"`, gloo ranks sharing the
    card) or shard_cells_cards (`"graphs"`, a card a rank over NCCL)."""
    import torch

    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
    from dealii_adapter_tpu_torch.kernels import counters

    calls0 = dict(mesh.calls)
    model = build_model(mesh.device, scale=SHARD_CELLS_SCALE, cg_loop=cg_loop,
                        device_mesh=mesh, **SHARD_CELLS)
    stress = model.local_rows(interface_traction(model))
    start_counts()
    state = model.initial_state()
    out = dict(rank=mesh.rank, newton=[], cg=[], times=[], converged=[],
               outside=[])
    for _ in range(SHARD_CELLS_STEPS):
        torch.cuda.synchronize()
        outside0 = model.host_syncs - model.cg_host_syncs
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        torch.cuda.synchronize()
        out["times"].append(time.perf_counter() - ts)
        out["outside"].append(model.host_syncs - model.cg_host_syncs - outside0)
        out["newton"].append(info.iterations)
        out["cg"].append(info.cg_iterations)
        out["converged"].append(info.converged)
    u = state.displacement.reshape(-1)
    out["checksum"] = float(torch.dot(u, u))  # replicated
    out["launches"] = counters.launch_counts()
    out["calls"] = {k: mesh.calls[k] - calls0[k] for k in calls0}
    return out


def phase_shard_cells(ref):
    """shard_cells (phase 13): the cell partition on `SHARD_RANKS` gloo
    ranks sharing card 0 against its one-rank reference; returns the
    launches of all ranks."""
    from dealii_adapter_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    out = spawn(_shard_cells_rank, SHARD_RANKS, "cuda:0", backend="gloo")
    log(f"shard_cells: {SHARD_RANKS} ranks on card 0 over gloo at scale "
        f"{SHARD_CELLS_SCALE} ({ref['n_dofs']} DoF), eager CG, ran in "
        f"{time.perf_counter() - t0:.1f} s (spawn, build and steps)")
    return check_shard_cells("shard_cells", out, ref)


def check_shard_cells(path, out, ref):
    """Log and check the ranks' results `out` of `_shard_cells_rank`
    against the one-rank reference `ref`: every step converged, Newton
    counts equal, CG within `SHARD_CG_SLACK` a solve, ||u||^2 within
    `SHARD_RTOL`; returns the launches of all ranks."""
    total = {}
    for r in out:
        tag = f"{path} rank {r['rank']}"
        rel = abs(r["checksum"] - ref["checksum"]) / ref["checksum"]
        log(f"{tag}: step times {r['times']} s; Newton {r['newton']}, CG "
            f"{r['cg']} (one rank: {ref['newton']}, {ref['cg']}, "
            f"{ref['times']} s); read-backs outside the CG {r['outside']} a "
            f"step; collectives {r['calls']}; checksum "
            f"{r['checksum']!r} against one rank's {ref['checksum']!r}: rel. "
            f"difference {rel:.3e} (limit {SHARD_RTOL})")
        read_counts(path, r["launches"])
        require(all(r["converged"]), f"{tag}: every step converged")
        require(r["newton"] == ref["newton"], f"{tag}: Newton counts equal")
        require_newton_syncs(tag, r["outside"], r["newton"])
        require(all(abs(a - b) <= SHARD_CG_SLACK * n
                    for a, b, n in zip(r["cg"], ref["cg"], r["newton"])),
                f"{tag}: CG within {SHARD_CG_SLACK} a solve")
        require(rel <= SHARD_RTOL, f"{tag}: checksum against one rank's")
        for k, n in r["launches"].items():
            total[k] = total.get(k, 0) + n
    return total


def phase_dryrun(n_ranks=SHARD_RANKS, backend="gloo", path="dryrun"):
    """dryrun (phase 13): `dryrun_multichip(SHARD_RANKS, "cuda")` on gloo
    ranks sharing card 0 (the eager CG); dryrun_cards: `n_ranks` ranks on
    cards of their own over NCCL (`backend=None`: the backend rule's
    choice, which must be NCCL; the CG in CUDA graphs). Returns the
    launches of all ranks."""
    from dealii_adapter_tpu_torch.parallel.dryrun import dryrun_multichip

    info = dryrun_multichip(n_ranks, "cuda", backend=backend)
    log(f"{path}: {info}")
    want = ("gloo", "host") if backend == "gloo" else ("nccl", "graphs")
    require((info["backend"], info["cg_loop"]) == want,
            f"{path}: backend and CG loop {want}")
    total = {}
    for launches in info["launches"]:
        read_counts(path, launches)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


def exchange_records(model):
    """exchange_cards (one rank's part, run after shard3d_cards' steps on
    its model): one halo fill and one interface sum of seeded f32 vectors
    at the fine lattice (`model._lat`, degree 2) and at the FEM-SEM level
    (the first Q1 level, on the same nodes), in each form of
    `EXCHANGE_FORMS` on the same input: the forms' results bit for bit,
    each form's bytes (p2p: the plane a neighbour needs; all_reduce: the
    buffer of one slot a rank), its CUDA-event time (`cuda_ms`, median of
    15) eager and replayed from a CUDA graph of the one call, and whether
    the replay equals the eager call bit for bit. Every rank runs the
    same calls in the same order."""
    import torch

    from dealii_adapter_tpu_torch.solvers.graphs import capture

    lat = model._lat
    mesh, dev = lat.mesh, model.device
    g = torch.Generator(device=dev).manual_seed(23 + mesh.rank)

    def in_form(form, fn):
        mesh.slot_exchange = form == "all_reduce"
        try:
            require(mesh.exchange_form(v) == form, f"exchange_cards: {form}")
            return fn()
        finally:
            mesh.slot_exchange = False

    rows = []
    for level, lay in (("fine", lat), ("FEM-SEM", model._precond.levels[1].layout)):
        v = torch.randn((lay.n_owned, 3), generator=g, device=dev)
        y = torch.randn(lay.slab_shape + (3,), generator=g, device=dev)
        plane = math.prod(n for a, n in enumerate(lay.grid_shape)
                          if a != lay.axis) * 3 * 4
        for op, call in (
                ("fill", lambda f: in_form(f, lambda: lay.fill(v))),
                ("interface_sum",
                 lambda f: in_form(f, lambda: lay.interface_sum(y)))):
            eager = {f: call(f) for f in EXCHANGE_FORMS}
            row = dict(level=level, op=op, lattice=list(lay.grid_shape),
                       p=lay.p, plane_bytes=plane,
                       bitwise=torch.equal(eager["p2p"], eager["all_reduce"]))
            for f in EXCHANGE_FORMS:
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):  # the warm-up before a capture
                    call(f)
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with capture(graph):
                    replayed = call(f)
                graph.replay()
                torch.cuda.synchronize(dev)
                row[f] = dict(
                    bytes=plane if f == "p2p" else mesh.world * plane,
                    eager_ms=cuda_ms(lambda: call(f)),
                    replay_ms=cuda_ms(graph.replay),
                    replay_equal=torch.equal(replayed, eager[f]))
                del graph
            rows.append(row)
    return rows


def _shard3d_slots_rank(mesh, *args):
    """`_shard3d_rank` with the halo exchanges as the slot all-reduce
    where the rule would send between neighbours (`slot_exchange`): the
    end-to-end side of exchange_cards' comparison."""
    mesh.slot_exchange = True
    try:
        return _shard3d_rank(mesh, *args)
    finally:
        mesh.slot_exchange = False


def _cards_rank(mesh, lam_max, coupled_lam_max, f64_steps):
    """One rank of a separate-card world (a spawned process, its own card,
    NCCL): shard3d_cards (the CUDA graphs, then exchange_cards on its
    model), its twin with the exchanges as the slot all-reduce, its
    host-loop twin, f64mg_cards, shard_cells_cards and coupled_cards, in
    this order on every rank; returns each one's results with its
    seconds."""
    import gc

    import torch

    out = {}
    for name, fn, args in (
            ("shard3d_cards", _shard3d_rank,
             (mesh, lam_max, CARD_STEPS, None, "graphs", exchange_records)),
            ("shard3d_cards all_reduce", _shard3d_slots_rank,
             (mesh, lam_max, CARD_STEPS, None, "graphs", None, False)),
            ("shard3d_cards host", _shard3d_rank,
             (mesh, lam_max, CARD_HOST_STEPS, None, "host", None, False)),
            ("f64mg_cards", _f64mg_shard_rank, (mesh, f64_steps, None, "graphs")),
            ("shard_cells_cards", _shard_cells_rank, (mesh, "graphs")),
            ("coupled_cards", _coupled_shard_rank,
             (mesh, coupled_lam_max, "graphs"))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        out[name]["phase_s"] = time.perf_counter() - t0
    return out


def card_worlds(n_cards, asked=None):
    """The worlds of the separate-card phases: 2 and min(4, cards) ranks,
    or 2 and `asked` (`--cards`); none on one card."""
    if asked is not None:
        return sorted({2, asked})
    return sorted({2, min(4, n_cards)}) if n_cards >= 2 else []


def phase_cards(world, parallel, cells_ref, f64_ref, records):
    """The separate-card phases (17) of one world: `world` ranks spawned
    one a card over NCCL (`_cards_rank`), each on its own card (the
    current device), every CG and body replayed from CUDA graphs:
    shard3d_cards against main3d (`check_shard3d`) and its host-loop twin
    against the graphs run (NewtonInfo equal, ||u||^2 within
    `LOOPS_RTOL`, bitwise logged), the per-card step times beside
    main3d's, exchange_cards, f64mg_cards (CG equal to one device's,
    `F64MG_CARDS_RTOL`), shard_cells_cards and coupled_cards against
    their shared-card phases' references. Returns {path: launches of all
    ranks}."""
    import torch

    from dealii_adapter_tpu_torch.parallel import spawn

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = spawn(_cards_rank, world, "cuda", parallel["lam_max"],
                parallel["coupled"]["lam_max"], len(f64_ref["checksums"]),
                backend="nccl", timeout_s=CARDS_TIMEOUT_S)
    log(f"cards {world}: {world} ranks, one a card over NCCL, ran in "
        f"{time.perf_counter() - t0:.1f} s (spawn, builds, steps); seconds "
        f"a phase on rank 0 {[(k, round(v['phase_s'], 1)) for k, v in out[0].items()]}")
    note = "a card a rank over NCCL"
    by_path = {}
    sh = [r["shard3d_cards"] for r in out]
    host = [r["shard3d_cards host"] for r in out]
    for x in sh + host:
        require(x["backend"] == "nccl" and x["current"] == x["rank"]
                and x["device"] == f"cuda:{x['rank']}",
                f"cards {world}: rank {x['rank']} on its own card over NCCL, "
                f"made current ({x['device']}, current {x['current']})")
    require(all(x["cg_loop"] == "graphs" and not x["eager"] for x in sh)
            and all(x["cg_loop"] == "host" and x["eager"] for x in host),
            f"cards {world}: the CUDA graphs and the host loop as named")
    slots = [r["shard3d_cards all_reduce"] for r in out]
    tag = f"shard3d_cards {world}"
    by_path[tag] = check_shard3d(tag, tag, sh, parallel, records, note)
    by_path[f"{tag} all_reduce"] = check_shard3d(
        f"{tag} all_reduce", f"{tag} all_reduce", slots, parallel, records,
        note + ", the exchanges as the slot all-reduce")
    by_path[f"{tag} host"] = check_shard3d(f"{tag} host", f"{tag} host",
                                           host, parallel, records, note)
    require(all(sum(c["p2p"] for c in x["calls"]) > 0 for x in sh)
            and all(sum(c["p2p"] for c in x["calls"]) == 0 for x in slots),
            f"{tag}: the exchanges between neighbours, its all_reduce twin's "
            "as the slot all-reduce")
    for twin, runs in (("host loop", host), ("slot all-reduce", slots)):
        for g, h in zip(sh, runs):
            n = len(h["checksums"])
            rels = [abs(a - b) / b
                    for a, b in zip(h["checksums"], g["checksums"])]
            bitwise = (h["infos"] == g["infos"][:n]
                       and h["checksums"] == g["checksums"][:n])
            log(f"{tag} rank {g['rank']}: the {twin} against the CUDA graphs "
                f"over {n} steps: NewtonInfo equal "
                f"{h['infos'] == g['infos'][:n]}, checksums {h['checksums']} "
                f"against {g['checksums'][:n]}: rel. differences "
                f"{[f'{x:.3e}' for x in rels]} (limit {LOOPS_RTOL}); "
                f"bitwise {bitwise}")
            require(h["infos"] == g["infos"][:n] and max(rels) <= LOOPS_RTOL,
                    f"{tag} rank {g['rank']}: the {twin}'s NewtonInfo and "
                    "checksums against the CUDA graphs'")
    med = [statistics.median(x["times"][1:]) for x in sh]
    med_slots = [statistics.median(x["times"][1:]) for x in slots]
    log(f"{tag}: per-card step time by exchange form, median of "
        f"{CARD_STEPS - 1} timed steps after 1 warmup, by rank: p2p {med} s, "
        f"slot all-reduce {med_slots} s (run after p2p on the same cards); "
        f"slowest rank all-reduce / p2p {max(med_slots) / max(med):.4f}")
    main_med = statistics.median(parallel["times"])
    log(f"{tag}: per-card step time, median of {CARD_STEPS - 1} timed steps "
        f"after 1 warmup, by rank {med} s; main3d on one card in this run "
        f"{main_med!r} s ({parallel['times']}); slowest rank / main3d "
        f"{max(med) / main_med:.3f}; collectives a step (the host loop's "
        f"count, one Python call each; the graphs replay the same) "
        f"{host[0]['calls'][-1]}; read-backs a step {sh[0]['syncs']} "
        f"(host loop {host[0]['syncs']}); peak device memory per card "
        f"{[round(x['peak_gib'], 3) for x in sh]} GiB")
    rows = []
    for i, row in enumerate(sh[0]["after"]):
        ranks = [x["after"][i] for x in sh]
        merged = dict(row, world=world,
                      bitwise=all(r["bitwise"] for r in ranks))
        for f in EXCHANGE_FORMS:
            merged[f] = dict(
                bytes=row[f]["bytes"],
                eager_ms=max(r[f]["eager_ms"] for r in ranks),
                replay_ms=max(r[f]["replay_ms"] for r in ranks),
                replay_equal=all(r[f]["replay_equal"] for r in ranks))
        rows.append(merged)
        log(f"exchange_cards {world}: {merged['level']} {merged['op']} on "
            f"{merged['lattice']} (degree {merged['p']}): p2p bit for bit the "
            f"all-reduce {merged['bitwise']}; "
            + "; ".join(f"{f} {merged[f]['bytes']} B, eager "
                        f"{merged[f]['eager_ms']:.4f} ms, replayed "
                        f"{merged[f]['replay_ms']:.4f} ms (replay equal "
                        f"{merged[f]['replay_equal']})" for f in EXCHANGE_FORMS)
            + " (CUDA events, median of 15, the slowest rank)")
        require(merged["bitwise"] and all(merged[f]["replay_equal"]
                                          for f in EXCHANGE_FORMS),
                f"exchange_cards {world}: {merged['level']} {merged['op']}: "
                "p2p equals the all-reduce, replays equal the eager calls")
    log(f"exchange_cards {world}: {json.dumps(rows)}")
    by_path[f"f64mg_cards {world}"] = check_f64mg_shard(
        f"f64mg_cards {world}", [r["f64mg_cards"] for r in out], f64_ref,
        records, True, eager=False, rtol=F64MG_CARDS_RTOL, cg_slack=0,
        note=note)
    by_path[f"shard_cells_cards {world}"] = check_shard_cells(
        f"shard_cells_cards {world}", [r["shard_cells_cards"] for r in out],
        cells_ref)
    by_path[f"coupled_cards {world}"] = check_coupled_shard(
        f"coupled_cards {world}", [r["coupled_cards"] for r in out],
        parallel["coupled"])
    return by_path


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step of each path after its checks")
    ap.add_argument("--cards", type=int, default=None, metavar="N",
                    help="run the device, build and kernels phases, the "
                         "one-card references of the separate-card phases "
                         "and those phases on 2 and N cards (N >= 2; fails "
                         "with fewer visible)")
    args = ap.parse_args()

    import torch

    phase_device()
    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)

    n_cards = torch.cuda.device_count()
    if args.cards is not None:
        require(args.cards >= 2, f"--cards {args.cards}: N must be 2 or more")
        require(n_cards >= args.cards,
                f"--cards {args.cards}: {n_cards} cards visible")
    worlds = card_worlds(n_cards, args.cards)
    full = args.cards is None  # every phase, not only the cards' references
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
    if full:
        by_path.update(timed("bench", phase_bench))
        by_path.update(timed("tangent3d", phase_tangent3d, main_run))
        by_path.update(timed("jvp", phase_jvp, main_run))
    by_path["stencil3d"], model, checksum = timed(
        "stencil3d", phase_stencil3d, main_run)
    parallel = {k: main_run[k] for k in ("mesh_tags", "lam_max", "checksum",
                                         "checksums", "cg", "newton", "times",
                                         "jvp3d") if k in main_run}
    del main_run
    by_path["coupled3d"], parallel["coupled"] = timed(
        "coupled3d", phase_coupled3d, model, checksum)
    del model
    torch.cuda.empty_cache()
    if full:
        by_path["linear2d"] = timed("linear2d", phase_linear2d, args.profile)
        by_path.update(timed("linear_loops", phase_linear_loops))
    paths, f64_ref = timed("f64mg", phase_f64mg)
    by_path.update(paths)
    if full:
        by_path["nonlinear2d"] = timed("nonlinear2d", phase_nonlinear2d,
                                       args.profile)
        by_path.update(timed("vcycle_bf16", phase_vcycle_bf16))
    by_path["cli"], cli_u2 = timed("cli", phase_cli)
    if full:
        by_path["cli_nl"] = timed("cli_nl", phase_cli_nl)
    # cli_ranks and dryrun pick their backend from the visible cards were
    # they not pinned to gloo and card 0: --cards runs them too
    by_path["cli_ranks"] = timed("cli_ranks", phase_cli_ranks, cli_u2)
    if full:
        by_path["golden_nl"] = timed("golden_nl", phase_golden_nl)
        by_path["gather3d"] = timed("gather3d", phase_gather3d, parallel)
        by_path["shard3d"] = timed("shard3d", phase_shard3d, parallel, records)
    (by_path["shard3d_nccl1"], cells_ref, by_path["coupled_nccl1"],
     by_path["f64mg_nccl1"]) = timed("shard3d_nccl1", phase_shard3d_nccl1,
                                     parallel, f64_ref)
    if full:
        by_path["shard_cells"] = timed("shard_cells", phase_shard_cells,
                                       cells_ref)
        by_path["f64mg_shard"] = timed("f64mg_shard", phase_f64mg_shard,
                                       f64_ref, records)
    by_path["dryrun"] = timed("dryrun", phase_dryrun)
    if full:
        by_path["coupled_shard"] = timed("coupled_shard", phase_coupled_shard,
                                         parallel)
    if not worlds:
        log(f"separate-card phases (shard3d_cards, exchange_cards, "
            f"f64mg_cards, shard_cells_cards, coupled_cards, cli_cards, "
            f"dryrun_cards) need 2 or more cards; {n_cards} visible: not run")
    for w in worlds:
        by_path.update(timed(f"cards {w}", phase_cards, w, parallel,
                             cells_ref, f64_ref, records))
    if worlds:
        w = worlds[-1]
        by_path[f"cli_cards {w}"] = timed(f"cli_cards {w}", phase_cli_ranks,
                                          cli_u2, w, True)
        by_path[f"dryrun_cards {w}"] = timed(
            f"dryrun_cards {w}", phase_dryrun, w, None, f"dryrun_cards {w}")
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
