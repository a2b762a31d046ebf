#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (each prints on its own lines; a failing phase raises and the
script exits non-zero without printing a result):

1. device  — require CUDA; print `nvidia-smi --query-gpu=name,power.limit`.
2. build   — compile the package's CUDA kernels (sm_90a) from csrc/.
3. kernels — each hand-written kernel against its plain PyTorch version
   on seeded random inputs at the main path's shapes, with CUDA-event
   times (median of 25 applications after warmup) of both.
   Limits: relative L2 error <= 1e-5 for f32 output (only the summation
   order differs), <= 1e-2 for bf16 output (one output rounding, 2^-8,
   plus order).
4. main    — `NonlinearElasticity` with the benchmark configuration of
   `bench.py` (3D Neo-Hookean perpendicular flap, Q2, scale 9:
   1,018,875 DoF), traction 1000 in x on the interface, 1 warmup and 3
   timed Newmark steps. Every step must converge, the kernel launch
   counts of the run must all be positive, and the checksum ||u||^2 must
   lie within rtol 1e-4 of the JAX package's 49.05486138743322 (Newton's
   tol_u of 1e-6 bounds the spread near 1e-5). `--profile` adds one more
   step under torch.profiler and prints its device-time table.

The line before the last is the JSON kernel record; the last line is
`{"ok": true, "device": {...}}`.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

CHECKSUM_REF = 49.05486138743322  # JAX package, BENCH_r05.json tail
CHECKSUM_RTOL = 1e-4
F32_RTOL = 1e-5
BF16_RTOL = 1e-2
SCALE = 9


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
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0:.1f} s) "
        f"-> {_build.BUILD_DIR / _build.LIB_NAME}")


def lattice_E(p, h, lmbda, mu, mass_coeff):
    """Element matrix mu*K + mass_coeff*M of one degree-p cell of edge h."""
    from dealii_adapter_tpu_torch.fem.dofspace import DofSpace
    from dealii_adapter_tpu_torch.mesh.generator import subdivided_hyper_rectangle
    from dealii_adapter_tpu_torch.ops.element_ops import ElementMatrices

    m = subdivided_hyper_rectangle((1, 1, 1), (0.0, 0.0, 0.0), h, p)
    el = ElementMatrices(DofSpace.create(m), lmbda / mu, 1.0, 1.0)
    return mu * el.K_e + mass_coeff * el.M_e


def phase_kernels():
    import numpy as np
    import torch

    from dealii_adapter_tpu_torch.ops import assembled_tangent as at
    from dealii_adapter_tpu_torch.ops.q1_structured import Q1StructuredOperator
    from dealii_adapter_tpu_torch.ops.q2_structured import Q2StructuredOperator

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, dtype=torch.float32).to(dev, dtype)

    records = []
    # main-path shapes: 39,366 Q2 cells, (19, 325, 55) node lattice
    n_cells, edofs = 27 * 162 * 9, 81
    lattice = (19, 325, 55)
    n_nodes = int(np.prod(lattice))

    # K1: assembled-tangent matvec, f32
    KT = randn(edofs, edofs, n_cells)
    u2 = randn(edofs, n_cells)
    out = at.apply_packed_tangents_T(KT, u2)
    ref = at.apply_packed_tangents_T_plain(KT, u2)
    torch.cuda.synchronize()
    mx, rel = compare(out, ref)
    rec = dict(
        name="K1 tangent_matvec", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/tangent_matvec.cu",
        replaces="dealii_adapter_tpu/ops/assembled_tangent.py:510",
        shape=f"KT {edofs}x{edofs}x{n_cells} f32",
        max_abs_err=mx, rel_l2_err=rel, limit=F32_RTOL,
        ms=cuda_ms(lambda: at.apply_packed_tangents_T(KT, u2)),
        plain_ms=cuda_ms(lambda: at.apply_packed_tangents_T_plain(KT, u2)),
    )
    log(f"kernel K1: rel_l2 {rel:.3e} max_abs {mx:.3e}  "
        f"{rec['ms']:.4f} ms vs plain {rec['plain_ms']:.4f} ms")
    require(rel <= F32_RTOL, rec)
    records.append(rec)
    del KT, u2, out, ref
    torch.cuda.empty_cache()

    # K3: Q1 level operator on the FEM-SEM lattice with the anisotropic E
    # of the first semi-coarsened level (cells 27 x 162 x 18 of the
    # 0.1 x 1.0 x 0.3 flap), bf16 (main path) and f32
    mu, nu, rho, dt, beta = 0.5e6, 0.4, 1000.0, 0.01, 0.25
    kappa = 2 * mu * (1 + nu) / (3 * (1 - 2 * nu))
    lam_eff = kappa - 2.0 * mu / 3
    mass = rho / (beta * dt * dt)
    E1 = lattice_E(1, (0.1 / 27, 1.0 / 162, 0.3 / 18), lam_eff, mu, mass)
    checks = []
    for dtype, lim in ((torch.bfloat16, BF16_RTOL), (torch.float32, F32_RTOL)):
        op = Q1StructuredOperator(E1, lattice, dtype, dev)
        u = randn(n_nodes, 3, dtype=dtype)
        mx, rel = compare(op(u), op.plain(u))
        chk = dict(
            dtype=str(dtype).replace("torch.", ""), max_abs_err=mx,
            rel_l2_err=rel, limit=lim, ms=cuda_ms(lambda: op(u)),
            plain_ms=cuda_ms(lambda: op.plain(u)),
        )
        log(f"kernel K3 {chk['dtype']}: rel_l2 {rel:.3e} max_abs {mx:.3e}  "
            f"{chk['ms']:.4f} ms vs plain {chk['plain_ms']:.4f} ms")
        require(rel <= lim, chk)
        checks.append(chk)
    records.append(dict(
        name="K3 q1_structured", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q1_structured.cu",
        replaces="dealii_adapter_tpu/ops/pallas_structured.py:345",
        shape=f"lattice {lattice} x 3, E 24x24",
        **{k: checks[0][k] for k in ("max_abs_err", "rel_l2_err", "limit",
                                      "ms", "plain_ms", "dtype")},
        other_checks=checks[1:],
    ))

    # K5: Q2 fine proxy, bf16, with the small-strain proxy element matrix
    E2 = lattice_E(2, (0.1 / 27, 1.0 / 162, 0.3 / 9), lam_eff, mu, mass)
    op = Q2StructuredOperator(E2, lattice, torch.bfloat16, dev)
    u = randn(n_nodes, 3, dtype=torch.bfloat16)
    mx, rel = compare(op(u), op.plain(u))
    rec = dict(
        name="K5 q2_structured", route="cuda",
        source="dealii_adapter_tpu_torch/csrc/q2_structured.cu",
        replaces="dealii_adapter_tpu/ops/pallas_phase.py:121",
        shape=f"lattice {lattice} x 3, E 81x81", dtype="bfloat16",
        max_abs_err=mx, rel_l2_err=rel, limit=BF16_RTOL,
        ms=cuda_ms(lambda: op(u)), plain_ms=cuda_ms(lambda: op.plain(u)),
    )
    log(f"kernel K5 bf16: rel_l2 {rel:.3e} max_abs {mx:.3e}  "
        f"{rec['ms']:.4f} ms vs plain {rec['plain_ms']:.4f} ms")
    require(rel <= BF16_RTOL, rec)
    records.append(rec)
    return records


def build_model(device):
    """The benchmark configuration of bench.py's build_model (its
    environment defaults), on the port."""
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
        NonlinearElasticity,
    )

    params = AllParameters(
        model="neo-Hookean", type_lin="CG", scenario="PF", dim=3,
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
    mesh, tags = make_scenario_grid(
        "PF", 3, 2, scale=SCALE, solver="neo-Hookean"
    )
    return NonlinearElasticity(params, mesh=mesh, tags=tags, device=device)


def counters():
    from dealii_adapter_tpu_torch.ops import assembled_tangent as at
    from dealii_adapter_tpu_torch.ops.q1_structured import Q1StructuredOperator
    from dealii_adapter_tpu_torch.ops.q2_structured import Q2StructuredOperator

    return {
        "K1 tangent_matvec": at.apply_packed_tangents_T,
        "K3 q1_structured": Q1StructuredOperator,
        "K5 q2_structured": Q2StructuredOperator,
    }


def phase_main(profile):
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = build_model(dev)
    torch.cuda.synchronize()
    levels = model._precond.levels
    log(f"main: model built in {time.perf_counter() - t0:.1f} s, "
        f"{model.space.n_dofs} DoF, {len(levels)} MG levels "
        f"{[lv.grid_shape for lv in levels]}, lam_max "
        f"{[round(lv.lam_max, 6) for lv in levels]}")
    torch.cuda.reset_peak_memory_stats()
    stress = torch.zeros((model.space.n_nodes, 3), dtype=torch.float64, device=dev)
    iface = torch.as_tensor(model.space.boundary_nodes[model.interface_id], device=dev)
    stress[iface, 0] = 1000.0

    for obj in counters().values():
        obj.launches = 0
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
        log(f"main: step {i} ({'warmup' if i == 0 else 'timed'}) "
            f"{times[-1]:.4f} s: newton {info.iterations} cg {info.cg_iterations} "
            f"f64 {info.f64_evals} f32 {info.f32_evals} asm "
            f"{info.tangent_assemblies} converged {info.converged}")
    launches = {k: obj.launches for k, obj in counters().items()}

    u = state.displacement
    require(tuple(u.shape) == (model.space.n_nodes, 3), f"shape {tuple(u.shape)}")
    require(bool(torch.isfinite(u).all()), "non-finite displacement")
    info = infos[-1]
    max_u = u.abs().max().item()
    timed = times[1:]
    log(f"main: last step newton_its {info.iterations} cg_its "
        f"{info.cg_iterations} f64_evals {info.f64_evals} f32_evals "
        f"{info.f32_evals} tangent_asm {info.tangent_assemblies} min_det_F "
        f"{info.min_det_F!r} max_u {max_u!r} checksum {checksum!r}")
    log(f"main: timed steps {timed} s; mean {statistics.mean(timed):.4f} s/step, "
        f"{model.space.n_dofs / 1e6 * len(timed) / sum(timed):.4f} MDoF*steps/s; "
        f"host syncs {model.host_syncs} over 4 steps")
    log(f"main: launches {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(all(i.converged for i in infos), "every step converged")
    rel = abs(checksum - CHECKSUM_REF) / CHECKSUM_REF
    log(f"main: checksum rel. difference to the JAX package {rel:.3e} "
        f"(limit {CHECKSUM_RTOL})")
    require(rel <= CHECKSUM_RTOL, f"checksum {checksum!r} vs {CHECKSUM_REF!r}")
    missing = [k for k, n in launches.items() if n <= 0]
    require(not missing, f"kernels launched on the main path: missing {missing}")

    if profile:
        from torch.profiler import ProfilerActivity, profile as prof

        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            ts = time.perf_counter()
            model.step(state, stress)
            torch.cuda.synchronize()
            wall = time.perf_counter() - ts
        from torch.autograd import DeviceType

        ka = p.key_averages()
        # kernels only: the aten ops that launched them carry the same time
        dev_us = sum(
            e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA
        )
        log(ka.table(sort_by="self_device_time_total", row_limit=30))
        log(f"profile: step wall {wall * 1e3:.1f} ms (profiled), device busy "
            f"{dev_us / 1e3:.1f} ms = {dev_us / 1e4 / wall:.1f}% of the wall")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra step after the checks")
    args = ap.parse_args()

    import torch

    phase_device()
    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)

    phase_build()
    records = phase_kernels()
    launches = phase_main(args.profile)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        for k, v in list(rec.items()):
            if isinstance(v, float) and not math.isfinite(v):
                raise RuntimeError(f"non-finite {k} in {rec['name']}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
