#!/usr/bin/env python3
"""Benchmark of the PyTorch port — prints ONE JSON line.

    python3 bench_torch.py [--device cpu]

The port's counterpart of `bench.py`: the same cells, built with the same
`AllParameters` (`nonlinear_config`, `linear_config`: `bench.py:58-183`
and the environment knobs it reads), run through
`dealii_adapter_tpu_torch` on the CUDA card. `--device cpu` (or
`BENCH_DEVICE=cpu`) runs the plain versions on the CPU, for the tests
only; without a card and without it the run raises.

Cells (environment knobs as bench.py's):

    (default)                                  Neo-Hookean, Q2, scale 9: 1,018,875 DoF
    BENCH_DEGREE=4 BENCH_SCALE=4               Neo-Hookean, Q4: 722,211 DoF
    BENCH_MODEL=linear                         linear theta-scheme, Q2, scale 4: 97,875 DoF
    BENCH_MODEL=linear BENCH_DEGREE=3 BENCH_SCALE=3   linear, Q3: 136,920 DoF

`BENCH_MODEL` (nonlinear | linear), `BENCH_SCALE` (9 nonlinear, 4
linear), `BENCH_STEPS` (3), `BENCH_DTYPE` (float64), `BENCH_DEGREE` (2)
and the solver knobs of bench.py's `build_model` and `build_linear_model`.
`BENCH_USE_PALLAS=0` raises: the port has no kernels-off mode on the card.
Not read: bench.py's TPU-side knobs (the CPU baseline, the tunecache
sidecar, the compile cache, the watchdog and the retry).

Timing (bench.py:185-260's contract): traction 1000 in x on the interface,
one warmup step, then `BENCH_STEPS` timed steps; each step's host clock
stops after a read-back of ||u||^2, and its CUDA-event time is recorded
beside it. Per-step diagnostics go to stderr: Newton and CG iterations,
f64 and f32 residual evaluations, tangent assemblies, convergence,
min det F, host read-backs and kernel launches (`kernels/counters.py`);
for the linear model CG iterations and the final absolute residual.

Checks before the number (a failed check exits 1 without the JSON line):
every Neo-Hookean step converged; every linear step's residual is at most
1e-10 (the reference's absolute contract); ||u||^2 after the last step
within the cell's rtol of the JAX package's value (`REFERENCES`) where the
cell runs its defaults (no solver knob set, float64, 3 timed steps).

Output: the last line of stdout, `{"metric", "value" (MDoF*steps/s),
"unit", "s_per_step", "n_dofs", "degree", "device"}` (`device`: the
card's name and power limit as nvidia-smi prints them).

Then the plausibility floor (bench.py:320-600's, kept a lower bound):
each component's device time is timed with CUDA events as (long chain -
short chain) / (difference in length), each chain a CUDA graph of
back-to-back calls; for every timed step, floor = 0.5 x (f64 evaluations x
t_f64 + f32 evaluations x t_f32 + assemblies x t_asm + CG iterations x
(t_operator + t_preconditioner)), the linear model's 0.5 x CG iterations x
t_operator. A component whose chain difference is not positive is left
out of the floor, never replaced by a guess. A step faster than its floor
exits 3. Nothing is persisted between runs.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

NONLINEAR_METRIC = "nonlinear_flap_3d_mdof_newmark_steps_per_s"
LINEAR_METRIC = "linear_flap_3d_mdof_theta_steps_per_s"
TRACTION = 1000.0
LINEAR_RESIDUAL_MAX = 1e-10  # the reference's absolute CG contract

# ||u||^2 after 1 warmup + 3 timed steps of each cell, the JAX package on
# the CPU with bench.py's defaults, and the rtol it is held to (Newton's
# tol_u of 1e-6 bounds the Neo-Hookean spread near 1e-5; both linear
# solves meet the absolute 1e-10 residual):
#   JAX_PLATFORMS=cpu python tools/jax_reference_bench.py linear
#   JAX_PLATFORMS=cpu python tools/jax_reference_bench.py linear \
#       --degree 3 --scale 3
#   JAX_PLATFORMS=cpu python tools/jax_reference_bench.py nonlinear \
#       --degree 4 --scale 4
# (the Q2 value is the JAX package's own bench.py checksum, BENCH_r05.json)
# {(model, degree, scale): (||u||^2, rtol)}
REFERENCES = {
    ("nonlinear", 2, 9): (49.05486138743322, 1e-4),
    ("nonlinear", 4, 4): (34.77847093602825, 1e-4),
    ("linear", 2, 4): (0.32154438189331797, 1e-6),
    ("linear", 3, 3): (0.4496516988094284, 1e-6),
}
# the knobs that change a cell's numerics: a set one leaves the reference
# check out
SOLVER_KNOBS = (
    "BENCH_PRECOND", "BENCH_PRECOND_DTYPE", "BENCH_SOLVE_DTYPE",
    "BENCH_FORCING", "BENCH_MG_DEGREE", "BENCH_MG_FINE_DEGREE",
    "BENCH_PREDICTOR", "BENCH_EW_ETA0", "BENCH_MG_FINE_TANGENT",
    "BENCH_TANGENT_PRECISION", "BENCH_TANGENT_SYM", "BENCH_TANGENT_KERNEL",
    "BENCH_TANGENT_REUSE", "BENCH_TANGENT_REUSE_AFTER",
    "BENCH_TANGENT_REFRESH_RATIO", "BENCH_F64_WINDOW", "BENCH_SUMFACT",
)
# chain lengths (short, long) of the floor's components
CHAINS = {"t_f64": (2, 10), "t_f32": (2, 10), "t_asm": (2, 6),
          "t_operator": (2, 12), "t_preconditioner": (2, 12)}


def log(msg):
    print(f"bench_torch: {msg}", file=sys.stderr, flush=True)


def _env(name, default):
    return os.environ.get(name, default)


def _check_pallas():
    if _env("BENCH_USE_PALLAS", "1") != "1":
        raise ValueError(
            "BENCH_USE_PALLAS=0: the port has no kernels-off mode on the card "
            "(its kernels' plain versions run only for CPU tensors)")


def nonlinear_config(degree=2, dtype="float64"):
    """bench.py's `build_model` parameters (bench.py:61-147), environment
    knobs included, as `AllParameters` keywords."""
    _check_pallas()
    return dict(
        model="neo-Hookean", type_lin="CG", scenario="PF", dim=3,
        poly_degree=degree, delta_t=0.01, mu=0.5e6, nu=0.4, rho=1000.0,
        tol_lin=1e-6, tol_u=1e-6, tol_f=1e-9, max_iterations_NR=10,
        max_iterations_lin=1.0, dtype=dtype,
        preconditioner=_env("BENCH_PRECOND", "MG"),
        precond_dtype=_env("BENCH_PRECOND_DTYPE", "bfloat16"),
        solve_dtype=_env("BENCH_SOLVE_DTYPE", "float32"),
        newton_forcing=_env("BENCH_FORCING", "ew"),
        mg_smooth_degree=int(_env("BENCH_MG_DEGREE", "3")),
        mg_fine_smooth_degree=int(_env("BENCH_MG_FINE_DEGREE", "1")),
        newton_predictor=_env("BENCH_PREDICTOR", "1") == "1",
        ew_eta0=float(_env("BENCH_EW_ETA0", "0.3")),
        use_pallas=True,
        mg_fine_tangent=_env("BENCH_MG_FINE_TANGENT", "0") == "1",
        tangent_assembly_precision=_env("BENCH_TANGENT_PRECISION", "highest"),
        tangent_block_symmetric=_env("BENCH_TANGENT_SYM", "0") == "1",
        tangent_matvec_kernel=_env("BENCH_TANGENT_KERNEL", "auto"),
        newton_tangent_reuse=_env("BENCH_TANGENT_REUSE", "0") == "1",
        tangent_reuse_after=int(_env("BENCH_TANGENT_REUSE_AFTER", "1")),
        tangent_refresh_ratio=float(_env("BENCH_TANGENT_REFRESH_RATIO", "0.02")),
        newton_residual_f64_window=float(_env("BENCH_F64_WINDOW", "30.0")),
        use_sumfact=_env("BENCH_SUMFACT", "0") == "1",
    )


def linear_config(degree=2, dtype="float64"):
    """bench.py's `build_linear_model` parameters (bench.py:164-181)."""
    _check_pallas()
    return dict(
        model="linear", type_lin="CG", scenario="PF", dim=3,
        poly_degree=degree, delta_t=0.005, theta=0.5, mu=0.5e6, nu=0.4,
        rho=1000.0, dtype=dtype,
        preconditioner=_env("BENCH_PRECOND", "MG"),
        precond_dtype=_env("BENCH_PRECOND_DTYPE", "bfloat16"),
        solve_dtype=_env("BENCH_SOLVE_DTYPE", "float32"),
        mg_smooth_degree=int(_env("BENCH_MG_DEGREE", "3")),
        mg_fine_smooth_degree=int(_env("BENCH_MG_FINE_DEGREE", "2")),
        use_pallas=True,
    )


def build_model(scale, dtype="float64", degree=2, device=None,
                mesh_tags=None, overrides=None, **model_kw):
    """`NonlinearElasticity` of the cell (`nonlinear_config` with
    `overrides`) on the PF flap from `make_scenario_grid("PF", dim,
    degree, scale=scale)` (`mesh_tags` reuses a mesh); `model_kw` go to the
    constructor (`mg_lam_max`, `cg_loop`, ...)."""
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
        NonlinearElasticity,
    )

    params = AllParameters(**dict(nonlinear_config(degree, dtype),
                                  **(overrides or {})))
    mesh, tags = mesh_tags or make_scenario_grid(
        "PF", params.dim, degree, scale=scale, solver="neo-Hookean")
    return NonlinearElasticity(params, mesh=mesh, tags=tags, device=device,
                               **model_kw)


def build_linear_model(scale, dtype="float64", degree=2, device=None,
                       mesh_tags=None, overrides=None, **model_kw):
    """`LinearElastodynamics` of the cell (`linear_config`), as
    `build_model`."""
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models.linear_elasticity import (
        LinearElastodynamics,
    )

    params = AllParameters(**dict(linear_config(degree, dtype),
                                  **(overrides or {})))
    mesh, tags = mesh_tags or make_scenario_grid(
        "PF", params.dim, degree, scale=scale, solver="linear")
    return LinearElastodynamics(params, mesh=mesh, tags=tags, device=device,
                                **model_kw)


def interface_traction(model, magnitude=TRACTION):
    """The (n_nodes, dim) stress: `magnitude` in x on the interface."""
    import torch

    s = torch.zeros((model.space.n_nodes, model.space.dim),
                    dtype=torch.float64, device=model.device)
    iface = torch.as_tensor(model.space.boundary_nodes[model.interface_id],
                            device=model.device)
    s[iface, 0] = magnitude
    return s


def _launches():
    from dealii_adapter_tpu_torch.kernels import counters

    return sum(counters.launch_counts().values())


def step_diag(info):
    """The per-step counts of a Neo-Hookean `NewtonInfo` or a linear
    `StepInfo`."""
    if hasattr(info, "cg_iterations"):
        return dict(newton_its=info.iterations, cg_its=info.cg_iterations,
                    f64_evals=info.f64_evals, f32_evals=info.f32_evals,
                    tangent_asm=info.tangent_assemblies,
                    converged=bool(info.converged), min_det_F=info.min_det_F)
    return dict(cg_its=info.iterations, residual=info.residual)


def run_steps(model, n_steps, magnitude=TRACTION):
    """One warmup and `n_steps` timed steps from rest; returns (state,
    stress, per-step diagnostics, the warmup's included). A step's `s` is
    its host time to a read-back of ||u||^2, `event_ms` the CUDA events'
    time around the same span (None on the CPU)."""
    import torch

    cuda = model.device.type == "cuda"
    stress = interface_traction(model, magnitude)
    state = model.initial_state()
    diags = []
    for i in range(n_steps + 1):
        if cuda:
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        syncs, launches = model.host_syncs, _launches()
        uncounted = getattr(model, "uncounted_f32_evals", None)
        t0 = time.perf_counter()
        if cuda:
            ev[0].record()
        state, info = model.step(state, stress)
        u = state.displacement.reshape(-1)
        checksum = torch.dot(u, u).item()
        if cuda:
            ev[1].record()
        t = time.perf_counter() - t0
        d = dict(step=i, warmup=i == 0, s=t,
                 event_ms=ev[0].elapsed_time(ev[1]) if cuda else None,
                 **step_diag(info), host_syncs=model.host_syncs - syncs,
                 launches=_launches() - launches, checksum=checksum)
        if uncounted is not None:  # evaluated, not in NewtonInfo's count
            d["f32_uncounted"] = model.uncounted_f32_evals - uncounted
        diags.append(d)
        log(f"step {i} ({'warmup' if i == 0 else 'timed'}): "
            + ", ".join(f"{k} {v!r}" for k, v in d.items()
                        if k not in ("step", "warmup")))
    return state, stress, diags


def check(model_kind, diags, key, reference_ok):
    """The checks before the number; returns a list of failures."""
    fails = []
    for d in diags:
        if model_kind == "nonlinear" and not d["converged"]:
            fails.append(f"step {d['step']} did not converge")
        if model_kind == "linear" and not d["residual"] <= LINEAR_RESIDUAL_MAX:
            fails.append(f"step {d['step']} residual {d['residual']!r} > "
                         f"{LINEAR_RESIDUAL_MAX}")
    ref = REFERENCES.get(key)
    checksum = diags[-1]["checksum"]
    if not math.isfinite(checksum):
        fails.append(f"||u||^2 {checksum!r}")
    if ref is None or not reference_ok:
        log(f"||u||^2 {checksum!r}: no reference for this cell "
            f"({'none recorded' if ref is None else 'knobs, dtype or steps differ'})")
    else:
        rel = abs(checksum - ref[0]) / ref[0]
        log(f"||u||^2 {checksum!r} against the JAX package's {ref[0]!r}: rel. "
            f"difference {rel:.3e} (limit {ref[1]})")
        if not rel <= ref[1]:
            fails.append(f"||u||^2 {checksum!r} vs {ref[0]!r} (rtol {ref[1]})")
    return fails


def card_name(device):
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return "cpu (plain versions; not a measurement of the card)"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the plausibility floor


def chain_seconds(fn, short, long, device, reps=3):
    """Seconds of one call of `fn` as (long chain - short chain) /
    (long - short): on the card each chain is a CUDA graph of that many
    back-to-back calls, replayed `reps` times between CUDA events (the
    fastest replay); on the CPU the calls run eagerly under the host
    clock. Not clamped: a non-positive value means the component is
    under the timer's noise, and the floor leaves it out."""
    import torch

    from dealii_adapter_tpu_torch.solvers.graphs import capture

    def chain_time(n):
        if device.type != "cuda":
            best = math.inf
            for _ in range(reps):
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                best = min(best, time.perf_counter() - t0)
            return best
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with capture(graph):
            for _ in range(n):
                fn()
        graph.replay()
        best = math.inf
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        del graph
        torch.cuda.empty_cache()
        return best

    return (chain_time(long) - chain_time(short)) / (long - short)


def components(model, state, stress):
    """{component: the function one call of which it times} of the
    floor: the Neo-Hookean model's f64 and f32 residuals, the tangent
    assembly (assembled tangent only), and its CG's operator and
    preconditioner; the linear model's CG operator."""
    import torch

    if not hasattr(model, "residual"):  # linear
        v = torch.ones_like(state.displacement, dtype=model.solve_dtype)
        return {"t_operator": lambda: model._cg_op(v)}
    from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
        NonlinearState,
    )

    delta = torch.zeros_like(state.displacement)
    st = NonlinearState(*state)
    out = {"t_f64": lambda: model.residual(delta, st, stress)}
    if model._mixed_tangent:
        out["t_f32"] = lambda: model._residual32(delta, st, stress)
    tdt = model.solve_dtype
    if model._use_assembled and model._tangent is not None:
        assemble_Kt, _ = model._make_tangent_fns()
        u_t = state.displacement.to(tdt)
        Kt = model._tangent[0]
        out["t_asm"] = lambda: assemble_Kt(u_t, out=Kt)
    solve = model._tangent[1] if model._tangent is not None else None
    if solve is not None and hasattr(solve, "operator"):
        v = torch.ones_like(state.displacement, dtype=tdt)
        out["t_operator"] = lambda: solve.operator(v)
        out["t_preconditioner"] = lambda: solve.M(v)
    return out


def step_counts(d):
    """{component: calls in the step} (the floor's counts)."""
    if "newton_its" not in d:
        return {"t_operator": d["cg_its"]}
    return {"t_f64": d["f64_evals"],
            "t_f32": d["f32_evals"] + d.get("f32_uncounted", 0),
            "t_asm": d["tangent_asm"], "t_operator": d["cg_its"],
            "t_preconditioner": d["cg_its"]}


def floor_seconds(counts, per_call):
    """(floor, {component: its seconds in the step}) = 0.5 x the sum of
    count x time over the components timed with a positive chain
    difference; the others are left out (the floor stays a lower bound)."""
    terms = {k: counts[k] * t for k, t in per_call.items()
             if t > 0 and counts.get(k, 0) > 0}
    return 0.5 * sum(terms.values()), terms


def plausibility_guard(diags, per_call):
    """Exit 3 if a timed step took less than its floor."""
    for d in diags:
        if d["warmup"]:
            continue
        floor, terms = floor_seconds(step_counts(d), per_call)
        detail = ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in terms.items())
        log(f"guard: step {d['step']} {d['s']!r} s, floor {floor!r} s "
            f"(0.5 x [{detail}])")
        if d["s"] < floor:
            log(f"FAILED plausibility guard: step {d['step']} took {d['s']!r} "
                f"s, below its floor {floor!r} s; the timing did not observe "
                "real execution")
            sys.exit(3)


# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (tests only)")
    args = ap.parse_args(argv)
    model_kind = _env("BENCH_MODEL", "nonlinear")
    if model_kind not in ("nonlinear", "linear"):
        raise ValueError(f"BENCH_MODEL={model_kind!r}: nonlinear or linear")
    scale = int(_env("BENCH_SCALE", "9" if model_kind == "nonlinear" else "4"))
    n_steps = int(_env("BENCH_STEPS", "3"))
    dtype = _env("BENCH_DTYPE", "float64")
    degree = int(_env("BENCH_DEGREE", "2"))
    device_name = args.device or os.environ.get("BENCH_DEVICE")

    import torch

    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
    from dealii_adapter_tpu_torch.device import resolve_device

    device = resolve_device(device_name)
    card = card_name(device)
    build = build_model if model_kind == "nonlinear" else build_linear_model
    t0 = time.perf_counter()
    model = build(scale, dtype, degree, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"{model_kind} degree {degree} scale {scale}: {model.space.n_dofs} "
        f"DoF on {card}, built in {time.perf_counter() - t0:.1f} s")
    state, stress, diags = run_steps(model, n_steps)
    timed = [d for d in diags if not d["warmup"]]
    reference_ok = (dtype == "float64" and n_steps == 3
                    and not any(k in os.environ for k in SOLVER_KNOBS))
    fails = check(model_kind, diags, (model_kind, degree, scale), reference_ok)
    if fails:
        for f in fails:
            log(f"FAILED check: {f}")
        sys.exit(1)
    elapsed = sum(d["s"] for d in timed)
    mdof = model.space.n_dofs / 1e6
    if timed and device.type == "cuda":
        log(f"timed steps: host {[d['s'] for d in timed]} s, CUDA events "
            f"{[d['event_ms'] for d in timed]} ms (median "
            f"{statistics.median(d['event_ms'] for d in timed)!r})")
    print(json.dumps({
        "metric": NONLINEAR_METRIC if model_kind == "nonlinear" else LINEAR_METRIC,
        "value": mdof * len(timed) / elapsed if timed else 0.0,
        "unit": "MDoF*steps/s",
        "s_per_step": elapsed / len(timed) if timed else 0.0,
        "n_dofs": model.space.n_dofs,
        "degree": degree,
        "device": card,
    }), flush=True)
    per_call = {}
    for name, fn in components(model, state, stress).items():
        per_call[name] = chain_seconds(fn, *CHAINS[name], device)
        log(f"guard: {name} {per_call[name] * 1e3!r} ms a call"
            + ("" if per_call[name] > 0 else " (not positive: left out)"))
    plausibility_guard(diags, per_call)
    log("guard passed")


if __name__ == "__main__":
    main()
