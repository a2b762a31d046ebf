"""Command-line entry point — counterpart of `dealii_adapter_tpu/cli.py`, the
framework's `elasticity.cc` (`:7-129`).

Parses a deal.II-format `.prm` file, creates the output folder, dispatches
on `Model` (linear | neo-Hookean), builds the model on the CUDA card (or on
`--device`), and runs the coupled loop. Coupling modes:

* `--standalone` (the default unless `--coupled`): an in-process
  `FakeParticipant` drives the loop with a configurable constant/ramped
  surface traction — the perpendicular-flap benchmark without a fluid.
* real preCICE with `--coupled` when pyprecice + a `precice-config.xml`
  are available, exactly like the reference binary.

The options and the output are the JAX CLI's, with `--device` added (the
port's counterpart of `JAX_PLATFORMS=cpu`: without a card and without
`--device cpu` the run raises, as the models do), a banner that names the
device, `--profile` through `torch.profiler`, the kernel launch counts of
the model build and, in the closing lines, the final ||u||^2 and the
kernel launch counts of the coupled run alone.
A configuration whose code path is not ported raises NotImplementedError
naming its ROADMAP item: `--devices` above 1 (the coupled run on several
ranks, `runner.MULTI_RANK_COUPLING`) here, the rest in the model.

Usage: python -m dealii_adapter_tpu_torch <case.prm> [options]
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time

import numpy as np


def _vcs_revision() -> str:
    """Short git revision of the installed tree, or 'unknown' outside a
    checkout — the banner parity of `elasticity.cc:32-44` /
    `CMakeLists.txt:46-51` (the reference bakes GIT_SHORTREV in at
    configure time; we resolve it at launch)."""
    import subprocess

    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        )
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dealii_adapter_tpu_torch",
        description="Coupled structural solver on a CUDA GPU (linear / "
                    "neo-Hookean), PyTorch port",
    )
    p.add_argument("prm", nargs="?", default="parameters.prm",
                   help=".prm parameter file (deal.II format)")
    p.add_argument("--standalone", action="store_true",
                   help="run without preCICE, with a scripted surface traction")
    p.add_argument("--coupled", action="store_true",
                   help="force real preCICE coupling (needs pyprecice)")
    p.add_argument("--traction", type=float, nargs="+", default=None,
                   help="standalone: constant traction vector on the interface")
    p.add_argument("--ramp", type=float, default=0.0,
                   help="standalone: ramp the traction linearly over this time")
    p.add_argument("--dim", type=int, default=None, choices=(2, 3))
    p.add_argument("--refine", type=int, default=0,
                   help="global refinements (cells x 2^n per axis)")
    p.add_argument("--devices", type=int, default=None,
                   help="ranks (> 1 raises: the coupled run on several ranks is "
                        "ROADMAP Queue 1 item 16)")
    p.add_argument("--dtype", choices=("float32", "float64"), default=None)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs on the CPU)")
    p.add_argument("--no-output", action="store_true")
    p.add_argument("--lenient", action="store_true",
                   help="ignore undeclared .prm subsections/keys instead of "
                        "rejecting them (deal.II ParameterHandler rejects)")
    p.add_argument("--verbose", action="store_true",
                   help="print every completed window's full solver info")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a torch.profiler trace of the coupled run "
                        "into DIR/trace.json (chrome trace format)")
    return p


def _launched() -> dict:
    """{kernel name: launches since the last reset}, launched kernels only."""
    from dealii_adapter_tpu_torch.kernels.counters import launch_counts

    return {k: n for k, n in launch_counts().items() if n}


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    import dealii_adapter_tpu_torch as dat
    from dealii_adapter_tpu_torch.adapter import Adapter, FakeParticipant
    from dealii_adapter_tpu_torch.device import resolve_device
    from dealii_adapter_tpu_torch.kernels import counters
    from dealii_adapter_tpu_torch.runner import MULTI_RANK_COUPLING, coupled_run
    from dealii_adapter_tpu_torch.utils import TimerOutput, write_vtu

    overrides = {}
    if args.dim is not None:
        overrides["dim"] = args.dim
    if args.devices is not None:
        overrides["n_devices"] = args.devices
    if args.dtype is not None:
        overrides["dtype"] = args.dtype
    params = dat.parse_prm(args.prm, strict=not args.lenient, **overrides)
    if params.n_devices > 1:
        raise NotImplementedError(MULTI_RANK_COUPLING)
    device = resolve_device(args.device)

    # banner (the reference prints thread count + git revisions,
    # `elasticity.cc:19-44`)
    print("-" * 58)
    print(f"--     . running dealii_adapter_tpu_torch v{dat.__version__}"
          f" (rev {_vcs_revision()})")
    if device.type == "cuda":
        print(f"--     . device cuda: {torch.cuda.get_device_name(device)} "
              f"({torch.cuda.device_count()} visible)")
    else:
        print(f"--     . device {device.type}")
    print(f"--     . model '{params.model}', scenario {params.scenario}, "
          f"dim {params.dim}, degree {params.poly_degree}")
    print("-" * 58)

    out_dir = params.output_folder or "."
    if not args.no_output and out_dir != ".":
        os.makedirs(out_dir, exist_ok=True)  # `elasticity.cc:56-81`

    if params.model == "neo-Hookean":
        from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
            NonlinearElasticity,
        )

        model = NonlinearElasticity(params, refine=args.refine, device=device)
    else:
        from dealii_adapter_tpu_torch.models.linear_elasticity import (
            LinearElastodynamics,
        )

        model = LinearElastodynamics(params, refine=args.refine, device=device)

    standalone = args.standalone or not args.coupled
    if standalone:
        mag = args.traction if args.traction is not None else [1000.0, 0.0, 0.0]
        mag = (list(mag) + [0.0, 0.0, 0.0])[: params.dim]
        ramp = args.ramp

        def read_fn(t, coords):
            f = min(t / ramp, 1.0) if ramp > 0 else 1.0
            return np.tile(np.asarray(mag) * f, (len(coords), 1))

        participant = FakeParticipant(
            dim=params.dim,
            window_dt=params.delta_t,
            end_time=params.end_time,
            read_fn=read_fn,
        )
    else:
        participant = None  # Adapter constructs real pyprecice

    adapter = Adapter(
        params, model.interface_id, model.space,
        participant=participant, dtype=model.dtype, device=device,
    )

    timer = TimerOutput("run")
    n_out = [0]

    def output_cb(state, t, info):
        ts = t.get_timestep()
        if hasattr(info, "cg_iterations"):  # Newton table analog
            print(f"  t={t.current():.4g}  newton_its={int(info.iterations)} "
                  f"cg_its={int(info.cg_iterations)} "
                  f"res={float(info.residual_abs):.3e} "
                  f"minJ={float(info.min_det_F):.4f}")
        else:
            print(f"  t={t.current():.4g}  cg_its={int(info.iterations)} "
                  f"res={float(info.residual):.3e}")
        if args.verbose:
            print(f"    {info}")
        if not args.no_output:
            with timer.section("Output results"):
                name = os.path.join(
                    out_dir, f"solution-{params.dim}d-{ts}.vtu"
                )
                extra = {}
                if hasattr(state, "velocity"):
                    extra["velocity"] = state.velocity
                write_vtu(name, model.space, state.displacement,
                          extra_point_data=extra)
                n_out[0] += 1

    final = []

    def run():
        with timer.section("Coupled run"):
            final.append(coupled_run(model, adapter, output_cb=output_cb))
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    # the closing counts are the coupled run's own: the model build's
    # launches (power iterations, the library's C1/C2 check) are printed
    # here, then every count restarts at 0 and, on the card, the library
    # is bound again, so its check runs anew and counts in the run
    print(f"kernel launches (model build): {_launched()}")
    counters.restart(device)

    t0 = _time.perf_counter()
    if args.profile:
        # device-level tracing around the whole coupled loop — the analog
        # of the reference's TimerOutput sections, at kernel granularity
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(args.profile, exist_ok=True)
        with profile(activities=activities) as prof:
            run()
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        run()
    elapsed = _time.perf_counter() - t0

    n_steps = round(params.end_time / params.delta_t)
    print("-" * 58)
    print(f"done: {n_steps} steps, {model.space.n_dofs} DoF, "
          f"{elapsed:.2f}s wall ({elapsed / max(n_steps,1):.4f} s/step), "
          f"{n_out[0]} VTU files in '{out_dir}'")
    u = final[0].displacement.reshape(-1)
    print(f"final ||u||^2: {torch.dot(u, u).item()!r}")
    print(f"kernel launches: {_launched()}")
    timer.print_summary()
    return 0


if __name__ == "__main__":
    sys.exit(main())
