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

`--devices N` above 1 runs one process per rank:
`torchrun --nproc-per-node N -m dealii_adapter_tpu_torch <case.prm>
--devices N`. Each rank initializes the default process group from
torchrun's environment (or uses one its caller initialized), with the
backend `parallel/partition.py:choose_backend` picks: NCCL when every rank
has a card of its own, gloo when the ranks share one card or run on the
CPU. Without either it raises, saying how to launch. A gloo world on the
card cannot capture its collectives in CUDA graphs, so there the models
run the host CG loop (`cg_loop="host"`), which the banner says. Rank 0
holds the participant (`adapter/adapter.py`) and alone prints the banner,
the table and the closing lines and writes the VTU files, from the
gathered fields.

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
                   help="ranks: above 1, launch one process per rank with "
                        "`torchrun --nproc-per-node N -m "
                        "dealii_adapter_tpu_torch`")
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


def _rank_group(n_devices: int, device_arg):
    """`(RankGroup, whether this call initialized the default process
    group)` for `--devices n_devices` above 1: the initialized default
    group, or one initialized from torchrun's environment with the
    backend `choose_backend` picks; raises with the launch hint without
    either."""
    import torch
    import torch.distributed as dist

    from dealii_adapter_tpu_torch.parallel.partition import (
        LAUNCH_HINT,
        choose_backend,
        make_device_mesh,
    )

    made = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
            raise RuntimeError(
                f"--devices {n_devices} needs one process per rank: "
                + LAUNCH_HINT)
        dev = torch.device(device_arg or "cuda")
        backend = choose_backend(dev, int(os.environ["WORLD_SIZE"]))
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        made = True
    return make_device_mesh(n_devices, device=device_arg), made


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    import torch

    import dealii_adapter_tpu_torch as dat
    from dealii_adapter_tpu_torch.adapter import Adapter, FakeParticipant
    from dealii_adapter_tpu_torch.device import resolve_device
    from dealii_adapter_tpu_torch.kernels import counters
    from dealii_adapter_tpu_torch.runner import coupled_run
    from dealii_adapter_tpu_torch.utils import TimerOutput, write_vtu

    overrides = {}
    if args.dim is not None:
        overrides["dim"] = args.dim
    if args.devices is not None:
        overrides["n_devices"] = args.devices
    if args.dtype is not None:
        overrides["dtype"] = args.dtype
    params = dat.parse_prm(args.prm, strict=not args.lenient, **overrides)
    mesh, made_group = None, False
    if params.n_devices > 1:
        mesh, made_group = _rank_group(params.n_devices, args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0  # prints and writes
    # a gloo world on the card cannot capture its collectives
    cg_loop = ("host" if mesh is not None and mesh.backend == "gloo"
               and device.type == "cuda" else "graphs")

    def say(*a):
        if lead:
            print(*a)

    # banner (the reference prints thread count + git revisions,
    # `elasticity.cc:19-44`)
    say("-" * 58)
    say(f"--     . running dealii_adapter_tpu_torch v{dat.__version__}"
        f" (rev {_vcs_revision()})")
    if device.type == "cuda":
        say(f"--     . device cuda: {torch.cuda.get_device_name(device)} "
            f"({torch.cuda.device_count()} visible)")
    else:
        say(f"--     . device {device.type}")
    if mesh is not None:
        say(f"--     . {mesh.world} ranks over {mesh.backend}; CG loop: "
            + ("host (gloo collectives cannot be captured in CUDA graphs)"
               if cg_loop == "host" else "graphs"))
    say(f"--     . model '{params.model}', scenario {params.scenario}, "
        f"dim {params.dim}, degree {params.poly_degree}")
    say("-" * 58)

    out_dir = params.output_folder or "."
    if lead and not args.no_output and out_dir != ".":
        os.makedirs(out_dir, exist_ok=True)  # `elasticity.cc:56-81`

    if params.model == "neo-Hookean":
        from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
            NonlinearElasticity as cls,
        )
    else:
        from dealii_adapter_tpu_torch.models.linear_elasticity import (
            LinearElastodynamics as cls,
        )
    model = cls(params, refine=args.refine, device=device, device_mesh=mesh,
                cg_loop=cg_loop)

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
        device_mesh=mesh,
    )

    timer = TimerOutput("run")
    n_out = [0]

    def output_cb(state, t, info):
        ts = t.get_timestep()
        if hasattr(info, "cg_iterations"):  # Newton table analog
            say(f"  t={t.current():.4g}  newton_its={int(info.iterations)} "
                f"cg_its={int(info.cg_iterations)} "
                f"res={float(info.residual_abs):.3e} "
                f"minJ={float(info.min_det_F):.4f}")
        else:
            say(f"  t={t.current():.4g}  cg_its={int(info.iterations)} "
                f"res={float(info.residual):.3e}")
        if args.verbose:
            say(f"    {info}")
        if not args.no_output:
            with timer.section("Output results"):
                # every rank takes part in the gathers, rank 0 writes
                disp = model.global_rows(state.displacement)
                extra = {}
                if hasattr(state, "velocity"):
                    extra["velocity"] = model.global_rows(state.velocity)
                if lead:
                    name = os.path.join(
                        out_dir, f"solution-{params.dim}d-{ts}.vtu"
                    )
                    write_vtu(name, model.space, disp, extra_point_data=extra)
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
    say(f"kernel launches (model build): {_launched()}")
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
    say("-" * 58)
    say(f"done: {n_steps} steps, {model.space.n_dofs} DoF, "
        f"{elapsed:.2f}s wall ({elapsed / max(n_steps,1):.4f} s/step), "
        f"{n_out[0]} VTU files in '{out_dir}'")
    u = model.global_rows(final[0].displacement).reshape(-1)
    say(f"final ||u||^2: {torch.dot(u, u).item()!r}")
    say(f"kernel launches: {_launched()}")
    if lead:
        timer.print_summary()
    if made_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
