#!/usr/bin/env python3
"""Where the time of one jvp tangent application goes, on the card.

    python3 tools/jvp_operator_profile.py [--scale 9] [--rows 25]
    python3 tools/jvp_operator_profile.py --device cpu --scale 1

Builds the 3D Neo-Hookean benchmark configuration of `chip_smoke.py`
(`build_model`) with each jvp tangent of its jvp paths (`f64jvp3d`: the
f64 jvp of the sum-factorized residual; `f64jvp3d dense`: the same
without `use_sumfact`, the dense (q, npc) tabulation products; `jvp3d`:
the f32 jvp of the internal force, here by `tangent_backend="jvp"`,
which selects it at every scale), takes one Newmark step so that the operator holds a
real linearization point, and profiles 5 applications of the CG
operator with torch.profiler: the device time per application, the
kernels per application, and the kernels that take the most device time
(per application; `--rows` of them). For the f64 paths, the same for the
residual itself without AD (one evaluation), for scale. On the CPU
(`--device cpu`, a small `--scale`) it rehearses the script and reports
CPU times, which are no device metric.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
import dealii_adapter_tpu_torch  # noqa: E402,F401  (precision policy)


def profiled(fn, reps, cuda, rows, tag):
    """Profile `reps` calls of `fn`; print per-call totals and the top
    `rows` kernels (device time on the card, CPU time otherwise)."""
    for _ in range(2):
        fn()
    if cuda:
        torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        if cuda:
            torch.cuda.synchronize()
    if cuda:
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count > 0]
        key = "self_device_time_total"
    else:
        events = [e for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.count > 0]
        key = "self_cpu_time_total"
    total = sum(getattr(e, key) for e in events) / reps / 1e3
    n = sum(e.count for e in events) / reps
    print(f"{tag}: {total!r} ms {'device' if cuda else 'CPU'} time per call, "
          f"{n:.0f} {'kernels' if cuda else 'aten calls'} per call", flush=True)
    events.sort(key=lambda e: -getattr(e, key))
    for e in events[:rows]:
        print(f"  {getattr(e, key) / reps / 1e3:9.4f} ms  "
              f"{e.count / reps:6.1f}x  {e.key[:110]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=chip_smoke.SCALE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=25)
    args = ap.parse_args()
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        chip_smoke.phase_device()
    mesh_tags = None
    paths = {"f64jvp3d": chip_smoke.JVP_PATHS["f64jvp3d"],
             "f64jvp3d dense": dict(chip_smoke.JVP_PATHS["f64jvp3d"],
                                    use_sumfact=False),
             "jvp3d": dict(tangent_backend="jvp")}
    for path, overrides in paths.items():
        t0 = time.perf_counter()
        model = chip_smoke.build_model(dev, scale=args.scale,
                                       mesh_tags=mesh_tags, **overrides)
        mesh_tags = (model.mesh, model.tags)
        stress = chip_smoke.interface_traction(model)
        state, info = model.step(model.initial_state(), stress)
        print(f"{path}: {model.space.n_dofs} DoF, built and stepped in "
              f"{time.perf_counter() - t0:.1f} s: newton {info.iterations} cg "
              f"{info.cg_iterations}", flush=True)
        chip_smoke.require(not model._use_assembled,
                           f"{path}: the model runs the jvp tangent")
        K = model._tangent[1].operator
        g = torch.Generator().manual_seed(8)
        v = model.mask_t * torch.randn(model.space.n_nodes, 3, generator=g).to(
            dev, model.solve_dtype)
        profiled(lambda: K(v), 5, cuda, args.rows, f"{path} jvp operator")
        if path.startswith("f64"):
            delta = torch.zeros_like(state.displacement)
            profiled(lambda: model.residual(delta, state, stress), 5, cuda,
                     min(args.rows, 10), f"{path} residual (no AD)")
        del model, state, K
        if cuda:
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
