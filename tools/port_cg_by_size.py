#!/usr/bin/env python3
"""CG iterations of the PyTorch port's paths by size and MG dtype.

    python3 tools/port_cg_by_size.py {linear,nonlinear} [--dim 2] \
        [--scale 48] [--precond-dtype float32] [--cap N] [--steps 1] \
        [--device cuda]

Builds `chip_smoke.py`'s model (`LINEAR_2D`, `NONLINEAR_2D`, or in 3D the
Neo-Hookean benchmark configuration `NONLINEAR`; the multigrid hierarchy
in `--precond-dtype`, by default the configuration's own) at `scale` on
the CUDA card, or with `--device cpu` on the CPU (where the port's sums,
and so its CG counts, follow the number of threads: set it with
`OMP_NUM_THREADS`). It caps every CG solve at `--cap` iterations
(default: the model's own cap, n_dofs), applies traction 1000 in x on the
interface and prints each step's iteration counts and wall time; for the
linear model also each inner solve of the f64 refinement (iterations,
tolerance, final f32 residual). The cap keeps a stalling solve (the bf16
hierarchy at large sizes) inside a chip call. Host times of a CPU run are
not device metrics.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=("linear", "nonlinear"))
    ap.add_argument("--dim", type=int, choices=(2, 3), default=2)
    ap.add_argument("--scale", type=int, default=None,
                    help=f"default {cs.SCALE_2D} in 2D, {cs.SCALE} in 3D")
    ap.add_argument("--precond-dtype", default=None)
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    if args.model == "linear" and args.dim == 3:
        ap.error("the linear configuration is 2D")
    scale = args.scale or (cs.SCALE_2D if args.dim == 2 else cs.SCALE)
    over = {} if args.precond_dtype is None else dict(
        precond_dtype=args.precond_dtype)

    import torch

    from dealii_adapter_tpu_torch.solvers import cg

    dev = torch.device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    if args.model == "linear":
        model = cs.build_linear_model(dev, scale=scale, cg_loop="host",
                                      **over)
        inner = cg.cg_solve

        def traced(op, b, x0, tol, max_iter, preconditioner=None):
            r = inner(op, b, x0, tol, max_iter, preconditioner)
            print(f"   inner CG {r.iterations} tol {tol:.3e} "
                  f"residual {r.residual_norm:.3e}", flush=True)
            return r

        cg.cg_solve = traced  # ir_cg_solve's inner solves (the host loop)
    else:
        model = cs.build_model(dev, dim=args.dim, scale=scale, **over)
    where = (dev.type if dev.type == "cuda"
             else f"cpu ({torch.get_num_threads()} threads)")
    cs.describe(f"{args.model} {args.dim}D scale {scale} "
                f"{model.params.precond_dtype} on {where}", model,
                time.perf_counter() - t0)
    if args.cap is not None:
        model._max_cg_iter = args.cap
    stress = cs.interface_traction(model)
    state = model.initial_state()
    for i in range(args.steps):
        sync()
        t0 = time.perf_counter()
        state, info = model.step(state, stress)
        sync()
        print(f"step {i}: {time.perf_counter() - t0:.3f} s {info}", flush=True)
    u = state.displacement
    print(f"checksum {float((u * u).sum())!r}")


if __name__ == "__main__":
    main()
