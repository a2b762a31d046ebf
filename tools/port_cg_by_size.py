#!/usr/bin/env python3
"""CG iterations of the PyTorch port's 2D paths by size and MG dtype.

    python3 tools/port_cg_by_size.py {linear,nonlinear} [--scale 48] \
        [--precond-dtype float32] [--cap N] [--steps 1]

Builds `chip_smoke.py`'s 2D model (`LINEAR_2D` or `NONLINEAR_2D`, with the
multigrid hierarchy in `--precond-dtype`) on the CUDA card at `scale`,
caps every CG solve at `--cap` iterations (default: the model's own cap,
n_dofs), applies traction 1000 in x on the interface and prints each
step's iteration counts and wall time; for the linear model also each
inner solve of the f64 refinement (iterations, tolerance, final f32
residual). The cap keeps a stalling solve (the bf16 hierarchy at large
sizes) inside a chip call.
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
    ap.add_argument("--scale", type=int, default=cs.SCALE_2D)
    ap.add_argument("--precond-dtype", default="float32")
    ap.add_argument("--cap", type=int, default=None)
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args()

    import torch

    from dealii_adapter_tpu_torch.solvers import cg

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    if args.model == "linear":
        cs.LINEAR_2D["precond_dtype"] = args.precond_dtype
        model = cs.build_linear_model(dev, scale=args.scale)
        inner = cg.cg_solve

        def traced(*a, **kw):
            r = inner(*a, **kw)
            print(f"   inner CG {r.iterations} tol {kw['tol']:.3e} "
                  f"residual {r.residual_norm:.3e}", flush=True)
            return r

        cg.cg_solve = traced  # ir_cg_solve's inner solves
    else:
        cs.NONLINEAR_2D["precond_dtype"] = args.precond_dtype
        model = cs.build_model(dev, dim=2, scale=args.scale)
    cs.describe(f"{args.model} {args.precond_dtype}", model,
                time.perf_counter() - t0)
    if args.cap is not None:
        model._max_cg_iter = args.cap
    stress = cs.interface_traction(model)
    state = model.initial_state()
    for i in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, info = model.step(state, stress)
        torch.cuda.synchronize()
        print(f"step {i}: {time.perf_counter() - t0:.3f} s {info}", flush=True)
    u = state.displacement
    print(f"checksum {float((u * u).sum())!r}")


if __name__ == "__main__":
    main()
