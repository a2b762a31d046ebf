#!/usr/bin/env python
"""Reference values of `bench_torch.py`'s checks, from the JAX package.

    JAX_PLATFORMS=cpu python tools/jax_reference_bench.py \
        {nonlinear,linear} [--degree 2] [--scale S] [--steps 3]

Builds the cell with `bench.py`'s own `build_model` / `build_linear_model`
(its environment defaults: the configuration `bench_torch.py` builds on
the port), runs `bench.py:run_steps` (traction 1000 in x on the
interface, 1 warmup and `--steps` more steps) and prints each step's
counts and the checksum ||u||^2 after the last step, which
`bench_torch.py` (`REFERENCES`) holds the port's run against. The scale
defaults to bench.py's: 9 for the Neo-Hookean model, 4 for the linear
one. Host times printed here are CPU times of the JAX package, not device
metrics.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dealii_adapter_tpu  # noqa: E402,F401  (x64)
import bench  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=("nonlinear", "linear"))
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", default="float64")
    args = ap.parse_args()
    scale = args.scale or (9 if args.model == "nonlinear" else 4)
    build = bench.build_model if args.model == "nonlinear" else bench.build_linear_model
    t0 = time.perf_counter()
    model = build(scale, args.dtype, args.degree)
    print(f"{args.model} degree {args.degree} scale {scale}: "
          f"{model.space.n_dofs} DoF, built in {time.perf_counter() - t0:.1f} s "
          "(CPU)", flush=True)
    elapsed, diags, _ = bench.run_steps(model, args.steps)
    print(f"diags {diags}")
    print(f"{args.model} degree {args.degree} scale {scale}: "
          f"{model.space.n_dofs} DoF, {args.steps + 1} steps in "
          f"{time.perf_counter() - t0:.1f} s (CPU); final ||u||^2 "
          f"{diags[-1]['checksum']!r}", flush=True)


if __name__ == "__main__":
    main()
