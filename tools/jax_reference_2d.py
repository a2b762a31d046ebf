#!/usr/bin/env python
"""Reference values of the PyTorch port's 2D checks, from the JAX package.

    JAX_PLATFORMS=cpu python tools/jax_reference_2d.py {linear,nonlinear} \
        [--dim 2] [--scale 48] [--steps 4] [--precond-dtype float32] \
        [--solve-dtype float32]

Runs the JAX package's model on the 2D perpendicular flap (Q2, `scale`
times the tutorial's 3 x 18 cells) with the parameters `chip_smoke.py`
gives the port (`LINEAR_2D` and `NONLINEAR_2D` there; `--precond-dtype`
overrides their multigrid hierarchy's dtype and `--solve-dtype` their
inner solve's, `""` for each the model's f64, as `chip_smoke.py`'s
`f64mg2d` runs it), or with `--dim 3` the
Neo-Hookean benchmark configuration `NONLINEAR` on the 3D flap, traction
1000 in x on the interface, and prints per step the iteration counts and
at the end the checksum ||u||^2 that `chip_smoke.py` holds the port's run
against.
Host times printed here are CPU times of the JAX package, not device
metrics.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import dealii_adapter_tpu  # noqa: E402,F401  (x64)
from dealii_adapter_tpu.config import AllParameters  # noqa: E402
from dealii_adapter_tpu.mesh.generator import make_scenario_grid  # noqa: E402
from chip_smoke import LINEAR_2D, NONLINEAR, NONLINEAR_2D  # noqa: E402  (stdlib-only module)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=("linear", "nonlinear"))
    ap.add_argument("--dim", type=int, choices=(2, 3), default=2)
    ap.add_argument("--scale", type=int, default=48)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--precond-dtype", default=None)
    ap.add_argument("--solve-dtype", default=None)
    args = ap.parse_args()
    if args.model == "linear" and args.dim == 3:
        ap.error("the linear configuration is 2D")

    if args.model == "linear":
        from dealii_adapter_tpu.models.linear_elasticity import (
            LinearElastodynamics as Model,
        )

        params, solver = LINEAR_2D, "linear"
    else:
        from dealii_adapter_tpu.models.nonlinear_elasticity import (
            NonlinearElasticity as Model,
        )

        params = NONLINEAR_2D if args.dim == 2 else dict(NONLINEAR, dim=3)
        solver = "neo-Hookean"
    if args.precond_dtype is not None:
        params = dict(params, precond_dtype=args.precond_dtype)
    if args.solve_dtype is not None:
        params = dict(params, solve_dtype=args.solve_dtype)
    params = AllParameters(**params)
    mesh, tags = make_scenario_grid("PF", args.dim, 2, scale=args.scale,
                                    solver=solver)
    t0 = time.perf_counter()
    model = Model(params, mesh=mesh, tags=tags)
    print(f"{args.model} {args.dim}D scale {args.scale} precond_dtype "
          f"{params.precond_dtype!r} solve_dtype {params.solve_dtype!r}: "
          f"{model.space.n_dofs} DoF, "
          f"built in {time.perf_counter() - t0:.1f} s (CPU)", flush=True)
    stress = np.zeros((model.space.n_nodes, args.dim))
    stress[model.space.boundary_nodes[model.interface_id], 0] = 1000.0
    stress = jnp.asarray(stress)
    state = model.initial_state()
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, info = model.step(state, stress)
        u = np.asarray(state.displacement)
        counts = {k: np.asarray(v).item() for k, v in info._asdict().items()}
        print(f"step {i}: {time.perf_counter() - t0:.1f} s (CPU) {counts}",
              flush=True)
    print(f"checksum {float((u * u).sum())!r} max_u {float(np.abs(u).max())!r}")


if __name__ == "__main__":
    main()
