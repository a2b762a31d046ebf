#!/usr/bin/env python3
"""Host time of one jvp tangent application on the CPU, by configuration.

    python3 tools/port_jvp_host_ms.py [--tree PATH] [--threads 2] [--reps 10]

Builds the port's Neo-Hookean model (`dealii_adapter_tpu_torch` of the
tree at `--tree`, this checkout by default, so that two trees can be
compared) on the CPU for each configuration below, forms its jvp tangent
at a seeded linearization point and prints the mean wall time of
`--reps` applications to a seeded direction after one warm-up. Forward-
mode AD runs eagerly here, so the time is host time a CG iteration of
the jvp tangent costs on the CPU (the tests' and the gloo ranks' cost);
it is no device metric. `--save FILE` writes the applications' results
(an `.npz`) so that two trees can be held bit for bit.

Configurations (2D PF unless named): `2d_q1` (152 DoF, the coupling
tests' f64 jvp), `2d_q2` (518), `3d_q2_sumfact` (3D Q2, sum
factorization), `2d_gather` (the gather backend), `2d_mixed_jvp` (the
f32 jvp of the internal force).
"""

import argparse
import os
import sys
import time

CONFIGS = {
    "2d_q1": dict(poly_degree=1, tol_lin=1e-8),
    "2d_q2": dict(poly_degree=2, tol_lin=1e-8),
    "3d_q2_sumfact": dict(dim=3, poly_degree=2, use_sumfact=True),
    "2d_gather": dict(poly_degree=2, element_backend="gather"),
    "2d_mixed_jvp": dict(poly_degree=2, solve_dtype="float32",
                         tangent_backend="jvp"),
}
BASE = dict(model="neo-Hookean", type_lin="CG", scenario="PF", delta_t=0.01,
            mu=0.5e6, nu=0.4, rho=1000.0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--save", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch

    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
        NonlinearElasticity,
        NonlinearState,
    )

    torch.set_num_threads(args.threads)
    out = {}
    for name, kw in CONFIGS.items():
        m = NonlinearElasticity(AllParameters(**BASE, **kw), device="cpu")
        rng = np.random.default_rng(7)
        n, dim = m.space.n_nodes, m.space.dim
        vecs = [torch.as_tensor(1e-4 * rng.standard_normal((n, dim)))
                for _ in range(4)]
        stress = np.zeros((n, dim))
        stress[m.space.boundary_nodes[m.interface_id], 0] = 5000.0
        _, K = m._make_jvp_tangent(vecs[0], NonlinearState(*vecs[1:4]),
                                   torch.as_tensor(stress))
        v = torch.as_tensor(rng.standard_normal((n, dim)))
        if m._mixed_tangent:
            v = v.float()
        y = K(v)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            y = K(v)
        ms = (time.perf_counter() - t0) / args.reps * 1e3
        print(f"{name:14s} {n * dim:6d} DoF  {ms:8.3f} ms an application "
              f"(CPU, {args.threads} threads)", flush=True)
        out[name] = y.numpy()
    if args.save:
        np.savez(args.save, **out)


if __name__ == "__main__":
    main()
