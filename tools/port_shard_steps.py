#!/usr/bin/env python3
"""Step times of the lattice partition by number of ranks, on one card.

    python3 tools/port_shard_steps.py [--ranks 1 2 4] [--steps 4] \
        [--scale 9] [--device cuda] [--out output/port_shard_steps.json]

Runs `chip_smoke.py`'s main configuration (3D Neo-Hookean flap, Q2; scale
9: 1,018,875 DoF) with the host CG loop, first in this process on one
device without a partition (the reference: Newton and CG counts, ||u||^2,
its multigrid lam_max values), then for each `--ranks` n on the lattice
partition over n ranks spawned on the same device over gloo (one card,
so the ranks share it: a time here is not a scaling result), each rank
running `chip_smoke._shard3d_rank` (its slab kernel checks, then
`--steps` steps from rest with the reference's lam_max). A world of one
exchanges nothing, so its steps differ from the reference's only by the
gloo all-reduce of every inner product. Prints, per world, rank 0's
per-step times, Newton and CG counts against the reference's, ||u||^2's
relative difference, and the halo fills, interface sums and all-reduces
a step, and writes them as JSON to `--out`. With
`--device cpu --scale 1` it rehearses the same on the CPU.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--scale", type=int, default=cs.SCALE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("output", "port_shard_steps.json"))
    args = ap.parse_args()

    import torch

    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
    from dealii_adapter_tpu_torch.kernels import _build
    from dealii_adapter_tpu_torch.parallel import spawn

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(cs.phase_device(), flush=True)
        _build.load_library()  # build once, before the ranks start
    model = cs.build_model(dev, scale=args.scale, cg_loop="host")
    lam_max = [lv.lam_max for lv in model._precond.levels]
    stress = cs.interface_traction(model)
    state = model.initial_state()
    ref = dict(times=[], newton=[], cg=[])
    for _ in range(args.steps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        u = state.displacement.reshape(-1)
        ref["checksum"] = float(torch.dot(u, u))
        ref["times"].append(time.perf_counter() - ts)
        ref["newton"].append(info.iterations)
        ref["cg"].append(info.cg_iterations)
    ref["n_dofs"] = model.space.n_dofs
    print(f"one device, no partition, host CG loop: {ref}", flush=True)
    del model, state
    worlds = {}
    for n in args.ranks:
        t0 = time.perf_counter()
        out = spawn(cs._shard3d_rank, n, dev, lam_max, args.steps, args.scale,
                    backend="gloo")
        r = out[0]
        rel = abs(r["checksums"][-1] - ref["checksum"]) / ref["checksum"]
        worlds[n] = dict(times=r["times"], newton=r["newton"], cg=r["cg"],
                         calls=r["calls"], checksum_rel=rel, slab=r["slab"],
                         wall_s=time.perf_counter() - t0)
        print(f"{n} rank(s) over gloo on one {dev.type} device: step times "
              f"{r['times']} s; Newton {r['newton']} (reference "
              f"{ref['newton']}), CG {r['cg']} (reference {ref['cg']}); "
              f"||u||^2 rel. difference {rel:.3e}; rank 0's slab {r['slab']}; "
              f"collectives a step {r['calls']}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(reference=ref, worlds=worlds), f, indent=1)


if __name__ == "__main__":
    main()
