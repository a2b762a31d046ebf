#!/usr/bin/env python3
"""The linear theta-step of `chip_smoke.py`'s linear cells on the card,
replayed from CUDA graphs (`cg_loop="graphs"`) and eager (`"host"`), and
one profiled step of each: where a linear step's time goes.

    python3 tools/linear_step_profile.py [--cells bench_linear_q2,...]
                                         [--loops graphs,host] [--steps 3]
                                         [--device cuda|cpu] [--scale S]

For each cell of `chip_smoke.LINEAR_CELLS` and each `cg_loop` (models on
one mesh, the first model's lam_max values), 1 warmup and `--steps` timed
steps from rest (per step: the wall time, CG iterations, residual, host
syncs, kernel launches and ||u||^2), then one more step under
torch.profiler tracing the card only (`chip_smoke.profile_timeline`:
device time by kernel group, launches, busy share of the step's wall,
read-backs and the idle gaps after them). The loops run in the order
given and then in reverse, so that a drift of the card shows as a
difference between the two runs of a loop. Every run of a cell must give
the same `StepInfo` and ||u||^2 bit for bit. The last line is a JSON
summary. `--device cpu` rehearses it on the CPU at a small `--scale`
(steps only: no profile, and no time there is a device time).
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def run(model, stress, n_steps, cuda, profile):
    import torch

    from dealii_adapter_tpu_torch.kernels import counters

    counters.reset()
    state, rows = model.initial_state(), []
    for _ in range(n_steps + 1):
        if cuda:
            torch.cuda.synchronize()
        syncs0 = model.host_syncs
        launches0 = sum(counters.launch_counts().values())
        t0 = time.perf_counter()
        state, info = model.step(state, stress)
        u = state.displacement.reshape(-1)
        checksum = torch.dot(u, u).item()
        rows.append(dict(
            seconds=time.perf_counter() - t0, info=tuple(info),
            syncs=model.host_syncs - syncs0,
            launches=sum(counters.launch_counts().values()) - launches0,
            checksum=checksum))
    prof = None
    if profile:
        _, prof = cs.profile_timeline("profile", model, state, stress)
    return rows, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(cs.LINEAR_CELLS))
    ap.add_argument("--loops", default="graphs,host")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=None,
                    help="every cell at this scale (default: its own)")
    args = ap.parse_args()

    import torch

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda:
        cs.phase_device()
    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)

    loops = args.loops.split(",")
    summary = {}
    for cell in args.cells.split(","):
        mesh_tags, lam_max, ref, runs = None, None, None, {}
        for loop in loops + loops[::-1]:
            t0 = time.perf_counter()
            model = cs.build_linear_cell(cell, device, args.scale,
                                         mesh_tags=mesh_tags,
                                         mg_lam_max=lam_max, cg_loop=loop)
            build = time.perf_counter() - t0
            if mesh_tags is None:
                mesh_tags = (model.mesh, model.tags)
                lam_max = [lv.lam_max for lv in model._precond.levels]
            rows, prof = run(model, cs.interface_traction(model), args.steps,
                             cuda, cuda)
            tag = f"{cell} cg_loop={loop}"
            print(f"{tag}: {model.space.n_dofs} DoF, built in {build:.1f} s; "
                  f"steps {[r['seconds'] for r in rows]} s; StepInfo "
                  f"{[r['info'] for r in rows]}; host syncs "
                  f"{[r['syncs'] for r in rows]}; launches "
                  f"{[r['launches'] for r in rows]}; checksum "
                  f"{rows[-1]['checksum']!r}", flush=True)
            got = ([r["info"] for r in rows], rows[-1]["checksum"])
            if ref is None:
                ref = got
            cs.require(got == ref, f"{tag}: {got} against {ref}")
            runs.setdefault(loop, []).append(dict(
                timed_mean_s=statistics.mean(r["seconds"] for r in rows[1:]),
                steps_s=[r["seconds"] for r in rows],
                cg=[r["info"][0] for r in rows],
                syncs=[r["syncs"] for r in rows],
                launches=[r["launches"] for r in rows], profile=prof))
            del model
            if cuda:
                torch.cuda.empty_cache()
        summary[cell] = runs
    print(json.dumps({"device": cs.bench_torch.card_name(device),
                      "cells": summary}))


if __name__ == "__main__":
    main()
