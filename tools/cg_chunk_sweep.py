#!/usr/bin/env python3
"""A model's step with its CG in CUDA graphs at several chunk lengths and
run eagerly (`cg_loop="host"`), in one process: per step the wall time,
the counts (CG and Newton; the linear model's CG), host syncs and kernel
launches, and each run's peak device memory.

    python3 tools/cg_chunk_sweep.py [--model nonlinear|linear]
                                    [--chunks 1,2,4,8,16] [--scale S]
                                    [--cells bench_linear_q2,...]
                                    [--rounds 2] [--device cuda|cpu]
                                    [--profiler-sessions N] [--kernels-phase]

`--model nonlinear` (the default) runs the 3D Neo-Hookean step of
`chip_smoke.py`'s main path (scale 9 unless `--scale`); `--model linear`
runs the linear theta-step on each of `--cells` (`chip_smoke.LINEAR_CELLS`:
bench_torch.py's two linear cells and linear2d, each at its own scale
unless `--scale`), where "graphs" replays the one step's bodies from
CUDA graphs (its defect-correction loop, `solvers/cg.py:ChunkedIRCG`,
around the chunks). On both models "host" runs the same step and CG
chunks eagerly (chunks of 1).
Each configuration runs 1 warmup and 3 timed steps from rest on one mesh
with the first model's lam_max values; the configurations run in order
and then in reverse (`--rounds 2`), the host loop first and last, so that
a drift of the card's clocks shows as a difference between the rounds.
Every run of a cell must take the same counts in every step and end with
the same checksum bit for bit. The last line is a JSON summary (means of
the timed steps per configuration). `--device cpu` rehearses it on the
CPU at a small `--scale`. To find what slows the same steps in
`chip_smoke.py`'s main phase, `--kernels-phase` first runs that script's
build and kernels phases, and `--profiler-sessions N` first runs N short
torch.profiler sessions (the card's activity only) around one small op.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def counts(info):
    """(CG, Newton) of a Neo-Hookean step, (CG, 0) of a linear one, and
    whether it met its contract."""
    if hasattr(info, "cg_iterations"):
        return (info.cg_iterations, info.iterations), info.converged
    return (info.iterations, 0), info.residual <= 1e-10


def run(model, stress, device):
    import torch

    from dealii_adapter_tpu_torch.kernels import counters

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    counters.reset()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = model.initial_state()
    rows = []
    for _ in range(4):
        sync()
        syncs0 = model.host_syncs
        launches0 = sum(counters.launch_counts().values())
        t0 = time.perf_counter()
        state, info = model.step(state, stress)
        u = state.displacement
        checksum = torch.dot(u.reshape(-1), u.reshape(-1)).item()
        (cg, newton), ok = counts(info)
        rows.append(dict(
            seconds=time.perf_counter() - t0, cg=cg, newton=newton,
            converged=ok, syncs=model.host_syncs - syncs0,
            launches=sum(counters.launch_counts().values()) - launches0))
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else None)
    return rows, checksum, peak


def sweep(build, configs, rounds, device):
    """Each `(loop, chunk)` of `configs` in turns over `rounds`, models
    from `build(loop, chunk, mesh_tags, lam_max)` on the first model's
    mesh and lam_max values; returns (counts per step, {tag: runs})."""
    import torch

    order = []
    for r in range(rounds):
        order += configs if r % 2 == 0 else configs[::-1]
    mesh_tags, lam_max, ref, results = None, None, None, {}
    for loop, chunk in order:
        tag = "host loop" if loop == "host" else f"graphs, chunk {chunk}"
        t0 = time.perf_counter()
        model = build(loop, chunk, mesh_tags, lam_max)
        if lam_max is None:
            mesh_tags = (model.mesh, model.tags)
            lam_max = [lv.lam_max for lv in model._precond.levels]
        build_s = time.perf_counter() - t0
        rows, checksum, peak = run(model, cs.interface_traction(model), device)
        counts = [(r["cg"], r["newton"]) for r in rows]
        print(f"{tag}: {model.space.n_dofs} DoF, built in {build_s:.1f} s; "
              f"steps {[r['seconds'] for r in rows]} s; CG/Newton {counts}; "
              f"host syncs {[r['syncs'] for r in rows]}; launches "
              f"{[r['launches'] for r in rows]}; peak "
              f"{peak if peak is None else round(peak, 3)} GiB; checksum "
              f"{checksum!r}", flush=True)
        cs.require(all(r["converged"] for r in rows), f"{tag}: converged")
        if ref is None:
            ref = (counts, checksum)
        cs.require(counts == ref[0] and checksum == ref[1],
                   f"{tag}: counts {counts} checksum {checksum!r} against "
                   f"{ref[0]} {ref[1]!r}")
        results.setdefault(tag, []).append(dict(
            timed_mean_s=statistics.mean(r["seconds"] for r in rows[1:]),
            steps_s=[r["seconds"] for r in rows],
            syncs=[r["syncs"] for r in rows],
            launches=[r["launches"] for r in rows], peak_gib=peak))
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return ref[0], results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("nonlinear", "linear"),
                    default="nonlinear")
    ap.add_argument("--chunks", default="1,2,4,8,16")
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--cells", default=",".join(cs.LINEAR_CELLS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profiler-sessions", type=int, default=0)
    ap.add_argument("--kernels-phase", action="store_true")
    args = ap.parse_args()

    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        cs.phase_device()
    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid

    if args.kernels_phase:
        cs.phase_build()
        cs.phase_kernels()
    if args.profiler_sessions:
        from torch.profiler import ProfilerActivity, profile

        for _ in range(args.profiler_sessions):
            with profile(activities=[ProfilerActivity.CUDA]):
                torch.ones(8, device=device).sum()
                torch.cuda.synchronize()
    configs = [("host", None)] + [
        ("graphs", int(n)) for n in args.chunks.split(",")]
    card = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    if args.model == "nonlinear":
        scale = cs.SCALE if args.scale is None else args.scale
        mesh_tags = make_scenario_grid("PF", 3, 2, scale=scale,
                                       solver="neo-Hookean")

        def build(loop, chunk, _mesh_tags, lam_max):
            return cs.build_model(device, scale=scale, mesh_tags=mesh_tags,
                                  mg_lam_max=lam_max, cg_loop=loop,
                                  cg_chunk=chunk)

        per_step, results = sweep(build, configs, args.rounds, device)
        print(json.dumps({"device": card, "cg_newton_per_step": per_step,
                          "runs": results}))
        return
    cells = {}
    for cell in args.cells.split(","):
        print(f"cell {cell}", flush=True)

        def build(loop, chunk, mesh_tags, lam_max, cell=cell):
            kw = {} if chunk is None else {"cg_chunk": chunk}
            return cs.build_linear_cell(cell, device, args.scale,
                                        mesh_tags=mesh_tags,
                                        mg_lam_max=lam_max, cg_loop=loop,
                                        **kw)

        per_step, results = sweep(build, configs, args.rounds, device)
        cells[cell] = dict(cg_per_step=[c for c, _ in per_step],
                           runs=results)
    print(json.dumps({"device": card, "cells": cells}))


if __name__ == "__main__":
    main()
