#!/usr/bin/env python3
"""The 3D Neo-Hookean step of `chip_smoke.py`'s main path with its CG in
CUDA graphs at several chunk lengths and with the host loop, in one
process: per step the wall time, CG and Newton counts, host syncs and
kernel launches, and each run's peak device memory.

    python3 tools/cg_chunk_sweep.py [--chunks 1,2,4,8,16] [--scale 9]
                                    [--rounds 2] [--device cuda|cpu]
                                    [--profiler-sessions N] [--kernels-phase]

Each configuration runs 1 warmup and 3 timed steps from rest on one mesh
with the first model's lam_max values; the configurations run in order
and then in reverse (`--rounds 2`), the host loop first and last, so that
a drift of the card's clocks shows as a difference between the rounds.
Every run must take the same CG and Newton counts in every step and end
with the same checksum bit for bit. The last line is a JSON summary
(means of the timed steps per configuration). `--device cpu` rehearses it
on the CPU at a small `--scale`. To find what slows the same steps in
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
        rows.append(dict(
            seconds=time.perf_counter() - t0, cg=info.cg_iterations,
            newton=info.iterations, converged=info.converged,
            syncs=model.host_syncs - syncs0,
            launches=sum(counters.launch_counts().values()) - launches0))
    peak = (torch.cuda.max_memory_allocated() / 2**30
            if device.type == "cuda" else None)
    return rows, checksum, peak


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="1,2,4,8,16")
    ap.add_argument("--scale", type=int, default=cs.SCALE)
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
    mesh_tags = make_scenario_grid("PF", 3, 2, scale=args.scale,
                                   solver="neo-Hookean")
    configs = [("host", None)] + [
        ("graphs", int(n)) for n in args.chunks.split(",")]
    order = []
    for r in range(args.rounds):
        order += configs if r % 2 == 0 else configs[::-1]
    lam_max, ref, results = None, None, {}
    for loop, chunk in order:
        tag = "host loop" if loop == "host" else f"graphs, chunk {chunk}"
        t0 = time.perf_counter()
        model = cs.build_model(device, scale=args.scale, mesh_tags=mesh_tags,
                               mg_lam_max=lam_max, cg_loop=loop,
                               cg_chunk=chunk)
        if lam_max is None:
            lam_max = [lv.lam_max for lv in model._precond.levels]
        build = time.perf_counter() - t0
        rows, checksum, peak = run(model, cs.interface_traction(model), device)
        counts = [(r["cg"], r["newton"]) for r in rows]
        print(f"{tag}: built in {build:.1f} s; steps "
              f"{[r['seconds'] for r in rows]} s; CG/Newton {counts}; host "
              f"syncs {[r['syncs'] for r in rows]}; launches "
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
    print(json.dumps({"device": (torch.cuda.get_device_name(0)
                                 if device.type == "cuda" else "cpu"),
                      "cg_newton_per_step": ref[0], "runs": results}))


if __name__ == "__main__":
    main()
