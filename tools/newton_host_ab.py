#!/usr/bin/env python3
"""The Neo-Hookean step on the host CG loop, two trees in turns, on one card.

    python3 tools/newton_host_ab.py --trees OLD NEW [--order ABBA] \
        [--steps 5] [--shard-steps 3] [--paths main3d_host shard3d ...] \
        [--out output/newton_host_ab.json]

Runs, for each tree of `--order` (A = OLD, B = NEW; default A, B, B, A)
in a subprocess of its own that imports that tree's package and
`chip_smoke.py`, the paths whose Krylov loop runs on the host
(`cg_loop="host"`), where the Newton loop's read-backs are not hidden by
CUDA graphs (`--paths` chooses among them; all by default):

- main3d host: `chip_smoke.py`'s main configuration (3D Neo-Hookean flap,
  Q2, scale 9: 1,018,875 DoF) in this process, 1 warmup and `--steps` - 1
  timed steps from rest;
- shard3d: the same on the lattice partition over 2 gloo ranks sharing
  the card (its lam_max values), `--shard-steps` steps;
- shard_cells: `chip_smoke.py`'s cell-partition configuration
  (`SHARD_CELLS` at `SHARD_CELLS_SCALE`) on 2 gloo ranks,
  `SHARD_CELLS_STEPS` steps.

Per step: the wall time (the card synchronized before and after), Newton
and CG counts, and the read-backs outside the CG (`host_syncs` less
`cg_host_syncs`); ||u||^2 after the last step. Prints one JSON line a run,
then each tree's medians of the timed steps, and writes all of it to
`--out`. With `--device cpu --scale 1` it rehearses the same on the CPU
(times there are not device metrics).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PATHS = ("main3d_host", "shard3d", "shard_cells")

def _import_tree(tree):
    """The tree's `chip_smoke` (and so its package) on sys.path first."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke

    return chip_smoke


def _steps(model, stress, n, sync, reduce=float):
    """`n` steps from rest: per-step times, Newton, CG, read-backs outside
    the CG; ||u||^2 after the last (`reduce` sums it over ranks)."""
    import torch

    state = model.initial_state()
    out = dict(times=[], newton=[], cg=[], outside=[], converged=[])
    for _ in range(n):
        sync()
        outside0 = model.host_syncs - model.cg_host_syncs
        ts = time.perf_counter()
        state, info = model.step(state, stress)
        sync()
        out["times"].append(time.perf_counter() - ts)
        out["outside"].append(model.host_syncs - model.cg_host_syncs - outside0)
        out["newton"].append(info.iterations)
        out["cg"].append(info.cg_iterations)
        out["converged"].append(bool(info.converged))
    u = state.displacement.reshape(-1)
    out["checksum"] = reduce(torch.dot(u, u))
    return out


def _rank(mesh, tree, scale, n_steps, lam_max, cells):
    """One gloo rank (a spawned process): shard3d's model (`cells`:
    shard_cells') on `mesh`, `n_steps` steps."""
    cs = _import_tree(tree)
    import torch

    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)

    dev = mesh.device
    if cells:
        model = cs.build_model(dev, scale=cs.SHARD_CELLS_SCALE,
                               cg_loop="host", device_mesh=mesh,
                               **cs.SHARD_CELLS)
        n_steps = cs.SHARD_CELLS_STEPS
    else:
        model = cs.build_model(dev, scale=scale, mg_lam_max=lam_max,
                               cg_loop="host", device_mesh=mesh)
    stress = model.local_rows(cs.interface_traction(model))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # a replicated field under the cell partition, this rank's rows else
    reduce = float if cells else (lambda x: float(mesh.all_reduce(x)))
    return dict(_steps(model, stress, n_steps, sync, reduce),
                rank=mesh.rank, calls=dict(mesh.calls))


def run_one(args):
    """Every path on one tree; prints and returns its record."""
    tree = os.path.abspath(args.tree)
    cs = _import_tree(tree)
    import torch

    import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
    from dealii_adapter_tpu_torch.parallel import spawn

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    rec = dict(tree=args.tree)
    if cuda:
        from dealii_adapter_tpu_torch.kernels import _build

        t0 = time.perf_counter()
        _build.load_library()  # build once, before the ranks start
        rec["build_s"] = time.perf_counter() - t0
    scale = args.scale or cs.SCALE
    t0 = time.perf_counter()
    model = cs.build_model(dev, scale=scale, cg_loop="host")
    rec["model_build_s"] = time.perf_counter() - t0
    lam_max = [lv.lam_max for lv in model._precond.levels]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if "main3d_host" in args.paths:
        rec["main3d_host"] = _steps(model, cs.interface_traction(model),
                                    args.steps, sync)
    del model
    if cuda:
        torch.cuda.empty_cache()
    for name, cells in (("shard3d", False), ("shard_cells", True)):
        if name not in args.paths:
            continue
        t0 = time.perf_counter()
        ranks = spawn(_rank, 2, dev, tree, scale,
                      args.shard_steps, lam_max, cells, backend="gloo")
        rec[name] = dict(ranks[0], wall_s=time.perf_counter() - t0,
                         same_on_ranks=all(
                             (r["newton"], r["checksum"]) == (
                                 ranks[0]["newton"], ranks[0]["checksum"])
                             for r in ranks))
    print(json.dumps(rec), flush=True)
    return rec


def _timed(rec, path):
    """The times of `path`'s timed steps (after the warmup)."""
    return rec[path]["times"][1:]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # one run
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--shard-steps", type=int, default=3)
    ap.add_argument("--scale", type=int, default=None)
    ap.add_argument("--paths", nargs="+", choices=PATHS, default=PATHS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("output",
                                                  "newton_host_ab.json"))
    args = ap.parse_args()
    if args.tree:
        run_one(args)
        return
    out_path = os.path.abspath(args.out)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    runs = []
    for which in args.order:
        tree = args.trees["AB".index(which)]
        cmd = [sys.executable, os.path.abspath(__file__), "--tree",
               os.path.abspath(tree),
               "--steps", str(args.steps), "--shard-steps",
               str(args.shard_steps), "--device", args.device,
               "--paths", *args.paths]
        if args.scale:
            cmd += ["--scale", str(args.scale)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode:
            raise SystemExit(f"{tree}: exit {p.returncode}")
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        rec.update(which=which, wall_s=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    summary = {}
    for which, tree in zip("AB", args.trees):
        mine = [r for r in runs if r["which"] == which]
        summary[tree] = {
            path: dict(
                median_s=statistics.median(
                    t for r in mine for t in _timed(r, path)),
                outside=[r[path]["outside"] for r in mine],
                newton=[r[path]["newton"] for r in mine],
                cg=[r[path]["cg"] for r in mine],
                checksums=[r[path]["checksum"] for r in mine])
            for path in args.paths}
    print(json.dumps({"summary": summary}), flush=True)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(dict(runs=runs, summary=summary), f, indent=1)


if __name__ == "__main__":
    main()
