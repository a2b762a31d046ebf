#!/usr/bin/env python3
"""Readings for the limits of a cell's check, on the card: one model,
many seeds, each seed's traffic driven for a short window at the cell's
own size and judged by the check, in one process (the model's set-up is
paid once).

    python benchmark/calibrate.py --workload <cell> --seeds 12 --seconds 8
    python benchmark/calibrate.py --workload <cell> --seeds 3 --control dtype=float32

`--control key=value` overrides the configuration's solver parameters:
the program's own lower-precision path (`dtype=float32`, the nearest
precision below the configuration's float64) is the check's control,
which has to come out not correct. Prints one JSON line a seed: its
numbers, the failed steps and the verdict.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def readings(workload, seeds, seconds, control=(), device=None, scale=None):
    """Yields (seed, correct, numbers, attempted, failed) for each seed."""
    import torch

    from benchmark.harness import check, program
    from benchmark.harness.cell import Cell

    cell = Cell(workload)
    config = dict(cell.config, params=dict(cell.config["params"]))
    for kv in control:
        k, v = kv.split("=", 1)
        try:
            config["params"][k] = json.loads(v)
        except ValueError:
            config["params"][k] = v
    device = torch.device(device or "cuda")
    import dealii_adapter_tpu_torch  # noqa: F401

    flap = program.Flap(config, scale)
    model = program.build(config, device, scale)
    for seed in seeds:
        drv = cell.driver()(model, flap, cell.traffic, cell.draw(seed), seed,
                            False)
        drv.warm_up()
        out = drv.window(seconds)
        correct, numbers = check.judge(config, out["samples"], cell.limits,
                                       device, scale)
        yield seed, correct, numbers, out["attempted"], out["failed"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="append", default=[])
    args = ap.parse_args()
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    t0 = time.perf_counter()
    for seed, correct, numbers, attempted, failed in readings(
            args.workload, seeds, args.seconds, args.control):
        print(json.dumps({
            "workload": args.workload, "control": args.control, "seed": seed,
            "correct": correct, "attempted": attempted, "failed": failed,
            "numbers": {k: v["value"] for k, v in numbers.items()},
            "t": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
