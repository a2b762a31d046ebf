#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's model through the port's public constructors on one
CUDA card, warms up the shapes and CUDA graphs its traffic uses (set-up),
drives the traffic for `--seconds`, then judges the sampled outputs
against the plain reference (`harness/check.py`). The last line of
standard output is the result: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics, read from a profiled stretch of the window) and
`device`; with `--trace 1` also `breakdown`; last, `check`: each number
compared, with its limit. No card, or fewer than the cell asks for: exit 2
with no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", "_cache")
# every build and kernel cache the run could make, at fixed paths inside
# the checkout (the port builds its kernels into its own `_build/`)
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "dealii_adapter_tpu")


def log(msg):
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names in sys.modules that the run may not load, compared
    whole (`dealii_adapter_tpu_torch` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log_steps(steps, window_s):
    """One line of the window's steps on standard error: their times and
    counts, in order."""
    ms = [round(s["event_ms"] if s["event_ms"] is not None else s["host_s"] * 1e3, 1)
          for s in steps]
    log(f"window {window_s!r} s, {len(steps)} steps: ms {ms}; newton "
        f"{[s['newton_its'] for s in steps]}; cg {[s['cg_its'] for s in steps]}")


def card(torch, chips):
    """The card to run on, or None when the machine lacks the cell's."""
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return None
    if torch.cuda.device_count() < chips:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for {chips}")
        return None
    return torch.device("cuda", 0)


def run(argv=None, device=None, scale=None):
    """One run; returns the result dict, or None without a card. `device`
    and `scale` are the tests' (a CPU rehearsal at a small scale); the
    command line always takes the card and the configuration's scale."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    t_torch = time.perf_counter() - T0
    from benchmark.harness import check, program
    from benchmark.harness.cell import Cell, metric_reader
    from benchmark.harness.trace import DeviceTrace

    cell = Cell(args.workload)
    if device is None:
        device = card(torch, cell.chips)
        if device is None:
            return None
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
    t_cuda = time.perf_counter() - T0
    import dealii_adapter_tpu_torch  # noqa: F401  (the precision policy)

    config, traffic = cell.config, cell.traffic
    t_import = time.perf_counter() - T0
    flap = program.Flap(config, scale)
    model = program.build(config, device, scale)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_build = time.perf_counter() - T0
    load = cell.draw(args.seed)
    driver = cell.driver()(model, flap, traffic, load, args.seed,
                           bool(args.trace))
    driver.warm_up()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    graphs = len(model._graphs)
    setup_s = time.perf_counter() - T0
    log(f"{cell.name}: {flap.n_dofs} DoF, load {load}, set-up {setup_s!r} s "
        f"(at {t_torch:.2f} torch imported, {t_cuda:.2f} the card's context, "
        f"{t_import:.2f} the port imported, {t_build:.2f} the model built)")

    out = driver.window(args.seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if len(model._graphs) != graphs:
        log(f"warning: {len(model._graphs) - graphs} CUDA graphs captured "
            "inside the window")
    prof = out["profile"]
    trace = (DeviceTrace(prof.read(), prof.wall_s)
             if prof is not None and prof.wall_s is not None else None)
    log_steps(out["steps"], out["window_s"])
    if "iterations_per_window" in out:
        log(f"{len(out['iterations_per_window'])} coupling windows: iterations "
            f"{out['iterations_per_window']}; ms "
            f"{[round(t * 1e3, 1) for t in out['window_wall_s']]}")
    r = types.SimpleNamespace(
        cell=cell, config=config, traffic=traffic, load=load,
        n_dofs=flap.n_dofs, setup_s=setup_s, device=device, trace=trace,
        traced_steps=[s for s in out["steps"] if s["traced"]], **{
            k: v for k, v in out.items() if k not in ("samples", "profile")})
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        value = metric_reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check runs with the program's state freed
    samples = out["samples"]
    del driver, model, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, numbers = check.judge(config, samples, cell.limits, device, scale)
    log(f"check: {len(samples)} samples judged in "
        f"{time.perf_counter() - t_check!r} s")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": r.attempted, "failed": r.failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.wall_s
        result["breakdown"] = trace.breakdown()
    result["check"] = numbers
    return result


def main():
    result = run()
    if result is None:
        sys.exit(2)
    found = forbidden_modules()
    if found:
        log(f"modules that the run may not load: {found}")
        sys.exit(3)
    for k, v in result["check"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
