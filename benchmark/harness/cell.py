"""Finds a cell's pieces by the names in BENCHMARK.json: the workload
entry, its configuration file, its traffic mix (`traffic/<mix>.json`, and
`traffic/<mix>.py` where the mix brings code of its own), the limits of
its check (`limits/<cell>.json`) and the readers of its metrics
(`metrics/<metric>.py`, with `metrics/<metric>.kernels/*.txt` holding the
kernel names a device-time metric sums)."""

from __future__ import annotations

import glob
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, bench: dict | None = None):
        self.bench = bench if bench is not None else load_json(
            os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(os.path.join(ROOT, self.config_entry["file"]))
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                              self.traffic_name + ".json"))
        self.traffic_code = _load_module(
            os.path.join(BENCH_DIR, "traffic", self.traffic_name + ".py"),
            "benchmark_traffic_")
        self.limits = load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
        self.chips = int(self.workload["chips"])

    def draw(self, seed: int) -> dict:
        """The run's load from the mix and the seed: the mix's own `draw`
        where `traffic/<mix>.py` has one, else the general generator's."""
        from . import drivers

        fn = getattr(self.traffic_code, "draw", None) or drivers.draw
        return fn(self.traffic, seed)

    def driver(self):
        """The loop that drives the program: the mix's own `Driver` where
        `traffic/<mix>.py` has one, else the general loop its `driver`
        key names (`march` or `coupled`)."""
        from . import drivers

        return (getattr(self.traffic_code, "Driver", None)
                or drivers.DRIVERS[self.traffic["driver"]])

    def metrics(self, trace: bool) -> list:
        """The entries of the metrics this cell reports in a run with or
        without tracing: an end-to-end metric without a `workloads` key is
        every cell's; a per-layer metric names its cells."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[key]
                if self.name in m.get("workloads", [self.name])]


def _load_module(path: str, prefix: str):
    """The module in the file at `path`, or None where there is no file."""
    if not os.path.exists(path):
        return None
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The `read(run)` function of `metrics/<name>.py`."""
    return _load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                        "benchmark_metric_").read


def kernel_patterns(name: str) -> list:
    """The regular expressions of the kernels that implement the operator
    of metric `name`, one file each under `metrics/<name>.kernels/`."""
    out = []
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "metrics",
                                              name + ".kernels", "*.txt"))):
        with open(path) as fh:
            out += [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]
    return out
