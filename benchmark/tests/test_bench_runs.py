"""Whole runs of each cell rehearsed on the CPU at scale 1 (the harness's
look for a card skipped): the result line's keys, and `correct` coming
out false when the timed path is broken underneath."""

import json

import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.harness import cell as C

SPEC = C.load_json(C.os.path.join(C.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 12345


@pytest.fixture(autouse=True)
def short_warm_up(monkeypatch):
    """No warm-up steps on the CPU (it has no graphs to capture), and one
    warm-up coupling window."""
    init = C.Cell.__init__

    def short(self, *a, **k):
        init(self, *a, **k)
        self.traffic = dict(self.traffic, warmup_steps=0, warmup_windows=1)

    monkeypatch.setattr(C.Cell, "__init__", short)


def rehearse(cell, trace=0, seconds=1.0):
    return R.run(["--workload", cell, "--seed", str(SEED), "--seconds",
                  str(seconds), "--trace", str(trace)], device="cpu", scale=1)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_the_contract_keys(cell):
    res = rehearse(cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device",
                         "check"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    e2e = {m["name"] for m in C.Cell(cell).metrics(False)}
    # the step's percentile needs two steps, more than a CPU second holds
    assert {"setup_s"} < set(res["metrics"]) <= e2e
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    for v in res["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)


@pytest.mark.parametrize("cell", ["linear_q3_flap3d.march",
                                  "linear_q3_flap3d.fsi_implicit"])
def test_traced_run_reports_the_counters(cell):
    res = rehearse(cell, trace=1)
    counters = {m["name"] for m in C.Cell(cell).metrics(True)
                if m["source"] != "device_trace"}
    assert counters <= set(res["metrics"])  # no device trace on the CPU


def _fault(kind):
    """A `step` that breaks the model's own step's output."""
    def broken(step):
        def run(state, data):
            new, info = step(state, data)
            d = new._asdict()
            if kind == "unchanged":
                d = {k: v.clone() for k, v in state._asdict().items()}
            elif kind == "half_left_out":
                n = d["displacement"].shape[0] // 2
                d = {k: torch.cat([v[:n], state._asdict()[k][n:]])
                     for k, v in d.items()}
            else:  # one answer altered where it is produced
                u = d["displacement"].clone()
                u[int(u[:, 0].abs().argmax()), 0] *= 1.001
                d["displacement"] = u
            return type(new)(**d), info
        return run
    return broken


@pytest.mark.parametrize("kind", ["unchanged", "half_left_out", "one_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, kind, monkeypatch):
    """The fault is planted in the model's step once set-up is done, so
    the window drives it."""
    from benchmark.harness import drivers

    for cls in drivers.DRIVERS.values():
        window = cls.window

        def broken_window(self, seconds, window=window):
            self.model.step = _fault(kind)(self.model.step)
            return window(self, seconds)

        monkeypatch.setattr(cls, "window", broken_window)
    res = rehearse(cell, seconds=0.5)
    assert res["correct"] is False, res["check"]


def test_the_copied_fluid_iterates_as_the_programs():
    """The benchmark's surrogate fluid against the program's own on a small
    2D linear flap: the same implicit iterations in every window."""
    from dealii_adapter_tpu_torch.adapter.adapter import Adapter
    from dealii_adapter_tpu_torch.adapter.participant import (
        SurrogateFluidParticipant,
    )
    from dealii_adapter_tpu_torch.config import AllParameters
    from dealii_adapter_tpu_torch.models.linear_elasticity import (
        LinearElastodynamics,
    )
    from dealii_adapter_tpu_torch.runner import coupled_run

    from benchmark.harness.participant import TimedSurrogateFluid

    p = AllParameters(model="linear", scenario="PF", dim=2, poly_degree=2,
                      delta_t=0.005, end_time=0.03, preconditioner="None")
    cpu = torch.device("cpu")
    k = 4.0e5

    def stress_fn(t, coords, u):
        sig = -k * u
        sig[:, 0] += 1000.0 * np.sin(2 * np.pi * t)
        return sig

    counts = []
    for make in (
            lambda: SurrogateFluidParticipant(2, p.delta_t, p.end_time, stress_fn,
                                              eps=5e-3, initial_relaxation=0.5),
            lambda: TimedSurrogateFluid(2, p.delta_t, stress_fn, eps=5e-3,
                                        max_iterations=50, initial_relaxation=0.5,
                                        max_windows=6)):
        model = LinearElastodynamics(p, device=cpu)
        fluid = make()
        coupled_run(model, Adapter(p, model.interface_id, model.space,
                                   participant=fluid, dtype=model.dtype,
                                   device=cpu))
        counts.append(fluid.iterations_per_window)
    assert counts[0] == counts[1] and len(counts[0]) == 6
    assert max(counts[0]) >= 3
