"""The benchmark's files against the contract: BENCHMARK.json's keys,
names and units, and every file a cell needs found by its name."""

import ast
import json
import os
import re

import pytest

from benchmark.harness import cell as C

ROOT, BENCH = C.ROOT, C.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = C.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    allnames = names + [w["name"] for w in SPEC["workloads"]] + [
        m["name"] for m in metrics]
    assert all(NAME.match(n) for n in allnames)
    assert len(set(allnames)) == len(allnames)


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_files(w):
    cell = C.Cell(w["name"], SPEC)
    assert cell.config["name"] == w["config"]
    assert cell.traffic["driver"] in ("march", "coupled")
    e2e = [m["name"] for m in cell.metrics(False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = cell.metrics(True)
    assert per_layer
    for m in cell.metrics(False) + per_layer:
        assert callable(C.metric_reader(m["name"]))
        if m["name"].endswith("_roofline.march"):
            assert C.kernel_patterns(m["name"])
    # every per-layer metric's end-to-end metric is reported in the cell
    assert {m["moves"] for m in per_layer} <= set(e2e)


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = C.load_json(os.path.join(ROOT, c["file"]))
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] == []
    assert cfg["params"]["dtype"] == "float64"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_and_a_reference_that_imports_nothing_of_the_port():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "dealii_adapter_tpu"}, path
    for path in _sources("reference"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "numpy", "torch"}, (path, tops)


def test_a_run_without_a_card_prints_nothing(monkeypatch, capsys):
    import torch

    from benchmark import run as R

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        monkeypatch.setattr("sys.argv", ["run.py", "--workload",
                                         SPEC["workloads"][0]["name"],
                                         "--seed", "1", "--seconds", "1"])
        R.main()
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_a_mix_that_brings_code_is_driven_by_it(tmp_path, monkeypatch):
    """`traffic/<mix>.py` takes the place of the general generator and loop
    for its mix alone; a mix of data alone keeps them."""
    from benchmark.harness import drivers

    w = SPEC["workloads"][0]
    for sub in ("traffic", "limits"):
        (tmp_path / sub).mkdir()
    (tmp_path / "traffic" / "own.json").write_text(json.dumps(
        {"driver": "march", "traction_pa": 1.0}))
    (tmp_path / "traffic" / "own.py").write_text(
        "def draw(traffic, seed):\n"
        "    return {'seed': seed, 'pa': traffic['traction_pa']}\n\n\n"
        "class Driver:\n    pass\n")
    (tmp_path / "traffic" / "plain.json").write_text(json.dumps(
        {"driver": "coupled"}))
    for name in ("x.own", "x.plain"):
        (tmp_path / "limits" / (name + ".json")).write_text("{}")
    spec = dict(SPEC, workloads=[
        dict(w, name="x.own", traffic="own"),
        dict(w, name="x.plain", traffic="plain")])
    monkeypatch.setattr(C, "BENCH_DIR", str(tmp_path))
    own, plain = C.Cell("x.own", spec), C.Cell("x.plain", spec)
    assert own.draw(7) == {"seed": 7, "pa": 1.0}
    assert own.driver().__name__ == "Driver"
    assert plain.driver() is drivers.CoupledRun
    assert plain.draw(7) == drivers.draw({}, 7)


@pytest.mark.parametrize("w", [w for w in SPEC["workloads"]
                               if w["traffic"] == "fsi_implicit"],
                         ids=lambda w: w["name"])
def test_a_coupled_episode_is_half_a_period_of_the_load(w):
    """The coupling window defaults to the configuration's dt, and an
    episode from rest runs the windows of `episode_periods` of the sine."""
    import types

    from benchmark.harness import drivers

    cell = C.Cell(w["name"], SPEC)
    dt = cell.config["params"]["delta_t"]
    model = types.SimpleNamespace(params=types.SimpleNamespace(delta_t=dt))
    run = drivers.CoupledRun(model, None, cell.traffic, {}, 1, False)
    assert run.window_dt == dt
    f = cell.traffic["frequency_hz"]
    n = run.episode_windows()
    assert n * dt * f == pytest.approx(cell.traffic["episode_periods"])
    assert n == {0.005: 50, 0.01: 25}[dt]
    assert drivers.CoupledRun(model, None, dict(cell.traffic, window_s=2 * dt),
                              {}, 1, False).window_dt == 2 * dt
