"""`bench_torch.py`, the port's benchmark entry point: one JSON line with
bench.py's keys from a tiny CPU run of each model, no jax on import, the
same `AllParameters` as bench.py's `build_model` and `build_linear_model`
(read from bench.py's source with `ast`, default and set environment
knobs), and a plausibility floor that stays a lower bound: it never
exceeds the sum of its timed components, leaves a non-positive chain
out, and a step faster than it exits 3."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import bench_torch
from dealii_adapter_tpu_torch.config import AllParameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

KEYS = {"metric", "value", "unit", "s_per_step", "n_dofs", "degree", "device"}


def _bench(env, timeout=300):
    full = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env)
    full.pop("BENCH_DEVICE", None)
    return subprocess.run(
        [sys.executable, "bench_torch.py", "--device", "cpu"], cwd=REPO,
        env=full, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("env,metric,n_dofs", [
    ({"BENCH_SCALE": "1", "BENCH_STEPS": "1"}, bench_torch.NONLINEAR_METRIC,
     2331),
    ({"BENCH_MODEL": "linear", "BENCH_DEGREE": "3", "BENCH_SCALE": "1",
      "BENCH_STEPS": "1"}, bench_torch.LINEAR_METRIC, 6600),
], ids=["nonlinear", "linear_q3"])
def test_prints_one_json_line(env, metric, n_dofs):
    r = _bench(env)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == KEYS
    assert out["metric"] == metric and out["unit"] == "MDoF*steps/s"
    assert out["n_dofs"] == n_dofs and out["degree"] == int(
        env.get("BENCH_DEGREE", "2"))
    assert out["value"] > 0 and out["s_per_step"] > 0
    assert out["device"].startswith("cpu")
    assert "guard passed" in r.stderr
    assert "step 1 (timed)" in r.stderr


def test_imports_no_jax():
    r = subprocess.run(
        [sys.executable, "-c",
         "import bench_torch, sys; bench_torch.nonlinear_config(); "
         "assert 'jax' not in sys.modules and 'torch' not in sys.modules"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_kernels_off_raises(monkeypatch):
    monkeypatch.setenv("BENCH_USE_PALLAS", "0")
    with pytest.raises(ValueError, match="no kernels-off mode"):
        bench_torch.nonlinear_config()
    with pytest.raises(ValueError, match="no kernels-off mode"):
        bench_torch.linear_config()


def _bench_py_params(name, degree, dtype):
    """The keywords of the `AllParameters(...)` call in bench.py's
    function `name`, evaluated under the current environment."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "AllParameters")
    scope = {"os": os, "int": int, "float": float}
    return {kw.arg: eval(compile(ast.Expression(kw.value), "bench.py", "eval"),
                         scope, {"degree": degree, "dtype": dtype})
            for kw in call.keywords}


KNOBS = {
    "BENCH_PRECOND": "Jacobi", "BENCH_PRECOND_DTYPE": "float32",
    "BENCH_SOLVE_DTYPE": "", "BENCH_FORCING": "fixed",
    "BENCH_MG_DEGREE": "2", "BENCH_MG_FINE_DEGREE": "3",
    "BENCH_PREDICTOR": "0", "BENCH_EW_ETA0": "0.2",
    "BENCH_MG_FINE_TANGENT": "1", "BENCH_TANGENT_PRECISION": "high",
    "BENCH_TANGENT_SYM": "1", "BENCH_TANGENT_KERNEL": "blocks",
    "BENCH_TANGENT_REUSE": "1", "BENCH_TANGENT_REUSE_AFTER": "2",
    "BENCH_TANGENT_REFRESH_RATIO": "0.05", "BENCH_F64_WINDOW": "10",
    "BENCH_SUMFACT": "1",
}


@pytest.mark.parametrize("knobs", [False, True], ids=["defaults", "knobs"])
@pytest.mark.parametrize("name,config", [
    ("build_model", bench_torch.nonlinear_config),
    ("build_linear_model", bench_torch.linear_config),
])
def test_parameters_equal_bench_py(monkeypatch, knobs, name, config):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    if knobs:
        for k, v in KNOBS.items():
            monkeypatch.setenv(k, v)
    for degree, dtype in ((2, "float64"), (4, "float32")):
        want = AllParameters(**_bench_py_params(name, degree, dtype))
        got = AllParameters(**config(degree, dtype))
        for field in want.__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), field


def test_floor_is_a_lower_bound():
    counts = {"t_f64": 3, "t_f32": 2, "t_asm": 4, "t_operator": 30,
              "t_preconditioner": 30}
    per_call = {"t_f64": 0.04, "t_f32": 0.02, "t_asm": -0.001,
                "t_operator": 0.0005, "t_preconditioner": 0.0}
    floor, terms = bench_torch.floor_seconds(counts, per_call)
    # the non-positive chains are left out, never replaced by a guess
    assert set(terms) == {"t_f64", "t_f32", "t_operator"}
    total = sum(counts[k] * t for k, t in per_call.items() if t > 0)
    assert floor == pytest.approx(0.5 * total)
    assert floor <= sum(counts[k] * max(t, 0.0) for k, t in per_call.items())
    # no positive component: no floor
    assert bench_torch.floor_seconds(counts, {"t_f64": 0.0})[0] == 0.0


def test_floor_counts_the_residuals_newton_info_leaves_out():
    """The solve-dtype residual the device Newton loop evaluates and
    discards at rest counts in the floor's f32 term."""
    d = dict(newton_its=2, cg_its=10, f64_evals=2, f32_evals=1,
             tangent_asm=1, f32_uncounted=1)
    assert bench_torch.step_counts(d)["t_f32"] == 2
    del d["f32_uncounted"]
    assert bench_torch.step_counts(d)["t_f32"] == 1


def test_guard_exits_3_on_a_too_fast_step():
    per_call = {"t_f64": 0.01, "t_operator": 0.001}
    diags = [dict(step=0, warmup=True, s=1e-9, newton_its=1, cg_its=10,
                  f64_evals=2, f32_evals=0, tangent_asm=1),
             dict(step=1, warmup=False, s=0.1, newton_its=1, cg_its=10,
                  f64_evals=2, f32_evals=0, tangent_asm=1)]
    bench_torch.plausibility_guard(diags, per_call)  # 0.1 s >= 0.015 s
    diags[1]["s"] = 0.014
    with pytest.raises(SystemExit) as e:
        bench_torch.plausibility_guard(diags, per_call)
    assert e.value.code == 3
    lin = [dict(step=1, warmup=False, s=0.004, cg_its=10)]
    with pytest.raises(SystemExit):
        bench_torch.plausibility_guard(lin, {"t_operator": 0.001})


def test_checks_fail_without_the_json_line():
    fails = bench_torch.check(
        "nonlinear", [dict(step=0, converged=False, checksum=49.0)],
        ("nonlinear", 2, 9), True)
    assert any("did not converge" in f for f in fails)
    assert any("vs 49.05486138743322" in f for f in fails)
    fails = bench_torch.check(
        "linear", [dict(step=0, residual=2e-10, checksum=1.0)],
        ("linear", 2, 1), True)
    assert fails == ["step 0 residual 2e-10 > 1e-10"]
