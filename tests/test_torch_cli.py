"""The PyTorch package's CLI (`python -m dealii_adapter_tpu_torch`) with
`--device cpu` against the JAX package's CLI on tests/test_cli.py's two
cases: exit code 0, the same output lines and VTU file names, and the
displacement of every VTU file equal to the JAX CLI's at rtol 1e-9."""

import base64
import os
import re
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from dealii_adapter_tpu.cli import main as jax_main
from dealii_adapter_tpu_torch.cli import main

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRM = """
subsection Time
  set End time = 0.02
  set Time step size = 0.01
  set Output interval = 1
  set Output folder = {out}
end
subsection System properties
  set Shear modulus = 0.5e6
  set Poisson's ratio = 0.4
  set rho = 1000
end
subsection Solver
  set Model = {model}
  set Solver type = CG
end
subsection Discretization
  set Polynomial degree = 1
end
subsection precice configuration
  set Scenario = PF
end
"""


def _write_prm(tmp_path, model, tag):
    out = tmp_path / f"out_{tag}"
    prm = tmp_path / f"case_{tag}.prm"
    prm.write_text(PRM.format(out=str(out), model=model))
    return str(prm), str(out)


def _displacement(path):
    """The "displacement" point array of a VTU file (binary, UInt64
    header), as (n_points, 3) float64."""
    text = open(path).read()
    m = re.search(r'Name="displacement"[^>]*>\n(.*?)\n</DataArray>', text, re.S)
    raw = base64.b64decode(m.group(1))
    (n,) = struct.unpack("<Q", raw[:8])
    return np.frombuffer(raw[8:8 + n], dtype=np.float64).reshape(-1, 3)


@pytest.mark.parametrize(
    "model,traction,check",
    [("linear", ["1000", "0"], "cg_its="),
     ("neo-Hookean", ["2000", "0"], "newton_its=")],
)
def test_cli_matches_jax(tmp_path, capsys, model, traction, check):
    jprm, jout = _write_prm(tmp_path, model, "jax")
    tprm, tout = _write_prm(tmp_path, model, "torch")
    assert jax_main([jprm, "--standalone", "--traction", *traction]) == 0
    jtext = capsys.readouterr().out
    assert main([tprm, "--standalone", "--traction", *traction,
                 "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert f"model '{model}'" in text and check in text
    assert "--     . device cpu" in text
    # plain versions on the CPU; the build's counts and the run's apart
    assert "kernel launches (model build): {}" in text
    assert "kernel launches: {}" in text
    # the same per-window lines (iteration counts, residuals)
    per_window = [x for x in text.splitlines() if x.startswith("  t=")]
    assert len(per_window) == 2
    assert [x.split()[0] for x in per_window] == [
        x.split()[0] for x in jtext.splitlines() if x.startswith("  t=")]
    files = sorted(os.listdir(tout))
    assert files == sorted(os.listdir(jout)) == [
        "solution-2d-1.vtu", "solution-2d-2.vtu"]
    for f in files:
        a = _displacement(os.path.join(jout, f))
        b = _displacement(os.path.join(tout, f))
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9 * np.abs(a).max())


def test_cli_no_output_and_no_card(tmp_path, capsys):
    """`--no-output` writes no folder; without `--device cpu` and without a
    card the run raises (in its own process: `python -m`), naming CUDA."""
    prm, out = _write_prm(tmp_path, "neo-Hookean", "x")
    assert main([prm, "--standalone", "--traction", "2000", "0",
                 "--no-output", "--device", "cpu"]) == 0
    assert "minJ=" in capsys.readouterr().out
    assert not os.path.exists(out)
    if torch.cuda.is_available():
        return
    r = subprocess.run(
        [sys.executable, "-m", "dealii_adapter_tpu_torch", prm, "--no-output"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300,
    )
    assert r.returncode != 0 and "CUDA" in r.stderr


def test_cli_verbose_prints_the_newton_table(tmp_path, capsys):
    """`--verbose` passes `verbose` to the Neo-Hookean model, as the JAX
    CLI does: each window prints the per-iteration Newton table (`NR it`
    0 to its Newton iterations, the JAX package's line), and the window's
    line and its full solver info still follow."""
    prm, _ = _write_prm(tmp_path, "neo-Hookean", "v")
    assert main([prm, "--standalone", "--traction", "2000", "0",
                 "--no-output", "--device", "cpu", "--verbose"]) == 0
    lines = capsys.readouterr().out.splitlines()
    windows = [i for i, x in enumerate(lines) if x.startswith("  t=")]
    assert len(windows) == 2
    start = 0
    for i in windows:
        its = [int(m[1]) for m in (re.match(r"^    NR it (\d+): RES_F\(abs\) "
                                            r"\S+  RES_F\(rel\) \S+  NU\(rel\) "
                                            r"\S+  min J \S+$", x)
                                   for x in lines[start:i]) if m]
        newton = int(re.search(r"newton_its=(\d+)", lines[i])[1])
        assert its == list(range(newton + 1))
        assert lines[i + 1].startswith("    NewtonInfo(")
        start = i + 1
