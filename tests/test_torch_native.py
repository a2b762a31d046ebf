"""The port's C++ host helpers (`dealii_adapter_tpu_torch/native.py`)
against numpy, the standard library and the JAX package's `native`
functions: the transpose-gather plan, base64 and the sorted unique ids;
their callers give the same results with and without the library; the
library builds only under the package's `_build/`, once when two
processes start at once. The JAX package's functions run on the port's
library (`jax_lib`, the same source): its own loader would build into
`csrc/build`, the JAX tests' build directory, which these tests leave
alone."""

import base64
import os
import subprocess
import sys

import numpy as np
import pytest

import dealii_adapter_tpu.native as jax_native
from dealii_adapter_tpu_torch import native
from dealii_adapter_tpu_torch.fem import dofspace
from dealii_adapter_tpu_torch.utils import vtk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_lib(monkeypatch):
    """The JAX package's `native` module bound to the port's library."""
    lib = native.get_lib()
    assert lib is not None
    monkeypatch.setattr(jax_native, "_LIB", lib)
    return jax_native


def _numpy_plan(monkeypatch, cells, n_nodes):
    with monkeypatch.context() as m:
        m.setattr(native, "build_plan_native", lambda *a: None)
        return dofspace.build_transpose_gather_plan(cells, n_nodes)


def test_library_builds_under_the_package():
    lib = native.get_lib()
    assert lib is not None, "a C++ compiler is present but the build failed"
    path = native.lib_path()
    assert path.exists()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == (
        native._PKG / "_build") and native._PKG.name == "dealii_adapter_tpu_torch"


def test_plan_matches_numpy_and_jax(monkeypatch, jax_lib):
    rng = np.random.default_rng(0)
    cells = rng.integers(0, 777, (321, 16)).astype(np.int32)
    plan, sentinel = native.build_plan_native(cells, 777)
    plan_np, sentinel_np = _numpy_plan(monkeypatch, cells, 777)
    assert sentinel == sentinel_np and plan.dtype == plan_np.dtype
    np.testing.assert_array_equal(plan, plan_np)
    # the caller takes the native path and gives the same plan
    got, s = dofspace.build_transpose_gather_plan(cells, 777)
    np.testing.assert_array_equal(got, plan_np)
    jax_plan, jax_sentinel = jax_lib.build_plan_native(cells, 777)
    np.testing.assert_array_equal(plan, jax_plan)
    assert sentinel == jax_sentinel


@pytest.mark.parametrize("n", [0, 1, 2, 3, 99991])
def test_b64_matches_stdlib_and_jax(jax_lib, n):
    data = np.random.default_rng(1).bytes(n)
    want = base64.b64encode(data).decode()
    assert native.b64_native(data) == want
    assert jax_lib.b64_native(data) == want


def test_vtk_b64_with_and_without_the_library(monkeypatch):
    arr = np.random.default_rng(3).standard_normal((57, 3))
    fast = vtk._b64(arr)
    monkeypatch.setattr(native, "b64_native", lambda data: None)
    assert vtk._b64(arr) == fast


def test_unique_sorted_matches_numpy_and_jax(jax_lib):
    ids = np.random.default_rng(2).integers(0, 100, 1000).astype(np.int32)
    got = native.unique_sorted_native(ids, 100)
    np.testing.assert_array_equal(got, np.unique(ids))
    np.testing.assert_array_equal(got, jax_lib.unique_sorted_native(ids, 100))


def test_two_processes_build_once(tmp_path):
    """Two processes that start at once on an empty build directory: one
    builds under the lock, the other waits, and both load the library."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from dealii_adapter_tpu_torch import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "lib = native.get_lib()\n"
        "assert lib is not None\n"
        "print(native.lib_path())\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    built = [f for f in os.listdir(tmp_path) if f.endswith(".so")]
    assert built == [os.path.basename(paths.pop())]
