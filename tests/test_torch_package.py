"""Package-level guarantees of the PyTorch port: it never imports jax, its
kernel wrappers take the plain version only for CPU tensors, unported
variants raise, the kernel build needs nvcc, and chip_smoke.py fails
without a GPU. One test compares the kernels with their plain versions
on the card; it skips where there is none."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import dealii_adapter_tpu_torch  # noqa: F401  (precision policy)
from dealii_adapter_tpu_torch.config import AllParameters
from dealii_adapter_tpu_torch.kernels import _build
from dealii_adapter_tpu_torch.models.nonlinear_elasticity import (
    NonlinearElasticity,
)
from dealii_adapter_tpu_torch.ops import assembled_tangent as at
from dealii_adapter_tpu_torch.ops.q1_structured import Q1StructuredOperator
from dealii_adapter_tpu_torch.ops.q2_structured import Q2StructuredOperator

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=REPO, timeout=300):
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_package_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dealii_adapter_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert 'dealii_adapter_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    r = _run(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_precision_policy_is_set():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _small_inputs(dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    KT = torch.randn(81, 81, 37, generator=g).to(dtype)
    u2 = torch.randn(81, 37, generator=g).to(dtype)
    lattice = (5, 7, 9)
    E1 = np.random.default_rng(seed).standard_normal((24, 24))
    E2 = np.random.default_rng(seed).standard_normal((81, 81))
    u = torch.randn(int(np.prod(lattice)), 3, generator=g).to(dtype)
    return KT, u2, lattice, E1 + E1.T, E2 + E2.T, u


def test_cpu_tensors_take_the_plain_path():
    KT, u2, lattice, E1, E2, u = _small_inputs()
    at.apply_packed_tangents_T.launches = 0
    Q1StructuredOperator.launches = Q2StructuredOperator.launches = 0
    torch.testing.assert_close(
        at.apply_packed_tangents_T(KT, u2), at.apply_packed_tangents_T_plain(KT, u2)
    )
    for cls, E in ((Q1StructuredOperator, E1), (Q2StructuredOperator, E2)):
        op = cls(E, lattice, torch.float32)
        torch.testing.assert_close(op(u), op.plain(u), rtol=0, atol=0)
    assert at.apply_packed_tangents_T.launches == 0
    assert Q1StructuredOperator.launches == Q2StructuredOperator.launches == 0


def test_non_cpu_non_cuda_tensors_raise():
    """A tensor that is neither on the CPU nor on a CUDA device never falls
    back to the plain version."""
    KT, u2, lattice, E1, _, u = _small_inputs()
    with pytest.raises(ValueError):
        at.apply_packed_tangents_T(KT.to("meta"), u2.to("meta"))
    with pytest.raises(ValueError):
        Q1StructuredOperator(E1, lattice, torch.float32)(u.to("meta"))


@pytest.mark.parametrize(
    "override",
    [
        dict(tangent_block_symmetric=True),
        dict(newton_tangent_reuse=True),
        dict(mg_fine_tangent=True),
        dict(use_sumfact=True),
        dict(tangent_backend="jvp"),
        dict(element_backend="gather"),
        dict(n_devices=2),
        dict(mg_level_backend="stencil_vmem"),
        dict(type_lin="Direct", dim=3, poly_degree=5),
    ],
    ids=lambda d: next(iter(d)),
)
def test_unported_variants_raise(override):
    kw = dict(model="neo-Hookean", type_lin="CG", scenario="PF", dim=2,
              poly_degree=2, preconditioner="MG", solve_dtype="float32")
    kw.update(override)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NonlinearElasticity(AllParameters(**kw))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build" / _build.LIB_NAME).exists()


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: chip_smoke.py would run for real")
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "torch.cuda.is_available() is False" in r.stderr
    # alone, without the package beside it, it fails too
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Run on the card: `python -m pytest -m cuda tests/test_torch_package.py`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    KT, u2, lattice, E1, E2, u = _small_inputs()
    dev = torch.device("cuda")
    KT, u2 = KT.to(dev), u2.to(dev)
    before = at.apply_packed_tangents_T.launches
    torch.testing.assert_close(
        at.apply_packed_tangents_T(KT, u2), at.apply_packed_tangents_T_plain(KT, u2),
        rtol=1e-5, atol=1e-4,
    )
    assert at.apply_packed_tangents_T.launches == before + 1
    for cls, E in ((Q1StructuredOperator, E1), (Q2StructuredOperator, E2)):
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            op = cls(E, lattice, dtype, dev)
            x = u.to(dev, dtype)
            out, ref = op(x).double(), op.plain(x).double()
            assert ((out - ref).norm() / ref.norm()).item() <= tol
