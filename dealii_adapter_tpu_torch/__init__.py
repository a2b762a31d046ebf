"""dealii_adapter_tpu_torch — the PyTorch/CUDA port of dealii_adapter_tpu.

The JAX package `dealii_adapter_tpu` stays the reference; this package
re-implements its single-device structured production path in PyTorch
for one NVIDIA H100: the 3D (and 2D) compressible Neo-Hookean flap with
Newmark-beta dynamics, Newton with the mixed f64/f32 residual schedule
and Eisenstat-Walker forcing, an f32 CG on the per-cell assembled tangent,
and a bf16 geometric-multigrid V-cycle as its preconditioner.

Three hand-written CUDA kernels (`csrc/`, built for sm_90a at first use
by `kernels/_build.py`) carry that path: the assembled-tangent matvec
(`ops/assembled_tangent.py`), the Q1 structured level operator
(`ops/q1_structured.py`) and the Q2 fine-level operator
(`ops/q2_structured.py`). Each wrapper launches its kernel for a CUDA
tensor and runs the plain PyTorch version beside it for a CPU tensor;
there is no other fallback. Kernel-selection knobs of the JAX config
(`use_pallas`, `tangent_matvec_kernel`) are ignored.

Precision policy, set once here: float32 matrix products run in full
float32 on the card, never TF32 —

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

The tangent assembly needs true f32 products: a single-bf16-pass assembly
diverges Newton on the production solve, and TF32 keeps no more mantissa
than that class of error allows. The state, residual and norms stay f64.

This package never imports jax; only its tests import both packages.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .config import AllParameters, parse_prm  # noqa: E402,F401

__version__ = "0.1.0"
