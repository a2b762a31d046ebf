"""dealii_adapter_tpu_torch — the PyTorch/CUDA port of dealii_adapter_tpu.

The JAX package `dealii_adapter_tpu` stays the reference; this package
re-implements its single-device structured path in PyTorch for one
NVIDIA H100, in 2D and 3D:

* `NonlinearElasticity`: the compressible Neo-Hookean flap with
  Newmark-beta dynamics, Newton with the mixed f64/f32 residual schedule
  and Eisenstat-Walker forcing, an f32 CG on the per-cell assembled
  tangent, and a bf16 geometric-multigrid V-cycle as its preconditioner;
* `LinearElastodynamics`: the linear theta-scheme velocity solve, f32 CG
  inside f64 defect correction to the reference's absolute 1e-10;
* the coupled time loop around either model (`runner.coupled_run`, the
  `adapter` package with its participants) and the CLI with VTU output
  (`python -m dealii_adapter_tpu_torch case.prm`).

Models and operators run on the CUDA card unless the caller passes
`device="cpu"` (`device.py`); without a card and without that argument
they raise.

Hand-written CUDA kernels (`csrc/`, built for sm_90a at first use by
`kernels/_build.py`, which launches the two health-check kernels C1/C2
right after loading the library) carry that path: the assembled-tangent
matvecs K1, K1b, K1c (full storage) and K2, K2b (block-symmetric
storage) (`ops/assembled_tangent.py`), the Q1 structured level operators
K3 (3D) and K4b (2D) and the plane-marching 3D Q1 operator K4
(`ops/q1_structured.py`), the assembled Q1 stencil K6 of the `stencil*`
multigrid level backends (`ops/stencil.py`) and the 3D Q2 fine-level
operator K5 (`ops/q2_structured.py`). Each wrapper launches its kernel for
a CUDA tensor and runs the plain PyTorch version beside it for a CPU
tensor; there is no other fallback. The Neo-Hookean model picks its
tangent kernel from `tangent_block_symmetric` and `tangent_matvec_kernel`
(`models/nonlinear_elasticity.py:tangent_kernel_id`); `use_pallas` is
ignored. `kernels/counters.py` names every wrapper's launch count.

Precision policy, set once here: float32 matrix products run in full
float32 on the card, never TF32, and bf16/fp16 products reduce in f32 —

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

The tangent assembly needs true f32 products: a single-bf16-pass assembly
diverges Newton on the production solve, and TF32 keeps no more mantissa
than that class of error allows. The bf16 multigrid transfers are matrix
products; with reduced-precision reductions cuBLAS may sum their split-K
parts in bf16, where PyTorch on the CPU and XLA sum in f32. The state,
residual and norms stay f64.

This package never imports jax; only its tests import both packages.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False

from .config import AllParameters, parse_prm  # noqa: E402,F401
from .models.linear_elasticity import LinearElastodynamics  # noqa: E402,F401
from .models.nonlinear_elasticity import NonlinearElasticity  # noqa: E402,F401
from .time_handler import Time  # noqa: E402,F401

__version__ = "0.1.0"
