"""Dense Cholesky solver for small SPD systems.

Counterpart of `dealii_adapter_tpu/solvers/direct.py`: one factorization
at setup (`torch.linalg.cholesky`), reused for every solve
(`torch.cholesky_solve`). For n_dofs up to a few tens of thousands.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


class DenseCholesky:
    def __init__(self, A: np.ndarray, dtype=torch.float64, device=None):
        self.n = A.shape[0]
        self._chol = torch.linalg.cholesky(
            torch.as_tensor(A, dtype=dtype, device=resolve_device(device))
        )

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        x = torch.cholesky_solve(
            b.reshape(self.n, 1).to(self._chol.dtype), self._chol
        )
        return x.reshape(b.shape).to(b.dtype)
