"""Q1 structured element operator (kernel K3), the multigrid level operator.

Counterpart of `dealii_adapter_tpu/ops/pallas_structured.py`
(`PallasQ1SlabOperator`). `Q1StructuredOperator(u)` computes y = A u for a
constant 24 x 24 element matrix over a 3D Q1 node lattice:

* on a CUDA tensor it launches csrc/q1_structured.cu (bf16 or f32 I/O,
  f32 accumulation; E is a runtime argument, so one kernel serves every
  level);
* on a CPU tensor it runs the plain version, `ops/structured.py`'s
  `StructuredOperator`, computing in f32 (f64 for f64 I/O) and rounding
  the output to the I/O dtype.

2D lattices run the plain version on the CPU; on the card they raise until
the 2D kernel (K4b) is ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..fem.dofspace import DofSpace
from .structured import _grid_shape, structured_operator_from_lattice

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class StructuredKernelOperator:
    """y = A u over a lattice of degree-`p` cells, through a hand-written
    gather kernel on the card and `StructuredOperator` on the CPU.
    Subclasses name the kernel entry point and keep its launch count."""

    p: int
    entry: str  # C entry point in the kernel library
    launches: int = 0

    def __init__(self, E: np.ndarray, grid_shape, dtype=torch.float32,
                 device="cpu"):
        E = np.asarray(E, dtype=np.float64)
        self.E_host = E
        self.grid_shape: Tuple[int, ...] = tuple(int(n) for n in grid_shape)
        self.dim = len(self.grid_shape)
        self.dtype = dtype
        self.device = torch.device(device)
        cdt = torch.float64 if dtype == torch.float64 else torch.float32
        self._plain = structured_operator_from_lattice(
            E, self.grid_shape, self.p, cdt, self.device
        )
        # row = output dof, node-major, as the kernel reads it
        self.E_dev = torch.as_tensor(E, dtype=torch.float32, device=self.device)

    def plain(self, u: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version: f32 (f64) compute, output rounded to
        the input dtype."""
        return self._plain(u.to(self._plain.EpT.dtype)).to(u.dtype)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        if u.device.type == "cpu":
            return self.plain(u)
        if not u.is_cuda:
            raise ValueError(f"{type(self).__name__}: unsupported device {u.device}")
        if self.dim != 3:
            raise NotImplementedError(
                f"{type(self).__name__}: 2D lattices have no CUDA kernel yet "
                "(ROADMAP Queue 2, K4b)"
            )
        if u.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"{type(self).__name__} kernel takes float32 or bfloat16 I/O, "
                f"got {u.dtype}"
            )
        n_nodes = int(np.prod(self.grid_shape))
        if tuple(u.shape) != (n_nodes, 3) or not u.is_contiguous():
            raise ValueError(
                f"{type(self).__name__}: u must be a contiguous ({n_nodes}, 3) "
                f"tensor, got {tuple(u.shape)}"
            )
        if self.E_dev.device != u.device:
            raise ValueError(
                f"{type(self).__name__}: operator on {self.E_dev.device}, "
                f"u on {u.device}"
            )
        from ..kernels._build import check, load_library, stream_of

        y = torch.empty_like(u)
        nz, ny, nx = self.grid_shape
        err = getattr(load_library(), self.entry)(
            u.data_ptr(), y.data_ptr(), self.E_dev.data_ptr(), nz, ny, nx,
            int(u.dtype == torch.bfloat16), stream_of(u),
        )
        check(err, self.entry)
        type(self).launches += 1
        return y

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal (host-computed once) in the operator dtype."""
        dim, p = self.dim, self.p
        d = np.diag(self.E_host).reshape(-1, dim)
        reps_rev = tuple((n - 1) // p for n in self.grid_shape)
        out = np.zeros(self.grid_shape + (dim,))
        for si, off in enumerate(np.ndindex(*(p + 1,) * dim)):
            sl = tuple(
                slice(o, o + (r - 1) * p + 1, p) for o, r in zip(off, reps_rev)
            )
            out[sl] += d[si]
        return torch.as_tensor(
            out.reshape(-1, dim), dtype=self.dtype, device=self.device
        )


class Q1StructuredOperator(StructuredKernelOperator):
    """K3: the Q1 level operator (csrc/q1_structured.cu)."""

    p = 1
    entry = "dat_q1_structured"
    launches = 0


def make_q1_operator(
    space: DofSpace, E: np.ndarray, dtype=torch.float32, device="cpu"
) -> Q1StructuredOperator:
    if space.mesh.degree != 1:
        raise ValueError(f"Q1 operator on a degree-{space.mesh.degree} space")
    return Q1StructuredOperator(E, _grid_shape(space), dtype, device)
