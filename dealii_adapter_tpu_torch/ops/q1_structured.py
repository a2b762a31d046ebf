"""Q1 structured element operators (kernels K3, K4 and K4b), the multigrid
level operators.

Counterpart of `dealii_adapter_tpu/ops/pallas_structured.py`
(`PallasQ1SlabOperator` in 3D, `PallasQ1Operator` in 2D and, through
`make_q1_plane_operator`, in 3D). `make_q1_operator(space, E)(u)` computes
y = A u for a constant element matrix (24 x 24 in 3D, 8 x 8 in 2D) over a
Q1 node lattice:

* on a CUDA tensor it launches csrc/q1_structured.cu (bf16 or f32 I/O, or
  bf16 in and f32 out, f32 accumulation; or, for an operator built in
  f64, f64 I/O and accumulation, the kernels' f64 instantiation with f64
  tables: an f64 multigrid hierarchy; the level's coefficients are a
  runtime argument, so one kernel serves every level): K3 in 3D and K4b
  in 2D, the folded 27- and
  9-point stencils with the per-node-class tables K6 reads
  (`ops/stencil.py:class_tables`, laid out by `kernel_table`); K4, the 3D
  operator of `make_q1_plane_operator`, computes K3's function and
  launches K3's kernel with the same tables under its own entry point
  (its first, plane-marching design stays as `dat_q1_plane_marching` for
  `chip_smoke.py`'s timing);
* on a CPU tensor it runs the plain version, `ops/structured.py`'s
  `StructuredOperator`, computing in f32 (f64 for f64 I/O) and rounding
  the output to the I/O dtype.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..fem.dofspace import DofSpace
from ..kernels import _build
from ..kernels.counters import Launches
from .stencil import (
    check_kernel_dtype,
    class_tables,
    kernel_table,
    q1_stencil_tables,
)
from .structured import _grid_shape, structured_operator_from_lattice


class StructuredKernelOperator:
    """y = A u over a `dim`-dimensional lattice of degree-`p` cells, through
    a hand-written kernel on the card and `StructuredOperator` on the CPU.
    Subclasses name the kernel entry point, whose arguments are (u, y,
    *coefficient pointers, *lattice, io mode, stream), say what it reads
    (`_coefficients`) and keep its launch count. Everything but u, y and
    the stream is bound once, in `__init__`; a call checks u, allocates y,
    launches on PyTorch's current stream and never synchronises, so that
    whole V-cycles can be captured in a CUDA graph. `out_dtype` float32
    with a bf16 u returns the kernel's f32 accumulation unrounded (the
    lattice partition adds its slabs' partial sums in f32). The Q1
    operators built in f64 take f64 u (their tables are f64), the others
    f32 or bf16 (`check_kernel_dtype`); `f64_kernel` False (K5) refuses
    f64 on the card."""

    p: int
    dim: int
    entry: str  # C entry point in the kernel library
    f64_kernel = True  # the kernel has an f64 instantiation (io mode 3)
    launches: int = 0

    def __init__(self, E: np.ndarray, grid_shape, dtype=torch.float32,
                 device=None):
        E = np.asarray(E, dtype=np.float64)
        self.E_host = E
        self.grid_shape: Tuple[int, ...] = tuple(int(n) for n in grid_shape)
        if len(self.grid_shape) != self.dim:
            raise ValueError(
                f"{type(self).__name__} takes a {self.dim}D lattice, got "
                f"{self.grid_shape}"
            )
        self.dtype = dtype
        self.device = resolve_device(device)
        cdt = torch.float64 if dtype == torch.float64 else torch.float32
        self._plain = structured_operator_from_lattice(
            E, self.grid_shape, self.p, cdt, self.device
        )
        # row = output dof, node-major, as the kernels read it
        self.E_dev = torch.as_tensor(E, dtype=torch.float32, device=self.device)
        self._coef = self._coefficients(E)
        self._args = tuple(c.data_ptr() for c in self._coef) + self.grid_shape
        self._u_shape = (math.prod(self.grid_shape), self.dim)
        self._lib = self._fn = None

    def _coefficients(self, E: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """The device arrays the kernel reads, in argument order."""
        return (self.E_dev,)

    def plain(self, u: torch.Tensor, out_dtype=None) -> torch.Tensor:
        """The plain PyTorch version: f32 (f64) compute, output rounded to
        `out_dtype` (default: the input dtype)."""
        out_dtype = u.dtype if out_dtype is None else out_dtype
        return self._plain(u.to(self._plain.EpT.dtype)).to(out_dtype)

    def __call__(self, u: torch.Tensor, out_dtype=None) -> torch.Tensor:
        if u.device.type == "cpu":
            return self.plain(u, out_dtype)
        if not u.is_cuda:
            raise ValueError(f"{type(self).__name__}: unsupported device {u.device}")
        if u.dtype == torch.float64 and not self.f64_kernel:
            raise TypeError(
                f"{type(self).__name__} kernel takes float32 or bfloat16 I/O, "
                f"got {u.dtype}"
            )
        check_kernel_dtype(type(self).__name__, self.dtype, u.dtype)
        if u.shape != self._u_shape or not u.is_contiguous():
            raise ValueError(
                f"{type(self).__name__}: u must be a contiguous "
                f"{self._u_shape} tensor, got {tuple(u.shape)}"
            )
        if u.device != self.E_dev.device:
            raise ValueError(
                f"{type(self).__name__}: operator on {self.E_dev.device}, "
                f"u on {u.device}"
            )
        out_dtype = u.dtype if out_dtype is None else out_dtype
        io = _build.io_mode(u.dtype, out_dtype)
        lib = _build.load_library()
        if lib is not self._lib:  # (re)bound library: look the entry up once
            self._lib, self._fn = lib, getattr(lib, self.entry)
        y = torch.empty_like(u, dtype=out_dtype)
        err = self._fn(
            u.data_ptr(), y.data_ptr(), *self._args, io,
            torch.cuda.current_stream(u.device).cuda_stream,
        )
        _build.check(err, self.entry)
        (type(self).f64 if io == 3 else type(self)).launches += 1
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
    """K3: the 3D Q1 level operator (csrc/q1_structured.cu), the folded
    27-point stencil with per-node-class coefficients."""

    p = 1
    dim = 3
    entry = "dat_q1_structured"
    launches = 0
    f64 = Launches()  # its f64 launches, not in `launches`

    def _coefficients(self, E):
        return _folded_table(E, 3, self.dtype, self.device)


class Q1StructuredOperator2D(StructuredKernelOperator):
    """K4b: the 2D Q1 level operator (csrc/q1_structured.cu), the folded
    9-point stencil with per-node-class coefficients."""

    p = 1
    dim = 2
    entry = "dat_q1_structured_2d"
    launches = 0
    f64 = Launches()  # its f64 launches, not in `launches`

    def _coefficients(self, E):
        return _folded_table(E, 2, self.dtype, self.device)


def _folded_table(E: np.ndarray, dim: int, dtype,
                  device) -> Tuple[torch.Tensor]:
    """K6's per-node-class tables of the element matrix E in the kernels'
    layout (`kernel_table`), f64 for an f64 operator and f32 otherwise:
    the argument tuple of K3 and K4b."""
    table = kernel_table(class_tables(q1_stencil_tables(E, dim, dim), dim),
                         dtype)
    return (torch.as_tensor(table, device=device),)


class Q1PlaneOperator(StructuredKernelOperator):
    """K4: the 3D Q1 operator of `make_q1_plane_operator`, the same function
    as K3, so `dat_q1_plane` launches K3's kernel with K3's tables
    (csrc/q1_structured.cu); its own entry point and launch count."""

    p = 1
    dim = 3
    entry = "dat_q1_plane"
    launches = 0
    f64 = Launches()  # its f64 launches, not in `launches`

    def _coefficients(self, E):
        return _folded_table(E, 3, self.dtype, self.device)


def q1_lattice_operator(
    E: np.ndarray, grid_shape, dtype=torch.float32, device=None
) -> StructuredKernelOperator:
    """The Q1 level operator of a 2D (K4b) or 3D (K3) Q1 node lattice
    (a whole level, or one rank's slab of it)."""
    cls = Q1StructuredOperator2D if len(grid_shape) == 2 else Q1StructuredOperator
    return cls(E, grid_shape, dtype, device)


def make_q1_operator(
    space: DofSpace, E: np.ndarray, dtype=torch.float32, device=None
) -> StructuredKernelOperator:
    """The Q1 level operator of a 2D (K4b) or 3D (K3) Q1 space."""
    if space.mesh.degree != 1:
        raise ValueError(f"Q1 operator on a degree-{space.mesh.degree} space")
    return q1_lattice_operator(E, _grid_shape(space), dtype, device)


def make_q1_plane_operator(
    space: DofSpace, E: np.ndarray, dtype=torch.float32, device=None
) -> StructuredKernelOperator:
    """The plane-at-a-time Q1 operator of a 3D (K4) or 2D (K4b) Q1 space:
    the counterpart of the JAX package's `make_pallas_q1_operator`. No
    model path selects it; the level operators are `make_q1_operator`'s."""
    if space.mesh.degree != 1:
        raise ValueError(f"Q1 operator on a degree-{space.mesh.degree} space")
    cls = Q1StructuredOperator2D if space.dim == 2 else Q1PlaneOperator
    return cls(E, _grid_shape(space), dtype, device)
