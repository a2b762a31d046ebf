"""Assembled 27-point (3D) / 9-point (2D) stencil form of the Q1 structured
operator (kernel K6), the multigrid level operator of the `stencil*`
level backends.

Counterpart of `dealii_adapter_tpu/ops/stencil.py`. On a uniform lattice
the ASSEMBLED Q1 operator is translation-invariant in the interior:
out[n] = sum_{delta in {-1,0,1}^d} S3[delta] @ u[n + delta], where
S3[delta] sums the element-matrix slot pairs (i, j) with
off_j - off_i = delta (243 FMA per node in 3D). At the boundary the
zero-padded interior stencil overcounts exactly the couplings of ghost
cells, which inclusion-exclusion removes:

    out = S3conv(u) - sum_faces S2conv(face plane of u)
                    + sum_edges S1conv(edge line of u)
                    - sum_corners C @ u[corner]          (3D)
    out = S3conv(u) - sum_faces S2conv(face line of u)
                    + sum_corners C @ u[corner]          (2D)

with the face/edge/corner tables the element matrix restricted to slot
pairs on the shared face/edge/corner (`q1_stencil_tables`, a copy of the
JAX package's host function).

* On a CPU tensor `StencilQ1Operator` runs the plain version: the shifted
  slices of a zero-padded tensor and the corrections above, in f32 for
  bf16/f32 I/O and in f64 for f64, rounded once to the I/O dtype.
* On a CUDA tensor it launches K6 (csrc/q1_stencil.cu) for bf16/f32 I/O
  and raises for any other dtype. K6 applies the whole operator in one
  launch: the host folds the corrections into one stencil table per node
  class (low face, interior or high face along each axis: 27 classes in
  3D, 9 in 2D; `class_tables`), and each thread applies its node's table
  to its in-lattice neighbours.

`strategy` is accepted as the JAX package takes it (`shift`, `conv`,
`banded`, `flat`, `flatx`, `vmem`). Those are TPU layouts of one
contraction (XLA fusions, an MXU convolution or banded matmuls, lane
flattenings, the whole-field-in-VMEM Pallas pass); the port has one
formulation, and on the card every strategy launches K6, in 2D as in 3D
(where the JAX package forces the plain XLA `shift` pass).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..fem.dofspace import DofSpace
from .structured import _grid_shape

STRATEGIES = ("shift", "conv", "banded", "flat", "flatx", "vmem")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _slots(ndim: int):
    """Q1 local-node offsets in tabulation order (x fastest), as tuples in
    GRID axis order (slowest first): 3D -> (z, y, x)."""
    if ndim == 2:
        return [(b, a) for b in (0, 1) for a in (0, 1)]
    return [(c, b, a) for c in (0, 1) for b in (0, 1) for a in (0, 1)]


def q1_stencil_tables(E: np.ndarray, ndim: int, dim: int):
    """Build the interior + boundary-correction stencil tables from the
    node-major (npc*dim, npc*dim) Q1 element matrix.

    Returns (S3, faces, edges, corners):
      S3: (3,)*ndim + (dim, dim) interior stencil, index [delta+1]
      faces: {(axis, side): (3,)*(ndim-1) + (dim, dim)} per boundary face
      edges: {(axes, sides): (3,)*(ndim-2) + (dim, dim)} (3D only; in 2D
             these are the corner table)
      corners: {corner_sides: (dim, dim)}
    side/sides entries are 0 (low boundary) or 1 (high boundary). A ghost
    cell BELOW the domain shares its TOP nodes (slot offset 1) with the
    real lattice, so side 0 restricts slots to offset 1 and vice versa.
    """
    offs = _slots(ndim)
    npc = len(offs)
    E4 = np.asarray(E, dtype=np.float64).reshape(npc, dim, npc, dim)

    S3 = np.zeros((3,) * ndim + (dim, dim))
    for i, oi in enumerate(offs):
        for j, oj in enumerate(offs):
            d = tuple(oj[k] - oi[k] + 1 for k in range(ndim))
            S3[d] += E4[i, :, j, :]

    def restricted(fixed):
        """Stencil over the free axes from slot pairs pinned on `fixed`
        axes: {axis: side} with side 0 => slot offset 1 (ghost below)."""
        free = [k for k in range(ndim) if k not in fixed]
        T = np.zeros((3,) * len(free) + (dim, dim))
        for i, oi in enumerate(offs):
            if any(oi[k] != (1 - s) for k, s in fixed.items()):
                continue
            for j, oj in enumerate(offs):
                if any(oj[k] != (1 - s) for k, s in fixed.items()):
                    continue
                d = tuple(oj[k] - oi[k] + 1 for k in free)
                T[d] += E4[i, :, j, :]
        return T

    faces = {}
    for ax in range(ndim):
        for side in (0, 1):
            faces[(ax, side)] = restricted({ax: side})

    edges = {}
    corners = {}
    if ndim == 3:
        for ax1 in range(ndim):
            for ax2 in range(ax1 + 1, ndim):
                for s1 in (0, 1):
                    for s2 in (0, 1):
                        edges[((ax1, ax2), (s1, s2))] = restricted(
                            {ax1: s1, ax2: s2}
                        )
        for s0 in (0, 1):
            for s1 in (0, 1):
                for s2 in (0, 1):
                    corners[(s0, s1, s2)] = restricted(
                        {0: s0, 1: s1, 2: s2}
                    )
    else:
        for s0 in (0, 1):
            for s1 in (0, 1):
                corners[(s0, s1)] = restricted({0: s0, 1: s1})
    return S3, faces, edges, corners


def class_tables(tables, ndim: int) -> np.ndarray:
    """K6's tables: (3^ndim classes, 3^ndim offsets, dim, dim), f64.

    A node's class has one digit per lattice axis (slowest first): 0 on
    the low face, 1 inside, 2 on the high face; its table is S3 minus the
    restricted tables of the faces it lies on, plus those of its edges,
    minus (3D) or plus (2D) its corner's, each placed at the offsets that
    stay inside that face, edge or corner: the inclusion-exclusion of the
    plain version folded per node class, on the host in f64. Offsets are
    lexicographic in (dz, dy, dx) + 1, as S3 is indexed."""
    S3, faces, edges, corners = tables
    dim = S3.shape[-1]
    out = np.zeros((3,) * ndim + (3,) * ndim + (dim, dim))
    center = 1
    for cls in np.ndindex(*(3,) * ndim):
        T = out[cls]
        T[...] = S3
        bnd = {ax: (0 if c == 0 else 1) for ax, c in enumerate(cls) if c != 1}
        for ax, side in bnd.items():
            idx = [slice(None)] * ndim
            idx[ax] = center
            T[tuple(idx)] -= faces[(ax, side)]
        for ((ax1, ax2), (s1, s2)), S1 in edges.items():  # 3D only
            if bnd.get(ax1) == s1 and bnd.get(ax2) == s2:
                idx = [slice(None)] * ndim
                idx[ax1] = idx[ax2] = center
                T[tuple(idx)] += S1
        sign = -1.0 if ndim == 3 else 1.0
        for sides, C in corners.items():
            if all(bnd.get(ax) == s for ax, s in enumerate(sides)):
                T[(center,) * ndim] += sign * C
    return out.reshape(3**ndim, 3**ndim, dim, dim)


def _conv_nd(g: torch.Tensor, S: np.ndarray, cdt) -> torch.Tensor:
    """Zero-padded stencil convolution: g is (*lattice, dim), S is
    (3,)*nd + (dim, dim); out[..., d] = sum_delta,e S[delta, d, e] *
    g[.. + delta, e], as shifted slices of the padded field in `cdt`."""
    nd = g.dim() - 1
    dim = g.shape[-1]
    shape = tuple(g.shape[:-1])
    gp = g.new_zeros(tuple(n + 2 for n in shape) + (dim,), dtype=cdt)
    gp[(slice(1, -1),) * nd] = g
    comps = [None] * dim
    for delta in np.ndindex(*(3,) * nd):
        W = S[delta]
        if not np.any(W):
            continue
        win = gp[tuple(slice(d, d + n) for d, n in zip(delta, shape))]
        for d in range(dim):
            acc = None
            for e in range(dim):
                w = float(W[d, e])
                if w == 0.0:
                    continue
                t = w * win[..., e]
                acc = t if acc is None else acc + t
            if acc is not None:
                comps[d] = acc if comps[d] is None else comps[d] + acc
    zero = g.new_zeros(shape, dtype=cdt)
    return torch.stack([c if c is not None else zero for c in comps], dim=-1)


def _sel(side: int, n: int) -> int:
    return 0 if side == 0 else n - 1


class StencilQ1Operator:
    """y = A u for a constant Q1 element matrix over a 2D or 3D node
    lattice, in the assembled-stencil form (K6 on the card, the plain
    inclusion-exclusion on the CPU); `diagonal()` is the assembled
    diagonal. One launch count for both dimensions."""

    p = 1
    launches = 0

    def __init__(self, E: np.ndarray, grid_shape, dtype=torch.float64,
                 strategy: str = "shift", device=None):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown stencil strategy {strategy!r}")
        self.grid_shape: Tuple[int, ...] = tuple(int(n) for n in grid_shape)
        self.ndim = self.dim = len(self.grid_shape)
        if self.ndim not in (2, 3):
            raise ValueError(f"2D or 3D lattice, got {self.grid_shape}")
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cdt = torch.float64 if dtype == torch.float64 else torch.float32
        self.tables = q1_stencil_tables(E, self.ndim, self.dim)
        self.class_tables = class_tables(self.tables, self.ndim)
        self._tables_dev = torch.as_tensor(
            self.class_tables, dtype=torch.float32, device=self.device
        ).contiguous()

    def plain(self, u: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch version (see the module docstring)."""
        S3, faces, edges, corners = self.tables
        nd, dim, shape, cdt = self.ndim, self.dim, self.grid_shape, self.cdt
        g = u.reshape(shape + (dim,))
        out = _conv_nd(g, S3, cdt)
        for (ax, side), S2 in faces.items():
            idx = [slice(None)] * nd
            idx[ax] = _sel(side, shape[ax])
            idx = tuple(idx)
            out[idx] -= _conv_nd(g[idx], S2, cdt)
        for ((ax1, ax2), (s1, s2)), S1 in edges.items():
            idx = [slice(None)] * nd
            idx[ax1] = _sel(s1, shape[ax1])
            idx[ax2] = _sel(s2, shape[ax2])
            idx = tuple(idx)
            out[idx] += _conv_nd(g[idx], S1, cdt)
        sign = -1.0 if nd == 3 else 1.0
        for sides, C in corners.items():
            idx = tuple(_sel(s, n) for s, n in zip(sides, shape))
            corr = torch.as_tensor(C, dtype=cdt, device=u.device) @ g[idx].to(cdt)
            out[idx] += sign * corr
        return out.reshape(-1, dim).to(u.dtype)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        if u.device.type == "cpu":
            return self.plain(u)
        if not u.is_cuda:
            raise ValueError(f"StencilQ1Operator: unsupported device {u.device}")
        if u.dtype not in _KERNEL_DTYPES:
            raise TypeError(
                f"StencilQ1Operator kernel (K6) takes float32 or bfloat16 "
                f"I/O, got {u.dtype}"
            )
        n_nodes = int(np.prod(self.grid_shape))
        if tuple(u.shape) != (n_nodes, self.dim) or not u.is_contiguous():
            raise ValueError(
                f"StencilQ1Operator: u must be a contiguous ({n_nodes}, "
                f"{self.dim}) tensor, got {tuple(u.shape)}"
            )
        if self._tables_dev.device != u.device:
            raise ValueError(
                f"StencilQ1Operator: operator on {self._tables_dev.device}, "
                f"u on {u.device}"
            )
        from ..kernels._build import check, load_library, stream_of

        nz = self.grid_shape[0] if self.ndim == 3 else 1
        ny, nx = self.grid_shape[-2:]
        y = torch.empty_like(u)
        err = load_library().dat_q1_stencil(
            u.data_ptr(), y.data_ptr(), self._tables_dev.data_ptr(), nz, ny,
            nx, self.ndim, int(u.dtype == torch.bfloat16), stream_of(u),
        )
        check(err, "dat_q1_stencil")
        StencilQ1Operator.launches += 1
        return y

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal by the same inclusion-exclusion, on host."""
        S3, faces, edges, corners = self.tables
        nd, dim, shape = self.ndim, self.dim, self.grid_shape
        out = np.broadcast_to(np.diag(S3[(1,) * nd]), shape + (dim,)).copy()
        for (ax, side), S2 in faces.items():
            idx = [slice(None)] * nd
            idx[ax] = _sel(side, shape[ax])
            out[tuple(idx)] -= np.diag(S2[(1,) * (nd - 1)])
        for ((ax1, ax2), (s1, s2)), S1 in edges.items():
            idx = [slice(None)] * nd
            idx[ax1] = _sel(s1, shape[ax1])
            idx[ax2] = _sel(s2, shape[ax2])
            out[tuple(idx)] += np.diag(S1[(1,)])
        sign = -1.0 if nd == 3 else 1.0
        for sides, C in corners.items():
            idx = tuple(_sel(s, n) for s, n in zip(sides, shape))
            out[idx] += sign * np.diag(C)
        return torch.as_tensor(
            out.reshape(-1, dim), dtype=self.dtype, device=self.device
        )


def make_q1_stencil_operator(
    space: DofSpace, E: np.ndarray, dtype=torch.float64,
    strategy: str = "shift", device=None,
) -> StencilQ1Operator:
    """The assembled-stencil Q1 operator of a degree-1 space."""
    if space.mesh.degree != 1:
        raise ValueError("StencilQ1Operator requires degree-1 meshes")
    return StencilQ1Operator(E, _grid_shape(space), dtype, strategy, device)


__all__ = [
    "STRATEGIES",
    "StencilQ1Operator",
    "class_tables",
    "make_q1_stencil_operator",
    "q1_stencil_tables",
]
