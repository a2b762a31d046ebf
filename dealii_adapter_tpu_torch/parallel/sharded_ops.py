"""Cell-partitioned element-kernel reductions over the ranks.

Counterpart of `dealii_adapter_tpu/parallel/sharded_ops.py` (its
`shard_map` mode, `element_backend="gather"` with `n_devices > 1`). Every
rank applies a per-cell kernel to its own `(cpd, npc)` cell block, reduces
the cell values into its contiguous node window through its windowed
transpose-gather plan (a gather and a fixed-order sum, no scatter), places
the window at its offset in a zero `(n_nodes_pad, dim)` buffer, and one
SUM all-reduce gives every rank the whole nodal vector. Vectors stay
replicated on every rank (the JAX package's `P()`).

The all-reduce carries forward- and reverse-mode tangents
(`RankGroup.all_reduce`), so the forward-mode derivative of a sharded
residual is the sharded tangent action (the Neo-Hookean model's jvp
tangent), as `jax.linearize` of the JAX package's `psum` is.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .partition import CellPartition, RankGroup


def sharded_cellwise_reduction(part: CellPartition, mesh: RankGroup,
                               local_kernel: Callable, *, has_min: bool = False):
    """`apply(u) -> (n_nodes, dim)` nodal sums (and, with `has_min`, the
    MIN over the ranks of the kernel's scalar monitor). `local_kernel(u,
    cells)` runs on this rank's `(cpd, npc)` cell block and returns the
    flattened per-cell values `(cpd * npc, dim)` (and the scalar). Padded
    cells' values are never gathered by the plan."""
    dev = mesh.device
    r = mesh.rank
    cells = torch.as_tensor(part.cells[r], dtype=torch.long, device=dev)
    plan = torch.as_tensor(part.plans[r], dtype=torch.long, device=dev)
    off = int(part.offsets[r])
    n_nodes, n_pad, wlen = part.n_nodes, part.n_nodes_pad, part.wlen

    def apply(u):
        out = local_kernel(u, cells)
        rflat, mn = out if has_min else (out, None)
        dim = rflat.shape[-1]
        flat = torch.cat([rflat, rflat.new_zeros((1, dim))])
        rloc = flat[plan].sum(dim=1)  # (wlen, dim) window sums
        buf = torch.cat([rflat.new_zeros((off, dim)), rloc,
                         rflat.new_zeros((n_pad - off - wlen, dim))])
        buf = mesh.all_reduce(buf)[:n_nodes]
        if has_min:
            # a monitor (det F > 0), never differentiated
            return buf, mesh.all_reduce(mn.detach(), "min")
        return buf

    return apply


class ShardedOperator:
    """The cell-partitioned action of a constant element matrix: the
    counterpart of `ops/element_ops.py:AssembledOperator` with its call
    interface, so solvers and models do not see the partition."""

    def __init__(self, part: CellPartition, mesh: RankGroup, E: torch.Tensor,
                 dim: int):
        self.part, self.mesh, self.E, self.dim = part, mesh, E, dim

        def matvec_kernel(u, cells):
            cpd, npc = cells.shape
            ucell = u[cells].reshape(cpd, npc * dim)
            return (ucell @ E).reshape(cpd * npc, dim)

        def diag_kernel(u, cells):
            cpd, npc = cells.shape
            d = torch.diagonal(E).reshape(npc, dim).to(u.dtype)
            return d.expand(cpd, npc, dim).reshape(cpd * npc, dim)

        self._matvec = sharded_cellwise_reduction(part, mesh, matvec_kernel)
        self._diag = sharded_cellwise_reduction(part, mesh, diag_kernel)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        return self._matvec(u)

    def diagonal(self) -> torch.Tensor:
        u = torch.ones((self.part.n_nodes, self.dim), dtype=self.E.dtype,
                       device=self.E.device)
        return self._diag(u)


def make_sharded_operator(space, E: np.ndarray, mesh: RankGroup,
                          dtype=torch.float64, part: CellPartition = None,
                          device=None) -> ShardedOperator:
    """The cell-partitioned operator of element matrix `E` on `space`,
    over `part` (default: `space`'s cells split over the ranks) on
    `device` (default: the rank's)."""
    if part is None:
        part = CellPartition.create(space.cells, space.n_nodes, mesh.world)
    return ShardedOperator(
        part=part, mesh=mesh,
        E=torch.as_tensor(np.asarray(E), dtype=dtype,
                          device=mesh.device if device is None else device),
        dim=space.dim)
