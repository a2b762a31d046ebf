"""The lattice partition: the structured operators on per-rank slabs.

The JAX package's production multi-device path shards the nodal lattice
with GSPMD (`P(axis, None)` on the lexicographic rows) and lets XLA insert
the halo exchanges. Here the decomposition is explicit. A node lattice
(slowest axis first, as `ops/structured.py` lays it out) is split along
one lattice axis, the split axis, into slabs of whole cell planes:

* rank r owns the cells between cell planes c_r and c_{r+1} and the node
  planes [c_r p, c_{r+1} p) (the last rank also the closing plane); a
  vector is distributed by rows, each rank holding its owned planes as
  one contiguous block;
* an operator reads its slab, the owned planes plus the first plane of
  the rank above (`fill`, the halo fill), runs the single-device code or
  kernel on the slab, which it sees as a box of its own, and the slab's
  top plane, a partial sum, is added into the first plane of the rank
  above (`interface_sum`);
* inner products are a local sum plus one all-reduce
  (`RankGroup.dot`).

The split axis follows one rule (`split_axis`): the slowest lattice axis
with at least as many cells as ranks. On the 3D flap (lattice (19, 325,
55) at 1,018,875 DoF) that is axis 0, whose 19 nodes stay 19 through the
Q1 multigrid levels above the coarse one, so every split lines up level
to level and the transfers act across it without a halo.

Both exchanges send each rank's planes to the neighbour that needs them,
as send/recv (`RankGroup.exchange`, the counterpart of the
collective-permutes XLA inserts for the JAX package's sharding), where
the backend can send the tensor: NCCL on the cards, gloo on the CPU.
Gloo ranks sharing a card (gloo's send/recv takes CPU tensors only) run
the same exchange as a SUM all-reduce of a buffer with one slot per rank
(the planes each rank contributes, in the directions some rank needs):
each slot holds one nonzero term, so both forms give the same bits, but
the buffer grows with the world size. `RankGroup.exchange_form` picks
the form, the one selector.
bf16 partial sums come out of the kernels in f32 (their bf16-in/f32-out
mode), travel and are added in f32 and are rounded once.
A world of one exchanges nothing: its slab is the lattice, and every
operator runs exactly the single-device code.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .partition import RankGroup


def split_axis(grid_shape: Sequence[int], p: int, world: int) -> int:
    """The slowest lattice axis with at least `world` cells."""
    for ax, n in enumerate(grid_shape):
        if (n - 1) // p >= world:
            return ax
    raise ValueError(
        f"no lattice axis of {tuple(grid_shape)} (degree {p}) has {world} "
        "cells to split over the ranks")


def balanced_bounds(n_cells: int, world: int) -> Tuple[int, ...]:
    """Cell-plane bounds (world + 1 of them) of a balanced split."""
    base, extra = divmod(n_cells, world)
    sizes = [base + (1 if r < extra else 0) for r in range(world)]
    return tuple(int(x) for x in np.concatenate([[0], np.cumsum(sizes)]))


class SlabLayout:
    """One lattice's split over the ranks of `mesh` along `axis`.
    `node_bounds` (world + 1 node-plane indices, multiples of p, the last
    the closing plane n - 1) defaults to a balanced cell split."""

    def __init__(self, grid_shape, p: int, axis: int, mesh: RankGroup,
                 node_bounds: Optional[Sequence[int]] = None):
        self.grid_shape = tuple(int(n) for n in grid_shape)
        self.p, self.axis, self.mesh = int(p), int(axis), mesh
        self.world, self.rank = mesh.world, mesh.rank
        n = self.grid_shape[axis]
        if node_bounds is None:
            node_bounds = [c * p for c in balanced_bounds((n - 1) // p, self.world)]
        nb = [int(b) for b in node_bounds]
        if (len(nb) != self.world + 1 or nb[0] != 0 or nb[-1] != n - 1
                or any(b % p for b in nb) or any(b >= c for b, c in zip(nb, nb[1:]))):
            raise ValueError(f"bad node bounds {nb} for {n} planes of degree {p} "
                             f"over {self.world} ranks")
        self.node_bounds = tuple(nb)
        # owned planes of every rank: [nb[q], nb[q+1]), the last to n
        self.owned = tuple((nb[q], nb[q + 1] if q < self.world - 1 else n)
                           for q in range(self.world))
        self.lo, self.hi = self.owned[self.rank]
        self.top = self.rank < self.world - 1  # a rank above shares a plane
        self.slab_planes = nb[self.rank + 1] + 1 - self.lo

        def shape(k):
            s = list(self.grid_shape)
            s[axis] = k
            return tuple(s)

        self.owned_shape = shape(self.hi - self.lo)
        self.slab_shape = shape(self.slab_planes)
        self.n_owned = math.prod(self.owned_shape)

    @property
    def slab_reps(self) -> Tuple[int, ...]:
        """Cells per axis of this rank's slab, slowest first."""
        return tuple((n - 1) // self.p for n in self.slab_shape)

    # -- global <-> distributed ------------------------------------------

    def local(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's rows (n_owned, dim) of a global (n_nodes, dim)
        vector."""
        dim = v.shape[-1]
        g = v.reshape(self.grid_shape + (dim,))
        return g.narrow(self.axis, self.lo, self.hi - self.lo).reshape(-1, dim)

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        """The global (n_nodes, dim) vector of a distributed one, on every
        rank (one all-reduce; each entry has one nonzero term)."""
        dim = v.shape[-1]
        if self.world == 1:
            return v.reshape(-1, dim)
        full = v.new_zeros(self.grid_shape + (dim,))
        full.narrow(self.axis, self.lo, self.hi - self.lo).copy_(
            v.reshape(self.owned_shape + (dim,)))
        return self.mesh.all_reduce(full).reshape(-1, dim)

    # -- the exchanges ----------------------------------------------------

    def extend(self, g: torch.Tensor, k_lo: int, k_hi: int,
               K: Tuple[int, int]) -> torch.Tensor:
        """The owned grid `g` (owned_shape + (dim,)) extended by `k_lo`
        planes of the rank below and `k_hi` of the rank above: every rank
        sends its last `K[0]` owned planes up and its first `K[1]` down
        (`K`, the same on every rank, at least each rank's k_lo and k_hi;
        a direction no rank needs is not sent), between neighbours or
        through one all-reduce (`RankGroup.exchange_form`)."""
        n_last, n_first = K
        if self.world == 1 or n_last + n_first == 0:
            return g
        ax = self.axis
        own = self.hi - self.lo
        last = g.narrow(ax, own - n_last, n_last).movedim(ax, 0)
        first = g.narrow(ax, 0, n_first).movedim(ax, 0)
        self.mesh.calls["halo"] += 1
        if self.mesh.exchange_form(g) == "p2p":
            below, above = self.mesh.exchange(first, last)
        else:
            mine = torch.cat([last, first])
            buf = mine.new_zeros((self.world,) + tuple(mine.shape))
            buf = torch.cat([buf[: self.rank], mine[None], buf[self.rank + 1:]])
            buf = self.mesh.all_reduce(buf)
            below = buf[self.rank - 1, :n_last] if self.rank > 0 else None
            above = (buf[self.rank + 1, n_last:] if self.top else None)
        parts = []
        if k_lo:
            parts.append(below[n_last - k_lo:].movedim(0, ax))
        parts.append(g)
        if k_hi:
            parts.append(above[:k_hi].movedim(0, ax))
        return torch.cat(parts, dim=ax) if len(parts) > 1 else g

    def fill(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's slab grid (slab_shape + (dim,)) of a distributed
        vector: the owned planes and the first plane of the rank above
        (only first planes are sent)."""
        dim = v.shape[-1]
        g = v.reshape(self.owned_shape + (dim,))
        return self.extend(g, 0, 1 if self.top else 0, (0, 1))

    def interface_sum(self, y: torch.Tensor) -> torch.Tensor:
        """The owned rows (n_owned, dim) of an operator output computed on
        this rank's slab (slab_shape + (dim,)): the slab's top plane, a
        partial sum, is added into the rank above's first plane (sent
        between neighbours or through one all-reduce, as in `extend`).
        Partial sums are added in f32 or wider."""
        dim = y.shape[-1]
        if self.world == 1:
            return y.reshape(-1, dim)
        ax = self.axis
        own = self.hi - self.lo
        wide = torch.float32 if y.dtype == torch.bfloat16 else y.dtype
        # the last rank's top plane is read by no rank; it goes in all the
        # same, so that under forward-mode AD every rank's input carries a
        # tangent and every rank runs the tangent's exchange
        top = y.narrow(ax, self.slab_planes - 1 if self.top else 0, 1)
        top = top.movedim(ax, 0).to(wide)
        self.mesh.calls["interface_sum"] += 1
        if self.mesh.exchange_form(y) == "p2p":
            below, _ = self.mesh.exchange(top[:0], top)
        else:  # the last rank's slot: 0 * a plane of y (a tangent, no value)
            top = top * (1.0 if self.top else 0.0)
            buf = y.new_zeros((self.world, 1) + tuple(top.shape[1:]),
                              dtype=wide)
            buf = torch.cat([buf[: self.rank], top[None], buf[self.rank + 1:]])
            buf = self.mesh.all_reduce(buf)
            below = buf[self.rank - 1] if self.rank > 0 else None
        out = y.narrow(ax, 0, own)
        if self.rank > 0:
            first = (out.narrow(ax, 0, 1).to(wide)
                     + below.movedim(0, ax)).to(y.dtype)
            out = torch.cat([first, out.narrow(ax, 1, own - 1)], dim=ax)
        return out.reshape(-1, dim)


class SlabOperator:
    """y = A u on distributed vectors: `fill`, the operator `op` built on
    this rank's slab lattice (a kernel wrapper or a plain structured
    operator), `interface_sum`. With more than one rank a bf16 vector goes
    into `op` as bf16 and comes out as its f32 accumulation
    (`op(u, out_dtype=torch.float32)`: the kernels' bf16-in/f32-out
    mode), so the slabs' partial sums are added in f32 and rounded to bf16
    once, as the single-device kernel, on the same bf16 path, rounds its
    f32 accumulation once. A world of one calls `op` on the vector
    itself."""

    def __init__(self, op, layout: SlabLayout):
        self.op, self.layout = op, layout

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        lay = self.layout
        if lay.world == 1:
            return self.op(u)
        dim = u.shape[-1]
        g = lay.fill(u).reshape(-1, dim)
        y = (self.op(g, out_dtype=torch.float32) if u.dtype == torch.bfloat16
             else self.op(g))
        return lay.interface_sum(y.reshape(lay.slab_shape + (dim,))).to(u.dtype)


def axis_transfer(M: np.ndarray, rows_of, src: SlabLayout):
    """y[rows] = M[rows] @ x along the split axis, x distributed by `src`,
    each rank q computing the rows `rows_of(q)`: (k_lo, k_hi, K, (c_lo,
    c_hi)) — the halo widths this rank needs below and above, their
    maxima over all ranks (`extend`'s K, computed from the bounds every
    rank knows, so the same everywhere), and the columns of M the
    extended x covers."""
    needs = []
    for q in range(src.world):
        lo, hi = src.owned[q]
        r0, r1 = rows_of(q)
        nz = np.nonzero(np.abs(M[r0:r1]).sum(axis=0))[0]
        c_lo = min(int(nz.min()), lo) if nz.size else lo
        c_hi = max(int(nz.max()) + 1, hi) if nz.size else hi
        needs.append((lo - c_lo, c_hi - hi, c_lo, c_hi))
    K = (max(a for a, _, _, _ in needs), max(b for _, b, _, _ in needs))
    for q in range(src.world):
        lo, hi = src.owned[q]
        if hi - lo < max(K):
            raise ValueError(f"rank {q} owns {hi - lo} planes, fewer than the "
                             f"halo of {max(K)} a transfer needs")
    k_lo, k_hi, c_lo, c_hi = needs[src.rank]
    return k_lo, k_hi, K, (c_lo, c_hi)
