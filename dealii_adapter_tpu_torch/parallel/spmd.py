"""The element backend and SPMD mode of a model, decided in one place.

Both models build their constant element-matrix operators through
`element_operators`, which picks the mode from `element_backend` and the
rank group (the JAX package's models make the same choice,
`dealii_adapter_tpu/models/linear_elasticity.py:105-176`):

* one device: the structured operator, or the gather-plan operator for
  `element_backend="gather"`;
* several ranks with `gather`: the cell partition (`sharded_ops.py`);
* several ranks otherwise: the lattice partition's slabs (`lattice.py`).
"""

from __future__ import annotations

import torch

from ..config import AllParameters
from ..fem.dofspace import DofSpace
from ..ops.element_ops import make_operator
from ..ops.structured import (
    _grid_shape,
    make_structured_operator,
    structured_operator_from_lattice,
)
from .lattice import SlabLayout, SlabOperator, split_axis
from .partition import CellPartition
from .sharded_ops import make_sharded_operator

# the JAX package's refusal of MG under its shard_map cell partition
MG_CELL_PARTITION = (
    "MG with the shard_map cell-partition backend is not supported; use "
    "element_backend='auto'/'structured' (GSPMD lattice sharding) for MG on "
    "a device mesh")


def check_collective_loop(device_mesh, device, cg_loop: str) -> None:
    """A gloo world on the card cannot capture its collectives in a CUDA
    graph: it must run the host CG loop (never swapped in silently)."""
    if (device_mesh is not None and device_mesh.backend == "gloo"
            and torch.device(device).type == "cuda" and cg_loop == "graphs"):
        raise ValueError(
            "a gloo process group's collectives cannot be captured in a CUDA "
            "graph: pass cg_loop='host' (or run one rank per card on NCCL)")


def lattice_layout(params: AllParameters, space: DofSpace, device_mesh):
    """The fine lattice's `SlabLayout` when the parameters and the rank
    group run the lattice partition (several ranks, an element backend
    other than `gather`), else None (one device, or the cell partition,
    whose vectors are replicated)."""
    if device_mesh is None or params.element_backend == "gather":
        return None
    gs, p = _grid_shape(space), space.mesh.degree
    return SlabLayout(gs, p, split_axis(gs, p, device_mesh.world), device_mesh)


def element_operators(params: AllParameters, space: DofSpace, device_mesh,
                      device):
    """`(mkop, lattice, cells)`: `mkop(E, dtype)` builds the constant
    element-matrix operator of the parameters' element backend and SPMD
    mode: structured, gather-plan, cell-partitioned (`gather` on several
    ranks) or on the lattice partition's slabs (`auto`/`structured` on
    several ranks; `lattice` is then the fine lattice's `SlabLayout`);
    `cells` says whether it is the cell partition."""
    gather = params.element_backend == "gather"
    if device_mesh is not None and gather:
        part = CellPartition.create(space.cells, space.n_nodes, device_mesh.world)

        def mkop(E, dtype):
            return make_sharded_operator(space, E, device_mesh, dtype, part=part,
                                         device=device)

        return mkop, None, True
    if device_mesh is not None:
        lat = lattice_layout(params, space, device_mesh)
        p = space.mesh.degree

        def mkop(E, dtype):
            return SlabOperator(structured_operator_from_lattice(
                E, lat.slab_shape, p, dtype, device), lat)

        return mkop, lat, False
    if gather:
        return (lambda E, dtype: make_operator(space, E, dtype, device)), None, False
    return ((lambda E, dtype: make_structured_operator(space, E, dtype, device)),
            None, False)
