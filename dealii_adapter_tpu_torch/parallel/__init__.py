"""Several ranks: the two SPMD modes of the JAX package's parallel layer.

Counterpart of `dealii_adapter_tpu/parallel/`. One process per rank under
`torch.distributed` (`partition.py`: `RankGroup`, the backend rule, the
`spawn` helper):

* the cell partition (`element_backend="gather"`, `n_devices > 1`; the JAX
  package's `shard_map` mode): each rank applies the element kernels to
  its own cell block and one all-reduce gives every rank the nodal sums;
  vectors are replicated (`sharded_ops.py`);
* the lattice partition (`element_backend` `auto`/`structured`; the JAX
  package's GSPMD mode, its production multi-device path): the node
  lattice is split into per-rank slabs, the structured operators and
  kernels run on each rank's slab with a halo fill and an interface sum,
  and vectors are distributed by rows (`lattice.py`).

`dryrun.py:dryrun_multichip` runs the production configuration on N
spawned ranks.
"""

from .partition import (
    CellPartition,
    RankGroup,
    choose_backend,
    make_device_mesh,
    spawn,
)
from .sharded_ops import ShardedOperator, make_sharded_operator, sharded_cellwise_reduction

__all__ = [
    "CellPartition",
    "RankGroup",
    "ShardedOperator",
    "choose_backend",
    "make_device_mesh",
    "make_sharded_operator",
    "sharded_cellwise_reduction",
    "spawn",
]
