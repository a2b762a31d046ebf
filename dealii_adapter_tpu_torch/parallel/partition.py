"""Ranks, their process group, and the host-side cell partition.

Counterpart of `dealii_adapter_tpu/parallel/partition.py`. The JAX package
runs one program over a `jax.sharding.Mesh`; here each rank is a process
under `torch.distributed`, PyTorch's idiom for several cards, and
`RankGroup` is the counterpart of the device mesh: the process group, this
rank, the world size, this rank's device and the backend.

The backend follows one rule (`choose_backend`): NCCL when every rank has a
card of its own, gloo when ranks share one card or run on the CPU. It is
never chosen by catching NCCL's failure. Gloo moves CUDA tensors through
the host and cannot be captured in a CUDA graph, so a gloo world on the
card runs the models' CG chunks eagerly (`cg_loop="host"`). Under NCCL
`make_device_mesh` makes the rank's card (`cuda:LOCAL_RANK`) current, the
one place every launch route (`spawn`, `torchrun`, the CLI) goes through:
the kernels launch on the current device's stream.

The lattice partition's halo exchanges go between neighbouring ranks
(`RankGroup.exchange`), the counterpart of the collective-permutes XLA
inserts for the JAX package's `P(axis, None)` sharding, wherever the
backend can send the tensor; one rule picks the form
(`RankGroup.exchange_form`).

A CUDA graph that captured NCCL work holds the group's communicators, and
destroying the group waits for it. `RankGroup.close` is the one way a run
ends its group: it resets the graphs that captured the group's
collectives, then destroys the group (`spawn`'s ranks and the CLI call
it; a `torchrun` script calls it last).

`CellPartition` is a copy of the JAX package's (numpy only): contiguous
lexicographic cell blocks, one per rank, with windowed transpose-gather
plans.

Launch a multi-rank run with `torchrun --nproc-per-node N script.py` (the
script calls `torch.distributed.init_process_group`, then builds its model
with `device_mesh=make_device_mesh()` and ends with that group's `close()`),
or with `spawn(fn, N, device)`, which starts N processes, initializes the
group, collects what `fn` returns and closes the group.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile
import time
import traceback
import weakref
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..fem.dofspace import build_transpose_gather_plan
from ..solvers.graphs import capturing

LAUNCH_HINT = (
    "launch one process per rank and initialize torch.distributed first: "
    "`torchrun --nproc-per-node N script.py` (then "
    "torch.distributed.init_process_group()), or "
    "dealii_adapter_tpu_torch.parallel.spawn(fn, N, device)"
)


def choose_backend(device, world: int) -> str:
    """NCCL when every rank has a card of its own (a CUDA device and at
    least `world` visible cards), gloo otherwise (ranks on the CPU, or
    sharing one card)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce with a forward-mode rule: the reduction is linear, so
    the tangent is the all-reduced tangent (the JAX package's `psum` has
    this rule built in). The backward rule all-reduces the cotangent. The
    rule runs only for an input that carries a tangent, so under
    forward-mode AD every rank's input must carry one where any does (the
    callers build their buffers from the differentiated values on every
    rank)."""

    @staticmethod
    def forward(x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def jvp(ctx, x_t, _):
        t = x_t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=ctx.group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def _p2p(mesh: "RankGroup", down: torch.Tensor, up: torch.Tensor):
    """Send `down` to the rank below and `up` to the rank above (an empty
    tensor is not sent); returns (what the rank below sent up, what the
    rank above sent down), each shaped as this rank's `up` and `down`
    (every rank sends the same shapes). A side without a neighbour is
    left unwritten and must not be read. All sends and receives of a rank
    go out as one batch (`batch_isend_irecv`: one NCCL group, so no order
    of the ranks can deadlock)."""
    from_below, from_above = torch.empty_like(up), torch.empty_like(down)
    r, ops = mesh.rank, []
    if r > 0:
        if down.numel():
            ops.append(dist.P2POp(dist.isend, down.contiguous(),
                                  mesh.peer(r - 1), mesh.group))
        if up.numel():
            ops.append(dist.P2POp(dist.irecv, from_below, mesh.peer(r - 1),
                                  mesh.group))
    if r < mesh.world - 1:
        if up.numel():
            ops.append(dist.P2POp(dist.isend, up.contiguous(),
                                  mesh.peer(r + 1), mesh.group))
        if down.numel():
            ops.append(dist.P2POp(dist.irecv, from_above, mesh.peer(r + 1),
                                  mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_below, from_above


class _NeighbourExchange(torch.autograd.Function):
    """`_p2p` with a forward-mode rule: the exchange is linear, so the
    tangents are exchanged the same way (the collective-permute's rule in
    the JAX package). As for `_AllReduceSum`, the rule runs only for
    inputs that carry a tangent, so every rank's inputs must carry one
    where any does (the callers build both from the differentiated values
    on every rank)."""

    @staticmethod
    def forward(down, up, mesh):
        return _p2p(mesh, down, up)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[2]

    @staticmethod
    def jvp(ctx, down_t, up_t, _):
        return _p2p(ctx.mesh, down_t, up_t)


@dataclasses.dataclass
class RankGroup:
    """One rank's view of the world: the process group, this rank, the
    world size, the device this rank computes on and the backend. Counts
    its collectives (`calls`: all-reduces of every kind, and among them the
    lattice partition's halo fills and interface sums) as Python calls;
    under a CUDA-graph replay nothing is counted; `exchange` counts as
    `p2p` when it sends between neighbours. `slot_exchange` set runs the
    halo exchanges as the slot all-reduce where the rule would send
    between neighbours (the same bits: the chip script's and the tests'
    side-by-side runs of both forms). Keeps the CUDA graphs that captured
    its collectives, for `close`."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device
    backend: str
    calls: dict = dataclasses.field(
        default_factory=lambda: {"all_reduce": 0, "p2p": 0, "halo": 0,
                                 "interface_sum": 0})
    slot_exchange: bool = False
    _graphs: weakref.WeakSet = dataclasses.field(
        default_factory=weakref.WeakSet, init=False, repr=False,
        compare=False)

    def _note_capture(self) -> None:
        """Keep the CUDA graph being captured, if any, for `close`."""
        graph = capturing()
        if graph is not None:
            self._graphs.add(graph)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """SUM (differentiable, forward and backward), MIN or MAX of `x`
        over the ranks, as a new tensor. bf16 is reduced in f32 (gloo has
        no bf16 reduction) and rounded back: exact for MIN, MAX and a SUM
        with one nonzero term."""
        self.calls["all_reduce"] += 1
        self._note_capture()
        dt = x.dtype
        y = x.float() if dt == torch.bfloat16 else x
        if op == "sum":
            y = _AllReduceSum.apply(y, self.group)
        elif op in ("min", "max"):
            y = y.detach().clone()
            dist.all_reduce(y, op=getattr(dist.ReduceOp, op.upper()),
                            group=self.group)
        else:
            raise ValueError(f"unknown reduction {op!r}")
        return y.to(dt)

    def exchange_form(self, x: torch.Tensor) -> str:
        """How the lattice partition's halo exchanges move `x`: "p2p",
        send/recv between neighbours, where the backend can send it (NCCL
        a CUDA tensor, gloo a CPU tensor) and `slot_exchange` is not set,
        else "all_reduce", a SUM all-reduce of one slot a rank (gloo ranks
        sharing a card: gloo's send/recv takes CPU tensors only). Both
        give the same bits: a slot holds one nonzero term. NCCL's
        send/recv is captured in the CUDA graphs as its all-reduce is."""
        sends = (x.device.type == "cuda") == (self.backend == "nccl")
        return "p2p" if sends and not self.slot_exchange else "all_reduce"

    def peer(self, rank: int) -> int:
        """The global rank of `rank` of this group (what send/recv take)."""
        return rank if self.group is None else dist.get_global_rank(
            self.group, rank)

    def exchange(self, down: torch.Tensor, up: torch.Tensor):
        """`down` to the rank below, `up` to the rank above, as one batch
        of send/recv (differentiable in forward mode); returns (the rank
        below's `up`, the rank above's `down`). A side without a
        neighbour is not written. Every rank passes the same shapes."""
        self.calls["p2p"] += 1
        self._note_capture()
        return _NeighbourExchange.apply(down, up, self)

    def dot(self, dot: Callable) -> Callable:
        """The global inner product of row-distributed vectors: the local
        `dot` plus one SUM all-reduce."""

        def gdot(a, b):
            return self.all_reduce(dot(a, b))

        return gdot

    def close(self) -> None:
        """End the run's group: reset every CUDA graph that captured one of
        its collectives (through `solvers.graphs.capture`), then destroy
        the process group. A graph holding captured NCCL work keeps the
        communicators, and the destroy waits for it (on 2 and 4 H100s it
        never returned while a model's graphs lived), so no caller has to
        drop its models first. Those graphs cannot be replayed after."""
        for graph in list(self._graphs):
            graph.reset()
        self._graphs.clear()
        dist.destroy_process_group(self.group)


def make_device_mesh(n_devices: Optional[int] = None, device=None,
                     group=None) -> RankGroup:
    """The `RankGroup` of the initialized default process group (or
    `group`). `n_devices`, when given, must equal its world size. `device`
    defaults to the CUDA card of this rank's local index (`LOCAL_RANK`,
    else the rank) under NCCL, the first card under gloo (ranks share
    it), and must be named "cpu" for a run on the CPU; a bare "cuda" is
    given the same index. The rank's card is made the current device, so
    that the kernels, which launch on the current device, run on it.
    Raises, saying how to launch, when torch.distributed is not
    initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"n_devices={n_devices} needs an initialized process group: "
            + LAUNCH_HINT)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"n_devices={n_devices}, but the process group has {world} ranks")
    backend = str(dist.get_backend(group))
    if device is None and not torch.cuda.is_available():
        resolve_device(None)  # raises, saying to pass device="cpu"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    return RankGroup(group=group, rank=rank, world=world, device=dev,
                     backend=backend)


@dataclasses.dataclass(frozen=True)
class CellPartition:
    """Per-rank padded cell blocks + windowed transpose-gather plans.

    Attributes (all host numpy; leading axis = shard):
      cells:    (n_shards, cpd, npc) int32 — padded with node 0 rows; padded
                rows are never referenced by any plan so they contribute 0.
      plans:    (n_shards, wlen, maxval) int32 — indices into the flattened
                local (cpd*npc + 1) cell-value array; cpd*npc is the zero
                sentinel row.
      offsets:  (n_shards,) int32 — global node id of each shard's window row 0.
      n_valid:  (n_shards,) int32 — real (unpadded) cell count per shard.
      n_nodes:  global node count; n_nodes_pad >= n_nodes is the reduction
                buffer length (window placement never clamps).
    """

    n_shards: int
    cpd: int
    cells: np.ndarray
    plans: np.ndarray
    offsets: np.ndarray
    n_valid: np.ndarray
    n_nodes: int
    n_nodes_pad: int

    @classmethod
    def create(cls, cells: np.ndarray, n_nodes: int, n_shards: int) -> "CellPartition":
        n_cells, npc = cells.shape
        cpd = math.ceil(n_cells / n_shards)
        sentinel = cpd * npc

        cells_sh = np.zeros((n_shards, cpd, npc), dtype=np.int32)
        plan_list = []
        offsets = np.zeros(n_shards, dtype=np.int32)
        n_valid = np.zeros(n_shards, dtype=np.int32)
        wlens, maxvals = [], []
        for d in range(n_shards):
            block = cells[d * cpd : min((d + 1) * cpd, n_cells)]
            m = block.shape[0]
            n_valid[d] = m
            cells_sh[d, :m] = block
            if m == 0:
                # empty shard (more ranks than cells): all-sentinel plan
                offsets[d] = 0
                plan_list.append(np.full((1, 1), sentinel, dtype=np.int64))
                wlens.append(1)
                maxvals.append(1)
                continue
            lo = int(block.min())
            hi = int(block.max()) + 1
            offsets[d] = lo
            local_plan, local_sentinel = build_transpose_gather_plan(
                block - lo, hi - lo
            )
            # re-point the sentinel at the padded flat length
            local_plan = np.where(local_plan == local_sentinel, sentinel, local_plan)
            plan_list.append(local_plan)
            wlens.append(hi - lo)
            maxvals.append(local_plan.shape[1])

        wlen = max(wlens)
        maxval = max(maxvals)
        plans = np.full((n_shards, wlen, maxval), sentinel, dtype=np.int32)
        for d, p in enumerate(plan_list):
            plans[d, : p.shape[0], : p.shape[1]] = p

        n_nodes_pad = max(int(offsets.max()) + wlen, n_nodes)
        return cls(
            n_shards=n_shards,
            cpd=cpd,
            cells=cells_sh,
            plans=plans,
            offsets=offsets,
            n_valid=n_valid,
            n_nodes=n_nodes,
            n_nodes_pad=n_nodes_pad,
        )

    @property
    def npc(self) -> int:
        return self.cells.shape[2]

    @property
    def wlen(self) -> int:
        return self.plans.shape[1]


# ---------------------------------------------------------------------------
# the spawn helper
# ---------------------------------------------------------------------------


def _worker(rank, world, backend, init_method, device, fn, args, queue,
            timeout_s, threads):
    if threads:
        torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)  # one host: rank r's card is cuda:r
    mesh = None
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_device_mesh(world, device=device)
        queue.put((rank, True, fn(mesh, *args)))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if mesh is not None:
            mesh.close()
        elif dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, device, *args, backend=None,
          init_dir=None, timeout_s: float = 600.0,
          threads: Optional[int] = None):
    """Run `fn(mesh, *args)` on `n_ranks` new processes (start method
    "spawn"), one rank each, over a process group initialized through a
    file in `init_dir` (a new temporary directory by default); returns the
    ranks' return values in rank order. `device` ("cpu" or "cuda") is
    required: under NCCL rank r computes on cuda:r, under gloo every rank
    on cuda:0 (or the CPU). `backend` defaults to `choose_backend`. A rank
    that raises makes this raise with its traceback, after every process
    has been stopped. `threads` sets each rank's torch threads; on the CPU
    it defaults to the host's cores shared out over the ranks (ranks whose
    thread pools overlap the cores slow each other's collectives down by
    orders of magnitude). `fn` and `args` must be picklable (a module-level
    function)."""
    import queue as _queue

    import torch.multiprocessing as mp

    device = torch.device(device)
    backend = backend or choose_backend(device, n_ranks)
    if threads is None and device.type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // n_ranks)
    init_dir = init_dir or tempfile.mkdtemp(prefix="dat_torch_dist_")
    init_file = os.path.join(str(init_dir), f"init_{os.getpid()}_{id(fn)}")
    if os.path.exists(init_file):
        os.remove(init_file)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [
        ctx.Process(target=_worker, args=(
            r, n_ranks, backend, "file://" + init_file, str(device), fn, args,
            q, timeout_s, threads), daemon=False)
        for r in range(n_ranks)
    ]
    for p in procs:
        p.start()
    results, errors = {}, []
    t_end = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < n_ranks:
            try:
                rank, ok, val = q.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:  # died before it could report (at start-up)
                    errors.append(f"ranks {dead} exited with codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                elif time.monotonic() > t_end:
                    errors.append(f"no result from some rank in {timeout_s} s")
                else:
                    continue
                break
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
                break
    finally:
        for p in procs:
            p.join(timeout=5.0 if not errors else 0.5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        if os.path.exists(init_file):
            os.remove(init_file)
    if errors:
        raise RuntimeError("a spawned rank failed: " + "\n".join(errors))
    return [results[r] for r in range(n_ranks)]
