"""Bodies that write into static buffers, run eagerly once and replayed
from CUDA graphs after that.

`GraphRunner(device, pool)(key, body)` runs `body()` (a callable that
reads and writes only tensors that outlive it, on the current stream, with
no host sync) once for real on a side stream at the first call with `key`,
captures it into a `torch.cuda.CUDAGraph` in `pool` right after, and from
then on replays that graph for `key`; on the CPU it always runs `body()`.
The first call is the warm-up PyTorch asks for before a capture, and its
result is the call's result, so no call runs a body twice. The launch
counts stay device launches: the warm-up's are real and counted, a
capture sets its wrappers' counts back and keeps them as the graph's
launches per replay, and every replay adds them again
(`kernels/counters.py`).

`GraphRunner(device, pool, eager=True)` runs every body eagerly and
captures nothing, with the same call: the runner of a model built with
`cg_loop="host"`, whose collectives on gloo ranks cannot be captured.

The Neo-Hookean model's Newton loop runs its residuals, tangent refills,
decisions and updates through one runner that shares its pool with the
model's CG graphs (`cg.py:ChunkedCG`, which warms both its bodies up
before it captures either; both capture through `capture`), and the
linear model's step its right-hand side, update and defect-correction
loop (`cg.py:ChunkedIRCG`) the same way; an eager runner makes the
linear model's `ChunkedCG` eager too.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, Hashable

import torch


_CAPTURING = []  # the graph `capture` records into, while it does


def capturing():
    """The CUDA graph `capture` is recording into, or None: a
    `parallel.RankGroup` registers it when one of its collectives is
    captured, and resets it in `RankGroup.close`."""
    return _CAPTURING[-1] if _CAPTURING else None


@contextlib.contextmanager
def capture(graph, pool=None):
    """`torch.cuda.graph(graph, pool=pool)` with Python's automatic garbage
    collection off: a collection in the middle of a capture can tear down
    another object's CUDA graphs (a dropped model in a reference cycle),
    which CUDA does not permit while a stream captures (seen on the H100
    as `cudaErrorStreamCaptureInvalidated`, in a process that had dropped
    such a model, and gone with the collection off). `torch.cuda.graph`
    collects once before it starts capturing. Every capture of the
    package goes through here (`capturing`)."""
    enabled = gc.isenabled()
    gc.disable()
    _CAPTURING.append(graph)
    try:
        with torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        _CAPTURING.pop()
        if enabled:
            gc.enable()


class GraphRunner:
    """Replays each keyed body from its CUDA graph (module docstring)."""

    def __init__(self, device, pool=None, eager: bool = False):
        self.device = torch.device(device)
        self.pool = pool
        self.eager = eager  # run every body, capture nothing
        self._graphs = {}  # key -> (CUDAGraph, launches per replay)

    def __call__(self, key: Hashable, body: Callable[[], None]) -> None:
        if self.eager or self.device.type != "cuda":
            body()
            return
        from ..kernels import counters

        entry = self._graphs.get(key)
        if entry is not None:
            graph, per_replay = entry
            graph.replay()
            counters.add(per_replay)
            return
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):  # the warm-up: this call's result
            body()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = counters.launch_counts()
        with capture(graph, self.pool):
            body()
        self._graphs[key] = (graph, counters.captured(before))

    def __len__(self) -> int:
        return len(self._graphs)
