"""The launch counts of every kernel wrapper of the package.

Each wrapper adds one to its `launches` where it launches its kernel, and
nowhere else (a CPU tensor takes the plain version and counts nothing).
`counters()` names them all, so a run can set them to 0, drive a path and
read which kernels the path launched (`chip_smoke.py`, the CLI summary).

Under CUDA graphs (`solvers/cg.py:ChunkedCG`) a wrapper runs only while
its launch is captured, and a replay launches the captured kernels
without running any Python. So a capture takes the launches its wrappers
counted back out (`captured`: nothing ran yet) and keeps them as the
graph's launches per replay, and every replay adds them again (`add`).
The counts therefore stay device launches: a replay of a CG chunk adds
the launches of all its iterations, the masked ones after convergence
included, since those really run.
"""

from __future__ import annotations


def counters() -> dict:
    """{kernel name: the object whose `launches` counts its launches}."""
    from ..ops import assembled_tangent as at
    from ..ops.q1_structured import (
        Q1PlaneOperator,
        Q1StructuredOperator,
        Q1StructuredOperator2D,
    )
    from ..ops.q2_structured import Q2StructuredOperator
    from ..ops.stencil import StencilQ1Operator
    from . import _build

    return {
        "C1 health_scale": _build.health_scale,
        "C2 health_add_one": _build.health_add_one,
        "K1 tangent_matvec": at.apply_packed_tangents_T,
        "K1b tangent_matvec_rows": at.apply_packed_tangents,
        "K1c tangent_matvec_blocks": at.apply_block_tangents,
        "K2 tangent_matvec_sym": at.apply_packed_tangents_sym,
        "K2b tangent_matvec_sym_blocks": at.apply_sym_block_tangents,
        "K3 q1_structured": Q1StructuredOperator,
        "K4 q1_plane": Q1PlaneOperator,
        "K4b q1_structured_2d": Q1StructuredOperator2D,
        "K5 q2_structured": Q2StructuredOperator,
        "K6 q1_stencil": StencilQ1Operator,
    }


def launch_counts() -> dict:
    """{kernel name: launches so far in this process}."""
    return {name: obj.launches for name, obj in counters().items()}


def reset() -> None:
    """Set every launch count to 0."""
    for obj in counters().values():
        obj.launches = 0


def captured(before: dict) -> dict:
    """The launches counted since the `launch_counts()` snapshot `before`,
    taken just before a CUDA-graph capture: what one replay of the graph
    launches. Sets every count back to `before`, since the capture itself
    launched nothing."""
    objs = counters()
    per_replay = {}
    for name, obj in objs.items():
        n = obj.launches - before.get(name, 0)
        if n:
            per_replay[name] = n
        obj.launches = before.get(name, 0)
    return per_replay


def add(launches: dict, times: int = 1) -> None:
    """Add `times` replays' worth of `launches` ({kernel name: per
    replay}) to the counts."""
    objs = counters()
    for name, n in launches.items():
        objs[name].launches += n * times
