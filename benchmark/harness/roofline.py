"""Roofline arithmetic (copied from the program's `chip_smoke.py:bound`,
`operator_work` and `stencil_work`): the least time one H100 SXM needs to
move an operator's bytes once and do its operations, at the published
peaks (NVIDIA's data sheet, dense, 700 W)."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # f32 outside the tensor cores
# the bytes of the V-cycle's vectors by the configuration's `precond_dtype`
IO_BYTES = {"bfloat16": 2, "float32": 4, "": 8}
PEAK_NOTE = "H100 SXM published peaks: 3.35 TB/s HBM, 67 TFLOP/s f32"


def bound_s(n_bytes: float, flops: float, flops_per_s: float = F32_FLOPS) -> float:
    """Seconds: the larger of bytes over bandwidth and operations over the
    peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / flops_per_s)


def tangent_matvec_work(n_cells: int, edofs: int, value_bytes: int = 4):
    """(bytes, operations) of one matvec with per-cell dense tangents: each
    cell's (edofs, edofs) matrix read once, its input and output vectors
    read and written once, one FMA per matrix entry."""
    return ((n_cells * edofs * edofs + 2 * n_cells * edofs) * value_bytes,
            2 * n_cells * edofs * edofs)


def stencil_work(grid_shape, io_bytes: int, table_bytes: int = 4):
    """(bytes, operations) of one assembled Q1 stencil apply: u read once, y
    written once, the class tables; 3^dim neighbours x dim^2 FMA a node."""
    dim = len(grid_shape)
    n_nodes = math.prod(grid_shape)
    n_off = 3 ** dim
    return (2 * n_nodes * dim * io_bytes + table_bytes * n_off * n_off * dim * dim,
            2 * n_nodes * n_off * dim * dim)


def q1_hierarchy(reps, degree: int, extent, coarse_size: int, dim: int = 3):
    """The Q1 levels' node lattices (slowest axis first) of the geometric
    multigrid the configuration asks for: Q1 on the fine node lattice
    (FEM-SEM), then aspect-aware semi-coarsening (halve the axes whose
    spacing is within 1.9x the finest, all of them when none changes) until
    a level has at most `coarse_size` DoF; that last level is solved
    directly. Returns (smoothed levels, the coarse level)."""
    reps = tuple(r * degree for r in reps) if degree > 1 else tuple(reps)
    levels = [reps]
    while math.prod(r + 1 for r in reps) * dim > coarse_size and any(r > 1 for r in reps):
        h = [e / r for e, r in zip(extent, reps)]
        hmin = min(h_d for h_d, r in zip(h, reps) if r > 1)
        new = tuple(max(1, (r + 1) // 2) if (r > 1 and h_d <= 1.9 * hmin) else r
                    for r, h_d in zip(reps, h))
        if new == reps:
            new = tuple(max(1, (r + 1) // 2) for r in reps)
        reps = new
        levels.append(reps)
    shapes = [tuple(reversed([r + 1 for r in lv])) for lv in levels]
    return shapes[:-1], shapes[-1]


def flap_cells(config: dict) -> int:
    """Cells of the flap (3 x 18 x 1 refined `scale` times an axis)."""
    s = int(config["scale"])
    return 3 * s * 18 * s * s


def tangent_matvec_s(config: dict) -> float:
    """The least time of one Newton tangent matvec (K1) at the
    configuration's shapes."""
    edofs = 3 * (config["params"]["poly_degree"] + 1) ** 3
    return bound_s(*tangent_matvec_work(flap_cells(config), edofs))


def tangent_write_s(config: dict) -> float:
    """The least time of one tangent assembly's write of the per-cell f32
    tangents (bytes once)."""
    edofs = 3 * (config["params"]["poly_degree"] + 1) ** 3
    return bound_s(flap_cells(config) * edofs * edofs * 4, 0)


def vcycle_levels_s(config: dict) -> float:
    """The least time of one V-cycle's Q1 level applications: on each
    smoothed Q1 level a Chebyshev pre-smoothing of degree d from zero, d
    applications, the residual, 1, and the post-smoothing, 1 + d; vectors
    of the configuration's `precond_dtype` read and written once, f32 class
    tables, 27 x 9 FMA a node. The levels are those the configuration asks
    for (`q1_hierarchy`)."""
    p = config["params"]
    s, deg = int(config["scale"]), p["poly_degree"]
    levels, _ = q1_hierarchy((3 * s, 18 * s, s), deg, (0.1, 1.0, 0.3),
                             p["mg_coarse_size"])
    d = p["mg_smooth_degree"]
    io = IO_BYTES[p["precond_dtype"]]
    return sum((2 * d + 2) * bound_s(*stencil_work(shape, io))
               for shape in levels)
