"""Structured quad/hex mesh generation with boundary colorization.

TPU-native replacement for the `GridGenerator::subdivided_hyper_rectangle`
use in the reference (`linear_elasticity.cc:143-147`,
`nonlinear_elasticity.cc:237-241`): the mesh is a set of index arrays (no
pointer-based triangulation) — node coordinates, dense cell->node
connectivity, and boundary-face lists tagged with colorized boundary ids
(id = 2*axis + side, deal.II convention).

The scenario geometry and boundary-ID rewrite of the reference's
`make_grid()` (`linear_elasticity.cc:79-188`, `nonlinear_elasticity.cc:171-301`)
is reproduced in :func:`make_scenario_grid`:

  FSI3 (Turek-Hron):  18x3(x1) cells, box (0.24899,0.19[,-0.005]) ..
                      (0.6,0.21[,0.005]); interface = {y_min, y_max, x_max},
                      clamped = x_min
  PF (perpendicular flap): 3x18(x1) cells, box (loc-0.05,0[,0]) ..
                      (loc+0.05,1[,0.3]); interface = {x_min, x_max, y_max},
                      clamped = y_min
  z faces (3D) are clamped out-of-plane in both scenarios.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from ..fem.tabulation import gauss_lobatto_points

# Boundary-ID conventions of the two reference solvers: the linear solver
# uses interface=6, clamped=0, out-of-plane=4 (`linear_elasticity.cc:57,157-158`);
# the nonlinear one uses interface=7, clamped=1, out-of-plane=8
# (`nonlinear_elasticity.cc:78`, `nonlinear_elasticity.h:256-257`).
LINEAR_IDS = dict(interface=6, clamped=0, out_of_plane=4)
NONLINEAR_IDS = dict(interface=7, clamped=1, out_of_plane=8)


@dataclasses.dataclass
class StructuredMesh:
    """A structured tensor-product Q_degree mesh of an axis-aligned box.

    All arrays are numpy (host-side setup data); device arrays are derived
    from them by the operator setup.

    Attributes:
      dim, degree:   spatial dimension and polynomial degree
      reps:          cells per axis, length dim
      p0, p1:        box corners
      axis_coords:   per-axis node coordinates (list of 1D arrays,
                     length reps[d]*degree + 1, GLL-spaced within each cell)
      nodes:         (n_nodes, dim) node coordinates, lexicographic (x fastest)
      cells:         (n_cells, (degree+1)^dim) int32 connectivity,
                     local nodes lexicographic (x fastest)
      cell_h:        (dim,) cell edge lengths (uniform by construction)
      boundary_faces: dict boundary_id -> (n_faces, 2) int32 array of
                     (cell_index, local_face) pairs; local face = 2*axis+side
    """

    dim: int
    degree: int
    reps: Tuple[int, ...]
    p0: np.ndarray
    p1: np.ndarray
    axis_coords: Tuple[np.ndarray, ...]
    nodes: np.ndarray
    cells: np.ndarray
    cell_h: np.ndarray
    boundary_faces: Dict[int, np.ndarray]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_dofs(self) -> int:
        return self.n_nodes * self.dim

    def relabel_boundaries(self, mapping: Dict[int, int]) -> "StructuredMesh":
        """Rewrite boundary ids (the reference's face->set_boundary_id loop,
        `linear_elasticity.cc:171-187`). Faces with ids not in `mapping`
        keep their id; target ids are merged."""
        new: Dict[int, np.ndarray] = {}
        for bid, faces in self.boundary_faces.items():
            tgt = mapping.get(bid, bid)
            new.setdefault(tgt, []).append(faces)
        merged = {bid: np.concatenate(fs, axis=0) for bid, fs in new.items()}
        return dataclasses.replace(self, boundary_faces=merged)


def subdivided_hyper_rectangle(
    reps: Sequence[int],
    p0: Sequence[float],
    p1: Sequence[float],
    degree: int = 1,
) -> StructuredMesh:
    """Generate a colorized structured mesh of the box [p0, p1].

    Equivalent capability to `GridGenerator::subdivided_hyper_rectangle`
    with colorize=true, fused with DoF distribution for a Q_degree
    vector-valued Lagrange space: nodes are the tensor grid of per-cell
    Gauss-Lobatto points, so nodal positions coincide with deal.II FE_Q
    support points.
    """
    reps = tuple(int(r) for r in reps)
    dim = len(reps)
    assert dim in (2, 3)
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    gll = gauss_lobatto_points(degree)  # on [0,1]

    # per-axis node coordinates: reps[d] cells, GLL points inside each
    axis_coords = []
    h = (p1 - p0) / np.asarray(reps)
    for d in range(dim):
        xs = [p0[d] + (c + gll[:-1]) * h[d] for c in range(reps[d])]
        coords = np.concatenate(xs + [[p1[d]]])
        axis_coords.append(coords)

    n_ax = [reps[d] * degree + 1 for d in range(dim)]  # nodes per axis

    # global nodes, lexicographic x fastest
    if dim == 2:
        Y, X = np.meshgrid(axis_coords[1], axis_coords[0], indexing="ij")
        nodes = np.stack([X.ravel(), Y.ravel()], axis=1)
    else:
        Z, Y, X = np.meshgrid(
            axis_coords[2], axis_coords[1], axis_coords[0], indexing="ij"
        )
        nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def node_id(ix, iy, iz=None):
        if dim == 2:
            return ix + n_ax[0] * iy
        return ix + n_ax[0] * (iy + n_ax[1] * iz)

    # cells, lexicographic x fastest; local nodes lexicographic x fastest
    p1d = degree + 1
    loc = np.arange(p1d)
    if dim == 2:
        cx = np.arange(reps[0])
        cy = np.arange(reps[1])
        CY, CX = np.meshgrid(cy, cx, indexing="ij")
        base_x = (CX.ravel() * degree)[:, None, None]  # (n_cells,1,1)
        base_y = (CY.ravel() * degree)[:, None, None]
        ly, lx = np.meshgrid(loc, loc, indexing="ij")
        lx = lx.ravel()[None, :]
        ly = ly.ravel()[None, :]
        cells = node_id(base_x[:, 0] + lx, base_y[:, 0] + ly)
    else:
        cx = np.arange(reps[0])
        cy = np.arange(reps[1])
        cz = np.arange(reps[2])
        CZ, CY, CX = np.meshgrid(cz, cy, cx, indexing="ij")
        bx = (CX.ravel() * degree)[:, None]
        by = (CY.ravel() * degree)[:, None]
        bz = (CZ.ravel() * degree)[:, None]
        lz, ly, lx = np.meshgrid(loc, loc, loc, indexing="ij")
        lx = lx.ravel()[None, :]
        ly = ly.ravel()[None, :]
        lz = lz.ravel()[None, :]
        cells = node_id(bx + lx, by + ly, bz + lz)
    cells = cells.astype(np.int32)

    # boundary faces with colorize ids: id = 2*axis + side
    def cell_index(icell):
        # icell: integer arrays per axis
        if dim == 2:
            return icell[0] + reps[0] * icell[1]
        return icell[0] + reps[0] * (icell[1] + reps[1] * icell[2])

    boundary_faces: Dict[int, np.ndarray] = {}
    for axis in range(dim):
        other = [d for d in range(dim) if d != axis]
        grids = np.meshgrid(*[np.arange(reps[d]) for d in other], indexing="ij")
        flat = [g.ravel() for g in grids]
        n_f = flat[0].size if flat else 1
        for side in range(2):
            idx = [None] * dim
            for t, d in enumerate(other):
                idx[d] = flat[t]
            idx[axis] = np.full(n_f, 0 if side == 0 else reps[axis] - 1)
            ci = cell_index(idx)
            bid = 2 * axis + side
            lf = np.full(n_f, 2 * axis + side, dtype=np.int32)
            boundary_faces[bid] = np.stack([ci.astype(np.int32), lf], axis=1)

    return StructuredMesh(
        dim=dim,
        degree=degree,
        reps=reps,
        p0=p0,
        p1=p1,
        axis_coords=tuple(axis_coords),
        nodes=nodes,
        cells=cells,
        cell_h=h,
        boundary_faces=boundary_faces,
    )


def make_scenario_grid(
    scenario: str,
    dim: int,
    degree: int,
    flap_location: float = 0.0,
    ids: Dict[int, int] | None = None,
    refine: int = 0,
    solver: str = "linear",
    scale: int = 1,
) -> Tuple[StructuredMesh, Dict[str, int]]:
    """Build the FSI3 or PF flap grid with the reference's boundary-ID
    semantics (`linear_elasticity.cc:79-188`, `nonlinear_elasticity.cc:171-301`).

    `refine` multiplies the cell count per axis by 2**refine (the reference
    hardcodes global_refinement = 0 at `linear_elasticity.cc:150`; we expose
    it as the resolution-scaling axis for benchmarks).

    Returns (mesh, id_dict) where id_dict has keys
    interface / clamped / out_of_plane.
    """
    tags = dict(LINEAR_IDS if solver == "linear" else NONLINEAR_IDS)
    if scenario == "FSI3":
        n = (18, 3, 1)
        p0 = (0.24899, 0.19, -0.005)
        p1 = (0.6, 0.21, 0.005)
        # colorize ids: long faces are y (ids 2,3), short are x (ids 0,1)
        id_long_bottom, id_long_top = 2, 3
        id_short_bottom, id_short_top = 0, 1
    elif scenario == "PF":
        n = (3, 18, 1)
        p0 = (flap_location - 0.05, 0.0, 0.0)
        p1 = (flap_location + 0.05, 1.0, 0.3)
        id_long_bottom, id_long_top = 0, 1
        id_short_bottom, id_short_top = 2, 3
    else:
        raise ValueError(f"Unknown scenario '{scenario}' (use 'FSI3' or 'PF')")

    factor = (2 ** refine) * scale  # `scale` = linear resolution multiplier
    reps = tuple(ni * factor for ni in n[:dim])
    mesh = subdivided_hyper_rectangle(reps, p0[:dim], p1[:dim], degree)

    mapping = {
        id_short_top: tags["interface"],
        id_long_bottom: tags["interface"],
        id_long_top: tags["interface"],
        id_short_bottom: tags["clamped"],
    }
    if dim == 3:
        mapping[4] = tags["out_of_plane"]
        mapping[5] = tags["out_of_plane"]
    mesh = mesh.relabel_boundaries(mapping)
    # raw colorize ids of the Dirichlet faces, for rebuilding equivalent
    # masks on coarser un-relabeled meshes (multigrid levels)
    tags["clamped_raw_ids"] = [id_short_bottom]
    tags["oop_raw_ids"] = [4, 5] if dim == 3 else []
    return mesh, tags
