"""DoF management for vector-valued Lagrange spaces on structured meshes.

Replaces the deal.II DoFHandler capabilities used by the reference:
  * boundary-DoF extraction per component and boundary id
    (`adapter.h:247-276`, via IndexSets)
  * boundary DoF -> support-point coordinates
    (`dof_tools_extension.h:18-75`)
  * Dirichlet masks for clamped / out-of-plane-clamped boundaries
    (`linear_elasticity.cc:429-451`, `nonlinear_elasticity.cc:1094-1150`)

Fields are stored as (n_nodes, dim) arrays (node-major). The global "DoF
index" of (node, component) is node*dim + component, but all kernels work
on the 2D layout directly.

The scatter of per-cell values back into global nodal vectors is done with
a precomputed **transpose-gather plan**: for every global node we store the
(<= max_valence) flattened positions of its appearances in the
(n_cells * nodes_per_cell) cell-local value array, padded with an index
pointing at a zero sentinel row. The scatter then becomes a dense gather +
fixed-width sum — no atomic/scatter traffic on TPU, fully deterministic.
This is the performance crux replacing deal.II sparse assembly
(SURVEY.md section 7, "hard parts").
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Tuple

import numpy as np

from .tabulation import Tabulation, tabulate

if TYPE_CHECKING:  # type-only; avoids a circular import with mesh.generator
    from ..mesh.generator import StructuredMesh


def build_transpose_gather_plan(
    cells: np.ndarray, n_nodes: int
) -> Tuple[np.ndarray, int]:
    """Build the (n_nodes, max_valence) plan indexing into the flattened
    (n_cells * nodes_per_cell + 1) cell-value array; the final sentinel row
    is zero. Returns (plan, sentinel_index).

    O(n log n) numpy construction. The structured operators never read the
    plan; only host-side setup (body-force weights) does."""
    n_cells, npc = cells.shape
    flat_nodes = cells.ravel().astype(np.int64)
    order = np.argsort(flat_nodes, kind="stable")
    sorted_nodes = flat_nodes[order]
    counts = np.bincount(sorted_nodes, minlength=n_nodes)
    max_val = int(counts.max()) if counts.size else 1
    sentinel = n_cells * npc
    plan = np.full((n_nodes, max_val), sentinel, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # position of each occurrence within its node's group
    pos_in_group = np.arange(len(sorted_nodes)) - starts[sorted_nodes]
    plan[sorted_nodes, pos_in_group] = order
    return plan, sentinel


@dataclasses.dataclass
class DofSpace:
    """Vector-valued Q_degree space on a StructuredMesh.

    Holds the tabulation, connectivity/scatter plans, boundary node sets and
    Dirichlet masks. All members are host numpy; operators convert to device
    arrays once.
    """

    mesh: "StructuredMesh"
    tab: Tabulation
    cells: np.ndarray  # (n_cells, npc) int32
    plan: np.ndarray  # (n_nodes, max_valence) transpose-gather plan
    plan_sentinel: int
    boundary_nodes: Dict[int, np.ndarray]  # boundary id -> sorted node ids

    @classmethod
    def create(cls, mesh: "StructuredMesh", n_q_1d: int | None = None) -> "DofSpace":
        tab = tabulate(mesh.dim, mesh.degree, n_q_1d or mesh.degree + 1)
        plan, sentinel = build_transpose_gather_plan(mesh.cells, mesh.n_nodes)
        boundary_nodes = {}
        for bid, faces in mesh.boundary_faces.items():
            ids = np.unique(
                mesh.cells[faces[:, 0][:, None], tab.face_nodes[faces[:, 1]]]
            )
            boundary_nodes[bid] = ids.astype(np.int64)
        return cls(
            mesh=mesh,
            tab=tab,
            cells=mesh.cells,
            plan=plan,
            plan_sentinel=sentinel,
            boundary_nodes=boundary_nodes,
        )

    # --- basic queries ----------------------------------------------------

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def n_nodes(self) -> int:
        return self.mesh.n_nodes

    @property
    def n_dofs(self) -> int:
        return self.mesh.n_nodes * self.mesh.dim

    def boundary_node_coords(self, bid: int) -> np.ndarray:
        """Support-point coordinates of the nodes on boundary `bid` —
        the capability of `DoFTools::map_boundary_dofs_to_support_points`
        (`dof_tools_extension.h:18-75`). Ordered by ascending node id, which
        matches the reference's IndexSet iteration order
        (`adapter.h:312-321`) for the same lexicographic numbering."""
        return self.mesh.nodes[self.boundary_nodes[bid]]

    def dirichlet_mask(
        self, clamped_id: int, out_of_plane_id: int | None = None
    ) -> np.ndarray:
        """(n_nodes, dim) float mask: 0 where the DoF is Dirichlet-fixed,
        1 elsewhere. Clamped boundary fixes all components
        (`linear_elasticity.cc:431-435`); the out-of-plane boundary fixes
        only the z component in 3D (`linear_elasticity.cc:436-446`)."""
        mask = np.ones((self.n_nodes, self.dim))
        if clamped_id in self.boundary_nodes:
            mask[self.boundary_nodes[clamped_id], :] = 0.0
        if self.dim == 3 and out_of_plane_id is not None:
            if out_of_plane_id in self.boundary_nodes:
                mask[self.boundary_nodes[out_of_plane_id], 2] = 0.0
        return mask

    def interface_faces(self, interface_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """(faces, face_node_ids): faces is (n_if, 2) of (cell, local_face);
        face_node_ids is (n_if, nodes_per_face) global node ids in the
        face-local lexicographic order of `tab.face_nodes`."""
        faces = self.mesh.boundary_faces[interface_id]
        fnodes = self.cells[faces[:, 0][:, None], self.tab.face_nodes[faces[:, 1]]]
        return faces, fnodes.astype(np.int64)
