"""Strain postprocessing for output.

Equivalent of the reference's `Postprocessor<dim>::evaluate_vector_field`
(`source/linear_elasticity/include/postprocessor.h:45-76`, duplicated at
`source/nonlinear_elasticity/include/postprocessor.h`): the small-strain
tensor eps = sym(grad u) evaluated per cell at the element's support
points. Like deal.II `DataOut`, output geometry is patch-per-cell, so the
strain field may be discontinuous across cell boundaries — values are
reported per (cell, node) pair.

A copy of the JAX package's `utils/postprocessor.py` (host numpy).
"""

from __future__ import annotations

import numpy as np

from ..fem.dofspace import DofSpace
from ..fem.tabulation import _tabulate_at


def _nodal_gradient_matrix(space: DofSpace) -> np.ndarray:
    """(npc, npc, dim) reference gradients of all shape functions at the
    support points, scaled to physical coordinates."""
    tab = space.tab
    _, dN = _tabulate_at(tab.nodes, tab.support_1d, space.dim)
    h = np.asarray(space.mesh.cell_h, dtype=np.float64)
    return dN / h[None, None, :]  # (n_pts=npc, n_shape=npc, dim)


def compute_nodal_strain(space: DofSpace, u: np.ndarray) -> np.ndarray:
    """Per-cell nodal strain: (n_cells, npc, dim, dim) with
    eps = 0.5 (grad u + grad u^T) evaluated at each local support point."""
    G = _nodal_gradient_matrix(space)  # (npc_pts, npc_shape, dim)
    ucell = np.asarray(u)[space.cells]  # (c, npc, dim)
    grad = np.einsum("cnd,pne->cpde", ucell, G)  # (c, p, dim, dim)
    return 0.5 * (grad + np.swapaxes(grad, -1, -2))
