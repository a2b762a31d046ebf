"""VTU (VTK XML UnstructuredGrid) output with higher-order Lagrange cells.

Replaces the deal.II `DataOut` + `MappingQEulerian` +
`write_higher_order_cells` output path of the reference
(`linear_elasticity.cc:590-630`, `nonlinear_elasticity.cc:1215-1250`):

* geometry is written *displaced* (Eulerian): points = X + u
* one VTK_LAGRANGE_QUADRILATERAL / _HEXAHEDRON cell per mesh cell, arbitrary
  degree, points duplicated per cell (patch-per-cell, like DataOut)
* point data: "displacement" vector + the dim*dim small-strain components
  named strain_xx ... (`postprocessor.h:81-97`)

The node-order permutation from this framework's lexicographic local
ordering to VTK's Lagrange ordering implements the published VTK
`PointIndexFromIJK` layout (corners, edges, faces, interior).

A copy of the JAX package's `utils/vtk.py` (host numpy), writing the same
bytes; fields given as tensors are read back to the host.
"""

from __future__ import annotations

import base64
import struct
from functools import lru_cache
from typing import Dict, Optional

import numpy as np

from ..fem.dofspace import DofSpace

VTK_LAGRANGE_QUADRILATERAL = 70
VTK_LAGRANGE_HEXAHEDRON = 72


def _quad_point_index(i, j, p):
    """VTK Lagrange quadrilateral index of the lexicographic node (i, j)."""
    ibdy, jbdy = i in (0, p), j in (0, p)
    if ibdy and jbdy:  # corner: (0,0)->0, (p,0)->1, (p,p)->2, (0,p)->3
        return (1 if i else 0) if not j else (2 if i else 3)
    offset = 4
    if jbdy:  # i-axis edge
        return offset + (i - 1) + ((p - 1) + (p - 1) if j else 0)
    if ibdy:  # j-axis edge
        return offset + (j - 1) + ((p - 1) if i else 2 * (p - 1) + (p - 1))
    offset += 4 * (p - 1)
    return offset + (i - 1) + (p - 1) * (j - 1)


def _hex_point_index(i, j, k, p):
    """VTK Lagrange hexahedron index of the lexicographic node (i, j, k)."""
    ibdy, jbdy, kbdy = i in (0, p), j in (0, p), k in (0, p)
    nbdy = ibdy + jbdy + kbdy
    if nbdy == 3:  # corner
        return ((1 if i else 0) if not j else (2 if i else 3)) + (4 if k else 0)
    offset = 8
    if nbdy == 2:  # edge
        if not ibdy:  # i-axis edge
            return (
                offset
                + (i - 1)
                + ((p - 1) + (p - 1) if j else 0)
                + (2 * ((p - 1) + (p - 1)) if k else 0)
            )
        if not jbdy:  # j-axis edge
            return (
                offset
                + (j - 1)
                + ((p - 1) if i else 2 * (p - 1) + (p - 1))
                + (2 * ((p - 1) + (p - 1)) if k else 0)
            )
        # k-axis edge; VTK hex edge order for the vertical edges is
        # {0,4},{1,5},{3,7},{2,6}, i.e. corner (i,j) -> 0,1,3,2
        offset += 4 * (p - 1) + 4 * (p - 1)
        return offset + (k - 1) + (p - 1) * ((3 if j else 1) if i else (2 if j else 0))
    offset += 4 * ((p - 1) + (p - 1) + (p - 1))
    if nbdy == 1:  # face
        if ibdy:
            return (
                offset
                + (j - 1)
                + (p - 1) * (k - 1)
                + ((p - 1) * (p - 1) if i else 0)
            )
        offset += 2 * (p - 1) * (p - 1)
        if jbdy:
            return (
                offset
                + (i - 1)
                + (p - 1) * (k - 1)
                + ((p - 1) * (p - 1) if j else 0)
            )
        offset += 2 * (p - 1) * (p - 1)
        return (
            offset + (i - 1) + (p - 1) * (j - 1) + ((p - 1) * (p - 1) if k else 0)
        )
    # interior
    offset += 2 * ((p - 1) * (p - 1) + (p - 1) * (p - 1) + (p - 1) * (p - 1))
    return offset + (i - 1) + (p - 1) * ((j - 1) + (p - 1) * (k - 1))


@lru_cache(maxsize=None)
def vtk_lagrange_perm(degree: int, dim: int) -> np.ndarray:
    """perm such that `conn_vtk[v] = lex_node perm_inv...`; concretely
    returns an array `lex_of_vtk` with `lex_of_vtk[vtk_index] = lex_index`,
    ready to index a cell's lexicographically-ordered point block."""
    p = degree
    p1 = p + 1
    n = p1**dim
    vtk_of_lex = np.empty(n, dtype=np.int64)
    if dim == 2:
        for j in range(p1):
            for i in range(p1):
                vtk_of_lex[i + p1 * j] = _quad_point_index(i, j, p)
    else:
        for k in range(p1):
            for j in range(p1):
                for i in range(p1):
                    vtk_of_lex[i + p1 * (j + p1 * k)] = _hex_point_index(i, j, k, p)
    assert sorted(vtk_of_lex) == list(range(n)), "VTK permutation is not a bijection"
    lex_of_vtk = np.empty(n, dtype=np.int64)
    lex_of_vtk[vtk_of_lex] = np.arange(n)
    return lex_of_vtk


def _b64(arr: np.ndarray) -> str:
    """The UInt64 byte-count header and the raw bytes, base64-encoded (the
    JAX package's plain path; its C++ encoder is not ported)."""
    raw = arr.tobytes()
    payload = struct.pack("<Q", len(raw)) + raw
    return base64.b64encode(payload).decode("ascii")


def _host(x) -> np.ndarray:
    """A float64 numpy copy of an array or a tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().to("cpu").double().numpy()
    return np.asarray(x, dtype=np.float64)


def _data_array(name: str, arr: np.ndarray, n_comp: Optional[int] = None) -> str:
    typemap = {
        np.dtype(np.float64): "Float64",
        np.dtype(np.float32): "Float32",
        np.dtype(np.int64): "Int64",
        np.dtype(np.int32): "Int32",
        np.dtype(np.uint8): "UInt8",
    }
    vtype = typemap[arr.dtype]
    comp = f' NumberOfComponents="{n_comp}"' if n_comp else ""
    return (
        f'<DataArray type="{vtype}" Name="{name}"{comp} format="binary">\n'
        f"{_b64(np.ascontiguousarray(arr))}\n</DataArray>\n"
    )


def write_vtu(
    path: str,
    space: DofSpace,
    displacement,
    extra_point_data: Optional[Dict[str, np.ndarray]] = None,
    displaced: bool = True,
    strain: bool = True,
) -> str:
    """Write one VTU time snapshot; returns `path`.

    `displacement` is the (n_nodes, dim) field; `extra_point_data` maps
    name -> (n_nodes, c) nodal arrays to include (e.g. velocity). Fields
    may be numpy arrays or tensors on any device (read back to the host).
    """
    u = _host(displacement)
    dim = space.dim
    cells = space.cells
    n_cells, npc = cells.shape
    degree = space.mesh.degree

    # patch-per-cell points, displaced geometry (MappingQEulerian analog)
    X = space.mesh.nodes[cells]  # (c, npc, dim)
    if displaced:
        X = X + u[cells]
    pts3 = np.zeros((n_cells, npc, 3))
    pts3[:, :, :dim] = X

    lex_of_vtk = vtk_lagrange_perm(degree, dim)
    conn = (
        np.arange(n_cells)[:, None] * npc + lex_of_vtk[None, :]
    ).astype(np.int64)
    offsets = (np.arange(1, n_cells + 1) * npc).astype(np.int64)
    ctype = VTK_LAGRANGE_QUADRILATERAL if dim == 2 else VTK_LAGRANGE_HEXAHEDRON
    types = np.full(n_cells, ctype, dtype=np.uint8)

    # point data (duplicated per cell like the geometry)
    u3 = np.zeros((n_cells, npc, 3))
    u3[:, :, :dim] = u[cells]
    point_arrays = [("displacement", u3.reshape(-1, 3), 3)]
    if strain:
        from .postprocessor import compute_nodal_strain

        eps = compute_nodal_strain(space, u)  # (c, npc, dim, dim)
        suffix = "xyz"
        for d in range(dim):
            for e in range(dim):
                point_arrays.append(
                    (f"strain_{suffix[d]}{suffix[e]}", eps[:, :, d, e].reshape(-1), None)
                )
    for name, arr in (extra_point_data or {}).items():
        arr = _host(arr)
        if arr.ndim == 2 and arr.shape[1] == dim:
            a3 = np.zeros((n_cells, npc, 3))
            a3[:, :, :dim] = arr[cells]
            point_arrays.append((name, a3.reshape(-1, 3), 3))
        else:
            point_arrays.append((name, arr[cells].reshape(-1), None))

    n_points = n_cells * npc
    parts = [
        '<?xml version="1.0"?>\n'
        '<VTKFile type="UnstructuredGrid" version="2.2" '
        'byte_order="LittleEndian" header_type="UInt64">\n'
        "<UnstructuredGrid>\n"
        f'<Piece NumberOfPoints="{n_points}" NumberOfCells="{n_cells}">\n'
    ]
    parts.append("<Points>\n")
    parts.append(_data_array("Points", pts3.reshape(-1, 3), 3))
    parts.append("</Points>\n<Cells>\n")
    parts.append(_data_array("connectivity", conn.reshape(-1)))
    parts.append(_data_array("offsets", offsets))
    parts.append(_data_array("types", types))
    parts.append("</Cells>\n")
    parts.append('<PointData Vectors="displacement">\n')
    for name, arr, nc in point_arrays:
        parts.append(_data_array(name, arr, nc))
    parts.append("</PointData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")

    with open(path, "w") as fh:
        fh.write("".join(parts))
    return path
