"""Reference-element tabulations for tensor-product Lagrange elements.

TPU-native equivalent of the capabilities consumed from deal.II's
`FE_Q`/`FESystem` + `QGauss` + `FEValues` on the reference code path
(`linear_elasticity.cc:59-61`, `nonlinear_elasticity.cc:68-75`): we
precompute (in numpy, at setup time) the values and gradients of all scalar
shape functions of a Q_p element at all Gauss quadrature points, for cells
and faces. Everything downstream consumes these as dense constant matrices,
which is exactly what batched MXU matmuls want.

Conventions:
  * reference element is [0,1]^dim
  * 1D support points are Gauss-Lobatto (like deal.II FE_Q for degree >= 2),
    so nodal coordinates and interface vertex positions match the reference
  * local (and global) node ordering is lexicographic, x fastest
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np


def gauss_legendre(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1] (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto_points(degree: int) -> np.ndarray:
    """The degree+1 Gauss-Lobatto-Legendre points on [0, 1], sorted.

    These are the 1D support points of deal.II's FE_Q (degree >= 2); for
    degree 1 they reduce to the endpoints.
    """
    if degree == 0:
        return np.array([0.5])
    if degree == 1:
        return np.array([0.0, 1.0])
    # Interior GLL points are the roots of P'_degree (Legendre derivative).
    coeffs = np.zeros(degree + 1)
    coeffs[degree] = 1.0
    interior = np.polynomial.legendre.legroots(np.polynomial.legendre.legder(coeffs))
    pts = np.concatenate(([-1.0], interior, [1.0]))
    return 0.5 * (np.sort(pts) + 1.0)


def lagrange_basis(nodes: np.ndarray, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate 1D Lagrange basis through `nodes` at points `x`.

    Returns (values, derivatives), each of shape (len(x), len(nodes)).
    Uses the direct product formula in float64; fine for the moderate
    degrees (<= ~10) this framework targets.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    vals = np.ones((len(x), n))
    ders = np.zeros((len(x), n))
    for i in range(n):
        others = [j for j in range(n) if j != i]
        denom = np.prod(nodes[i] - nodes[others])
        # value
        num = np.ones_like(x)
        for j in others:
            num = num * (x - nodes[j])
        vals[:, i] = num / denom
        # derivative: sum over k of prod_{j != i,k} (x - x_j)
        dnum = np.zeros_like(x)
        for k in others:
            term = np.ones_like(x)
            for j in others:
                if j != k:
                    term = term * (x - nodes[j])
            dnum = dnum + term
        ders[:, i] = dnum / denom
    return vals, ders


def _tensor_indices(degree: int, dim: int) -> np.ndarray:
    """Lexicographic multi-indices (x fastest) of the (degree+1)^dim nodes."""
    p1 = degree + 1
    rng = np.arange(p1)
    if dim == 1:
        return rng[:, None]
    if dim == 2:
        iy, ix = np.meshgrid(rng, rng, indexing="ij")
        return np.stack([ix.ravel(), iy.ravel()], axis=1)
    iz, iy, ix = np.meshgrid(rng, rng, rng, indexing="ij")
    return np.stack([ix.ravel(), iy.ravel(), iz.ravel()], axis=1)


@dataclasses.dataclass(frozen=True)
class Tabulation:
    """Constant reference-element data for a Q_degree element in `dim` D.

    Attributes (all numpy float64):
      support_1d:   (degree+1,) 1D GLL support points on [0,1]
      nodes:        (n_nodes_per_cell, dim) reference coords of local nodes
      q_points:     (n_q, dim) cell quadrature points on [0,1]^dim
      q_weights:    (n_q,)
      N:            (n_q, n_nodes) shape values at cell quadrature points
      dN:           (n_q, n_nodes, dim) reference gradients at cell q-points
      face_q_points:(n_faces, n_qf, dim) volume coords of face q-points
      face_q_weights:(n_qf,) face quadrature weights (reference measure 1)
      face_N:       (n_faces, n_qf, n_nodes) volume shape values at face qps
      face_dN:      (n_faces, n_qf, n_nodes, dim) volume shape gradients
      face_nodes:   (n_faces, n_nodes_per_face) local node ids of each face
      face_normal_ref: (n_faces, dim) outward unit normals in ref config
    Face ordering: face f = 2*axis + side (side 0: coord=0, side 1: coord=1),
    matching the deal.II colorize boundary-id convention used by
    `GridGenerator::subdivided_hyper_rectangle` (`linear_elasticity.cc:143-147`).
    """

    dim: int
    degree: int
    n_q_1d: int
    support_1d: np.ndarray
    nodes: np.ndarray
    q_points: np.ndarray
    q_weights: np.ndarray
    N: np.ndarray
    dN: np.ndarray
    face_q_weights: np.ndarray
    face_N: np.ndarray
    face_dN: np.ndarray
    face_nodes: np.ndarray
    face_normal_ref: np.ndarray

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_faces(self) -> int:
        return 2 * self.dim

    @property
    def n_nodes_per_face(self) -> int:
        return (self.degree + 1) ** (self.dim - 1)


def _tabulate_at(points: np.ndarray, support: np.ndarray, dim: int):
    """Shape values/gradients of the tensor-product basis at `points`.

    points: (n_pts, dim). Returns N (n_pts, n_nodes), dN (n_pts, n_nodes, dim).
    """
    degree = len(support) - 1
    idx = _tensor_indices(degree, dim)  # (n_nodes, dim)
    vals_d, ders_d = [], []
    for d in range(dim):
        v, g = lagrange_basis(support, points[:, d])
        vals_d.append(v)  # (n_pts, degree+1)
        ders_d.append(g)
    n_nodes = idx.shape[0]
    n_pts = points.shape[0]
    N = np.ones((n_pts, n_nodes))
    for d in range(dim):
        N = N * vals_d[d][:, idx[:, d]]
    dN = np.zeros((n_pts, n_nodes, dim))
    for dd in range(dim):
        g = np.ones((n_pts, n_nodes))
        for d in range(dim):
            fac = ders_d[d] if d == dd else vals_d[d]
            g = g * fac[:, idx[:, d]]
        dN[:, :, dd] = g
    return N, dN


@lru_cache(maxsize=None)
def tabulate(dim: int, degree: int, n_q_1d: int) -> Tabulation:
    """Build the full tabulation for a Q_degree element with an
    n_q_1d-point Gauss rule per direction (reference uses degree+1 for the
    linear solver, degree+2 for the nonlinear one; `linear_elasticity.cc:61`,
    `nonlinear_elasticity.cc:74-75`)."""
    assert dim in (2, 3)
    support = gauss_lobatto_points(degree)
    idx = _tensor_indices(degree, dim)
    nodes = support[idx]  # (n_nodes, dim)

    q1, w1 = gauss_legendre(n_q_1d)
    # cell quadrature: tensor product, lexicographic with x fastest (same
    # convention as _tensor_indices)
    if dim == 2:
        qy, qx = np.meshgrid(q1, q1, indexing="ij")
        q_points = np.stack([qx.ravel(), qy.ravel()], axis=1)
        wy, wx = np.meshgrid(w1, w1, indexing="ij")
        q_weights = (wx * wy).ravel()
    else:
        qz, qy, qx = np.meshgrid(q1, q1, q1, indexing="ij")
        q_points = np.stack([qx.ravel(), qy.ravel(), qz.ravel()], axis=1)
        wz, wy, wx = np.meshgrid(w1, w1, w1, indexing="ij")
        q_weights = (wx * wy * wz).ravel()

    N, dN = _tabulate_at(q_points, support, dim)

    # faces: f = 2*axis + side
    n_faces = 2 * dim
    if dim == 2:
        fq1 = q1[:, None]  # (n_qf, 1)
        fw = w1
    else:
        fqy, fqx = np.meshgrid(q1, q1, indexing="ij")
        fq1 = np.stack([fqx.ravel(), fqy.ravel()], axis=1)  # (n_qf, 2)
        fwy, fwx = np.meshgrid(w1, w1, indexing="ij")
        fw = (fwx * fwy).ravel()
    n_qf = fq1.shape[0]

    face_N = np.zeros((n_faces, n_qf, nodes.shape[0]))
    face_dN = np.zeros((n_faces, n_qf, nodes.shape[0], dim))
    face_nodes = np.zeros((n_faces, (degree + 1) ** (dim - 1)), dtype=np.int64)
    face_normal_ref = np.zeros((n_faces, dim))
    for axis in range(dim):
        tang = [d for d in range(dim) if d != axis]
        for side in range(2):
            f = 2 * axis + side
            pts = np.zeros((n_qf, dim))
            pts[:, axis] = float(side)
            for t, d in enumerate(tang):
                pts[:, d] = fq1[:, t]
            fN, fdN = _tabulate_at(pts, support, dim)
            face_N[f] = fN
            face_dN[f] = fdN
            face_normal_ref[f, axis] = -1.0 if side == 0 else 1.0
            # local node ids on this face, lexicographic in the tangential dims
            on_face = idx[:, axis] == (0 if side == 0 else degree)
            ids = np.nonzero(on_face)[0]
            # sort lexicographically by (tang[-1], ..., tang[0]) with tang[0] fastest
            key = np.zeros(len(ids))
            mult = 1
            for d in tang:
                key = key + idx[ids, d] * mult
                mult *= degree + 1
            face_nodes[f] = ids[np.argsort(key, kind="stable")]

    return Tabulation(
        dim=dim,
        degree=degree,
        n_q_1d=n_q_1d,
        support_1d=support,
        nodes=nodes,
        q_points=q_points,
        q_weights=q_weights,
        N=N,
        dN=dN,
        face_q_weights=fw,
        face_N=face_N,
        face_dN=face_dN,
        face_nodes=face_nodes,
        face_normal_ref=face_normal_ref,
    )
