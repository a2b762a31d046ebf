"""Continuous Lagrange elements of degree p on the flap's lattice of
equal axis-aligned hexahedra, in plain PyTorch and NumPy.

Nodes per cell are the tensor grid of the p + 1 Gauss-Lobatto points
(deal.II's FE_Q support points). Global nodes are numbered on the node
lattice with x fastest, then y, then z: the order of the (n_nodes, 3)
fields that the solid reads and writes. Integrals use the tensor Gauss
rule of `n_q` points per axis. Vectors are (n_nodes, 3) tensors; cell
loops run in blocks of cells so that the work fits beside the program.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_CELLS = 1024  # cells per block of the element loops


def gauss_lobatto(p: int) -> np.ndarray:
    """The p + 1 Gauss-Lobatto points on [0, 1]: the ends and the roots of
    the derivative of the Legendre polynomial of degree p."""
    inner = np.polynomial.legendre.Legendre.basis(p).deriv().roots().real
    x = np.concatenate([[-1.0], np.sort(inner), [1.0]])
    return 0.5 * (x + 1.0)


def gauss(n: int):
    """The n-point Gauss rule on [0, 1]: (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def lagrange(nodes: np.ndarray, x: np.ndarray):
    """Values and derivatives of the Lagrange polynomials on `nodes` at
    the points `x`: two (len(x), len(nodes)) arrays."""
    n = len(nodes)
    val = np.ones((len(x), n))
    der = np.zeros((len(x), n))
    for j in range(n):
        others = [k for k in range(n) if k != j]
        for k in others:
            val[:, j] *= (x - nodes[k]) / (nodes[j] - nodes[k])
        for m in others:
            term = np.full(len(x), 1.0 / (nodes[j] - nodes[m]))
            for k in others:
                if k != m:
                    term *= (x - nodes[k]) / (nodes[j] - nodes[k])
            der[:, j] += term
    return val, der


def tensor_basis(p: int, pts: list, h: np.ndarray):
    """Shape values (n_pts, npc) and physical gradients (n_pts, npc, 3) of
    the cell's (p + 1)^3 nodes (x fastest) at the tensor points
    pts = [x-points, y-points, z-points] (on [0, 1], z slowest), for a
    cell of edge lengths h."""
    nodes = gauss_lobatto(p)
    v, d = zip(*(lagrange(nodes, q) for q in pts))
    # point (qz, qy, qx), node (kz, ky, kx)
    N = np.einsum("ak,bj,ci->cbaijk", v[0], v[1], v[2])
    Gx = np.einsum("ak,bj,ci->cbaijk", d[0], v[1], v[2]) / h[0]
    Gy = np.einsum("ak,bj,ci->cbaijk", v[0], d[1], v[2]) / h[1]
    Gz = np.einsum("ak,bj,ci->cbaijk", v[0], v[1], d[2]) / h[2]
    n_pts = len(pts[0]) * len(pts[1]) * len(pts[2])
    # (qz, qy, qx, kz, ky, kx) -> (q, node), x fastest in both
    N = N.reshape(n_pts, -1)
    G = np.stack([g.reshape(n_pts, -1) for g in (Gx, Gy, Gz)], axis=-1)
    return N, G


class Lattice:
    """The flap's hexahedral lattice: `reps` cells per axis on the box
    [p0, p1], Q_p nodes. Holds the connectivity, the node sets of the
    boundaries and the Dirichlet mask, as tensors on `device`."""

    def __init__(self, reps, p0, p1, p: int, device):
        self.reps = tuple(int(r) for r in reps)
        self.p0 = np.asarray(p0, dtype=np.float64)
        self.p1 = np.asarray(p1, dtype=np.float64)
        self.p = int(p)
        self.device = torch.device(device)
        self.h = (self.p1 - self.p0) / np.asarray(self.reps)
        self.shape = tuple(r * p + 1 for r in self.reps)  # nodes per axis
        nx, ny, nz = self.shape
        self.n_nodes = nx * ny * nz
        gll = gauss_lobatto(p)
        self.axis_coords = [
            np.concatenate([self.p0[a] + (c + gll[:-1]) * self.h[a]
                            for c in range(self.reps[a])] + [[self.p1[a]]])
            for a in range(3)]
        # cells (x fastest), each with its nodes (x fastest)
        cx, cy, cz = (np.arange(r) * p for r in self.reps)
        k = np.arange(p + 1)
        base = (cx[None, None, :] + nx * (cy[None, :, None]
                                          + ny * cz[:, None, None]))
        local = (k[None, None, :] + nx * (k[None, :, None]
                                          + ny * k[:, None, None]))
        self.cells = torch.as_tensor(
            (base.reshape(-1, 1) + local.reshape(1, -1)), device=self.device)
        self.n_cells = self.cells.shape[0]

    def node_ids(self, ix=None, iy=None, iz=None) -> np.ndarray:
        """Ascending ids of the nodes whose lattice indices match the given
        ones (None: any)."""
        nx, ny, nz = self.shape
        x = np.arange(nx) if ix is None else np.atleast_1d(ix)
        y = np.arange(ny) if iy is None else np.atleast_1d(iy)
        z = np.arange(nz) if iz is None else np.atleast_1d(iz)
        ids = x[None, None, :] + nx * (y[None, :, None] + ny * z[:, None, None])
        return np.unique(ids.ravel())

    def coords(self) -> np.ndarray:
        """(n_nodes, 3) node coordinates."""
        X, Y, Z = self.axis_coords
        g = np.meshgrid(Z, Y, X, indexing="ij")
        return np.stack([g[2].ravel(), g[1].ravel(), g[0].ravel()], axis=1)

    def vector(self, dtype=torch.float64) -> torch.Tensor:
        return torch.zeros((self.n_nodes, 3), dtype=dtype, device=self.device)

    def cell_loop(self, fn, u: torch.Tensor, *more: torch.Tensor) -> torch.Tensor:
        """Sum into the nodes of fn(cell values of u, of `more`...) ->
        (c, npc, 3) per-cell contributions, over blocks of cells."""
        out = torch.zeros_like(u)
        for s in range(0, self.n_cells, BLOCK_CELLS):
            conn = self.cells[s:s + BLOCK_CELLS]
            fe = fn(u[conn], *(m[conn] for m in more))
            out.index_add_(0, conn.reshape(-1), fe.reshape(-1, 3))
        return out


def flap_lattice(scale: int, p: int, device) -> Lattice:
    """The perpendicular flap (upstream Scenario PF) in 3D: 3 x 18 x 1 cells
    times `scale` per axis on [-0.05, 0.05] x [0, 1] x [0, 0.3]."""
    return Lattice((3 * scale, 18 * scale, scale), (-0.05, 0.0, 0.0),
                   (0.05, 1.0, 0.3), p, device)


class FlapBoundary:
    """The flap's boundary conditions on a lattice: clamped at y = 0 (every
    component), z held on z = 0 and z = 0.3, and the fluid interface on
    x = min, x = max and y = max (its nodes ascending: the order of the
    coupling data)."""

    def __init__(self, lat: Lattice):
        nx, ny, nz = lat.shape
        mask = np.ones((lat.n_nodes, 3))
        mask[lat.node_ids(iz=[0, nz - 1]), 2] = 0.0
        mask[lat.node_ids(iy=0), :] = 0.0
        self.mask = torch.as_tensor(mask, device=lat.device)
        self.interface_nodes = np.unique(np.concatenate([
            lat.node_ids(ix=0), lat.node_ids(ix=nx - 1),
            lat.node_ids(iy=ny - 1)]))
        # the interface's faces: (axis, side) with the cells next to them
        self.faces = [(0, 0), (0, 1), (1, 1)]

    def nodal_field(self, lat: Lattice, values) -> torch.Tensor:
        """(n_nodes, 3) f64 field: `values` (one row per interface node, in
        the interface order) on the interface, 0 elsewhere."""
        out = lat.vector()
        idx = torch.as_tensor(self.interface_nodes, device=lat.device)
        out[idx] = torch.as_tensor(np.asarray(values), dtype=torch.float64,
                                   device=lat.device).reshape(-1, 3)
        return out


def face_cells(lat: Lattice, axis: int, side: int) -> torch.Tensor:
    """Connectivity of the cells whose face (axis, side) lies on the
    lattice's boundary."""
    reps = lat.reps
    c = [np.arange(r) for r in reps]
    c[axis] = np.array([0 if side == 0 else reps[axis] - 1])
    ids = (c[0][None, None, :] + reps[0] * (c[1][None, :, None]
                                             + reps[1] * c[2][:, None, None]))
    return lat.cells[torch.as_tensor(ids.ravel(), device=lat.device)]


def face_basis(lat: Lattice, axis: int, side: int, n_q: int):
    """(N, G, w): the cell basis at the Gauss points of face (axis, side)
    and the face quadrature weights times the face's area."""
    q, wq = gauss(n_q)
    pts = [q, q, q]
    pts[axis] = np.array([0.0 if side == 0 else 1.0])
    N, G = tensor_basis(lat.p, pts, lat.h)
    others = [a for a in range(3) if a != axis]
    w = np.outer(wq, wq).ravel() * lat.h[others[0]] * lat.h[others[1]]
    dev = lat.device
    return (torch.as_tensor(N, device=dev), torch.as_tensor(G, device=dev),
            torch.as_tensor(w, device=dev))


def cell_basis(lat: Lattice, n_q: int):
    """(N, G, w) of the cell at its n_q^3 Gauss points, w including the
    cell's volume."""
    q, wq = gauss(n_q)
    N, G = tensor_basis(lat.p, [q, q, q], lat.h)
    w = np.einsum("a,b,c->abc", wq, wq, wq).ravel() * np.prod(lat.h)
    dev = lat.device
    return (torch.as_tensor(N, device=dev), torch.as_tensor(G, device=dev),
            torch.as_tensor(w, device=dev))


def mass_apply(lat: Lattice, basis, rho: float, a: torch.Tensor) -> torch.Tensor:
    """M a with the consistent mass matrix of density rho."""
    N, _, w = basis

    def fn(ae):
        aq = torch.einsum("qn,cnk->cqk", N, ae)
        return torch.einsum("qn,q,cqk->cnk", N, rho * w, aq)

    return lat.cell_loop(fn, a)


def gradients(G: torch.Tensor, ue: torch.Tensor) -> torch.Tensor:
    """(c, q, 3, 3) gradients H[k, d] = d u_k / d X_d of the cell values ue
    (c, npc, 3)."""
    return torch.einsum("qnd,cnk->cqkd", G, ue)


def test_contraction(G: torch.Tensor, w: torch.Tensor, P: torch.Tensor):
    """(c, npc, 3): sum over q of w P[k, d] dN_n/dX_d."""
    return torch.einsum("q,cqkd,qnd->cnk", w, P, G)
