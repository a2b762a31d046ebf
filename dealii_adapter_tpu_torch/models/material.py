"""Compressible Neo-Hookean material with volumetric/isochoric split.

Counterpart of `dealii_adapter_tpu/models/material.py`:

  kappa = 2 mu (1+nu) / (3 (1-2 nu)),  c1 = mu/2
  Psi   = (kappa/4)(J^2 - 1 - 2 ln J) + c1 (tr b_bar - dim)
  tau   = (kappa/2)(J^2 - 1) I + dev(2 c1 b_bar)
  Jc    = Jc_vol + Jc_iso (spatial tangent J * c)

with b_bar = J^{-2/dim} F F^T. The hot path works on component lists
(the `_c` functions): every tensor is a dim x dim nested list of equally
shaped (q, c) tensors, so each component is one contiguous pointwise
pass. `NeoHookean.psi`, `NeoHookean.tau`, `NeoHookean.Jc`,
`det_and_inv` and `kinematics` take batched (..., dim, dim) tensors, as
the JAX package's do (tests and API parity; off the hot path, so they
use plain arithmetic).

In f64 the reciprocal and J^{-2/3} are taken from an f32 seed refined by
two division-free Newton steps, exactly as the JAX package does, so both
packages round the same way.

Arithmetic between a tensor and a Python number goes through the Scalar
overloads (`smul`, `sadd`, `ssub`, `rsub`) and sums of terms through
`fsum`, never through `x * 2.0` or the built-in `sum`: under forward-mode
AD (the jvp tangent differentiates this code) a number that the Python
binding wraps as a tensor has no tangent, and PyTorch then builds a zero
tangent whose shape logic runs in Python, hundreds of microseconds an
operation on the CPU. The Scalar overloads' derivatives need no tangent
for the number, and the values are the same bits (the binding wraps the
number as those overloads do).
"""

from __future__ import annotations

import dataclasses

import torch

_aten = torch.ops.aten


def smul(x: torch.Tensor, s: float) -> torch.Tensor:
    """x * s."""
    return _aten.mul.Scalar(x, s)


def sadd(x: torch.Tensor, s: float) -> torch.Tensor:
    """x + s."""
    return _aten.add.Scalar(x, s)


def ssub(x: torch.Tensor, s: float) -> torch.Tensor:
    """x - s."""
    return _aten.sub.Scalar(x, s)


def rsub(s: float, x: torch.Tensor) -> torch.Tensor:
    """s - x."""
    return _aten.rsub.Scalar(x, s)


def fsum(terms):
    """The terms added left to right, as the built-in `sum` adds them
    after its leading 0."""
    it = iter(terms)
    out = next(it)
    for t in it:
        out = out + t
    return out


@dataclasses.dataclass(frozen=True)
class NeoHookean:
    mu: float
    nu: float
    rho: float

    @property
    def kappa(self) -> float:
        return (2.0 * self.mu * (1.0 + self.nu)) / (3.0 * (1.0 - 2.0 * self.nu))

    @property
    def c1(self) -> float:
        return self.mu / 2.0

    def psi(self, det_F: torch.Tensor, b_bar: torch.Tensor) -> torch.Tensor:
        """The strain energy, batched over the leading axes of `det_F` and
        of the (..., dim, dim) `b_bar`."""
        dim = b_bar.shape[-1]
        psi_vol = (self.kappa / 4.0) * (det_F**2 - 1.0 - 2.0 * torch.log(det_F))
        tr_bbar = torch.diagonal(b_bar, dim1=-2, dim2=-1).sum(-1)
        return psi_vol + self.c1 * (tr_bbar - dim)

    def tau(self, det_F: torch.Tensor, b_bar: torch.Tensor) -> torch.Tensor:
        """tau = (kappa/2)(J^2-1) I + dev(2 c1 b_bar), batched over the
        leading axes."""
        dim = b_bar.shape[-1]
        eye = torch.eye(dim, dtype=b_bar.dtype, device=b_bar.device)
        p_vol = 0.5 * self.kappa * (det_F**2 - 1.0)
        tau_bar = 2.0 * self.c1 * b_bar
        tr = torch.diagonal(tau_bar, dim1=-2, dim2=-1).sum(-1)
        tau_iso = tau_bar - (tr / dim)[..., None, None] * eye
        return p_vol[..., None, None] * eye + tau_iso

    def tau_c(self, det_F, b_bar):
        """Component-wise Kirchhoff stress: `b_bar` is a dim x dim nested
        list of equally shaped tensors; returns the same structure."""
        dim = len(b_bar)
        p_vol = smul(ssub(det_F**2, 1.0), 0.5 * self.kappa)
        c2 = 2.0 * self.c1
        tr = fsum(b_bar[i][i] for i in range(dim))
        iso_diag = p_vol - smul(tr, c2 / dim)
        return [
            [
                smul(b_bar[i][j], c2) + iso_diag if i == j
                else smul(b_bar[i][j], c2)
                for j in range(dim)
            ]
            for i in range(dim)
        ]

    def Jc(self, det_F: torch.Tensor, b_bar: torch.Tensor) -> torch.Tensor:
        """J times the spatial elasticity tensor, (..., d, d, d, d), for a
        stacked (..., d, d) `b_bar` (tests and API parity)."""
        dim = b_bar.shape[-1]
        eye = torch.eye(dim, dtype=b_bar.dtype, device=b_bar.device)
        IxI = torch.einsum("ij,kl->ijkl", eye, eye)
        S = 0.5 * (
            torch.einsum("ik,jl->ijkl", eye, eye)
            + torch.einsum("il,jk->ijkl", eye, eye)
        )
        dev_P = S - IxI / dim
        J = det_F[..., None, None, None, None]
        dP = 0.5 * self.kappa * (det_F - 1.0 / det_F)
        d2P = 0.5 * self.kappa * (1.0 + 1.0 / det_F**2)
        Jc_vol = J * (
            (dP + det_F * d2P)[..., None, None, None, None] * IxI
            - (2.0 * dP)[..., None, None, None, None] * S
        )
        tau_bar = 2.0 * self.c1 * b_bar
        tr_bar = torch.diagonal(tau_bar, dim1=-2, dim2=-1).sum(-1)
        tau_iso = tau_bar - (tr_bar / dim)[..., None, None] * eye
        t_x_I = torch.einsum("...ij,kl->...ijkl", tau_iso, eye)
        I_x_t = torch.einsum("ij,...kl->...ijkl", eye, tau_iso)
        Jc_iso = (2.0 / dim) * tr_bar[..., None, None, None, None] * dev_P - (
            2.0 / dim
        ) * (t_x_I + I_x_t)
        return Jc_vol + Jc_iso


def _refined_recip(d: torch.Tensor) -> torch.Tensor:
    r = d.to(torch.float32).reciprocal().to(torch.float64)
    r = r * rsub(2.0, d * r)
    r = r * rsub(2.0, d * r)
    return r


def _refined_pow_m23(J: torch.Tensor) -> torch.Tensor:
    """J^(-2/3) for J > 0 (the dim=3 isochoric scale)."""
    J2 = J * J
    s = (J.to(torch.float32) ** (-2.0 / 3.0)).to(torch.float64)
    third = 1.0 / 3.0
    s = smul(s * rsub(4.0, J2 * s * s * s), third)
    s = smul(s * rsub(4.0, J2 * s * s * s), third)
    return s


def _is_f64(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype == torch.float64


def iso_scale(J, dim: int):
    """J^(-2/dim) with the refined f64 path."""
    if dim == 2:
        return _refined_recip(J) if _is_f64(J) else J.reciprocal()
    if _is_f64(J):
        return _refined_pow_m23(J)
    return J ** (-2.0 / dim)


def det_and_inv(F: torch.Tensor):
    """Determinant and inverse of (..., 2, 2) or (..., 3, 3) matrices by
    their explicit formulas (the cofactors over the determinant)."""
    if F.shape[-1] == 2:
        a, b = F[..., 0, 0], F[..., 0, 1]
        c, e = F[..., 1, 0], F[..., 1, 1]
        det = a * e - b * c
        inv = torch.stack([torch.stack([e, -b], dim=-1),
                           torch.stack([-c, a], dim=-1)], dim=-2)
        return det, inv / det[..., None, None]
    a = F
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    cof = torch.stack([torch.stack([c00, c10, c20], dim=-1),
                       torch.stack([c01, c11, c21], dim=-1),
                       torch.stack([c02, c12, c22], dim=-1)], dim=-2)
    return det, cof / det[..., None, None]


def det_and_inv_c(F):
    """Determinant and inverse of a dim x dim nested list of equally shaped
    tensors; returns (det, inv) with inv in the same structure."""
    dim = len(F)
    if dim == 2:
        (a, b), (c, e) = F
        det = a * e - b * c
        inv_det = _refined_recip(det) if _is_f64(det) else det.reciprocal()
        return det, [[e * inv_det, -b * inv_det], [-c * inv_det, a * inv_det]]
    a = F
    c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
    c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
    c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
    c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
    c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
    c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
    c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
    c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
    inv_det = _refined_recip(det) if _is_f64(det) else det.reciprocal()
    inv = [
        [c00 * inv_det, c10 * inv_det, c20 * inv_det],
        [c01 * inv_det, c11 * inv_det, c21 * inv_det],
        [c02 * inv_det, c12 * inv_det, c22 * inv_det],
    ]
    return det, inv


def kinematics_c(grad_u):
    """grad_u (dim x dim nested list) -> (F, J, F_inv, b_bar), tensors in
    the same nested-list structure."""
    dim = len(grad_u)
    F = [
        [sadd(grad_u[i][j], 1.0) if i == j else grad_u[i][j] for j in range(dim)]
        for i in range(dim)
    ]
    J, F_inv = det_and_inv_c(F)
    scale = iso_scale(J, dim)
    b_bar = [
        [scale * fsum(F[i][k] * F[j][k] for k in range(dim)) for j in range(dim)]
        for i in range(dim)
    ]
    return F, J, F_inv, b_bar


def kinematics(grad_u: torch.Tensor):
    """F, J, F^{-1} and b_bar from (..., dim, dim) displacement gradients
    (deal.II's Kinematics::F, F_iso and b)."""
    dim = grad_u.shape[-1]
    F = grad_u + torch.eye(dim, dtype=grad_u.dtype, device=grad_u.device)
    J, F_inv = det_and_inv(F)
    b = torch.einsum("...ik,...jk->...ij", F, F)
    b_bar = J[..., None, None] ** (-2.0 / dim) * b
    return F, J, F_inv, b_bar
