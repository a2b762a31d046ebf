"""Materialized per-cell Newton tangent and its matvec (kernel K1).

Counterpart of `dealii_adapter_tpu/ops/assembled_tangent.py`, restricted
to what the production path runs:

  1. per quadrature point, the closed-form 1st-Piola tangent
     A = dP/dF (`piola_tangent_blocks`, material + geometric terms);
  2. the element tangents K[d][e][i, j, c], contracted from A with the
     static basis S[(i,j), (k,l,q)] = (w G)[q,i,k] G[q,j,l] — one f32
     matmul per upper component block, lower blocks mirrored by transpose
     so K = K^T holds bitwise (`assemble_cell_tangents`);
  3. the column-major pack KT[(e,j), (d,i), c] (`pack_cell_tangents_T`);
  4. per CG iteration, out[(d,i), c] = sum_(e,j) KT[(e,j),(d,i),c] u[(e,j),c]
     (`apply_packed_tangents_T`): the hand-written CUDA kernel
     csrc/tangent_matvec.cu on the card, the einsum
     `apply_packed_tangents_T_plain` on the CPU.

Layouts follow ops/structured.py: component-separated tensors with the
cell axis trailing.
"""

from __future__ import annotations

import torch

from ..models.material import det_and_inv_c


def piola_tangent_blocks(grad, material):
    """Closed-form pointwise tangent A[(d,k),(e,l)] = dP_dk/dF_el of the
    compressible Neo-Hookean model. With Fi = F^{-1}, s = J^{-2/dim},
    p = (kappa/2)(J^2-1), c2 = 2 c1 = mu, trB = sum_ab F_ab^2:

      A_dk,el = kappa J^2 Fi_le Fi_kd
              + c2 s delta_de delta_kl
              + (c2 s trB/dim - p) Fi_ld Fi_ke
              - (2 c2 s/dim) (Fi_le F_dk + F_el Fi_kd)
              + (2 c2 s trB/dim^2) Fi_le Fi_kd

    grad: dim x dim nested list of (q, c) displacement-gradient components.
    Returns {(m, n): (q, c)} with m = d*dim+k, n = e*dim+l; mirrored
    entries share one tensor, so the symmetry is bitwise."""
    dim = len(grad)
    F = [
        [grad[i][j] + (1.0 if i == j else 0.0) for j in range(dim)]
        for i in range(dim)
    ]
    J, Fi = det_and_inv_c(F)
    kappa, c2 = material.kappa, 2.0 * material.c1
    s = J ** (-2.0 / dim)
    p = 0.5 * kappa * (J * J - 1.0)
    trB = sum(F[a][b] * F[a][b] for a in range(dim) for b in range(dim))
    kJ2 = kappa * J * J + (2.0 * c2 / (dim * dim)) * (s * trB)
    geo = (c2 / dim) * (s * trB) - p
    c2s = c2 * s
    two_d = 2.0 * c2 / dim

    comps = {}
    for d in range(dim):
        for k in range(dim):
            for e in range(dim):
                for l_ in range(dim):
                    if (e * dim + l_, d * dim + k) in comps:
                        comps[(d * dim + k, e * dim + l_)] = comps[
                            (e * dim + l_, d * dim + k)
                        ]
                        continue
                    a = kJ2 * (Fi[l_][e] * Fi[k][d])
                    a = a + geo * (Fi[l_][d] * Fi[k][e])
                    a = a - two_d * (
                        s * (Fi[l_][e] * F[d][k] + F[e][l_] * Fi[k][d])
                    )
                    if d == e and k == l_:
                        a = a + c2s
                    comps[(d * dim + k, e * dim + l_)] = a
    return comps


def contraction_basis(G: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Static S[(i,j), (k,l,q)] = (w G)[q,i,k] G[q,j,l], (npc^2, dim^2 q)."""
    q, npc, dim = G.shape
    Gw = G * w[:, None, None]
    return torch.einsum("qik,qjl->ijklq", Gw, G).reshape(npc * npc, dim * dim * q)


def assemble_cell_tangents(ut, G, w, material, mass_term=None, S=None):
    """Element tangents at the current iterate.

    ut: (dim, npc, c) cell-patch displacements; G: (q, npc, dim) physical
    reference gradients; w: (q,) weights; mass_term: optional (npc, npc)
    scalar matrix added to the diagonal component blocks (alpha_1 * rho
    element mass); S: the precomputed `contraction_basis(G, w)`.

    Returns K as a dim x dim nested list of (npc, npc, c) tensors,
    K[d][e][i, j, c] = dF_int[d,i,c] / du[e,j,c]. Float32 products are
    true f32 (the package sets TF32 off)."""
    dim, npc, c = ut.shape
    q = G.shape[0]
    grad = [
        [G[:, :, e] @ ut[d] for e in range(dim)] for d in range(dim)
    ]
    comps = piola_tangent_blocks(grad, material)
    if S is None:
        S = contraction_basis(G, w)
    m = mass_term[:, :, None] if mass_term is not None else None
    K = [[None] * dim for _ in range(dim)]
    for d in range(dim):
        for e in range(d, dim):
            A_de = torch.stack(
                [
                    comps[(d * dim + k, e * dim + l_)]
                    for k in range(dim)
                    for l_ in range(dim)
                ],
                dim=0,
            ).reshape(dim * dim * q, c)
            Kde = (S @ A_de).reshape(npc, npc, c)
            if d == e:
                # restore exact within-block symmetry lost to summation order
                Kde = 0.5 * (Kde + Kde.transpose(0, 1))
                if m is not None:
                    Kde = Kde + m
                K[d][e] = Kde
            else:
                K[d][e] = Kde
                K[e][d] = Kde.transpose(0, 1)
    return K


def apply_cell_tangents(K, ut):
    """out[d, i, c] = sum_{e,j} K[d][e][i, j, c] * ut[e, j, c] (nested-list
    reference form, for tests)."""
    dim = ut.shape[0]
    return torch.stack(
        [
            sum(torch.einsum("ijc,jc->ic", K[d][e], ut[e]) for e in range(dim))
            for d in range(dim)
        ],
        dim=0,
    )


def pack_cell_tangents_T(K) -> torch.Tensor:
    """Column-major pack KT[(e, j), (d, i), c] = K[d][e][i, j, c], one
    contiguous (edofs, edofs, c) tensor."""
    dim = len(K)
    npc, _, c = K[0][0].shape
    KT = torch.empty(
        (dim * npc, dim * npc, c), dtype=K[0][0].dtype, device=K[0][0].device
    )
    for e in range(dim):
        for d in range(dim):
            KT[e * npc:(e + 1) * npc, d * npc:(d + 1) * npc] = K[d][e].transpose(
                0, 1
            )
    return KT


def apply_packed_tangents_T_plain(KT: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: out (edofs, c) = sum_j KT[j, :, c] u2[j, c]."""
    return torch.einsum("jic,jc->ic", KT, u2)


def apply_packed_tangents_T(KT: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: out (edofs, c) = sum_j KT[j, :, c] * u2[j, c].

    CUDA tensors launch csrc/tangent_matvec.cu (f32 only, contiguous,
    any cell count); CPU tensors take `apply_packed_tangents_T_plain`."""
    if KT.device.type == "cpu" and u2.device.type == "cpu":
        return apply_packed_tangents_T_plain(KT, u2)
    if not (KT.is_cuda and u2.is_cuda and KT.device == u2.device):
        raise ValueError(
            f"tangent matvec: KT on {KT.device}, u on {u2.device}; both must "
            "be on one CUDA device (or both on the CPU)"
        )
    if KT.dtype != torch.float32 or u2.dtype != torch.float32:
        raise TypeError(
            f"tangent matvec kernel takes float32, got {KT.dtype}, {u2.dtype}"
        )
    if KT.dim() != 3 or KT.shape[0] != KT.shape[1] or u2.shape != (
        KT.shape[0], KT.shape[2]
    ):
        raise ValueError(
            f"tangent matvec shapes: KT {tuple(KT.shape)} must be (E, E, C) "
            f"and u {tuple(u2.shape)} must be (E, C)"
        )
    if not (KT.is_contiguous() and u2.is_contiguous()):
        raise ValueError("tangent matvec kernel takes contiguous tensors")
    from ..kernels._build import check, load_library, stream_of

    out = torch.empty_like(u2)
    err = load_library().dat_tangent_matvec_f32(
        KT.data_ptr(), u2.data_ptr(), out.data_ptr(),
        KT.shape[0], KT.shape[2], stream_of(u2),
    )
    check(err, "tangent_matvec")
    apply_packed_tangents_T.launches += 1
    return out


apply_packed_tangents_T.launches = 0


def tangent_bytes(space, dtype: torch.dtype) -> int:
    """Device footprint of the materialized tangent for a DofSpace."""
    npc = space.tab.n_nodes
    dim = space.dim
    n_cells = 1
    for r in space.mesh.reps:
        n_cells *= r
    elem = torch.empty((), dtype=dtype).element_size()
    return dim * dim * npc * npc * n_cells * elem
