"""Materialized per-cell Newton tangent and its matvecs (kernels K1, K1b,
K1c, K2, K2b).

Counterpart of `dealii_adapter_tpu/ops/assembled_tangent.py`, restricted
to what the Newton CG runs:

  1. per quadrature point, the closed-form 1st-Piola tangent
     A = dP/dF (`piola_tangent_blocks`, material + geometric terms);
  2. the element tangents K[d][e][i, j, c], contracted from A with the
     static basis S[(i,j), (k,l,q)] = (w G)[q,i,k] G[q,j,l] — one matmul
     per upper component block (d <= e), summed in f64 and rounded once
     to the tangent dtype (`_assemble_upper`). Full storage mirrors the
     lower blocks as transposed views, so K = K^T holds bitwise
     (`assemble_cell_tangents`); block-symmetric storage keeps the upper
     blocks only (`assemble_cell_tangents_sym`, 2/3 of the bytes in 3D);
  3. the layouts the kernels read: the column-major pack KT[(e,j), (d,i), c]
     (`pack_cell_tangents_T`, K1), the row-major pack (`pack_cell_tangents`,
     K1b), the nested blocks as they are (K1c), the packed upper blocks
     (`pack_cell_tangents_sym`, K2) or the upper blocks as they are (K2b);
  4. per CG iteration, out[(d,i), c] = sum_(e,j) K[d][e][i,j,c] u[(e,j),c]:
     the hand-written CUDA kernels csrc/tangent_matvec.cu (K1, K1b, K1c)
     and csrc/tangent_matvec_sym.cu (K2, K2b) for CUDA tensors, their
     `*_plain` einsum twins for CPU tensors. Each wrapper counts its
     launches in `.launches`.

Layouts follow ops/structured.py: component-separated tensors with the
cell axis trailing.
"""

from __future__ import annotations

import ctypes

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


def upper_blocks(dim):
    """Index pairs (d, e), d <= e, in the storage order of the
    block-symmetric tangent layout."""
    return [(d, e) for d in range(dim) for e in range(dim) if d <= e]


ASSEMBLY_PRECISIONS = ("highest", "high", "default", "bf16emu")


def _bf16emu(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and widened back (an operand of a "bf16emu"
    product)."""
    return x.to(torch.bfloat16).to(x.dtype)


def _assemble_upper(ut, G, w, material, mass_term, S, out=None,
                    precision="highest"):
    """The upper component blocks {(d, e): (npc, npc, c)}, d <= e, in
    `upper_blocks` order; diagonal blocks symmetrized exactly, mass term
    added to them. `out`, a list of (npc, npc, c) tensors in that order,
    receives the blocks (the last operation of each writes into it, with
    the same arithmetic), so the tangent keeps its address from one
    Newton iteration to the next.

    The contraction S @ A sums its dim^2 q terms in f64 and rounds once
    to the tangent dtype. Summed in f32, it loses the cancellation that
    leaves a rigid translation with (almost) no stiffness: on the 3D
    benchmark flap (1,018,875 DoF) the f32 tangent's product with a
    translation differed by 2.3e-4 relative between the card (cuBLAS)
    and the CPU, where the products with random vectors agreed to 5e-7,
    and the Newton CG of the first step took 59 iterations on the card
    and 34 on the CPU; with the f64 sum both take 31
    (tools/vcycle_operator_ab.py).

    `precision` (`tangent_assembly_precision`): "highest", "high" and
    "default" assemble as above. "default" is full precision on purpose:
    PyTorch's default f32 product has TF32 off (the package sets it so),
    which the port's numerics require, and the JAX package's
    `Precision.DEFAULT` is the same product on the CPU, where it is a
    no-op. "bf16emu" computes each assembly product as the JAX package's
    `_pdot` does: both operands rounded to bf16, the product accumulated
    in the tangent's own dtype (the gradients and the S contraction, with
    no f64 sum)."""
    if precision not in ASSEMBLY_PRECISIONS:
        raise ValueError(f"unknown assembly precision {precision!r}; "
                         f"expected one of {ASSEMBLY_PRECISIONS}")
    emu = precision == "bf16emu"
    dim, npc, c = ut.shape
    q = G.shape[0]
    if emu:
        grad = [[_bf16emu(G[:, :, e]) @ _bf16emu(ut[d]) for e in range(dim)]
                for d in range(dim)]
    else:
        grad = [
            [G[:, :, e] @ ut[d] for e in range(dim)] for d in range(dim)
        ]
    comps = piola_tangent_blocks(grad, material)
    if S is None:
        S = contraction_basis(G, w)
    m = mass_term[:, :, None] if mass_term is not None else None
    Sop = _bf16emu(S) if emu else S.to(torch.float64)
    blocks = upper_blocks(dim)
    if out is not None and (len(out) != len(blocks) or any(
            tuple(o.shape) != (npc, npc, c) or o.dtype != ut.dtype
            for o in out)):
        raise ValueError(
            f"out must be {len(blocks)} ({npc}, {npc}, {c}) {ut.dtype} "
            f"blocks, got {[(tuple(o.shape), o.dtype) for o in out]}"
        )
    K = {}
    for b, (d, e) in enumerate(blocks):
        A_de = torch.stack(
            [
                comps[(d * dim + k, e * dim + l_)]
                for k in range(dim)
                for l_ in range(dim)
            ],
            dim=0,
        ).reshape(dim * dim * q, c)
        A_op = _bf16emu(A_de) if emu else A_de.to(torch.float64)
        Ksum = (Sop @ A_op).reshape(npc, npc, c)
        dst = None if out is None else out[b]
        if d == e:
            # restore exact within-block symmetry lost to summation order
            Kde = Ksum.to(A_de.dtype)
            Kde = torch.mul(Kde + Kde.transpose(0, 1), 0.5, out=dst)
            if m is not None:
                Kde = Kde.add_(m) if dst is not None else Kde + m
        else:
            Kde = Ksum.to(A_de.dtype) if dst is None else dst.copy_(Ksum)
        K[(d, e)] = Kde
    return K


def assemble_cell_tangents(ut, G, w, material, mass_term=None, S=None,
                           out=None, precision="highest"):
    """Element tangents at the current iterate.

    ut: (dim, npc, c) cell-patch displacements; G: (q, npc, dim) physical
    reference gradients; w: (q,) weights; mass_term: optional (npc, npc)
    scalar matrix added to the diagonal component blocks (alpha_1 * rho
    element mass); S: the precomputed `contraction_basis(G, w)`; out: an
    earlier result to overwrite (its upper blocks receive the new ones);
    precision: the assembly tier (`_assemble_upper`).

    Returns K as a dim x dim nested list of (npc, npc, c) tensors,
    K[d][e][i, j, c] = dF_int[d,i,c] / du[e,j,c]; the lower blocks are
    transposed views of the upper ones. Float32 products are true f32 (the
    package sets TF32 off)."""
    dim = ut.shape[0]
    if out is not None:
        out = [out[d][e] for d, e in upper_blocks(dim)]
    Ku = _assemble_upper(ut, G, w, material, mass_term, S, out, precision)
    K = [[None] * dim for _ in range(dim)]
    for (d, e), Kde in Ku.items():
        K[d][e] = Kde
        if d != e:
            K[e][d] = Kde.transpose(0, 1)
    return K


def assemble_cell_tangents_sym(ut, G, w, material, mass_term=None, S=None,
                               out=None, precision="highest"):
    """Block-symmetric element tangents: the list [K00, K01, (K02,) K11,
    ...] of the upper blocks in `upper_blocks` order, each a contiguous
    (npc, npc, c) tensor (arguments as `assemble_cell_tangents`; `out` an
    earlier such list to overwrite). The lower blocks are never stored;
    `apply_cell_tangents_sym` applies the upper ones transposed in their
    place."""
    return list(_assemble_upper(ut, G, w, material, mass_term, S, out,
                                precision).values())


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


def apply_cell_tangents_sym(Ku, ut):
    """Symmetric apply of the upper-block storage (plain nested form):
    out[d] = sum_{e>=d} K[d][e] ut[e] + sum_{e<d} K[e][d]^T ut[e]."""
    dim = ut.shape[0]
    Kd = dict(zip(upper_blocks(dim), Ku))
    return torch.stack(
        [
            sum(
                torch.einsum("ijc,jc->ic", Kd[(d, e)], ut[e]) if e >= d
                else torch.einsum("jic,jc->ic", Kd[(e, d)], ut[e])
                for e in range(dim)
            )
            for d in range(dim)
        ],
        dim=0,
    )


def _pack_out(blocks, rows, cols, out):
    """`out`, checked to be a contiguous (rows, cols, c) tensor of the
    blocks' dtype and device, or a new one."""
    b0 = blocks[0]
    shape = (rows, cols, b0.shape[-1])
    if out is None:
        return torch.empty(shape, dtype=b0.dtype, device=b0.device)
    if (tuple(out.shape) != shape or out.dtype != b0.dtype
            or out.device != b0.device or not out.is_contiguous()):
        raise ValueError(
            f"out must be a contiguous {shape} {b0.dtype} tensor on "
            f"{b0.device}, got {tuple(out.shape)} {out.dtype} on {out.device}"
        )
    return out


def pack_cell_tangents_T(K, out=None) -> torch.Tensor:
    """Column-major pack KT[(e, j), (d, i), c] = K[d][e][i, j, c], one
    contiguous (edofs, edofs, c) tensor (K1), written into `out` if
    given."""
    dim = len(K)
    npc = K[0][0].shape[0]
    KT = _pack_out(K[0], dim * npc, dim * npc, out)
    for e in range(dim):
        for d in range(dim):
            KT[e * npc:(e + 1) * npc, d * npc:(d + 1) * npc] = K[d][e].transpose(
                0, 1
            )
    return KT


def pack_cell_tangents(K, out=None) -> torch.Tensor:
    """Row-major pack K[(d, i), (e, j), c] = K[d][e][i, j, c], one
    contiguous (edofs, edofs, c) tensor (K1b), written into `out` if
    given."""
    dim = len(K)
    npc = K[0][0].shape[0]
    Kp = _pack_out(K[0], dim * npc, dim * npc, out)
    for d in range(dim):
        for e in range(dim):
            Kp[d * npc:(d + 1) * npc, e * npc:(e + 1) * npc] = K[d][e]
    return Kp


def pack_cell_tangents_sym(Ku, out=None) -> torch.Tensor:
    """Upper-block list -> one contiguous (n_blocks * npc, npc, c) tensor,
    block b in rows [b * npc, (b + 1) * npc) (K2), written into `out` if
    given."""
    npc = Ku[0].shape[0]
    return torch.cat(Ku, dim=0, out=_pack_out(Ku, len(Ku) * npc, npc, out))


def _plain_or_check(name, tensors, u2):
    """True when every operand lies on the CPU (the wrapper then runs its
    plain version). Otherwise all must lie on one CUDA device in float32
    with the cell axis contiguous, u2 contiguous; anything else raises."""
    devices = {t.device for t in tensors} | {u2.device}
    if all(dv.type == "cpu" for dv in devices):
        return True
    if len(devices) != 1 or u2.device.type != "cuda":
        raise ValueError(
            f"{name}: operands on {sorted(map(str, devices))}; all must be on "
            "one CUDA device (or all on the CPU)"
        )
    if any(t.dtype != torch.float32 for t in tensors) or u2.dtype != torch.float32:
        raise TypeError(
            f"{name} kernel takes float32, got "
            f"{sorted({str(t.dtype) for t in tensors} | {str(u2.dtype)})}"
        )
    if not u2.is_contiguous() or any(
        t.dim() != 3 or t.stride(2) != 1 for t in tensors
    ):
        raise ValueError(f"{name} kernel takes tensors with a contiguous cell axis")
    return False


def _check_u(name, u2, rows, n_cells):
    if u2.dim() != 2 or tuple(u2.shape) != (rows, n_cells):
        raise ValueError(
            f"{name}: u {tuple(u2.shape)} must be ({rows}, {n_cells})"
        )


def apply_packed_tangents_T_plain(KT: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: out (edofs, c) = sum_j KT[j, :, c] u2[j, c]."""
    return torch.einsum("jic,jc->ic", KT, u2)


def _apply_pack(name, entry, K, u2):
    """Launch K1 or K1b on a contiguous (E, E, C) pack."""
    if K.dim() != 3 or K.shape[0] != K.shape[1]:
        raise ValueError(f"{name}: K {tuple(K.shape)} must be (E, E, C)")
    _check_u(name, u2, K.shape[0], K.shape[2])
    if not K.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous pack")
    from ..kernels._build import check, load_library, stream_of

    out = torch.empty_like(u2)
    err = getattr(load_library(), entry)(
        K.data_ptr(), u2.data_ptr(), out.data_ptr(), K.shape[0], K.shape[2],
        stream_of(u2),
    )
    check(err, name)
    return out


def apply_packed_tangents_T(KT: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: out (edofs, c) = sum_j KT[j, :, c] * u2[j, c] over the
    column-major pack. CUDA tensors launch csrc/tangent_matvec.cu (f32,
    contiguous, any cell count); CPU tensors take
    `apply_packed_tangents_T_plain`."""
    if _plain_or_check("K1 tangent matvec", [KT], u2):
        return apply_packed_tangents_T_plain(KT, u2)
    out = _apply_pack("K1 tangent matvec", "dat_tangent_matvec_f32", KT, u2)
    apply_packed_tangents_T.launches += 1
    return out


def apply_packed_tangents_plain(K: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Plain version of K1b: out (edofs, c) = sum_j K[:, j, c] u2[j, c]."""
    return torch.einsum("ijc,jc->ic", K, u2)


def apply_packed_tangents(K: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """K1b wrapper: the matvec over the row-major pack
    (`pack_cell_tangents`); K1's kernel with the row and column strides
    swapped (csrc/tangent_matvec.cu)."""
    if _plain_or_check("K1b tangent matvec", [K], u2):
        return apply_packed_tangents_plain(K, u2)
    out = _apply_pack("K1b tangent matvec", "dat_tangent_matvec_rows_f32", K, u2)
    apply_packed_tangents.launches += 1
    return out


def apply_block_tangents_plain(K, u2: torch.Tensor) -> torch.Tensor:
    """Plain version of K1c: `apply_cell_tangents` on (dim * npc, c)."""
    dim = len(K)
    npc, _, c = K[0][0].shape
    return apply_cell_tangents(K, u2.reshape(dim, npc, c)).reshape(dim * npc, c)


def apply_block_tangents(K, u2: torch.Tensor) -> torch.Tensor:
    """K1c wrapper: the matvec from the dim x dim nested blocks as
    `assemble_cell_tangents` returns them, without a pack. Blocks may be
    strided views (the transposed lower blocks) as long as the cell axis is
    contiguous; the kernel reads them through their strides."""
    name = "K1c tangent matvec"
    dim = len(K)
    flat = [K[d][e] for d in range(dim) for e in range(dim)]
    if _plain_or_check(name, flat, u2):
        return apply_block_tangents_plain(K, u2)
    npc, _, c = flat[0].shape
    if not 1 <= dim <= 3 or any(tuple(b.shape) != (npc, npc, c) for b in flat):
        raise ValueError(
            f"{name}: K must be dim x dim (dim <= 3) blocks of one shape "
            f"(npc, npc, C), got {[tuple(b.shape) for b in flat]}"
        )
    _check_u(name, u2, dim * npc, c)
    from ..kernels._build import c_array, check, load_library, stream_of

    ptrs = c_array(ctypes.c_void_p, [b.data_ptr() for b in flat])
    s_i = c_array(ctypes.c_longlong, [b.stride(0) for b in flat])
    s_j = c_array(ctypes.c_longlong, [b.stride(1) for b in flat])
    out = torch.empty_like(u2)
    err = load_library().dat_tangent_matvec_blocks_f32(
        ctypes.addressof(ptrs), ctypes.addressof(s_i), ctypes.addressof(s_j),
        u2.data_ptr(), out.data_ptr(), dim, npc, c, stream_of(u2),
    )
    check(err, name)
    apply_block_tangents.launches += 1
    return out


# npc of the Q1-Q4 elements the K2/K2b kernel is instantiated for
_SYM_KERNEL_NPC = {2: (4, 9, 16, 25), 3: (8, 27, 64, 125)}


def apply_sym_block_tangents_plain(Ku, u2: torch.Tensor, dim: int, npc: int):
    """Plain version of K2b: `apply_cell_tangents_sym` on (dim * npc, c)."""
    c = u2.shape[-1]
    return apply_cell_tangents_sym(Ku, u2.reshape(dim, npc, c)).reshape(
        dim * npc, c
    )


def apply_packed_tangents_sym_plain(Kpack, u2: torch.Tensor, dim: int, npc: int):
    """Plain version of K2: the packed upper blocks, applied as K2b's."""
    return apply_sym_block_tangents_plain(
        list(Kpack.split(npc, dim=0)), u2, dim, npc
    )


def _apply_sym(name, blocks, u2, dim, npc):
    """Launch the block-symmetric kernel on the upper blocks `blocks`."""
    n_cells = u2.shape[-1]
    if npc not in _SYM_KERNEL_NPC.get(dim, ()):
        raise ValueError(
            f"{name}: the kernel covers Q1-Q4 elements, npc in "
            f"{_SYM_KERNEL_NPC} by dim; got dim {dim}, npc {npc}"
        )
    if len(blocks) != len(upper_blocks(dim)) or any(
        tuple(b.shape) != (npc, npc, n_cells) or not b.is_contiguous()
        for b in blocks
    ):
        raise ValueError(
            f"{name}: need {len(upper_blocks(dim))} contiguous ({npc}, {npc}, "
            f"{n_cells}) upper blocks, got {[tuple(b.shape) for b in blocks]}"
        )
    _check_u(name, u2, dim * npc, n_cells)
    from ..kernels._build import c_array, check, load_library, stream_of

    ptrs = c_array(ctypes.c_void_p, [b.data_ptr() for b in blocks])
    out = torch.empty_like(u2)
    err = load_library().dat_tangent_matvec_sym_f32(
        ctypes.addressof(ptrs), u2.data_ptr(), out.data_ptr(), dim, npc,
        n_cells, stream_of(u2),
    )
    check(err, name)
    return out


def apply_packed_tangents_sym(Kpack: torch.Tensor, u2: torch.Tensor, dim: int,
                              npc: int) -> torch.Tensor:
    """K2 wrapper: the symmetric matvec from the packed upper blocks
    (`pack_cell_tangents_sym`, (n_blocks * npc, npc, c)),
    csrc/tangent_matvec_sym.cu."""
    name = "K2 tangent matvec (symmetric)"
    if _plain_or_check(name, [Kpack], u2):
        return apply_packed_tangents_sym_plain(Kpack, u2, dim, npc)
    if not Kpack.is_contiguous() or Kpack.shape[0] != len(upper_blocks(dim)) * npc:
        raise ValueError(
            f"{name}: Kpack {tuple(Kpack.shape)} must be a contiguous "
            f"({len(upper_blocks(dim)) * npc}, {npc}, C) pack"
        )
    out = _apply_sym(name, list(Kpack.split(npc, dim=0)), u2, dim, npc)
    apply_packed_tangents_sym.launches += 1
    return out


def apply_sym_block_tangents(Ku, u2: torch.Tensor, dim: int, npc: int) -> torch.Tensor:
    """K2b wrapper: the symmetric matvec from the upper blocks as
    `assemble_cell_tangents_sym` returns them (no pack), with K2's kernel."""
    name = "K2b tangent matvec (symmetric blocks)"
    if _plain_or_check(name, list(Ku), u2):
        return apply_sym_block_tangents_plain(Ku, u2, dim, npc)
    out = _apply_sym(name, list(Ku), u2, dim, npc)
    apply_sym_block_tangents.launches += 1
    return out


apply_packed_tangents_T.launches = 0
apply_packed_tangents.launches = 0
apply_block_tangents.launches = 0
apply_packed_tangents_sym.launches = 0
apply_sym_block_tangents.launches = 0


def tangent_bytes(space, dtype: torch.dtype, sym: bool = False) -> int:
    """Device footprint of the materialized tangent for a DofSpace: all
    dim^2 component blocks, or with `sym` the dim (dim + 1) / 2 upper
    ones."""
    npc = space.tab.n_nodes
    dim = space.dim
    n_cells = 1
    for r in space.mesh.reps:
        n_cells *= r
    elem = torch.empty((), dtype=dtype).element_size()
    n_blocks = len(upper_blocks(dim)) if sym else dim * dim
    return n_blocks * npc * npc * n_cells * elem
