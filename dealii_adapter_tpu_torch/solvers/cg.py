"""Matrix-free preconditioned conjugate gradients as a host loop.

Counterpart of `dealii_adapter_tpu/solvers/cg.py`. The JAX package keeps
the whole solve in one `lax.while_loop`; here the loop runs on the host
and reads the residual norm back every iteration (`resn > tol`), so the
iteration count is exactly the one the JAX loop takes for the same
numbers. That is one device-to-host sync per CG iteration; CUDA graphs
of fixed-length chunks are later work.

Convergence follows deal.II's SolverControl: iterate until the l2 norm of
the residual drops below an absolute tolerance or the cap is hit.
`ir_cg_solve` wraps a low-precision CG in high-precision defect
correction, also as a host loop (one read-back per refinement).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool
    host_syncs: int = 0  # device-to-host read-backs the solve made


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0-dim inner product in the operands' dtype (bf16 operands accumulate
    in f32 and round the result, as XLA's bf16 dot does)."""
    if a.dtype == torch.bfloat16:
        return torch.dot(a.reshape(-1).float(), b.reshape(-1).float()).to(a.dtype)
    return torch.dot(a.reshape(-1), b.reshape(-1))


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """M^{-1} r = r / diag (diag already 1 on Dirichlet rows)."""
    inv = 1.0 / diag

    def apply(r):
        return r * inv

    return apply


def chebyshev_preconditioner(
    operator: Callable, diag: torch.Tensor, lambda_max: float,
    degree: int = 4, eig_ratio: float = 30.0,
) -> Callable:
    """Chebyshev polynomial of the Jacobi-scaled operator on
    [lambda_max/eig_ratio, 1.05 lambda_max]."""
    inv = 1.0 / diag
    lmax = lambda_max * 1.05
    lmin = lambda_max / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)

    def apply(r):
        z = torch.zeros_like(r)
        resid = r
        d = (1.0 / theta) * (inv * resid)
        sigma = theta / delta
        rho = 1.0 / sigma
        for _ in range(degree):
            z = z + d
            resid = resid - operator(d)
            rho_next = 1.0 / (2.0 * sigma - rho)
            d = rho_next * rho * d + (2.0 * rho_next / delta) * (inv * resid)
            rho = rho_next
        return z + d

    return apply


def random_start(shape: Tuple[int, ...], dtype, device, seed: int = 0):
    """Seeded standard-normal start vector (drawn on the CPU, so it is the
    same on every device)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32).to(device, dtype)


def estimate_lambda_max(
    operator: Callable, diag: torch.Tensor, shape: Tuple[int, ...],
    iters: int = 12, seed: int = 0, v0: Optional[torch.Tensor] = None,
) -> float:
    """Power-iteration estimate of lambda_max(diag^{-1} A), computed in
    `diag.dtype`. `v0` is the start vector; by default it is drawn from a
    `torch.Generator` seeded with `seed`. (The JAX package draws it from
    `jax.random.normal(PRNGKey(seed))`; tests that compare the two packages
    pass that vector here.)"""
    inv = 1.0 / diag
    if v0 is None:
        v0 = random_start(shape, diag.dtype, diag.device, seed)
    v = v0.to(diag.device, diag.dtype)
    v = v / torch.sqrt(_dot(v, v))
    for _ in range(iters):
        w = inv * operator(v)
        v = w / torch.sqrt(_dot(w, w))
    w = inv * operator(v)
    return float(_dot(v, w) / _dot(v, v))


def cg_solve(
    operator: Callable, b: torch.Tensor, x0: torch.Tensor, tol: float,
    max_iter: int, preconditioner: Optional[Callable] = None,
) -> CGResult:
    """Preconditioned CG solving operator(x) = b to ||r||_2 <= tol
    (absolute, rounded to b's dtype)."""
    M = preconditioner if preconditioner is not None else (lambda r: r)
    tol = torch.tensor(float(tol), dtype=b.dtype).item()
    x = x0
    r = b - operator(x0)
    z = M(r)
    p = z
    rz = _dot(r, z)
    resn = torch.sqrt(_dot(r, r)).item()
    k = 0
    while resn > tol and k < max_iter:
        Ap = operator(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        resn = torch.sqrt(_dot(r, r)).item()
        k += 1
    return CGResult(x=x, iterations=k, residual_norm=resn, converged=resn <= tol,
                    host_syncs=k + 1)


def ir_cg_solve(
    operator_hi: Callable, operator_lo: Callable, b: torch.Tensor,
    x0: torch.Tensor, tol: float, max_iter: int, lo_dtype=torch.float32,
    preconditioner: Optional[Callable] = None, inner_rtol: float = 1e-6,
    max_refinements: int = 6,
) -> CGResult:
    """Mixed-precision iterative refinement (defect correction): each round
    solves the defect equation with a preconditioned CG in `lo_dtype` to
    `inner_rtol` times the current true residual, and the residual and
    solution accumulate in `b.dtype`, so a few f32 solves meet an f64
    absolute tolerance (the reference's 1e-10,
    `linear_elasticity.cc:542-543`). `operator_hi`/`operator_lo` are the
    same SPD action in high/low precision; `preconditioner` maps lo -> lo.
    `iterations` is the total of the inner CG iterations."""
    tol = torch.tensor(float(tol), dtype=b.dtype).item()
    x = x0
    r = b - operator_hi(x0)
    resn = torch.sqrt(_dot(r, r)).item()
    k = refinements = 0
    syncs = 1
    while resn > tol and refinements < max_refinements:
        inner = cg_solve(
            operator_lo, r.to(lo_dtype), torch.zeros_like(r, dtype=lo_dtype),
            tol=inner_rtol * resn, max_iter=max_iter,
            preconditioner=preconditioner,
        )
        x = x + inner.x.to(b.dtype)
        r = b - operator_hi(x)
        resn = torch.sqrt(_dot(r, r)).item()
        k += inner.iterations
        refinements += 1
        syncs += inner.host_syncs + 1
    return CGResult(x=x, iterations=k, residual_norm=resn, converged=resn <= tol,
                    host_syncs=syncs)
