"""Matrix-free preconditioned conjugate gradients: a host loop, and the
same loop in fixed-length chunks kept on the device.

Counterpart of `dealii_adapter_tpu/solvers/cg.py`, whose `cg_solve` runs a
whole solve inside one `lax.while_loop`. Here:

* `cg_solve` is a host loop that reads the residual norm back every
  iteration (`resn > tol`), one device-to-host sync per iteration. It is
  the oracle of `ChunkedCG` and the "host" side of the models' `cg_loop`;
* `ChunkedCG` keeps the loop state (x, r, p, rz, the iteration count and
  the residual norm) and the tolerance and cap in device tensors and runs
  the loop in chunks of `chunk` iterations. Each iteration is the JAX
  `body` guarded by the JAX `cond`: it computes `active = (resn > tol) &
  (k < max_iter)`, runs the body as `cg_solve` does (same operations,
  order and dtypes), and commits every state tensor with
  `torch.where(active, new, old)`, so once the solve has converged or hit
  the cap the remaining iterations of the chunk change nothing (`where`,
  not a multiplication by the mask: an inactive iteration may compute
  0/0, and NaN * 0 is NaN). One read-back of (k, resn) after each chunk
  decides whether another one runs. The iterate, iteration count and
  residual equal `cg_solve`'s bit for bit for every chunk length. On a
  CUDA device the start and the chunk are each captured once in a
  `torch.cuda.CUDAGraph` (operator, preconditioner and dots: on the
  models' paths the tangent kernel and the whole V-cycle) at the first
  solve and replayed for every later one; a capture or replay that fails
  raises. On the CPU the same code runs eagerly.

Convergence follows deal.II's SolverControl: iterate until the l2 norm of
the residual drops below an absolute tolerance or the cap is hit.
`ir_cg_solve` wraps a low-precision CG in high-precision defect
correction as a host loop (one read-back per refinement).
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
    max_refinements: int = 6, inner_solve: Optional[Callable] = None,
) -> CGResult:
    """Mixed-precision iterative refinement (defect correction): each round
    solves the defect equation with a preconditioned CG in `lo_dtype` to
    `inner_rtol` times the current true residual, and the residual and
    solution accumulate in `b.dtype`, so a few f32 solves meet an f64
    absolute tolerance (the reference's 1e-10,
    `linear_elasticity.cc:542-543`). `operator_hi`/`operator_lo` are the
    same SPD action in high/low precision; `preconditioner` maps lo -> lo.
    `inner_solve(b, x0, tol, max_iter)` runs the inner solves (a
    `ChunkedCG` over `operator_lo` and `preconditioner`; by default the
    host-loop `cg_solve`). `iterations` is the total of the inner CG
    iterations."""
    if inner_solve is None:
        def inner_solve(b_lo, x0_lo, tol, max_iter):
            return cg_solve(operator_lo, b_lo, x0_lo, tol, max_iter,
                            preconditioner)
    tol = torch.tensor(float(tol), dtype=b.dtype).item()
    x = x0
    r = b - operator_hi(x0)
    resn = torch.sqrt(_dot(r, r)).item()
    k = refinements = 0
    syncs = 1
    while resn > tol and refinements < max_refinements:
        inner = inner_solve(
            r.to(lo_dtype), torch.zeros_like(r, dtype=lo_dtype),
            inner_rtol * resn, max_iter,
        )
        x = x + inner.x.to(b.dtype)
        r = b - operator_hi(x)
        resn = torch.sqrt(_dot(r, r)).item()
        k += inner.iterations
        refinements += 1
        syncs += inner.host_syncs + 1
    return CGResult(x=x, iterations=k, residual_norm=resn, converged=resn <= tol,
                    host_syncs=syncs)


CG_LOOPS = ("graphs", "host")  # the models' `cg_loop` choices
# iterations per chunk: on the 3D benchmark step (tools/cg_chunk_sweep.py,
# PERF.md) a masked iteration costs ~2.6 ms of device time and a read-back
# far less, so the masked iterations of a longer chunk cost more than the
# read-backs it saves: chunks of 1 were fastest, 8 and 16 slowest
CG_CHUNK = 1
_INT32_MAX = 2**31 - 1


class ChunkedCG:
    """`cg_solve(operator, b, x0, tol, max_iter, preconditioner)` with the
    loop on the device, in chunks of `chunk` iterations (module docstring).

    `solve = ChunkedCG(operator, preconditioner)`; `solve(b, x0, tol,
    max_iter) -> CGResult`. The first call fixes the shape, dtype and
    device of b; every call copies b and x0 into static buffers and writes
    tol and max_iter into device tensors, so a new tolerance is a buffer
    write, not a new capture. `host_syncs` counts the read-backs, one per
    chunk; the returned x is a copy of the static iterate.

    On a CUDA device the operator and preconditioner must be capturable
    (launch on the current stream, no host syncs, no allocation outside
    PyTorch's allocator): the start and one chunk are captured at the
    first call, after one warm-up on a side stream as PyTorch requires,
    and replayed from then on. The kernel wrappers count launches in
    Python, which a replay does not run: the launches each capture
    recorded are set back (a capture launches nothing) and added again at
    every replay (`kernels/counters.py`), so the counts stay device
    launches, the masked iterations of a solve's last chunk included."""

    def __init__(self, operator: Callable,
                 preconditioner: Optional[Callable] = None,
                 chunk: int = CG_CHUNK):
        if int(chunk) < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.operator = operator
        self.M = preconditioner if preconditioner is not None else (lambda r: r)
        self.chunk = int(chunk)
        self._like = None  # (shape, dtype, device) of b, fixed at the first call
        self._graphs = None  # [(CUDAGraph, launches per replay)] once captured

    def _allocate(self, b: torch.Tensor):
        self._like = (b.shape, b.dtype, b.device)
        vec = lambda: torch.zeros_like(b)  # noqa: E731
        scalar = lambda dt: torch.zeros((), dtype=dt, device=b.device)  # noqa: E731
        self._b, self._x0, self._x, self._r, self._p = (vec() for _ in range(5))
        self._rz, self._resn, self._tol = (scalar(b.dtype) for _ in range(3))
        self._k, self._max_iter = scalar(torch.int32), scalar(torch.int32)
        # (k, resn) after a chunk, the one tensor read back
        self._status = torch.zeros(2, dtype=torch.float64, device=b.device)

    def _start(self):
        """cg_solve's lines before the loop, into the static state."""
        r = self._b - self.operator(self._x0)
        z = self.M(r)
        self._x.copy_(self._x0)
        self._r.copy_(r)
        self._p.copy_(z)
        self._rz.copy_(_dot(r, z))
        self._resn.copy_(torch.sqrt(_dot(r, r)))
        self._k.zero_()
        self._publish()

    def _chunk(self, iterations: Optional[int] = None):
        """`iterations` (default `chunk`) guarded iterations of the loop."""
        x, r, p, rz = self._x, self._r, self._p, self._rz
        for _ in range(self.chunk if iterations is None else iterations):
            active = (self._resn > self._tol) & (self._k < self._max_iter)
            Ap = self.operator(p)
            alpha = rz / _dot(p, Ap)
            x_new = x + alpha * p
            r_new = r - alpha * Ap
            z = self.M(r_new)
            rz_new = _dot(r_new, z)
            beta = rz_new / rz
            p_new = z + beta * p
            resn = torch.sqrt(_dot(r_new, r_new))
            for old, new in ((x, x_new), (r, r_new), (p, p_new),
                             (rz, rz_new), (self._resn, resn)):
                torch.where(active, new, old, out=old)
            self._k.add_(active)
        self._publish()

    def _publish(self):
        self._status[0].copy_(self._k)
        self._status[1].copy_(self._resn)

    def _capture(self):
        from ..kernels import counters

        dev = self._like[2]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up: real launches, counted
            self._start()
            self._chunk(1)
        torch.cuda.current_stream(dev).wait_stream(side)
        graphs, pool = [], None
        for body in (self._start, self._chunk):
            graph = torch.cuda.CUDAGraph()
            before = counters.launch_counts()
            with torch.cuda.graph(graph, pool=pool):
                body()
            graphs.append((graph, counters.captured(before)))
            pool = graph.pool()
        self._graphs = graphs

    def _run(self, which: int):
        """The start (0) or one chunk (1): a graph replay on a CUDA device,
        the eager code on the CPU."""
        if self._graphs is None:
            (self._start, self._chunk)[which]()
            return
        from ..kernels import counters

        graph, per_replay = self._graphs[which]
        graph.replay()
        counters.add(per_replay)

    def __call__(self, b: torch.Tensor, x0: torch.Tensor, tol: float,
                 max_iter: int) -> CGResult:
        tol = torch.tensor(float(tol), dtype=b.dtype).item()
        if self._like is None:
            self._allocate(b)
        elif (b.shape, b.dtype, b.device) != self._like:
            raise ValueError(
                f"ChunkedCG: b {tuple(b.shape)} {b.dtype} on {b.device}; this "
                f"solver's buffers are {tuple(self._like[0])} {self._like[1]} "
                f"on {self._like[2]}"
            )
        self._b.copy_(b)
        self._x0.copy_(x0)
        self._tol.fill_(tol)
        self._max_iter.fill_(min(int(max_iter), _INT32_MAX))
        if b.is_cuda and self._graphs is None:
            self._capture()
        self._run(0)
        syncs = 0
        while True:
            self._run(1)
            k, resn = self._status.tolist()
            syncs += 1
            k = int(k)
            if not (resn > tol and k < max_iter):
                break
        return CGResult(x=self._x.clone(), iterations=k, residual_norm=resn,
                        converged=resn <= tol, host_syncs=syncs)


def make_cg(loop: str, operator: Callable,
            preconditioner: Optional[Callable] = None,
            chunk: int = CG_CHUNK) -> Callable:
    """The models' Krylov solve `solve(b, x0, tol, max_iter) -> CGResult`:
    `ChunkedCG` for `loop="graphs"` (CUDA graphs on a card, the same chunks
    eagerly on the CPU), the host-loop `cg_solve` for `loop="host"`."""
    if loop == "graphs":
        return ChunkedCG(operator, preconditioner, chunk)
    if loop == "host":
        def solve(b, x0, tol, max_iter):
            return cg_solve(operator, b, x0, tol, max_iter, preconditioner)

        return solve
    raise ValueError(f"unknown cg_loop {loop!r}; expected one of {CG_LOOPS}")
