"""Matrix-free preconditioned conjugate gradients: a host loop, and the
same loop in fixed-length chunks kept on the device.

Counterpart of `dealii_adapter_tpu/solvers/cg.py`, whose `cg_solve` runs a
whole solve inside one `lax.while_loop`. Here:

* `cg_solve` is a host loop that reads the residual norm back every
  iteration (`resn > tol`), one device-to-host sync per iteration. It is
  the JAX package's function and the oracle of `ChunkedCG`; no model
  runs it;
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
  raises. On the CPU, and on a card when built with `eager=True` (both
  models under `cg_loop="host"`, `make_cg`: gloo ranks' collectives
  cannot be captured), the same code runs eagerly.

Every solve and `estimate_lambda_max` take the inner product as `dot`
(default `_dot`): on row-distributed vectors (the lattice partition) the
local sum plus one all-reduce (`parallel/partition.py:RankGroup.dot`).

Convergence follows deal.II's SolverControl: iterate until the l2 norm of
the residual drops below an absolute tolerance or the cap is hit.
`ir_cg_solve` wraps a low-precision CG in high-precision defect
correction as a host loop (one read-back per refinement), the oracle of
`ChunkedIRCG`, which keeps that loop on the device around a `ChunkedCG`
(its decisions in the CG's status, no read-back of their own).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float
    converged: bool
    host_syncs: int = 0  # device-to-host read-backs the solve made
    x_stat: Optional[float] = None  # `ChunkedIRCG`'s x_stat of the result


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
    dot: Callable = _dot,
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
    v = v / torch.sqrt(dot(v, v))
    for _ in range(iters):
        w = inv * operator(v)
        v = w / torch.sqrt(dot(w, w))
    w = inv * operator(v)
    return float(dot(v, w) / dot(v, v))


def lambda_max(operator: Callable, diag: torch.Tensor,
               shape: Tuple[int, ...], lattice=None) -> float:
    """`estimate_lambda_max` of a global (n_nodes, dim) operator; on the
    lattice partition (`lattice`, a `parallel/lattice.py:SlabLayout`) from
    this rank's rows of the global start vector, with the global inner
    product, so every rank gets the one-device estimate up to summation
    order."""
    if lattice is None:
        return estimate_lambda_max(operator, diag, shape)
    v0 = lattice.local(random_start(shape, diag.dtype, diag.device))
    return estimate_lambda_max(operator, diag, shape, v0=v0,
                               dot=lattice.mesh.dot(_dot))


def cg_solve(
    operator: Callable, b: torch.Tensor, x0: torch.Tensor, tol: float,
    max_iter: int, preconditioner: Optional[Callable] = None,
    dot: Callable = _dot,
) -> CGResult:
    """Preconditioned CG solving operator(x) = b to ||r||_2 <= tol
    (absolute, rounded to b's dtype). `tol` is a float, or a 0-dim tensor
    (the Newton loop's, computed on the device), read back together with
    the first residual norm, so it costs no read-back of its own."""
    M = preconditioner if preconditioner is not None else (lambda r: r)
    x = x0
    r = b - operator(x0)
    z = M(r)
    p = z
    rz = dot(r, z)
    resn = torch.sqrt(dot(r, r))
    if isinstance(tol, torch.Tensor):
        resn, tol = torch.stack([resn, tol.to(resn)]).tolist()
    else:
        tol = torch.tensor(float(tol), dtype=b.dtype).item()
        resn = resn.item()
    k = 0
    while resn > tol and k < max_iter:
        Ap = operator(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        resn = torch.sqrt(dot(r, r)).item()
        k += 1
    return CGResult(x=x, iterations=k, residual_norm=resn, converged=resn <= tol,
                    host_syncs=k + 1)


def ir_cg_solve(
    operator_hi: Callable, operator_lo: Callable, b: torch.Tensor,
    x0: torch.Tensor, tol: float, max_iter: int, lo_dtype=torch.float32,
    preconditioner: Optional[Callable] = None, inner_rtol: float = 1e-6,
    max_refinements: int = 6, dot: Callable = _dot,
) -> CGResult:
    """Mixed-precision iterative refinement (defect correction): each round
    solves the defect equation with a preconditioned CG in `lo_dtype` to
    `inner_rtol` times the current true residual, and the residual and
    solution accumulate in `b.dtype`, so a few f32 solves meet an f64
    absolute tolerance (the reference's 1e-10,
    `linear_elasticity.cc:542-543`). `operator_hi`/`operator_lo` are the
    same SPD action in high/low precision; `preconditioner` maps lo -> lo.
    The inner solves are the host-loop `cg_solve`; `iterations` is their
    total. `ChunkedIRCG` runs the same loop on the device."""
    tol = torch.tensor(float(tol), dtype=b.dtype).item()
    x = x0
    r = b - operator_hi(x0)
    resn = torch.sqrt(dot(r, r)).item()
    k = refinements = 0
    syncs = 1
    while resn > tol and refinements < max_refinements:
        inner = cg_solve(
            operator_lo, r.to(lo_dtype), torch.zeros_like(r, dtype=lo_dtype),
            inner_rtol * resn, max_iter, preconditioner, dot,
        )
        x = x + inner.x.to(b.dtype)
        r = b - operator_hi(x)
        resn = torch.sqrt(dot(r, r)).item()
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
    launches, the masked iterations of a solve's last chunk included.
    With `eager=True` nothing is captured and the same code runs eagerly
    on the card too."""

    def __init__(self, operator: Callable,
                 preconditioner: Optional[Callable] = None,
                 chunk: int = CG_CHUNK, dot: Callable = _dot, pool=None,
                 status_slots: int = 0, eager: bool = False):
        if int(chunk) < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.operator = operator
        self.dot = dot
        self.pool = pool  # a CUDA-graph memory pool to capture into
        self.M = preconditioner if preconditioner is not None else (lambda r: r)
        self.chunk = int(chunk)
        # slots after (k, resn, tol) in the status read after every chunk,
        # for the code that runs the solves to publish its own scalars in
        # (`ChunkedIRCG`), so that they cost no read-back of their own
        self.status_slots = int(status_slots)
        self.eager = bool(eager)  # run the start and chunks, capture nothing
        self._like = None  # (shape, dtype, device) of b, fixed at the first call
        self._graphs = None  # [(CUDAGraph, launches per replay)] once captured

    def _allocate(self, b: torch.Tensor):
        self._like = (b.shape, b.dtype, b.device)
        vec = lambda: torch.zeros_like(b)  # noqa: E731
        scalar = lambda dt: torch.zeros((), dtype=dt, device=b.device)  # noqa: E731
        self._b, self._x0, self._x, self._r, self._p = (vec() for _ in range(5))
        self._rz, self._resn, self._tol = (scalar(b.dtype) for _ in range(3))
        self._k, self._max_iter = scalar(torch.int32), scalar(torch.int32)
        # (k, resn, tol, *slots) after a chunk, the one tensor read back
        self._status = torch.zeros(3 + self.status_slots, dtype=torch.float64,
                                   device=b.device)

    def _start(self):
        """cg_solve's lines before the loop, into the static state."""
        r = self._b - self.operator(self._x0)
        z = self.M(r)
        self._x.copy_(self._x0)
        self._r.copy_(r)
        self._p.copy_(z)
        self._rz.copy_(self.dot(r, z))
        self._resn.copy_(torch.sqrt(self.dot(r, r)))
        self._k.zero_()
        self._publish()

    def _chunk(self, iterations: Optional[int] = None):
        """`iterations` (default `chunk`) guarded iterations of the loop."""
        x, r, p, rz = self._x, self._r, self._p, self._rz
        for _ in range(self.chunk if iterations is None else iterations):
            active = (self._resn > self._tol) & (self._k < self._max_iter)
            Ap = self.operator(p)
            alpha = rz / self.dot(p, Ap)
            x_new = x + alpha * p
            r_new = r - alpha * Ap
            z = self.M(r_new)
            rz_new = self.dot(r_new, z)
            beta = rz_new / rz
            p_new = z + beta * p
            resn = torch.sqrt(self.dot(r_new, r_new))
            for old, new in ((x, x_new), (r, r_new), (p, p_new),
                             (rz, rz_new), (self._resn, resn)):
                torch.where(active, new, old, out=old)
            self._k.add_(active)
        self._publish()

    def _publish(self):
        self._status[0].copy_(self._k)
        self._status[1].copy_(self._resn)
        self._status[2].copy_(self._tol)

    def _capture(self):
        from ..kernels import counters
        from .graphs import capture

        dev = self._like[2]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # warm-up: real launches, counted
            self._start()
            self._chunk(1)
        torch.cuda.current_stream(dev).wait_stream(side)
        graphs, pool = [], self.pool
        for body in (self._start, self._chunk):
            graph = torch.cuda.CUDAGraph()
            before = counters.launch_counts()
            with capture(graph, pool):
                body()
            graphs.append((graph, counters.captured(before)))
            pool = graph.pool()
        self._graphs = graphs

    def _run(self, which: int):
        """The start (0) or one chunk (1): a graph replay once captured,
        else the eager code."""
        if self._graphs is None:
            (self._start, self._chunk)[which]()
            return
        from ..kernels import counters

        graph, per_replay = self._graphs[which]
        graph.replay()
        counters.add(per_replay)

    def bind(self, b: torch.Tensor, max_iter: int) -> None:
        """Fix (at the first call) or check b's shape, dtype and device,
        write the cap, and on a CUDA device capture the graphs once
        (unless `eager`)."""
        if self._like is None:
            self._allocate(b)
        elif (b.shape, b.dtype, b.device) != self._like:
            raise ValueError(
                f"ChunkedCG: b {tuple(b.shape)} {b.dtype} on {b.device}; this "
                f"solver's buffers are {tuple(self._like[0])} {self._like[1]} "
                f"on {self._like[2]}"
            )
        self._max_iter.fill_(min(int(max_iter), _INT32_MAX))
        if b.is_cuda and self._graphs is None and not self.eager:
            self._capture()

    def read_status(self) -> list:
        """The status as floats: the one read-back after a chunk."""
        return self._status.tolist()

    def __call__(self, b: torch.Tensor, x0: torch.Tensor, tol,
                 max_iter: int) -> CGResult:
        """`tol` a float, or a 0-dim tensor on b's device, copied into the
        solver's tolerance on the device (no read-back; the Newton loop
        computes it there)."""
        self.bind(b, max_iter)
        self._b.copy_(b)
        self._x0.copy_(x0)
        if isinstance(tol, torch.Tensor):
            self._tol.copy_(tol)  # rounds to b's dtype, as the float path
        else:
            self._tol.fill_(torch.tensor(float(tol), dtype=b.dtype).item())
        self._run(0)
        syncs = 0
        while True:
            self._run(1)
            k, resn, tol = self.read_status()[:3]
            syncs += 1
            k = int(k)
            if not (resn > tol and k < max_iter):
                break
        return CGResult(x=self._x.clone(), iterations=k, residual_norm=resn,
                        converged=resn <= tol, host_syncs=syncs)


class ChunkedIRCG:
    """`ir_cg_solve(operator_hi, operator_lo, b, x0, tol, max_iter,
    lo_dtype, preconditioner, inner_rtol, max_refinements)` with the
    defect-correction loop on the device: the counterpart of the JAX
    package's `lax.while_loop` (`dealii_adapter_tpu/solvers/cg.py:206`).

    `solve = ChunkedIRCG(...)`; `solve(b, x0, tol, max_iter) -> CGResult`.
    The state (x, resn, the inner iterations k and the refinement count)
    lies in device tensors. The start and each refinement (the JAX
    `body` after its inner solve: `x += inner.x`, `r = b - A_hi(x)`, its
    norm, k and the count advanced) run through `runner`
    (`graphs.py:GraphRunner`: replayed from CUDA graphs on a card, eager
    on the CPU or where the runner is `eager`, and then so is the inner
    solve), and each ends with the JAX `cond` (`resn > tol` and the
    count below `max_refinements`) computed on the device. The next inner
    solve's right-hand side r and tolerance `inner_rtol * resn` are
    written into the inner `ChunkedCG`'s buffers there, so the inner
    solve starts without a read-back; where the loop has ended, its
    tolerance is +inf, and the start and one chunk then change nothing
    but cost their device time. The decision, resn, k, the count and
    `x_stat(x)` (a 0-dim function of the iterate, if given) go into the
    spare slots of the inner solver's status, which the host reads after
    every chunk (`ChunkedCG.status_slots`), so a refinement reads back
    nothing of its own: after an inner solve ends, the host runs the
    refinement and, unless it expects the loop to end there
    (`_expect_end`), the next inner start and chunk before it reads.
    Where it expects the end, it reads the status after the refinement
    alone, which saves the masked start and chunk; it does so at most
    once a solve (after a wrong guess every later refinement goes on to
    the next start and chunk), so `host_syncs`, the read-backs, are at
    most one per chunk plus one. A wrong guess costs that one read-back,
    or the masked start and chunk. The iterate, iterations and residual
    equal `ir_cg_solve`'s bit for bit (same operations, order and
    dtypes). On the CPU the same code runs eagerly."""

    # the refinement loop's slots in the inner solver's status
    SLOTS = ("refine", "resn", "iterations", "refinements", "x_stat")

    def __init__(self, operator_hi: Callable, operator_lo: Callable,
                 preconditioner: Optional[Callable] = None,
                 lo_dtype=torch.float32, inner_rtol: float = 1e-6,
                 max_refinements: int = 6, chunk: int = CG_CHUNK,
                 dot: Callable = _dot, pool=None, runner=None,
                 x_stat: Optional[Callable] = None):
        self.operator_hi = operator_hi
        self.lo_dtype = lo_dtype
        self.inner_rtol = float(inner_rtol)
        self.max_refinements = int(max_refinements)
        self.dot = dot
        self.pool = pool
        self.runner = runner  # a GraphRunner (default: one of its own)
        self.x_stat = x_stat
        self.inner = ChunkedCG(operator_lo, preconditioner, chunk, dot, pool,
                               status_slots=len(self.SLOTS),
                               eager=runner is not None and runner.eager)
        self._like = None

    def _allocate(self, b: torch.Tensor):
        from .graphs import GraphRunner

        self._like = (b.shape, b.dtype, b.device)
        self._b, self._x0, self._x = (torch.zeros_like(b) for _ in range(3))
        self._resn, self._tol = (torch.zeros((), dtype=b.dtype, device=b.device)
                                 for _ in range(2))
        self._k, self._i = (torch.zeros((), dtype=torch.int32, device=b.device)
                            for _ in range(2))
        self._refine = torch.zeros((), dtype=torch.bool, device=b.device)
        self._inf = torch.full((), math.inf, dtype=b.dtype, device=b.device)
        if self.runner is None:
            self.runner = GraphRunner(b.device, self.pool)

    def _decide(self, r: torch.Tensor):
        """The JAX `cond`; the next inner solve's b and tolerance; the
        status slots."""
        inner = self.inner
        torch.logical_and(self._resn > self._tol,
                          self._i < self.max_refinements, out=self._refine)
        inner._b.copy_(r.to(self.lo_dtype))
        # rounds to the inner dtype, as `ir_cg_solve`'s float tolerance
        inner._tol.copy_(torch.where(self._refine,
                                     self.inner_rtol * self._resn, self._inf))
        slots = [self._refine, self._resn, self._k, self._i]
        if self.x_stat is not None:
            slots.append(self.x_stat(self._x))
        for j, v in enumerate(slots):
            inner._status[3 + j].copy_(v)

    def _start(self):
        """`ir_cg_solve`'s lines before the loop."""
        r = self._b - self.operator_hi(self._x0)
        self._x.copy_(self._x0)
        self._resn.copy_(torch.sqrt(self.dot(r, r)))
        self._k.zero_()
        self._i.zero_()
        self._decide(r)

    def _refinement(self):
        """The loop body after its inner solve."""
        inner = self.inner
        self._x.add_(inner._x.to(self._x.dtype))
        r = self._b - self.operator_hi(self._x)
        self._resn.copy_(torch.sqrt(self.dot(r, r)))
        self._k.add_(inner._k)
        self._i.add_(1)
        self._decide(r)

    # the estimate of `_expect_end` may exceed `tol` by this factor
    END_MARGIN = 4.0

    def _expect_end(self, resn_in, resn, resn_prev, i, tol) -> bool:
        """Whether the refinement just run (the `i`-th) should end the
        loop: the cap, or the new residual estimated at or below
        `END_MARGIN * tol`. The estimate is the larger of the inner
        solve's own residual and the current residual times the last
        refinement's reduction: the rounding of the f32 solves bounds
        the reduction well above `inner_rtol` (1e-5 to 5e-4 a refinement
        on the linear cells), so the inner residual alone promises too
        much. The last refinement of the linear Q2 cell reduces up to 4x
        more than the one before it, and far from the end the estimate
        exceeds `tol` a hundredfold or more (the linear cells on a CPU,
        `tools/linear_step_profile.py`'s configurations), hence the
        margin."""
        if i + 1 >= self.max_refinements:
            return True
        est = resn_in
        if resn_prev:
            est = max(est, resn * (resn / resn_prev))
        return est <= self.END_MARGIN * tol

    def __call__(self, b: torch.Tensor, x0: torch.Tensor, tol,
                 max_iter: int) -> CGResult:
        if self._like is None:
            self._allocate(b)
        elif (b.shape, b.dtype, b.device) != self._like:
            raise ValueError(
                f"ChunkedIRCG: b {tuple(b.shape)} {b.dtype} on {b.device}; "
                f"this solver's buffers are {tuple(self._like[0])} "
                f"{self._like[1]} on {self._like[2]}")
        inner = self.inner
        first = inner._like is None
        inner.bind(torch.empty_like(b, dtype=self.lo_dtype), max_iter)
        if first:
            inner._x0.zero_()
        self._b.copy_(b)
        self._x0.copy_(x0)
        tol = torch.tensor(float(tol), dtype=b.dtype).item()
        self._tol.fill_(tol)
        self.runner(("ir", "start"), self._start)
        syncs, launch, spent = 0, "inner", False
        outer = {}  # the true residual norm at each refinement count
        while True:
            if launch == "inner":  # the next inner solve's start and chunk
                inner._run(0)
            if launch != "none":
                inner._run(1)
            k_in, resn_in, tol_in, refine, resn, k, i, stat = (
                inner.read_status())
            syncs += 1
            outer[int(i)] = resn
            if not refine:
                break
            if launch == "none":  # read after the refinement: go on
                launch = "inner"
            elif resn_in > tol_in and k_in < max_iter:
                launch = "chunk"
            else:
                self.runner(("ir", "refine"), self._refinement)
                launch = ("none" if not spent and self._expect_end(
                    resn_in, resn, outer.get(int(i) - 1), int(i), tol)
                          else "inner")
                spent = launch == "none"
        return CGResult(x=self._x.clone(), iterations=int(k),
                        residual_norm=resn, converged=resn <= tol,
                        host_syncs=syncs,
                        x_stat=stat if self.x_stat is not None else None)


def make_cg(loop: str, operator: Callable,
            preconditioner: Optional[Callable] = None,
            chunk: int = CG_CHUNK, dot: Callable = _dot,
            pool=None) -> ChunkedCG:
    """The models' Krylov solve `solve(b, x0, tol, max_iter) -> CGResult`,
    one `ChunkedCG` for both loops: its chunks captured in CUDA graphs on
    a card (into `pool` if given) for `loop="graphs"`, run eagerly for
    `loop="host"` (`eager=True`: gloo ranks, whose collectives cannot be
    captured); on the CPU both run eagerly."""
    if loop not in CG_LOOPS:
        raise ValueError(f"unknown cg_loop {loop!r}; expected one of {CG_LOOPS}")
    return ChunkedCG(operator, preconditioner, chunk, dot, pool,
                     eager=loop == "host")
