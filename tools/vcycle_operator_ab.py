#!/usr/bin/env python3
"""The 3D Neo-Hookean step with the V-cycle's operators swapped: the
kernels' arithmetic against the plain versions', in one process.

    python3 tools/vcycle_operator_ab.py [--scale 9] [--steps 1] \
        [--device cuda] [--variants all] [--trace] [--audit] \
        [--perturb N] [--from-cpu vcycle|tangent|assembly|matvec] \
        [--assembly-f32]

Builds `chip_smoke.py`'s 3D benchmark model (`NONLINEAR`, bf16 multigrid
hierarchy) at `scale` once for each way of computing the V-cycle's fine
proxy and Q1 level operators, and runs `steps` steps from rest with
traction 1000 in x on the interface:

* `kernels`: the model as it runs on the card, K5 (E split into two bf16
  terms, about f32) and K3 (f32 per-node-class tables), each rounding its
  f32 sums once to bf16;
* `plain f32`: the kernels' plain versions (`StructuredOperator` in f32,
  rounded once to bf16), what the port runs on the CPU;
* `plain bf16`: the bf16 `StructuredOperator` (bf16 element matrix, bf16
  products, overlap-add rounded a slot at a time), what the JAX package
  runs on the CPU; tests/test_torch_nonlinear.py's
  `test_bf16_vcycle_equals_jax_bitwise_3d` swaps the operators the same
  way;

and then `kernels` with the `plain bf16` hierarchy's lam_max values and
`plain bf16` with the `kernels` ones, which separates the estimate from
the smoother. For each hierarchy it prints the lam_max of every level
(each level's 12-step power iteration runs through the same operator the
level's smoother applies) and that estimate taken again through the
level's operator, which must give the same value; for each step the CG
iterations of every Newton correction, the Newton count and the checksum
||u||^2. `--variants` runs a comma-separated subset of the names above
(`kernels` and `plain f32` are one computation on the CPU, where the
wrappers run their plain versions). `--trace` adds, for every Newton
correction, the norm of its right-hand side, the CG tolerance and the CG
residual after each iteration (the norms of the residuals the V-cycle is
applied to), so that a run on the card and one on the CPU can be read
side by side up to the first line that differs. Nothing here is on the
package's path: the swaps are made by replacing the two factories the
model calls, and the count and the trace by wrapping the CG solve the
model builds (`make_cg`, in the model's module).

`--perturb N` runs each step N times more with the traction scaled by
1 + k * 1e-6 (k = 1 .. N), which samples how far the counts move under a
perturbation far below the solver's tolerances. `--from-cpu vcycle`
(`tangent`, `assembly`, `matvec`) runs the model on the card with its
V-cycle (its tangent assembly and matvec, or one of the two) computed by
the same model built on the CPU, the operands copied across for every
call: which piece's device arithmetic moves the counts.
`--assembly-f32` contracts the element tangents (the matrix product
S @ A of the assembly, which the package sums in f64 and rounds once to
f32) as one f32 product instead, to compare the two.

`--audit` instead builds the model (`kernels`) on the card and on the CPU
and applies every piece of the first Newton correction's CG to the same
inputs on both: the f64 residual, the assembled tangent (and on the
card and on the CPU, how far each cell's element tangent at u = 0 lies
from the first cell's), the tangent matvec on random vectors, on the
V-cycle of the residual and on a rigid translation, the whole V-cycle,
the residual after one CG iteration, and on every level the level
operator, one Chebyshev smoothing, the restriction and prolongation and
the coarse solve. It prints each
piece's relative L2 difference between the card and the CPU and the
share of bf16 entries that differ, so that the first piece whose
difference exceeds the roundoff of its dtype names itself.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


class _Plain:
    """A level operator computed by its kernel's plain version."""

    def __init__(self, op):
        self.op = op

    def __call__(self, u):
        return self.op.plain(u)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=cs.SCALE)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--variants", default="all")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--audit", action="store_true")
    ap.add_argument("--perturb", type=int, default=0)
    ap.add_argument("--from-cpu", default=None,
                    choices=("vcycle", "tangent", "assembly", "matvec"))
    ap.add_argument("--assembly-f32", action="store_true")
    args = ap.parse_args()
    if args.assembly_f32:
        contract_in_f32()
    if args.audit:
        return audit(args.scale, args.device)

    import torch

    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.models import nonlinear_elasticity as nl
    from dealii_adapter_tpu_torch.ops import q1_structured, q2_structured
    from dealii_adapter_tpu_torch.ops.structured import _grid_shape
    from dealii_adapter_tpu_torch.solvers import cg
    from dealii_adapter_tpu_torch.solvers import multigrid as mg

    dev = torch.device(args.device)
    if dev.type == "cuda":
        log_card = cs.phase_device()
        print(f"card: {log_card}", flush=True)

    def plain_f32_q2(space, E, dtype=torch.float32, device=None):
        return _Plain(q2_structured.make_q2_operator(space, E, dtype, device))

    def plain_f32_q1(space, E, dtype=torch.float32, device=None):
        return _Plain(q1_structured.make_q1_operator(space, E, dtype, device))

    def plain_bf16(space, E, dtype=torch.float32, device=None):
        return q2_structured._PlainDegreeOperator(
            E, _grid_shape(space), space.mesh.degree, dtype, device)

    factories = {
        "kernels": (q2_structured.make_q2_operator,
                    q1_structured.make_q1_operator),
        "plain f32": (plain_f32_q2, plain_f32_q1),
        "plain bf16": (plain_bf16, plain_bf16),
    }
    solves = []
    make_cg = nl.make_cg

    def counted_cg(loop, op, preconditioner=None, *rest):
        """The model's CG (`make_cg`: the eager `ChunkedCG` under
        cg_loop="host"), each solve's iterations counted and, with
        --trace, the residual norm of every preconditioner application
        (the start's and one an iteration) recorded."""
        history = []

        def traced(r):
            history.append(float(torch.linalg.vector_norm(r.double())))
            return preconditioner(r)

        solve = make_cg(loop, op, traced if args.trace else preconditioner,
                        *rest)

        def counted(b, x0, tol, max_iter):
            history.clear()
            r = solve(b, x0, tol, max_iter)
            solves.append(r.iterations)
            if args.trace:
                print(f"  correction {len(solves)}: ||rhs|| "
                      f"{float(torch.linalg.vector_norm(b.double()))!r} tol "
                      f"{float(tol)!r}: {r.iterations} CG, residual "
                      f"{r.residual_norm!r}; CG residuals {history}",
                      flush=True)
            return r

        return counted

    # the models run their CG chunks eagerly (cg_loop="host"), so the
    # traced preconditioner's read-backs are allowed
    nl.make_cg = counted_cg
    mesh_tags = make_scenario_grid("PF", 3, 2, scale=args.scale,
                                   solver="neo-Hookean")
    lam = {}

    def run(name, ops, lam_from=None):
        nl.make_q2_operator, mg.make_q1_operator = factories[ops]
        t0 = time.perf_counter()
        model = cs.build_model(dev, scale=args.scale, mesh_tags=mesh_tags,
                               mg_lam_max=lam.get(lam_from), cg_loop="host")
        levels = model._precond.levels
        lam.setdefault(name, [lv.lam_max for lv in levels])
        again = [cg.estimate_lambda_max(lv.operator, lv.diag,
                                        (lv.diag.shape[0], 3))
                 for lv in levels if lv.coarse_solve is None]
        print(f"{name}: built in {time.perf_counter() - t0:.1f} s, "
              f"{model.space.n_dofs} DoF; lam_max "
              f"{[lv.lam_max for lv in levels]}"
              + (f" (from {lam_from})" if lam_from else
                 f", again through each level's operator {again}"),
              flush=True)
        if lam_from is None and again != lam[name][:len(again)]:
            raise RuntimeError(f"{name}: lam_max estimates differ {again}")
        if args.from_cpu:
            from_cpu(model, args.from_cpu, torch.device("cpu"),
                     cs.build_model(torch.device("cpu"), scale=args.scale,
                                    mesh_tags=mesh_tags,
                                    mg_lam_max=lam[name], cg_loop="host"))
        stress = cs.interface_traction(model)
        state = model.initial_state()
        for i in range(args.steps):
            for k in range(args.perturb + 1):
                solves.clear()
                t0 = time.perf_counter()
                new, info = model.step(state, (1.0 + k * 1e-6) * stress)
                u = new.displacement
                print(f"{name}: step {i}{f' traction x (1 + {k}e-6)' if k else ''} "
                      f"{time.perf_counter() - t0:.2f} s: CG per Newton "
                      f"correction {solves} = {info.cg_iterations}, Newton "
                      f"{info.iterations}, converged {info.converged}, "
                      f"checksum {float((u * u).sum())!r}", flush=True)
                if k == 0:
                    state_next = new
            state = state_next
        del model, state
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    runs = (("kernels", "kernels", None), ("plain f32", "plain f32", None),
            ("plain bf16", "plain bf16", None),
            ("kernels, plain bf16's lam_max", "kernels", "plain bf16"),
            ("plain bf16, the kernels' lam_max", "plain bf16", "kernels"))
    wanted = None if args.variants == "all" else args.variants.split(",")
    for name, ops, lam_from in runs:
        if wanted is None or name in wanted:
            run(name, ops, lam_from)


def contract_in_f32():
    """Make the tangent assembly's contraction S @ A_de one f32 product
    (`ops/assembled_tangent.py:_assemble_upper` sums it in f64)."""
    import torch

    from dealii_adapter_tpu_torch.ops import assembled_tangent as at

    class _Narrow:
        def __init__(self, S):
            self.S = S

        def to(self, dtype):
            return self

        def __matmul__(self, A):
            return (self.S @ A.to(self.S.dtype)).to(torch.float64)

    assemble = at._assemble_upper

    def narrow(ut, G, w, material, mass_term, S):
        if S is None:
            S = at.contraction_basis(G, w)
        return assemble(ut, G, w, material, mass_term, _Narrow(S))

    at._assemble_upper = narrow


def from_cpu(model, piece, cpu, host):
    """Replace `model`'s V-cycle (`piece` "vcycle"), its tangent assembly
    and matvec ("tangent") or one of the two ("assembly", "matvec") with
    `host`'s, the same model on the CPU, each call's operands copied to
    the CPU and the result back (a tangent layout of one tensor: K1, K1b,
    K2)."""
    if piece == "vcycle":
        pre = host._precond

        def vcycle(r):
            return pre(r.to(cpu)).to(r.device)

        model._precond = vcycle
        return
    assemble_h, make_h = host._make_tangent_fns()
    assemble_d, make_d = model._make_tangent_fns()
    dev = model.device

    def fns():
        def assemble(u_t, out=None):
            if piece == "matvec":
                Kt = assemble_d(u_t).to(cpu)
            else:
                Kt = assemble_h(u_t.to(cpu))
                Kt = Kt.to(dev) if piece == "assembly" else Kt
            return Kt if out is None else out.copy_(Kt)

        def make(Kt):
            if piece == "assembly":
                return make_d(Kt)
            op = make_h(Kt)
            return lambda v: op(v.to(cpu)).to(v.device)

        return assemble, make

    model._make_tangent_fns = fns


def audit(scale, device):
    """The pieces of one CG iteration on the card (`device`; the CPU
    against itself with "cpu") against the same pieces on the CPU, on the
    same inputs (see the module docstring)."""
    import torch

    from dealii_adapter_tpu_torch.mesh.generator import make_scenario_grid
    from dealii_adapter_tpu_torch.solvers import cg
    from dealii_adapter_tpu_torch.solvers import multigrid as mg

    cuda, cpu = torch.device(device), torch.device("cpu")
    if cuda.type == "cuda":
        print(f"card: {cs.phase_device()}", flush=True)
    mesh_tags = make_scenario_grid("PF", 3, 2, scale=scale,
                                   solver="neo-Hookean")
    host = cs.build_model(cpu, scale=scale, mesh_tags=mesh_tags)
    lam = [lv.lam_max for lv in host._precond.levels]
    card = cs.build_model(cuda, scale=scale, mesh_tags=mesh_tags,
                          mg_lam_max=lam)
    print(f"scale {scale}: {host.space.n_dofs} DoF, lam_max {lam}", flush=True)
    g = torch.Generator().manual_seed(3)

    def both(fn, *args):
        """fn(model, *args on that model's device) for the CPU and the card,
        compared on the CPU."""
        a = fn(host, *[x.to(cpu) for x in args])
        b = fn(card, *[x.to(cuda) for x in args]).to(cpu)
        return a, b

    def report(name, a, b):
        d = (a.double() - b.double()).norm() / a.double().norm()
        share = (a != b).double().mean()
        print(f"audit {name} ({a.dtype}, {tuple(a.shape)}): rel L2 card vs "
              f"CPU {float(d):.3e}, entries that differ {float(share):.3%}",
              flush=True)

    stress = cs.interface_traction(host)
    state = host.initial_state()
    zero = torch.zeros_like(state.displacement)
    rhs, _ = host.residual(zero, state, stress)
    a, b = both(lambda m, z, s: m.residual(
        z, type(state)(z, z, z), s)[0], zero, stress)
    report("f64 residual at the predictor", a, b)
    r32 = rhs.to(torch.float32)
    mask = host.mask.to(torch.float32)
    v = torch.randn(r32.shape, generator=g) * mask
    u_t = 1e-4 * torch.randn(r32.shape, generator=g) * mask

    def matvec(m, u, x):
        assemble, make = m._make_tangent_fns()
        return make(assemble(u))(x)

    report("assembled tangent at a random u", *both(
        lambda m, u: m._make_tangent_fns()[0](u), u_t))
    for where, K in zip(("CPU", "card"), both(
            lambda m, u: m._make_tangent_fns()[0](u), 0 * u_t)):
        spread = (K - K[:, :, :1]).abs().max() / K.abs().max()
        print(f"audit tangent at u = 0 on the {where}: largest difference "
              f"between a cell's element matrix and the first cell's, over "
              f"the largest entry: {float(spread):.3e}; asymmetry "
              f"{float((K - K.transpose(0, 1)).abs().max() / K.abs().max()):.3e}",
              flush=True)
    z0 = host._precond(r32)
    report("tangent matvec at u = 0 on the V-cycle of the residual", *both(
        matvec, 0 * u_t, z0))
    ones = torch.zeros_like(v)
    ones[:, 0] = 1.0
    report("tangent matvec at u = 0 on a translation (x)", *both(
        matvec, 0 * u_t, ones * mask))
    report("tangent matvec at u = 0", *both(matvec, 0 * u_t, v))
    report("tangent matvec at a random u", *both(matvec, u_t, v))
    report("V-cycle on the residual", *both(lambda m, r: m._precond(r), r32))

    def cg_step(m, r):  # the first CG iteration at u = 0: its residual
        assemble, make = m._make_tangent_fns()
        op = make(assemble(torch.zeros_like(r)))
        x = cg.cg_solve(op, r, torch.zeros_like(r), tol=0.0, max_iter=1,
                        preconditioner=m._precond).x
        return r - op(x)

    report("residual after one CG iteration", *both(cg_step, r32))
    report("V-cycle on a random vector", *both(lambda m, r: m._precond(r), v))
    for li, lv in enumerate(host._precond.levels):
        n = lv.diag.shape[0]
        dt = lv.diag.dtype
        x = (torch.randn(n, 3, generator=g) * lv.mask.float()).to(dt)
        if lv.coarse_solve is not None:
            report(f"level {li} coarse solve", *both(
                lambda m, b: m._precond.levels[li].coarse_solve(b), x))
            continue
        report(f"level {li} operator", *both(
            lambda m, y: m._precond.levels[li].operator(y), x))
        deg = (host._precond.smooth_degree_fine if li == 0
               else host._precond.smooth_degree)
        report(f"level {li} Chebyshev pre-smoothing (degree {deg})", *both(
            lambda m, y: mg._chebyshev_smooth(
                m._precond.levels[li], y, torch.zeros_like(y), deg,
                x_is_zero=True), x))
        report(f"level {li} restriction", *both(
            lambda m, y: m._precond._restrict(li, y), x))
        nc = host._precond.levels[li + 1].diag.shape[0]
        ec = (torch.randn(nc, 3, generator=g)
              * host._precond.levels[li + 1].mask.float()).to(dt)
        report(f"level {li} prolongation", *both(
            lambda m, y: m._precond._prolong(li, y), ec))


if __name__ == "__main__":
    main()
