"""The V-cycle's Q1 level operators (K3 today) over the traced stretch:
the least time one H100 needs for the level applications the stretch's
V-cycles need (one V-cycle a CG iteration, `roofline.vcycle_levels_s`),
over the device time of the kernels named in
`q1_level_roofline.march.kernels/`, in %."""

from benchmark.harness import roofline


def read(run):
    if run.trace is None:
        return None
    from benchmark.harness.cell import kernel_patterns

    vcycles = sum(st["cg_its"] for st in run.traced_steps)
    t = run.trace.seconds_matching(kernel_patterns("q1_level_roofline.march"))
    if t <= 0 or vcycles == 0:
        return None
    return 100.0 * vcycles * roofline.vcycle_levels_s(run.config) / t
