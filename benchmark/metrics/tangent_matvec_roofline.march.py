"""The Newton tangent's matvec (K1 today) over the traced stretch: the
least time one H100 needs for the matvecs the stretch's CG iterations
need (one each; the per-cell f32 tangents read once, the cell vectors
read and written once, `roofline.tangent_matvec_s`), over the device time
of the kernels named in `tangent_matvec_roofline.march.kernels/`, in %."""

from benchmark.harness import roofline


def read(run):
    if run.config["params"]["model"] != "neo-Hookean" or run.trace is None:
        return None
    from benchmark.harness.cell import kernel_patterns

    matvecs = sum(st["cg_its"] for st in run.traced_steps)
    t = run.trace.seconds_matching(kernel_patterns("tangent_matvec_roofline.march"))
    if t <= 0 or matvecs == 0:
        return None
    return 100.0 * matvecs * roofline.tangent_matvec_s(run.config) / t
