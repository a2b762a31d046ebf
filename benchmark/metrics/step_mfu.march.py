"""The whole step's share of the card's peak over the traced stretch: the
least time one H100 needs for the work the stretch's counters say was
needed, over the stretch's length (host clock), in %. Counted
(`harness/roofline.py`): the tangent matvecs and the V-cycles' Q1 level
applications, as the two rooflines count them, and each tangent
assembly's write of the per-cell f32 tangents. The rest of the step's
work is not counted, so the share is a lower bound that still bounds the
kernels' gains: a kernel taken off the path leaves its roofline silent
and this share reading on."""

from benchmark.harness import roofline


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    cfg = run.config
    cg = sum(st["cg_its"] for st in run.traced_steps)
    asm = sum(st["tangent_asm"] for st in run.traced_steps)
    need = cg * roofline.vcycle_levels_s(cfg)
    if cfg["params"]["model"] == "neo-Hookean":
        need += cg * roofline.tangent_matvec_s(cfg) + asm * roofline.tangent_write_s(cfg)
    return 100.0 * need / run.trace.wall_s
