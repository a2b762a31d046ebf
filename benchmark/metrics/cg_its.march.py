"""CG iterations a step, every Newton correction's or refinement pass's
(`NewtonInfo.cg_iterations`, `StepInfo.iterations`), over the window."""


def read(run):
    if not run.steps:
        return None
    return sum(s["cg_its"] for s in run.steps) / len(run.steps)
