"""Newton iterations a step (`NewtonInfo.iterations`), over the window."""


def read(run):
    if not run.steps or run.config["params"]["model"] != "neo-Hookean":
        return None
    return sum(s["newton_its"] for s in run.steps) / len(run.steps)
