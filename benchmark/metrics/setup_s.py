"""Set-up: process start to the first timed step (imports, the kernels'
library, the model build, the warm-up that captures the cell's CUDA
graphs), host clock."""


def read(run):
    return run.setup_s
