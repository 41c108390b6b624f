"""setup_s: seconds from the process's start to the window's first
operation: imports, the world, the kernels' build or load, warm-up."""


def read(run):
    return run.setup_s
