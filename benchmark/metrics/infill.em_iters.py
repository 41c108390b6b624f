"""infill.em_iters (iters): the mean of ``InfillResult.n_iters`` over the
targets the window's calls completed."""


def read(run):
    it = run.values.get("em_iters")
    return sum(it) / len(it) if it else None
