"""step.launches (ops): device operations (kernels, copies, memsets) a
tile-pair whose launch lies inside one of the program's ``engine.launch``
ranges (the step's enqueue, sharding and the start of its product's copy
to the host), over the number of those ranges, by the profiler."""


def read(run):
    if run.trace is None:
        return None
    ops, n = run.trace.launched_in("engine.launch")
    return len(ops) / n if n else None
