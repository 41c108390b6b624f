"""ppca.launches_per_iter (ops): device operations launched a trip of the
PPCA EM loop: those whose launch lies inside one of the program's
``ppca.em_step`` ranges, over the number of those ranges, by the
profiler."""


def read(run):
    if run.trace is None:
        return None
    ops, n = run.trace.launched_in("ppca.em_step")
    return len(ops) / n if n else None
