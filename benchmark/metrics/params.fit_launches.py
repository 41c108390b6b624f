"""params.fit_launches (ops): device operations launched a month of the
station-parameter build's variogram fits (the residuals, the empirical
variogram and the fit): those whose launch lies inside one of the program's
``variogram.fit`` ranges, over the number of those ranges, by the
profiler."""


def read(run):
    if run.trace is None:
        return None
    ops, n = run.trace.launched_in("variogram.fit")
    return len(ops) / n if n else None
