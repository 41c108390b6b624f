"""params.gn_fit_s (s): host seconds a pass of the variogram fits, one a
month (the residuals, the empirical variogram and the Gauss-Newton fit:
``variogram.fit`` records of the traced window, over its
``params.krig_params`` records)."""


def _records(run):
    """The program's span records inside the traced window, or None (no
    trace, or a program without spans)."""
    if run.trace is None:
        return None
    try:
        from topotpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    return recorded(*run.trace.window)


def read(run):
    recs = _records(run)
    calls = sum(r.name == "params.krig_params" for r in recs or ())
    if not calls:
        return None
    return sum(r.t1 - r.t0 for r in recs if r.name == "variogram.fit") / calls / 1e9
