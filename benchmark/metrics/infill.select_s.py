"""infill.select_s (s): host seconds an ``infill_network`` call spent
choosing each target's predictor stations (``infill.select_predictors``
records of the traced window, over its ``infill.call`` records)."""


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
    calls = sum(r.name == "infill.call" for r in recs or ())
    if not calls:
        return None
    return sum(r.t1 - r.t0 for r in recs if r.name == "infill.select_predictors") / calls / 1e9
