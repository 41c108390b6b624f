"""params.loo_score_s (s): host seconds a pass of the anomaly sweep spent in
the numpy scoring of its daily leave-one-out runs (``xval.score`` records of
the traced window, over its ``xval.sweep_anoms`` records)."""


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
    sweeps = sum(r.name == "xval.sweep_anoms" for r in recs or ())
    if not sweeps:
        return None
    return sum(r.t1 - r.t0 for r in recs if r.name == "xval.score") / sweeps / 1e9
