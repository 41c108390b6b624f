"""step.krig_launches (ops): the tile step's ``krig_normals_indexed``
launches a tile-pair: the program's ``step.krig`` records (one a launch,
keyed by its sizes) over its ``engine.launch`` records, in the traced
window. One where both variables take one (k, ka), two where they differ."""


def read(run):
    if run.trace is None:
        return None
    try:
        from topotpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    recs = recorded(*run.trace.window)
    steps = sum(r.name == "engine.launch" for r in recs)
    krig = sum(r.name == "step.krig" for r in recs)
    return krig / steps if steps and krig else None
