"""engine.verify_share (%): the share of the engine writer's time spent
checking what it wrote: the read-back with its coverage counts
(``engine.write.verify``) and the cross-variable check on int32 copies
(``engine.write.viol``), over the whole write of each tile-pair
(``engine.write``), from the program's span records of the traced window."""


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
    recs = _records(run) or ()
    total = sum(r.t1 - r.t0 for r in recs if r.name == "engine.write")
    if not total:
        return None
    checks = sum(r.t1 - r.t0 for r in recs
                 if r.name in ("engine.write.verify", "engine.write.viol"))
    return 100.0 * checks / total
