"""engine.fetch_wait_ms: host ms a tile-pair that the engine's fetch thread
waited for a product's copy into pinned memory (``engine.fetch_wait``
records of the traced window, over the tile-pairs written there)."""


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
    pairs = sum(r.name == "engine.write" for r in recs or ())
    if not pairs:
        return None
    return sum(r.t1 - r.t0 for r in recs if r.name == "engine.fetch_wait") / pairs / 1e6
