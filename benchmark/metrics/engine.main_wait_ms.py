"""engine.main_wait_ms: host ms a tile-pair that the engine's main thread
spent blocked in the traced window: waiting for a free pinned product
buffer (``engine.buffer_wait``), for room in the fetch queue
(``engine.queue_wait``) and for a staging slot's last copy
(``engine.stage_wait``), summed over the program's span records of that
thread, over the tile-pairs written (``engine.write`` records)."""

WAITS = ("engine.buffer_wait", "engine.queue_wait", "engine.stage_wait")


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
    ns = sum(r.t1 - r.t0 for r in recs if r.name in WAITS and r.thread == run.main_thread)
    return ns / pairs / 1e6
