"""selection.device_ms.grid: device ms a tile-pair of neighbour selection in
the tile step: the operations launched inside the program's
``geo.distance`` (the tile's distance matrix) and ``geo.select_neighbors``
(masking and ``topk``) ranges, summed, over the ``engine.launch`` ranges,
by the profiler."""


def read(run):
    if run.trace is None:
        return None
    _, n = run.trace.launched_in("engine.launch")
    if not n:
        return None
    ops = {}
    for name in ("geo.distance", "geo.select_neighbors"):
        ops.update((o.corr, o) for o in run.trace.launched_in(name)[0])
    return sum(o.t1 - o.t0 for o in ops.values()) / n * 1e3 if ops else None
