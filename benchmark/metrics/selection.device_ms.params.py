"""selection.device_ms.params: device ms a call of neighbour selection in
the station-parameter stage (the leave-one-out neighbourhoods of the
variogram fits and the sweeps, cosine branch and ``topk``): the operations
launched inside the program's ``geo.select_neighbors`` ranges, over the
number of those ranges, by the profiler."""


def read(run):
    if run.trace is None:
        return None
    ops, n = run.trace.launched_in("geo.select_neighbors")
    return sum(o.t1 - o.t0 for o in ops) / n * 1e3 if n and ops else None
