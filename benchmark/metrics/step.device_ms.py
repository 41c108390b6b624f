"""step.device_ms: device ms a tile-pair of the kernels (and copies) that each
step call launched, by the profiler: the operations whose launch lies
inside a ``bench.step`` range, summed, over the number of ranges."""


def read(run):
    if run.trace is None:
        return None
    ops, n = run.trace.launched_in("bench.step")
    return sum(o.t1 - o.t0 for o in ops) / n * 1e3 if n and ops else None
