"""scatter_daily_packed_roofline (%): the least time of the tile steps'
``scatter_daily_packed_kernel`` launches by the frozen counts
(``counts/scatter_daily_packed.py``, ``benchlib/peaks.py``), each step at its
chunk's day count, over their time in the profiler's trace."""

from benchlib import catalog, peaks


def read(run):
    shape, days = run.meta.get("scatter_daily_packed"), run.meta.get("chunk_days")
    ops = run.trace.kernels("scatter_daily_packed_kernel") if run.trace and shape else []
    if not ops:
        return None
    c = catalog.load_module("counts", "scatter_daily_packed")
    w0, w1 = run.trace.window
    steps = [s for s in run.spans if s.name == "step_launch" and w0 <= s.t0 < w1]
    if len(steps) != len(ops):
        return None  # the launches and the steps do not pair: nothing sound to read
    least = sum(peaks.bound_s(c.nbytes(ndays=days[s.key[0]], **shape),
                              c.flops(ndays=days[s.key[0]], **shape)) for s in steps)
    return 100.0 * least / sum(o.t1 - o.t0 for o in ops)
