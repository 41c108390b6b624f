"""krig_normals_roofline.grid (%): the least time of the tile step's
``krig_normals_indexed_kernel`` launches by the frozen counts
(``counts/krig_normals.py``, ``benchlib/peaks.py``), over their time in the
profiler's trace."""

from benchlib import catalog, peaks


def read(run):
    shape = run.meta.get("krig_normals")
    ops = run.trace.kernels("krig_normals_indexed_kernel") if run.trace and shape else []
    if not ops:
        return None
    c = catalog.load_module("counts", "krig_normals")
    least = len(ops) * peaks.bound_s(c.nbytes(**shape), c.flops(**shape))
    return 100.0 * least / sum(o.t1 - o.t0 for o in ops)
