"""krig_normals_roofline.grid-k (%): the least time of the tile step's
``krig_normals_indexed_kernel`` launches at per-variable sizes, over their
time in the profiler's trace. Each launch's least time comes from the shape
in the key of the program's ``step.krig`` range it was launched in (the
slots read, the systems' and the gain rows' prefixes, the systems) and the
cell's tile shape (``run.meta``), by ``counts/krig_normals_sized.py`` and
``benchlib/peaks.py``.

The trace's ``step.krig`` ranges and the program's ``step.krig`` records
are the same spans: taken in order, the i-th range has the i-th record's
key. Where their counts differ, a range takes the key of the record that
began nearest to it."""

import bisect

from benchlib import catalog, peaks


def _keys(run, ranges):
    """The ``step.krig`` key of each of ``ranges``, or None (no records)."""
    try:
        from topotpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    recs = sorted((r for r in recorded(*run.trace.window) if r.name == "step.krig"),
                  key=lambda r: r.t0)
    if not recs:
        return None
    if len(recs) == len(ranges):
        return [r.key for r in recs]
    starts = [r.t0 / 1e9 for r in recs]
    out = []
    for g in ranges:
        i = bisect.bisect_left(starts, g.t0)
        near = min((j for j in (i - 1, i) if 0 <= j < len(recs)),
                   key=lambda j: abs(starts[j] - g.t0))
        out.append(recs[near].key)
    return out


def read(run):
    shape = run.meta.get("krig_normals_sized")
    if run.trace is None or not shape:
        return None
    tr = run.trace
    ranges = sorted((r for r in tr.ranges if r.name == "step.krig"
                     and tr.window[0] <= r.t0 < tr.window[1]), key=lambda r: r.t0)
    keys = _keys(run, ranges) if ranges else None
    if not keys:
        return None
    starts = [r.t0 for r in ranges]
    c = catalog.load_module("counts", "krig_normals_sized")
    least = spent = 0.0
    for o in tr.kernels("krig_normals_indexed_kernel"):
        at = tr.launch_at.get(o.corr)
        i = bisect.bisect_right(starts, at[0]) - 1 if at else -1
        if i < 0 or at[0] > ranges[i].t1 or at[1] != ranges[i].tid:
            continue  # not the tile step's
        k, kn, ka, P = keys[i]
        sized = dict(shape, k=k, P=P, k_normal=kn, k_anom=ka)
        least += peaks.bound_s(c.nbytes(**sized), c.flops(**sized))
        spent += o.t1 - o.t0
    return 100.0 * least / spent if spent else None
