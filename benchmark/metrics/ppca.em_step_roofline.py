"""ppca.em_step_roofline (%): the least time of a trip of the PPCA EM loop
over its device time. The device time is that of the operations launched
inside the program's ``ppca.em_step`` ranges, by the profiler, over the
number of those ranges; the least time is each trip's, from the key
(B, T, V, q) of the ``ppca.impute`` span that holds it (the program's span
records: a trip's parent), by the frozen counts (``counts/ppca_em_step.py``,
``benchlib/peaks.py``), averaged over the trips. Nothing where the program
has no ``ppca.impute`` spans."""

from benchlib import catalog, peaks


def read(run):
    if run.trace is None:
        return None
    try:
        from topotpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    recs = recorded(*run.trace.window)
    shape = {r.id: r.key for r in recs if r.name == "ppca.impute"
             and isinstance(r.key, tuple) and len(r.key) == 4}
    trips = [shape[r.parent] for r in recs if r.name == "ppca.em_step" and r.parent in shape]
    ops, n = run.trace.launched_in("ppca.em_step")
    if not trips or not ops or not n:
        return None
    c = catalog.load_module("counts", "ppca_em_step")
    least = sum(peaks.bound_s(c.nbytes(*k), c.flops(*k)) for k in trips) / len(trips)
    return 100.0 * least / (sum(o.t1 - o.t0 for o in ops) / n)
