"""ranks.end_wait_share (%): the share of the job's rank-time in the window
that its ranks spent waiting at a barrier (the program's
``multihost.barrier`` span records of every rank, clipped to rank 0's
window), over the number of ranks x the window: what the slowest rank costs
the others, the wait to open the window included. Nothing without a trace,
or from a program whose barriers take no span."""


def read(run):
    ranks = run.meta.get("ranks")
    if run.trace is None or not ranks or run.window_s <= 0:
        return None
    w0, w1 = run.window
    waits = [(t0 / 1e9, t1 / 1e9) for r in ranks for name, t0, t1 in r.get("records", ())
             if name == "multihost.barrier"]
    if not waits:
        return None
    inside = sum(max(0.0, min(t1, w1) - max(t0, w0)) for t0, t1 in waits)
    return 100.0 * inside / (len(ranks) * run.window_s)
