"""infill.select_device_ms (ms): device ms a predictor selection on the
device: the operations launched inside the program's
``infill.select.device`` ranges (the upload of the standardised series and
the mask, the targets' gram rows, the scores, ``topk``, the fetch of the
indices), summed, over the number of those ranges, by the profiler."""


def read(run):
    if run.trace is None:
        return None
    ops, n = run.trace.launched_in("infill.select.device")
    return sum(o.t1 - o.t0 for o in ops) / n * 1e3 if n and ops else None
