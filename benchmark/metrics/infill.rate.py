"""infill.rate (stations/s): target stations serially completed by
``infill_network`` in the window, over all the time of the window's calls."""


def read(run):
    n = run.counters.get("targets", 0)
    return n / run.window_s if n else None
