"""engine.product_rate (var-cell-days/s): 2 variables x land cells x days of
every tile-pair written and verified in the window, over the window: from
its start until the engine returned, the last chunk's overrun included."""


def read(run):
    n = run.counters.get("var_cell_days", 0)
    return n / run.window_s if n else None
