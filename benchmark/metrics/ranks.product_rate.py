"""ranks.product_rate (var-cell-days/s): 2 variables x land cells x days of
every tile-pair that the job's ranks wrote and verified in the window, over
the window (rank 0's: from its start to its leaving the barrier that closes
it, which is when the slowest rank is done). Each rank's count is its
engine's, returned by the driver of the cell; nothing where no rank
returned one."""


def read(run):
    ranks = run.meta.get("ranks")
    n = sum(r["var_cell_days"] for r in ranks or ())
    return n / run.window_s if n and run.window_s > 0 else None
