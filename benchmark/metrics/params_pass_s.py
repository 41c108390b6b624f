"""params_pass_s (s): the window over the passes it holds; a pass is
``build_krig_params`` + ``optimize_nnghs`` + ``optimize_nnghs_anoms`` over
the network."""


def read(run):
    n = run.counters.get("passes", 0)
    return run.window_s / n if n else None
