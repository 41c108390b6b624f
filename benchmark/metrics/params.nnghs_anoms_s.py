"""params.nnghs_anoms_s (s): host seconds a pass in ``optimize_nnghs_anoms``
(the daily leave-one-out sweep; it returns numpy, so it ends synchronised)."""


def read(run):
    s = run.of("nnghs_anoms")
    return sum(x.t1 - x.t0 for x in s) / len(s) if s else None
