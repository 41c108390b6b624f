"""engine.tile_pair_p95_ms: the 95th percentile (numpy's linear rule), over every
tile-pair written in the window, of the time from the start of its prepare
(main thread) to the end of its write and read-back verify (writer thread)."""

import collections

import numpy as np


def read(run):
    starts = collections.defaultdict(list)
    for s in run.spans:
        if s.name == "prepare_pair":
            starts[s.key].append(s.t0)
    lat = []
    for s in run.of("write_tile_pair"):
        if starts[s.key]:
            lat.append(s.t1 - starts[s.key].pop(0))
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
