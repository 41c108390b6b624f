"""engine.prepare_ms: mean host ms a tile-pair of the engine's main thread in
``prepare_pair`` (cell fields, the station pool, pinned staging, the copy)."""


def read(run):
    s = run.of("prepare_pair")
    return sum(x.t1 - x.t0 for x in s) / len(s) * 1e3 if s else None
