"""engine.write_ms: mean host ms a tile-pair of the engine's writer thread in
``_write_tile_pair`` (mosaic write, read-back verify, manifest)."""


def read(run):
    s = run.of("write_tile_pair")
    return sum(x.t1 - x.t0 for x in s) / len(s) * 1e3 if s else None
