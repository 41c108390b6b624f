"""The grid cell's one-chunk sink: a cell the current chunk has not written
reads back as the sentinel, in the engine's read-back and in the sampled
snapshots, though the buffer still holds the chunk before."""

import numpy as np
import tiny  # noqa: F401  (paths)

from benchlib import sink as sinks


class Grid:
    nrows, ncols = 4, 8


def test_unwritten_cells_read_as_the_sentinel():
    rows, cols = np.array([0, 0]), np.array([1, 5])  # one sampled cell in each tile
    Sink = sinks.make_sink(rows, cols, max_days=3)
    Sink.prepare(Grid.nrows, Grid.ncols, ("tmin",))
    w = Sink("m", "tmin", Grid, None, 0.01, 0.0, 4, 4)
    tile = np.arange(3 * 16, dtype=np.int16).reshape(3, 4, 4)
    w.write_tile(0, 0, tile, None, None, t0=0)
    w.write_tile(0, 4, tile + 100, None, None, t0=0)
    assert (w.read_tile_raw(0, 4, 4, 4, t0=0) == tile + 100).all()
    w.write_tile(0, 0, tile + 200, None, None, t0=3)  # the next chunk writes one tile
    assert (w.read_tile_raw(0, 0, 4, 4, t0=3) == tile + 200).all()
    assert (w.read_tile_raw(0, 4, 4, 4, t0=3) == sinks.SENTINEL).all()
    assert (w.read_tile_raw(0, 0, 4, 4, t0=0) == sinks.SENTINEL).all()  # a retired chunk
    w.finalize(2, True)
    (t0a, first), (t0b, second) = Sink.SNAPSHOTS["tmin"]
    assert (t0a, t0b) == (0, 3)
    assert (first[:, 0] == tile[:, 0, 1]).all() and (first[:, 1] == tile[:, 0, 1] + 100).all()
    assert (second[:, 0] == tile[:, 0, 1] + 200).all()
    assert (second[:, 1] == sinks.SENTINEL).all()
