"""The grid cell's mosaic sink: the direct-mode writer's interface on numpy
arrays in host memory, holding one chunk of days.

A frozen copy of ``chip_smoke.py::MemoryMosaic`` (the card's machine has no
``h5py``), changed to hold one chunk: a 1948-2016 mosaic of the region would
take 52 GB a variable, one year 0.8 GB. The daily buffer is made once, in
set-up (``prepare``). A mask of the cells written in the current chunk
stands in for a file's fill value: a cell this chunk has not written reads
back as the sentinel, in the engine's read-back and in the snapshots, as
if the buffer had been refilled when the chunk began, without rewriting
0.8 GB a variable at each chunk inside the measured window. When a chunk is
retired (the next one begins, or the mosaic is finalised) the values of the
sampled cells are copied out for the comparison with the reference: that is
all of the chunk that outlives it. Monthly normals and se, which the engine
writes from its first chunk only, are kept whole.
"""

from __future__ import annotations

import pathlib

import numpy as np

SENTINEL = -32768


def make_sink(rows: np.ndarray, cols: np.ndarray, max_days: int = 366):
    """A writer class for one run. Its instances register under their
    variable in ``cls.OPEN``; ``cls.SNAPSHOTS[var]`` collects, per retired
    chunk, ``(t0, int16 (nt, n_samples))`` of the sampled cells ``rows``,
    ``cols``; ``cls.prepare(shape)`` makes the daily buffers in set-up."""

    class ChunkMosaic:
        OPEN: dict = {}
        SNAPSHOTS: dict = {}
        BUFFERS: dict = {}

        @classmethod
        def prepare(cls, nrows: int, ncols: int, variables=("tmin", "tmax")) -> None:
            for v in variables:
                cls.BUFFERS[v] = np.full((max_days, nrows, ncols), SENTINEL, np.int16)

        def __init__(self, path, var, grid, dates, daily_scale, daily_offset, tile_rows,
                     tile_cols, compress=0):
            self.path = pathlib.Path(path)
            self.var = var
            self.fresh = True
            shape = (grid.nrows, grid.ncols)
            if var not in self.BUFFERS or self.BUFFERS[var].shape[1:] != shape:
                self.BUFFERS[var] = np.full((max_days,) + shape, SENTINEL, np.int16)
            self.daily = self.BUFFERS[var]
            self.written = np.zeros(shape, bool)  # cells written in the current chunk
            self.normal = np.full((12,) + shape, np.nan, np.float32)
            self.se = np.full((12,) + shape, np.nan, np.float32)
            self.attrs = {"scale_factor": float(np.float32(daily_scale)),
                          "add_offset": float(np.float32(daily_offset)), "layout": "direct"}
            self.t0 = None
            self.nt = 0
            self.OPEN[var] = self
            self.SNAPSHOTS.setdefault(var, [])

        def _retire(self) -> None:
            if self.t0 is not None:
                snap = self.daily[: self.nt, rows, cols].copy()
                snap[:, ~self.written[rows, cols]] = SENTINEL
                self.SNAPSHOTS[self.var].append((self.t0, snap))
                self.t0 = None

        def _chunk(self, t0: int, nt: int) -> None:
            if t0 != self.t0:
                self._retire()
                self.written.fill(False)
                self.t0, self.nt = t0, nt

        def write_tile(self, row0, col0, daily_i16, normal, se, t0=0):
            nt, nr, nc = daily_i16.shape
            self._chunk(t0, nt)
            self.daily[:nt, row0 : row0 + nr, col0 : col0 + nc] = daily_i16
            self.written[row0 : row0 + nr, col0 : col0 + nc] = True
            if normal is not None:
                self.normal[:, row0 : row0 + nr, col0 : col0 + nc] = normal
                self.se[:, row0 : row0 + nr, col0 : col0 + nc] = se

        def read_tile_raw(self, row0, col0, nr, nc, t0=0, nt=None):
            nt = self.nt if nt is None else nt
            if t0 != self.t0:
                return np.full((nt, nr, nc), SENTINEL, np.int16)
            out = self.daily[:nt, row0 : row0 + nr, col0 : col0 + nc].copy()
            seen = self.written[row0 : row0 + nr, col0 : col0 + nc]
            if not seen.all():
                out[:, ~seen] = SENTINEL
            return out

        def read_monthly_back(self, row0, col0, nr, nc):
            sl = (slice(None), slice(row0, row0 + nr), slice(col0, col0 + nc))
            return self.normal[sl].copy(), self.se[sl].copy()

        def finalize(self, n_tiles, reconciled, process_index=0, process_count=1):
            self._retire()
            self.attrs.update(n_tiles=n_tiles, complete=True, reconciled=bool(reconciled),
                              process_index=process_index, process_count=process_count)

        def close(self):
            pass

    return ChunkMosaic
