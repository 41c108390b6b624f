"""The four-rank grid cell's mosaic shard: the direct-mode writer's
interface on numpy arrays in host memory, holding one chunk of days of the
tiles that its rank owns (``tile_id % count == rank``) and nothing else.

A rank of a job over several processes writes its own full-grid shard
(``mosaic_<var>_pNNN``), but only its own tiles ever reach it. Here those
tiles are kept tile by tile, as a tile-chunked file lays them out: a daily
buffer of (owned tiles, 366 days, tile cells) int16 a variable, made once in
set-up (``prepare``), 2.35 GB a variable for 196 tiles of 128 x 128. A tile
not written in the current chunk reads back as the sentinel, as a file's
fill value would. A tile written that the rank does not own is kept out of
the buffer and recorded as a claim: the check counts it.

When a chunk is retired (the next one begins, or the shard is finalised)
the values of the sampled cells that lie in the rank's tiles are copied out,
with which of them were written and which tiles the chunk wrote; that is
all of the chunk that outlives it. Monthly normals and se, which the engine
writes from each pass's first chunk, are kept whole for the rank's tiles.
"""

from __future__ import annotations

import pathlib

import numpy as np

SENTINEL = -32768


def make_sink(rows, cols, tile_rows: int, tile_cols: int, nrows: int, ncols: int,
              rank: int, count: int, max_days: int = 366):
    """A writer class for one rank of one run over a region of ``nrows`` x
    ``ncols`` cells. ``rows``, ``cols``: the sampled cells. Its instances
    register under their variable in ``cls.OPEN``; ``cls.SNAPSHOTS[var]``
    collects a dict a retired chunk: ``pass`` (``cls.PASS`` when the chunk
    began), ``t0``, ``daily`` int16 (nt, n_samples) with the sentinel where
    this rank wrote nothing, ``wrote`` (n_samples,) and ``tiles`` (the tile
    ids written, its own or not); ``cls.ATTRS[var]`` the attributes each
    finalised shard was stamped with."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    per_row = -(-ncols // tile_cols)
    n_tiles = -(-nrows // tile_rows) * per_row
    owned = np.arange(rank, n_tiles, count)
    slot_of = {int(t): i for i, t in enumerate(owned)}
    tid = (rows // tile_rows) * per_row + cols // tile_cols
    mine = tid % count == rank
    s_slot = np.array([slot_of.get(int(t), 0) for t in tid], np.int64)
    s_off = (rows % tile_rows) * tile_cols + cols % tile_cols
    cells = tile_rows * tile_cols

    class ShardMosaic:
        OPEN: dict = {}
        SNAPSHOTS: dict = {}
        ATTRS: dict = {}
        BUFFERS: dict = {}
        FIRST: dict = {}  # var -> the first shard that received normals
        PASS = 0
        OWNED = owned
        MINE = mine

        @classmethod
        def prepare(cls, variables=("tmin", "tmax")) -> None:
            for v in variables:
                cls.BUFFERS[v] = np.full((len(owned), max_days, cells), SENTINEL, np.int16)

        def __init__(self, path, var, grid, dates, daily_scale, daily_offset, tile_rows_,
                     tile_cols_, compress=0):
            if (grid.nrows, grid.ncols, tile_rows_, tile_cols_) != (nrows, ncols, tile_rows,
                                                                   tile_cols):
                raise ValueError("the shard was made for another grid or tiling")
            self.path = pathlib.Path(path)
            self.var = var
            self.fresh = True
            if var not in self.BUFFERS:
                self.BUFFERS[var] = np.full((len(owned), max_days, cells), SENTINEL, np.int16)
            self.daily = self.BUFFERS[var]
            self.written = np.zeros(len(owned), bool)  # tiles written in the current chunk
            self.normal = np.full((len(owned), 12, cells), np.nan, np.float32)
            self.se = np.full((len(owned), 12, cells), np.nan, np.float32)
            self.monthly = np.zeros(len(owned), bool)
            self.attrs = {"scale_factor": float(np.float32(daily_scale)),
                          "add_offset": float(np.float32(daily_offset)), "layout": "direct"}
            self.t0 = None
            self.nt = 0
            self.pass_ = self.PASS
            self.tiles: set = set()
            self.OPEN[var] = self
            self.SNAPSHOTS.setdefault(var, [])
            self.ATTRS.setdefault(var, [])

        def _slot(self, row0: int, col0: int):
            t = (row0 // tile_rows) * per_row + col0 // tile_cols
            return t, slot_of.get(t)

        def _retire(self) -> None:
            if self.t0 is None:
                return
            ok = mine & self.written[s_slot]
            snap = np.full((self.nt, len(rows)), SENTINEL, np.int16)
            snap[:, ok] = self.daily[s_slot[ok], : self.nt, s_off[ok]].T
            self.SNAPSHOTS[self.var].append(dict(pass_=self.pass_, t0=self.t0, daily=snap,
                                                 wrote=ok, tiles=sorted(self.tiles)))
            self.t0 = None

        def _chunk(self, t0: int, nt: int) -> None:
            if t0 != self.t0:
                self._retire()
                self.written.fill(False)
                self.tiles = set()
                self.t0, self.nt, self.pass_ = t0, nt, self.PASS

        def _tile(self, a, k, n_lead):
            """The (lead, nr, nc) view of slot ``k`` of ``a`` (lead planes)."""
            return a[k, :n_lead].reshape(n_lead, tile_rows, tile_cols)

        def write_tile(self, row0, col0, daily_i16, normal, se, t0=0):
            nt, nr, nc = daily_i16.shape
            self._chunk(t0, nt)
            t, k = self._slot(row0, col0)
            self.tiles.add(t)
            if k is None:
                return  # not this rank's: recorded in ``tiles``, kept out of the shard
            self._tile(self.daily, k, nt)[:, :nr, :nc] = daily_i16
            self.written[k] = True
            if normal is not None:
                self._tile(self.normal, k, 12)[:, :nr, :nc] = normal
                self._tile(self.se, k, 12)[:, :nr, :nc] = se
                self.monthly[k] = True
                self.FIRST.setdefault(self.var, self)

        def read_tile_raw(self, row0, col0, nr, nc, t0=0, nt=None):
            nt = self.nt if nt is None else nt
            _, k = self._slot(row0, col0)
            if t0 != self.t0 or k is None or not self.written[k]:
                return np.full((nt, nr, nc), SENTINEL, np.int16)
            return self._tile(self.daily, k, nt)[:, :nr, :nc].copy()

        def read_monthly_back(self, row0, col0, nr, nc):
            _, k = self._slot(row0, col0)
            if k is None:
                nan = np.full((12, nr, nc), np.nan, np.float32)
                return nan, nan.copy()
            return (self._tile(self.normal, k, 12)[:, :nr, :nc].copy(),
                    self._tile(self.se, k, 12)[:, :nr, :nc].copy())

        def finalize(self, n_tiles, reconciled, process_index=0, process_count=1):
            self._retire()
            self.attrs.update(n_tiles=n_tiles, complete=True, reconciled=bool(reconciled),
                              process_index=process_index, process_count=process_count,
                              file=self.path.name)
            self.ATTRS[self.var].append(dict(self.attrs))

        def close(self):
            pass

        @classmethod
        def monthly_at_samples(cls, var):
            """(normal, se) (12, n_samples) float32 at the sampled cells of
            the rank's tiles from the first shard that received them, NaN
            elsewhere, and which samples they cover."""
            first = cls.FIRST.get(var)
            n = len(rows)
            normal = np.full((12, n), np.nan, np.float32)
            se = normal.copy()
            if first is None:
                return normal, se, np.zeros(n, bool)
            ok = mine & first.monthly[s_slot]
            normal[:, ok] = first.normal[s_slot[ok], :, s_off[ok]].T
            se[:, ok] = first.se[s_slot[ok], :, s_off[ok]].T
            return normal, se, ok

    return ShardMosaic
