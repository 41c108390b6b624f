"""Plain assembly of a grid product written in shards by a job over several
processes.

Each process owns the tiles with ``tile_id % count == its index``, the tile
id counted row by row (tile row x tiles a row + tile column), and writes
those tiles, and only those, into a shard of its own. The product at a cell
is therefore its owner's shard at that cell. numpy only: this reads the
shards' arrays as it is given them and shares nothing with the program,
which publishes the same mapping as a virtual file
(``io.ncdf.build_virtual_mosaic``).
"""

from __future__ import annotations

import collections

import numpy as np


def tile_ids(rows, cols, tile_rows: int, tile_cols: int, ncols: int) -> np.ndarray:
    """The tile of each cell (``rows``, ``cols``) of a grid ``ncols`` wide."""
    per_row = -(-ncols // tile_cols)
    return (np.asarray(rows) // tile_rows) * per_row + np.asarray(cols) // tile_cols


def owners(tile_id, count: int) -> np.ndarray:
    """The process that owns each tile."""
    return np.asarray(tile_id) % count


def assemble(values, wrote, owner, fill):
    """The product from the shards: ``values`` (P, ..., n), a shard's values
    at n cells, ``wrote`` (P, n) where each shard wrote them, ``owner`` (n,)
    each cell's process. Returns the product (..., n), each cell from its
    owner's shard where the owner wrote it and ``fill`` elsewhere, and (n,)
    the number of shards that wrote each cell without owning it."""
    values = np.asarray(values)
    wrote = np.asarray(wrote, bool)
    owner = np.asarray(owner)
    out = np.full(values.shape[1:], fill, values.dtype)
    for p in range(wrote.shape[0]):
        take = (owner == p) & wrote[p]
        out[..., take] = values[p][..., take]
    foreign = (wrote & (owner[None, :] != np.arange(wrote.shape[0])[:, None])).sum(0)
    return out, foreign


def claim_faults(tiles_of_shard, count: int) -> int:
    """Tiles of one chunk that a shard wrote without owning them, plus every
    claim of a tile beyond its first: ``tiles_of_shard[p]`` lists the tiles
    shard p wrote (each shard its index in the job)."""
    claims = collections.Counter(t for tiles in tiles_of_shard for t in set(tiles))
    twice = sum(n - 1 for n in claims.values())
    foreign = sum(int(t) % count != p for p, tiles in enumerate(tiles_of_shard)
                  for t in set(tiles))
    return twice + foreign


def attr_faults(attrs, index: int, count: int, n_tiles: int) -> int:
    """1 unless a shard's attributes say it is finished, that it is shard
    ``index`` of ``count`` and that it holds ``n_tiles`` tiles."""
    ok = (bool(attrs.get("complete")) and attrs.get("process_index") == index
          and attrs.get("process_count") == count and attrs.get("n_tiles") == n_tiles)
    return 0 if ok else 1
