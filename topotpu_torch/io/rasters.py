"""Covariate raster stacks (the port's own copy of the JAX package's
``io/rasters.py``): DEM, TDI, monthly LST and the land mask.

Parity target: the reference's GDAL raster inputs (SURVEY.md §2 L0 —
30-arcsec DEM, topographic dissection index, 12 monthly MODIS LST grids,
land mask). Stacks are stored as one HDF5 file with the grid spec in attrs,
and loaded as numpy arrays the tile engine slices per tile. ``h5py`` is
imported inside ``save`` and ``load`` only, so that importing the module
needs none.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import numpy as np

from topotpu_torch.core.grid import GridSpec


@dataclasses.dataclass
class RasterStack:
    grid: GridSpec
    elev: np.ndarray      # (R, C) f32, m
    tdi: np.ndarray       # (R, C) f32
    lst: np.ndarray       # (12, R, C) f32, C
    landmask: np.ndarray  # (R, C) bool

    def tile_view(self, row0: int, col0: int, nrows: int, ncols: int):
        sl = (slice(row0, row0 + nrows), slice(col0, col0 + ncols))
        return (
            self.elev[sl],
            self.tdi[sl],
            self.lst[(slice(None),) + sl],
            self.landmask[sl],
        )

    def save(self, path: str | pathlib.Path):
        import h5py

        path = pathlib.Path(path)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with h5py.File(tmp, "w") as f:
            for k in ("lon0", "lat0", "cellsize"):
                f.attrs[k] = getattr(self.grid, k)
            f.attrs["nrows"] = self.grid.nrows
            f.attrs["ncols"] = self.grid.ncols
            f.create_dataset("elev", data=self.elev.astype(np.float32),
                             compression="gzip", compression_opts=1)
            f.create_dataset("tdi", data=self.tdi.astype(np.float32),
                             compression="gzip", compression_opts=1)
            f.create_dataset("lst", data=self.lst.astype(np.float32),
                             compression="gzip", compression_opts=1)
            f.create_dataset("landmask", data=self.landmask)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "RasterStack":
        import h5py

        with h5py.File(path, "r") as f:
            grid = GridSpec(
                lon0=float(f.attrs["lon0"]),
                lat0=float(f.attrs["lat0"]),
                cellsize=float(f.attrs["cellsize"]),
                nrows=int(f.attrs["nrows"]),
                ncols=int(f.attrs["ncols"]),
            )
            return cls(
                grid=grid,
                elev=f["elev"][...],
                tdi=f["tdi"][...],
                lst=f["lst"][...],
                landmask=f["landmask"][...].astype(bool),
            )

    @classmethod
    def from_world(cls, world) -> "RasterStack":
        return cls(
            grid=world.grid,
            elev=world.elev.astype(np.float32),
            tdi=world.tdi.astype(np.float32),
            lst=world.lst.astype(np.float32),
            landmask=world.landmask,
        )
