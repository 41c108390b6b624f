"""Station observation databases on HDF5 (the port's own copy of the JAX
package's ``io/stndb.py``: the same groups, dataset names, attributes and
dtypes, so a database written by either package opens in the other).

Parity target: ``twx/db/station_data.py`` (SURVEY.md §2.3) —
``StationDataDb`` (all-obs database: stations x days obs matrices for
tmin/tmax plus QA-flag variables and station attributes) and
``StationSerialDataDb`` (the serially-complete, infilled database carrying
monthly normals and fitted variogram parameters as station attributes).

The artifact chain these files form IS the pipeline's checkpoint/resume
story (SURVEY.md §5): raw obs DB -> QA'd -> homogenized -> serial/infilled
-> param-annotated; every stage reads one file and atomically writes the
next.

Stored as plain HDF5 (h5py); string attrs as fixed-width bytes. Layout:
  /stn/{stn_id,name,state,lon,lat,elev,tdi,lst,bad,...}   (S,) or (S, 12)
  /obs/{tmin,tmax}              (S, T) float32, NaN = missing
  /obs/qflag_{tmin,tmax}        (S, T) uint8 QA flag codes
  /time                         (T,) days since 1948-01-01

``h5py`` is imported where a file is opened, so importing the module needs
none.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from topotpu_torch.core import constants as C

_EPOCH = np.datetime64("1948-01-01", "D")


class StationDB:
    """Read/write station database. Open modes: 'r', 'w' (new), 'a'."""

    def __init__(self, path: str | pathlib.Path, mode: str = "r"):
        import h5py

        self.path = pathlib.Path(path)
        self._f = h5py.File(self.path, mode)

    # ---------- construction ----------
    @classmethod
    def create(
        cls,
        path: str | pathlib.Path,
        stn_attrs: dict[str, np.ndarray],
        dates: np.ndarray,
    ) -> "StationDB":
        db = cls(path, "w")
        f = db._f
        g = f.create_group("stn")
        n = None
        for k, v in stn_attrs.items():
            v = np.asarray(v)
            if v.dtype.kind in ("U", "O"):
                v = v.astype("S32")
            g.create_dataset(k, data=v)
            n = len(v) if n is None else n
        f.create_dataset("time", data=(dates - _EPOCH).astype(np.int32))
        f.create_group("obs")
        return db

    # ---------- station attributes ----------
    def stn(self, name: str) -> np.ndarray:
        v = self._f["stn"][name][...]
        if v.dtype.kind == "S":
            return v.astype(str)
        return v

    def set_stn(self, name: str, value: np.ndarray):
        value = np.asarray(value)
        if value.dtype.kind in ("U", "O"):
            value = value.astype("S32")
        g = self._f["stn"]
        if name in g:
            del g[name]
        g.create_dataset(name, data=value)

    @property
    def n_stations(self) -> int:
        return self._f["stn"][C.LON].shape[0]

    @property
    def dates(self) -> np.ndarray:
        return _EPOCH + self._f["time"][...].astype("timedelta64[D]")

    # ---------- observations ----------
    def set_obs(self, var: str, data: np.ndarray):
        g = self._f["obs"]
        if var in g:
            del g[var]
        g.create_dataset(
            var, data=data.astype(np.float32),
            chunks=(1, data.shape[1]), compression="gzip", compression_opts=1,
        )

    def obs(self, var: str, idx=None) -> np.ndarray:
        d = self._f["obs"][var]
        return d[...] if idx is None else d[idx]

    def set_qflags(self, var: str, flags: np.ndarray):
        self.set_obs_raw(f"qflag_{var}", flags.astype(np.uint8))

    def qflags(self, var: str) -> np.ndarray:
        return self._f["obs"][f"qflag_{var}"][...]

    def set_obs_raw(self, name: str, data: np.ndarray):
        g = self._f["obs"]
        if name in g:
            del g[name]
        g.create_dataset(name, data=data, chunks=(1, data.shape[1]),
                         compression="gzip", compression_opts=1)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_serial_db(
    path: str | pathlib.Path,
    src: StationDB,
    var: str,
    filled: np.ndarray,
    norms: np.ndarray,
    bad: np.ndarray,
    vario: np.ndarray | None = None,
) -> None:
    """Write the serially-complete DB for one variable (atomic).

    Mirrors StationSerialDataDb's role: complete obs + NORM_* + BAD (+ fitted
    variogram params once the param build has run)."""
    path = pathlib.Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    attrs = {k: src.stn(k) for k in src._f["stn"].keys()}
    attrs[C.BAD] = bad.astype(np.uint8)
    attrs[C.NORM] = norms.astype(np.float32)
    if vario is not None:
        attrs[C.VARIO_NUG] = vario[..., 0].astype(np.float32)
        attrs[C.VARIO_PSILL] = vario[..., 1].astype(np.float32)
        attrs[C.VARIO_RNG] = vario[..., 2].astype(np.float32)
    with StationDB.create(tmp, attrs, src.dates) as db:
        db.set_obs(var, filled)
    os.replace(tmp, path)
