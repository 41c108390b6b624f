"""SNHT changepoint detection and monthly means for the post-infill flags.

The port's own copy of the part of the JAX package's ``homog/pha.py`` that
``infill.post_infill.changepoint_flags`` needs: ``detect_breaks`` (batched
SNHT binary segmentation in C++, ``pha_core.cpp``) and ``monthly_means``
(numpy). The C++ core is built with ``g++`` at first use into
``topotpu_torch/homog/_build/`` (listed in ``.gitignore``) and called through
``ctypes``; a failed build raises. The pairwise network logic of the
homogenization stage is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
import tempfile

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_SO = _DIR / "_build" / "libpha.so"
_SRC = _DIR / "pha_core.cpp"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build ``pha_core.cpp`` unless its library is newer, and load it."""
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _SO.parent.mkdir(exist_ok=True)
        # built under a temporary name and renamed into place, so processes
        # building at once never load a half-written file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_SO.parent)
        os.close(fd)
        cmd = ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed for {_SRC.name} (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(str(_SO))
    lib.pha_detect_breaks.restype = ctypes.c_int
    lib.pha_detect_breaks.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def detect_breaks(series: np.ndarray, minseg: int = 24, max_breaks: int = 5):
    """(N, T) difference series -> (breaks (N, max_breaks) int32 [-1 pad],
    stats (N, max_breaks) f64). C++ batched SNHT binary segmentation."""
    series = np.ascontiguousarray(series, np.float32)
    N, T = series.shape
    breaks = np.empty((N, max_breaks), np.int32)
    stats = np.empty((N, max_breaks), np.float64)
    _lib().pha_detect_breaks(
        series.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), N, T,
        minseg, max_breaks,
        breaks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return breaks, stats


def monthly_means(daily: np.ndarray, year: np.ndarray, month: np.ndarray,
                  min_days: int = 20):
    """(S, T) daily + calendar -> (S, M) monthly means (NaN if sparse) and
    the (M,) month start keys."""
    keys = year * 12 + (month - 1)
    uniq = np.unique(keys)
    S = daily.shape[0]
    out = np.full((S, len(uniq)), np.nan, np.float32)
    for i, k in enumerate(uniq):
        sel = keys == k
        block = daily[:, sel]
        n = np.isfinite(block).sum(axis=1)
        s = np.nansum(np.where(np.isfinite(block), block, 0.0), axis=1)
        out[:, i] = np.where(n >= min_days, s / np.maximum(n, 1), np.nan)
    return out, uniq
