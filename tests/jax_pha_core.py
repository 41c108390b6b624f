"""Load the JAX package's C++ SNHT core (``topotpu/homog/pha_core.cpp``) for
the port's tests, safely under several pytest-xdist workers.

``topotpu/homog/pha.py`` builds its library with ``g++ -o`` straight into
place, so one worker can load the file while another is still writing it
(``OSError: ... libpha.so: file too short`` from ``ctypes``). The port's tests
call the JAX package for comparison, so they would both start such builds and
load their half-written output. ``load_jax_pha`` builds the library under a
file lock to a temporary name and renames it into place, loads it, retrying
while an in-place build of a JAX test is still writing it, and hands the handle
to the module, which then never builds. Call it before the first call into the
JAX package that reaches the core (a module-scoped autouse fixture does).
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile
import time

import topotpu.homog.pha as jpha

LOAD_WAIT_S = 120.0


def _build_in_place_atomically() -> None:
    so, src = jpha._SO, jpha._SRC
    so.parent.mkdir(exist_ok=True)
    with open(so.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(src), "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _load() -> ctypes.CDLL:
    """``ctypes.CDLL`` of the library, waiting out a build still writing it."""
    deadline = time.monotonic() + LOAD_WAIT_S
    while True:
        try:
            return ctypes.CDLL(str(jpha._SO))
        except OSError:  # missing or half-written: a JAX test's build is in flight
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def load_jax_pha():
    """The JAX package's ``pha`` module with its C++ core loaded."""
    if jpha._lib is None:
        _build_in_place_atomically()
        lib = _load()
        # the signatures topotpu/homog/pha.py::_load_lib declares
        lib.pha_detect_breaks.restype = ctypes.c_int
        lib.pha_detect_breaks.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ]
        lib.pha_break_model.restype = ctypes.c_int
        lib.pha_break_model.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        jpha._lib = lib
    return jpha
