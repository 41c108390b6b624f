"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

A source named in ``PARTS`` is compiled in that many parts at once, one
``nvcc -c -DTOPOTPU_PART=<i>`` process a part (the source compiles only
part i's kernels under that macro), and the objects are linked into the one
library: its kernels' compile times overlap instead of adding up.

The library lands in ``topotpu_torch/kernels/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the source, every shared
header ``csrc/*.cuh`` and the flags, so an edited source or header rebuilds
and an unchanged one is reused. The build runs at
the first launch, never at import; the compiler's report (registers, shared
memory, spills from ``-Xptxas -v``) is kept beside the library as
``<lib>.log``. No fast-math flag: the kernels hold exact fp32 division,
square root, ``expf`` and ``asinf``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
PARTS = {"krig_normals": 3}  # sources compiled in parts (see the module docstring)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises when none exists."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` is built, keyed by its content,
    the content of every header in ``csrc`` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode() + str(PARTS.get(name, 1)).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its keyed library already exists.

    The library is written under a temporary name and renamed into place, so
    processes building at once never load a half-written file."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    nvcc, src = find_nvcc(), str(CSRC / f"{name}.cu")
    objs = [f"{tmp}.{i}.o" for i in range(PARTS.get(name, 0))]
    if not objs:
        steps = [[[nvcc, *NVCC_FLAGS, "-o", tmp, src]]]
    else:
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        steps = [[[nvcc, *flags, "-c", f"-DTOPOTPU_PART={i}", "-o", obj, src]
                  for i, obj in enumerate(objs)],
                 [[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]]]
    log = []
    try:
        for step in steps:  # the commands of a step run at once
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for cmd in step]
            texts = [proc.communicate()[0] for proc in procs]
            log += texts
            for cmd, proc, text in zip(step, procs, texts):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{text}")
    except BaseException:
        os.unlink(tmp)
        raise
    finally:
        for obj in objs:
            pathlib.Path(obj).unlink(missing_ok=True)
    pathlib.Path(str(out) + ".log").write_text("".join(log))
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str, entry: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """Build (if needed) and load ``csrc/<name>.cu``; return its C function
    ``entry`` with ``argtypes`` declared and an ``int`` (cudaError_t) result."""
    lib = ctypes.CDLL(str(build(name)))
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def common_device(what: str, *tensors) -> torch.device:
    """The one device all ``tensors`` lie on; raises on a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs on several devices {sorted(map(str, devices))}")
    return devices.pop()


def require(what: str, name: str, t: torch.Tensor, dtype: torch.dtype,
            shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: {name} is on {t.device}, not CUDA")
    if t.dtype != dtype:
        raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} is not contiguous")
