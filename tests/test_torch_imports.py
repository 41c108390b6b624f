"""Guard: the port imports neither JAX nor h5py, and importing it builds or
launches nothing (the machine with the GPU has neither package)."""

import subprocess
import sys
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]

MODULES = [
    "topotpu_torch",
    "topotpu_torch.core",
    "topotpu_torch.core.device",
    "topotpu_torch.geo",
    "topotpu_torch.geo.distance",
    "topotpu_torch.geo.neighbors",
    "topotpu_torch.kernels",
    "topotpu_torch.kernels._build",
    "topotpu_torch.kernels.wls",
    "topotpu_torch.kernels.cholesky",
    "topotpu_torch.kernels.krig_normals",
    "topotpu_torch.kernels.scatter_daily",
    "topotpu_torch.kernels.ok_solve_fused",
    "topotpu_torch.stats",
    "topotpu_torch.stats.variogram",
    "topotpu_torch.stats.ppca",
    "topotpu_torch.infill",
    "topotpu_torch.infill.pipeline",
    "topotpu_torch.infill.post_infill",
    "topotpu_torch.interp",
    "topotpu_torch.interp.anoms",
    "topotpu_torch.interp.normals",
    "topotpu_torch.interp.point",
    "topotpu_torch.interp.convert",
    "topotpu_torch.interp.params",
    "topotpu_torch.interp.xval",
    "topotpu_torch.io",
    "topotpu_torch.io.synthetic",
]

PROBE = f"""
import importlib, sys
for name in {MODULES!r}:
    importlib.import_module(name)
from topotpu_torch.kernels.krig_normals import krig_normals_fused
from topotpu_torch.kernels.scatter_daily import scatter_daily
from topotpu_torch.kernels.ok_solve_fused import ok_solve_fused, ok_solve_fused_xyz
assert krig_normals_fused.launches == 0 and scatter_daily.launches == 0
assert ok_solve_fused.launches == 0 and ok_solve_fused_xyz.launches == 0
# no submodule shadows the package's re-export of the plain OK solve
import topotpu_torch.kernels as kernels
assert kernels.ok_solve is kernels.cholesky.ok_solve
# the post-infill flags build and call the C++ SNHT core of topotpu.homog
import numpy as np
from topotpu.core.dates import get_days_metadata
from topotpu_torch.infill.post_infill import changepoint_flags
days = get_days_metadata("2013-01-01", "2015-12-31")
filled = np.random.default_rng(0).normal(size=(2, days.ndays)).astype(np.float32)
flags = changepoint_flags(filled, np.ones_like(filled, bool), days.year, days.month)
assert flags.shape == (2,) and not flags.any()
bad = sorted(m for m in ("jax", "jaxlib", "h5py", "triton") if m in sys.modules)
print("LOADED", bad)
"""


def test_port_imports_no_jax_or_h5py():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_tf32_is_off_after_import():
    import torch

    import topotpu_torch.core  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
