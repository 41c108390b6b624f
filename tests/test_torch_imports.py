"""Guard: the port stands alone. Importing every module of ``topotpu_torch``
and ``chip_smoke`` loads neither JAX nor anything of the JAX package
(``topotpu``), nor h5py or triton (the machine with the GPU has no JAX and no
h5py), and builds or launches nothing; and no source file of the port
imports ``topotpu``."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import topotpu_torch
names = ["topotpu_torch"] + [
    m.name for m in pkgutil.walk_packages(topotpu_torch.__path__, "topotpu_torch.")
]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
print("MODULES", len(names))
for needed in ("core.config", "core.dates", "core.grid", "core.constants", "io.synthetic",
               "oracle.numpy_ref", "oracle.pipeline", "homog.pha", "kernels.krig_normals",
               "infill.post_infill", "interp.point", "dist.engine", "dist.multihost",
               "io.ncdf", "io.rasters", "utils.status", "qa", "qa.qa_temp", "qa.qa_location",
               "homog", "geo.regions", "io.stndb", "io.build_db", "io.ushcn", "io.download",
               "interp.f64check", "utils.profiling"):
    assert "topotpu_torch." + needed in names, needed
from topotpu_torch.kernels.krig_normals import krig_normals_indexed
from topotpu_torch.kernels.scatter_daily import scatter_daily
from topotpu_torch.kernels.ok_solve_fused import ok_solve_fused, ok_solve_fused_xyz
from topotpu_torch.dist.engine import TileEngine
assert TileEngine.MOSAIC_WRITER is None  # io.ncdf.MosaicWriter, resolved when a mosaic opens
assert krig_normals_indexed.launches == 0 and scatter_daily.launches == 0
assert ok_solve_fused.launches == 0 and ok_solve_fused_xyz.launches == 0
# no submodule shadows the package's re-export of the plain OK solve
import topotpu_torch.kernels as kernels
assert kernels.ok_solve is kernels.cholesky.ok_solve
# the post-infill flags build and call the port's own C++ SNHT core
import numpy as np
from topotpu_torch.core.dates import get_days_metadata
from topotpu_torch.infill.post_infill import changepoint_flags
days = get_days_metadata("2013-01-01", "2015-12-31")
filled = np.random.default_rng(0).normal(size=(2, days.ndays)).astype(np.float32)
flags = changepoint_flags(filled, np.ones_like(filled, bool), days.year, days.month)
assert flags.shape == (2,) and not flags.any()
# the packages' exports, as the JAX package's __init__ files name them
from topotpu_torch.geo import make_climate_regions
from topotpu_torch.homog import HomogResult, homogenize_elements, homogenize_network
from topotpu_torch.homog import parse_station_history
from topotpu_torch.qa import check_coordinates, check_elevation, run_qa_non_spatial
from topotpu_torch.qa import run_qa_spatial
from topotpu_torch.io.stndb import StationDB  # h5py only once a file opens
roots = ("jax", "jaxlib", "topotpu", "h5py", "triton")
bad = sorted(m for m in sys.modules
             if m in roots or m.startswith(tuple(r + "." for r in roots)))
print("LOADED", bad)
"""


def test_port_imports_no_jax_or_h5py():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_port_sources_do_not_import_the_jax_package():
    pattern = re.compile(r"(import|from)\s+(topotpu|jax|jaxlib)[.\s]")
    files = sorted((REPO / "topotpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    hits = [
        f"{f.relative_to(REPO)}:{i}: {line.strip()}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if pattern.search(line)
    ]
    assert not hits, "\n".join(hits)


def test_tf32_is_off_after_import():
    import torch

    import topotpu_torch.core  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
