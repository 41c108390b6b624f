"""Guard: the port stands alone. Importing every module of ``topotpu_torch``
and ``chip_smoke`` loads neither JAX nor anything of the JAX package
(``topotpu``), nor h5py or triton (the machine with the GPU has no JAX and no
h5py), and builds or launches nothing; and no source file of the port
imports ``topotpu``. And the port is complete at the level of names: every
public top-level name of every module of the JAX package has its
counterpart, apart from a commented list of what exists for the TPU only."""

import pathlib
import re
import subprocess
import sys

import pytest

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
               "interp.f64check", "utils.profiling", "cli", "cli.main", "cli.steps",
               "dist.mesh", "interp.normals"):
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
# the CLI: its stages and the multi-process host side, h5py only once a file opens
from topotpu_torch.cli.main import main
from topotpu_torch.cli.steps import step_interp, stage_resume_status
from topotpu_torch.dist.multihost import init_multihost, merge_manifests, partition_tiles
# the rest of the JAX package's dist layer: the mesh, the sharded steps, the
# process group's helpers and the virtual master over the mosaic shards
from topotpu_torch.dist.mesh import CELL_AXIS, make_mesh, shard_pair_inputs, shard_tile_inputs
from topotpu_torch.dist.mesh import sharded_interp_tile, sharded_interp_tile_flat
from topotpu_torch.dist.mesh import sharded_interp_tile_pair_flat, tile_input_specs
from topotpu_torch.dist.multihost import barrier, global_mesh, initialize, is_coordinator
from topotpu_torch.dist.multihost import local_mesh
from topotpu_torch.io.ncdf import build_virtual_mosaic
# regression-kriged normals on gathered neighbourhoods, and the packages' exports
import topotpu_torch.interp as i
i.krig_normals; i.krig_normals_and_gains; i.NormalsResult; i.anomaly_gain_rows; i.scatter_gains
import topotpu_torch.interp.normals
from topotpu_torch.kernels.krig_normals import krig_normals_gathered
assert krig_normals_gathered.launches == 0
from topotpu_torch.kernels.variogram_fit import variogram_fit
assert variogram_fit.launches == 0
from topotpu_torch.core import DaysMetadata, GridSpec, TileSpec, TopoConfig, config, constants
from topotpu_torch.core import dates, get_days_metadata, grid
import torch.distributed as dist
assert not dist.is_initialized()  # importing joins no process group
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


def test_cli_imports_h5py_only_where_files_open():
    """The CLI's modules import no JAX, no ``topotpu``, no triton anywhere,
    and h5py only inside the functions that open files, never at module
    level."""
    import ast

    for name in ("main.py", "steps.py", "__main__.py", "__init__.py"):
        tree = ast.parse((REPO / "topotpu_torch" / "cli" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "jaxlib", "topotpu", "triton"} & set(roots), (name, roots)
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert all("h5py" not in ast.unparse(n) for n in top), name


# Name-level completeness: every public top-level name of each module of the
# JAX package exists at the port's counterpart path (the same path under
# topotpu_torch/ unless COUNTERPART says otherwise), or is listed below.
JAX_MODULES = sorted(p.relative_to(REPO / "topotpu").as_posix()
                     for p in (REPO / "topotpu").rglob("*.py"))
COUNTERPART = {  # the Pallas kernels' modules: each kernel's wrapper is a module of its own
    "kernels/pallas_krig.py": ("kernels/krig_normals.py", "kernels/ok_solve_fused.py",
                               "geo/distance.py"),  # (EARTH_RADIUS_KM lives in geo)
    "kernels/pallas_scatter.py": ("kernels/scatter_daily.py",),
}
RENAMED = {  # the port's name of a TPU kernel's entry
    ("kernels/pallas_krig.py", "krig_normals_fused"): "krig_normals_gathered",
    ("kernels/pallas_scatter.py", "scatter_daily_matmul"): "scatter_daily",
}
NOT_PORTED = {  # ROADMAP.md's "Do not port": they exist for the TPU, Mosaic or XLA only;
    # and what the port replaced by its own
    ("utils/profiling.py", "Timer"):
        "wall-time scopes that no stage opened; the port's stages open utils.profiling.span, "
        "read through recording() and device_trace",
    ("kernels/pallas_krig.py", "padded_kernel_k"):
        "Mosaic compiles k in (33, 55) slowly; the CUDA kernel takes any 1 <= k <= 64",
    ("kernels/pallas_krig.py", "LANES"): "the TPU's 128-lane cell blocks; the kernels take any C",
    ("kernels/pallas_krig.py", "ASIN_VALID_KM"): "the Taylor asin's range; the kernels use asinf",
    ("kernels/pallas_krig.py", "LOOPED_K_THRESHOLD"):
        "where Mosaic's factorisation loops; the CUDA kernel unrolls K = 32 and 64",
    ("kernels/pallas_scatter.py", "CELLS_BLOCK"): "the TPU's cell blocks; any C is taken",
    ("kernels/pallas_scatter.py", "MAX_Y_COLS"): "the TPU's column chunks; any D is taken",
    **{(m, "HI"): "XLA's matmul precision; float32 is full by default in torch, and "
                  "core/device.py keeps TF32 off"
       for m in ("interp/anoms.py", "interp/normals.py", "interp/params.py", "kernels/wls.py",
                 "stats/ppca.py", "stats/variogram.py")},
}


def _top_level(path, imported):
    """The names a module binds at its top level: definitions, assignments
    and, with ``imported``, the names its imports bind."""
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif imported and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_has_every_public_name_of_the_jax_module(module):
    """A package's ``__init__`` exports what it imports; any other module's
    public names are what it defines."""
    jax_names = {n for n in _top_level(REPO / "topotpu" / module, module.endswith("__init__.py"))
                 if not n.startswith("_")}
    ports = [REPO / "topotpu_torch" / p for p in COUNTERPART.get(module, (module,))]
    assert all(p.is_file() for p in ports), ports
    port_names = set().union(*(_top_level(p, True) for p in ports))
    missing = sorted(n for n in jax_names
                     if RENAMED.get((module, n), n) not in port_names
                     and (module, n) not in NOT_PORTED)
    assert not missing, f"topotpu/{module}: {missing} not in {[str(p) for p in ports]}"


def test_completeness_lists_name_real_jax_names():
    """Every entry of the lists above names a public name the JAX module
    still has, so a name that goes away leaves no stale exception."""
    for module, name in [*RENAMED, *NOT_PORTED]:
        assert name in _top_level(REPO / "topotpu" / module, False), (module, name)
