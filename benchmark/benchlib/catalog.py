"""Finding the benchmark's pieces by name.

A cell (``cells/<cell>.json``) names its configuration (``configs/<config>.json``)
and its traffic mix (``traffic/<traffic>.json``), whose ``driver`` is
``drivers/<driver>.py``. A metric is ``metrics/<metric>.py`` and a kernel's
operation and byte counts ``counts/<kernel>.py``. Adding any of them is adding
a file: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re

BENCH_DIR = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a name of the benchmark")
    return name


def load_json(kind: str, name: str, dirs=None) -> dict:
    """``<kind>/<name>.json`` from the first of ``dirs`` (default: the
    benchmark's own folder) that has it."""
    for d in list(dirs or []) + [BENCH_DIR / kind]:
        path = pathlib.Path(d) / f"{_checked(name)}.json"
        if path.is_file():
            return json.loads(path.read_text())
    raise FileNotFoundError(f"no {kind} named {name!r}")


def load_module(kind: str, name: str, dirs=None):
    """The module ``<kind>/<name>.py`` (names may hold dots, so it is loaded
    from its file, not imported by name)."""
    for d in list(dirs or []) + [BENCH_DIR / kind]:
        path = pathlib.Path(d) / f"{_checked(name)}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no {kind} named {name!r}")


def benchmark_json() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """The end-to-end and the per-layer metrics that ``bench`` gives ``cell``:
    those that list it under ``workloads``, or list no cells; a per-layer
    metric without ``workloads`` goes with every cell of the metric it moves."""
    def mine(m):
        return cell in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if mine(m) is not False]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (mine(m) if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def resolve(cell_name: str, cell_dirs=None) -> dict:
    """The cell with its configuration, traffic mix and driver name."""
    cell = load_json("cells", cell_name, cell_dirs)
    config = load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    return dict(name=cell_name, cell=cell, config=config, traffic=traffic,
                driver=traffic["driver"])
