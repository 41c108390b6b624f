"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, the metrics, and the result line.

``main`` is the command line (it needs CUDA); ``run_cell`` is the rest of a
run on any device, which the CPU tests call with small sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

from benchlib import catalog
from benchlib.record import Record
from benchlib.trace import Tracer

BANNED = ("jax", "jaxlib", "flax", "topotpu")  # top-level module names, compared whole


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct where ``value <= limit`` for every check."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell, its configuration and traffic mix
    (with a test's overrides applied), the seed and the window's length,
    the device, the record, the tracer and a scratch directory."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: object
    rec: Record
    tracer: Tracer
    tmpdir: str
    options: dict  # test-only: "control" (the reference in the program's place), "fault"


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    out.update(over or {})
    return out


def process_start(fallback: float) -> float:
    """The process's start on the ``perf_counter`` clock (from
    ``/proc/self/stat``), or ``fallback`` where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return fallback


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start=None,
             bench: dict | None = None, cell_dirs=None, overrides: dict | None = None) -> dict:
    """Everything of a run after the look for a chip. Returns the result
    (its keys in the order of the result line)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    found = catalog.resolve(name, cell_dirs)
    bench = catalog.benchmark_json() if bench is None else bench
    e2e, per_layer = catalog.cell_metrics(bench, name)
    driver = catalog.load_module("drivers", found["driver"])
    cell = _merged(found["cell"], overrides.get("cell"))
    rec = Record()
    tracer = Tracer(bool(trace), cell.get("trace_seconds"))
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        ctx = Ctx(name=name, cell=cell, config=_merged(found["config"], overrides.get("config")),
                  traffic=_merged(found["traffic"].get("params", {}), overrides.get("traffic")),
                  seed=int(seed), seconds=float(seconds), device=device, rec=rec,
                  tracer=tracer, tmpdir=tmp, options=dict(overrides.get("options", {})))
        state = driver.setup(ctx)
        if cuda:
            tracer.start()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)  # the window's peak, not the world's
        t0 = time.perf_counter()
        rec.setup_s = t0 - t_start
        tracer.window_started(t0)
        driver.window(ctx, state)
        if cuda:
            torch.cuda.synchronize()
        rec.window = (t0, time.perf_counter())
        tracer.stop()
        banned = banned_modules()
        if banned:
            raise SystemExit(f"the run loaded {', '.join(banned)}: the benchmark may load "
                             f"neither JAX nor the JAX package")
        peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        rec.memory_peak_bytes = peak
        rec.trace = tracer.read()
        state = driver.release(ctx, state)
        checks, attempted, failed = driver.check(ctx, state)

    metrics = {}
    for m in (per_layer if trace else e2e):
        value = catalog.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": all(c.ok for c in checks), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown(rec.spans, rec.main_thread)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def _args(argv):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run there builds (the program's own nvcc libraries already
    live in ``topotpu_torch/kernels/_build/``)."""
    cache = catalog.ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _allocator() -> None:
    """One malloc arena that keeps what is freed (glibc's ``mallopt``).

    Set before any thread starts. By default every thread gets an arena of
    its own, and each large temporary (the engine's writer makes several of
    6-24 MB a tile-pair) is mapped afresh and faulted in page by page, at a
    cost that follows the host's memory state and so drifts through a
    check. With one arena, a 32 MB mmap threshold and no trimming, the
    freed blocks are reused: the same work, without the kernel's page
    faults. A libc without ``mallopt`` leaves the defaults."""
    import ctypes

    try:
        mallopt = ctypes.CDLL("libc.so.6").mallopt
    except (OSError, AttributeError):
        return
    M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_ARENA_MAX = -1, -3, -8
    mallopt(M_ARENA_MAX, 1)
    mallopt(M_MMAP_THRESHOLD, 32 << 20)
    mallopt(M_TRIM_THRESHOLD, (1 << 31) - 1)


def main(argv, t_imported: float) -> int:
    t_start = process_start(t_imported)
    _allocator()
    args = _args(argv)
    _caches()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is available: the benchmark measures the GPU", file=sys.stderr)
        return 2
    try:
        chips = int(catalog.load_json("cells", args.workload)["chips"])
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} GPUs and {torch.cuda.device_count()} are visible",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    banned = banned_modules()
    if banned:
        print(f"the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
