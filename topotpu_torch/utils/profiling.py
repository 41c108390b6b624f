"""Profiling/tracing hooks (port of ``topotpu.utils.profiling``).

Parity target: SURVEY.md §5 — the reference has nothing beyond StatusCheck;
the rebuild adds device traces plus simple wall-time scopes keyed to the
BASELINE metric (cells/sec kriged).
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time


@contextlib.contextmanager
def device_trace(log_dir: str | pathlib.Path):
    """Capture a ``torch.profiler`` trace of the host and, where a CUDA
    device exists, its kernels; written on exit as a Chrome trace
    (``trace.json``, open it in Perfetto or ``chrome://tracing``) in
    ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / "trace.json"))


class Timer:
    """Named wall-time scopes with a cells/sec summary line."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self, n_cells: int | None = None) -> str:
        total = sum(self.times.values())
        out = {k: round(v, 3) for k, v in sorted(self.times.items(), key=lambda kv: -kv[1])}
        line = {"total_s": round(total, 3), "scopes": out}
        if n_cells and total > 0:
            line["cells_per_sec"] = round(n_cells / total, 1)
        return json.dumps(line)
