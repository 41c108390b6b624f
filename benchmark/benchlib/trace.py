"""The traced window: ``torch.profiler`` over CPU and CUDA activity, read
from its Chrome trace.

The profiler starts in set-up (its first start takes seconds) and stops at
the first boundary of the window's work after the cell's ``trace_seconds``,
or at the window's end. The trace is exported to a file under ``TMPDIR``,
read once and deleted. Its times are wall-clock nanoseconds
(``baseTimeNanoseconds`` + ``ts``); they are mapped onto ``perf_counter``,
the clock of the run record's spans.

What readers get (``Trace``): the device operations (kernels, copies,
memsets) inside the traced window, the host's launch of each (by
correlation id), the ``record_function`` ranges the harness opened, and the
union of device activity. A device operation that crosses an edge of the
window counts for its part inside.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceOp(NamedTuple):
    name: str
    t0: float
    t1: float
    corr: int


class Range(NamedTuple):
    name: str
    t0: float
    t1: float
    tid: int


class Tracer:
    """Start in set-up, ``boundary()`` at each unit boundary of the window,
    ``stop()`` at its end; ``trace`` then holds the reading."""

    def __init__(self, enabled: bool, trace_seconds: float | None):
        self.enabled = enabled
        self.trace_seconds = trace_seconds
        self.prof = None
        self.t_window = None
        self.t_stop = None
        self.trace = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()

    def window_started(self, t: float) -> None:
        self.t_window = t

    def boundary(self) -> None:
        """A unit of the window's work has ended: stop once the cell's
        ``trace_seconds`` have passed."""
        if (self.prof is not None and self.t_stop is None and self.trace_seconds is not None
                and time.perf_counter() - self.t_window >= self.trace_seconds):
            self._stop()

    def stop(self) -> None:
        if self.prof is not None and self.t_stop is None:
            self._stop()

    def _stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def read(self) -> "Trace | None":
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        self.trace = Trace(raw, self.t_window, self.t_stop)
        return self.trace


class Trace:
    def __init__(self, raw: dict, w0: float, w1: float):
        # wall-clock ns of the trace -> perf_counter seconds
        offset_ns = time.time_ns() - time.perf_counter_ns()
        base = int(raw.get("baseTimeNanoseconds", 0))

        def t(us):
            return (base + us * 1e3 - offset_ns) / 1e9

        self.window = (w0, w1)
        self.ops: list[DeviceOp] = []
        self.launch_at: dict[int, tuple[float, int]] = {}  # correlation -> (t, tid)
        self.ranges: list[Range] = []
        self.cpu_ops: list[Range] = []
        for e in raw.get("traceEvents", []):
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            t0 = t(float(e["ts"]))
            t1 = t0 + float(e.get("dur", 0.0)) / 1e6
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                a, b = max(t0, w0), min(t1, w1)
                if b > a:
                    self.ops.append(DeviceOp(e["name"], a, b, int(args.get("correlation", -1))))
            elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                self.launch_at[int(args["correlation"])] = (t0, int(e.get("tid", 0)))
            elif cat == "user_annotation":
                self.ranges.append(Range(e["name"], t0, t1, int(e.get("tid", 0))))
            elif cat == "cpu_op":
                self.cpu_ops.append(Range(e["name"], t0, t1, int(e.get("tid", 0))))
        self.ops.sort(key=lambda o: o.t0)
        self.busy = _union([(o.t0, o.t1) for o in self.ops])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def kernels(self, word: str) -> list[DeviceOp]:
        """Device operations whose name holds ``word``."""
        return [o for o in self.ops if word in o.name]

    def launched_in(self, range_name: str) -> tuple[list[DeviceOp], int]:
        """The device operations launched inside the ``record_function``
        ranges called ``range_name`` that began in the window, and the
        number of those ranges."""
        rs = sorted((r for r in self.ranges if r.name == range_name
                     and self.window[0] <= r.t0 < self.window[1]), key=lambda r: r.t0)
        starts = [r.t0 for r in rs]
        got = []
        for o in self.ops:
            at = self.launch_at.get(o.corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at[0]) - 1
            if i >= 0 and at[0] <= rs[i].t1 and at[1] == rs[i].tid:
                got.append(o)
        return got, len(rs)

    def idle_gaps(self) -> list[tuple[float, float]]:
        w0, w1 = self.window
        edges = [w0] + [x for iv in self.busy for x in iv] + [w1]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def breakdown(self, spans, main_thread: int) -> dict:
        """The ten device operations that took most time, by name, and the
        ten longest idle gaps, each named by what the host's main thread was
        doing at its middle: the innermost span of the harness there, and
        the outermost profiled host operation."""
        by_name: dict[str, float] = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + (o.t1 - o.t0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
        main_ops = [r for r in self.cpu_ops if r.tid == main_thread]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            now = [s for s in spans if s.t0 <= mid <= s.t1]
            inner = [s for s in now if s.thread == main_thread]
            what = "main: " + (min(inner, key=lambda s: s.t1 - s.t0).name if inner
                               else "between the harness's spans")
            ops = [r for r in main_ops if r.t0 <= mid <= r.t1]
            if ops:
                what += " / " + max(ops, key=lambda r: r.t1 - r.t0).name
            others = sorted({s.name for s in now if s.thread != main_thread})
            if others:
                what += "; other threads: " + ", ".join(others)
            named.append([what, b - a])
        return {"device_ops": [[n[:200], s] for n, s in top], "idle_gaps": named}


def _union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
