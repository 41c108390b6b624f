"""Spans in the program, and the exporter of a profiled run (the port of
``topotpu.utils.profiling``).

``span(name, key=None)`` marks one stage of the program's work where it
happens (the engine's prepare, launch, waits and writes, neighbour
selection, the PPCA EM loop, the station sweeps). It is a context manager:

* off (no ``recording()`` open and no ``torch.profiler`` recording) it
  returns one shared no-op object: two global reads, no allocation, no
  clock read;
* on, it appends one ``SpanRecord`` when it closes: its name, its start and
  end on ``time.perf_counter_ns``, the native id of its thread, its key (what
  it is of: a tile, a batch) and its parent, the innermost span open on the
  same thread when it opened;
* with a ``torch.profiler`` recording it also opens a ``record_function``
  range of the same name, so that a span of the profiler's thread sits in
  the Chrome trace on the profiler's clock and the trace ties each device
  operation to the range that launched it. (A range opened on another
  thread does not reach a trace that was not started with
  ``profile_all_threads``; those spans reach a reader through the records.)

Records go to every open ``recording()``; with none open, those taken while
a profiler records go to one list kept to its newest ``PROFILED_LIMIT``,
which ``recorded(t0, t1)`` reads. ``device_trace(log_dir, tag)`` runs both and
writes the Chrome trace (``trace<tag>.json``) and the records
(``spans<tag>.json``) on the trace's clock.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import pathlib
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function

PROFILED_LIMIT = 1_000_000  # records kept from runs profiled without a recording()


class SpanRecord(NamedTuple):
    id: int
    name: str
    t0: int               # time.perf_counter_ns at the span's start
    t1: int               # ... and at its end
    thread: int           # native id of the thread that took it
    key: object           # what the span is of (a tile, a batch), or None
    parent: int | None    # id of the innermost span open on the thread, or None


_open: tuple = ()  # the record lists of the open recording() blocks
_profiled: collections.deque = collections.deque(maxlen=PROFILED_LIMIT)
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of a run that records nothing: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "key", "id", "parent", "range", "t0")

    def __init__(self, name: str, key):
        self.name = name
        self.key = key

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        # the clock is read before the range opens: opening it calls into
        # torch, which lets go of the GIL, and taking it back may wait for
        # another thread for milliseconds after the range has begun
        self.t0 = time.perf_counter_ns()
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _local.stack.pop()
        rec = SpanRecord(self.id, self.name, self.t0, t1, threading.get_native_id(), self.key,
                         self.parent)
        sinks = _open
        if sinks:
            for s in sinks:
                s.append(rec)
        else:
            _profiled.append(rec)
        return False


def span(name: str, key=None):
    """A context manager that records the enclosed work as ``name`` (see the
    module docstring); the shared no-op where nothing records."""
    if not _open and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, key)


@contextlib.contextmanager
def recording():
    """Record every span of every thread while the block runs; yields the
    list the records are appended to, in the order the spans closed."""
    global _open
    got: list = []
    _open = _open + (got,)
    try:
        yield got
    finally:
        _open = tuple(r for r in _open if r is not got)


def recorded(t0: float | None = None, t1: float | None = None) -> list:
    """The records taken while a profiler recorded and no ``recording()``
    was open (the newest ``PROFILED_LIMIT``) that lie wholly inside
    [``t0``, ``t1``], in ``time.perf_counter`` seconds."""
    lo = -1 if t0 is None else int(t0 * 1e9)
    hi = float("inf") if t1 is None else int(t1 * 1e9)
    return [r for r in list(_profiled) if r.t0 >= lo and r.t1 <= hi]


@contextlib.contextmanager
def device_trace(log_dir: str | pathlib.Path, tag: str = ""):
    """Profile the enclosed work and record its spans. On exit ``log_dir``
    holds ``trace<tag>.json``, a ``torch.profiler`` Chrome trace of the host
    and, where a CUDA device exists, its kernels (open it in Perfetto or
    ``chrome://tracing``), and ``spans<tag>.json``, every span of every
    thread with its id, key, parent and thread, its times ``t0`` / ``t1`` in
    wall-clock ns as the trace's are (``baseTimeNanoseconds`` + ``ts``).
    ``tag`` tells apart the files of processes that share ``log_dir``.
    Yields the list of records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    with recording() as got:
        to_wall = time.time_ns() - time.perf_counter_ns()
        prof.start()
        try:
            yield got
        finally:
            prof.stop()
    prof.export_chrome_trace(str(log_dir / f"trace{tag}.json"))
    spans = [{"id": r.id, "name": r.name, "t0": r.t0 + to_wall, "t1": r.t1 + to_wall,
              "thread": r.thread, "key": r.key, "parent": r.parent} for r in got]
    (log_dir / f"spans{tag}.json").write_text(json.dumps({"spans": spans}, default=repr))
