"""The run record: what a run leaves for the metric readers.

Spans are taken on the host clock (``time.perf_counter``) by the benchmark's
own files around the calls into the program; counters and value lists hold
what the program returns (counts, iterations). ``window`` is the measured
window, ``setup_s`` the time from process start to its first operation, and
``trace`` the profiler's reading of the traced window (``--trace 1`` only),
``memory_peak_bytes`` the device memory the window's work held at its peak.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    thread: int   # native id of the thread that took it
    key: object   # what the span is of (a tile, a call), or None


class Record:
    def __init__(self):
        self.spans: list[Span] = []
        self.counters: collections.Counter = collections.Counter()
        self.values: dict[str, list] = collections.defaultdict(list)
        self.window = (0.0, 0.0)
        self.setup_s = 0.0
        self.trace = None
        self.memory_peak_bytes = 0
        self.meta: dict = {}  # what readers need of the cell: shapes, calendars
        self.main_thread = threading.get_native_id()

    def add(self, name: str, t0: float, t1: float, key=None) -> None:
        self.spans.append(Span(name, t0, t1, threading.get_native_id(), key))

    @contextlib.contextmanager
    def span(self, name: str, key=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, t0, time.perf_counter(), key)

    def of(self, name: str) -> list[Span]:
        """The spans called ``name`` that ended inside the window."""
        w0, w1 = self.window
        return [s for s in self.spans if s.name == name and w0 <= s.t1 <= w1]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]
