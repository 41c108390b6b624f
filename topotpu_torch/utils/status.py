"""Progress/throughput reporting (the port's own copy of the JAX package's
``utils/status.py``).

Parity target: ``twx/utils/status_check.py::StatusCheck`` (SURVEY.md §2.17,
§5) — the reference's only observability: a counter printing items/sec every
N ticks. Kept, plus a cells/sec figure since that is the BASELINE headline
metric.
"""

from __future__ import annotations

import sys
import time


class StatusCheck:
    def __init__(
        self,
        total: int,
        unit: str = "items",
        every: int = 1,
        enabled: bool = True,
        items_per: int = 1,
        out=None,
    ):
        # out=None resolves sys.stderr AT PRINT TIME: a default bound at
        # import time captures whatever stream sys.stderr happens to be when
        # this module is first imported (under pytest's capsys that is a
        # per-test buffer that gets CLOSED, and the next pipeline run dies
        # with "I/O operation on closed file"; long-lived CLI processes that
        # redirect stderr mid-run would hit the same staleness).
        self.total = total
        self.unit = unit
        self.every = every
        self.enabled = enabled
        self.items_per = items_per  # e.g. cells per tile, for cells/sec
        self.out = out
        self.count = 0
        self.t0 = time.perf_counter()

    def tick(self, n: int = 1):
        self.count += n
        if self.enabled and self.count % self.every == 0:
            dt = time.perf_counter() - self.t0
            rate = self.count / max(dt, 1e-9)
            msg = (
                f"[status] {self.count}/{self.total} {self.unit} "
                f"({rate:.2f} {self.unit}/s"
            )
            if self.items_per > 1:
                msg += f", {rate * self.items_per:,.0f} cells/s"
            msg += f", {dt:.1f}s elapsed)"
            out = self.out if self.out is not None else sys.stderr
            try:
                print(msg, file=out, flush=True)
            except ValueError:
                # a caller-supplied stream that has since been closed must
                # not kill the pipeline over a progress line
                pass

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0
