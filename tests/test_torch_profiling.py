"""The port's profiling hooks (``topotpu_torch.utils.profiling``) against the
JAX package's: ``Timer`` reports the same line for the same scopes, and
``device_trace`` writes a Chrome trace with the traced work on the CPU."""

import json

import pytest
import torch

from topotpu.utils import profiling as jprof
from topotpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("n_cells", [None, 0, 100, 65_536])
def test_timer_report_matches_jax(n_cells):
    timers = [tprof.Timer(), jprof.Timer()]
    for t in timers:
        with t.scope("a"):
            pass
        with t.scope("b"):
            pass
        with t.scope("a"):
            pass
    # the same scope times in both, so the reports can be compared as strings
    timers[1].times = dict(timers[0].times)
    assert timers[0].report(n_cells) == timers[1].report(n_cells)
    rep = json.loads(timers[0].report(n_cells))
    assert list(rep["scopes"]) == sorted(rep["scopes"], key=lambda k: -timers[0].times[k])
    assert ("cells_per_sec" in rep) == bool(n_cells and sum(timers[0].times.values()) > 0)


def test_timer_scope_records_on_error():
    t = tprof.Timer()
    with pytest.raises(RuntimeError):
        with t.scope("x"):
            raise RuntimeError("boom")
    assert t.times["x"] >= 0.0


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    x = torch.ones(128, 128)
    with tprof.device_trace(tmp_path / "trace"):
        (x @ x).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
