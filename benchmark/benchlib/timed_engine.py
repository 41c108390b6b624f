"""The grid cell's ``TileEngine``: the program's engine, with the harness's
spans around the calls it makes to its own stages.

A frozen copy of ``chip_smoke.py::timed_engine``: host-clock spans around
``prepare_pair`` (main thread), the fetch wait (fetch thread),
``_write_tile_pair`` (writer thread: mosaic write, read-back verify,
manifest) and each step launch, each keyed by (chunk day offset, tile). Its
changes: the spans go to the run record; in a traced run each launch opens
a ``record_function`` range (``bench.step``) so that the kernels it launched
are found in the trace; the chunk loop stops at the first chunk boundary
past the deadline and marks each boundary for the tracer; and ``hooks`` may
alter a step's product (the tests' planted fault).
"""

from __future__ import annotations

import contextlib
import time


def timed_engine(rec, sink, deadline: list, tracer, traced: bool, alter=None):
    """A ``TileEngine`` subclass writing into ``sink``. ``deadline[0]`` is the
    ``perf_counter`` time after which no chunk begins; ``alter(engine, spec,
    out)``, where given, may change a step's product in place."""
    from torch.profiler import record_function

    from topotpu_torch.dist.engine import TileEngine

    def stamp(name, t0, engine, spec):
        rec.add(name, t0, time.perf_counter(), key=(engine.mosaic_t0, spec.tile_id))

    class Timed(TileEngine):
        MOSAIC_WRITER = sink

        def prepare_pair(self, spec, a, b):
            t = time.perf_counter()
            out = super().prepare_pair(spec, a, b)
            stamp("prepare_pair", t, self, spec)
            self._spec = spec
            return out

        def _fetch(self, fut):
            t = time.perf_counter()
            host = TileEngine._fetch(fut)
            rec.add("fetch_wait", t, time.perf_counter())
            return host

        def _write_tile_pair(self, spec, var_a, var_b, result):
            t = time.perf_counter()
            super()._write_tile_pair(spec, var_a, var_b, result)
            stamp("write_tile_pair", t, self, spec)
            land = int(self.rasters.landmask[spec.row0 : spec.row0 + spec.nrows,
                                             spec.col0 : spec.col0 + spec.ncols].sum())
            rec.counters["tile_pairs"] += 1
            rec.counters["var_cell_days"] += 2 * land * self.days.ndays

        def _get_pair_fn(self, *args, **kwargs):
            fn = super()._get_pair_fn(*args, **kwargs)

            def launch(*a, **kw):
                t = time.perf_counter()
                with record_function("bench.step") if traced else contextlib.nullcontext():
                    out = fn(*a, **kw)
                    if alter is not None:
                        alter(self, self._spec, out)
                stamp("step_launch", t, self, self._spec)
                return out
            return launch

        def _iter_chunk_engines(self, years_per_chunk):
            for sub, day_sel in super()._iter_chunk_engines(years_per_chunk):
                if time.perf_counter() >= deadline[0]:
                    return
                yield sub, day_sel
                tracer.boundary()

    return Timed
