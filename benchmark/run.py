#!/usr/bin/env python3
"""Run one cell of the benchmark of ``topotpu_torch`` on this machine's GPUs.

    python3 benchmark/run.py --workload grid.year-chunks --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The cell is found by name in
``benchmark/cells/``; it names its configuration (``benchmark/configs/``) and
its traffic mix (``benchmark/traffic/``), whose driver
(``benchmark/drivers/``) sets up the inputs from the seed, warms up, runs the
measured window and hands what it produced to the plain reference under
``benchmark/reference/``. The metrics that ``BENCHMARK.json`` gives the cell
are read by ``benchmark/metrics/<name>.py``: its end-to-end metrics with
``--trace 0``, its per-layer ones with ``--trace 1``. The last line of
standard output is the result as one JSON object; the numbers compared with
the reference, each beside its limit, are the last lines of standard error.

Exits 2 without a result where no CUDA device is available, or fewer than
the cell asks for.
"""

import time

T_IMPORTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    sys.path[:0] = [os.path.dirname(HERE), HERE]  # the program, then the harness
    from benchlib import runner

    return runner.main(sys.argv[1:] if argv is None else argv, T_IMPORTED)


if __name__ == "__main__":
    sys.exit(main())
