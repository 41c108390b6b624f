"""The readings a cell's limits are set from: the program's numbers compared
with the reference over many seeds, and the control's (the reference in
TF32 put in the program's place), in one process, so that the set-up is
paid once a seed and the process start once.

    python3 benchmark/tests/readings.py --workload grid.year-chunks --seconds 30 \
        --seeds 101 102 103 [--control]

Prints one JSON line a seed with every check's value. It needs a GPU; the
benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.dirname(BENCH), BENCH]

from benchlib import runner  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    a = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    opts = {"control": True} if a.control else {}
    for seed in a.seeds:
        out = runner.run_cell(a.workload, seed, a.seconds, False, torch.device("cuda", 0),
                              overrides={"options": opts})
        print(json.dumps({"seed": seed, "control": a.control, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": {k: v["value"] for k, v in out["checks"].items()}}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
