"""What the benchmark loads, checked in a fresh interpreter: a small run of
each cell loads neither JAX nor the JAX package ``topotpu`` (top-level
module names compared whole: the port's name begins with the JAX
package's), and the references load nothing of the program."""

import json
import subprocess
import sys

import tiny

BANNED = {"jax", "jaxlib", "flax", "topotpu"}


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=tiny.ROOT, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runs_load_no_jax():
    code = (f"import sys, json; sys.path[:0] = [{tiny.BENCH + '/tests'!r}]\n"
            "import tiny\n"
            "for cell in sorted(tiny.OVERRIDES): tiny.run(cell)\n"
            "from benchlib import catalog\n"
            "for kind in ('drivers', 'metrics', 'counts'):\n"
            "    for p in sorted((catalog.BENCH_DIR / kind).glob('*.py')):\n"
            "        catalog.load_module(kind, p.stem)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _top_level(code)
    assert "topotpu_torch" in loaded
    assert not loaded & BANNED


def test_references_load_nothing_of_the_program():
    code = (f"import sys, json; sys.path[:0] = [{tiny.BENCH!r}]\n"
            "import reference, reference.grid, reference.infill, reference.precision\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _top_level(code)
    assert not loaded & (BANNED | {"topotpu_torch"})
