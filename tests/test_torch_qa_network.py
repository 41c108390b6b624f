"""``chip_smoke.py``'s station-QA network (``qa_network``: 1,000 stations,
2004-2015, 15 % missing, every planted fault) through the JAX package's QA
and homogenisation and through the port's, as the script's ``[qa]`` and
``[homog]`` phases run them: flags and breakpoints are equal bit for bit,
every planted fault carries an accepted code, and the JAX package's counts
of planted steps found and breaks elsewhere are the ``QH_JAX_COUNTS`` the
script holds the card's run to. About 25 s on one core.
"""

import pathlib
import sys

import numpy as np
import torch

from topotpu.core import constants as C
from topotpu.homog import homogenize_elements as j_homog
from topotpu.qa import run_qa_non_spatial as j_non_spatial
from topotpu.qa import run_qa_spatial as j_spatial
from topotpu_torch.homog import homogenize_elements as t_homog
from topotpu_torch.qa import run_qa_non_spatial as t_non_spatial
from topotpu_torch.qa import run_qa_spatial as t_spatial
from jax_pha_core import load_jax_pha

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_qa_network_matches_jax_and_the_scripts_counts():
    world, days, tmin, tmax, planted, steps = chip_smoke.qa_network()
    lon, lat = world.stn_lon, world.stn_lat
    flags = {}
    for pkg, non_spatial, spatial in (("jax", j_non_spatial, j_spatial),
                                      ("port", t_non_spatial, t_spatial)):
        ft, fx = non_spatial(tmin, tmax, days)
        flags[pkg] = dict(tmin=spatial(tmin, ft, lon, lat, days),
                          tmax=spatial(tmax, fx, lon, lat, days))
    for var in ("tmin", "tmax"):
        np.testing.assert_array_equal(flags["port"][var], flags["jax"][var])
    for name, var, s, t, codes in planted:
        assert np.isin(flags["jax"][var][s, t], list(codes)).all(), name

    obs = {v: np.where(flags["jax"][v] == C.QA_OK, a, np.nan)
           for v, a in (("tmin", tmin), ("tmax", tmax))}
    load_jax_pha()  # the JAX package's C++ core, built and loaded safely under xdist
    want = j_homog(obs, days.year, days.month, lon, lat)
    got = t_homog(obs, days.year, days.month, lon, lat, device=torch.device("cpu"))
    for var in want:
        assert got[var].breakpoints == want[var].breakpoints
        np.testing.assert_array_equal(got[var].adjustments, want[var].adjustments)
    assert chip_smoke.homog_counts(want, days, steps) == chip_smoke.QH_JAX_COUNTS
