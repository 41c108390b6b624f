#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port, ``topotpu_torch``, once on one NVIDIA GPU.

    python3 chip_smoke.py            # everything below
    python3 chip_smoke.py kernels    # phases 1-3 only (kernel times of one source tree, the
                                     # [normals] lines included), then exit 0 without the
                                     # last two lines
    python3 chip_smoke.py scatter    # the same with only the daily contraction's lines
    python3 chip_smoke.py ok_solve   # only the OK solve: its build and its [ok_solve] lines

(``_multihost_worker`` is the mode of phase 13's workers, which the script
starts itself.)

Phases, in order; each prints one line, and any failure exits non-zero:

1. environment: torch version, the device, and ``nvidia-smi``'s name and
   power limit (a line of its own). No CUDA device: exit non-zero.
2. build: the four kernel libraries from ``topotpu_torch/kernels/csrc/*.cu``
   with nvcc, all started at once. While they compile, the main thread
   builds phase 9's world on the host (numpy, 15-22 s on the card's host),
   and ``python -m topotpu_torch.cli --help`` (phase 12) runs in a process
   of its own: the script's 240 s budget had no room for either in turn.
   The OK solve's library, the slowest to compile, is waited for only
   where its lines begin, after the other kernels' lines.
3. kernel vs plain version on the card at production shapes (65,536
   cells, a 512-station pool, k = 32 and 64; the daily contraction at D =
   744 and 2,976), with the CPU parity tests' tolerances on 99.9 % of
   values, a cap on every value and a float64 run as arbiter (see
   ``_compare_krig``), and CUDA-event times. ``krig_normals`` takes the tile
   step's 24 systems a cell in one launch, with one shared neighbourhood and
   with one a month (and, at k = 32, under the gaussian and the uniform
   weight kernel, and with the systems on the first 24 slots and the gain
   rows on the first 16, one neighbourhood a month, the sizes of the main
   path's anomaly sweep and per-variable tiles, with float64 deciding for
   the normal and the trend by statistics); its time stands beside that of
   the same systems solved one a launch, 24 launches on the same inputs.
   Beside each kernel's time: its bound (the larger of bytes over 3.35 TB/s
   and fp32 operations over 67 TFLOP/s), and for the daily contraction the
   time of ``scatter_add_`` + ``matmul`` (two library calls). The daily
   contraction's packed entry
   (``scatter_daily_packed``: contraction, + normal, reconcile, int16
   quantisation and calendar order in one launch) runs at both variables,
   365 days (31 slots a month) and 1,461 days (124), with one neighbourhood
   and with one a month, with shared and with per-variable gain rows, the
   reconcile on, part of the cells not ok: against its plain version by the
   integer rule (sentinels identical, at most one int16 count apart, under
   1 % of counts differing, no tmax < tmin where both are ok), beside the
   time of the float entry followed by the packing in plain torch. Then the
   fused OK solve at its own API, both entries
   (pair distances, xyz), B = 65,536 and k = 32 and 64: one call of each
   entry with the launch counters from 0, then the comparison with the
   plain version (``tests/test_pallas_krig.py``'s tolerances on every value,
   ok flags identical, masked weights exactly 0), beside the library route
   to the factorisation and solves (``torch.linalg.cholesky_ex`` +
   ``torch.cholesky_solve`` on the plain version's matrices, which the port
   never calls). ``python3 chip_smoke.py ok_solve`` builds only
   ``ok_solve.cu`` and prints only these lines. Between the ``[kernels]``
   and the ``[ok_solve]`` lines, ``[normals]``: ``interp/normals.py``'s
   ``krig_normals_and_gains`` and ``krig_normals`` on the same 65,536 cells
   (the 64 nearest stations' rows gathered once; k = 32 and 64 with
   q = 3 trend covariates (elev, tdi, July's LST) and qa = 2 (elev, tdi),
   k = 32 with q = 7 (elev, tdi, the LST of months 0-4) and qa = 1, and
   the gaussian and uniform weight kernels at k = 32): each call one launch
   of the gathered entry of ``krig_normals.cu`` and none of the indexed
   one, then that entry against its plain version by ``_compare_krig``'s
   rule, its time, the plain version's, its bound and the July normals'
   MAE against the world's truth (under 0.3 C where July's LST is a
   covariate). Then the variogram fit (``kernels/variogram_fit.py``) at the
   station stage's shape, 10,000 fits x 15 bins x 50 Gauss-Newton steps in
   one launch, against its plain loop: ok flags identical, after one step
   every fit's parameters and SSE within 1e-5 of their scale, and after 50
   at most 1 % of the fits' curves more than 1e-3 of the sill apart (a step accepted or
   rejected on near-equal SSEs parts a few fits, as float64 does), its
   time, the plain loop's and its bound.
4. the paired tile step (``interp_tile_pair_flat``) at the benchmark's size:
   65,536 cells, 512 stations, k = 32, 365 days, both variables, the
   run-global pack lattice and the reconcile. The run must launch
   ``krig_normals`` and ``scatter_daily_packed`` exactly once each and the
   float entry ``scatter_daily`` not at all; the decoded
   int16 product is held against the float64 numpy oracle and the world's
   true normals. Then the same step with per-variable neighbourhood sizes
   on one 128 x 128 tile, which launches ``krig_normals`` once a variable
   and ``scatter_daily_packed`` once.
5. the reconcile on the lattice at one 128 x 128 production tile with
   crossing variables: no cell where both are ok may have tmax < tmin. Its
   float step (``interp_tile_pair``) must launch ``scatter_daily`` once.
6. the float64 validation mode (``interp/f64check.py::compare_f32_f64``, the
   CLI's validate-f64 step) on one 64 x 64 tile of the benchmark world (cut
   from a 128 x 128 production tile: its float64 side took the host 9-32 s),
   one variable, k = 32, with the month layout's real-day mask: the float32
   step on the card against the same step in float64 on the host's CPU.
   Printed: normal, se and daily RMSE and max, the ok flip rate, the cells
   compared and both walls. It fails unless the float32 side launched
   ``krig_normals`` once, ``scatter_daily`` once and ``scatter_daily_packed``
   not at all, and normal and daily RMSE are under BASELINE's 0.05 C.
7. a profiler breakdown of one step, with the launch counts read from the
   trace (one ``krig_normals`` kernel, one packed kernel, no float-entry
   kernel), the copy, ``cat`` and elementwise kernels' share and the total
   number of kernel launches.
8. the production engine (``dist/engine.py::TileEngine``) as the CLI's
   interp stage drives it: direct-to-mosaic ``run_production_pair`` over
   ``bench_e2e.py``'s world (512 x 512 cells, 1,000 stations, 16 tiles of
   128 x 128, k = 32, a 512-station pool, both variables, the reconcile) in
   two one-year chunks (2015, 2016: 32 tile-pair steps), with a k_table that
   gives two tiles per-variable sizes, into an in-memory mosaic
   (``MemoryMosaic``: the writer interface on numpy arrays). Printed: wall,
   var-cells/s, the main thread's prepare, the fetch thread's wait, the
   writer's time, the steps' device time (CUDA events around each launch)
   and busy share, launches, peak device and pinned host memory. It fails
   unless 32 tile-pairs come back a variable, every manifest entry covers
   its tile's land with no lattice violation and records its k, the
   launches are 36 ``krig_normals``, 32 ``scatter_daily_packed`` and no
   ``scatter_daily``, two tiles equal direct step calls bit for bit, July
   normals of 8,192 sampled cells are within 0.3 C MAE of the truth, and a
   resume of three tiles recomputes exactly them, bit for bit.
9. the station-side stages at the reference's full network size: 10,000
   stations on a 1024 x 1024 grid over one 4-year chunk (1,461 days).
   krig-params (k_fit = 64; it must launch ``variogram_fit`` 12 times,
   once a month) and the failed-fit fill, with the usable-fit
   share, the July empirical variograms of 256 sampled stations (recomputed
   from the same month's residuals) held against the float64 loop oracle,
   and the timed run's fits of them against scipy's; then the indexed
   ``krig_normals`` kernel against its plain version at the x-val runs' own
   shapes (12 LOO neighbourhoods, the 10,000 stations as cells and as table
   rows, one variable) at every k of the nnghs sweep: k = 32 and 48 by
   ``_compare_krig``'s rule value by value, k = 8, 16 and 24 with float64
   deciding by statistics (``ill_conditioned``); then the LOO x-val
   of normals at k = 32 (accuracy bars, July normals of 256 stations against
   the float64 pipeline oracle run with the station left out), the nnghs
   sweep over (8, 16, 24, 32, 48) with two regions, the daily x-val and the
   anomaly sweep over (8, 16, 24, 32). The indexed ``krig_normals`` launch
   counter must rise by one per x-val run. Each stage's wall time and the peak device
   memory are printed, and profiler breakdowns of krig-params (its fits
   one ``variogram_fit`` launch a month) and of the daily x-val.
10. the stages before the infill, as the CLI's qa, homog and make-regions
   steps call them, on the CLI's synthetic network (``qa_network``:
   ``make_world(default_rng(31))``, 512 x 512 cells, 1,000 stations,
   2004-2015, tmin and tmax as its synth-data step builds them, 15 %
   missing), with ``tests/test_qa.py``'s planted defects, its lone +15 C
   value (in tmax) and +1.5 C before 2010 in both variables of 20 stations:
   ``run_qa_non_spatial``, ``run_qa_spatial`` of each variable, the flagged
   values set to NaN, ``homogenize_elements`` over tmin and tmax, and
   ``make_climate_regions`` of the world's rasters. The full network is
   10,000 stations; at that size this host work would take about 80 s, so
   it is cut to 1,000 (the 12-year span is what minseg = 24 months needs).
   Printed: each wall, flags by code, the share of unplanted values
   flagged, planted steps found within 6 months and breaks elsewhere per
   variable, the branch ``select_predictors`` took, region sizes. It fails
   unless every planted fault carries a code ``tests/test_qa.py`` accepts,
   the selection took its numpy branch, the homogenisation finds at most
   one planted step fewer and at most two breaks more elsewhere than the
   JAX package does on the same network (``QH_JAX_COUNTS``), and the
   regions are labelled 0..11 on land and -1 off it, none empty.
11. the PPCA infill at BASELINE config #3's settings
   (``configs/config3_infill.json``: 12 components, 24 predictors, 200
   iterations, batches of 32) over the first 5,000 stations of the station
   phase's world and its 1,461 days (config #3's 1986-2015 span, 10,957
   days, took the phase 224 s on an H100 80GB HBM3 at 700 W, over its 120 s
   budget; all 10,000 stations took the host-bound EM loop 66-99 s and the
   whole script 269-285 s, so the network is cut to keep the script under
   240 s; 5,000 stations still take the device branch of the selection):
   the CLI's 15 % random gaps, then ``xval_infill``'s
   20 % hold-out, then the post-infill
   changepoint flags. Printed: the walls of ``select_predictors``, the EM
   batch loop, ``changepoint_flags`` and ``xval_infill``, the EM iteration
   statistics, peak device memory and a profiler breakdown of one EM
   batch over 50 iterations. It fails unless the device branch of ``select_predictors`` ran,
   the held-out MAE is under 0.6 x the station-month climatology's, |bias|
   < 0.1 C, the filled series' monthly normals are within 0.15 C MAE of the
   truth, every kept observation comes back unchanged and every value is
   finite, the predictor sets of 256 sampled stations agree with a float64
   recompute away from ties, and ``ppca_impute`` on two batches agrees
   between the card and the CPU (``filled`` within 5e-2 C, 5e-3 C on 99.9 %
   of entries; iteration counts within one).
12. the CLI's stages (``topotpu_torch/cli/steps.py``) chained in the order
   ``all --optim-nnghs`` runs them, through the array cores that sit
   between their artifact reads and writes (no h5py on the card's machine):
   the synthetic world of ``--grid 256 --stations 512`` over 2015 -> qa ->
   homog -> infill (PPCAParams' defaults: 12 components, 24 predictors, 200
   iterations) -> krig-params -> optim-nnghs (regions by
   ``make_climate_regions``, both sweeps a variable) -> interp (the engine
   into ``MemoryMosaic``, four 128 x 128 tiles, k = 32, a 512-station pool,
   the reconcile, the sweep's k_table) -> mosaic (direct layout, complete,
   reconciled) -> point (8 land sites) -> validate (streamed, with its disk
   sample on the in-memory mosaic) -> aggregate -> validate-f64 (tmin, one
   64 x 64 tile as in phase 6: the production tile's float64 side takes
   9-32 s on the card's host). Each stage consumes the one before it; each
   prints its report as the CLI does and its launches. Full production
   width, cut in depth: the stages' device work at the network's full size
   is what phases 8, 9 and 11 measure. It fails unless
   ``python -m topotpu_torch.cli --help`` exits 0, every land tile is in the
   manifest with full coverage, ``viol`` 0 and its k, the launches are those
   the tiles and the k_table give (optim-nnghs one ``krig_normals`` a sweep
   candidate, interp one a tile-pair and two where the variables' sizes
   differ plus one ``scatter_daily_packed`` a tile-pair and no float entry,
   point and validate-f64 one ``krig_normals`` and one ``scatter_daily`` a
   variable, the rest none; krig-params 24 ``variogram_fit``, one a month
   and variable), the point stage's normals, se and dailies agree
   with the same stage on CPU tensors (the plain versions; ``[kernels]``'
   parity tolerance on 99.9 % of values, 1e-2 C cap), validate-f64 is
   within the 0.05 C bar, no decoded cell has tmax < tmin, validate is ok for both
   variables, the July normals of 8,192 land cells are within 0.3 C MAE of
   the truth (the world's normal plus its anomaly field's July mean: the
   chain's normals come from one year of observations), and the first
   month's aggregate is the numpy mean of the decoded dailies within one
   lattice step.
13. a job of two processes on the card (``[multihost]``): two workers of
   this script, started as soon as the build ends (their imports, CUDA
   start-up and rendezvous overlap the phases before), both on ``cuda:0``
   (``local_mesh``: one card, two ranks), joined by gloo at a port this
   script keeps bound and hands to process 0. Each runs
   ``TileEngine.run_production_pair`` over its strided tiles of phase 12's
   world (its inputs, pickled by this process) into its own in-memory shard
   and ``manifest_pNNN.json``; then a barrier; the coordinator merges the
   manifests and assembles the shards tile by tile as
   ``build_virtual_mosaic`` maps them (tile_id % 2). Meanwhile this process
   runs the same production on one device. It fails unless both workers
   exit 0, each made its own tiles, their launches add up to the
   one-process run's, and the assembled mosaics and merged manifests equal
   the one-process run's bit for bit. Printed: each worker's start-up, wait,
   run and launches.
14. the split path (``[mesh]``): ``sharded_interp_tile_pair_flat`` over
   ``make_mesh(devices=[cuda:0, cuda:0])`` on one 128 x 128 tile of phase
   4's world (k = 32, the 512-station pool, both variables, the reconcile),
   with the dynamic lattice (one reduction over the shards) and the fixed
   one (none): each product bit for bit against the single-device step
   (int16 buffer and scales), the launches of the two shards two of
   ``krig_normals`` and two of the float or the packed contraction, both
   forms' walls in turns. Then the sharded product fetched two ways
   (gathered on the card and copied once; a copy and an event a shard, then
   the columns put in order on the host), in turns. Then
   ``TileEngine.run_pair`` over phase 12's world with the two-shard mesh
   and with one device, each twice: mosaics, attributes and manifests bit
   for bit, launches twice the one-device engine's.
15. the card's name and power limit, one JSON line of kernels (each launch
   count is the sum over the main-path runs, each counted from 0; each
   kernel with its time, its plain version's, its bound and the library's
   way where there is one) and, as the last line,
   ``{"ok": true, "device": {...}}``. ``[phase]`` lines give each phase's
   wall.

It imports nothing of JAX and nothing of the JAX package: configuration,
dates, the synthetic world and the float64 oracle are the port's own.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

N_SIDE = 256          # benchmark world: 256 x 256 = 65,536 cells
N_STATIONS = 512
K = 32
NDAYS = 365
ORACLE_CELLS = 256
ORACLE_BUDGET_S = 60.0
HALF_STEP_C = 1.2e-3  # half of the run-global lattice step, 160 C / 65500 / 2
# station-side slice: config8's grid with config7's network (~8.5 km spacing)
ST_SIDE = 1024
ST_STATIONS = 10000
ST_START, ST_END = "2015-01-01", "2018-12-31"  # one 4-year chunk, 1,461 days
ST_SAMPLE = 256       # stations held against the float64 oracles
# infill slice: BASELINE config #3 over the station phase's network
IN_CONFIG = "configs/config3_infill.json"
IN_STATIONS = 5000    # the first 5,000 of the station phase's 10,000 (see phase_infill)
IN_GAPS = 0.15        # the CLI's synthetic random gaps (cli/steps.py step_synth_data)
IN_HOLDOUT = 0.2      # xval_infill's hold-out
IN_TIE_MARGIN = 1e-4  # predictor score units (|corr| + 1); float32 grams part by ~1e-6
# engine slice: bench_e2e.py's 512 x 512 world, 1,000 stations, two one-year chunks
EN_SIDE = 512
EN_STATIONS = 1000
EN_START, EN_END = "2015-01-01", "2016-12-31"  # 731 days, one leap year
EN_K_TABLE = {5: {"tmin": (24, 16), "tmax": (32, 24)},   # per-variable (k, ka) of two
              10: {"tmin": (24, 16), "tmax": (32, 24)}}  # tiles, as optim-nnghs gives
EN_RESUME = (3, 5, 12)  # tiles of the 2016 chunk recomputed by the resume check
EN_TRUTH_CELLS = 8192   # cells whose July normal is held against the truth
# station QA + homogenisation slice: the CLI's synthetic network (step_synth_data)
# at 1,000 of the full network's 10,000 stations (see phase_station_qa)
QH_SIDE = 512
QH_STATIONS = 1000
QH_START, QH_END = "2004-01-01", "2015-12-31"  # 4,383 days: minseg = 24 months needs the span
QH_MISSING = 0.15       # step_synth_data's missing_frac
QH_STEPS = 20           # stations with +1.5 C in both variables before QH_STEP_AT
QH_STEP_AT = 20100101
# planted steps found (of QH_STEPS) and breaks elsewhere, per variable, that the
# JAX package's QA + homogenize_elements give on qa_network()
# (tests/test_torch_qa_network.py holds them); the port may find one fewer
# and two more elsewhere
QH_JAX_COUNTS = {"tmin": (7, 0), "tmax": (7, 0)}
# float64 validation slice: a 64 x 64 tile, not a 128 x 128 production tile;
# the float64 side on the host took 9-32 s at 128 x 128, which held the script
# over 240 s in one of three runs (see phase_f64)
F64_SIDE = 64
# the CLI's stages chained: `all --optim-nnghs` on the CLI's synthetic world at
# --grid 256 --stations 512 over 2015 (four production tiles; see phase_cli)
CLI_SIDE = 256
CLI_STATIONS = 512
CLI_START, CLI_END = "2015-01-01", "2015-12-31"
CLI_CANDIDATES = (8, 16, 24, 32, 48)  # the CLI's --k-candidates default
CLI_POINTS = 8          # point-stage sites, on land cells
CLI_TRUTH_CELLS = 8192  # cells whose July normal is held against the truth
# the split path: one 128 x 128 production tile of phase 4's world in two
# shards of one card (see phase_mesh)
MESH_SIDE = 128
MESH_REPS = 5           # step walls of each form, in turns, after a warm-up
# two processes on the card, each over its strided tiles of the [cli] world
# (see start_multihost and multihost_worker)
MH_PROCESSES = 2
MH_TIMEOUT_S = 600      # the workers wait from the build to the end of [cli]
# csrc/<name>.cu; kernel names hold them
KERNELS = ("krig_normals", "scatter_daily", "ok_solve", "variogram_fit")
VF_FITS, VF_BINS, VF_ITERS = 10_000, 15, 50  # the station stage's fits of one month
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_environment():
    import torch

    from topotpu_torch.core.device import cuda_device

    dev = cuda_device()  # raises without a CUDA device
    if shutil.which("g++") is None:  # the post-infill flags build homog/pha_core.cpp
        raise RuntimeError("no g++ on the PATH")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name!r} count {torch.cuda.device_count()}")
    log(smi)
    return dev, name


def phase_build(names=KERNELS):
    """Build ``csrc/<name>.cu`` for each name, one nvcc each, all at once;
    returns the ``[build]`` lines (the wall and the compiler's register and
    spill report) for the caller to print."""
    from concurrent.futures import ThreadPoolExecutor

    from topotpu_torch.kernels import _build

    def timed(name):
        t = time.perf_counter()
        return _build.build(name), time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source
        paths, walls = zip(*pool.map(timed, names))
    reports = []
    for path in paths:
        log_text = path.with_name(path.name + ".log").read_text()
        for ln in log_text.splitlines():
            entry = re.findall(r"\d+([a-z][a-z_]*_kernel)((?:I(?:L[ib]\d+E)+E)?)", ln)
            if "Compiling entry function" in ln and entry:  # name and template arguments
                args = ", ".join(re.findall(r"L[ib](\d+)E", entry[-1][1]))
                reports.append(f"{entry[-1][0]}<{args}>")
            elif "registers" in ln or "spill" in ln:
                reports.append(ln.strip())
    each = ", ".join(f"{n} {w:.3f} s" for n, w in zip(names, walls))
    return [f"[build] nvcc {_build.find_nvcc()} built {', '.join(names)} in "
            f"{time.perf_counter() - t0:.3f} s ({each})"] + [
                f"[build] ptxas: {ln}" for ln in reports]


def cuda_ms(fn, reps, warmup=2):
    """Mean device milliseconds of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(nbytes, flops):
    """The least time the card could take, ms, and what sets it: every input
    byte read once and every output byte written once at the memory rate, or
    the float32 operations at the peak rate outside the tensor cores."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def solve_flops(k, xyz=True):
    """Float32 operations of one k-neighbour kriging system, counted from
    the chain (a division, a square root, an exp or an asin as one): the
    covariance (k^2 / 2 entries of 4), the Cholesky (k^3 / 3), two
    right-hand sides through two triangular solves (4 k^2), the OK
    reduction (10 k); with ``xyz`` the k^2 / 2 pair distances of 12."""
    return 2 * k * k + k**3 / 3 + 4 * k * k + 10 * k + (6 * k * k if xyz else 0)


def vfit_flops(n_bins, n_iters):
    """Float32 operations of one variogram fit (a division or an exp as
    one), as ``csrc/variogram_fit.cu`` runs it: a step's 40 a bin (the
    Jacobian pass 30, the trial SSE 10) and 114 for the fit (the ten sums
    over the lanes, the damped 3 x 3 solve, the trial point, the decision);
    the set-up, under one step's worth, left out."""
    return n_iters * (40 * n_bins + 114)


def variogram_line(dev):
    """``[kernels] variogram_fit``: the fit kernel against its plain loop
    on VF_FITS synthetic exponential variograms (5 % noise, every 7th fit
    with its first bins empty, every 97th with every bin empty)."""
    import torch

    from topotpu_torch.kernels.variogram_fit import fit_exp_variogram_ref, variogram_fit
    from topotpu_torch.stats.variogram import EmpiricalVariogram

    B, n = VF_FITS, VF_BINS
    rng = np.random.default_rng(5)
    nug, ps, rg = rng.uniform(0, 0.2, B), rng.uniform(0.5, 3, B), rng.uniform(30, 150, B)
    h = np.linspace(5, 300, n)[None].repeat(B, 0)
    gamma = (nug[:, None] + ps[:, None] * (1 - np.exp(-h / rg[:, None])))
    gamma *= 1 + 0.05 * rng.normal(size=gamma.shape)
    npairs = rng.integers(5, 80, (B, n)).astype(np.float64)
    npairs[::7, :3] = 0
    npairs[::97] = 0
    gamma, h = np.where(npairs > 0, gamma, 0), np.where(npairs > 0, h, 0)
    emp = EmpiricalVariogram(*(torch.tensor(a, dtype=torch.float32, device=dev)
                               for a in (gamma, h, npairs, np.full(B, 300.0))))
    t = time.perf_counter()
    # one step: every fit's parameters and SSE within 1e-5 of their scale (the
    # sill, the range, the sill squared), as the card tests hold them
    one = [[a.double().cpu().numpy() for a in f[:4]]
           for f in (variogram_fit(emp, 1), fit_exp_variogram_ref(emp, 1))]
    sill = one[1][0] + one[1][1]
    step1 = max(float(np.max(np.abs(g - w) / (scale + 1e-30)))
                for g, w, scale in zip(*one, (sill, sill, one[1][2], sill**2)))
    if not step1 <= 1e-5:
        raise AssertionError(f"variogram_fit: one step {step1:.3e} of scale from the plain "
                             f"loop's")
    got, want = variogram_fit(emp, VF_ITERS), fit_exp_variogram_ref(emp, VF_ITERS)
    ok = want.ok.cpu().numpy()
    if not np.array_equal(got.ok.cpu().numpy(), ok):
        raise AssertionError("variogram_fit: ok flags differ from the plain loop's")
    p = [[a.double().cpu().numpy() for a in (f.nugget, f.psill, f.rng)] for f in (got, want)]
    curve = [q[0][:, None] + q[1][:, None] * (1 - np.exp(-h / q[2][:, None])) for q in p]
    gap = (np.abs(curve[0] - curve[1]).max(1) / (p[1][0] + p[1][1]))[ok]
    if np.mean(gap > 1e-3) > 0.01:
        raise AssertionError(f"variogram_fit: {np.sum(gap > 1e-3)} of {ok.sum()} fits more "
                             f"than 1e-3 of the sill from the plain loop's")
    t_cmp = time.perf_counter() - t
    ms = cuda_ms(lambda: variogram_fit(emp, VF_ITERS), 20)
    plain_ms = cuda_ms(lambda: fit_exp_variogram_ref(emp, VF_ITERS), 2, warmup=1)
    nbytes = 3 * B * n * 4 + B * 4 + 4 * B * 4 + B
    bnd = bound(nbytes, B * vfit_flops(n, VF_ITERS))
    log(f"[kernels] variogram_fit B={B} n_bins={n} n_iters={VF_ITERS}, 1 launch: ok flags "
        f"identical; after one step at most {step1:.3e} of scale from the plain loop; curves "
        f"vs the plain loop, in sills: median {np.median(gap):.3e}, 99th "
        f"percentile {np.quantile(gap, 0.99):.3e}, max {gap.max():.3e} ({np.sum(gap > 1e-3)} "
        f"of {ok.sum()} fits over 1e-3) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
        f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} ({t_cmp:.1f} s to compare)")
    return dict(max_abs_err=float(gap.max()), ms=ms, plain_ms=plain_ms, library_ms=None, **bnd)


def krig_flops(k, n_systems, n_nbr=1, q=3, qa=3, q_fixed=2):
    """Operations of the normals chain for one cell: per neighbourhood the
    weights, pair distances, the ``q_fixed`` design columns no system
    changes, the gain rows (qa + 1 columns: (qa + 1) (qa + 2) / 2 + qa + 1
    products of 3 k, and the small solves); per system its q - q_fixed
    design columns, the WLS normal equations and right-hand side (the same
    count for q + 1 columns), the residuals, the variogram weights and the
    kriging solve. The defaults are the indexed entry's design (trend elev,
    tdi, lst_m; anomalies elev, x, y); the gathered entry's one system is
    ``krig_flops(k, 1, 1, q, qa, q_fixed=q)``."""
    products = lambda p: p * (p + 1) // 2 + p  # noqa: E731
    per_nbr = (10 * k + 6 * k * k + q_fixed * 8 * k
               + (qa * 8 * k + products(qa + 1) * 3 * k + 200))
    per_system = ((q - q_fixed) * 8 * k + products(q + 1) * 3 * k + 200 + 10 * k + 6 * k
                  + solve_flops(k, xyz=False))
    return n_nbr * per_nbr + n_systems * per_system


def _krig_planes(rows64, k, dev):
    """The k-neighbour prefix of the 64-neighbour planes xyz3k (3k, C), dist_t
    and mask_t (k, C), with holes: the last slot of every 7th cell masked and
    cell 3 left with two valid slots (fewer than min_neighbors)."""
    import torch

    C = rows64["dist_t"].shape[1]
    xyz3k = np.array(rows64["xyz3k"].reshape(3, 64, C)[:, :k].reshape(3 * k, C))
    dist_t, mask_t = np.array(rows64["dist_t"][:k]), np.array(rows64["mask_t"][:k])
    mask_t[-1, ::7] = 0.0
    mask_t[2:, 3] = 0.0
    dist_t *= mask_t
    return [torch.from_numpy(a).to(dev) for a in (xyz3k, dist_t, mask_t)]


def _compare_krig(got, want, want64, k, ill_conditioned=False, collinear=False):
    """Kernel vs its float32 plain version, with a float64 plain run as the
    arbiter. At 65,536 cells a few cells have a nearly collinear trend
    design (lst follows elevation) whose float32 rounding is amplified by
    the squared condition number of the normal equations; there any two
    float32 implementations part by a few 1e-3 C. So: ok flags identical;
    at least 99.9 % of values within the parity tolerance (normal and trend
    rtol 1e-4 atol 1e-3, 2e-3 above k = 32; variance rtol 1e-3 atol 1e-4;
    variogram and gains rtol 1e-4 atol 1e-5); every value within the cap
    (1e-2 C for normal and trend, 1e-3 for variance and gains; 1e-4 for the
    variogram values outside the parity tolerance, since a fitted range of
    thousands of km has a float32 spacing above 1e-4); and the kernel no further from float64 than 2x the plain
    version's distance + the parity atol.

    With ``ill_conditioned`` (the LOO systems at k <= 24 over a network at
    8.5 km spacing: a 4-column trend design whose float32 plain version
    itself sits up to 5e-2 C from float64 at a few stations at k = 16, and
    where the worst station of a month is the kernel's as often as the plain
    version's) float64 decides for the normal and the trend by statistics,
    not value by value: the mean, the 99th and the 99.9th percentile of the
    kernel's distances at most 2x the plain version's + 1e-4 C, and its
    worst within 0.1 C, the float32 band on record for k = 16. At k = 24
    that is the only change (one station's kernel normal is 2.4e-3 C from
    float64 where the plain version's happens to be exact; the plain
    version's worst is 2.6e-3 C); at k = 16 the normal and the trend are
    moreover held to the parity tolerance on 99 % of values, without the cap.

    Below k = 16 (the sweep's k = 8: four trend columns on eight neighbours)
    float32 is further out still: on this network the plain version's
    normals sit up to 0.64 C from float64 at the worst station of a month
    (the kernel's up to 0.48 C), 95.7-97.3 % of a month's normals are inside
    the parity tolerance, and the gain rows part by up to 1.8e-3 (99.88 %
    inside). There the same statistics decide for the normal, the trend and
    the gains, with 95 % of the normals and trends and 99 % of the gains
    inside the parity tolerance, the kernel's worst normal within 1 C and
    its worst gain within 1e-2.

    With ``collinear`` (a trend design whose columns share a term: the LST
    of several months, each a constant minus 0.0055 x elevation plus a
    field of its own; or elevation and one month's LST on a 24-slot prefix,
    where the plain version's normal sits up to 8.8e-3 C from float64 and
    the kernel's up to 2.9e-3 C, 1.0e-2 C apart at the worst cell) float64
    decides for the normal and the trend at any k as the
    ``ill_conditioned`` rule does below k = 24: 99 % of values inside the
    parity tolerance, the statistics against float64, the worst within
    0.1 C."""
    import torch

    got, want, want64 = (t.double() for t in (got, want, want64))  # compared on the card
    if not torch.equal(got[2], want[2]):
        raise AssertionError("ok flags differ")
    ok = want[2] > 0.5
    atol_n = 2e-3 if k > 32 else 1e-3
    checks = [
        (lambda t: t[0][ok], 1e-4, atol_n, 1e-2, "normal"),
        (lambda t: t[3][ok], 1e-4, atol_n, 1e-2, "trend"),
        (lambda t: t[1][ok], 1e-3, 1e-4, 1e-3, "variance"),
        (lambda t: t[4:7], 1e-4, 1e-5, 1e-4, "variogram"),
        (lambda t: t[8:][:, ok], 1e-4, 1e-5, 1e-3, "gains"),
    ]
    err = 0.0
    for pick, rtol, atol, cap, what in checks:
        g, w, w64 = pick(got), pick(want), pick(want64)
        d = (g - w).abs()
        within = d <= atol + rtol * w.abs()
        inside = float(within.double().mean())
        dmax = float(d.max())
        small = ill_conditioned and k < 16
        trendish = what in ("normal", "trend")
        by_stats = (ill_conditioned and (trendish or (small and what == "gains"))
                    or collinear and trendish)
        loose = by_stats and (k < 24 or collinear)
        # one float32 step of a 2,000 km range is 1.2e-4, above the cap
        capped = d[~within] if what == "variogram" else d
        over_cap = not loose and capped.numel() > 0 and float(capped.max()) > cap
        share = 0.999 if not loose else 0.95 if small and trendish else 0.99
        if inside < share or over_cap:
            raise AssertionError(f"{what}: {inside:.5f} within tolerance, max {dmax:.3e}")
        e_kern, e_plain = (g - w64).abs(), (w - w64).abs()
        if by_stats:
            stats = (torch.mean, lambda e: e.flatten().quantile(0.99),
                     lambda e: e.flatten().quantile(0.999))
            worst = (1.0 if small else 0.1) if trendish else 1e-2
            further = float(e_kern.max()) > worst or any(
                float(stat(e_kern)) > 2 * float(stat(e_plain)) + 1e-4 for stat in stats)
        else:
            further = bool((e_kern > 2 * e_plain + atol + rtol * w64.abs()).any())
        if further:
            raise AssertionError(f"{what}: kernel further from float64 than the plain "
                                 f"version ({float(e_kern.max()):.3e} vs "
                                 f"{float(e_plain.max()):.3e})")
        err = max(err, dmax)
    return err, int((~ok).sum()), float((got[0][ok] - want64[0][ok]).abs().max()), \
        float((want[0][ok] - want64[0][ok]).abs().max())


def neighbour_planes(world):
    """The 64-neighbour kernel planes of every cell of the benchmark world."""
    from topotpu_torch.io.synthetic import krig_rows_from_world

    C = N_SIDE * N_SIDE
    rows, cols = np.unravel_index(np.arange(C), (N_SIDE, N_SIDE))
    t0 = time.perf_counter()
    rows64 = krig_rows_from_world(world, rows, cols, 64)
    log(f"[kernels] neighbour planes for {C} cells built on the host in "
        f"{time.perf_counter() - t0:.3f} s")
    return rows64


def _indexed_inputs(ti, k, per_month, dev):
    """The indexed entry's arguments for the benchmark tile with both
    variables: (idx, dist, mask, table, cell), from the tile step's own
    functions, with ``_krig_planes``' holes (the last slot of every 7th cell
    masked, cell 3 left with two valid slots). With ``per_month`` station
    7 m + 3 is invalid in month m, so the 12 neighbourhoods differ."""
    import torch

    from topotpu_torch.interp.point import VarFields, tile_neighborhoods, tile_tables

    if per_month:
        valid = ti.stn_valid.clone()
        for m in range(12):
            valid[7 * m + 3, m] = False
        ti = ti._replace(stn_valid=valid)
    pair = _pair(ti, 9.0, 0.85)
    table, cell = tile_tables(ti, (VarFields(ti.stn_norm, ti.stn_vario, ti.stn_anoms), pair.b))
    nbrs = tile_neighborhoods(ti, k, not per_month)
    idx = torch.stack([n.idx for n in nbrs])
    dist = torch.stack([n.dist for n in nbrs])
    mask = torch.stack([n.mask for n in nbrs])
    mask[:, ::7, -1] = False
    mask[:, 3, 2:] = False
    dist = dist * mask
    return idx, dist, mask, table, cell


def _compare_indexed(args, pairs, per_month, k, ill_conditioned=False,
                     weight_kernel="bisquare", k_normal=None, k_anom=None, collinear=False):
    """The indexed entry against its plain version on the arguments ``args``
    (idx, dist, mask, table, cell), the systems on the first ``k_normal``
    slots and the gain rows on the first ``k_anom`` (None: all k), system by
    system, by ``_compare_krig``'s rule at the systems' slot count: the worst
    error, the most not-ok cells of a system, and the normals' distances from
    float64 (kernel, plain)."""
    import torch

    from topotpu_torch.kernels.krig_normals import (
        krig_normals_indexed,
        krig_normals_indexed_ref,
    )

    kw = dict(weight_kernel=weight_kernel, k_normal=k_normal, k_anom=k_anom)
    head, gains = krig_normals_indexed(*args, pairs, not per_month, **kw)
    torch.cuda.synchronize()
    want = krig_normals_indexed_ref(*args, pairs, not per_month, **kw)
    idx, dist, mask, table, cell = args
    want64 = krig_normals_indexed_ref(idx, dist.double(), mask, table.double(), cell.double(),
                                      pairs, not per_month, **kw)
    rows = lambda hg, p, n: torch.cat([hg[0][p].T, hg[1][n].T])  # noqa: E731
    err = n_not_ok = 0
    e64_kern = e64_plain = 0.0
    for p, (m, _) in enumerate(pairs):
        n = m if per_month else 0
        e, bad, ek, ep = _compare_krig(rows((head, gains), p, n), rows(want, p, n),
                                       rows(want64, p, n), k_normal or k, ill_conditioned,
                                       collinear)
        err, n_not_ok = max(err, e), max(n_not_ok, bad)
        e64_kern, e64_plain = max(e64_kern, ek), max(e64_plain, ep)
    return err, n_not_ok, e64_kern, e64_plain


def phase_kernels(world, days, rows64, dev):
    import torch

    from topotpu_torch.io.synthetic import tile_inputs_from_world
    from topotpu_torch.kernels.krig_normals import (
        krig_normals_indexed,
        krig_normals_indexed_ref,
    )
    C = N_SIDE * N_SIDE
    report = {}

    # krig_normals: 24 systems a cell (12 months x 2 variables) in one launch
    cells = np.unravel_index(np.arange(C), (N_SIDE, N_SIDE))
    ti, _ = tile_inputs_from_world(world, days.month_idx, *cells, dev)
    pairs = [(m, v) for m in range(12) for v in range(2)]
    for k, per_month, weight_kernel, k_normal, k_anom in (
            (K, False, "bisquare", None, None), (K, True, "bisquare", None, None),
            (64, False, "bisquare", None, None), (64, True, "bisquare", None, None),
            (K, False, "gaussian", None, None), (K, False, "uniform", None, None),
            (K, True, "bisquare", 24, 16)):
        t = time.perf_counter()
        args = _indexed_inputs(ti, k, per_month, dev)
        kw = dict(weight_kernel=weight_kernel, k_normal=k_normal, k_anom=k_anom)
        # elevation and LST on 24 slots: float64 decides by statistics (see
        # _compare_krig)
        collinear = (k_normal or k) <= 24
        err, n_not_ok, e64_kern, e64_plain = _compare_indexed(
            args, pairs, per_month, k, collinear=collinear, **kw)
        t_cmp = time.perf_counter() - t
        kern = lambda: krig_normals_indexed(*args, pairs, not per_month, **kw)  # noqa: E731
        plain = lambda: krig_normals_indexed_ref(*args, pairs, not per_month, **kw)  # noqa: E731
        ms, plain_ms = cuda_ms(kern, 10), cuda_ms(plain, 1, warmup=0)
        idx, dist, mask, table, cell = args
        N = idx.shape[0]
        nbytes = (idx.numel() * (8 + 4 + 1) + (table.numel() + cell.numel()) * 4
                  + (len(pairs) * C * 8 + N * C * k) * 4)
        bnd = bound(nbytes, C * krig_flops(k, len(pairs), N))
        sizes = (f" k_normal={k_normal} k_anom={k_anom} (float64 decides by mean, 99th and "
                 f"99.9th percentile)" if k_normal else "")
        line = (f"[kernels] krig_normals C={C} S={N_STATIONS} k={k}{sizes} {weight_kernel} "
                f"{'one neighbourhood a month' if per_month else 'shared neighbourhood'}, "
                f"{len(pairs)} systems a cell in 1 launch: max_abs_err {err:.3e} (normal vs "
                f"float64: kernel {e64_kern:.3e}, plain {e64_plain:.3e}; not-ok cells "
                f"{n_not_ok}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
                f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}")
        if (per_month, weight_kernel) == (False, "bisquare"):
            # the same systems one a launch: what sharing the neighbourhood's
            # weights, pair distances and gains in one launch saves
            each = lambda: [krig_normals_indexed(*args, [pr], True) for pr in pairs]  # noqa: E731
            heads = torch.stack([h[0] for h, _ in each()])
            if not torch.equal(torch.nan_to_num(heads), torch.nan_to_num(kern()[0])):
                raise AssertionError("a system's head depends on the launch it is solved in")
            line += (f"; the same systems one a launch, {len(pairs)} launches: "
                     f"{cuda_ms(each, 3, warmup=1):.4f} ms (heads equal bit for bit)")
        log(f"{line} ({t_cmp:.1f} s to compare, {time.perf_counter() - t:.1f} s in all)")
        if (k, per_month, weight_kernel) == (K, False, "bisquare"):
            report["krig_normals"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          library_ms=None, **bnd)
        del args, idx, dist, mask, table, cell
    del ti
    report.update(scatter_lines(rows64, dev))
    report["variogram_fit"] = variogram_line(dev)
    return report


NM_TREND3 = ("elev", "tdi", "lst6")  # July's LST: the month whose normals are kriged
NM_LST5 = ("elev", "tdi", "lst0", "lst1", "lst2", "lst3", "lst4")  # five months share elevation
NM_CASES = (  # k, trend covariates, anomaly covariates, weight kernel
    (32, NM_TREND3, ("elev", "tdi"), "bisquare"),
    (64, NM_TREND3, ("elev", "tdi"), "bisquare"),
    (32, NM_LST5, ("elev",), "bisquare"),
    (32, NM_TREND3, ("elev", "tdi"), "gaussian"),
    (32, NM_TREND3, ("elev", "tdi"), "uniform"),
)


def phase_normals(world, days, dev):
    """``[normals]``: ``interp/normals.py``'s ``krig_normals_and_gains`` and
    ``krig_normals`` (callers' own covariates on gathered neighbourhoods,
    through the gathered entry of ``csrc/krig_normals.cu``) on the tile
    step's 65,536 cells, July's normals of variable 0, with ``_krig_planes``'
    holes. The 64 nearest stations' table rows are gathered once; each case
    takes its k-prefix and its covariates (``NM_CASES``). The trend on five
    LST months is compared with ``collinear``: its float32 normal equations
    part any two implementations by up to ~1e-2 C. Per case: both
    functions with the launch counters from 0 (one gathered launch each, no
    indexed one, the same heads), then the wrapper against its plain version
    by ``_compare_krig``'s rule with a float64 plain run as arbiter, the
    kernel's and the plain version's times, the bound and the July MAE
    against the world's truth. Returns the kernels-line report and the
    main-path launches."""
    import torch

    from topotpu_torch.interp import normals
    from topotpu_torch.interp.point import VarFields, tile_neighborhoods, tile_tables
    from topotpu_torch.io.synthetic import tile_inputs_from_world
    from topotpu_torch.kernels import krig_normals as kn

    t_all = time.perf_counter()
    C, m = N_SIDE * N_SIDE, 6
    rows, cols = np.unravel_index(np.arange(C), (N_SIDE, N_SIDE))
    ti, _ = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    table, cell = tile_tables(ti, (VarFields(ti.stn_norm, ti.stn_vario, ti.stn_anoms),))
    nbr = tile_neighborhoods(ti, 64, True)[0]
    G = table[nbr.idx.long()]  # (C, 64, F): every station column, gathered once
    tcol = dict(elev=0, tdi=1, x=2, y=3, **{f"lst{i}": 7 + i for i in range(12)})
    ccol = dict(elev=0, tdi=1, x=2, y=3, **{f"lst{i}": 4 + i for i in range(12)})
    lon, lat = world.grid.cell_lonlat(rows, cols)
    truth = torch.from_numpy(world.true_normal(
        lon, lat, world.elev[rows, cols], world.tdi[rows, cols], world.lst[m, rows, cols],
        m + 1)).to(dev)
    base = kn.TABLE_BASE
    report, launched = {}, 0
    for k, cov, acov, weight_kernel in NM_CASES:
        t = time.perf_counter()
        Gk = G[:, :k]
        mask = nbr.mask[:, :k].clone()
        mask[::7, -1] = False
        mask[3, 2:] = False
        operands = tuple(x.contiguous() for x in (
            nbr.dist[:, :k] * mask, mask, Gk[..., 4:7], Gk[..., [tcol[c] for c in cov]],
            cell[:, [ccol[c] for c in cov]], Gk[..., base + m],
            Gk[..., base + 12 + 3 * m: base + 15 + 3 * m], Gk[..., [tcol[c] for c in acov]],
            cell[:, [ccol[c] for c in acov]]))
        kw = dict(weight_kernel=weight_kernel)

        kn.krig_normals_gathered.launches = kn.krig_normals_indexed.launches = 0
        res, gains = normals.krig_normals_and_gains(*operands, **kw)
        alone = normals.krig_normals(*operands[:7], **kw)
        torch.cuda.synchronize()
        n = (kn.krig_normals_gathered.launches, kn.krig_normals_indexed.launches)
        if n != (2, 0):
            raise RuntimeError(f"[normals] launched gathered / indexed {n}, expected (2, 0)")
        launched += n[0]
        same = lambda a, b: torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))  # noqa: E731
        if not all(same(getattr(alone, f), getattr(res, f)) for f in res._fields):
            raise AssertionError("[normals] krig_normals and krig_normals_and_gains differ")

        head, g = kn.krig_normals_gathered(*operands, **kw)
        want = kn.krig_normals_gathered_ref(*operands, **kw)
        want64 = kn.krig_normals_gathered_ref(
            *(x.double() if x.is_floating_point() else x for x in operands), **kw)
        if not (same(head[:, 0], res.normal) and same(g, gains)):
            raise AssertionError("[normals] the API's result is not the kernel's")
        rows_of = lambda h, gg: torch.cat([h.T, gg.T])  # noqa: E731
        err, n_not_ok, e64_kern, e64_plain = _compare_krig(
            rows_of(head, g), rows_of(*want), rows_of(*want64), k, collinear=cov == NM_LST5)
        t_cmp = time.perf_counter() - t
        ms = cuda_ms(lambda: kn.krig_normals_gathered(*operands, **kw), 10)
        plain_ms = cuda_ms(lambda: kn.krig_normals_gathered_ref(*operands, **kw), 1, warmup=0)
        q, qa = len(cov), len(acov)
        nbytes = sum(x.numel() * x.element_size() for x in operands) + C * (8 + k) * 4
        bnd = bound(nbytes, C * krig_flops(k, 1, 1, q, qa, q_fixed=q))
        mae = float((res.normal - truth)[res.ok].abs().mean())
        if cov == NM_TREND3 and mae > 0.3:
            raise RuntimeError(f"[normals] July normals MAE vs truth {mae:.4f} C > 0.3 C")
        log(f"[normals] krig_normals_and_gains C={C} k={k} q={q} ({','.join(cov)}) qa={qa} "
            f"({','.join(acov)}) {weight_kernel}: launches {n[0]} (gathered; indexed {n[1]}); "
            f"kernel vs plain max_abs_err {err:.3e} (normal vs float64: kernel "
            f"{e64_kern:.3e}, plain {e64_plain:.3e}; not-ok cells {n_not_ok}); July MAE vs "
            f"truth {mae:.4f} C; kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} ({t_cmp:.1f} s to compare, "
            f"{time.perf_counter() - t:.1f} s in all)")
        if (k, cov, weight_kernel) == (K, NM_TREND3, "bisquare"):
            report["krig_normals_gathered"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                                   library_ms=None, **bnd)
        del operands, head, g, want, want64, res, gains, alone
    log(f"[normals] {len(NM_CASES)} cases in {time.perf_counter() - t_all:.1f} s")
    return report, dict(krig_normals_gathered=launched)


def scatter_lines(rows64, dev):
    """The daily contraction's two entries against their plain versions at
    the tile step's shapes; the report of each at the main path's shape."""
    import torch

    from topotpu_torch.kernels.scatter_daily import scatter_daily, scatter_daily_ref

    C = N_SIDE * N_SIDE
    report = {}
    rng = np.random.default_rng(1)
    idx = np.ascontiguousarray(rows64["idx"][:, :K])  # (C, k) int64, as select_neighbors' topk
    idx[::3, 1] = idx[::3, 0]  # duplicate indices accumulate
    for D in (744, 2976):
        t = time.perf_counter()
        args = [
            torch.from_numpy(idx).to(dev),
            torch.from_numpy(rng.normal(size=(C, K)).astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(size=(C, K)) > 0.05).to(dev),
            torch.from_numpy(rng.normal(size=(N_STATIONS, D)).astype(np.float32)).to(dev),
        ]
        kern = lambda: scatter_daily(*args)  # noqa: E731
        plain = lambda: scatter_daily_ref(*args)  # noqa: E731

        def library():  # a dense (C, S) gain matrix, then one full-fp32 product
            i, g, m, y = args
            G = torch.zeros((C, N_STATIONS), dtype=g.dtype, device=dev)
            return G.scatter_add_(1, i.long(), g * m) @ y

        # compared on the card: at D = 2,976 each (C, D) array is 780 MB
        got, want = kern(), plain()
        for what, a, tol in (("scatter_daily", got, 1e-5), ("scatter_add_ + matmul", library(),
                                                            1e-4)):
            if not bool(torch.isclose(a, want, rtol=tol, atol=tol, equal_nan=True).all()):
                raise AssertionError(f"{what} D={D}: outside rtol = atol = {tol:.0e}")
        err = float((got - want).abs().max())
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3, warmup=1)
        library_ms = cuda_ms(library, 5, warmup=1)
        nbytes = sum(a.numel() * a.element_size() for a in args) + C * D * 4
        bnd = bound(nbytes, 2.0 * K * C * D)
        log(f"[kernels] scatter_daily C={C} S={N_STATIONS} k={K} D={D}: max_abs_err "
            f"{err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
            f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; scatter_add_ + matmul (two "
            f"library calls, full fp32) {library_ms:.4f} ms "
            f"(output write {C * D * 4 / ms / 1e6:.1f} GB/s) ({time.perf_counter() - t:.1f} s)")
        if D == 744:
            report["scatter_daily"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                           library_ms=library_ms, **bnd)
        del args, got, want
    report["scatter_daily_packed"] = _packed_lines(rows64["idx"], dev)
    return report


def _packed_by_parts(idx, mask, gains, Y, normal, ok, slot_of_day, scales, reconcile):
    """The packed entry's daily rows the way the step made them before the
    entry existed: the float entry over the variables' concatenated day axes
    (one call with one neighbourhood, one a month with twelve, one more set
    with per-variable gains), then the packing in plain torch. Returns the
    (V, ndays, C) int16 rows."""
    import torch

    from topotpu_torch.kernels.scatter_daily import quantize_plane_fixed, scatter_daily

    G, N, C, _ = gains.shape
    V, S, D = Y.shape
    dpm = D // 12
    anoms = [None] * V
    for g in range(G):
        vs = list(range(V)) if G == 1 else [g]
        if N == 1:
            Yc = torch.cat([Y[v] for v in vs], dim=1)
            out = scatter_daily(idx[0], gains[g, 0], mask[0], Yc)
            out = out.view(C, len(vs), 12, dpm).permute(1, 2, 0, 3)
        else:
            out = torch.stack([
                scatter_daily(idx[m], gains[g, m], mask[m],
                              torch.cat([Y[v, :, m * dpm:(m + 1) * dpm] for v in vs], dim=1)
                              ).view(C, len(vs), dpm)
                for m in range(12)]).permute(2, 0, 1, 3)
        for j, v in enumerate(vs):
            anoms[v] = out[j]
    daily = [normal[v][:, :, None] + anoms[v] for v in range(V)]
    if reconcile:
        bad = (ok[0] & ok[1])[:, :, None] & (daily[1] < daily[0])
        mid = 0.5 * (daily[0] + daily[1])
        daily = [torch.where(bad, mid, d) for d in daily]
    slot = slot_of_day.long()
    return torch.stack([
        quantize_plane_fixed(daily[v], ok[v][:, :, None], scales[v, 0], scales[v, 1])
        .permute(0, 2, 1).reshape(D, C)[slot] for v in range(V)])


def _packed_lines(idx64, dev):
    """``scatter_daily_packed`` against its plain version at the tile step's
    shapes: both variables on one lattice, the reconcile on, neighbourhoods
    from the benchmark world (month m's are slots m .. m + k - 1 of each
    cell's 64 nearest, so the twelve differ and stay local), duplicate and
    stray indices, masked slots, 3 % of the cells not ok in a month, var B's
    normals 0.2 C above var A's so that the dailies cross on part of the
    days. The integer rule: sentinel positions identical, at most one int16
    count apart, under 1 % of the counts differing, and no cell with both ok
    and q_1 < q_0. Returns the report of the main path's shape (365 days, one
    neighbourhood, shared gains)."""
    import torch

    from topotpu_torch.core.config import TopoConfig
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.interp.convert import fixed_scales_from_config
    from topotpu_torch.interp.point import month_layout
    from topotpu_torch.kernels.scatter_daily import scatter_daily_packed, scatter_daily_packed_ref

    C, V = idx64.shape[0], 2
    fs = fixed_scales_from_config(TopoConfig(), V).reshape(V, 6)
    scales = torch.from_numpy(np.ascontiguousarray(fs[:, :2])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    normal_ = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    chance = lambda p, *shape: torch.rand(shape, generator=gen, device=dev) > p  # noqa: E731
    report = None
    for end in ("2015-12-31", "2018-12-31"):
        layout = month_layout(get_days_metadata("2015-01-01", end))
        dpm, ndays = layout.dpm, len(layout.slot_of_day)
        slot = torch.from_numpy(layout.slot_of_day.astype(np.int32)).to(dev)
        Y = normal_(V, N_STATIONS, 12 * dpm) * 3.0
        for N in (1, 12):
            idx = np.stack([idx64[:, (np.arange(K) + m) % 64] for m in range(N)])
            idx[:, ::3, 1] = idx[:, ::3, 0]
            idx[:, 5::11, 2] = -1
            idx[:, 7::13, K - 1] = N_STATIONS + 7
            idx = torch.from_numpy(np.ascontiguousarray(idx)).to(dev)
            mask = chance(0.05, N, C, K)
            normal = normal_(1, 12, C) * 5.0 + 10.0
            normal = torch.cat([normal, normal + 0.2])
            ok = chance(0.03, V, 12, C)
            for G in (1, 2):
                t = time.perf_counter()
                gains = normal_(G, N, C, K) * 0.1
                args = (idx, mask, gains, Y, normal, ok, slot, scales)
                got = torch.full((V * (ndays + 24), C), 12345, dtype=torch.int16, device=dev)
                want = got.clone()
                kern = lambda: scatter_daily_packed(*args, got, reconcile=True)  # noqa: E731
                plain = lambda: scatter_daily_packed_ref(*args, want, reconcile=True)  # noqa: E731
                parts = lambda: _packed_by_parts(*args, True)  # noqa: E731
                kern(), plain()
                torch.cuda.synchronize()
                g = got.view(V, ndays + 24, C).int()
                w = want.view(V, ndays + 24, C).int()
                if not bool((g[:, ndays:] == 12345).all()):
                    raise AssertionError("scatter_daily_packed wrote outside the daily rows")
                g, w = g[:, :ndays], w[:, :ndays]
                if not torch.equal(g == -32768, w == -32768):
                    raise AssertionError("scatter_daily_packed: sentinel positions differ")
                d = (g - w).abs()
                err, share = int(d.max()), float((d > 0).float().mean())
                both = (g[0] != -32768) & (g[1] != -32768)
                viol = int((both & (g[1] < g[0])).sum())
                n_same = int((both & (g[1] == g[0])).sum())
                if err > 1 or share >= 0.01 or viol or n_same == 0:
                    raise AssertionError(
                        f"scatter_daily_packed ndays={ndays} N={N} G={G}: max count difference "
                        f"{err}, share differing {share:.5f}, {viol} cells with q_1 < q_0, "
                        f"{n_same} reconciled")
                p = parts().int()
                if not (torch.equal(p == -32768, w == -32768) and int((p - w).abs().max()) <= 1):
                    raise AssertionError("the float entry + plain packing disagrees")
                del g, w, d, both, p
                ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 1, warmup=0)
                parts_ms = cuda_ms(parts, 2, warmup=0)
                nbytes = (sum(a.numel() * a.element_size() for a in args)
                          + V * ndays * C * 2)
                bnd = bound(nbytes, 2.0 * K * C * V * 12 * dpm)
                log(f"[kernels] scatter_daily_packed C={C} S={N_STATIONS} k={K} V={V} "
                    f"ndays={ndays} dpm={dpm} N={N} G={G} reconcile on: max count difference "
                    f"{err}, share of counts differing {share:.6f}, sentinels identical "
                    f"({float((~ok).float().mean()):.4f} not ok), {n_same} reconciled pairs, "
                    f"0 with q_1 < q_0; kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
                    f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; the float entry + plain "
                    f"torch packing {parts_ms:.4f} ms "
                    f"(int16 write {V * ndays * C * 2 / ms / 1e6:.1f} GB/s) "
                    f"({time.perf_counter() - t:.1f} s)")
                if (ndays, N, G) == (NDAYS, 1, 1):
                    report = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                                  library_ms=None, **bnd)
                del args, gains, got, want
            del idx, mask, normal, ok
        del Y
    return report


def _ok_inputs(rows64, k, dev, seed=3):
    """Fused OK-solve inputs at k from the benchmark planes: (k, k, B) pair
    distances, (3k, B) xyz rows, (k, B) point distances and mask (with
    ``_krig_planes``' holes), per-cell nugget, psill and range."""
    import torch

    from topotpu_torch.geo.distance import pairwise_km_from_xyz

    xyz3k, dist_t, mask_t = _krig_planes(rows64, k, dev)
    B = dist_t.shape[1]
    xyz = xyz3k.reshape(3, k, B).permute(2, 1, 0)
    dp = pairwise_km_from_xyz(xyz, xyz).permute(1, 2, 0).contiguous()
    rng = np.random.default_rng(seed)
    par = [torch.from_numpy(rng.uniform(lo, hi, B).astype(np.float32)).to(dev)
           for lo, hi in ((0.01, 0.1), (0.5, 2.0), (30.0, 150.0))]
    return dp, xyz3k, dist_t, mask_t, par


def _compare_ok(got, want, mask_t, k):
    """Kernel vs its plain version with ``tests/test_pallas_krig.py``'s
    tolerances on every value: weights rtol 2e-4, atol 2e-5 (5e-5 above
    k = 32), variances rtol 2e-3, atol 1e-4; ok flags identical and masked
    weights exactly 0."""
    got, want = ([t.cpu().numpy() for t in r] for r in (got, want))
    np.testing.assert_array_equal(got[2], want[2], err_msg="ok flags")
    if np.any(got[0][mask_t.cpu().numpy() < 0.5] != 0.0):
        raise AssertionError("a masked slot has a non-zero weight")
    err = 0.0
    for i, rtol, atol, what in ((0, 2e-4, 5e-5 if k > 32 else 2e-5, "weights"),
                                (1, 2e-3, 1e-4, "variance")):
        np.testing.assert_allclose(got[i], want[i], rtol=rtol, atol=atol, err_msg=what)
        err = max(err, float(np.abs(got[i].astype(np.float64) - want[i]).max()))
    return err, int((~want[2].astype(bool)).sum())


def _library_ok(dp, dist_t, mask_t, par):
    """The library route to the OK solve's factorisation and solves: the
    (B, k, k) covariance and the two right-hand sides assembled by the plain
    version (``cholesky.assemble_exp_cov``) outside the timed window, then
    ``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve`` inside it. The
    port never calls it; it times the factorisation and solves only."""
    import torch

    from topotpu_torch.kernels.cholesky import assemble_exp_cov

    mask = mask_t.T > 0.5
    C, c0, _ = assemble_exp_cov(dp.permute(2, 0, 1), dist_t.T, *par, mask, jitter_frac=1e-5)
    rhs = torch.stack([c0, mask.to(C.dtype)], dim=-1).contiguous()

    def library():
        L, _ = torch.linalg.cholesky_ex(C)
        return torch.cholesky_solve(rhs, L)

    if not bool(torch.isfinite(library()).all()):
        raise RuntimeError("the library route gave non-finite solutions")
    return library


def phase_ok_solve(rows64, dev):
    """The fused OK solve, both entries, at its own API (no path of the
    system calls it): one call of each at k = 32 with the counters from 0,
    then kernel vs plain version at k = 32 and 64, each beside the library
    route (``_library_ok``, one timing a k for both entries: the same
    matrices)."""
    import torch

    from topotpu_torch.kernels.ok_solve_fused import (
        ok_solve_fused,
        ok_solve_fused_ref,
        ok_solve_fused_xyz,
        ok_solve_fused_xyz_ref,
    )

    entries = dict(ok_solve_fused=(ok_solve_fused, ok_solve_fused_ref, 0),
                   ok_solve_fused_xyz=(ok_solve_fused_xyz, ok_solve_fused_xyz_ref, 1))
    report, launches = {}, {}
    for k in (K, 64):
        dp, xyz3k, dist_t, mask_t, par = _ok_inputs(rows64, k, dev)
        if k == K:
            ok_solve_fused.launches = ok_solve_fused_xyz.launches = 0
            ok_solve_fused(dp, dist_t, mask_t, *par)
            ok_solve_fused_xyz(xyz3k, dist_t, mask_t, *par)
            torch.cuda.synchronize()
            launches = dict(ok_solve_fused=ok_solve_fused.launches,
                            ok_solve_fused_xyz=ok_solve_fused_xyz.launches)
            if launches != dict(ok_solve_fused=1, ok_solve_fused_xyz=1):
                raise RuntimeError(f"the OK-solve API did not launch its kernels: {launches}")
        library_ms = cuda_ms(_library_ok(dp, dist_t, mask_t, par), 5, warmup=1)
        for name, (kern_fn, plain_fn, xyz) in entries.items():
            t = time.perf_counter()
            args = ((xyz3k if xyz else dp), dist_t, mask_t, *par)
            kern = lambda: kern_fn(*args)  # noqa: E731
            plain = lambda: plain_fn(*args)  # noqa: E731
            err, n_not_ok = _compare_ok(kern(), plain(), mask_t, k)
            ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 3, warmup=1)
            B = dist_t.shape[1]
            # the pair entry reads the diagonal and lower triangle only, as the
            # JAX kernel does up to k = 32 (above, it reads rows of the whole
            # matrix): tests/test_torch_ok_solve.py::test_ok_solve_pair_reads_lower_triangle
            first = xyz3k.numel() if xyz else (k * (k + 1) // 2 if k <= 32 else k * k) * B
            bnd = bound((first + sum(a.numel() for a in args[1:]) + (k + 1) * B) * 4 + B,
                        B * solve_flops(k, xyz=bool(xyz)))
            log(f"[ok_solve] {name} B={B} k={k}: max_abs_err {err:.3e} "
                f"(not-ok cells {n_not_ok}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; cholesky_ex + "
                f"cholesky_solve {library_ms:.4f} ms ({time.perf_counter() - t:.1f} s)")
            if k == K:
                report[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    library_ms=library_ms, **bnd)
        del dp
    return report, launches


def _pair(ti, norm_add, anom_mul):
    from topotpu_torch.interp.point import PairTileInputs, VarFields

    return PairTileInputs(
        geom=ti,
        b=VarFields(norm=ti.stn_norm + norm_add, vario=ti.stn_vario,
                    anoms=ti.stn_anoms * anom_mul),
    )


def _decode(buf, scales, v):
    """Var v's (daily, normal, se) planes from the flat int16 buffer, float64
    with NaN at sentinels."""
    o = v * (NDAYS + 24)
    sc = scales[6 * v : 6 * v + 6]
    dec = lambda q, s, off: np.where(q == -32768, np.nan, q * float(s) + float(off))  # noqa: E731
    return (dec(buf[o : o + NDAYS], sc[0], sc[1]),
            dec(buf[o + NDAYS : o + NDAYS + 12], sc[2], sc[3]),
            dec(buf[o + NDAYS + 12 : o + NDAYS + 24], sc[4], sc[5]))


def _oracle_check(world, days, rows, cols, picks, daily, normal, se, day_ok=None):
    """Hold decoded var-A values at the cells ``picks`` against the float64
    oracle, in batches until ORACLE_CELLS cells or ORACLE_BUDGET_S seconds."""
    from topotpu_torch.oracle.pipeline import interp_tile_oracle

    vario = np.tile(np.asarray(world.true_vario, np.float64), (world.n_stations, 12, 1))
    t0 = time.perf_counter()
    done = []
    errs = dict(normal=0.0, se=0.0, daily=0.0)
    for b0 in range(0, len(picks), 16):
        if time.perf_counter() - t0 > ORACLE_BUDGET_S:
            break
        sel = picks[b0 : b0 + 16]
        want = interp_tile_oracle(world, list(zip(rows[sel], cols[sel])), K, vario,
                                  days.month_idx)
        np.testing.assert_allclose(normal[:, sel], want["normal"], rtol=1e-4,
                                   atol=2e-2 + HALF_STEP_C, err_msg="normals vs oracle")
        np.testing.assert_allclose(se[:, sel], want["se"], rtol=2e-2,
                                   atol=2e-2 + HALF_STEP_C, err_msg="se vs oracle")
        got_d = daily[:, sel].T
        keep = np.ones_like(got_d, bool) if day_ok is None else day_ok[:, sel].T
        np.testing.assert_allclose(got_d[keep], want["daily"][keep], rtol=1e-3,
                                   atol=5e-2 + HALF_STEP_C, err_msg="dailies vs oracle")
        errs["normal"] = max(errs["normal"], float(np.abs(normal[:, sel] - want["normal"]).max()))
        errs["se"] = max(errs["se"], float(np.abs(se[:, sel] - want["se"]).max()))
        errs["daily"] = max(errs["daily"], float(np.abs(got_d[keep] - want["daily"][keep]).max()))
        done += list(sel)
    return len(done), errs, time.perf_counter() - t0


def _tile_kernels():
    from topotpu_torch.kernels.krig_normals import krig_normals_indexed
    from topotpu_torch.kernels.scatter_daily import scatter_daily, scatter_daily_packed

    return dict(krig_normals=krig_normals_indexed, scatter_daily=scatter_daily,
                scatter_daily_packed=scatter_daily_packed)


def _zero_launches():
    for wrapper in _tile_kernels().values():
        wrapper.launches = 0


def _read_launches():
    return {name: wrapper.launches for name, wrapper in _tile_kernels().items()}


def phase_slice(world, days, dev):
    import torch

    from topotpu_torch.core.config import InterpParams, TopoConfig
    from topotpu_torch.interp.convert import fixed_scales_from_config
    from topotpu_torch.interp.point import interp_tile_pair_flat
    from topotpu_torch.io.synthetic import tile_inputs_from_world
    C = N_SIDE * N_SIDE
    rows, cols = np.unravel_index(np.arange(C), (N_SIDE, N_SIDE))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    pair = _pair(ti, 9.0, 0.85)
    params = InterpParams(k_neighbors=K)
    fixed = fixed_scales_from_config(TopoConfig(), 2)
    step = lambda: interp_tile_pair_flat(  # noqa: E731
        pair, layout.slot_of_day, params, shared_validity=True,
        fixed_scales=fixed, reconcile=True,
    )

    _zero_launches()
    out = step()
    torch.cuda.synchronize()
    launches = _read_launches()
    # one launch covers the step's 24 systems, one the whole daily product
    if launches != dict(krig_normals=1, scatter_daily=0, scatter_daily_packed=1):
        raise RuntimeError(f"main path did not run through the kernels: {launches}")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    buf = out.buf.cpu().numpy()
    assert buf.shape == (2 * (NDAYS + 24), C) and buf.dtype == np.int16
    np.testing.assert_array_equal(out.scales.cpu().numpy(), fixed)
    daily, normal, se = _decode(buf, fixed, 0)
    daily_b, normal_b, _ = _decode(buf, fixed, 1)
    for a in (daily, normal, se, daily_b, normal_b):
        assert np.isfinite(a).all(), "a land cell came out not ok"

    lon, lat = world.grid.cell_lonlat(rows, cols)
    truth = world.true_normal(lon, lat, world.elev[rows, cols], world.tdi[rows, cols],
                              world.lst[6, rows, cols], 7)
    mae = float(np.mean(np.abs(normal[6] - truth)))
    if mae > 0.3:
        raise RuntimeError(f"July normals MAE vs truth {mae:.4f} C > 0.3 C")

    picks = np.random.default_rng(5).choice(C, ORACLE_CELLS, replace=False)
    n, errs, secs = _oracle_check(world, days, rows, cols, picks, daily, normal, se)
    log(f"[slice] interp_tile_pair_flat C={C} S={N_STATIONS} k={K} days={NDAYS} vars=2: "
        f"launches {launches}; step wall {' '.join(f'{w * 1e3:.3f}' for w in walls)} ms "
        f"(after warm-up); {2 * C / min(walls):.1f} var-cells/s; July normals MAE vs "
        f"truth {mae:.4f} C; oracle on {n} cells ({secs:.1f} s): max err normal "
        f"{errs['normal']:.3e} se {errs['se']:.3e} daily {errs['daily']:.3e} C")
    return launches, step


def phase_per_var(world, days, dev):
    """The paired step with per-variable neighbourhood sizes (what the nnghs
    optimisation hands to production) on one 128 x 128 tile: each distinct
    (k, ka) pair takes a launch of ``krig_normals`` of its own (here one a
    variable), whose systems read the slots below that k and whose gain rows
    those below that ka, and one ``scatter_daily_packed`` launch reads each
    variable's own gain rows. Var A keeps k = ka = 32 and is held against the
    float64 oracle; var B runs at k = 24, ka = 16."""
    import torch

    from topotpu_torch.core.config import InterpParams, TopoConfig
    from topotpu_torch.interp.convert import fixed_scales_from_config
    from topotpu_torch.interp.point import interp_tile_pair_flat
    from topotpu_torch.io.synthetic import tile_inputs_from_world

    tile = TopoConfig().tile_rows
    rows, cols = np.unravel_index(np.arange(tile * tile), (tile, tile))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    params = InterpParams(k_neighbors=K, k_per_var=(K, 24), ka_per_var=(K, 16))
    fixed = fixed_scales_from_config(TopoConfig(), 2)
    _zero_launches()
    t0 = time.perf_counter()
    out = interp_tile_pair_flat(_pair(ti, 9.0, 0.85), layout.slot_of_day, params,
                                shared_validity=True, fixed_scales=fixed, reconcile=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    # krig_normals once a (k, ka) pair; one packed launch reads both variables' gain rows
    if launches != dict(krig_normals=2, scatter_daily=0, scatter_daily_packed=1):
        raise RuntimeError(f"per-variable step: launches {launches}")
    buf = out.buf.cpu().numpy()
    daily, normal, se = _decode(buf, fixed, 0)
    daily_b, normal_b, se_b = _decode(buf, fixed, 1)
    for a in (daily, normal, se, daily_b, normal_b, se_b):
        assert np.isfinite(a).all(), "a land cell came out not ok"
    picks = np.random.default_rng(7).choice(tile * tile, 32, replace=False)
    n, errs, _ = _oracle_check(world, days, rows, cols, picks, daily, normal, se)
    log(f"[per-var] {tile}x{tile} tile, k_per_var=({K}, 24) ka_per_var=({K}, 16): launches "
        f"{launches}; first-call wall {wall * 1e3:.3f} ms; var A vs the oracle on {n} cells: "
        f"max err normal {errs['normal']:.3e} se {errs['se']:.3e} daily {errs['daily']:.3e} C; "
        f"var B normals differ from var A's + 9 C by up to "
        f"{float(np.abs(normal_b - normal - 9.0).max()):.3e} C")
    return launches


def phase_reconcile(world, days, dev):
    import torch

    from topotpu_torch.core.config import InterpParams, TopoConfig
    from topotpu_torch.interp.convert import fixed_scales_from_config
    from topotpu_torch.interp.point import interp_tile_pair, interp_tile_pair_flat, ungroup_days
    from topotpu_torch.io.synthetic import tile_inputs_from_world

    tile = TopoConfig().tile_rows
    rows, cols = np.unravel_index(np.arange(tile * tile), (tile, tile))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    pair = _pair(ti, 0.2, 0.5)
    params = InterpParams(k_neighbors=K)
    fixed = fixed_scales_from_config(TopoConfig(), 2)

    _zero_launches()
    res_a, res_b = interp_tile_pair(pair, params, shared_validity=True)
    launches = _read_launches()
    # the float step: one launch of the float entry over both variables' days
    if launches != dict(krig_normals=1, scatter_daily=1, scatter_daily_packed=0):
        raise RuntimeError(f"float paired step: launches {launches}")
    both = (res_a.ok & res_b.ok)[:, :, None]
    cross = (both & (res_b.daily < res_a.daily)).cpu().numpy()  # (12, C, dpm)
    n_cross = int(cross.sum())
    out = interp_tile_pair_flat(pair, layout.slot_of_day, params, shared_validity=True,
                                fixed_scales=fixed, reconcile=True)
    buf = out.buf.cpu().numpy().astype(np.int32)
    torch.cuda.synchronize()
    raw_a, raw_b = buf[:NDAYS], buf[NDAYS + 24 : 2 * NDAYS + 24]
    ok_both = (raw_a != -32768) & (raw_b != -32768)
    viol = int((ok_both & (raw_b < raw_a)).sum())
    if n_cross == 0:
        raise RuntimeError("the reconcile case produced no crossings")
    if viol:
        raise RuntimeError(f"{viol} cells with tmax < tmin on the lattice after reconcile")

    daily, normal, se = _decode(out.buf.cpu().numpy(), fixed, 0)
    day_ok = ~ungroup_days(cross.transpose(1, 0, 2), layout).T  # (ndays, C)
    picks = np.random.default_rng(6).choice(tile * tile, 64, replace=False)
    n, errs, _ = _oracle_check(world, days, rows, cols, picks, daily, normal, se, day_ok)
    log(f"[reconcile] {tile}x{tile} tile, var B = A + 0.2 C, anomalies x 0.5: "
        f"float step launches {launches}; "
        f"{n_cross} crossings before reconcile, {viol} lattice violations after; "
        f"oracle on {n} cells (uncrossed days): max err normal {errs['normal']:.3e} "
        f"daily {errs['daily']:.3e} C")
    return launches


def phase_f64(world, days, dev):
    """The float64 validation mode (``interp/f64check.py::compare_f32_f64``,
    what the CLI's validate-f64 step calls) on one ``F64_SIDE`` x
    ``F64_SIDE`` tile of the benchmark world, one variable, k = 32, with the
    month layout's real-day mask: the float32 tile step on the card (one
    ``krig_normals`` launch and one launch of ``scatter_daily``'s float entry)
    against the same step in float64 on the host's CPU, held to BASELINE's
    0.05 C RMSE bar on normals and dailies. The validate-f64 step hands it a
    128 x 128 production tile; a quarter of that keeps the host's float64
    side, which varies by 3x with the host's load, inside the script's
    budget."""
    from topotpu_torch.core.config import InterpParams
    from topotpu_torch.interp import f64check
    from topotpu_torch.io.synthetic import tile_inputs_from_world

    tile = F64_SIDE
    C = tile * tile
    rows, cols = np.unravel_index(np.arange(C), (tile, tile))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    _zero_launches()
    with _StageWalls(f64check, ("run_tile_f64",)) as walls:
        t = time.perf_counter()
        r = f64check.compare_f32_f64(ti, InterpParams(k_neighbors=K),
                                     day_valid=layout.day_valid, device=dev)
        wall = time.perf_counter() - t
    launches = _read_launches()
    stats = " ".join(f"{key} RMSE {r[key]['rmse']:.3e} max {r[key]['max']:.3e}"
                     for key in ("normal", "se", "daily"))
    log(f"[f64] compare_f32_f64 on a {tile}x{tile} tile, S={N_STATIONS} k={K} days={NDAYS}, "
        f"one variable: {stats} C; ok_flip_rate {r['ok_flip_rate']:.6f}, n_compared "
        f"{r['n_compared']}; float32 on the card {wall - walls['run_tile_f64']:.3f} s, float64 "
        f"on the host {walls['run_tile_f64']:.3f} s; float32 launches {launches}")
    if launches != dict(krig_normals=1, scatter_daily=1, scatter_daily_packed=0):
        raise RuntimeError(f"the float32 side launched {launches}")
    if not (r["normal"]["rmse"] < 0.05 and r["daily"]["rmse"] < 0.05):
        raise RuntimeError("float32 vs float64: outside the 0.05 C parity bar")
    if r["n_compared"] < 0.99 * 12 * C:
        raise RuntimeError(f"only {r['n_compared']} cell-months compared")
    return launches


def profile_breakdown(tag, what, fn):
    """Run ``fn`` once under ``torch.profiler`` and log its wall, the device
    kernel time (busy share = device time / wall), the port kernels' share
    and the top kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (the aten ops that launched them would count
    # the same time twice); self device time in us
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    if not events:
        log(f"[{tag}] the profiler recorded no device time")
        return []
    total = sum(dev_us(e) for e in events)
    ours = sum(dev_us(e) for e in events if any(k in e.key for k in KERNELS))
    top = sorted(events, key=lambda e: -dev_us(e))[:8]
    parts = "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in top)
    log(f"[{tag}] {what} under the profiler: wall {wall_us / 1e3:.3f} ms, device "
        f"kernels {total / 1e3:.3f} ms ({len(events)} kinds; busy share "
        f"{total / wall_us:.3f}), of which the port kernels {ours / 1e3:.3f} ms; "
        f"top: {parts} (traced and read in {time.perf_counter() - t_all:.1f} s)")
    return [(e.key, dev_us(e) / 1e3, e.count) for e in events]


def phase_profile(step):
    import torch

    step()
    torch.cuda.synchronize()
    events = profile_breakdown("profile", "one step", step)
    if not events:
        return
    pick = lambda word: [(ms, n) for key, ms, n in events if word in key]  # noqa: E731
    krig, packed, floats = (pick(w) for w in ("krig_normals", "scatter_daily_packed_kernel",
                                              "scatter_daily_kernel"))
    cats = pick("CatArrayBatchedCopy")
    copies = [c for c in pick("copy") if c not in cats]
    elementwise = [e for e in pick("elementwise") if e not in copies]
    total = lambda sel: (sum(ms for ms, _ in sel), sum(n for _, n in sel))  # noqa: E731
    log("[profile] by kind: krig_normals %.3f ms in %d launches; scatter_daily_packed %.3f ms "
        "in %d; the float entry scatter_daily %.3f ms in %d; copy kernels %.3f ms in %d; cat "
        "%.3f ms in %d; elementwise kernels %.3f ms in %d; all kernels %.3f ms in %d launches"
        % (*total(krig), *total(packed), *total(floats), *total(copies), *total(cats),
           *total(elementwise), *total([(ms, n) for _, ms, n in events])))
    counts = (total(krig)[1], total(packed)[1], total(floats)[1])
    if counts != (1, 1, 0):
        raise RuntimeError(f"the step launched krig_normals, the packed and the float daily "
                           f"kernel {counts} times, not (1, 1, 0)")


class MemoryMosaic:
    """``topotpu_torch.io.ncdf.MosaicWriter``'s interface on numpy arrays (the
    machine with the card has no h5py). Mosaics stay in ``STORE`` by path for
    the life of the process, so a second engine on the same paths resumes
    them; a store whose shape or daily lattice differs starts fresh. Reads
    return copies, as an HDF5 read does."""

    STORE: dict = {}  # path -> {"daily", "normal", "se", "attrs"}

    def __init__(self, path, var, grid, dates, daily_scale, daily_offset, tile_rows,
                 tile_cols, compress=0):
        import pathlib

        self.path = pathlib.Path(path)
        self.var = var
        shape = (len(dates), grid.nrows, grid.ncols)
        attrs = {"scale_factor": float(np.float32(daily_scale)),
                 "add_offset": float(np.float32(daily_offset)), "layout": "direct"}
        old = self.STORE.get(self.path)
        self.fresh = not (old is not None and old["daily"].shape == shape
                          and all(old["attrs"][k] == attrs[k] for k in attrs))
        if self.fresh:
            monthly = lambda: np.full((12,) + shape[1:], np.nan, np.float32)  # noqa: E731
            self.STORE[self.path] = dict(daily=np.full(shape, -32768, np.int16),
                                         normal=monthly(), se=monthly(), attrs=attrs)
        else:  # resume: the tiles are rewritten, so completeness is claimed again only
            for stale in ("complete", "reconciled"):  # by finalize
                old["attrs"].pop(stale, None)
        self.data = self.STORE[self.path]

    def write_tile(self, row0, col0, daily_i16, normal, se, t0=0):
        nt, nr, nc = daily_i16.shape
        sl = (slice(row0, row0 + nr), slice(col0, col0 + nc))
        self.data["daily"][(slice(t0, t0 + nt),) + sl] = daily_i16
        if normal is not None:
            self.data["normal"][(slice(None),) + sl] = normal
            self.data["se"][(slice(None),) + sl] = se

    def read_tile_raw(self, row0, col0, nr, nc, t0=0, nt=None):
        d = self.data["daily"]
        if nt is None:
            nt = d.shape[0] - t0
        return d[t0 : t0 + nt, row0 : row0 + nr, col0 : col0 + nc].copy()

    def read_monthly_back(self, row0, col0, nr, nc):
        sl = (slice(None), slice(row0, row0 + nr), slice(col0, col0 + nc))
        return self.data["normal"][sl].copy(), self.data["se"][sl].copy()

    def finalize(self, n_tiles, reconciled, process_index=0, process_count=1):
        self.data["attrs"].update(n_tiles=n_tiles, complete=True, reconciled=bool(reconciled),
                                  process_index=process_index, process_count=process_count)

    def close(self):
        pass


def memory_engine(*args, **kwargs):
    """A ``TileEngine`` that writes its direct-mode mosaics into
    ``MemoryMosaic``."""
    from topotpu_torch.dist.engine import TileEngine

    class MemoryEngine(TileEngine):
        MOSAIC_WRITER = MemoryMosaic

    return MemoryEngine(*args, **kwargs)


def engine_inputs(side, n_stations, start, end, seed=0):
    """``bench_e2e.py::build``'s world with the port's types: a side x side
    world, every station valid in every month with the world's variogram;
    var B = var A's normals + 9 C with anomalies x 0.85. Returns (world, days,
    rasters, a, b)."""
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.dist.engine import StationSet
    from topotpu_torch.io.rasters import RasterStack
    from topotpu_torch.io.synthetic import make_world

    days = get_days_metadata(start, end)
    world = make_world(np.random.default_rng(seed), nrows=side, ncols=side,
                       n_stations=n_stations, ndays=days.ndays)
    S = world.n_stations
    a = StationSet(
        lon=world.stn_lon, lat=world.stn_lat, elev=world.stn_elev, tdi=world.stn_tdi,
        lst=world.stn_lst, norm=world.stn_norm,
        vario=np.tile(np.asarray(world.true_vario, np.float32), (S, 12, 1)),
        valid=np.ones((S, 12), bool), anoms=world.stn_anoms.astype(np.float32),
    )
    b = dataclasses.replace(a, norm=world.stn_norm + 9.0,
                            anoms=(world.stn_anoms * 0.85).astype(np.float32))
    return world, days, RasterStack.from_world(world), a, b


def timed_engine(stats):
    """A TileEngine that writes into ``MemoryMosaic`` and adds to ``stats``:
    the main thread's prepare seconds a tile-pair, the fetch thread's waits,
    the writer's seconds a tile-pair, a pair of CUDA events around each step
    launch, and any watchdog stall (which then exits as the engine does)."""
    import torch

    from topotpu_torch.dist.engine import TileEngine

    class Timed(TileEngine):
        MOSAIC_WRITER = MemoryMosaic

        def prepare_pair(self, spec, a, b):
            t = time.perf_counter()
            out = super().prepare_pair(spec, a, b)
            stats["prepare"].append(time.perf_counter() - t)
            return out

        def _fetch(self, fut):
            t = time.perf_counter()
            host = TileEngine._fetch(fut)
            stats["fetch"].append(time.perf_counter() - t)
            return host

        def _write_tile_pair(self, spec, var_a, var_b, result):
            t = time.perf_counter()
            super()._write_tile_pair(spec, var_a, var_b, result)
            stats["write"].append(time.perf_counter() - t)

        def _get_pair_fn(self, *args, **kwargs):
            fn = super()._get_pair_fn(*args, **kwargs)

            def launch(*a, **kw):
                t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0.record()
                out = fn(*a, **kw)
                t1.record()
                stats["events"].append((t0, t1))
                return out
            return launch

        def _on_stall(self, idle_s):
            stats["stalls"].append(idle_s)
            super()._on_stall(idle_s)

    return Timed


def _tile_region(spec, t0, nt):
    return (slice(t0, t0 + nt), slice(spec.row0, spec.row0 + spec.nrows),
            slice(spec.col0, spec.col0 + spec.ncols))


def phase_engine(dev):
    """The port's production engine as ``topotpu/cli/steps.py::step_interp``
    drives the JAX one: direct-to-mosaic ``run_production_pair`` over
    ``bench_e2e.py``'s world (512 x 512 cells, 1,000 stations, 16 tiles of
    128 x 128 at the config defaults: k = 32, a 512-station pool) in two
    one-year chunks, with a k_table that gives two tiles per-variable sizes
    and an in-memory mosaic (the card's machine has no h5py). Checks the
    counts, the manifests, coverage and lattice order, the launches, two
    tiles bit for bit against direct step calls, July normals against the
    truth, and a resume of three tiles bit for bit. Returns the launches."""
    import pathlib
    import tempfile

    import torch

    from topotpu_torch.core.config import TopoConfig
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.interp.point import interp_tile_pair_flat

    t_phase = time.perf_counter()
    world, days, rasters, a, b = engine_inputs(EN_SIDE, EN_STATIONS, EN_START, EN_END)
    cfg = TopoConfig(start_date=EN_START, end_date=EN_END, stall_timeout_s=60)
    log(f"[engine] world {EN_SIDE}x{EN_SIDE}, {a.n} stations, {days.ndays} days built on the "
        f"host in {time.perf_counter() - t_phase:.3f} s")
    stats = {k: [] for k in ("prepare", "fetch", "write", "events", "stalls")}
    laps = {}
    Engine = timed_engine(stats)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_engine_")
    root = pathlib.Path(tmp.name)
    mosaics = {v: root / f"mosaic_{v}.h5" for v in ("tmin", "tmax")}
    make = lambda out: Engine(cfg, rasters, days, out / "tiles", device=dev,  # noqa: E731
                              mosaic_paths=mosaics, k_table=EN_K_TABLE)
    try:
        # warm-up: prepare and step one tile; then one step alone on an idle
        # device, its span by CUDA events and its host wall
        warm = Engine(cfg, rasters, days, root / "warm", device=dev)
        spec = warm.tiling.tile(0)
        _, pair = warm.prepare_pair(spec, a, b)
        step = lambda: interp_tile_pair_flat(  # noqa: E731
            pair, warm._dev_slot(), cfg.interp, True, fixed_scales=warm._dev_scales(2),
            reconcile=True)
        step()
        torch.cuda.synchronize()
        t_alone = time.perf_counter()
        alone_ms = cuda_ms(step, 1, warmup=0)
        alone_wall = (time.perf_counter() - t_alone) * 1e3
        del warm, pair, step
        for v in stats.values():
            v.clear()
        laps["world, warm-up"] = time.perf_counter() - t_phase

        eng = make(root)
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        counts = eng.run_production_pair("tmin", "tmax", a, b, years_per_chunk=1,
                                         progress=False)
        wall = time.perf_counter() - t0
        laps["run"] = wall
        launches = _read_launches()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        pinned = (eng._staging.nbytes + eng._fetch_pool.nbytes) / 2**20
        device_ms = sum(s.elapsed_time(e) for s, e in stats["events"])
        n_pairs = len(stats["write"])
        var_cells = 2 * EN_SIDE * EN_SIDE * 2  # two variables, two one-year chunks
        timing = dict(prepare=np.mean(stats["prepare"]) * 1e3, fetch=np.sum(stats["fetch"]),
                      fetch_max=np.max(stats["fetch"]) * 1e3,
                      write=np.mean(stats["write"]) * 1e3)

        n_ktab = len(EN_K_TABLE) * 2  # k_table tiles x chunks: one more krig_normals launch
        if counts != {"tmin": 32, "tmax": 32} or n_pairs != 32:
            raise RuntimeError(f"run_production_pair returned {counts} ({n_pairs} writes)")
        if launches != dict(krig_normals=32 + n_ktab, scatter_daily=0, scatter_daily_packed=32):
            raise RuntimeError(f"engine launches {launches}")
        land = {t.tile_id: int(rasters.landmask[_tile_region(t, 0, 0)[1:]].sum())
                for t in eng.tiling.land_tiles(rasters.landmask)}
        if len(land) != 16:
            raise RuntimeError(f"{len(land)} land tiles, expected 16")
        for year in ("2015", "2016"):
            man = json.loads((root / "tiles" / f"chunk_{year}_{year}" / "manifest.json")
                             .read_text())["tiles"]
            if len(man) != 32:
                raise RuntimeError(f"chunk {year}: {len(man)} manifest entries")
            for key, info in man.items():
                var, tid = key.split("_")
                ver, want_k = info["verify"], EN_K_TABLE.get(int(tid), {}).get(var)
                if (ver["covered"] != land[int(tid)] or ver["viol"] != 0 or ver["pairs"] <= 0
                        or info.get("k") != (list(want_k) if want_k else None)):
                    raise RuntimeError(f"chunk {year} {key}: {info}")
        store = {v: MemoryMosaic.STORE[mosaics[v]] for v in mosaics}
        for v, m in store.items():
            if not (m["attrs"].get("complete") and m["attrs"].get("reconciled")
                    and m["attrs"].get("n_tiles") == 16):
                raise RuntimeError(f"mosaic {v} attrs {m['attrs']}")

        # two tiles of the 2016 chunk against the step called directly
        d16 = get_days_metadata("2016-01-01", EN_END)
        sel = days.year == 2016
        a16, b16 = (dataclasses.replace(s, anoms=s.anoms[:, sel]) for s in (a, b))
        check = Engine(cfg, rasters, d16, root / "check", device=dev, k_table=EN_K_TABLE)
        fixed = check._dev_scales(2)
        nd, t0_16 = d16.ndays, int(np.flatnonzero(sel)[0])
        for tid in (3, 5):
            spec = check.tiling.tile(tid)
            _, pair = check.prepare_pair(spec, a16, b16)
            params = check._params_for(spec, "tmin", "tmax") or cfg.interp
            out = interp_tile_pair_flat(pair, check._dev_slot(), params, True,
                                        fixed_scales=fixed, reconcile=True)
            buf, sc = out.buf.cpu().numpy(), out.scales.cpu().numpy()
            for v, var in enumerate(("tmin", "tmax")):
                rows = buf[v * (nd + 24) : (v + 1) * (nd + 24)].reshape(
                    nd + 24, cfg.tile_rows, cfg.tile_cols)
                s6 = sc[6 * v : 6 * v + 6]
                ok = rows[nd : nd + 12] != -32768
                dec = lambda q, i: np.where(ok, q.astype(np.float32) * float(s6[i])  # noqa: E731
                                            + float(s6[i + 1]), np.nan)
                m = store[var]
                same = (np.array_equal(m["daily"][_tile_region(spec, t0_16, nd)], rows[:nd])
                        and np.array_equal(m["normal"][_tile_region(spec, 0, 12)],
                                           dec(rows[nd : nd + 12], 2), equal_nan=True)
                        and np.array_equal(m["se"][_tile_region(spec, 0, 12)],
                                           dec(rows[nd + 12 :], 4), equal_nan=True))
                if not same:
                    raise RuntimeError(f"tile {tid} {var}: the mosaic is not the direct step's")
        del check, pair, out

        # July normals of sampled cells against the truth (the world's exact
        # residual field is a dense product over every station for each cell)
        cells = np.random.default_rng(11).choice(EN_SIDE * EN_SIDE, EN_TRUTH_CELLS, replace=False)
        rows, cols = np.unravel_index(cells, (EN_SIDE, EN_SIDE))
        lon, lat = world.grid.cell_lonlat(rows, cols)
        truth = world.true_normal(lon, lat, world.elev[rows, cols], world.tdi[rows, cols],
                                  world.lst[6, rows, cols], 7)
        mae = float(np.mean(np.abs(store["tmin"]["normal"][6][rows, cols] - truth)))
        if mae >= 0.3:
            raise RuntimeError(f"July normals MAE vs truth {mae:.4f} C")

        laps["checks"] = time.perf_counter() - t0 - wall
        # resume: three tiles of the 2016 chunk lose their manifest entries
        # and their daily region; exactly they are recomputed, bit for bit
        t = time.perf_counter()
        first = {v: {k: store[v][k].copy() for k in ("daily", "normal", "se")} for v in store}
        man_path = root / "tiles" / "chunk_2016_2016" / "manifest.json"
        man = json.loads(man_path.read_text())
        for tid in EN_RESUME:
            for v in store:
                del man["tiles"][f"{v}_{tid:05d}"]
                store[v]["daily"][_tile_region(eng.tiling.tile(tid), t0_16, nd)] = -32768
        man_path.write_text(json.dumps(man))
        _zero_launches()
        t_resume = time.perf_counter()
        again = make(root).run_production_pair("tmin", "tmax", a, b, years_per_chunk=1,
                                               progress=False)
        resume_wall = time.perf_counter() - t_resume
        resumed = _read_launches()
        n_k = sum(tid in EN_K_TABLE for tid in EN_RESUME)
        if again != {"tmin": 3, "tmax": 3} or resumed != dict(
                krig_normals=3 + n_k, scatter_daily=0, scatter_daily_packed=3):
            raise RuntimeError(f"resume returned {again}, launches {resumed}")
        for v in store:
            for k, arr in first[v].items():
                if not np.array_equal(store[v][k], arr, equal_nan=k != "daily"):
                    raise RuntimeError(f"resume changed the {v} mosaic's {k}")
        if stats["stalls"]:
            raise RuntimeError(f"the stall watchdog fired: {stats['stalls']}")
        laps["resume and its checks"] = time.perf_counter() - t
    finally:
        for path in mosaics.values():
            MemoryMosaic.STORE.pop(path, None)
        tmp.cleanup()

    log(f"[engine] run_production_pair {EN_SIDE}x{EN_SIDE}, {a.n} stations, 2 one-year chunks "
        f"(365 + 366 days), 16 tiles of {cfg.tile_rows}x{cfg.tile_cols}, k={cfg.interp.k_neighbors}, pool "
        f"{cfg.interp.max_tile_stations}, reconcile on, k_table on tiles {sorted(EN_K_TABLE)}: "
        f"{n_pairs} tile-pairs in {wall:.3f} s, {var_cells / wall:.1f} var-cells/s; prepare "
        f"{timing['prepare']:.3f} ms a tile-pair (main thread); fetch thread waited "
        f"{timing['fetch']:.3f} s in all (longest {timing['fetch_max']:.3f} ms); writer "
        f"{timing['write']:.3f} ms a tile-pair; device {device_ms:.3f} ms in the steps "
        f"(CUDA events around each launch; one step alone on the idle device "
        f"{alone_ms:.3f} ms, host wall {alone_wall:.3f} ms), busy share "
        f"{device_ms / 1e3 / wall:.3f}; launches "
        f"{launches}; peak device memory {peak:.3f} GiB, pinned host {pinned:.1f} MiB; checks: "
        f"manifests 32 + 32 a variable, full coverage, viol 0, k recorded, tiles 3 and 5 bit "
        f"for bit vs the direct step, July normals MAE vs truth {mae:.4f} C ({EN_TRUTH_CELLS} "
        f"cells); resume of tiles "
        f"{list(EN_RESUME)}: {again}, launches {resumed}, {resume_wall:.3f} s, mosaic bit for "
        f"bit; watchdog quiet; walls " + ", ".join(f"{k} {v:.3f} s" for k, v in laps.items())
        + f" ({time.perf_counter() - t_phase:.1f} s in all)")
    return {k: launches[k] + resumed[k] for k in launches}


def _wsse(gamma, h, npairs, nug, ps, rg):
    """Weighted SSE of the variogram fit objective (gstat fit.method 7), float64."""
    ok = npairs > 0
    w = np.where(ok, npairs / np.maximum(h, 1e-3) ** 2, 0.0)
    w = w / w.sum(-1, keepdims=True)
    model = nug[..., None] + ps[..., None] * (1 - np.exp(-h / rg[..., None]))
    return np.sum(np.where(ok, w * (gamma - model) ** 2, 0.0), -1)


def _variogram_oracle(st, vario_m, month, picks, vp, ip, dev):
    """Month ``month``'s empirical variograms of the stations ``picks``
    against the float64 loop oracle (npairs equal, gamma and h rtol 1e-4, as
    ``tests/test_variogram.py``). The timed krig-params run keeps only the
    fitted parameters, so the variograms are computed again here by the
    port's own functions from the same month's residuals over the whole
    network, on a batch of the picked stations. A station with a pair within
    1e-6 (relative) of a bin edge or of the cutoff, where float32 and float64
    may bin it differently (their d / width differ by ~2e-7), is skipped.
    Then the timed run's fits ``vario_m`` of those stations against scipy's
    least squares on the same variograms: per fit, whether its weighted SSE
    is within 1.1x scipy's + 1e-10. Returns the max gamma error, the skipped
    count, the share within, the median wSSE ratio and how many fits outside
    have their nugget at the 0 bound."""
    import torch

    from topotpu_torch.oracle import numpy_ref
    from topotpu_torch.interp.convert import to_tensor
    from topotpu_torch.interp.params import station_residuals
    from topotpu_torch.stats.variogram import empirical_variogram

    f = lambda a: to_tensor(a, dev)  # noqa: E731
    dp, resid, mask = station_residuals(
        f(st.lon), f(st.lat), f(st.elev), f(st.tdi),
        to_tensor(st.valid[:, month], dev, torch.bool), f(st.lst[:, month]),
        f(st.norm[:, month]), vp.k_fit_neighbors, ip)
    sel = torch.as_tensor(picks, device=dev)
    dp, resid, mask = dp[sel], resid[sel], mask[sel]
    emp = empirical_variogram(dp, resid, mask, n_bins=vp.n_bins, max_dist_frac=vp.max_dist_frac)
    gamma, h, npairs, cutoff = (t.cpu().numpy().astype(np.float64) for t in emp)
    dp, resid, mask = (t.cpu().numpy() for t in (dp, resid, mask))
    n_bins, err, skipped = vp.n_bins, 0.0, 0
    for b in range(len(picks)):
        m = mask[b]
        d = dp[b][np.ix_(m, m)].astype(np.float64)
        pos = d[np.triu_indices(int(m.sum()), 1)] / (cutoff[b] / n_bins)
        pos = pos[(pos > 0.0) & (pos <= n_bins * (1.0 + 1e-6))]
        if np.any(np.abs(pos - np.round(pos)) < 1e-6 * np.maximum(pos, 1.0)):
            skipped += 1
            continue
        wg, wh, wn = numpy_ref.empirical_variogram_loops(d, resid[b][m].astype(np.float64),
                                                         n_bins, cutoff[b])
        np.testing.assert_array_equal(npairs[b], wn, err_msg=f"npairs of station {picks[b]}")
        np.testing.assert_allclose(gamma[b], wg, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(h[b], wh, rtol=1e-4, atol=1e-6)
        err = max(err, float(np.abs(gamma[b] - wg).max()))
    if skipped > len(picks) // 10:
        raise RuntimeError(f"{skipped} of {len(picks)} stations sit on a bin edge")

    got = _wsse(gamma, h, npairs, *(vario_m[picks, i].astype(np.float64) for i in range(3)))
    want = np.array([
        _wsse(gamma[b], h[b], npairs[b], *numpy_ref.fit_exp_scipy(gamma[b], h[b], npairs[b]))
        for b in range(len(picks))
    ])
    within = got <= 1.1 * want + 1e-10
    outside_at_bound = int(np.sum(~within & (vario_m[picks, 0] == 0.0)))
    return (err, skipped, float(within.mean()), float(np.median(got / np.maximum(want, 1e-30))),
            outside_at_bound)


def _loo_oracle(st, vario_m, normal_m, month, picks, k):
    """July LOO normals of the stations ``picks`` against the float64
    pipeline oracle run with each station left out of the pool."""
    from topotpu_torch.oracle.pipeline import interp_cell_month

    cov = np.stack([st.elev, st.tdi, st.lst[:, month]], 1)
    errs = []
    for s in picks:
        keep = np.arange(len(st.lon)) != s
        want = interp_cell_month(
            st.lon[s], st.lat[s], cov[s], np.zeros(3), st.lon[keep], st.lat[keep],
            cov[keep], np.zeros((keep.sum(), 3)), st.norm[keep, month],
            vario_m[keep].astype(np.float64), k)["normal"]
        errs.append(abs(float(normal_m[s]) - want))
    return np.array(errs)


def stations_world():
    """The station phase's world and its station arrays, built on the host
    (numpy) while nvcc builds the kernels: (world, arrays, ndays, seconds)."""
    from topotpu_torch.io.synthetic import make_world, station_arrays_from_world

    t0 = time.perf_counter()
    ndays = int((np.datetime64(ST_END) - np.datetime64(ST_START)).astype(int)) + 1
    world = make_world(np.random.default_rng(7), nrows=ST_SIDE, ncols=ST_SIDE,
                       n_stations=ST_STATIONS, ndays=ndays)
    return world, station_arrays_from_world(world, start=ST_START), ndays, \
        time.perf_counter() - t0


def phase_stations(dev, prebuilt):
    """krig-params, the x-val stages and both nnghs sweeps at the full
    network size, through the port's public functions, on ``prebuilt``
    (``stations_world()``'s result)."""
    import torch

    from topotpu_torch.core.config import InterpParams, VariogramParams
    from topotpu_torch.interp import xval
    from topotpu_torch.interp.params import (
        build_krig_params,
        fill_failed_fits,
        krig_params_to_numpy,
    )
    from topotpu_torch.interp.xval import (
        optimize_nnghs,
        optimize_nnghs_anoms,
        xval_interp_daily,
        xval_interp_normals,
    )
    from topotpu_torch.kernels.krig_normals import krig_normals_indexed
    from topotpu_torch.kernels.variogram_fit import variogram_fit

    world, st, ndays, build_s = prebuilt
    S = len(st.lon)
    log(f"[stations] world {ST_SIDE}x{ST_SIDE}, {S} stations, {ndays} days built on the "
        f"host in {build_s:.3f} s (while nvcc built the kernels)")
    picks = np.sort(np.random.default_rng(8).choice(S, ST_SAMPLE, replace=False))
    torch.cuda.reset_peak_memory_stats()
    walls = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        log(f"[stations] {name} wall {walls[name]:.3f} s")
        return out

    vp = VariogramParams(k_fit_neighbors=64, n_bins=15, gn_iters=50)
    ip = InterpParams()
    variogram_fit.launches = 0
    res = timed("krig-params", lambda: krig_params_to_numpy(build_krig_params(
        st.lon, st.lat, st.elev, st.tdi, st.lst, st.norm, st.valid, vp, ip, dev)))
    fits = variogram_fit.launches
    if fits != 12:  # one launch fits a month's stations
        raise RuntimeError(f"krig-params: {fits} variogram_fit launches, expected 12")
    usable = float(res.ok.mean())
    if usable <= 0.95:
        raise RuntimeError(f"only {usable:.4f} of the fits are usable")
    vario = fill_failed_fits(res.vario, res.ok).astype(np.float32)
    emp_err, skipped, fit_share, fit_median, at_bound = _variogram_oracle(
        st, res.vario[:, 6], 6, picks, vp, ip, dev)
    log(f"[stations] krig-params S={S} k_fit=64: usable fits {usable:.4f}; July empirical "
        f"variograms of {ST_SAMPLE - skipped} stations vs the float64 loop oracle: max gamma "
        f"err {emp_err:.3e} ({skipped} skipped at a bin edge); fits within 1.1x scipy's wSSE: "
        f"{fit_share:.4f} of {ST_SAMPLE} (median ratio {fit_median:.4f}; of the fits outside, "
        f"{at_bound} have nugget 0)")
    # the Gauss-Newton step is clamped onto the box after it is solved, so
    # where the best nugget is 0 it stalls short of scipy's bounded optimum,
    # in the JAX package as in the port (tests/test_torch_variogram.py). The
    # per-fit bar therefore holds on a share: 0.902 on this world on an
    # H100 in two runs, held to 0.85
    if fit_share < 0.85 or fit_median > 1.1:
        raise RuntimeError(f"variogram fits: {fit_share:.4f} within 1.1x scipy's wSSE, "
                           f"median ratio {fit_median:.4f}")
    st = st._replace(vario=vario)

    # the indexed kernel at the x-val runs' own shapes (12 LOO neighbourhoods,
    # the stations as cells and as table rows, one variable) against its
    # plain version, at every k of the nnghs sweep; up to k = 24 float64
    # decides by statistics (see _compare_krig)
    st_dev = xval._stations(dev, *st.krig())
    for k, ill in ((8, True), (16, True), (24, True), (K, False), (48, False)):
        t = time.perf_counter()
        _, (*args, pairs, shared) = xval._loo_systems(st_dev, k)
        err, n_not_ok, e64_kern, e64_plain = _compare_indexed(args, pairs, not shared, k, ill)
        log(f"[stations] krig_normals indexed at the LOO shapes C=S={S} k={k}, {len(pairs)} "
            f"systems on {args[0].shape[0]} neighbourhoods in 1 launch vs the plain version"
            f"{' (float64 decides by mean, 99th and 99.9th percentile)' if ill else ''}: "
            f"max_abs_err {err:.3e} (normal vs float64: kernel {e64_kern:.3e}, plain "
            f"{e64_plain:.3e}; not-ok cells {n_not_ok}) ({time.perf_counter() - t:.1f} s)")
        del args
    del st_dev

    counts = {}

    def counted(name, runs, fn):
        krig_normals_indexed.launches = 0
        out = timed(name, fn)
        counts[name] = krig_normals_indexed.launches
        if counts[name] != runs:  # one launch covers an x-val run's 12 months
            raise RuntimeError(f"{name}: {counts[name]} krig_normals launches, "
                               f"expected {runs}")
        return out

    p32 = InterpParams(k_neighbors=K)
    sc = counted("xval-normals", 1, lambda: xval_interp_normals(*st.krig(), p32, dev))
    mae, bias, r2 = float(sc.mae.mean()), float(sc.bias.mean()), float(sc.r2.mean())
    if not (mae < 0.6 and abs(bias) < 0.1 and r2 > 0.9):
        raise RuntimeError(f"x-val normals: MAE {mae:.4f} bias {bias:.4f} R2 {r2:.4f}")
    normal7 = sc.per_station_err[:, 6] + st.norm[:, 6].astype(np.float32)
    scored = picks[np.isfinite(normal7[picks])]
    t = time.perf_counter()
    loo_err = _loo_oracle(st, vario[:, 6], normal7, 6, scored, K)
    if len(scored) < 0.95 * ST_SAMPLE or loo_err.max() > 2e-2:
        raise RuntimeError(f"LOO normals vs oracle: {len(scored)} scored, max err "
                           f"{loo_err.max():.3e} C")
    log(f"[stations] xval-normals k={K}: MAE {mae:.4f} C, bias {bias:.4f} C, R2 {r2:.4f}; "
        f"July LOO normals of {len(scored)} stations vs the float64 oracle: max err "
        f"{loo_err.max():.3e} C ({time.perf_counter() - t:.1f} s)")

    regions = (st.lon > np.median(st.lon)).astype(int)
    cands = (8, 16, 24, 32, 48)
    nn = counted("optim-nnghs", len(cands), lambda: optimize_nnghs(
        *st.krig(), candidates=cands, region_labels=regions, device=dev))
    if set(nn["best"]) != {0, 1} or not all(k in cands for k in nn["best"].values()):
        raise RuntimeError(f"optimize_nnghs picked {nn['best']}")
    log(f"[stations] optim-nnghs over {cands}: best {nn['best']}; mean MAE by k "
        + " ".join(f"{k}:{float(np.mean(v)):.4f}" for k, v in nn["mae"].items()))

    daily = counted("xval-daily", 1, lambda: xval_interp_daily(
        *st.krig(), st.anoms, st.month_idx, p32, dev))
    if not (daily["mae"] < 2.0 and abs(daily["bias"]) < 0.15):
        raise RuntimeError(f"daily x-val: MAE {daily['mae']:.4f} bias {daily['bias']:.4f}")
    acands = (8, 16, 24, 32)
    na = counted("optim-nnghs-anoms", len(acands), lambda: optimize_nnghs_anoms(
        *st.krig(), st.anoms, st.month_idx, candidates=acands, region_labels=regions,
        device=dev))
    if set(na["best"]) != {0, 1} or not all(v < 2.0 for v in na["mae"].values()):
        raise RuntimeError(f"optimize_nnghs_anoms: best {na['best']} MAE {na['mae']}")
    log(f"[stations] xval-daily k={K} ka={min(p32.k_neighbors_anom, K)} over {ndays} days: "
        f"MAE {daily['mae']:.4f} C, bias {daily['bias']:.4f} C, RMSE {daily['rmse']:.4f} C; "
        f"optim-nnghs-anoms over {acands}: best {na['best']}; MAE by ka "
        + " ".join(f"{k}:{v:.4f}" for k, v in na["mae"].items()))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[stations] krig_normals launches {counts}; walls "
        + " ".join(f"{n} {w:.3f} s" for n, w in walls.items())
        + f"; peak device memory {peak:.3f} GiB")
    profile_breakdown("stations", "krig-params",
                      lambda: build_krig_params(st.lon, st.lat, st.elev, st.tdi, st.lst,
                                                st.norm, st.valid, vp, ip, dev))
    profile_breakdown("stations", "xval-daily", lambda: xval_interp_daily(
        *st.krig(), st.anoms, st.month_idx, p32, dev))
    return sum(counts.values()), fits, world


def _observed_day(arrays, s, t0, half=0):
    """The first day from ``t0`` on where every array of ``arrays`` is
    observed at station ``s`` on that day and ``half`` days either side."""
    ok = np.logical_and.reduce([np.isfinite(a[s]) for a in arrays])
    win = np.lib.stride_tricks.sliding_window_view(ok, 2 * half + 1).all(axis=1)
    return half + t0 + int(np.flatnonzero(win[t0:])[0])


def qa_network():
    """The station-QA slice's network: ``make_world`` (seed 31, 512 x 512
    cells, 1,000 stations, 2004-2015), tmin and tmax built as the CLI's
    synth-data step builds them (15 % missing), and the faults planted:
    ``tests/test_qa.py``'s defects (a world record in each variable, a 30-day
    streak, tmax < tmin, a +30 C spike, a date-aligned duplicated year), its
    lone +15 C value at a station with at least 3 neighbours within 75 km
    (``run_qa_spatial``'s radius), and +1.5 C before 2010-01-01 in both
    variables of 20 stations. Days are moved forward to observed ones where
    the fault needs an observed value. Returns (world, days, tmin, tmax,
    planted, steps): ``planted`` lists (fault, variable, station, day
    indices, the codes ``tests/test_qa.py`` accepts), ``steps`` the
    stepped stations."""
    from topotpu_torch.core import constants as C
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.io.synthetic import make_world
    from topotpu_torch.oracle.numpy_ref import haversine_km

    days = get_days_metadata(QH_START, QH_END)
    rng = np.random.default_rng(31)
    world = make_world(rng, nrows=QH_SIDE, ncols=QH_SIDE, n_stations=QH_STATIONS,
                       ndays=days.ndays)
    S = world.n_stations
    tmin = (world.stn_norm[np.arange(S)[:, None], days.month_idx[None, :]]
            + world.stn_anoms).astype(np.float32)
    tmax = tmin + 10.0 + 1.5 * rng.standard_normal(tmin.shape).astype(np.float32)
    for arr in (tmin, tmax):
        arr[rng.uniform(size=arr.shape) < QH_MISSING] = np.nan

    planted = []
    tmin[0, 100] = 99.0
    planted.append(("world record", "tmin", 0, np.array([100]), {C.QA_IMPOSS_VALUE}))
    tmax[1, 200] = -120.0
    planted.append(("world record", "tmax", 1, np.array([200]), {C.QA_IMPOSS_VALUE}))
    tmin[2, 300:330] = 5.0
    planted.append(("30-day streak", "tmin", 2, np.arange(300, 330), {C.QA_STREAK}))
    t = _observed_day((tmax,), 3, 400)
    tmin[3, t] = tmax[3, t] + 5.0
    for var in ("tmin", "tmax"):
        planted.append(("tmax < tmin", var, 3, np.array([t]), {C.QA_INTERNAL}))
    t = _observed_day((tmax,), 4, 500, half=1)
    tmax[4, t] += 30.0
    planted.append(("+30 C spike", "tmax", 4, np.array([t]),
                    {C.QA_SPIKE_DIP, C.QA_CLIM_OUTLIER, C.QA_GAP}))
    y13 = np.flatnonzero(days.year == 2013)
    slot = (days.month - 1) * 31 + (days.day - 1)
    src_of_slot = {slot[i]: i for i in np.flatnonzero(days.year == 2012)}
    tmin[5, y13] = tmin[5, [src_of_slot[slot[i]] for i in y13]]
    both = np.flatnonzero((days.year == 2012) | (days.year == 2013))  # the check flags both
    planted.append(("duplicated year", "tmin", 5, both[np.isfinite(tmin[5, both])],
                    {C.QA_DUP_YEAR}))

    d = haversine_km(world.stn_lon[:, None], world.stn_lat[:, None],
                     world.stn_lon[None], world.stn_lat[None])
    near = (d < 75.0).sum(axis=1) - 1
    s = 6 + int(np.flatnonzero(near[6:] >= 3)[0])
    # in tmax: tmin + 15 C would lie above the day's tmax, which the internal
    # consistency check takes before the spatial one sees it
    t = _observed_day((tmax,), s, 600)
    tmax[s, t] += 15.0
    planted.append(("lone +15 C", "tmax", s, np.array([t]), {C.QA_SPATIAL_REGRESS}))

    others = np.setdiff1d(np.arange(S), [p[2] for p in planted])
    steps = np.sort(np.random.default_rng(32).choice(others, QH_STEPS, replace=False))
    cut = int(np.flatnonzero(days.ymd == QH_STEP_AT)[0])
    tmin[steps, :cut] += 1.5
    tmax[steps, :cut] += 1.5
    return world, days, tmin, tmax, planted, steps


def homog_counts(results, days, steps, date_tol=6):
    """{variable: (planted steps found within ``date_tol`` months, breaks
    elsewhere)} of ``homogenize_elements``' results."""
    keys = np.unique(days.year * 12 + days.month - 1)
    at = int(np.searchsorted(keys, (QH_STEP_AT // 10000) * 12 + (QH_STEP_AT // 100) % 100 - 1))
    out = {}
    for var, res in results.items():
        found = elsewhere = 0
        for s, brks in enumerate(res.breakpoints):
            hit = [b for b, _ in brks if s in steps and abs(b - at) <= date_tol]
            found += bool(hit)
            elsewhere += len(brks) - min(len(hit), 1)
        out[var] = (found, elsewhere)
    return out


def phase_station_qa(dev):
    """The stages before the infill on ``qa_network()``, as the CLI's qa and
    homog steps and make-regions call them: the non-spatial QA, the spatial
    QA of each variable, the flagged values set to NaN, ``homogenize_elements``
    over tmin and tmax (its pair selection, ``select_predictors``, takes the
    numpy branch at this size, as in the JAX package), and the climate
    regions of the world's rasters. The full network is 10,000 stations; at
    that size the host would spend about 80 s here, so the network is cut to
    1,000 (the span stays 12 years: with minseg = 24 months a shorter one
    leaves the break search almost no room)."""
    from topotpu_torch.core import constants as C
    from topotpu_torch.geo import make_climate_regions
    from topotpu_torch.homog import homogenize_elements
    from topotpu_torch.infill import pipeline
    from topotpu_torch.io.rasters import RasterStack
    from topotpu_torch.qa import run_qa_non_spatial, run_qa_spatial

    t = time.perf_counter()
    world, days, tmin, tmax, planted, steps = qa_network()
    lon, lat = world.stn_lon, world.stn_lat
    S, T = tmin.shape
    walls = dict(network=time.perf_counter() - t)
    t = time.perf_counter()
    ft, fx = run_qa_non_spatial(tmin, tmax, days)
    walls["non-spatial"] = time.perf_counter() - t
    t = time.perf_counter()
    ft = run_qa_spatial(tmin, ft, lon, lat, days)
    fx = run_qa_spatial(tmax, fx, lon, lat, days)
    walls["spatial"] = time.perf_counter() - t
    flags = dict(tmin=ft, tmax=fx)
    missed = [f"{name} ({var}, station {s}: codes {sorted(set(flags[var][s, t].tolist()))})"
              for name, var, s, t, codes in planted
              if not np.isin(flags[var][s, t], list(codes)).all()]
    by_code = np.bincount(np.concatenate([ft.ravel(), fx.ravel()]), minlength=16)
    unplanted = dict(tmin=np.isfinite(tmin), tmax=np.isfinite(tmax))
    for _, var, s, t, _ in planted:
        unplanted[var][s, t] = False
    share = {v: float((flags[v][unplanted[v]] != C.QA_OK).mean()) for v in flags}
    log(f"[qa] {S} stations x {T} days ({QH_START} to {QH_END}), {QH_MISSING:.0%} missing, "
        f"{len(planted)} planted faults: walls network {walls['network']:.3f} s, "
        f"run_qa_non_spatial {walls['non-spatial']:.3f} s, run_qa_spatial (both variables) "
        f"{walls['spatial']:.3f} s; flags by code "
        + str({int(c): int(n) for c, n in enumerate(by_code) if n and c != C.QA_OK})
        + "; share of unplanted observed values flagged "
        + " ".join(f"{v} {x:.6f}" for v, x in share.items())
        + f"; planted faults without an accepted code: {len(missed)}")
    if missed:
        raise RuntimeError("planted QA faults missed: " + "; ".join(missed))

    obs = {v: np.where(flags[v] == C.QA_OK, a, np.nan) for v, a in (("tmin", tmin),
                                                                    ("tmax", tmax))}
    M = len(np.unique(days.year * 12 + days.month - 1))
    gram = 6.0 * S * S * M
    pipeline._device_select_predictors.calls = 0
    t = time.perf_counter()
    res = homogenize_elements(obs, days.year, days.month, lon, lat, device=dev)
    wall = time.perf_counter() - t
    calls = pipeline._device_select_predictors.calls
    counts = homog_counts(res, days, steps)
    log(f"[homog] homogenize_elements(tmin, tmax) on {S} stations x {M} months: wall "
        f"{wall:.3f} s; select_predictors took its numpy branch on the host (6 S^2 M = "
        f"{gram:.3g} gram operations < 2e11), device-branch calls {calls}; planted "
        f"+1.5 C steps found within 6 months of {QH_STEP_AT} (of {QH_STEPS}) and breaks "
        f"elsewhere: " + ", ".join(f"{v} {f} and {e}" for v, (f, e) in counts.items())
        + f" (the JAX package: " + ", ".join(f"{v} {f} and {e}" for v, (f, e)
                                            in QH_JAX_COUNTS.items()) + ")")
    if calls:
        raise RuntimeError(f"select_predictors ran its device branch {calls}x")
    for v, (found, elsewhere) in counts.items():
        j_found, j_elsewhere = QH_JAX_COUNTS[v]
        if found < j_found - 1 or elsewhere > j_elsewhere + 2:
            raise RuntimeError(f"homogenisation of {v}: {found} found, {elsewhere} elsewhere; "
                               f"the JAX package {j_found} and {j_elsewhere}")

    t = time.perf_counter()
    rasters = RasterStack.from_world(world)
    labels = make_climate_regions(rasters)
    wall = time.perf_counter() - t
    land = rasters.landmask
    sizes = np.bincount(labels[land], minlength=12)
    log(f"[regions] make_climate_regions on {QH_SIDE}x{QH_SIDE} cells ({int(land.sum())} land): "
        f"wall {wall:.3f} s; region sizes {sizes.tolist()}")
    if (labels[~land] != -1).any() or labels[land].min() < 0 or labels[land].max() > 11 \
            or len(sizes) != 12 or (sizes == 0).any():
        raise RuntimeError("climate regions: labels outside 0..11 on land or -1 off it, "
                           "or an empty region")


class _StageWalls:
    """Within a ``with`` block, time every call of the named functions of
    ``module`` (each ending in a device synchronise) and add the seconds to
    ``walls[name]``; the functions are restored on exit."""

    def __init__(self, module, names):
        self.module, self.names, self.walls = module, names, dict.fromkeys(names, 0.0)

    def _timed(self, name, fn):
        import torch

        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.walls[name] += time.perf_counter() - t
            return out
        return run

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.module, n, self._timed(n, fn))
        return self.walls

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def _scores64(obs_in, rows, lon, lat):
    """Rows ``rows`` of the predictor score of ``select_predictors`` on the
    network ``obs_in`` (NaN = missing), recomputed in float64 on the host
    from the same standardised float32 series: |corr| + 1 over >= 30 jointly
    observed days, else the proximity tiebreak; -1 on the diagonal."""
    from topotpu_torch.oracle.numpy_ref import haversine_km

    mask = np.isfinite(obs_in)
    mu = np.nanmean(np.where(mask, obs_in, np.nan), axis=1)
    sd = np.nanstd(np.where(mask, obs_in, np.nan), axis=1) + 1e-6
    xs = np.where(mask, (obs_in - mu[:, None]) / sd[:, None], 0.0).astype(np.float32)
    x, m = xs.astype(np.float64), mask.astype(np.float64)
    del xs
    xr, mr = x[rows], m[rows]
    n = mr @ m.T
    sx, sy = xr @ m.T, mr @ x.T
    sxy = xr @ x.T
    sxx, syy = (xr * xr) @ m.T, mr @ (x * x).T
    sn = np.maximum(n, 1.0)
    cov = sxy / sn - (sx / sn) * (sy / sn)
    vx = np.maximum(sxx / sn - (sx / sn) ** 2, 1e-12)
    vy = np.maximum(syy / sn - (sy / sn) ** 2, 1e-12)
    score = np.abs(np.where(n < 30, 0.0, cov / np.sqrt(vx * vy)))
    prox = 1e-4 / (1.0 + haversine_km(lon[rows, None], lat[rows, None], lon[None], lat[None]))
    score = np.where(score > 0, score + 1.0, prox)
    score[np.arange(len(rows)), rows] = -1.0
    return score


def phase_infill(world, dev):
    """BASELINE config #3's PPCA settings (``configs/config3_infill.json``:
    12 components, 24 predictors, 200 iterations) over the first
    ``IN_STATIONS`` stations of the station phase's ``world`` and its 4-year
    chunk (config #3's 1986-2015 span took the phase over 120 s, and the
    whole network kept the script over 240 s), through ``xval_infill``: the
    CLI's 15 % random gaps, then the x-val's 20 % hold-out."""
    import pathlib

    import torch

    from topotpu_torch.core.config import TopoConfig
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.infill import pipeline
    from topotpu_torch.infill.post_infill import changepoint_flags
    from topotpu_torch.interp.convert import to_tensor
    from topotpu_torch.interp.xval import xval_infill
    from topotpu_torch.io.synthetic import station_network_from_world
    from topotpu_torch.stats.ppca import ppca_impute

    t_phase = time.perf_counter()
    params = TopoConfig.load(pathlib.Path(__file__).resolve().parent / IN_CONFIG).ppca
    days = get_days_metadata(ST_START, ST_END)
    truth, obs = station_network_from_world(world, days.month_idx, IN_GAPS, seed=9)
    truth, obs = truth[:IN_STATIONS], obs[:IN_STATIONS]
    stn_lon, stn_lat = world.stn_lon[:IN_STATIONS], world.stn_lat[:IN_STATIONS]
    S, T = obs.shape
    log(f"[infill] {IN_CONFIG}'s {params} on {S} stations x {T} days ({ST_START} to "
        f"{ST_END}); gaps drawn on the host in {time.perf_counter() - t_phase:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    pipeline._device_select_predictors.calls = 0
    with _StageWalls(pipeline, ("select_predictors", "_infill_batch")) as walls:
        t = time.perf_counter()
        out = xval_infill(obs, days.month_idx, params, holdout_frac=IN_HOLDOUT, seed=0,
                          stn_lon=stn_lon, stn_lat=stn_lat, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    calls = pipeline._device_select_predictors.calls
    peak = torch.cuda.max_memory_allocated() / 2**30
    if calls != 1:
        raise RuntimeError(f"the device branch of select_predictors ran {calls} times")
    res = out["result"]

    t = time.perf_counter()
    flags = changepoint_flags(res.filled, res.obs_mask, days.year, days.month)
    cp_wall = time.perf_counter() - t
    it = res.n_iters
    log(f"[infill] walls: select_predictors {walls['select_predictors']:.3f} s, EM batch loop "
        f"{walls['_infill_batch']:.3f} s ({-(-S // params.batch_size)} batches of "
        f"{params.batch_size}), changepoint_flags {cp_wall:.3f} s, xval_infill {wall:.3f} s; "
        f"device branch of select_predictors ran {calls}x; EM iterations mean "
        f"{it.mean():.2f} p95 {np.percentile(it, 95):.0f} max {it.max()}, converged "
        f"(< {params.max_iters}) {np.mean(it < params.max_iters):.4f}; changepoint flags "
        f"{int(flags.sum())}; peak device memory {peak:.3f} GiB")

    # accuracy, as tests/test_ppca_infill.py and tests/test_xval.py hold it
    hold = np.isfinite(obs) & (np.random.default_rng(0).uniform(size=obs.shape) < IN_HOLDOUT)
    seen = np.where(hold, np.nan, obs)
    if hold.sum() != out["n_holdout"]:
        raise RuntimeError(f"hold-out of {out['n_holdout']} entries, expected {hold.sum()}")
    kept = np.isfinite(seen)
    if not np.isfinite(res.filled).all() or not np.array_equal(res.filled[kept], obs[kept]):
        raise RuntimeError("a value is not finite or an observed entry changed")
    clim = np.empty_like(truth)
    for mth in range(12):
        sel = days.month_idx == mth
        clim[:, sel] = np.nanmean(seen[:, sel], axis=1)[:, None]
    mae_clim = float(np.abs(clim - obs)[hold].mean())
    true_norm = np.stack([truth[:, days.month_idx == m].mean(axis=1) for m in range(12)], 1)
    norm_mae = float(np.abs(res.norms - true_norm).mean())
    log(f"[infill] held-out {out['n_holdout']} entries: MAE {out['mae']:.4f} C (climatology "
        f"{mae_clim:.4f} C, ratio {out['mae'] / mae_clim:.4f}), bias {out['bias']:.4f} C, RMSE "
        f"{out['rmse']:.4f} C; monthly normals MAE vs truth {norm_mae:.4f} C; bad stations "
        f"{int(res.bad.sum())}")
    if not (out["mae"] < 0.6 * mae_clim and abs(out["bias"]) < 0.1 and norm_mae < 0.15):
        raise RuntimeError("infill accuracy bars not met")

    # predictor sets of sampled stations against a float64 recompute
    t = time.perf_counter()
    rows = np.sort(np.random.default_rng(8).choice(S, ST_SAMPLE, replace=False))
    score = _scores64(seen, rows, stn_lon, stn_lat)
    n = res.predictors.shape[1]
    n_diff, worst = 0, 0.0
    for i, s in enumerate(rows):
        diff = set(res.predictors[s]) ^ set(np.argsort(-score[i], kind="stable")[:n])
        if diff:
            n_diff += 1
            edge = np.sort(score[i])[::-1][n - 1]
            worst = max(worst, max(abs(score[i, j] - edge) for j in diff))
    log(f"[infill] predictors of {ST_SAMPLE} stations vs the float64 scores: {n_diff} sets "
        f"differ, every difference within {worst:.3e} of the boundary score (tie margin "
        f"{IN_TIE_MARGIN:.0e}; {time.perf_counter() - t:.1f} s)")
    if worst >= IN_TIE_MARGIN:
        raise RuntimeError("predictor sets differ from the float64 ranking away from ties")

    # the first two batches of the schedule: card vs CPU, and one batch of 64
    # vs two of 32 on the card
    mask = np.isfinite(seen)
    tgt = np.argsort(mask.sum(axis=1), kind="stable")[: 2 * params.batch_size]
    cols = np.concatenate([tgt[:, None], res.predictors[tgt]], axis=1)
    Y = np.ascontiguousarray(np.where(mask, seen, 0.0).astype(np.float32)[cols].transpose(0, 2, 1))
    M = np.ascontiguousarray(mask[cols].transpose(0, 2, 1))
    n_comp = min(params.n_components, cols.shape[1] - 1)
    kw = dict(n_components=n_comp, max_iters=params.max_iters, tol=params.tol)
    Yd, Md = torch.from_numpy(Y).to(dev), torch.from_numpy(M).to(dev)
    bs = params.batch_size
    halves = [slice(0, bs), slice(bs, 2 * bs)]
    card = [ppca_impute(Yd[h], Md[h], **kw) for h in halves]
    card = [torch.cat([getattr(r, f) for r in card]).cpu().numpy() for f in ("filled", "n_iters")]
    one = ppca_impute(Yd, Md, **kw)
    b_diff = float(np.abs(one.filled.cpu().numpy() - card[0]).max())
    b_iters = int((one.n_iters.cpu().numpy() != card[1]).sum())
    t = time.perf_counter()
    cpu = ppca_impute(torch.from_numpy(Y), torch.from_numpy(M), **kw)
    cpu_s = time.perf_counter() - t
    d = np.abs(card[0] - cpu.filled.numpy())
    d_it = np.abs(card[1].astype(int) - cpu.n_iters.numpy())
    log(f"[infill] two batches ({len(tgt)} targets) card vs CPU: filled max |diff| "
        f"{d.max():.3e} C, 99.9th pct {np.quantile(d, 0.999):.3e} C (tolerance 5e-2 / "
        f"5e-3 C); n_iters differ at {int((d_it > 0).sum())} targets, max by {d_it.max()} "
        f"(CPU run {cpu_s:.1f} s); on the card one batch of {2 * bs} vs two of {bs}: filled max "
        f"|diff| {b_diff:.3e} C, n_iters differ at {b_iters} ("
        f"{'bit for bit' if b_diff == 0 and b_iters == 0 else 'not bit for bit'})")
    if d.max() > 5e-2 or np.quantile(d, 0.999) > 5e-3 or d_it.max() > 1:
        raise RuntimeError("ppca_impute on the card and on the CPU disagree")

    obs_dev = to_tensor(np.where(mask, seen, 0.0), dev)
    mask_dev = to_tensor(mask, dev, torch.bool)
    midx_dev = to_tensor(days.month_idx, dev, torch.int64)
    cols_dev = torch.from_numpy(cols).to(dev)
    # one batch and 50 iterations: the trace of two batches of 200 (~18,000
    # small kernels) takes the profiler tens of seconds to read
    profile_breakdown("infill", "the EM loop of one batch, 50 iterations", lambda: (
        pipeline._infill_batch(obs_dev, mask_dev, cols_dev[halves[0]], midx_dev, n_comp,
                               50, params.tol)))
    log(f"[infill] phase wall {time.perf_counter() - t_phase:.1f} s")


def _point_against_plain(card, point_core, where, sets, days, params):
    """The point stage's results on the card (``card``: variable -> normal,
    se, ok, daily) against ``point_core`` on CPU tensors, where
    ``krig_normals`` and ``scatter_daily`` run their plain versions on the
    same inputs. ok flags and NaN cells identical; normals and dailies within
    rtol 1e-4 atol 1e-3 C, se within rtol 1e-3 atol 1e-3 C, on at least 99.9 %
    of values and every value within 1e-2 C (``[kernels]``' parity
    tolerance and cap). Returns the largest difference."""
    import torch

    err = 0.0
    for v, got in card.items():
        want = point_core(where, sets[v], days, params, torch.device("cpu"))
        if not np.array_equal(got[2], want[2]):
            raise RuntimeError(f"point {v}: ok flags differ between the card and the CPU")
        for what, g, w, rtol in zip(("normal", "se", "daily"), (got[0], got[1], got[3]),
                                    (want[0], want[1], want[3]), (1e-4, 1e-3, 1e-4)):
            if not np.array_equal(np.isnan(g), np.isnan(w)):
                raise RuntimeError(f"point {v} {what}: NaN cells differ")
            d = np.abs(g - w)[~np.isnan(w)]
            inside = float(np.mean(d <= 1e-3 + rtol * np.abs(w[~np.isnan(w)])))
            if inside < 0.999 or d.max() > 1e-2:
                raise RuntimeError(f"point {v} {what}: {inside:.5f} within tolerance of the "
                                   f"plain version, max {d.max():.3e} C")
            err = max(err, float(d.max()))
    return err


def start_cli_help():
    """``python -m topotpu_torch.cli --help`` in a process of its own, started
    beside the kernel build: its imports took 10.8 s on the card's host when
    run in turn, all of it waiting. ``phase_cli`` reads its result."""
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent
    return subprocess.Popen([sys.executable, "-m", "topotpu_torch.cli", "--help"], cwd=repo,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def phase_cli(dev, helped):
    """The CLI's stages (``topotpu_torch/cli/steps.py``) chained on the card
    in the order ``all --optim-nnghs`` runs them, through the array cores
    between their artifact reads and writes (the card's machine has no
    h5py): synth world -> qa -> homog -> infill -> krig-params ->
    optim-nnghs -> interp (the engine into ``MemoryMosaic``, with the
    optimized k_table) -> mosaic (the direct branch's checks) -> point
    (held against its plain version on the CPU) -> validate (streamed) and
    aggregate over the in-memory mosaic -> validate-f64 (tmin on one tile).
    Each stage consumes the one before it. Full production width: 128 x 128
    tiles, k = 32, a 512-station pool, both variables, the reconcile,
    PPCAParams' defaults; depth cut to the CLI's synthetic world at --grid
    256 --stations 512 over 2015 (four tiles), and validate-f64's tile to
    ``F64_SIDE`` x ``F64_SIDE`` as in ``[f64]``. Also runs
    ``python -m topotpu_torch.cli --help`` (``helped``: the process that
    ``start_cli_help`` started). Returns the launches, and the interp
    stage's inputs (config, rasters, days, station sets, k_table) for the
    [multihost] and [mesh] phases."""
    import dataclasses
    import pathlib
    import tempfile

    import torch

    from topotpu_torch.cli import steps
    from topotpu_torch.core import constants as C
    from topotpu_torch.core.config import TopoConfig
    from topotpu_torch.dist.engine import TileEngine
    from topotpu_torch.dist.multihost import merge_manifests
    from topotpu_torch.geo.regions import make_climate_regions
    from topotpu_torch.interp.point import krig_launches
    from topotpu_torch.io.rasters import RasterStack
    from topotpu_torch.kernels.variogram_fit import variogram_fit

    t_phase = time.perf_counter()
    out, err = helped.communicate(timeout=300)
    if helped.returncode != 0 or "synth-data" not in out:
        raise RuntimeError(f"python -m topotpu_torch.cli --help: exit {helped.returncode}\n"
                           f"{err[-2000:]}")
    log(f"[cli] python -m topotpu_torch.cli --help (started with the build): exit 0, "
        f"{len(out.splitlines())} lines; waited {time.perf_counter() - t_phase:.3f} s for it")

    VARS = (C.TMIN, C.TMAX)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    root = pathlib.Path(tmp.name)
    cfg = TopoConfig(data_dir=str(root), start_date=CLI_START, end_date=CLI_END,
                     stall_timeout_s=60)
    days = steps._days(cfg)
    walls, launches, total = {}, {}, dict.fromkeys(_read_launches(), 0)

    def stage(name, fn):
        """Run one stage with the launch counts from 0; print its report as
        the CLI does, then its launches."""
        _zero_launches()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t
        launches[name] = _read_launches()
        for k, n in launches[name].items():
            total[k] += n
        log("[cli] " + json.dumps({"stage": name, "result": result,
                                    "wall_s": round(walls[name], 2)}, default=str)[:1500])
        return result

    mosaics = {v: root / f"mosaic_{v}.h5" for v in VARS}
    try:
        st = {}

        def synth():
            st["world"], st["attrs"], tmin, tmax = steps._synth_world(
                days, CLI_SIDE, CLI_SIDE, CLI_STATIONS, 0.15, 0, 0.1)
            st["obs"] = {C.TMIN: tmin, C.TMAX: tmax}
            st["rasters"] = RasterStack.from_world(st["world"])
            return "ok"
        stage("synth-data", synth)
        attrs, rasters = st["attrs"], st["rasters"]
        lon, lat = attrs[C.LON], attrs[C.LAT]

        def qa():
            ft, fx, out = steps._qa_core(st["obs"][C.TMIN], st["obs"][C.TMAX], lon, lat, days,
                                         True, rasters, attrs[C.ELEV], attrs[C.STN_ID])
            st["flags"] = {C.TMIN: ft, C.TMAX: fx}
            return out
        stage("qa", qa)

        def homog():
            results, n_breaks = steps._homog_core(st["obs"], st["flags"], days, lon, lat,
                                                  None, dev)
            st["homog"] = {v: r.adjusted_daily for v, r in results.items()}
            return n_breaks
        stage("homog", homog)

        def infill():
            out, st["stn"], st["filled"] = {}, {}, {}
            for v in VARS:
                res, bad, out[v] = steps._infill_core(st["homog"][v], days, cfg.ppca, lon, lat,
                                                      dev)
                # the serial DB's attributes, as write_serial_db writes them
                st["stn"][v] = {**attrs, C.BAD: bad.astype(np.uint8),
                                C.NORM: res.norms.astype(np.float32)}
                st["filled"][v] = res.filled
            return out
        stage("infill", infill)

        def krig_params():
            out = {}
            for v in VARS:
                vario, out[v] = steps._krig_params_core(st["stn"][v], cfg, dev)
                for i, name in enumerate((C.VARIO_NUG, C.VARIO_PSILL, C.VARIO_RNG)):
                    st["stn"][v][name] = vario[..., i]
            return out
        variogram_fit.launches = 0
        stage("krig-params", krig_params)
        total["variogram_fit"] = variogram_fit.launches
        if total["variogram_fit"] != 12 * len(VARS):  # one launch a month and variable
            raise RuntimeError(f"krig-params: {total['variogram_fit']} variogram_fit launches")

        def optim_nnghs():
            reg = make_climate_regions(rasters)  # step_make_regions' defaults
            regions = steps._sample_regions(reg, *rasters.grid.rowcol(lon, lat))
            out = {v: steps._optim_nnghs_core(st["stn"][v], st["filled"][v], regions, days,
                                              cfg, CLI_CANDIDATES, dev) for v in VARS}
            ids = np.unique(reg).astype(np.int32)
            ks = {v: steps._nnghs_k_arrays(out[v], ids, cfg) for v in VARS}
            st["ktab"] = steps._nnghs_table_core(reg.astype(np.int32), ids, ks, rasters, cfg)
            return out
        stage("optim-nnghs", optim_nnghs)
        ktab = st["ktab"]
        sets = {v: steps._station_set_core(st["stn"][v], st["filled"][v], days) for v in VARS}

        def interp():
            eng = memory_engine(cfg, rasters, days, root / "tiles", device=dev,
                               mosaic_paths=mosaics, k_table=ktab)
            st["eng"] = eng
            return steps._interp_core(eng, sets, 0, ktab, "optim-nnghs (in memory)")
        interp_rep = stage("interp", interp)
        store = {v: MemoryMosaic.STORE[mosaics[v]] for v in VARS}

        def mosaic():
            merge_manifests(root / "tiles")
            layout = steps._latest_layout(root / "tiles")
            a = {v: store[v]["attrs"] for v in VARS}
            if layout != "direct" or not all(a[v].get("complete") and a[v].get("reconciled")
                                             for v in VARS):
                raise RuntimeError(f"mosaic: layout {layout}, attrs {a}")
            return {v: a[v]["n_tiles"] for v in VARS}
        stage("mosaic", mosaic)

        land_rc = np.argwhere(rasters.landmask)
        pick = land_rc[np.random.default_rng(5).choice(len(land_rc), CLI_POINTS, replace=False)]
        p_lon, p_lat = rasters.grid.cell_lonlat(pick[:, 0], pick[:, 1])
        sites = list(zip(p_lon.tolist(), p_lat.tolist()))

        where = steps._point_sites(rasters, sites)

        def point():
            out, st["point"] = {}, {}
            for v in VARS:
                st["point"][v] = normal, _, ok, daily = steps._point_core(
                    where, sets[v], days, cfg.interp, dev)
                if not (np.isfinite(daily).all() and ok.all()):
                    raise RuntimeError(f"point {v}: {int(ok.all(0).sum())} of {len(sites)} ok")
                out[v] = {"sites": len(sites), "ok_sites": int(ok.all(0).sum()),
                          "annual_normal": [round(float(x), 2) for x in normal.mean(0)]}
            return out
        stage("point", point)
        point_err = _point_against_plain(st["point"], steps._point_core, where, sets, days,
                                         cfg.interp)

        def validate():
            res = steps._streamed_core(
                cfg, root / "tiles", rasters,
                {v: {v: store[v]["daily"], "normal": store[v]["normal"]} for v in VARS})
            if res is None or any(res[v]["status"] != "ok" for v in VARS):
                raise RuntimeError(f"validate: {res}")
            return res
        stage("validate", validate)

        def aggregate():
            means = {name: {} for name in ("monthly", "annual")}
            for name, i, plane in steps._aggregate_core(store[C.TMIN]["daily"], days.date64):
                means[name][i] = plane
            st["agg"] = means
            return {C.TMIN: {"months": len(means["monthly"]), "years": len(means["annual"])}}
        stage("aggregate", aggregate)

        def validate_f64():
            # one tile of F64_SIDE x F64_SIDE, as [f64]: the production tile's
            # float64 side takes 9-32 s on the card's host
            f64_cfg = dataclasses.replace(cfg, tile_rows=F64_SIDE, tile_cols=F64_SIDE)
            eng = TileEngine(f64_cfg, rasters, days, root / "tiles_f64", device=dev)
            res = steps._validate_f64_core(eng, sets[C.TMIN], 1, f64_cfg, dev)
            if res["tiles"] != 1 or not res["within_parity_bar"]:
                raise RuntimeError(f"validate-f64: {res}")
            return {C.TMIN: res}
        stage("validate-f64", validate_f64)

        # checks
        tiles = list(st["eng"].tiling.land_tiles(rasters.landmask))
        n = len(tiles)
        man = json.loads((root / "tiles" / "manifest.json").read_text())["tiles"]
        for t in tiles:
            land = int(rasters.landmask[t.row0:t.row0 + t.nrows, t.col0:t.col0 + t.ncols].sum())
            for v in VARS:
                info = man.get(f"{v}_{t.tile_id:05d}")
                want_k = list(ktab[t.tile_id][v]) if t.tile_id in ktab else None
                if (info is None or info["verify"]["viol"] != 0
                        or info["verify"]["covered"] != land or info.get("k") != want_k):
                    raise RuntimeError(f"manifest {v} tile {t.tile_id}: {info}")
        zero = dict.fromkeys(_read_launches(), 0)
        want = {name: zero for name in launches}
        want["optim-nnghs"] = dict(zero, krig_normals=2 * (
            len(CLI_CANDIDATES) + sum(k <= cfg.interp.k_neighbors for k in CLI_CANDIDATES)))
        want["interp"] = dict(zero, scatter_daily_packed=n, krig_normals=sum(
            krig_launches(st["eng"]._params_for(t, *VARS) or cfg.interp, len(VARS))
            for t in tiles))
        want["point"] = dict(zero, krig_normals=2, scatter_daily=2)
        want["validate-f64"] = dict(zero, krig_normals=1, scatter_daily=1)
        if launches != want:
            raise RuntimeError(f"launches by stage {launches}, expected {want}")
        if interp_rep[C.TMIN] != n or interp_rep[C.TMAX] != n:
            raise RuntimeError(f"interp {interp_rep}, {n} land tiles")
        lo, hi = store[C.TMIN]["daily"], store[C.TMAX]["daily"]
        both = (lo != -32768) & (hi != -32768)
        if (hi[both] < lo[both]).any():  # one lattice for both: raw order is value order
            raise RuntimeError(f"{int((hi[both] < lo[both]).sum())} decoded cells tmax < tmin")
        land_cells = np.flatnonzero(rasters.landmask.ravel())
        cells = np.random.default_rng(11).choice(land_cells, min(CLI_TRUTH_CELLS, land_cells.size),
                                                 replace=False)
        rows, cols = np.unravel_index(cells, rasters.landmask.shape)
        world = st["world"]
        c_lon, c_lat = world.grid.cell_lonlat(rows, cols)
        # the chain estimates its normals from one year of observations, so
        # the truth is the world's normal plus the mean of its noise-free
        # anomaly field over July 2015 (about 1 C here; the anomalies are
        # zero-mean over the span, not a month)
        normal = world.true_normal(c_lon, c_lat, world.elev[rows, cols], world.tdi[rows, cols],
                                   world.lst[6, rows, cols], 7)
        truth = normal + world.anom_field_fn(c_lon, c_lat)[:, days.month_idx == 6].mean(1)
        got_jul = store[C.TMIN]["normal"][6][rows, cols]
        mae = float(np.mean(np.abs(got_jul - truth)))
        mae_normal = float(np.mean(np.abs(got_jul - normal)))
        if not mae < 0.3:
            raise RuntimeError(f"July normals MAE vs truth {mae:.4f} C")
        sc = store[C.TMIN]["attrs"]["scale_factor"]
        off = store[C.TMIN]["attrs"]["add_offset"]
        dec = np.where(lo != -32768, lo.astype(np.float32) * np.float32(sc) + np.float32(off),
                       np.nan)
        m0 = days.month_idx == days.month_idx[0]
        blk = dec[m0]
        ref = np.where(np.isfinite(blk).all(0), blk.mean(0), np.nan)
        q = st["agg"]["monthly"][0]
        got = np.where(q != -32768, q.astype(np.float32) * np.float32(sc) + np.float32(off), np.nan)
        if not (np.array_equal(np.isfinite(ref), np.isfinite(got))
                and np.abs(got - ref)[np.isfinite(ref)].max() <= sc + 1e-6):
            raise RuntimeError("aggregate: the first month is not the daily mosaic's mean")
    finally:
        for path in mosaics.values():
            MemoryMosaic.STORE.pop(path, None)
        tmp.cleanup()
    log(f"[cli] chain {CLI_SIDE}x{CLI_SIDE}, {CLI_STATIONS} stations, {days.ndays} days, "
        f"{n} tiles of {cfg.tile_rows}x{cfg.tile_cols}, k={cfg.interp.k_neighbors}, pool "
        f"{cfg.interp.max_tile_stations}, PPCA q={cfg.ppca.n_components} / "
        f"{cfg.ppca.n_neighbors} predictors / {cfg.ppca.max_iters} iterations, k_table on "
        f"{len(ktab)} tiles: walls " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; launches by stage {json.dumps(launches)}; checks: manifests, viol 0, k recorded, "
        f"launches as the tiles and the k_table give, no tmax < tmin, validate ok, July normals "
        f"MAE vs truth {mae:.4f} C ({cells.size} cells; {mae_normal:.4f} C vs the world's normal "
        f"without the year's anomaly), first month's aggregate = the daily "
        f"mean within one lattice step, point vs its plain version on the CPU max |diff| "
        f"{point_err:.3e} C, validate-f64 within the 0.05 C bar "
        f"({time.perf_counter() - t_phase:.1f} s in all)")
    return total, dict(cfg=cfg, rasters=rasters, days=days, sets=sets, ktab=ktab)


def phase_mesh(world, days, dev, cli):
    """The cell-sharded step (``dist/mesh.py``) on two shards of the one card,
    ``make_mesh(devices=[dev, dev])``, at full width: one 128 x 128 tile of
    phase 4's world, k = 32, the 512-station pool, both variables, the
    reconcile. ``sharded_interp_tile_pair_flat`` with the dynamic lattice
    (the reduction over the shards) and with the fixed one: each product
    bit for bit against the single-device step on the same inputs (int16
    buffer and scales), the launches of each shard (one ``krig_normals``,
    one float ``scatter_daily`` or one packed) and the reductions counted,
    and both forms' walls in turns. Then the two ways to fetch the sharded
    product (gathered on the first device and copied once, or one copy and
    one event a shard into one pinned buffer, then the columns put in order
    on the host), in turns. Then ``TileEngine.run_pair`` over the [cli]
    world's four tiles (``cli``: what ``phase_cli`` returns), with that mesh
    and with the one device, each twice, into ``MemoryMosaic``: mosaics and
    manifests equal bit for bit. Returns the launches of the sharded runs."""
    import pathlib
    import tempfile

    import torch

    from topotpu_torch.core import constants as C
    from topotpu_torch.core.config import InterpParams, TopoConfig
    from topotpu_torch.dist import mesh as tmesh
    from topotpu_torch.interp.convert import fixed_scales_from_config
    from topotpu_torch.interp.point import interp_tile_pair_flat, krig_launches
    from topotpu_torch.io.synthetic import tile_inputs_from_world

    t_phase = time.perf_counter()
    rows, cols = np.unravel_index(np.arange(MESH_SIDE * MESH_SIDE), (MESH_SIDE, MESH_SIDE))
    ti, layout = tile_inputs_from_world(world, days.month_idx, rows, cols, dev)
    pair = _pair(ti, 9.0, 0.85)
    params = InterpParams(k_neighbors=K)
    fixed = torch.as_tensor(fixed_scales_from_config(TopoConfig(), 2), device=dev)
    slot = torch.as_tensor(layout.slot_of_day.astype(np.int32), device=dev)
    mesh = tmesh.make_mesh(devices=[dev, dev])
    shards = tmesh.shard_pair_inputs(mesh, pair)
    total = dict.fromkeys(_read_launches(), 0)
    lines = []
    for lattice, fx in (("dynamic", None), ("fixed", fixed)):
        fn = tmesh.sharded_interp_tile_pair_flat(mesh, params, True, fixed=fx is not None,
                                                 reconcile=True)
        split = (lambda: fn(shards, slot, fx)) if fx is not None else (lambda: fn(shards, slot))
        single = lambda: interp_tile_pair_flat(  # noqa: E731
            pair, slot, params, True, fixed_scales=fx, reconcile=True)
        want = single()
        reductions = tmesh._pmin_pmax.calls
        _zero_launches()
        got = split()
        torch.cuda.synchronize()
        launches = _read_launches()
        reductions = tmesh._pmin_pmax.calls - reductions
        for k, n in launches.items():
            total[k] += n
        expect = dict(krig_normals=2, scatter_daily=0 if fx is not None else 2,
                      scatter_daily_packed=2 if fx is not None else 0)
        if launches != expect or reductions != (0 if fx is not None else 1):
            raise RuntimeError(f"[mesh] {lattice}: launches {launches}, expected {expect}; "
                               f"{reductions} reductions")
        if not (torch.equal(got.buf, want.buf) and torch.equal(got.scales, want.scales)):
            diff = int((got.buf != want.buf).sum())
            raise RuntimeError(f"[mesh] {lattice}: the two-shard product differs from the "
                               f"single-device step in {diff} values")
        walls = {"one device": [], "two shards": []}
        for _ in range(MESH_REPS):
            for name, f in (("one device", single), ("two shards", split)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                f()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t) * 1e3)
        med = {k: float(np.median(v)) for k, v in walls.items()}
        lines.append(f"{lattice} lattice: bit for bit (buffer {tuple(got.buf.shape)} int16 and "
                     f"scales), launches of the two shards {launches}, {reductions} reduction; "
                     f"step wall one device {med['one device']:.3f} ms, two shards "
                     f"{med['two shards']:.3f} ms (medians of {MESH_REPS}, in turns; "
                     + ", ".join(f"{k} " + " ".join(f"{w:.3f}" for w in v)
                                 for k, v in walls.items()) + ")")
    log(f"[mesh] sharded_interp_tile_pair_flat, mesh [{dev}, {dev}], one {MESH_SIDE}x{MESH_SIDE} "
        f"tile, {N_STATIONS} stations, k={K}, {NDAYS} days, 2 variables, reconcile: "
        + "; ".join(lines))

    # the fetch of the sharded product: gathered on the first device then one
    # copy and one event, or a copy and an event a shard into one pinned
    # buffer, then the columns in order on the host
    outs = [tmesh._pair_fixed_adapter(p, slot, fixed, params=params, shared_validity=True,
                                      reconcile=True) for p in shards]
    torch.cuda.synchronize()
    rows_n, half = outs[0].buf.shape
    gathered = torch.empty((rows_n, 2 * half), dtype=torch.int16, pin_memory=True)
    per_shard = torch.empty((2, rows_n, half), dtype=torch.int16, pin_memory=True)

    def fetch_gathered():
        gathered.copy_(torch.cat([o.buf for o in outs], dim=1), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return gathered.numpy()

    def fetch_per_shard():
        events = []
        for j, o in enumerate(outs):
            per_shard[j].copy_(o.buf, non_blocking=True)
            events.append(torch.cuda.Event())
            events[-1].record()
        for e in events:
            e.synchronize()
        return np.concatenate(list(per_shard.numpy()), axis=1)

    if not np.array_equal(fetch_gathered(), fetch_per_shard()):
        raise RuntimeError("[mesh] the two fetches of the sharded product differ")
    fetch = {"gathered": [], "per shard": []}
    for _ in range(10):
        for name, f in (("gathered", fetch_gathered), ("per shard", fetch_per_shard)):
            t = time.perf_counter()
            f()
            fetch[name].append((time.perf_counter() - t) * 1e3)
    log(f"[mesh] fetch of the two-shard product ({rows_n} x {2 * half} int16, "
        f"{rows_n * 2 * half * 2 / 2**20:.1f} MiB) into pinned host memory, medians of 10 in "
        f"turns: gathered on {dev} + one copy + one event {np.median(fetch['gathered']):.3f} ms, "
        f"one copy + one event a shard + host column order {np.median(fetch['per shard']):.3f} ms")
    del outs, shards, pair, ti

    # the engine over the [cli] world with the two-shard mesh and with one device
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_")
    root = pathlib.Path(tmp.name)
    VARS = (C.TMIN, C.TMAX)
    results, walls = {}, {"one device": [], "two shards": []}
    try:
        for rep in range(2):
            for name, kw in (("one device", dict(device=dev)), ("two shards", dict(mesh=mesh))):
                out = root / f"{name.replace(' ', '_')}_{rep}"
                mosaics = {v: out / f"mosaic_{v}.h5" for v in VARS}
                eng = memory_engine(cli["cfg"], cli["rasters"], cli["days"], out / "tiles",
                                   mosaic_paths=mosaics, k_table=cli["ktab"], **kw)
                _zero_launches()
                t = time.perf_counter()
                counts = eng.run_pair(C.TMIN, C.TMAX, cli["sets"][C.TMIN], cli["sets"][C.TMAX],
                                      progress=False)
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t)
                launches = _read_launches()
                store = {v: MemoryMosaic.STORE.pop(mosaics[v]) for v in VARS}
                man = json.loads((out / "tiles" / "manifest.json").read_text())["tiles"]
                for info in man.values():
                    del info["ts"]
                results[name, rep] = (counts, store, man, launches)
                if name == "two shards":
                    for k, n in launches.items():
                        total[k] += n
        tiles = list(eng.tiling.land_tiles(cli["rasters"].landmask))
        krig = sum(krig_launches(eng._params_for(t, *VARS) or cli["cfg"].interp, len(VARS))
                   for t in tiles)
        for rep in range(2):
            one, two = results["one device", rep], results["two shards", rep]
            want = dict(krig_normals=2 * krig, scatter_daily=0, scatter_daily_packed=2 * len(tiles))
            if two[3] != want or two[0] != one[0] or one[0] != {v: len(tiles) for v in VARS}:
                raise RuntimeError(f"[mesh] engine: counts {two[0]} / {one[0]}, launches "
                                   f"{two[3]}, expected {want}")
            for v in VARS:
                for key in ("daily", "normal", "se"):
                    if not np.array_equal(one[1][v][key], two[1][v][key], equal_nan=True):
                        raise RuntimeError(f"[mesh] engine: the two-shard {v} {key} differs")
                if one[1][v]["attrs"] != two[1][v]["attrs"]:
                    raise RuntimeError(f"[mesh] engine: {v} attrs {two[1][v]['attrs']}")
            if one[2] != two[2]:
                raise RuntimeError("[mesh] engine: the manifests differ")
    finally:
        tmp.cleanup()
    var_cells = 2 * cli["cfg"].tile_rows * cli["cfg"].tile_cols * len(tiles)
    log(f"[mesh] TileEngine.run_pair over the [cli] world ({len(tiles)} tiles of "
        f"{cli['cfg'].tile_rows}x{cli['cfg'].tile_cols}, its k_table on "
        f"{len(cli['ktab'])} tiles), each run twice in turns: one device "
        + " ".join(f"{w:.3f}" for w in walls["one device"]) + " s ("
        + " ".join(f"{var_cells / w:.1f}" for w in walls["one device"])
        + " var-cells/s), two shards " + " ".join(f"{w:.3f}" for w in walls["two shards"])
        + " s (" + " ".join(f"{var_cells / w:.1f}" for w in walls["two shards"])
        + f" var-cells/s); launches of a two-shard run {results['two shards', 1][3]}; mosaics, "
        f"attributes and manifests bit for bit ({time.perf_counter() - t_phase:.1f} s in all)")
    return total


def start_multihost():
    """Start ``MH_PROCESSES`` workers of this script (``multihost_worker``),
    beside the kernel build's end: each imports torch, takes its device
    (``local_mesh``: both take the one card), joins the process group by
    gloo and waits for the [cli] world's inputs. Process 0 serves the
    rendezvous on a listening socket bound here, so no other program can
    take the port first. Their output goes to files (a pipe left unread
    could fill and block them). Returns what ``phase_multihost`` needs."""
    import pathlib
    import socket
    import tempfile

    from topotpu_torch.dist.multihost import COORDINATOR_FD_ENV

    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_multihost_"))
    repo = pathlib.Path(__file__).resolve().parent
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen()
    coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    workers = dict(procs=[], root=root, coordinator=coordinator)
    try:
        for rank in range(MH_PROCESSES):
            env = dict(os.environ)
            if rank == 0:
                env[COORDINATOR_FD_ENV] = str(sock.fileno())
            with open(root / f"worker{rank}.log", "w") as out:
                workers["procs"].append(subprocess.Popen(
                    [sys.executable, str(repo / "chip_smoke.py"), "_multihost_worker", str(rank),
                     coordinator, str(root), repr(time.time())],
                    cwd=repo, env=env, pass_fds=(sock.fileno(),) if rank == 0 else (),
                    stdout=out, stderr=subprocess.STDOUT, text=True))
    except BaseException:
        stop_multihost(workers)
        raise
    finally:
        sock.close()
    return workers


def stop_multihost(workers):
    """Kill the workers that still run and remove their directory."""
    for proc in workers["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(workers["root"], ignore_errors=True)


def _mh_inputs(root):
    return root / "inputs.pkl"


def _shard_file(root, var, rank):
    return root / f"shard_{var}_p{rank:03d}.npz"


def multihost_worker(rank, coordinator, root, spawned_at):
    """One process of ``phase_multihost`` (``python3 chip_smoke.py
    _multihost_worker RANK COORDINATOR DIR SPAWNED_AT``): ``init_multihost``,
    its device from ``local_mesh``, then, once the parent has written the
    [cli] world's inputs, ``TileEngine.run_production_pair`` over its strided
    tiles into its own ``MemoryMosaic`` shard and manifest; the shard goes to
    a file, then a barrier; the coordinator merges the manifests and
    assembles the shards tile by tile as ``build_virtual_mosaic`` maps them
    (tile_id % P). Prints one JSON line: its walls and launches."""
    import pathlib
    import pickle

    import torch
    import torch.distributed as dist

    from topotpu_torch.core import constants as C
    from topotpu_torch.dist import multihost
    from topotpu_torch.kernels import _build

    root = pathlib.Path(root)
    for name in ("krig_normals", "scatter_daily"):  # built by the parent: never twice
        if not _build.library_path(name).is_file():
            raise RuntimeError(f"{name}: the parent's build is missing")
    ctx = multihost.init_multihost(coordinator, MH_PROCESSES, rank)
    mesh = multihost.local_mesh()
    torch.zeros(1, device=mesh.devices[0])  # the CUDA context, before the inputs come
    ready = time.time() - spawned_at
    t_wait = time.perf_counter()
    while not _mh_inputs(root).exists():
        if time.perf_counter() - t_wait > MH_TIMEOUT_S:
            raise RuntimeError("no inputs from the parent")
        time.sleep(0.05)
    waited = time.perf_counter() - t_wait
    with open(_mh_inputs(root), "rb") as f:  # written by the parent process
        cli = pickle.load(f)

    VARS = (C.TMIN, C.TMAX)
    mosaics = {v: root / f"mosaic_{v}.h5" for v in VARS}
    eng = memory_engine(cli["cfg"], cli["rasters"], cli["days"], root / "tiles", ctx=ctx,
                       mosaic_paths=mosaics, k_table=cli["ktab"])
    _zero_launches()
    t = time.perf_counter()
    # returns once every tile is written: every step and fetch has ended
    counts = eng.run_production_pair(C.TMIN, C.TMAX, cli["sets"][C.TMIN], cli["sets"][C.TMAX],
                                     years_per_chunk=1, progress=False)
    run = time.perf_counter() - t
    launches = _read_launches()
    for v in VARS:
        store = MemoryMosaic.STORE.pop(eng._mosaic_path(v))
        np.savez(_shard_file(root, v, rank), daily=store["daily"], normal=store["normal"],
                 se=store["se"], attrs=json.dumps(store["attrs"]))
    multihost.barrier("shards written")
    assembled = None
    if ctx.is_coordinator:
        t = time.perf_counter()
        for chunk in sorted((root / "tiles").glob("chunk_*_*")):
            multihost.merge_manifests(chunk)
        tiles = list(eng.tiling.land_tiles(cli["rasters"].landmask))
        for v in VARS:
            shards = [np.load(_shard_file(root, v, i)) for i in range(MH_PROCESSES)]
            for i, sh in enumerate(shards):
                attrs = json.loads(str(sh["attrs"]))
                if not (attrs.get("complete") and attrs["process_index"] == i
                        and attrs["process_count"] == MH_PROCESSES):
                    raise RuntimeError(f"shard {v} p{i}: attrs {attrs}")
            out = {k: np.array(shards[0][k]) for k in ("daily", "normal", "se")}
            out["normal"][:] = out["se"][:] = np.nan
            out["daily"][:] = -32768
            for ts in tiles:
                sl = (slice(None), slice(ts.row0, ts.row0 + ts.nrows),
                      slice(ts.col0, ts.col0 + ts.ncols))
                for k in out:
                    out[k][sl] = shards[ts.tile_id % MH_PROCESSES][k][sl]
            n_tiles = sum(json.loads(str(sh["attrs"]))["n_tiles"] for sh in shards)
            np.savez(root / f"assembled_{v}.npz", n_tiles=n_tiles, **out)
        assembled = time.perf_counter() - t
    dist.destroy_process_group()
    print(json.dumps(dict(rank=rank, device=str(mesh.devices), startup_s=ready,
                          waited_s=waited, run_s=run, assemble_s=assembled,
                          tiles=counts, launches=launches)), flush=True)


def phase_multihost(workers, dev, cli):
    """Two OS processes on the one card (both ``cuda:0``, joined by gloo),
    each ``TileEngine.run_production_pair`` over its strided tiles of the
    [cli] world into its own ``MemoryMosaic`` shard and manifest; the
    coordinator assembles them (see ``multihost_worker``). Here: the
    workers get the inputs, this process runs the one-process engine on
    them meanwhile, and the assembled mosaics and the merged manifest are
    held bit for bit against it. A failure in either worker fails the
    phase. Returns the workers' launches."""
    import pickle

    from topotpu_torch.core import constants as C

    t_phase = time.perf_counter()
    root = workers["root"]
    tmp = root / "inputs.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(cli, f)
    tmp.replace(_mh_inputs(root))

    VARS = (C.TMIN, C.TMAX)
    ref_root = root / "one_process"
    mosaics = {v: ref_root / f"mosaic_{v}.h5" for v in VARS}
    eng = memory_engine(cli["cfg"], cli["rasters"], cli["days"], ref_root / "tiles", device=dev,
                       mosaic_paths=mosaics, k_table=cli["ktab"])
    _zero_launches()
    t = time.perf_counter()
    counts = eng.run_production_pair(C.TMIN, C.TMAX, cli["sets"][C.TMIN], cli["sets"][C.TMAX],
                                     years_per_chunk=1, progress=False)
    ref_wall = time.perf_counter() - t
    ref_launches = _read_launches()
    ref = {v: MemoryMosaic.STORE.pop(mosaics[v]) for v in VARS}

    reports = []
    for rank, proc in enumerate(workers["procs"]):
        try:
            proc.wait(timeout=MH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        out = (root / f"worker{rank}.log").read_text()
        if proc.returncode != 0:
            raise RuntimeError(f"[multihost] worker {rank} exited {proc.returncode}:\n"
                               f"{out[-3000:]}")
        reports.append(json.loads(out.strip().splitlines()[-1]))
    for v in VARS:
        got = np.load(root / f"assembled_{v}.npz")
        for key in ("daily", "normal", "se"):
            if not np.array_equal(got[key], ref[v][key], equal_nan=True):
                raise RuntimeError(f"[multihost] the assembled {v} {key} differs from the "
                                   f"one-process run in {int((got[key] != ref[v][key]).sum())}"
                                   " values")
        if int(got["n_tiles"]) != ref[v]["attrs"]["n_tiles"]:
            raise RuntimeError(f"[multihost] {v}: {int(got['n_tiles'])} tiles in the shards")
    chunks = sorted(p.name for p in (ref_root / "tiles").glob("chunk_*_*"))
    for chunk in chunks:
        mans = []
        for d in (root / "tiles" / chunk, ref_root / "tiles" / chunk):
            man = json.loads((d / "manifest.json").read_text())["tiles"]
            for info in man.values():
                del info["ts"]
                info["file"] = re.sub(r"_p\d{3}(?=\.h5$)", "", info["file"])
            mans.append(man)
        if mans[0] != mans[1]:
            raise RuntimeError(f"[multihost] {chunk}: the merged manifest differs")
    for rank, rep in enumerate(reports):
        owned = {v: len([t for t in eng.tiling.land_tiles(cli["rasters"].landmask)
                         if t.tile_id % MH_PROCESSES == rank]) for v in VARS}
        if rep["tiles"] != owned:
            raise RuntimeError(f"[multihost] worker {rank} made {rep['tiles']}, owns {owned}")
    total = dict.fromkeys(_read_launches(), 0)
    for rep in reports:
        for k, n in rep["launches"].items():
            total[k] += n
    if total != ref_launches:
        raise RuntimeError(f"[multihost] the workers launched {total}, the one-process run "
                           f"{ref_launches}")
    log(f"[multihost] {MH_PROCESSES} processes on {dev} (gloo, rendezvous at "
        f"{workers['coordinator']} on a socket held from the start), each "
        f"run_production_pair over its strided tiles of the [cli] world into its own "
        f"MemoryMosaic shard and manifest_pNNN.json: "
        + "; ".join(f"worker {r['rank']} on {r['device']}: ready {r['startup_s']:.3f} s after "
                    f"its start (imports, CUDA, rendezvous), waited {r['waited_s']:.3f} s for "
                    f"the inputs, run {r['run_s']:.3f} s, tiles {r['tiles']}, launches "
                    f"{r['launches']}" + (f", assembled the shards in {r['assemble_s']:.3f} s"
                                          if r["assemble_s"] is not None else "")
                    for r in reports)
        + f"; one-process run {counts} in {ref_wall:.3f} s, launches {ref_launches}; merged "
        f"manifests of {chunks} and "
        f"the assembled mosaics bit for bit against it ({time.perf_counter() - t_phase:.1f} s "
        f"in all)")
    return total


def main():
    if sys.argv[1:2] == ["_multihost_worker"]:
        rank, coordinator, root, spawned_at = sys.argv[2:]
        multihost_worker(int(rank), coordinator, root, float(spawned_at))
        return
    mode = sys.argv[1] if sys.argv[1:] else "all"
    if mode not in ("all", "kernels", "scatter", "ok_solve") or sys.argv[2:]:
        raise SystemExit(f"unknown arguments {sys.argv[1:]}: none, 'kernels', 'scatter' "
                         f"or 'ok_solve'")
    t_start = time.perf_counter()
    dev, name = phase_environment()
    t_phase = [time.perf_counter()]

    def lap(name):
        t_phase.append(time.perf_counter())
        log(f"[phase] {name} took {t_phase[-1] - t_phase[-2]:.1f} s")

    helped = start_cli_help() if mode == "all" else None
    workers = {}
    try:
        run_phases(mode, dev, name, helped, workers, t_start, lap)
    finally:
        if helped is not None and helped.poll() is None:
            helped.kill()
            helped.wait()
        if workers:
            stop_multihost(workers)


def run_phases(mode, dev, name, helped, workers, t_start, lap):
    from topotpu_torch.core.dates import get_days_metadata
    from topotpu_torch.io.synthetic import make_world

    from concurrent.futures import ThreadPoolExecutor

    names = dict(scatter=("scatter_daily",), ok_solve=("ok_solve",)).get(mode, KERNELS)
    # the whole run first needs the OK solve's library after the kernels
    # phase: its nvcc starts with the others and is waited for there
    late = ("ok_solve",) if mode == "all" else ()
    pool = ThreadPoolExecutor(2)  # build threads wait on nvcc processes
    build = pool.submit(phase_build, tuple(n for n in names if n not in late))
    late_build = pool.submit(phase_build, late) if late else None
    pool.shutdown(wait=False)  # the builds submitted run to their end
    st_prebuilt = stations_world() if mode == "all" else None
    for ln in build.result():
        log(ln)
    if mode == "all":  # their start-up overlaps the phases before [multihost]
        workers.update(start_multihost())
    lap("build" + (", the station phase's world" if st_prebuilt else ""))
    world = make_world(np.random.default_rng(0), nrows=N_SIDE, ncols=N_SIDE,
                       n_stations=N_STATIONS, ndays=NDAYS)
    days = get_days_metadata("2015-01-01", "2015-12-31")
    rows64 = neighbour_planes(world)
    if mode == "scatter":
        scatter_lines(rows64, dev)
        return
    if mode == "ok_solve":
        phase_ok_solve(rows64, dev)
        return
    report = phase_kernels(world, days, rows64, dev)
    lap("kernels")
    normals_report, normals_launches = phase_normals(world, days, dev)
    report.update(normals_report)
    lap("normals")
    if mode == "kernels":
        return
    for ln in late_build.result():
        log(ln)
    ok_report, ok_launches = phase_ok_solve(rows64, dev)
    del rows64
    launches, step = phase_slice(world, days, dev)
    for more in (phase_per_var(world, days, dev), phase_reconcile(world, days, dev),
                 phase_f64(world, days, dev)):
        for kernel, n in more.items():
            launches[kernel] += n
    phase_profile(step)
    del step
    lap("ok_solve, slice, per-var, reconcile, f64, profile")
    for kernel, n in phase_engine(dev).items():
        launches[kernel] += n
    lap("engine")
    st_launches, launches["variogram_fit"], st_world = phase_stations(dev, st_prebuilt)
    del st_prebuilt
    launches["krig_normals"] += st_launches
    lap("stations")
    phase_station_qa(dev)
    lap("qa, homog, regions")
    phase_infill(st_world, dev)
    del st_world
    lap("infill")
    cli_launches, cli = phase_cli(dev, helped)
    for kernel, n in cli_launches.items():
        launches[kernel] += n
    lap("cli")
    for kernel, n in phase_multihost(workers, dev, cli).items():
        launches[kernel] += n
    lap("multihost")
    for kernel, n in phase_mesh(world, days, dev, cli).items():
        launches[kernel] += n
    del cli
    lap("mesh")
    launches.update(ok_launches)
    launches.update(normals_launches)
    report.update(ok_report)

    import torch

    sources = dict(
        krig_normals=("topotpu_torch/kernels/csrc/krig_normals.cu",
                      "topotpu/kernels/pallas_krig.py:445"),
        krig_normals_gathered=("topotpu_torch/kernels/csrc/krig_normals.cu",
                               "topotpu/kernels/pallas_krig.py:445"),
        scatter_daily=("topotpu_torch/kernels/csrc/scatter_daily.cu",
                       "topotpu/kernels/pallas_scatter.py:67"),
        scatter_daily_packed=("topotpu_torch/kernels/csrc/scatter_daily.cu",
                              "topotpu/kernels/pallas_scatter.py:67"),
        ok_solve_fused=("topotpu_torch/kernels/csrc/ok_solve.cu",
                        "topotpu/kernels/pallas_krig.py:584"),
        ok_solve_fused_xyz=("topotpu_torch/kernels/csrc/ok_solve.cu",
                            "topotpu/kernels/pallas_krig.py:608"),
        variogram_fit=("topotpu_torch/kernels/csrc/variogram_fit.cu",
                       None),  # replaces no TPU kernel: XLA runs the JAX package's loop
    )
    kernels = [
        dict(name=k, route="cuda", source=src, replaces=rep, launches=launches[k],
             **report[k])
        for k, (src, rep) in sources.items()
    ]
    log(f"[total] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
