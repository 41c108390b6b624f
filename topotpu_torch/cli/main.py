"""topotpu_torch pipeline CLI (the port of ``topotpu.cli.main``).

Parity target: the reference's run-this-then-that shell pipeline of numbered
``bin/step*.py`` scripts (SURVEY.md §2.18, L6). One entry point:

    python -m topotpu_torch.cli <stage> [--config cfg.json] [stage options]

Stages (in pipeline order):
    synth-data   generate synthetic rasters + obs DB (no-network stand-in)
    download     fetch GHCN-D raw data (needs network)
    build-db     parse raw files -> all_obs.h5
    qa           flag observations (non-spatial + spatial checks)
    homog        pairwise homogenization -> homog.h5
    infill       PPCA serial completion -> serial_{var}.h5
    krig-params  per-station variogram fits -> serial DB attrs
    interp       gridded tile interpolation -> tiles/
    mosaic       merge tiles -> mosaic_{var}.h5
    validate     output integrity / coverage report
    validate-f64 re-run sample tiles at float64 on CPU, report f32 error
    all          synth-data .. validate in sequence; RELAUNCH-SAFE: stages
                 whose output artifact is complete are skipped (the artifact
                 chain is the checkpoint, SURVEY §5), interp additionally
                 resumes tile-by-tile from its manifests; --redo forces a
                 full re-run
    xval-interp  leave-one-station-out normals scores
    xval-infill  hold-out infill scores

Device: the first CUDA device, taken by the first stage that needs one;
interp steps over this process's share of the visible devices (its mesh,
``config.mesh.n_devices`` of them). There is no fallback to the CPU, which
runs only when TOPOTPU_PLATFORM=cpu is set.

Several processes: start ``interp`` once a process, each with
``--coordinator host:port --num-processes N --process-id i``; process 0
serves the rendezvous (``torch.distributed``, gloo) at that address. Each
interpolates the tiles with ``tile_id % N == i``; then one ``mosaic`` run
merges the manifests and publishes the mosaic over the processes' shards.
A process whose share of the host's GPUs is one card
(``dist.multihost.local_devices``) makes it current before any CUDA work.

The artifacts are the JAX package's (``python -m topotpu.cli``), so either
CLI reads, resumes and finishes a data_dir that the other wrote.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import sys

from topotpu_torch.core.config import TopoConfig
from topotpu_torch.core.device import platform_devices


def _load_config(path: str | None) -> TopoConfig:
    if path:
        return TopoConfig.load(path)
    default = pathlib.Path("topotpu.json")
    if default.exists():
        return TopoConfig.load(default)
    return TopoConfig()


def _device():
    """``TOPOTPU_PLATFORM=cpu``: the CPU. Anything else, or nothing: the first
    CUDA device (``platform_devices`` raises where there is none)."""
    return platform_devices()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="topotpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("stage", choices=[
        "synth-data", "download", "build-db", "qa", "homog", "infill",
        "krig-params", "interp", "mosaic", "validate", "validate-f64", "all",
        "xval-interp", "xval-daily", "xval-infill", "optim-nnghs", "point",
        "make-regions", "aggregate",
    ])
    ap.add_argument("--config", help="TopoConfig JSON path")
    ap.add_argument("--data-dir", help="override config.data_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stations", type=int, default=250, help="synth-data station count")
    ap.add_argument("--grid", type=int, default=96, help="synth-data grid size")
    ap.add_argument("--chunk-years", type=int, default=0,
                    help="interp: years per production chunk (0 = single span)")
    ap.add_argument("--coordinator", default=None,
                    help="interp: coordinator host:port of a multi-process "
                         "job (process 0 serves the rendezvous there)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="interp: total processes in the job")
    ap.add_argument("--process-id", type=int, default=None,
                    help="interp: this process's rank [0, num-processes)")
    ap.add_argument("--regions", default=None,
                    help="optim-nnghs: HDF5 region raster (int 'regions' "
                         "dataset on the run grid, e.g. climate divisions); "
                         "default: data_dir/regions.h5 if present (see "
                         "make-regions), else covariate-clustered regions "
                         "built on the fly")
    ap.add_argument("--n-regions", type=int, default=12,
                    help="make-regions: number of climate-division-like "
                         "regions to cluster from the covariate rasters")
    ap.add_argument("--station-history", default=None,
                    help="homog: documented-change metadata file "
                         "('STN_ID YYYY-MM' lines); detection relaxes near "
                         "documented dates (Menne-Williams windows)")
    ap.add_argument("--points", default=None,
                    help="point: 'lon,lat;lon,lat;...' sites to interpolate "
                         "(the reference's PtInterpTair ad-hoc use); pass as "
                         "--points=-106.0,41.0 — the = form keeps a leading "
                         "minus from parsing as a flag")
    ap.add_argument("--out", default=None,
                    help="point: output directory for the CSVs "
                         "(default: data_dir)")
    ap.add_argument("--deep", action="store_true",
                    help="validate: force the full product re-scan instead "
                         "of the engine's streamed verify stats + sampled "
                         "deep re-read")
    ap.add_argument("--nnghs", default=None,
                    help="interp: optim-nnghs artifact (nnghs.h5) to apply "
                         "per-tile optimized neighborhood sizes; default: "
                         "data_dir/nnghs.h5 when present")
    ap.add_argument("--no-nnghs", action="store_true",
                    help="interp: ignore any nnghs.h5 artifact and use the "
                         "config k_neighbors everywhere")
    ap.add_argument("--optim-nnghs", action="store_true",
                    help="all: run the optim-nnghs stage between "
                         "krig-params and interp so production consumes "
                         "the optimized per-region k (SURVEY §2.16)")
    ap.add_argument("--k-candidates", default=None,
                    help="optim-nnghs: comma-separated neighborhood sizes "
                         "to sweep (default 8,16,24,32,48)")
    ap.add_argument("--stall-timeout", type=int, default=None,
                    help="interp/all: seconds of zero tile-pipeline progress "
                         "after which the engine exits 75 (EX_TEMPFAIL); "
                         "relaunch the same command to resume. Overrides "
                         "config stall_timeout_s; 0 disables")
    ap.add_argument("--redo", action="store_true",
                    help="all: re-run every stage even when its output "
                         "artifact already exists (default: resume — skip "
                         "completed stages; the artifact chain is the "
                         "checkpoint)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="profile the stage and record its spans: DIR gets "
                         "trace.json (the torch.profiler Chrome trace) and "
                         "spans.json (every thread's spans on the trace's "
                         "clock); in a job of several processes each gets "
                         "its own, trace_pNNN.json and spans_pNNN.json, "
                         "NNN its --process-id; default off")
    args = ap.parse_args(argv)
    several = (args.num_processes or 1) > 1
    if (several and args.coordinator and args.process_id is not None
            and args.stage in ("interp", "all")):
        from topotpu_torch.dist.multihost import local_devices

        # the rank's card current before any CUDA work, the profiler's start
        # included: the process then opens a context on no other card
        local_devices(args.process_id, args.num_processes)
    if args.trace:
        from topotpu_torch.utils.profiling import device_trace

        tag = f"_p{args.process_id or 0:03d}" if several else ""
        with device_trace(args.trace, tag):
            return _stages(ap, args)
    return _stages(ap, args)


def _stages(ap, args) -> int:
    """Run the stages ``args`` names."""
    cfg = _load_config(args.config)
    if args.data_dir or args.stall_timeout is not None:
        import dataclasses

        over = {}
        if args.data_dir:
            over["data_dir"] = args.data_dir
        if args.stall_timeout is not None:
            over["stall_timeout_s"] = args.stall_timeout
        cfg = dataclasses.replace(cfg, **over)

    import time as _time

    from topotpu_torch.cli import steps

    # resolved by the first stage that reaches the device: the host-only
    # stages (synth-data, qa, mosaic, validate, aggregate, make-regions)
    # run on a machine without a GPU
    device = functools.cache(_device)
    _stage_t0 = [_time.time()]

    def report(name, result):
        now = _time.time()
        print(json.dumps({"stage": name, "result": result,
                          "wall_s": round(now - _stage_t0[0], 2)},
                         default=str),
              flush=True)
        _stage_t0[0] = now

    stage = args.stage

    # Stage-level resume for `all` (SURVEY §5: the artifact chain IS the
    # checkpoint). A killed/stalled production run relaunched with the same
    # command skips every stage whose artifact is complete instead of
    # recomputing hours of qa/infill/optim-nnghs; the cascade guarantees
    # consistency (once one stage re-runs, everything downstream re-runs,
    # because its artifact was rewritten). --redo forces a full re-run.
    resume: dict = {}
    if stage == "all" and not args.redo:
        resume = steps.stage_resume_status(
            cfg, args.grid, args.grid, args.stations, args.seed
        )
    upstream_reran = [False]

    def run_or_skip(name, fn):
        if resume.get(name, False) and not upstream_reran[0]:
            report(name, "skipped (resume: artifact complete; --redo to force)")
        else:
            upstream_reran[0] = upstream_reran[0] or bool(resume)
            report(name, fn())

    if stage in ("synth-data", "all"):
        run_or_skip("synth-data", lambda: (
            steps.step_synth_data(cfg, nrows=args.grid, ncols=args.grid,
                                  n_stations=args.stations, seed=args.seed),
            "ok",
        )[1])
    if stage == "download":
        steps.step_download(cfg)
        report("download", "ok")
    if stage == "build-db":
        steps.step_build_db(cfg)
        report("build-db", "ok")
    if stage in ("qa", "all"):
        run_or_skip("qa", lambda: steps.step_qa(cfg))
    if stage in ("homog", "all"):
        run_or_skip("homog", lambda: steps.step_homog(
            cfg, station_history_path=args.station_history, device=device()))
    if stage in ("infill", "all"):
        run_or_skip("infill", lambda: steps.step_infill(cfg, device=device()))
    if stage in ("krig-params", "all"):
        run_or_skip("krig-params",
                    lambda: steps.step_krig_params(cfg, device=device()))
    _cands = (
        tuple(int(x) for x in args.k_candidates.split(","))
        if args.k_candidates else (8, 16, 24, 32, 48)
    )
    if stage == "all" and args.optim_nnghs:
        run_or_skip("optim-nnghs",
                    lambda: steps.step_optim_nnghs(cfg, candidates=_cands,
                                                   regions_path=args.regions,
                                                   device=device()))
    if stage in ("interp", "all"):
        from topotpu_torch.dist.multihost import init_multihost

        ctx = init_multihost(args.coordinator, args.num_processes,
                             args.process_id)
        # the engine steps over this process's mesh (dist.multihost.local_mesh)
        report("interp", steps.step_interp(cfg, chunk_years=args.chunk_years,
                                           ctx=ctx, nnghs_path=args.nnghs,
                                           use_nnghs=not args.no_nnghs))
    if stage in ("mosaic", "all"):
        report("mosaic", steps.step_mosaic(cfg))
    if stage in ("validate", "all"):
        report("validate", steps.step_validate(cfg, deep=args.deep))
    if stage == "validate-f64":
        report("validate-f64", steps.step_validate_f64(cfg, device=device()))
    if stage == "aggregate":
        report("aggregate", steps.step_aggregate(cfg))
    if stage == "make-regions":
        report("make-regions",
               steps.step_make_regions(cfg, n_regions=args.n_regions,
                                       seed=args.seed))
    if stage == "optim-nnghs":
        report("optim-nnghs",
               steps.step_optim_nnghs(cfg, candidates=_cands,
                                      regions_path=args.regions,
                                      device=device()))
    if stage == "point":
        if not args.points:
            ap.error("point requires --points 'lon,lat;lon,lat;...'")
        sites = [
            tuple(float(v) for v in part.split(","))
            for part in args.points.split(";") if part.strip()
        ]
        report("point", steps.step_point(cfg, sites, out_dir=args.out,
                                         device=device()))

    if stage == "xval-interp":
        # both variables, per month AND per region (regions.h5 when
        # present) — the paper's normals error-table protocol
        report("xval-interp", steps.step_xval_interp(cfg, device=device()))
    if stage == "xval-daily":
        report("xval-daily", steps.step_xval_daily(cfg, device=device()))
    if stage == "xval-infill":
        from topotpu_torch.core import constants as C
        from topotpu_torch.interp.xval import xval_infill
        from topotpu_torch.io.stndb import StationDB

        p = steps._paths(cfg)
        days = steps._days(cfg)
        src = p["homog"] if p["homog"].exists() else p["all_obs"]
        # per-variable, like the reference's per-variable mpi_xval jobs
        out = {}
        with StationDB(src) as db:
            for var in (C.TMIN, C.TMAX):
                r = xval_infill(
                    db.obs(var), days.month_idx, cfg.ppca,
                    stn_lon=db.stn(C.LON), stn_lat=db.stn(C.LAT),
                    device=device(),
                )
                r.pop("result")
                out[var] = r
        report("xval-infill", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
