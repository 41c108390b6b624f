"""Driver of the station-parameter cells: TopoWx's station-side stages
before the grid, one pass = ``build_krig_params`` (variogram parameters of
every station and month) + ``optimize_nnghs`` (the normals neighbourhood
size by leave-one-out, per region) + ``optimize_nnghs_anoms`` (the anomaly
size by daily leave-one-out), over the whole network.

Set-up: the network from the seed (the infill cell's, serially complete:
the stations' true normals and anomalies), the regions (the network halved
at its median longitude), the sampled stations, and a warm-up pass over
``warmup_stations`` stations. Window: passes until the first pass boundary
past ``--seconds``. Check, on the last pass, for ``sample_stations``
stations drawn from the seed, against the plain reference
(``reference/params.py``) in float64 on the device: the fitted variogram
curves of every month (their 90th percentile gap: the damped Gauss-Newton
accepts or rejects a step on near-equal SSEs, so a few fits in float32 end
elsewhere along a flat valley, as the TF32 control's do), the LOO normal
errors at ``compared_ks`` and the daily MAE at ``compared_kas`` (at k or
ka = 8 and at k = 16 the float32 regression on so few stations is itself
as far from float64 as the control: PERF.md has the readings), leaving out
a station whose k-th and next neighbour lie within ``tie_km`` (the program
ranks by float32 cosines); and the k chosen in each region against the
rule (the smallest k within one standard error of the best per-station
MAE) applied to the program's own per-station errors of every station.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from benchlib.runner import Check
from benchlib import network as netw
from reference import params as ref_params


def setup(ctx):
    import torch

    from topotpu_torch.core.config import InterpParams, VariogramParams
    from topotpu_torch.interp.params import build_krig_params
    from topotpu_torch.interp.xval import optimize_nnghs, optimize_nnghs_anoms

    cfg = ctx.config
    net = netw.network(ctx)
    v = cfg["variogram"]
    vp = VariogramParams(n_bins=v["n_bins"], max_dist_frac=v["max_dist_frac"],
                         gn_iters=v["gn_iters"], k_fit_neighbors=v["k_fit_neighbors"])
    ip = InterpParams(k_neighbors=cfg["k_neighbors"], k_neighbors_anom=cfg["k_neighbors_anom"])
    regions = (net.st.lon > np.median(net.st.lon)).astype(int)
    fns = (build_krig_params, optimize_nnghs, optimize_nnghs_anoms)
    rng = np.random.default_rng(ctx.seed + 2)
    sample = np.sort(rng.choice(len(net.st.lon), int(ctx.cell["sample_stations"]), replace=False))
    s = dict(net=net, vp=vp, ip=ip, regions=regions, fns=fns, last=None, sample=sample)
    _pass(ctx, s, np.arange(ctx.traffic["warmup_stations"]), record=False)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return s


def _pass(ctx, s, sel=slice(None), record=True):
    """One pass over the stations ``sel``; spans in the run record where
    ``record``."""
    import contextlib

    import torch

    net, dev = s["net"], ctx.device
    build, nnghs, anoms = s["fns"]
    span = ctx.rec.span if record else (lambda *a, **k: contextlib.nullcontext())
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    st = net.st
    a = (st.lon[sel], st.lat[sel], st.elev[sel], st.tdi[sel], st.lst[sel], st.norm[0][sel],
         st.vario[sel], np.ones((len(st.lon[sel]), 12), bool))
    regions = s["regions"][sel]
    with span("krig_params"):
        kp = build(*a[:6], a[7], s["vp"], s["ip"], device=dev)
        sync()
    with span("nnghs"):
        nn = nnghs(*a, candidates=ctx.traffic["normal_ks"], region_labels=regions,
                   base_params=s["ip"], device=dev)
    with span("nnghs_anoms"):
        na = anoms(*a, net.st.anoms[0][sel], net.months, candidates=ctx.traffic["anom_ks"],
                   region_labels=regions, base_params=s["ip"], device=dev)
    return kp, nn, na


def window(ctx, s):
    deadline = time.perf_counter() + ctx.seconds
    while True:
        with ctx.rec.span("params_pass"):
            kp, nn, na = _pass(ctx, s)
        ctx.rec.counters["passes"] += 1
        ctx.tracer.boundary()
        if time.perf_counter() >= deadline:
            break
    if ctx.options.get("fault") == "answer":  # the tests' planted fault: a sampled
        k = ctx.cell["compared_ks"][0]        # station's LOO error 0.5 C off
        nn["per_station_err"][k][s["sample"][0], 0] += 0.5
    s["last"] = (kp, nn, na)


def release(ctx, s):
    import torch

    kp, nn, na = s["last"]
    s["last"] = dict(vario=kp.vario.cpu().numpy(), fit_ok=kp.ok.cpu().numpy(),
                     normal_err={k: np.asarray(v) for k, v in nn["per_station_err"].items()},
                     normal_best=dict(nn["best"]),
                     daily_mae={k: np.asarray(v) for k, v in na["per_station_mae"].items()},
                     daily_best=dict(na["best"]))
    s.pop("fns")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return s


def _rule(per_station: dict, regions, fallback: int) -> dict:
    """The k of each region by the configuration's rule: the smallest k whose
    mean per-station MAE is within one standard error of the best."""
    best = {}
    for r in np.unique(regions):
        sc = {}
        for k, e in per_station.items():
            v = e[regions == r]
            v = v[np.isfinite(v)]
            if v.size:  # as Python floats, as the program sums them
                sc[k] = (float(v.mean()), float(v.std(ddof=1) / np.sqrt(v.size)) if v.size > 1
                         else 0.0)
        if not sc:
            best[int(r)] = fallback
            continue
        kb = min(sc, key=lambda k: sc[k][0])
        best[int(r)] = int(min(k for k in sc if sc[k][0] <= sc[kb][0] + sc[kb][1]))
    return best


def _station_mae(err: np.ndarray) -> np.ndarray:
    a = np.abs(err)
    fin = np.isfinite(a)
    cnt = fin.sum(1)
    return np.where(cnt > 0, np.where(fin, a, 0.0).sum(1) / np.maximum(cnt, 1), np.nan)


def check(ctx, s):
    net, last, lim = s["net"], s["last"], ctx.cell["limits"]
    st = dict(lon=net.st.lon, lat=net.st.lat, elev=net.st.elev, tdi=net.st.tdi, lst=net.st.lst,
              norm=net.st.norm[:1], vario=net.st.vario, anoms=net.st.anoms[:1])
    t = s["sample"]
    cfg = dict(ctx.config, k_neighbors=s["ip"].k_neighbors)
    v = ctx.config["variogram"]
    ks, kas = ctx.traffic["normal_ks"], ctx.traffic["anom_ks"]
    ss, mm = np.repeat(t, 12), np.tile(np.arange(12), len(t))
    want_fit = ref_params.variogram_fits(st, ss, mm, v, cfg, "f64", ctx.device)
    want_n, gap_km = ref_params.loo_normal_errors(st, t, ks, cfg, "f64", ctx.device)
    want_d, gap_a = ref_params.loo_daily_mae(st, t, kas, cfg["k_neighbors"], net.months, cfg,
                                             "f64", ctx.device)
    if ctx.options.get("control"):
        got_fit = ref_params.variogram_fits(st, ss, mm, v, cfg, "tf32", ctx.device)
        got_n, _ = ref_params.loo_normal_errors(st, t, ks, cfg, "tf32", ctx.device)
        got_d, _ = ref_params.loo_daily_mae(st, t, kas, cfg["k_neighbors"], net.months, cfg,
                                            "tf32", ctx.device)
        got_best = rule_best = {}  # the rule is the control's own: nothing to compare
    else:
        vario = last["vario"][ss, mm]
        got_fit = dict(nugget=vario[:, 0].astype(np.float64), psill=vario[:, 1].astype(np.float64),
                       range=vario[:, 2].astype(np.float64), ok=last["fit_ok"][ss, mm])
        got_n = {k: last["normal_err"][k][t] for k in ks}
        got_d = {k: last["daily_mae"][k][t] for k in kas}
        got_best = {("n", r): k for r, k in last["normal_best"].items()}
        got_best.update({("a", r): k for r, k in last["daily_best"].items()})
        rule_best = {("n", r): k for r, k in _rule(
            {k: _station_mae(e) for k, e in last["normal_err"].items()}, s["regions"],
            cfg["k_neighbors"]).items()}
        rule_best.update({("a", r): k for r, k in _rule(
            last["daily_mae"], s["regions"], min(cfg["k_neighbors_anom"], cfg["k_neighbors"])
        ).items()})
    fit_gap = ref_params.curve_gap(got_fit, want_fit)
    both = want_fit["ok"] & got_fit["ok"]
    tie = float(ctx.cell["tie_km"])
    diag = {f"loo_normal_err_C_k{k}": float(np.nanmax(
        np.abs(got_n[k] - want_n[k])[gap_km[k] >= tie], initial=0.0)) for k in ks}
    diag.update({f"loo_daily_mae_err_C_ka{k}": float(np.nanmax(
        np.abs(got_d[k] - want_d[k])[gap_a[k] >= tie], initial=0.0)) for k in kas})
    diag["fit_curve_gap_max"] = float(fit_gap[both].max()) if both.any() else 0.0
    print("params readings " + json.dumps(diag), file=sys.stderr)
    cmp_k, cmp_ka = ctx.cell["compared_ks"], ctx.cell["compared_kas"]
    checks = [
        Check("fit_curve_gap_p90", float(np.percentile(fit_gap[both], 90)) if both.any() else 0.0,
              lim["fit_curve_gap_p90"]),
        Check("fit_ok_mismatch", int((want_fit["ok"] != got_fit["ok"]).sum()), 0),
        Check("loo_normal_err_C", max(diag[f"loo_normal_err_C_k{k}"] for k in cmp_k),
              lim["loo_normal_err_C"]),
        Check("loo_daily_mae_err_C", max(diag[f"loo_daily_mae_err_C_ka{k}"] for k in cmp_ka),
              lim["loo_daily_mae_err_C"]),
        Check("k_choice_faults", sum(got_best.get(r) != k for r, k in rule_best.items()), 0),
    ]
    return checks, int(ctx.rec.counters["passes"]), 0
