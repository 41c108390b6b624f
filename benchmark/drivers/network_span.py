"""Driver of the share cell: TopoWx's PPCA infill of the station network over
its whole span (BASELINE config #7 through config #3's settings) as one rank
of the reference's task farm (``bin/mpi_infill_stn_obs.py``): each call
infills one share of the targets against every station of the network,
through ``infill_network(targets=)``.

Set-up: the network from the seed (``benchlib/network.py``: stations, their
normals and daily anomalies over the span, observations missing at random),
the configuration's ``shares`` round-robin shares (station i in share
i % shares), and a warm-up: one call on the first ``warmup_targets`` targets
of share 0 against the whole network, whose selection runs on the device and
whose EM batches have the window's shapes. A program whose ``infill_network``
takes no ``targets`` cannot run the cell and stops here, before the world is
made. Window: one call a share, the shares in turn, until the first call
boundary past ``--seconds``. Check: for ``sample_targets`` targets of each
call, drawn from the seed, as ``network_infill.py`` checks them, against the
plain reference in float64 on the device (``reference/infill.py``), with
every target scored against the whole network (``reference/infill_shares.py``
reads the selection's shortfall, the tie margin's reading).
"""

from __future__ import annotations

import inspect
import time

import numpy as np

from benchlib import catalog
from benchlib import network as netw
from benchlib.runner import Check
from reference import infill as ref_infill
from reference import infill_shares

_infill = catalog.load_module("drivers", "network_infill")


def setup(ctx):
    import torch

    from topotpu_torch.infill.pipeline import infill_network

    if "targets" not in inspect.signature(infill_network).parameters:
        raise SystemExit("infill_network takes no targets: this program cannot infill a share "
                         "of the network against the whole of it")
    net = netw.network(ctx)
    lon, lat, obs, months = net.st.lon, net.st.lat, net.obs, net.months
    del net  # the anomalies and the truth: the window needs the observations only
    n = int(ctx.config["shares"])
    shares = [np.arange(i, len(lon), n) for i in range(n)]
    params = _infill.ppca_params(ctx.config)
    infill_network(obs, months, params, targets=shares[0][: ctx.traffic["warmup_targets"]],
                   stn_lon=lon, stn_lat=lat, device=ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(fn=infill_network, params=params, lon=lon, lat=lat, obs=obs, months=months,
                shares=shares, calls=[])


def window(ctx, s):
    rng = np.random.default_rng(ctx.seed + 1)
    n_sample = int(ctx.cell["sample_targets"])
    deadline = time.perf_counter() + ctx.seconds
    while True:
        i = len(s["calls"])
        share = s["shares"][i % len(s["shares"])]
        with ctx.rec.span("infill_call", key=i):
            res = s["fn"](s["obs"], s["months"], s["params"], targets=share,
                          stn_lon=s["lon"], stn_lat=s["lat"], device=ctx.device)
        ctx.rec.counters["targets"] += len(share)
        ctx.rec.values["em_iters"].extend(res.n_iters.tolist())
        pick = np.sort(rng.choice(len(share), min(n_sample, len(share)), replace=False))
        if ctx.options.get("fault") == "answer":  # the tests' planted fault: one imputed
            gap = np.flatnonzero(~res.obs_mask[pick[0]])[0]  # value 0.5 C off
            res.filled[pick[0], gap] += 0.5
        s["calls"].append(dict(targets=share[pick], filled=res.filled[pick].copy(),
                               norms=res.norms[pick].copy(),
                               predictors=res.predictors[pick].copy(),
                               bad_values=int((~np.isfinite(res.filled)).sum())))
        ctx.tracer.boundary()
        if time.perf_counter() >= deadline:
            return


def release(ctx, s):
    return _infill.release(ctx, s)


def check(ctx, s):
    p = ctx.config["ppca"]
    lim = ctx.cell["limits"]
    tie = float(ctx.cell["tie_margin"])
    control = bool(ctx.options.get("control"))
    obs = s["obs"].astype(np.float64)
    # every sampled target of every call scored at once: the float64
    # standardisation of the whole network is the check's largest cost
    every = np.concatenate([c["targets"] for c in s["calls"]])
    score_all = ref_infill.scores(obs, s["lon"], s["lat"], every, ctx.device)
    err_f = err_n = short = 0.0
    changed = faults = failed = 0
    row = 0
    for call in s["calls"]:
        t = call["targets"]
        score, row = score_all[row : row + len(t)], row + len(t)
        if control:
            chosen = ref_infill.best(score, p["n_neighbors"])
            got = ref_infill.reference(obs, t, chosen, s["months"], p, "tf32", ctx.device)
        else:
            chosen = call["predictors"].astype(np.int64)
            got = dict(filled=call["filled"].astype(np.float64),
                       normals=call["norms"].astype(np.float64))
        want = ref_infill.reference(obs, t, chosen, s["months"], p, "f64", ctx.device)
        faults += ref_infill.selection_faults(score, chosen, t, tie)
        short = max(short, infill_shares.shortfall(score, chosen))
        failed += call["bad_values"]
        seen = np.isfinite(obs[t])
        changed += int((got["filled"][seen] != obs[t][seen]).sum())
        err_f = max(err_f, float(np.abs(got["filled"] - want["filled"]).max()))
        err_n = max(err_n, float(np.abs(got["normals"] - want["normals"]).max()))
    checks = [Check("filled_err_C", err_f, lim["filled_err_C"]),
              Check("normal_err_C", err_n, lim["normal_err_C"]),
              Check("predictor_shortfall", short, tie),
              Check("observed_changed", changed, 0),
              Check("predictor_faults", faults, 0),
              Check("nonfinite_values", failed, 0)]
    return checks, int(ctx.rec.counters["targets"]), failed
