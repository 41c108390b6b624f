"""Pairwise homogenization (PHA-equivalent): the port's own copy of the JAX
package's ``homog/pha.py``.

The numeric core (batched SNHT changepoint detection, and the minbic
break-model selection behind each step estimate) is C++ (``pha_core.cpp``),
built with ``g++`` at first use into ``topotpu_torch/homog/_build/`` (listed
in ``.gitignore``) and called through ``ctypes``; a failed build raises. The
network logic is numpy on the host, as in the JAX package: monthly means and
anomalies, pair formation against each station's most-correlated neighbours
(``infill.pipeline.select_predictors``, the one step that can reach the
device, so the functions that call it take an explicit ``device``),
attribution voting across pairs and elements, documented station-history
windows, break-model confirmation, and the adjustment of the daily series.

Algorithm (classic pairwise approach, Menne & Williams 2009):
  1. monthly mean series per station; anomalies vs station climatology;
  2. each station pairs with its most-correlated neighbors; difference
     series target - neighbor isolate non-climatic steps;
  3. SNHT binary segmentation flags breaks in each difference series (C++);
  4. a break is attributed to the target when a quorum of its pairs agree
     on the date (+-tol months) — the neighbor-voting step that
     distinguishes the culprit station from its witnesses;
  5. each attributed break is classified by minbic model selection
     (const / trend / step / sloped step / two-segment trend, chosen by
     BIC, as in Lund & Reeves 2002 / the PHA "minbic" stage): trend-only
     inhomogeneities are NOT adjusted as steps, and a confirming pair
     must also clear a t-statistic threshold on the fitted offset, making
     significance amplitude-dependent;
  6. per confirmed break, the step size is the trimmed mean of the
     model-fitted pair offsets; segments before each break are shifted so
     the whole series matches its most recent (assumed-correct) segment;
  7. monthly adjustments are broadcast to the daily series.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import pathlib
import subprocess
import tempfile

import numpy as np
import torch

_DIR = pathlib.Path(__file__).resolve().parent
_SO = _DIR / "_build" / "libpha.so"
_SRC = _DIR / "pha_core.cpp"


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build ``pha_core.cpp`` unless its library is newer, and load it."""
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _SO.parent.mkdir(exist_ok=True)
        # built under a temporary name and renamed into place, so processes
        # building at once never load a half-written file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_SO.parent)
        os.close(fd)
        cmd = ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed for {_SRC.name} (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(str(_SO))
    lib.pha_detect_breaks.restype = ctypes.c_int
    lib.pha_detect_breaks.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
    ]
    lib.pha_break_model.restype = ctypes.c_int
    lib.pha_break_model.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def detect_breaks(series: np.ndarray, minseg: int = 24, max_breaks: int = 5):
    """(N, T) difference series -> (breaks (N, max_breaks) int32 [-1 pad],
    stats (N, max_breaks) f64). C++ batched SNHT binary segmentation."""
    series = np.ascontiguousarray(series, np.float32)
    N, T = series.shape
    breaks = np.empty((N, max_breaks), np.int32)
    stats = np.empty((N, max_breaks), np.float64)
    _lib().pha_detect_breaks(
        series.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), N, T,
        minseg, max_breaks,
        breaks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return breaks, stats


def break_model(x: np.ndarray, brk: int, lo: int, hi: int,
                min_side: int = 12) -> tuple[int, float, float]:
    """Lund-Reeves/minbic model selection at a candidate break (C++).

    Fits const / trend / step / step+common-slope / two-segment-trend mean
    functions to the finite months of ``x[lo:hi)`` with the break before
    month ``brk`` and picks the minimum-BIC model — the discrimination step
    that full Menne-Williams PHA applies after SNHT detection, so a trend
    inhomogeneity is classified as model 1 instead of being misread as a
    step, and a sloped-step's offset is estimated without trend bias.

    Returns ``(model, step, tstat)``: model id (0 const, 1 trend, 2 step,
    3 step+slope, 4 two slopes; -1 degenerate), the fitted offset at the
    break (0 for 0/1), and its t-statistic (amplitude-dependent
    significance: callers threshold on ``|tstat|``).
    """
    x = np.ascontiguousarray(x, np.float32)
    step = ctypes.c_double()
    tstat = ctypes.c_double()
    model = _lib().pha_break_model(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(x), int(brk), int(lo), int(hi), int(min_side),
        ctypes.byref(step), ctypes.byref(tstat),
    )
    return int(model), float(step.value), float(tstat.value)


# ------------------------------------------------------------------ driver


@dataclasses.dataclass
class HomogResult:
    adjusted_daily: np.ndarray    # (S, T) daily series with adjustments
    adjustments: np.ndarray       # (S, M) monthly adjustment applied
    breakpoints: list[list[tuple[int, float]]]  # per station: (month_idx, step)
    monthly: np.ndarray           # (S, M) original monthly means


def monthly_means(daily: np.ndarray, year: np.ndarray, month: np.ndarray,
                  min_days: int = 20):
    """(S, T) daily + calendar -> (S, M) monthly means (NaN if sparse) and
    the (M,) month start keys."""
    keys = year * 12 + (month - 1)
    uniq = np.unique(keys)
    S = daily.shape[0]
    out = np.full((S, len(uniq)), np.nan, np.float32)
    for i, k in enumerate(uniq):
        sel = keys == k
        block = daily[:, sel]
        n = np.isfinite(block).sum(axis=1)
        s = np.nansum(np.where(np.isfinite(block), block, 0.0), axis=1)
        out[:, i] = np.where(n >= min_days, s / np.maximum(n, 1), np.nan)
    return out, uniq


def _pair_diffs(
    daily: np.ndarray,
    year: np.ndarray,
    month: np.ndarray,
    n_pairs: int,
    stn_lon: np.ndarray | None = None,
    stn_lat: np.ndarray | None = None,
    *,
    device: torch.device | str,
):
    """Monthly climatology anomalies and target-minus-neighbor difference
    series against the n_pairs most-correlated neighbors (selected by
    ``select_predictors``, whose device branch runs on ``device``)."""
    S = daily.shape[0]
    monthly, keys = monthly_means(daily, year, month)
    M = monthly.shape[1]
    cal_month = (keys % 12).astype(int)

    # anomalies vs station monthly climatology (count-guarded nanmean)
    clim = np.full((S, 12), np.nan, np.float32)
    for m in range(12):
        sel = cal_month == m
        block = monthly[:, sel]
        n = np.isfinite(block).sum(axis=1)
        s = np.nansum(np.where(np.isfinite(block), block, 0.0), axis=1)
        clim[:, m] = np.where(n > 0, s / np.maximum(n, 1), np.nan)
    anom = monthly - clim[:, cal_month]

    # pair selection: most-correlated neighbors on monthly anomalies.
    # select_predictors answers small networks with numpy on the host and
    # larger ones with grams + top-k on ``device``, returning only the
    # (S, n_pairs) index matrix (a host-side (S, S) correlation costs tens
    # of seconds at production S). Overlap requirement is 30 *months* here
    # (30 days upstream) — fine for multi-decade series, and the distance
    # fallback covers short ones.
    from topotpu_torch.infill.pipeline import select_predictors

    order = select_predictors(
        anom, np.isfinite(anom), n_pairs, stn_lon, stn_lat, device=device
    )

    diffs = np.full((S, n_pairs, M), np.nan, np.float32)
    for s in range(S):
        diffs[s] = anom[s][None, :] - anom[order[s]]
    return monthly, keys, diffs


def vote_clusters(
    breaks_s: np.ndarray, date_tol: int
) -> list[tuple[int, int]]:
    """Cluster one station's pair break dates: (center month, votes) per
    date cluster. A true break at the target is witnessed by (nearly)
    every pair, while a neighbor's own break shows in just one pair — so
    vote count separates culprit from witnesses."""
    cand_sorted = np.sort(breaks_s[breaks_s >= 0])
    out: list[tuple[int, int]] = []
    i = 0
    while i < len(cand_sorted):
        # greedy clustering over the UNCONSUMED tail only (a contiguous
        # prefix of it, since the array is sorted): measuring closeness
        # against the full array would let already-clustered candidates
        # vote again (inflating counts toward a false quorum) and advance
        # the cursor past never-clustered candidates (losing real breaks
        # whenever pair dates are 1..2*date_tol apart)
        close = cand_sorted[i:] - cand_sorted[i] <= date_tol
        votes = int(close.sum())
        members = cand_sorted[i : i + votes]
        out.append((int(np.median(members)), votes))
        i += votes
    return out


def merge_attributions(
    clusters_by_elem: dict[str, list[tuple[int, int]]],
    need: int,
    date_tol: int,
    minseg: int,
    documented: tuple[int, ...] | list[int] = (),
    n_months: int | None = None,
) -> tuple[dict[str, list[int]], dict[str, dict[int, int]]]:
    """Cross-element attribution (Menne-Williams multi-element
    confirmation): a cluster is attributed when it reaches the quorum in
    its own element, OR falls one vote short but is corroborated by a
    near-quorum cluster at the same date (+-date_tol) in another element —
    a station move shifts tmin and tmax together, so coincident evidence
    across elements substitutes for one missing pair vote. Accepted dates
    are then thinned to >= minseg spacing per element (date order).

    ``documented``: month indices of documented station-history changes for
    this station (Menne-Williams metadata windows). Near a documented date
    the attribution quorum is waived entirely — any SNHT cluster within
    +-date_tol snaps to the documented date and is accepted — and every
    documented date is additionally injected as a candidate even with zero
    SNHT evidence. Both go through break-model confirmation downstream
    (with its own relaxed quorum, see _confirm_and_steps), so a documented
    date with no step signature in any pair is still never adjusted.

    Returns ``(accepted, fallbacks)``: ``accepted`` maps element ->
    thinned break dates; ``fallbacks`` maps element -> {documented date ->
    blind candidate it displaced in a minseg conflict}. A caller that
    finds a documented date failing break-model confirmation should
    reinstate its fallback (see homogenize_elements) — otherwise supplying
    metadata could *suppress* a genuine blind adjustment whose SNHT
    position happens to fall within minseg (but beyond date_tol) of a
    no-signal documented note."""
    accepted: dict[str, list[int]] = {}
    fallbacks: dict[str, dict[int, int]] = {}
    doc = sorted(documented)
    for elem, clusters in clusters_by_elem.items():
        dates: list[int] = []
        for center, votes in clusters:
            near = [d for d in doc if abs(d - center) <= date_tol]
            if near:
                dates.append(min(near, key=lambda d: abs(d - center)))
                continue
            if votes >= need:
                dates.append(center)
                continue
            if votes == need - 1 and any(
                v2 >= need - 1 and abs(c2 - center) <= date_tol
                for e2, cl2 in clusters_by_elem.items()
                if e2 != elem
                for c2, v2 in cl2
            ):
                dates.append(center)
        for d in doc:  # documented dates with no cluster: inject as candidates
            if d not in dates:
                dates.append(d)
        # minseg conflicts between a documented date and an SNHT cluster
        # beyond date_tol: only one break fits in the window, so pick by
        # where the position evidence is. A cluster whose center sits
        # against the SNHT guard band (breaks only exist in
        # [minseg, n_months-minseg)) was *forced* there — the true break
        # may well be at the documented date just outside the band, so the
        # documented date wins and the displaced candidate is kept as its
        # fallback (reinstated if the documented date fails break-model
        # confirmation — a no-signal note, e.g. a time-of-observation
        # change, must not swallow a genuine blind adjustment). A cluster
        # SNHT placed *freely* mid-series is strong position evidence, so
        # it wins and the no-snap documented date yields. Without
        # ``n_months`` the geometry is unknown and documented always wins.
        docset = set(doc)
        fb: dict[int, int] = {}
        kept: list[int] = []
        lost_docs: set[int] = set()
        for c in set(dates):
            if c in docset:
                kept.append(c)
                continue
            conflict = [d for d in docset if abs(c - d) < minseg]
            if not conflict:
                kept.append(c)
                continue
            d = min(conflict, key=lambda d: abs(c - d))
            constrained = n_months is None or (
                c <= minseg + date_tol
                or c >= n_months - minseg - date_tol - 1
            )
            if constrained:
                if d not in fb or abs(c - d) < abs(fb[d] - d):
                    fb[d] = c
            else:
                kept.append(c)
                lost_docs.add(d)
        kept = [c for c in kept if c not in lost_docs]
        thinned: list[int] = []
        for c in sorted(kept):
            if not thinned or c - thinned[-1] >= minseg:
                thinned.append(c)
        accepted[elem] = thinned
        fallbacks[elem] = {d: c for d, c in fb.items() if d not in lost_docs}
    return accepted, fallbacks


def _confirm_and_steps(
    diffs_s: np.ndarray,
    attributed: list[int],
    M: int,
    quorum_min: int,
    t_crit: float,
    documented: frozenset[int] | set[int] = frozenset(),
) -> list[tuple[int, float]]:
    """Break-model confirmation + step estimation per attributed break.

    For each pair series, minbic model selection classifies the
    neighborhood of the break: only pairs whose best model contains a
    step (2/3/4) AND whose step t-statistic clears t_crit count as
    confirmations — so a trend inhomogeneity (model 1 wins) is never
    adjusted as a step, and significance is amplitude-dependent (a small
    offset in noisy/short segments has small t and is dropped). The step
    estimate is the trimmed mean of the winning models' offsets, which
    de-biases sloped steps that a window-mean estimator would smear.

    At a documented station-history date (``documented``) the confirmation
    quorum drops to 1: metadata already attributes the change to this
    station, so a single pair showing a significant model step suffices —
    the amplitude t-test is the only remaining gate (Menne-Williams treats
    documented changepoints as given and only estimates/screens the
    adjustment)."""
    n_pairs = diffs_s.shape[0]
    stn_breaks: list[tuple[int, float]] = []
    bounds = [0] + attributed + [M]
    for bi, b in enumerate(attributed):
        lo, hi = bounds[bi], bounds[bi + 2]
        steps = []
        for p in range(n_pairs):
            model, st, tstat = break_model(diffs_s[p], b, lo, hi)
            if model >= 2 and np.isfinite(st) and abs(tstat) >= t_crit:
                steps.append(st)
        if len(steps) >= (1 if b in documented else quorum_min):
            steps = np.sort(steps)
            k = len(steps) // 5
            est = float(
                np.mean(steps[k : len(steps) - k] if len(steps) > 2 * k else steps)
            )
            stn_breaks.append((int(b), est))
    return stn_breaks


def homogenize_elements(
    dailies: dict[str, np.ndarray],
    year: np.ndarray,
    month: np.ndarray,
    stn_lon: np.ndarray,
    stn_lat: np.ndarray,
    n_pairs: int = 8,
    quorum_frac: float = 0.5,
    quorum_min: int = 3,
    date_tol: int = 6,
    minseg: int = 24,
    max_breaks: int = 5,
    t_crit: float = 3.0,
    station_history: dict[int, list[int]] | None = None,
    *,
    device: torch.device | str,
) -> dict[str, HomogResult]:
    """Homogenize one or more elements (e.g. tmin + tmax) of an (S, T)
    daily network in place of the reference's PHA run.

    With multiple elements, attribution uses Menne-Williams-style
    multi-element confirmation (see merge_attributions): coincident
    near-quorum evidence across elements rescues breaks one vote short of
    the single-element quorum. Detection, model confirmation, step
    estimation and adjustment stay per-element (an instrument change can
    shift tmax only, and the step sizes differ even for joint moves).

    ``station_history``: documented station-history metadata (the input
    full PHA v52i reads from NCEI's "his" files): maps station index ->
    list of month keys (``year*12 + month-1``) of documented changes
    (moves, instrument swaps). Near those dates attribution is relaxed and
    confirmation needs only one significant pair (see merge_attributions /
    _confirm_and_steps) — so small documented steps that would not clear
    the blind quorum are still caught, while undocumented behavior is
    completely unchanged. Parse files with ``parse_station_history``.

    ``device``: where ``select_predictors`` runs its device branch (networks
    above its gram-size threshold); smaller networks take its numpy branch
    on the host whatever the device."""
    elems = list(dailies)
    S = dailies[elems[0]].shape[0]
    n_pairs = min(n_pairs, S - 1)  # at most S-1 distinct neighbors
    need = max(quorum_min, int(np.ceil(quorum_frac * n_pairs)))

    per_elem: dict[str, tuple] = {}
    for e in elems:
        monthly, keys, diffs = _pair_diffs(
            dailies[e], year, month, n_pairs, stn_lon, stn_lat, device=device
        )
        M = monthly.shape[1]
        breaks, _ = detect_breaks(
            diffs.reshape(S * n_pairs, M), minseg, max_breaks
        )
        per_elem[e] = (monthly, keys, diffs, breaks.reshape(S, n_pairs, -1))

    results: dict[str, HomogResult] = {
        e: HomogResult(
            adjusted_daily=None, adjustments=np.zeros((S, per_elem[e][0].shape[1]), np.float32),
            breakpoints=[], monthly=per_elem[e][0],
        )
        for e in elems
    }
    # documented-change month keys -> positions in the monthly series (the
    # calendar — and so ``keys`` — is shared across elements)
    keys0 = per_elem[elems[0]][1]
    key_pos = {int(k): i for i, k in enumerate(keys0)}
    doc_by_stn: dict[int, tuple[int, ...]] = {}
    for s, ks in (station_history or {}).items():
        pos = tuple(sorted(key_pos[int(k)] for k in ks if int(k) in key_pos))
        if pos:
            doc_by_stn[int(s)] = pos

    for s in range(S):
        doc = doc_by_stn.get(s, ())
        clusters = {
            e: vote_clusters(per_elem[e][3][s], date_tol) for e in elems
        }
        accepted, fallbacks = merge_attributions(
            clusters, need, date_tol, minseg, documented=doc,
            n_months=per_elem[elems[0]][0].shape[1],
        )
        for e in elems:
            monthly, keys, diffs, _ = per_elem[e]
            M = monthly.shape[1]
            stn_breaks = _confirm_and_steps(
                diffs[s], accepted[e], M, quorum_min, t_crit,
                documented=frozenset(doc),
            )
            # A documented date that displaced a blind candidate in the
            # minseg conflict but then failed break-model confirmation
            # (no step signature at the documented month) must not swallow
            # the blind break: reinstate the displaced candidate (if it
            # keeps minseg spacing to the surviving dates) and re-confirm
            # once under the blind quorum.
            confirmed = {b for b, _ in stn_breaks}
            failed = [
                d for d in accepted[e]
                if d in fallbacks[e] and d not in confirmed
            ]
            if failed:
                retry = [c for c in accepted[e] if c not in failed]
                for d in failed:
                    c = fallbacks[e][d]
                    if all(abs(c - o) >= minseg for o in retry):
                        retry.append(c)
                if sorted(retry) != accepted[e]:
                    stn_breaks = _confirm_and_steps(
                        diffs[s], sorted(retry), M, quorum_min, t_crit,
                        documented=frozenset(doc),
                    )
            results[e].breakpoints.append(stn_breaks)
            # adjust-to-latest: months before each break get minus the
            # accumulated later steps
            adj = np.zeros(M, np.float32)
            for b, est in stn_breaks:
                adj[:b] += np.float32(est)
            results[e].adjustments[s] = adj

    # broadcast monthly adjustments to daily values
    out: dict[str, HomogResult] = {}
    for e in elems:
        monthly, keys, _, _ = per_elem[e]
        keys_daily = year * 12 + (month - 1)
        key_to_idx = {k: i for i, k in enumerate(keys)}
        midx = np.array([key_to_idx[k] for k in keys_daily])
        r = results[e]
        out[e] = HomogResult(
            adjusted_daily=dailies[e] + r.adjustments[:, midx],
            adjustments=r.adjustments,
            breakpoints=r.breakpoints,
            monthly=monthly,
        )
    return out


def homogenize_network(
    daily: np.ndarray,
    year: np.ndarray,
    month: np.ndarray,
    stn_lon: np.ndarray,
    stn_lat: np.ndarray,
    *,
    device: torch.device | str,
    **kwargs,
) -> HomogResult:
    """Single-element homogenization (see homogenize_elements)."""
    return homogenize_elements(
        {"x": daily}, year, month, stn_lon, stn_lat, device=device, **kwargs
    )["x"]


def parse_station_history(
    text: str, stn_ids: np.ndarray | list[str]
) -> dict[int, list[int]]:
    """Parse a station-history metadata file into homogenize_elements'
    ``station_history`` mapping.

    Format (whitespace-separated, '#' comments, the role of NCEI's PHA
    "his" station-history input — SURVEY §2.7):

        STN_ID  YYYY-MM  [free-text note]

    one documented change (move / instrument swap / time-of-observation
    change) per line, dated to the first month affected. Unknown station
    ids are ignored (histories commonly cover a wider network than the
    run). Returns {station index: [year*12 + month-1, ...]}."""
    ids = [
        i.decode() if isinstance(i, (bytes, np.bytes_)) else str(i)
        for i in np.asarray(stn_ids).tolist()
    ]
    index = {sid: i for i, sid in enumerate(ids)}
    out: dict[int, list[int]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        if len(parts) < 2:
            raise ValueError(f"station-history line {lineno}: need "
                             f"'STN_ID YYYY-MM', got {line!r}")
        sid, ym = parts[0], parts[1]
        try:
            y, m = ym.split("-")
            key = int(y) * 12 + int(m) - 1
            if not 1 <= int(m) <= 12:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"station-history line {lineno}: bad date {ym!r} "
                "(want YYYY-MM)"
            ) from None
        if sid in index:
            out.setdefault(index[sid], []).append(key)
    return out
