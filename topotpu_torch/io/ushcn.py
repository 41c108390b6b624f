"""USHCN v2.5 homogenized monthly ingest (the port's own copy of the JAX
package's ``io/ushcn.py``).

Parity target: ``twx/db/ushcn.py`` (SURVEY.md §2.4) — read USHCN "FLs.52i"
homogenized monthly series, used by the reference to anchor/compare its own
homogenization adjustments.

Format (NCEI USHCN v2.5 README): one line per station-year:
  cols 1-11 station id, 13-16 year, then 12 x (value(6) dmflag qcflag
  dsflag) fields; value in hundredths of a degree C... the tarball variant
  used by the reference stores tenths of deg F for raw and hundredths deg C
  in later revisions — the unit is a constructor knob with the v2.5 deg-C
  hundredths default.
"""

from __future__ import annotations

import numpy as np

MISSING = -9999


def parse_ushcn_monthly(
    text: str, scale: float = 0.01, drop_estimated: bool = False
) -> dict[str, dict]:
    """Parse FLs.52i-style lines -> {stn_id: {"years": (Y,), "values": (Y, 12)}}.

    Per-month field layout is value(6) + DMFLAG + QCFLAG + DSFLAG (v2.5
    readme). ``-9999`` in the value field is the missing code regardless of
    flags. ``drop_estimated=True`` additionally NaNs months whose DMFLAG is
    'E' (wholly FILNET-estimated, no underlying observation) — anchoring
    comparisons against estimated values would score the infill model, not
    the homogenization."""
    per_station: dict[str, dict[int, np.ndarray]] = {}
    for line in text.splitlines():
        if len(line) < 16 + 12 * 9:
            continue
        sid = line[0:11].strip()
        try:
            year = int(line[12:16])
        except ValueError:
            continue
        vals = np.full(12, np.nan)
        for m in range(12):
            off = 16 + m * 9
            raw = line[off : off + 6]
            dmflag = line[off + 6 : off + 7]
            try:
                v = int(raw)
            except ValueError:
                continue
            if v == MISSING:
                continue
            if drop_estimated and dmflag == "E":
                continue
            vals[m] = v * scale
        per_station.setdefault(sid, {})[year] = vals
    out = {}
    for sid, by_year in per_station.items():
        years = np.array(sorted(by_year))
        values = np.stack([by_year[y] for y in years])
        out[sid] = {"years": years, "values": values}
    return out


def iter_ushcn_tar(path, scale: float = 0.01, drop_estimated: bool = False):
    """Stream (stn_id, {"years", "values"}) out of the tarball NCEI ships
    (``ushcn.<elem>.latest.FLs.52i.tar.gz``: one member file per station).
    Sequential ``r|*`` streaming — same constant-memory discipline as
    ``io.build_db.iter_ghcnd_tar``. Non-station members are skipped; each
    member is parsed with parse_ushcn_monthly."""
    import tarfile

    with tarfile.open(path, "r|*") as tf:
        for member in tf:
            if not member.isfile() or ".FLs." not in member.name:
                continue
            f = tf.extractfile(member)
            if f is None:
                continue
            parsed = parse_ushcn_monthly(
                f.read().decode("ascii", "replace"),
                scale=scale, drop_estimated=drop_estimated,
            )
            yield from parsed.items()


def compare_adjustments(
    our_monthly_adjusted: np.ndarray,
    our_years: np.ndarray,
    ushcn: dict,
    stn_id: str,
) -> float:
    """RMSE between our homogenized monthly means and USHCN's for one
    station over the overlapping years (the reference's anchoring check)."""
    if stn_id not in ushcn:
        return np.nan
    u = ushcn[stn_id]
    common, ia, ib = np.intersect1d(our_years, u["years"], return_indices=True)
    if len(common) == 0:
        return np.nan
    a = our_monthly_adjusted[ia]
    b = u["values"][ib]
    both = np.isfinite(a) & np.isfinite(b)
    if both.sum() == 0:
        return np.nan
    return float(np.sqrt(np.mean((a[both] - b[both]) ** 2)))
