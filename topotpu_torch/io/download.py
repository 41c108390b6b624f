"""Raw observation-data acquisition (the port's own copy of the JAX
package's ``io/download.py``).

Parity target: ``twx/db/download.py`` (SURVEY.md §2.1) — fetch GHCN-Daily
(``ghcnd_all.tar.gz`` + station inventory) from NCEI, SNOTEL from NRCS AWDB,
and RAWS from WRCC.

The package opens no connection of its own, so the fetchers are thin,
testable URL builders + a single gated ``fetch`` seam: callers (and tests)
inject a ``urlopen``-compatible opener; without one, a clear
DownloadUnavailable is raised instead of a hang. Everything downstream (parsers, DB build) operates
on local files and is fully exercised in tests.
"""

from __future__ import annotations

import pathlib
from typing import Callable

GHCND_BASE = "https://www.ncei.noaa.gov/pub/data/ghcn/daily"
GHCND_ALL_TAR = f"{GHCND_BASE}/ghcnd_all.tar.gz"
GHCND_STATIONS = f"{GHCND_BASE}/ghcnd-stations.txt"
GHCND_INVENTORY = f"{GHCND_BASE}/ghcnd-inventory.txt"
SNOTEL_AWDB = "https://wcc.sc.egov.usda.gov/awdbWebService/services"
RAWS_WRCC = "https://raws.dri.edu"
USHCN_BASE = "https://www.ncei.noaa.gov/pub/data/ushcn/v2.5"


class DownloadUnavailable(RuntimeError):
    pass


def ghcnd_station_url(stn_id: str) -> str:
    return f"{GHCND_BASE}/all/{stn_id}.dly"


def ushcn_tar_url(kind: str = "FLs.52i", elem: str = "tmax") -> str:
    """NCEI ships one tarball per element (tmax/tmin/tavg) per revision —
    anchoring tmin homogenization needs the tmin tarball, not tmax's."""
    assert elem in ("tmax", "tmin", "tavg"), elem
    return f"{USHCN_BASE}/ushcn.{elem}.latest.{kind}.tar.gz"


def fetch(
    url: str,
    dest: str | pathlib.Path,
    opener: Callable | None = None,
    chunk: int = 1 << 20,
) -> pathlib.Path:
    """Stream a URL to dest (atomic). Requires an opener (urllib-style);
    raises DownloadUnavailable without one."""
    dest = pathlib.Path(dest)
    if opener is None:
        raise DownloadUnavailable(
            f"no network opener configured for {url}; provide opener= "
            "(e.g. urllib.request.urlopen) in a connected environment"
        )
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    with opener(url) as r, open(tmp, "wb") as f:
        while True:
            b = r.read(chunk)
            if not b:
                break
            f.write(b)
    tmp.replace(dest)
    return dest
