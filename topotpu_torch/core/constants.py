"""Station/grid attribute constants (the port's own copy of the JAX
package's ``core/constants.py``).

Parity target: attribute constants in ``twx/db/station_data.py`` (reference
SURVEY.md §2.3: STN_ID, STATE, LON, LAT, ELEV, TDI, LST, MEAN_OBS, BAD, ...).
"""

# Station attribute names (struct-of-arrays keys in the station DB).
STN_ID = "stn_id"
STN_NAME = "name"
STATE = "state"
LON = "lon"
LAT = "lat"
ELEV = "elev"          # station elevation, m
TDI = "tdi"            # topographic dissection index
LST = "lst"            # MODIS land skin temperature, per month: (nstn, 12)
NORM = "norm"          # monthly normals per variable: (nstn, 12)
BAD = "bad"            # station flagged unusable
VARIO_NUG = "vario_nug"    # fitted exponential variogram nugget, (nstn, 12)
VARIO_PSILL = "vario_psill"  # partial sill, (nstn, 12)
VARIO_RNG = "vario_rng"      # range (km), (nstn, 12)

# Temperature variables.
TMIN = "tmin"
TMAX = "tmax"
VARS = (TMIN, TMAX)

# Observation networks the reference ingests (SURVEY.md §2.1-2.2).
NET_GHCN = "GHCN"
NET_SNOTEL = "SNOTEL"
NET_RAWS = "RAWS"

# Missing-value sentinel used in obs matrices (float arrays use NaN on device;
# this sentinel is for on-disk integer-packed stores).
MISSING = -9999.0

# QA flag codes — mirrors the GHCN-D/Durre et al. 2010 suite the reference
# ports in twx/qa/qa_temp.py (SURVEY.md §2.5).
QA_OK = 0
QA_DUP_YEAR = 1          # duplicated full-year series
QA_DUP_YEAR_MONTH = 2    # duplicated month within/between years
QA_DUP_WITHIN_MONTH = 3  # tmin series duplicates tmax within a month
QA_IMPOSS_VALUE = 4      # exceeds world records
QA_STREAK = 5            # >=20 identical consecutive values
QA_GAP = 6               # gap check in monthly distribution
QA_INTERNAL = 7          # tmax < tmin inconsistency
QA_SPIKE_DIP = 8         # day-to-day swing > 25C on both sides
QA_CLIM_OUTLIER = 9      # climatological z-score outlier
QA_SPATIAL_REGRESS = 10  # spatial regression corroboration failure
QA_SPATIAL_CORROB = 11   # neighbor-corroboration failure
QA_MEGA = 12             # mega-consistency (monthly tmax < monthly tmin)
QA_NAUGHT = 13           # -0 / +0 flag-style placeholder values
QA_FREQUENT = 14         # too-frequent identical value within climatology
