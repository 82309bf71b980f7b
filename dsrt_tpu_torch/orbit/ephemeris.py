"""Moon-from-Sun ephemeris: SPICE when available, analytic fallback.

A copy of dsrt_tpu/orbit/ephemeris.py: the port imports nothing of the JAX
package.

The reference calls spiceypy `spkezr("MOON", et, "J2000", "NONE", "SUN")`
with naif0012.tls + de440s.bsp (lunar_polar_orbit_sim.py:238-253, 363-366);
de440s.bsp is missing from its repo, so the sim cannot actually run from a
clean checkout.  Here SPICE is an optional dependency and the fallback is a
low-precision analytic ephemeris (mean-element Earth orbit + mean-element
lunar orbit, ~0.1% position error) — more than enough for lighting geometry
at ~1 AU.  SURVEY.md §7 step 8 calls for exactly this gating.
"""

from __future__ import annotations

import datetime as _dt
import math
import os
from typing import Optional

import numpy as np

DEFAULT_EPOCH_UTC = "2027-01-25T00:00:00"  # reference default (:341-343)

AU_KM = 149_597_870.7


def _try_spice(epoch_utc: str, kernel_dir: Optional[str]):
    try:
        import spiceypy as sp
    except ImportError:
        return None
    if not kernel_dir:
        return None
    tls = os.path.join(kernel_dir, "naif0012.tls")
    bsp = os.path.join(kernel_dir, "de440s.bsp")
    if not (os.path.exists(tls) and os.path.exists(bsp)):
        return None
    try:
        sp.furnsh(tls)
        sp.furnsh(bsp)
        et = sp.utc2et(epoch_utc)
        state, _ = sp.spkezr("MOON", et, "J2000", "NONE", "SUN")
        return np.array(state[0:3], np.float64)
    except Exception:
        return None


def _julian_centuries(epoch_utc: str) -> float:
    t = _dt.datetime.fromisoformat(epoch_utc)
    # days since J2000.0 (2000-01-01T12:00)
    j2000 = _dt.datetime(2000, 1, 1, 12, 0, 0)
    days = (t - j2000).total_seconds() / 86400.0
    return days / 36525.0


def _analytic_moon_from_sun(epoch_utc: str) -> np.ndarray:
    """Mean-element Sun->Earth + Earth->Moon, rotated to an equatorial
    J2000-like frame.  Good to ~0.1-1% — fine for lighting direction."""
    T = _julian_centuries(epoch_utc)
    d2r = math.pi / 180.0

    # Earth-Moon barycenter heliocentric ecliptic (low-precision mean elems)
    L = (100.46435 + 35999.372854 * T) * d2r          # mean longitude
    g = (357.52911 + 35999.05029 * T) * d2r           # mean anomaly
    e = 0.016708634 - 0.000042037 * T
    # equation of center
    C = ((1.914602 - 0.004817 * T) * np.sin(g)
         + (0.019993 - 0.000101 * T) * np.sin(2 * g)
         + 0.000289 * np.sin(3 * g)) * d2r
    lam = L + C
    r_au = 1.000001018 * (1 - e * e) / (1 + e * np.cos(g + C))
    earth_ecl = r_au * AU_KM * np.array([np.cos(lam), np.sin(lam), 0.0])

    # Moon geocentric ecliptic (leading terms of ELP)
    Lp = (218.3164477 + 481267.88123421 * T) * d2r    # mean longitude
    D = (297.8501921 + 445267.1114034 * T) * d2r      # mean elongation
    Mp = (134.9633964 + 477198.8675055 * T) * d2r     # mean anomaly
    F = (93.2720950 + 483202.0175233 * T) * d2r       # arg of latitude
    lon = Lp + d2r * (6.288774 * np.sin(Mp) + 1.274027 * np.sin(2 * D - Mp)
                      + 0.658314 * np.sin(2 * D))
    lat = d2r * (5.128122 * np.sin(F))
    rm = 385000.56 - 20905.355 * np.cos(Mp)
    moon_geo_ecl = rm * np.array([np.cos(lat) * np.cos(lon),
                                  np.cos(lat) * np.sin(lon),
                                  np.sin(lat)])

    ecl = (moon_geo_ecl + earth_ecl)  # Sun->Moon, ecliptic of date ~ J2000
    # rotate ecliptic -> equatorial (obliquity)
    eps = 23.439291 * d2r
    R = np.array([[1, 0, 0],
                  [0, np.cos(eps), -np.sin(eps)],
                  [0, np.sin(eps), np.cos(eps)]])
    return R @ ecl


def get_moon_pos_from_sun(epoch_utc: str = DEFAULT_EPOCH_UTC,
                          kernel_dir: Optional[str] = None) -> np.ndarray:
    """Sun->Moon position [km].  SPICE if kernels are present, else the
    analytic fallback."""
    r = _try_spice(epoch_utc, kernel_dir)
    if r is not None:
        return r
    return _analytic_moon_from_sun(epoch_utc)
