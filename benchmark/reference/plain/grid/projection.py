"""Polar-stereographic map projection (ellipsoidal).

Replaces the two projections the reference actually uses from the vendored
NSIDC mapx C library (reference: contrib/mapx/src/polar_stereographic.c:86-260,
mesh/NpsNextsim.mpp, mesh/NpsASR.mpp). The math follows the same Snyder
formulation as mapx (t-function forward; series-in-chi inverse) so projected
coordinates match the reference numerics to rounding.

NpsNextsim.mpp parameters: lat0=90, lat_ts(lat1)=60, central meridian -45°
(mapx 'rotation' of -45 about the pole), Hughes-1980 ellipsoid
(a=6378.273 km, e=0.081816153).

Host-side numpy only (the grid is built on the host and copied to the
device once).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PolarStereo:
    """North (or south) polar stereographic on an ellipsoid.

    x,y in meters, origin at the pole, x axis toward lon0+90E, y axis toward
    lon0+180 (mapx convention: x = rho*sin(lam), y = -rho*cos(lam) with
    lam = lon - lon0).
    """

    lat0: float = 90.0  # pole (+90 or -90)
    lat_ts: float = 60.0  # latitude of true scale (mapx lat1)
    lon0: float = -45.0  # central meridian
    a: float = 6378.273e3  # equatorial radius [m] (Hughes 1980, as in .mpp)
    ecc: float = 0.081816153

    @property
    def _m1(self) -> float:
        # m = cos(phi)/sqrt(1 - e^2 sin^2 phi) at lat_ts
        # (reference: polar_stereographic.c:115-116)
        phi1 = math.radians(abs(self.lat_ts))
        s = math.sin(phi1)
        return math.cos(phi1) / math.sqrt(1.0 - self.ecc**2 * s * s)

    @property
    def _t1(self) -> float:
        # (reference: polar_stereographic.c:118-131)
        phi1 = math.radians(abs(self.lat_ts))
        s = math.sin(phi1)
        num = 1.0 - self.ecc * s
        den = 1.0 + self.ecc * s
        return math.tan(math.pi / 4 - phi1 / 2) / (num / den) ** (self.ecc / 2)

    def forward(self, lat, lon) -> Tuple[np.ndarray, np.ndarray]:
        """lat/lon [deg] -> x,y [m]. (reference: polar_stereographic.c:136-187)"""
        south = self.lat0 < 0
        sgn = -1.0 if south else 1.0
        phi = np.deg2rad(sgn * np.asarray(lat))
        lam = np.deg2rad(sgn * (np.asarray(lon) - self.lon0))
        sin_phi = np.sin(phi)
        num = 1.0 + self.ecc * sin_phi
        den = 1.0 - self.ecc * sin_phi
        t = np.sqrt((1.0 - sin_phi) / (1.0 + sin_phi) * (num / den) ** self.ecc)
        rho = self.a * self._m1 * t / self._t1
        x = rho * np.sin(lam)
        y = -rho * np.cos(lam)
        return sgn * x, sgn * y

    def inverse(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """x,y [m] -> lat/lon [deg]. (reference: polar_stereographic.c:188-246)"""
        south = self.lat0 < 0
        sgn = -1.0 if south else 1.0
        x = sgn * np.asarray(x)
        y = sgn * np.asarray(y)
        rho = np.sqrt(x * x + y * y)
        t = rho * self._t1 / (self.a * self._m1)
        chi = np.pi / 2.0 - 2.0 * np.arctan(t)
        e2 = self.ecc**2
        e4 = e2 * e2
        e6 = e4 * e2
        e8 = e4 * e4
        phi = (
            chi
            + np.sin(2 * chi) * (e2 / 2.0 + 5.0 * e4 / 24.0 + e6 / 12.0 + 13.0 * e8 / 360.0)
            + np.sin(4 * chi) * (7.0 * e4 / 48.0 + 29.0 * e6 / 240.0 + 811.0 * e8 / 11520.0)
            + np.sin(6 * chi) * (7.0 * e6 / 120.0 + 81.0 * e8 / 1120.0)
            + np.sin(8 * chi) * (4279.0 * e8 / 161280.0)
        )
        lat = sgn * np.rad2deg(phi)
        lam = np.arctan2(x, -y)
        lon = sgn * np.rad2deg(lam) + self.lon0
        lon = (lon + 180.0) % 360.0 - 180.0
        return lat, lon


#: The model's native projection (mesh/NpsNextsim.mpp)
NPS_NEXTSIM = PolarStereo(lat0=90.0, lat_ts=60.0, lon0=-45.0)
#: The ASR forcing grid projection (mesh/NpsASR.mpp: rotation -175 => lon0 -175)
NPS_ASR = PolarStereo(lat0=90.0, lat_ts=60.0, lon0=-175.0)
