"""The boundary docs of the geo checks: the points on which two float32
evaluations of a geo query or a geotile may disagree, worked out in float64
on the host. The port's CPU tests and `chip_smoke.py` count them, and hold
match sets and tile counts equal except for them.

The card's and the CPU's f32 `sin`, `cos`, `arcsin`, `log` and `tan` may
differ by an ulp. So a point within ~1e-6 relative of a `geo_distance`
radius, or on a tile edge, can fall on either side on one device and not
the other. Imports numpy and the port, never the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

from elasticsearch_tpu_torch.aggs.nodes import _MERC_LAT
from elasticsearch_tpu_torch.query.geo import EARTH_RADIUS_M


def haversine_m_f64(lat: np.ndarray, lon: np.ndarray, lat0: float, lon0: float) -> np.ndarray:
    """The arc distance in meters from (lat0, lon0), in float64: what
    decides whether a doc lies within float32 noise of a radius."""
    la1, lo1 = np.radians(np.asarray(lat, np.float64)), np.radians(np.asarray(lon, np.float64))
    la2, lo2 = math.radians(lat0), math.radians(lon0)
    a = np.sin((la1 - la2) / 2) ** 2 + np.cos(la1) * math.cos(la2) * np.sin((lo1 - lo2) / 2) ** 2
    return 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def boundary_docs(lat: np.ndarray, lon: np.ndarray, lat0: float, lon0: float,
                  distance_m: float, rtol: float = 1e-5) -> np.ndarray:
    """Docs whose float64 distance lies within `rtol` relative of the radius:
    the only docs on which two float32 evaluations may disagree."""
    d = haversine_m_f64(lat, lon, lat0, lon0)
    return np.abs(d - distance_m) <= rtol * max(distance_m, 1.0)


def tile_boundary_docs(lat: np.ndarray, lon: np.ndarray, precision: int,
                       tol: float = 1e-4) -> np.ndarray:
    """Points whose float64 tile coordinate lies within `tol` of an inner
    tile edge: the only points whose float32 tile two devices may round to
    different tiles."""
    n = 1 << precision
    lr = np.deg2rad(np.clip(np.asarray(lat, np.float64), -_MERC_LAT, _MERC_LAT))
    yf = (1.0 - np.log(np.tan(lr) + 1.0 / np.cos(lr)) / np.pi) / 2.0 * n
    xf = (np.asarray(lon, np.float64) + 180.0) / 360.0 * n
    out = np.zeros(len(xf), bool)
    for f in (xf, yf):
        r = np.rint(f)
        out |= (np.abs(f - r) < tol) & (r > 0) & (r < n)
    return out
