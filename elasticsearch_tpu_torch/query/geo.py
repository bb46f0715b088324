"""Geo queries: `geo_bounding_box` and `geo_distance`.

This package's copy of the JAX package's `query/geo.py` (reference behavior:
index/query/GeoBoundingBoxQueryBuilder.java, with boxes that cross the
dateline, and GeoDistanceQueryBuilder.java, the haversine arc distance). A
geo_point is two float32 docvalue columns, `field#lat` and `field#lon`
(`index/pack.py`), so both queries are elementwise arithmetic over two
columns on the device, scored at a constant boost.

The haversine runs in the JAX package's float32 operations, in its order:
degrees to radians, the two half-angle sines squared, the cosines, the
clamp, `arcsin(sqrt(a))`, times 2R. The card's and the CPU's `sin`, `cos`
and `arcsin` may differ by an ulp, so a point within ~1e-6 relative of the
radius can fall on either side (the checks count such boundary docs).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np
import torch

from ..index.pack import _parse_geo_point
from ..utils.errors import IllegalArgumentError, QueryParsingError
from .nodes import QueryNode, _doc_match, _empty

EARTH_RADIUS_M = 6371008.7714  # the mean radius of Lucene's GeoUtils

_DIST_UNITS = {
    "mm": 0.001, "cm": 0.01, "m": 1.0, "km": 1000.0,
    "in": 0.0254, "ft": 0.3048, "yd": 0.9144, "mi": 1609.344,
    "nmi": 1852.0, "nauticalmiles": 1852.0, "kilometers": 1000.0,
    "meters": 1.0, "miles": 1609.344, "feet": 0.3048, "inch": 0.0254,
}


def parse_distance_meters(v) -> float:
    """"12km", "3.5mi", 250 (meters) -> meters."""
    if isinstance(v, (int, float)):
        return float(v)
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]*)\s*", str(v))
    if not m:
        raise IllegalArgumentError(f"failed to parse distance [{v}]")
    unit = m.group(2).lower() or "m"
    if unit not in _DIST_UNITS:
        raise IllegalArgumentError(f"unknown distance unit [{unit}]")
    return float(m.group(1)) * _DIST_UNITS[unit]


def geo_cols(dev, fld):
    """-> (lat, has, lon) of a geo_point field on the device, or None."""
    lat = dev["dv_float"].get(f"{fld}#lat")
    lon = dev["dv_float"].get(f"{fld}#lon")
    if lat is None or lon is None:
        return None
    return lat[0], lat[1] & lon[1], lon[0]


def haversine_m(lat: torch.Tensor, lon: torch.Tensor, lat0: float, lon0: float) -> torch.Tensor:
    """Arc distance in meters from (lat0, lon0), in float32 (the JAX
    package's operations and order)."""
    la1 = torch.deg2rad(lat)
    lo1 = torch.deg2rad(lon)
    la2 = math.radians(lat0)
    lo2 = math.radians(lon0)
    a = torch.sin((la1 - la2) / 2) ** 2 + torch.cos(la1) * math.cos(la2) \
        * torch.sin((lo1 - lo2) / 2) ** 2
    return 2.0 * EARTH_RADIUS_M * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


@dataclass
class GeoBoundingBoxNode(QueryNode):
    fld: str = ""
    top: float = 90.0
    bottom: float = -90.0
    left: float = -180.0
    right: float = 180.0
    boost: float = 1.0

    def prepare(self, pack):
        return float(np.float32(self.boost))

    def device_eval(self, dev, params, ctx):
        got = geo_cols(dev, self.fld)
        if got is None:
            return _empty(ctx)
        lat, has, lon = got
        n = ctx.num_docs
        lat, has, lon = lat[:n], has[:n], lon[:n]
        ok = has & (lat <= self.top) & (lat >= self.bottom)
        if self.left <= self.right:
            ok = ok & (lon >= self.left) & (lon <= self.right)
        else:  # the box crosses the dateline
            ok = ok & ((lon >= self.left) | (lon <= self.right))
        match = _doc_match(ok, ctx)
        return params * match.to(torch.float32), match


@dataclass
class GeoDistanceNode(QueryNode):
    fld: str = ""
    lat: float = 0.0
    lon: float = 0.0
    distance_m: float = 0.0
    boost: float = 1.0

    def prepare(self, pack):
        return float(np.float32(self.boost))

    def device_eval(self, dev, params, ctx):
        got = geo_cols(dev, self.fld)
        if got is None:
            return _empty(ctx)
        lat, has, lon = got
        n = ctx.num_docs
        dist = haversine_m(lat[:n], lon[:n], self.lat, self.lon)
        match = _doc_match(has[:n] & (dist <= self.distance_m), ctx)
        return params * match.to(torch.float32), match


def parse_geo_bounding_box(body, mappings) -> GeoBoundingBoxNode:
    body = dict(body)
    boost = float(body.pop("boost", 1.0))
    body.pop("validation_method", None)
    body.pop("ignore_unmapped", None)
    if len(body) != 1:
        raise QueryParsingError("[geo_bounding_box] expects one field")
    (fld, spec), = body.items()
    if "top_left" in spec and "bottom_right" in spec:
        top, left = _parse_geo_point(spec["top_left"])
        bottom, right = _parse_geo_point(spec["bottom_right"])
    else:
        top, bottom = float(spec["top"]), float(spec["bottom"])
        left, right = float(spec["left"]), float(spec["right"])
    return GeoBoundingBoxNode(fld=fld, top=top, bottom=bottom, left=left, right=right,
                              boost=boost)


def parse_geo_distance(body, mappings) -> GeoDistanceNode:
    body = dict(body)
    boost = float(body.pop("boost", 1.0))
    distance = body.pop("distance", None)
    for k in ("distance_type", "validation_method", "ignore_unmapped"):
        body.pop(k, None)
    if distance is None:
        raise QueryParsingError("[geo_distance] requires [distance]")
    if len(body) != 1:
        raise QueryParsingError("[geo_distance] expects one origin field")
    (fld, origin), = body.items()
    lat, lon = _parse_geo_point(origin)
    return GeoDistanceNode(fld=fld, lat=lat, lon=lon,
                           distance_m=parse_distance_meters(distance), boost=boost)
