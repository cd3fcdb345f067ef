"""GeoJSON shape storage and predicates — the cellulite equivalent.

Reference: milli's `_geojson` reserved field is indexed into cellulite
(index.rs:205, update/new/extract/geo/); filters combine the `_geo` point
R-tree with cellulite shape queries (facet/filter/index_filter.rs:495-715):
`_geoRadius`/`_geoBoundingBox` union point and shape matches, `_geoPolygon`
matches shapes only and requires `_geojson` to be filterable.

The TPU build stores parsed shapes per docid and evaluates the predicates
vectorized-per-shape on the host (shape counts are tiny next to postings);
a device grid-cell index is the scale-up path.
"""

from __future__ import annotations

import math
from typing import Optional

# A parsed shape is a list of (kind, data):
#   ("point", (lat, lng))
#   ("line", [(lat, lng), ...])
#   ("polygon", [ring0, ring1...])  rings = [(lat, lng), ...], ring0 = outer


def parse_geojson(value) -> Optional[list]:
    """Parse a GeoJSON geometry/feature into primitive shapes; None if
    invalid. Coordinates are GeoJSON [lng, lat]."""
    if not isinstance(value, dict):
        return None
    gtype = value.get("type")
    if gtype == "Feature":
        return parse_geojson(value.get("geometry"))
    if gtype == "FeatureCollection":
        shapes = []
        for feat in value.get("features", []) or []:
            sub = parse_geojson(feat)
            if sub:
                shapes.extend(sub)
        return shapes or None
    if gtype == "GeometryCollection":
        shapes = []
        for geom in value.get("geometries", []) or []:
            sub = parse_geojson(geom)
            if sub:
                shapes.extend(sub)
        return shapes or None
    coords = value.get("coordinates")
    if coords is None:
        return None

    def pt(c):
        return (float(c[1]), float(c[0]))  # -> (lat, lng)

    try:
        if gtype == "Point":
            return [("point", pt(coords))]
        if gtype == "MultiPoint":
            return [("point", pt(c)) for c in coords]
        if gtype == "LineString":
            return [("line", [pt(c) for c in coords])]
        if gtype == "MultiLineString":
            return [("line", [pt(c) for c in line]) for line in coords]
        if gtype == "Polygon":
            return [("polygon", [[pt(c) for c in ring] for ring in coords])]
        if gtype == "MultiPolygon":
            return [
                ("polygon", [[pt(c) for c in ring] for ring in poly])
                for poly in coords
            ]
    except (TypeError, ValueError, IndexError):
        return None
    return None


# -- predicates ---------------------------------------------------------------

_EARTH_R = 6371000.0


def _haversine_m(lat1, lng1, lat2, lng2) -> float:
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dp = math.radians(lat2 - lat1)
    dl = math.radians(lng2 - lng1)
    a = math.sin(dp / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dl / 2) ** 2
    return 2 * _EARTH_R * math.asin(math.sqrt(a))


def _point_in_ring(lat, lng, ring) -> bool:
    inside = False
    n = len(ring)
    for i in range(n):
        la1, lo1 = ring[i]
        la2, lo2 = ring[(i + 1) % n]
        if (lo1 > lng) != (lo2 > lng):
            t = (lng - lo1) / (lo2 - lo1)
            if lat < la1 + t * (la2 - la1):
                inside = not inside
    return inside


def _point_in_polygon(lat, lng, rings) -> bool:
    if not rings or not _point_in_ring(lat, lng, rings[0]):
        return False
    # holes
    return not any(_point_in_ring(lat, lng, hole) for hole in rings[1:])


def _segment_distance_m(lat, lng, a, b) -> float:
    """Point-to-segment distance, locally-planar approximation (adequate at
    filter scales; cellulite's spherical cells bound the same error)."""
    # scale lng by cos(lat) so degrees are locally isotropic
    k = math.cos(math.radians(lat))
    ax, ay = (a[1] - lng) * k, a[0] - lat
    bx, by = (b[1] - lng) * k, b[0] - lat
    dx, dy = bx - ax, by - ay
    denom = dx * dx + dy * dy
    t = 0.0 if denom == 0 else max(0.0, min(1.0, -(ax * dx + ay * dy) / denom))
    px, py = ax + t * dx, ay + t * dy
    deg = math.hypot(px, py)
    return deg * math.pi / 180.0 * _EARTH_R


def _segments(points, closed=False):
    n = len(points)
    last = n if closed else n - 1
    for i in range(last):
        yield points[i], points[(i + 1) % n]


def _segments_intersect(p1, p2, p3, p4) -> bool:
    def orient(a, b, c):
        v = (b[1] - a[1]) * (c[0] - a[0]) - (b[0] - a[0]) * (c[1] - a[1])
        return 0 if v == 0 else (1 if v > 0 else -1)

    o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
    o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
    if o1 != o2 and o3 != o4:
        return True
    return False


def shape_in_circle(shapes: list, lat: float, lng: float, radius_m: float) -> bool:
    for kind, data in shapes:
        if kind == "point":
            if _haversine_m(lat, lng, data[0], data[1]) <= radius_m:
                return True
        elif kind == "line":
            if any(
                _segment_distance_m(lat, lng, a, b) <= radius_m
                for a, b in _segments(data)
            ):
                return True
        else:  # polygon: center inside, or boundary within radius
            if _point_in_polygon(lat, lng, data):
                return True
            if data and any(
                _segment_distance_m(lat, lng, a, b) <= radius_m
                for a, b in _segments(data[0], closed=True)
            ):
                return True
    return False


def shape_in_polygon(shapes: list, query_ring: list) -> bool:
    """True when any shape intersects the query polygon (single ring of
    (lat, lng) points) — the cellulite `in_shape` predicate."""
    for kind, data in shapes:
        if kind == "point":
            if _point_in_ring(data[0], data[1], query_ring):
                return True
        elif kind == "line":
            if any(_point_in_ring(la, lo, query_ring) for la, lo in data):
                return True
            if any(
                _segments_intersect(a, b, c, d)
                for a, b in _segments(data)
                for c, d in _segments(query_ring, closed=True)
            ):
                return True
        else:
            outer = data[0] if data else []
            # any vertex of one inside the other, or any edge crossing
            if any(_point_in_ring(la, lo, query_ring) for la, lo in outer):
                return True
            if any(
                _point_in_polygon(la, lo, data) for la, lo in query_ring
            ):
                return True
            if any(
                _segments_intersect(a, b, c, d)
                for a, b in _segments(outer, closed=True)
                for c, d in _segments(query_ring, closed=True)
            ):
                return True
    return False


def shape_in_box(shapes: list, top_right, bottom_left) -> bool:
    """Box as polygon ring (handles the antimeridian by splitting)."""
    tr_lat, tr_lng = top_right
    bl_lat, bl_lng = bottom_left
    if bl_lng <= tr_lng:
        boxes = [(bl_lng, tr_lng)]
    else:  # wraps the antimeridian
        boxes = [(bl_lng, 180.0), (-180.0, tr_lng)]
    for lo, hi in boxes:
        ring = [
            (tr_lat, hi),
            (tr_lat, lo),
            (bl_lat, lo),
            (bl_lat, hi),
        ]
        if shape_in_polygon(shapes, ring):
            return True
    return False
