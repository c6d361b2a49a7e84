from .polygon import (
    GeometryError,
    Polygon,
    convex_hull,
    point_in_polygon,
    points_in_polygon,
    polygon_area,
    segments_intersect,
    union_exterior,
)

__all__ = [
    "GeometryError",
    "Polygon",
    "convex_hull",
    "point_in_polygon",
    "points_in_polygon",
    "polygon_area",
    "segments_intersect",
    "union_exterior",
]
