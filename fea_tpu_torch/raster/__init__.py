"""Pixel maps and images of plates and fields (the port of fea_tpu/raster)."""

from .locate import Frame, PixelMap, build_pixel_map, make_frame
from .rasterizer import (
    cell_field_image,
    field_image,
    geometry_image,
    interpolate_field,
    node_splat_image,
    outline_image,
    region_image,
    scalar_range,
)

__all__ = [
    "Frame",
    "PixelMap",
    "build_pixel_map",
    "make_frame",
    "cell_field_image",
    "field_image",
    "geometry_image",
    "interpolate_field",
    "node_splat_image",
    "outline_image",
    "region_image",
    "scalar_range",
]
