"""Field and region rasterization with the reference's image semantics,
the port of fea_tpu/raster/rasterizer.py.

Reproduces what pyvista/VTK offscreen rendering produced for the dataset
(custom_plotter.py:56-193 + fea_analysis.py:463-613):
  * "binary" colormap: scalar lo -> white (255), hi -> black (0),
    background white;
  * per-image scalar range = data range of the plotted step's field,
    appended to ranges.txt by the caller;
  * linear (Gouraud) interpolation of nodal scalars across triangles;
  * region masks: solid black for cell regions, small splats for
    vertex/edge (point) regions.

The nodal interpolation (`interpolate_field`) runs in torch ops on the
caller's device, the CUDA device unless the caller names another; the
masks and splats are host NumPy.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .locate import PixelMap


def scalar_range(values) -> Tuple[float, float]:
    """The (lo, hi) the renderer would report for a nodal field (the value
    written to ranges.txt — custom_plotter.py:181-188)."""
    v = np.asarray(values)
    return float(v.min()), float(v.max())


def interpolate_field(
    pixel_map: PixelMap, triangles: np.ndarray, nodal_values, device=None
) -> torch.Tensor:
    """(S,S) f32 nodal field sampled at pixel centers (garbage outside the
    mesh), on `device`: per pixel, the 3 nodal values of its triangle
    dotted with the barycentric weights."""
    device = resolve_device(device)
    tri_idx = torch.as_tensor(pixel_map.tri_idx, device=device)
    bary = torch.as_tensor(np.asarray(pixel_map.bary, np.float32), device=device)
    tris = torch.as_tensor(np.asarray(triangles, np.int32), device=device)
    values = torch.as_tensor(np.asarray(nodal_values, np.float32), device=device)
    tri = torch.where(tri_idx[..., None] >= 0, tris[tri_idx.clamp(min=0)], 0)  # (S,S,3)
    return (values[tri] * bary).sum(dim=-1)


def field_image(
    pixel_map: PixelMap,
    triangles: np.ndarray,
    nodal_values: np.ndarray,
    value_range: Optional[Tuple[float, float]] = None,
    device=None,
) -> np.ndarray:
    """uint8 (S,S) image of a nodal scalar field, binary-colormap style,
    computed in f32 on `device` (the CUDA device unless named)."""
    device = resolve_device(device)
    field = interpolate_field(pixel_map, triangles, nodal_values, device)
    lo, hi = value_range if value_range is not None else scalar_range(nodal_values)
    span = hi - lo
    if abs(span) < 1e-30:
        # Uniform field renders solid black (the reference's input.png:
        # constant mat-id field under the binary cmap).
        normalized = torch.ones_like(field)
    else:
        # divided by a tensor: the card turns a division by a Python
        # scalar into a product with its reciprocal
        normalized = ((field - lo) / torch.full_like(field, span)).clamp(0.0, 1.0)
    gray = (1.0 - normalized) * 255.0
    inside = torch.as_tensor(pixel_map.inside, device=device)
    img = torch.where(inside, gray, 255.0)
    return torch.round(img).to(torch.uint8).cpu().numpy()


def cell_field_image(
    pixel_map: PixelMap,
    cell_values: np.ndarray,
    value_range: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """uint8 image of a per-cell (el_avg) field — flat shading per triangle,
    as VTK renders cell data (the reference's cauchy_strain/stress images)."""
    vals = np.asarray(cell_values, dtype=np.float64)
    lo, hi = value_range if value_range is not None else scalar_range(vals)
    span = hi - lo
    field = vals[np.clip(pixel_map.tri_idx, 0, None)]
    if abs(span) < 1e-30:
        normalized = np.ones_like(field)
    else:
        normalized = np.clip((field - lo) / span, 0.0, 1.0)
    gray = (1.0 - normalized) * 255.0
    return np.where(pixel_map.inside, np.round(gray), 255).astype(np.uint8)


def geometry_image(pixel_map: PixelMap) -> np.ndarray:
    """Solid geometry render (input.png): black inside, white outside."""
    return np.where(pixel_map.inside, 0, 255).astype(np.uint8)


def node_splat_image(
    pixel_map: PixelMap, coords: np.ndarray, node_ids: np.ndarray, radius: float = 2.0
) -> np.ndarray:
    """Black disks at the given nodes (vertex/edge force & constraint
    region renders — VTK draws these point regions as dots)."""
    S = pixel_map.frame.image_size
    img = np.full((S, S), 255, dtype=np.uint8)
    if len(node_ids) == 0:
        return img
    pix = pixel_map.frame.pixel_of_world(np.asarray(coords)[np.asarray(node_ids)])
    r = int(np.ceil(radius))
    dr, dc = np.mgrid[-r : r + 1, -r : r + 1]
    disk = (dr * dr + dc * dc) <= radius * radius
    dr, dc = dr[disk], dc[disk]  # (D,)
    c0 = np.round(pix[:, 0]).astype(np.int64)[:, None]  # (K,1)
    r0 = np.round(pix[:, 1]).astype(np.int64)[:, None]
    rr = (r0 + dr).ravel()
    cc = (c0 + dc).ravel()
    keep = (rr >= 0) & (rr < S) & (cc >= 0) & (cc < S)
    img[rr[keep], cc[keep]] = 0
    return img


def region_image(
    pixel_map: PixelMap,
    triangles: np.ndarray,
    member_nodes: np.ndarray,
    n_nodes: int,
) -> np.ndarray:
    """Cell-region mask (MaterialRegion renders): pixels whose containing
    triangle has all vertices in the region are black."""
    member = np.zeros(n_nodes, dtype=bool)
    member[np.asarray(member_nodes, dtype=np.int64)] = True
    tri_member = member[np.asarray(triangles)].all(axis=1)  # (M,)
    tri_idx = pixel_map.tri_idx
    mask = pixel_map.inside & tri_member[np.clip(tri_idx, 0, None)]
    return np.where(mask, 0, 255).astype(np.uint8)


def outline_image(
    pixel_map: PixelMap,
    coords: np.ndarray,
    ring_corner_lists,
    width: float = 1.0,
) -> np.ndarray:
    """Boundary outline (outline.png, the autoscale probe artifact)."""
    S = pixel_map.frame.image_size
    img = np.full((S, S), 255, dtype=np.uint8)
    for ring in ring_corner_lists:
        pts = np.asarray(coords)[np.asarray(ring)]
        pix = pixel_map.frame.pixel_of_world(pts)
        a = pix  # (m,2)
        b = np.roll(pix, -1, axis=0)
        seg = b - a
        n = np.maximum(2, (np.hypot(seg[:, 0], seg[:, 1]) * 2).astype(np.int64))
        # sample every segment at its own resolution in one flat batch
        reps = np.repeat(np.arange(len(a)), n)
        local = np.concatenate([np.linspace(0.0, 1.0, k) for k in n])
        p = a[reps] + local[:, None] * seg[reps]
        c0 = np.round(p[:, 0]).astype(np.int64)
        r0 = np.round(p[:, 1]).astype(np.int64)
        keep = (r0 >= 0) & (r0 < S) & (c0 >= 0) & (c0 < S)
        img[r0[keep], c0[keep]] = 0
    return img
