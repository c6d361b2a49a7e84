"""Deterministic framing + pixel->triangle point location (the port's own
copy of fea_tpu/raster/locate.py, host NumPy).

Replaces the reference's render->pixel-scan->re-render->crop loop
(datagen/generate.py:129-145, datagen/utils.py:18-56) with direct math:
the geometry's long axis spans the image, the short axis is centered —
which is exactly what the VTK camera + autoscale dance converges to.

The pixel map (containing triangle + barycentric weights per pixel) is
computed once per plate and reused for every condition/step/field image,
eliminating the per-image VTK render of the reference
(fea_analysis.py:463-613).
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np


class Frame(NamedTuple):
    """World <-> pixel transform for a square image_size x image_size image.

    World x maps to image columns; world y maps to rows bottom-up (row 0 is
    the top of the image, matching the reference's view_xy renders)."""

    image_size: int
    scale: float  # pixels per world unit
    offset_x: float  # pixel offset of world minx
    offset_y: float  # pixel offset of world miny
    minx: float
    miny: float

    def world_of_pixels(self) -> np.ndarray:
        """(S, S, 2) world coordinates of pixel centers."""
        S = self.image_size
        cols = np.arange(S) + 0.5
        rows = np.arange(S) + 0.5
        x = (cols - self.offset_x) / self.scale + self.minx
        y = ((S - rows) - self.offset_y) / self.scale + self.miny
        return np.stack(np.meshgrid(x, y, indexing="xy"), axis=-1)

    def pixel_of_world(self, pts: np.ndarray) -> np.ndarray:
        """(N, 2) world points -> (N, 2) (col, row) pixel coordinates."""
        col = (pts[:, 0] - self.minx) * self.scale + self.offset_x
        row = self.image_size - ((pts[:, 1] - self.miny) * self.scale + self.offset_y)
        return np.stack([col, row], axis=-1)


def make_frame(coords: np.ndarray, image_size: int) -> Frame:
    """Frame a node cloud: long axis spans the full image, short axis
    centered (reference generate.py:129-145 semantics)."""
    minx, miny = coords.min(axis=0)
    maxx, maxy = coords.max(axis=0)
    w, h = maxx - minx, maxy - miny
    extent = max(w, h)
    scale = image_size / max(extent, 1e-12)
    offset_x = (image_size - w * scale) / 2.0
    offset_y = (image_size - h * scale) / 2.0
    return Frame(
        image_size=image_size,
        scale=float(scale),
        offset_x=float(offset_x),
        offset_y=float(offset_y),
        minx=float(minx),
        miny=float(miny),
    )


class PixelMap(NamedTuple):
    tri_idx: np.ndarray  # (S, S) int32, -1 where outside the mesh
    bary: np.ndarray  # (S, S, 3) float32 barycentric weights
    inside: np.ndarray  # (S, S) bool
    frame: Frame


_BARY_TOL = 1e-5  # small negative tolerance keeps boundary pixels


def build_pixel_map(
    coords: np.ndarray,
    triangles: np.ndarray,
    image_size: int,
    frame: Optional[Frame] = None,
    cell_px: int = 8,
    pad_candidates: int = 0,
    pad_shapes: Optional[Tuple[int, int]] = None,
) -> PixelMap:
    """Locate every pixel center in the mesh by scattering triangles over
    their pixel bounding boxes (pure NumPy, single pass).

    This is the scatter dual of per-pixel candidate gathering: total work
    is sum over triangles of their bbox pixel counts (~3-4 px^2 per
    triangle at datagen scale) instead of pixels x candidate-table-width —
    ~20x fewer containment tests on the datagen host. Barycentric coordinates are affine-invariant,
    so tests run directly in pixel space; ties on shared edges resolve by
    the largest minimum-barycentric score (then highest triangle index),
    deterministically.

    `cell_px`, `pad_candidates`, `pad_shapes` are accepted for backward
    compatibility and ignored (the scatter pass needs no binning or shape
    bucketing)."""
    del cell_px, pad_candidates, pad_shapes
    frame = frame or make_frame(coords, image_size)
    S = image_size
    tri = np.asarray(triangles, np.int64)
    M = len(tri)
    # continuous pixel coords of triangle vertices; pixel (r, c)'s center
    # sits at (c + 0.5, r + 0.5)
    vp = frame.pixel_of_world(np.asarray(coords, np.float64))[tri]  # (M,3,2)
    # bbox expansion must be at least as loose as the containment test:
    # score >= -_BARY_TOL admits pixels up to _BARY_TOL (in barycentric
    # units) outside an edge, which in pixel units is _BARY_TOL x the
    # triangle's extent — a fixed pad would be tighter than containment
    # for large triangles (coarse app meshes at 512px).
    ext = np.maximum(
        vp[..., 0].max(1) - vp[..., 0].min(1),
        vp[..., 1].max(1) - vp[..., 1].min(1),
    )
    # x1.5 >= sqrt(2): a diagonal edge's altitude exceeds the axis-aligned
    # extent by up to sqrt(2), so padding by exactly _BARY_TOL*ext would
    # still be tighter than containment for diagonal hull edges
    pad = 1e-4 + 1.5 * _BARY_TOL * ext
    col_lo = np.clip(np.ceil(vp[..., 0].min(1) - 0.5 - pad), 0, S - 1).astype(np.int64)
    col_hi = np.clip(np.floor(vp[..., 0].max(1) - 0.5 + pad), 0, S - 1).astype(np.int64)
    row_lo = np.clip(np.ceil(vp[..., 1].min(1) - 0.5 - pad), 0, S - 1).astype(np.int64)
    row_hi = np.clip(np.floor(vp[..., 1].max(1) - 0.5 + pad), 0, S - 1).astype(np.int64)
    span_c = col_hi - col_lo + 1
    span_r = row_hi - row_lo + 1

    p0 = vp[:, 0]
    e1 = vp[:, 1] - p0  # (M,2)
    e2 = vp[:, 2] - p0
    d = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    inv_d = np.where(np.abs(d) > 1e-30, 1.0 / np.where(d != 0, d, 1.0), 0.0)

    # winner per pixel: packed (score, tri) int64 key, max-reduced
    key_buf = np.full(S * S, -1, dtype=np.int64)
    max_sc = int(span_c.max()) if M else 0
    max_sr = int(span_r.max()) if M else 0
    for dr in range(max_sr):
        r_mask = dr < span_r
        for dc in range(max_sc):
            mask = r_mask & (dc < span_c)
            if not mask.any():
                continue
            t = np.nonzero(mask)[0]
            c = col_lo[t] + dc
            r = row_lo[t] + dr
            px = c + 0.5 - p0[t, 0]
            py = r + 0.5 - p0[t, 1]
            w1 = (px * e2[t, 1] - py * e2[t, 0]) * inv_d[t]
            w2 = (e1[t, 0] * py - e1[t, 1] * px) * inv_d[t]
            w0 = 1.0 - w1 - w2
            score = np.minimum(np.minimum(w0, w1), w2)
            # a degenerate (zero-area) triangle has inv_d forced to 0,
            # which would yield barycentrics (1,0,0) -> score 0 and CLAIM
            # every bbox pixel; reject it outright
            ok = (score >= -_BARY_TOL) & (inv_d[t] != 0.0)
            if not ok.any():
                continue
            t = t[ok]
            si = np.round((score[ok] + 1.0) * 1e7).astype(np.int64)
            key = (si << 24) | t
            np.maximum.at(key_buf, r[ok] * S + c[ok], key)

    tri_idx = np.where(key_buf >= 0, key_buf & ((1 << 24) - 1), -1).astype(
        np.int32
    )
    inside = tri_idx >= 0

    # one vectorized pass: barycentrics of each pixel in its winning triangle
    safe = np.where(inside, tri_idx, 0)
    rows, cols = np.divmod(np.arange(S * S), S)
    px = cols + 0.5 - p0[safe, 0]
    py = rows + 0.5 - p0[safe, 1]
    w1 = (px * e2[safe, 1] - py * e2[safe, 0]) * inv_d[safe]
    w2 = (e1[safe, 0] * py - e1[safe, 1] * px) * inv_d[safe]
    w0 = 1.0 - w1 - w2
    bary = np.stack([w0, w1, w2], axis=-1)
    bary = np.clip(bary, 0.0, 1.0)
    bary = bary / np.maximum(bary.sum(-1, keepdims=True), 1e-12)
    bary = np.where(inside[:, None], bary, 0.0).astype(np.float32)

    return PixelMap(
        tri_idx=tri_idx.reshape(S, S),
        bary=bary.reshape(S, S, 3),
        inside=inside.reshape(S, S),
        frame=frame,
    )
