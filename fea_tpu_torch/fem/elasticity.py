"""2D linear elasticity: constitutive matrices and P1 element stiffness,
the port of fea_tpu/fem/elasticity.py.

Matches sfepy's `stiffness_from_youngpoisson(dim=2, ...)` defaults (plane
strain), used by the reference for every material region
(fea_analysis.py:257-266). Per-element arrays are element-minor ((3, 3, M),
(3, 6, M), (6, 6, M)), fea_tpu's layout, which the banded code of a later
slice expects. All arithmetic is in the dtype of the inputs, f32 or f64;
the einsums contract over 3, and the solve's entry points assert that TF32
matmuls are off.
"""

import numpy as np
import torch


def _as_tensor(value):
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(value, dtype=torch.float64)


def plane_strain_stiffness(young, poisson):
    """Plane-strain D (..., 3, 3) from Young's modulus / Poisson ratio.

    D = [[lam+2mu, lam, 0], [lam, lam+2mu, 0], [0, 0, mu]] with the
    engineering-shear Voigt convention (exx, eyy, 2*exy).
    """
    young, poisson = torch.broadcast_tensors(_as_tensor(young), _as_tensor(poisson))
    lam = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    mu = young / (2.0 * (1.0 + poisson))
    zeros = torch.zeros_like(lam)
    row0 = torch.stack([lam + 2 * mu, lam, zeros], dim=-1)
    row1 = torch.stack([lam, lam + 2 * mu, zeros], dim=-1)
    row2 = torch.stack([zeros, zeros, mu], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def plane_stress_stiffness(young, poisson):
    """Plane-stress variant (sfepy's plane='stress' option)."""
    young, poisson = torch.broadcast_tensors(_as_tensor(young), _as_tensor(poisson))
    c = young / (1.0 - poisson**2)
    zeros = torch.zeros_like(c)
    row0 = torch.stack([c, c * poisson, zeros], dim=-1)
    row1 = torch.stack([c * poisson, c, zeros], dim=-1)
    row2 = torch.stack([zeros, zeros, c * (1 - poisson) / 2], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def element_stiffness_np(coords, triangles, young, poisson):
    """Float64 NumPy element stiffness — host-side exact assembly for the
    mixed-precision refinement path and the direct solve.
    Returns (Ke (M,6,6), B (M,3,6), D (M,3,3), area (M,))."""
    coords = np.asarray(coords, np.float64)
    triangles = np.asarray(triangles)
    young = np.asarray(young, np.float64)
    poisson = np.asarray(poisson, np.float64)
    lam = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    mu = young / (2.0 * (1.0 + poisson))
    zeros = np.zeros_like(lam)
    D = np.stack(
        [
            np.stack([lam + 2 * mu, lam, zeros], axis=-1),
            np.stack([lam, lam + 2 * mu, zeros], axis=-1),
            np.stack([zeros, zeros, mu], axis=-1),
        ],
        axis=-2,
    )
    p = coords[triangles]
    x, y = p[..., 0], p[..., 1]
    b = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], -1)
    c = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], -1)
    area2 = x[:, 0] * b[:, 0] + x[:, 1] * b[:, 1] + x[:, 2] * b[:, 2]
    area = 0.5 * area2
    bn = b / area2[:, None]
    cn = c / area2[:, None]
    z = np.zeros_like(bn)
    rxx = np.stack([bn[:, 0], z[:, 0], bn[:, 1], z[:, 1], bn[:, 2], z[:, 2]], -1)
    ryy = np.stack([z[:, 0], cn[:, 0], z[:, 1], cn[:, 1], z[:, 2], cn[:, 2]], -1)
    rxy = np.stack([cn[:, 0], bn[:, 0], cn[:, 1], bn[:, 1], cn[:, 2], bn[:, 2]], -1)
    B = np.stack([rxx, ryy, rxy], -2)
    Ke = np.einsum("mji,mjk,mkl->mil", B, D, B) * area[:, None, None]
    return Ke, B, D, area


def plane_strain_stiffness_em(young, poisson):
    """Element-minor plane-strain D: (3, 3, M) for per-element (M,) inputs."""
    lam = young * poisson / ((1.0 + poisson) * (1.0 - 2.0 * poisson))
    mu = young / (2.0 * (1.0 + poisson))
    zeros = torch.zeros_like(lam)
    return torch.stack(
        [
            torch.stack([lam + 2 * mu, lam, zeros], dim=0),
            torch.stack([lam, lam + 2 * mu, zeros], dim=0),
            torch.stack([zeros, zeros, mu], dim=0),
        ],
        dim=0,
    )  # (3, 3, M)


def triangle_geometry(coords, triangles):
    """Per-element B-matrix ingredients for P1 triangles, element-minor.

    Returns (B (3,6,M), area (M,)). B maps the 6 nodal dofs
    (ux0, uy0, ux1, uy1, ux2, uy2) to Voigt strain (exx, eyy, 2exy)."""
    x = coords[:, 0]
    y = coords[:, 1]
    t0, t1, t2 = triangles[:, 0], triangles[:, 1], triangles[:, 2]
    x0, x1, x2 = x[t0], x[t1], x[t2]
    y0, y1, y2 = y[t0], y[t1], y[t2]
    # Shape-function gradient coefficients, (3, M).
    b = torch.stack([y1 - y2, y2 - y0, y0 - y1], dim=0)
    c = torch.stack([x2 - x1, x0 - x2, x1 - x0], dim=0)
    area2 = x0 * b[0] + x1 * b[1] + x2 * b[2]  # 2*area, (M,)
    area = 0.5 * area2
    inv = 1.0 / area2
    bn = b * inv  # dN/dx, (3, M)
    cn = c * inv  # dN/dy
    zeros = torch.zeros_like(bn[0])
    # Rows: exx from ux via dN/dx; eyy from uy via dN/dy; 2exy mixes both.
    row_xx = torch.stack([bn[0], zeros, bn[1], zeros, bn[2], zeros], dim=0)
    row_yy = torch.stack([zeros, cn[0], zeros, cn[1], zeros, cn[2]], dim=0)
    row_xy = torch.stack([cn[0], bn[0], cn[1], bn[1], cn[2], bn[2]], dim=0)
    B = torch.stack([row_xx, row_yy, row_xy], dim=0)  # (3, 6, M)
    return B, area


def element_stiffness(coords, triangles, D):
    """Per-element 6x6 stiffness Ke = area * B^T D B, element-minor.

    D: (3,3) shared, or (3,3,M) per element (see plane_strain_stiffness_em).
    Returns (Ke (6,6,M), B (3,6,M), area (M,))."""
    B, area = triangle_geometry(coords, triangles)
    if D.ndim == 2:
        D = D[:, :, None].expand(3, 3, B.shape[-1])
    DB = torch.einsum("ijm,jkm->ikm", D, B)
    Ke = torch.einsum("jim,jkm->ikm", B, DB) * area[None, None, :]
    return Ke, B, area
