"""Two-level aggregation preconditioner for the elasticity PCG, the port
of fea_tpu/fem/coarse.py (the geometric aggregates).

The reference solves every system with a sparse direct LU
(fea_analysis.py:371-375), which is immune to conditioning. Matrix-free
f32 CG is not: random plates with thin features, point loads, and
zero-stiffness straddling cells (the sfepy region semantics) reach
condition numbers where block-Jacobi PCG stalls near 1e-3 relative
residual after thousands of iterations.

Fix: a coarse space of per-aggregate rigid-body modes (the 2D elasticity
near-null space: x/y translation + rotation), solved densely.

  M^-1 = block-Jacobi  +  P (P^T K P)^-1 P^T      (additive two-level)

  * aggregates: geometric node binning on a uniform grid (host, O(N));
  * P: 3 modes per aggregate, masked at Dirichlet dofs (device);
  * Kc = P^T K P assembled from the element 6x6 blocks by a sorted
    scatter-sum (device, once per condition — K depends on condition
    materials/BCs);
  * Kc^-1 formed explicitly via Cholesky so each CG iteration's coarse
    correction is ONE dense (3Nc,3Nc)x(3Nc) matvec, no triangular solves
    in the hot loop.

n_coarse is a pure function of the node bucket. Where fea_tpu restricts
with three segment-sums over `agg_ids`, the port sums over a fixed-width
table of each aggregate's member nodes (`CoarseSpace.members`), as the
matrix-free operator sums over incidence slots: a fixed order, so the
preconditioner is the same from run to run on the card.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .assembly import scatter_sum


class CoarseSpace(NamedTuple):
    """Host-built per-plate aggregation (condition-independent).

    agg_ids: (N,) int32 aggregate of each node (padding ghosts -> outlier
             aggregate with zero arm; they are Dirichlet-fixed and masked).
    arms:    (N, 2) float32 node offset from its aggregate centroid (the
             rotation-mode moment arm).
    n_coarse: static aggregate count (grid cells + 1 outlier slot).
    members: (n_coarse, width) int32: each aggregate's real nodes, padded
             with N (the index of a zero appended to the vector being
             summed); ghosts are left out (aggregate_members).
    """

    agg_ids: np.ndarray
    arms: np.ndarray
    n_coarse: int
    members: np.ndarray


def n_coarse_for_bucket(node_bucket: int, agg_target: int = 16) -> int:
    """Static coarse size for a node bucket: ~one aggregate per
    `agg_target` nodes, floor 8, cap 1024. Shared by all plates in the
    bucket. The cap bounds the dense coarse operator: Kc and its inverse
    are (3*n_coarse)^2 floats and the factorization is O((3*n_coarse)^3).
    1024 aggregates capture the low-frequency modes of any mesh this
    pipeline produces; beyond that the coarse grid stops paying for
    itself."""
    return min(max(node_bucket // agg_target, 8), 1024)


def aggregate_members(
    agg_ids: np.ndarray, n_coarse: int, n_real: Optional[int] = None
) -> np.ndarray:
    """(n_coarse, width) table of the first `n_real` nodes' indices by
    aggregate, in node order, padded with len(agg_ids); width a multiple
    of 8.

    Bucket-padding ghosts (nodes from `n_real` on) are left out: they are
    Dirichlet-fixed, so the residual the table sums is zero there, and all
    of them share the outlier aggregate — thousands of nodes in a large
    bucket, which would set the width of the whole table."""
    agg_ids = np.asarray(agg_ids, np.int64)
    n = len(agg_ids)
    real = agg_ids[: n if n_real is None else n_real]
    counts = np.bincount(real, minlength=n_coarse)
    width = ((max(int(counts.max()), 1) + 7) // 8) * 8
    order = np.argsort(real, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(len(real)) - np.repeat(starts, counts)
    members = np.full((n_coarse, width), n, dtype=np.int32)
    members[real[order], within] = order
    return members


def build_aggregates(
    coords: np.ndarray,
    n_coarse: int,
    n_real: Optional[int] = None,
) -> CoarseSpace:
    """Geometric aggregation: bin the real nodes on a uniform grid over
    their bbox sized so used cells < n_coarse; compact to dense ids.

    Nodes beyond `n_real` (bucket-padding ghosts, placed far from the
    domain by StaticProblem.padded) go to a reserved outlier aggregate
    with zero arm — they are always Dirichlet-fixed, so they contribute
    nothing to P^T K P or to the coarse residual."""
    coords = np.asarray(coords, np.float64)
    n = len(coords)
    if n_real is None:
        n_real = n
    real = coords[:n_real]
    # grid_n^2 <= n_coarse - 1 (one slot reserved for the outlier agg)
    grid_n = max(int(np.floor(np.sqrt(max(n_coarse - 1, 1)))), 1)
    lo = real.min(axis=0)
    hi = real.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    cell = np.clip(
        ((real - lo) / span * grid_n).astype(np.int64), 0, grid_n - 1
    )
    flat = cell[:, 0] * grid_n + cell[:, 1]
    used, compact = np.unique(flat, return_inverse=True)
    n_used = len(used)
    assert n_used < n_coarse, (n_used, n_coarse)

    agg_ids = np.full(n, n_coarse - 1, dtype=np.int32)  # outlier default
    agg_ids[:n_real] = compact.astype(np.int32)

    # centroids of the real aggregates -> rotation arms
    sums = np.zeros((n_used, 2))
    np.add.at(sums, compact, real)
    counts = np.bincount(compact, minlength=n_used).astype(np.float64)
    centroids = sums / counts[:, None]
    arms = np.zeros((n, 2), dtype=np.float32)
    arms[:n_real] = (real - centroids[compact]).astype(np.float32)
    return CoarseSpace(
        agg_ids=agg_ids, arms=arms, n_coarse=n_coarse,
        members=aggregate_members(agg_ids, n_coarse, n_real),
    )


def build_coarse_matrix(
    Ke: torch.Tensor,  # (6,6,M) element-minor, dof order (x0,y0,x1,y1,x2,y2)
    triangles: torch.Tensor,  # (M,3)
    agg_ids: torch.Tensor,  # (N,)
    arms: torch.Tensor,  # (N,2)
    free_nodes: torch.Tensor,  # (N,) 1.0 free / 0.0 fixed
    n_coarse: int,
) -> torch.Tensor:
    """Kc = P^T K P assembled element-wise: each element's 6x6 block maps
    to the <=9 coarse dofs (3 vertex aggregates x 3 rigid modes) through
    the local prolongation Le, then sums into the dense Kc.

    Returns (3*n_coarse, 3*n_coarse), SPD-regularized (unit diagonal on
    empty aggregates, small ridge elsewhere) and Cholesky-ready."""
    dtype = Ke.dtype
    tri = triangles.to(torch.int64)  # (M,3)
    arm_e = arms[tri].to(dtype)  # (M,3,2)
    free_e = free_nodes[tri].to(dtype)  # (M,3)

    # Le[k, 3s+m] for k = 2a+c, nonzero iff s == a:
    #   c=0: (1, 0, -arm_y) ; c=1: (0, 1, +arm_x)   x free(node)
    M = tri.shape[0]
    Le = Ke.new_zeros((6, 9, M))
    for a in range(3):
        f = free_e[:, a]
        Le[2 * a + 0, 3 * a + 0] = f
        Le[2 * a + 0, 3 * a + 2] = -arm_e[:, a, 1] * f
        Le[2 * a + 1, 3 * a + 1] = f
        Le[2 * a + 1, 3 * a + 2] = arm_e[:, a, 0] * f

    # Kce = Le^T Ke Le, element-minor throughout
    T1 = torch.einsum("klm,ljm->kjm", Ke, Le)  # (6,9,M)
    Kce = torch.einsum("kim,kjm->ijm", Le, T1)  # (9,9,M)

    # coarse dof of local slot (s, m): 3*agg[tri[:, s]] + m
    cdof = (3 * agg_ids.to(torch.int64)[tri]).T  # (3, M)
    modes = torch.arange(3, device=cdof.device)[:, None]
    cdof = torch.cat([cdof[s][None] + modes for s in range(3)])  # (9, M)
    nc3 = 3 * n_coarse
    flat = (cdof[:, None, :] * nc3 + cdof[None, :, :]).reshape(-1)  # (81*M,)
    Kc = scatter_sum(nc3 * nc3, flat, Kce.reshape(-1)).reshape(nc3, nc3)

    # Regularize: empty aggregates (no free node) get an identity diagonal;
    # the rest a tiny ridge so f32 Cholesky stays positive.
    d = torch.diagonal(Kc)
    ridge = 1e-6 * d.max() + torch.where(d <= 0.0, 1.0, 0.0).to(dtype)
    return Kc + torch.diag(ridge)


def coarse_inverse(Kc: torch.Tensor) -> torch.Tensor:
    """Explicit Kc^-1 via Cholesky (one-time); NaN-safe: a failed
    factorization (a pathological condition) degrades to the zero matrix,
    i.e. plain block-Jacobi. `cholesky_ex` reports the failure as a value
    on the device: nothing raises and the host reads nothing. Kc may carry
    leading batch axes; each matrix degrades on its own."""
    L, info = torch.linalg.cholesky_ex(Kc)
    eye = torch.eye(Kc.shape[-1], dtype=Kc.dtype, device=Kc.device)
    inv = torch.cholesky_solve(eye.expand(Kc.shape), L)
    ok = (info == 0) & torch.isfinite(inv).all(dim=-1).all(dim=-1)
    return torch.where(ok[..., None, None], inv, torch.zeros_like(inv))


def coarse_apply(
    Kc_inv: torch.Tensor,  # (3Nc, 3Nc)
    agg_ids: torch.Tensor,  # (N,)
    arms: torch.Tensor,  # (N,2)
    members: torch.Tensor,  # (Nc, width), CoarseSpace.members
    r_planar: torch.Tensor,  # (2N,) comp-major (x block then y block)
) -> torch.Tensor:
    """z = P Kc^-1 P^T r on planar dof vectors (the CG hot-loop term).

    Restriction = 3 sums over each aggregate's members; coarse solve = one
    dense matvec; prolongation = gathers. r is already masked at fixed dofs
    by the CG loop, and P's fixed rows are zero in Kc, so no extra masking
    needed."""
    n = agg_ids.shape[0]
    dtype = r_planar.dtype
    rx = r_planar[:n]
    ry = r_planar[n:]
    armx = arms[:, 0].to(dtype)
    army = arms[:, 1].to(dtype)
    moments = torch.stack([rx, ry, -army * rx + armx * ry])  # (3, N)
    moments = torch.cat([moments, moments.new_zeros(3, 1)], dim=1)
    rc = moments[:, members].sum(dim=2).T.reshape(-1)  # (3Nc,) [3a+m]
    # a matvec in the working dtype: a reduced-precision product here
    # would make the preconditioner vary from iteration to iteration and
    # void PCG's convergence guarantee on the ill-conditioned solves the
    # coarse space exists for
    zc3 = torch.mv(Kc_inv, rc).reshape(-1, 3)[agg_ids]  # (N, 3)
    zx = zc3[:, 0] - army * zc3[:, 2]
    zy = zc3[:, 1] + armx * zc3[:, 2]
    return torch.cat([zx, zy])
