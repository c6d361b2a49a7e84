"""Banded stiffness operator, the port of fea_tpu/fem/banded.py (the
operator; the band-block Jacobi smoother that fea_tpu keeps behind an
off-by-default switch is not ported).

K·u as a *dense banded* product instead of element gathers:

  * host side, once per mesh: a reverse-Cuthill-McKee permutation of the
    nodes. Real datagen meshes (mesh_size 1e-2, ~4-8k nodes) have RCM
    node bandwidth 50-120, i.e. interleaved-dof half-bandwidth ~105-240;
  * once per solve: K's element blocks are summed into a block-shifted
    dense band S of shape (n_blocks, R, W) where row block b holds rows
    [bR, bR+R) and column c of block b is global column bR + c - hb.
    Every K entry with |i-j| <= hb has a slot (W = 2*hb + R), so
    S·window == K·u exactly;
  * every CG iteration: y = einsum('brw,bw->br', S, windows(u)) — one
    batched dense product with a static-index window gather.

The permutation lives inside the solver scaffold: conditions are built on
the original mesh, per-condition arrays are permuted on the host at
dispatch and displacements unpermuted at fetch, so the node order of every
consumer is the mesher's.

Every device function takes leading lane axes (conditions) on its per-solve
arrays; the index tables are shared. Arithmetic is in the input dtype (the
solve's entry points refuse TF32).
"""

import numpy as np
import torch

from .assembly import scatter_sum

# Rows per band block; every node bucket is a multiple of 64 so 2*Nb is
# always divisible by R.
BAND_R = 128


def quantize_hb(hb: int) -> int:
    """Round a dof half-bandwidth up to a multiple of 64 so grouped
    plates share band shapes (W = 2*hb + R stays a multiple of 128)."""
    return max(64, ((int(hb) + 63) // 64) * 64)


def rcm_permutation(triangles: np.ndarray, n_nodes: int):
    """RCM node ordering for bandwidth reduction.

    Returns (perm, hb_dof): `perm[k]` = original node id placed at
    position k, and the natural interleaved-dof half-bandwidth of the
    permuted mesh (2*node_bw + 1, unquantized)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    tri = np.asarray(triangles, dtype=np.int64)
    rows = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 2]])
    cols = np.concatenate([tri[:, 1], tri[:, 2], tri[:, 0]])
    adj = sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n_nodes, n_nodes)
    )
    adj = (adj + adj.T).tocsr()
    perm = np.asarray(
        reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64
    )
    inv = np.empty(n_nodes, np.int64)
    inv[perm] = np.arange(n_nodes)
    node_bw = int(np.abs(inv[rows] - inv[cols]).max()) if len(rows) else 1
    return perm, 2 * node_bw + 1


def band_assembly_indices(
    triangles: np.ndarray, n_nodes: int, hb: int
) -> np.ndarray:
    """Static scatter plan: flat indices into the (2*n_nodes * W,) band
    buffer for every (k1, k2, e) entry of the element-minor Ke (6,6,M).

    `triangles` must already be in the permuted (banded) node order and
    satisfy |i-j| <= hb for every element edge. Returns (36, M) int32."""
    tri = np.asarray(triangles, dtype=np.int64)
    M = len(tri)
    W = 2 * hb + BAND_R
    k = np.arange(6)
    # interleaved dof of local dof k for each element: 2*node + comp
    dof = 2 * tri[:, k // 2] + (k % 2)  # (M, 6)
    i = dof[:, :, None]  # (M, 6, 1) row
    j = dof[:, None, :]  # (M, 1, 6) col
    c = j - (i // BAND_R) * BAND_R + hb
    if c.size and (c.min() < 0 or c.max() >= W):
        raise ValueError(
            f"band half-width {hb} too small for mesh (c range "
            f"[{c.min()}, {c.max()}], W={W})"
        )
    flat = i * W + c  # (M, 6, 6); row-major over (i, c)
    # Ke layout is (k1, k2, e) element-minor -> reorder to (36, M)
    return np.ascontiguousarray(
        flat.transpose(1, 2, 0).reshape(36, M)
    ).astype(np.int32)


def band_assembly_indices_dev(triangles, m_real, hb: int):
    """Device twin of `band_assembly_indices`, computed from the triangle
    table already on the device.

    triangles (..., Mb, 3), m_real (...) the real-triangle counts: ghost
    padding triangles are routed to node 0 (their Ke is exactly zero, so
    the sum there stays exact). No validation here: PlateSolver guarantees
    hb >= the RCM bandwidth of the real triangles by construction.
    Returns (..., 36, Mb) int64."""
    Mb = triangles.shape[-2]
    m_real = torch.as_tensor(m_real, device=triangles.device)
    real = torch.arange(Mb, device=triangles.device) < m_real[..., None]
    tri = torch.where(real[..., None], triangles.to(torch.int64), 0)
    k = torch.arange(6, device=triangles.device)
    dof = 2 * tri[..., k // 2] + (k % 2)  # (..., Mb, 6)
    i = dof[..., :, :, None]
    j = dof[..., :, None, :]
    W = 2 * hb + BAND_R
    c = j - (i // BAND_R) * BAND_R + hb
    flat = i * W + c  # (..., Mb, 6, 6)
    return flat.movedim(-3, -1).reshape(flat.shape[:-3] + (36, Mb))


def assemble_band(Ke, band_idx, n_dofs: int, hb: int):
    """Sum the element blocks into the block-shifted band, through the
    deterministic `scatter_sum`.

    Ke: (..., 6,6,M) element-minor; band_idx: (36, M) (flat-chunk callers
    pre-offset per plate). Returns S (..., n_dofs//R, R, W): one sum per
    solve, amortized over the CG iterations."""
    W = 2 * hb + BAND_R
    S = scatter_sum(n_dofs * W, band_idx.reshape(-1), Ke.flatten(-3))
    return S.reshape(Ke.shape[:-3] + (n_dofs // BAND_R, BAND_R, W))


def window_index(n_dofs: int, hb: int, device=None) -> torch.Tensor:
    """(n_blocks, W) static indices into the hb-padded dof vector:
    window b covers padded positions [bR, bR + W)."""
    W = 2 * hb + BAND_R
    nblk = n_dofs // BAND_R
    return (
        torch.arange(nblk, device=device)[:, None] * BAND_R
        + torch.arange(W, device=device)[None, :]
    )


def banded_matvec(S, x, win_idx, hb: int):
    """y = K x on interleaved (..., n_dofs) vectors via the block-shifted
    band: a window gather (static indices) and one batched product in the
    working dtype."""
    x_pad = torch.nn.functional.pad(x, (hb, hb))
    Xw = x_pad[..., win_idx]  # (..., nblk, W)
    y = torch.einsum("...brw,...bw->...br", S, Xw)
    return y.flatten(-2)


def planar_to_interleaved(u, n):
    """(..., 2n) comp-major planar -> (..., 2n) node-interleaved."""
    lead = u.shape[:-1]
    return u.reshape(lead + (2, n)).transpose(-1, -2).reshape(lead + (2 * n,))


def interleaved_to_planar(u, n):
    """(..., 2n) node-interleaved -> (..., 2n) comp-major planar."""
    lead = u.shape[:-1]
    return u.reshape(lead + (n, 2)).transpose(-1, -2).reshape(lead + (2 * n,))
