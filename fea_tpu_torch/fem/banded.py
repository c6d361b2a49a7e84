"""Banded stiffness operator and band-block Jacobi, the port of
fea_tpu/fem/banded.py.

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


def band_block_diagonal(S, hb: int, block: int):
    """Extract K's (block x block) diagonal blocks from the band.

    S: (..., nblk, R, W) block-shifted band (assemble_band). Returns
    (..., n_dofs // block, block, block). Band geometry: S[i // R, i % R,
    j - (i // R) * R + hb] = K[i, j], so diagonal block g (rows and
    columns [g*block, (g+1)*block)) is a static-index gather. Entries whose
    column offset falls outside the band window satisfy |i - j| > hb and
    are exactly zero in K; they are masked to 0 here."""
    nblk, R, W = S.shape[-3:]
    lead = S.shape[:-3]
    n_dofs = nblk * R
    nb = n_dofs // block
    g = torch.arange(nb, device=S.device)[:, None, None]
    r = torch.arange(block, device=S.device)[None, :, None]
    s = torch.arange(block, device=S.device)[None, None, :]
    i = g * block + r
    j = g * block + s
    c = j - (i // R) * R + hb
    valid = (c >= 0) & (c < W)
    flat = i * W + torch.where(valid, c, 0)
    D = S.flatten(-3)[..., flat.reshape(-1)].reshape(lead + (nb, block, block))
    return D * valid.to(S.dtype)


def _masked_cholesky(D, free_blocks, ridge: float):
    """The masked, ridged SPD blocks' inverse Cholesky factor Linv (lower
    triangular L's inverse), the block mask f, the masked diagonal and
    whether each factorization succeeded.

    Fixed (and ghost) rows and columns are zeroed and given a unit
    diagonal; a relative ridge keeps the factorization positive against
    zero-stiffness straddling cells. `cholesky_ex` reports a block that is
    not positive definite by `info` > 0 with a partial factor (fea_tpu's
    `jnp.linalg.cholesky` gives NaN there), so a block counts as failed
    where `info` != 0; callers also test the result for finite values."""
    B = D.shape[-1]
    f = free_blocks.to(D.dtype)
    Dm = D * f[..., :, None] * f[..., None, :]
    diag = torch.diagonal(Dm, dim1=-2, dim2=-1)  # (..., nb, B)
    mx = diag.max(dim=-1, keepdim=True).values
    add = ridge * mx + torch.where(diag <= 0.0, 1.0, 0.0).to(D.dtype)
    L, info = torch.linalg.cholesky_ex(Dm + torch.diag_embed(add))
    eye = torch.eye(B, dtype=D.dtype, device=D.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)
    return Linv, f, diag, info == 0


def spd_block_inverse(D, free_blocks, ridge: float = 1e-7):
    """Exact-PSD inverse of masked SPD diagonal blocks.

    D: (..., nb, B, B); free_blocks: (..., nb, B) 1.0 free / 0.0 fixed.
    Fixed (and ghost-padding) rows and columns are re-masked to zero after
    the factorization, so the preconditioner never injects residual at
    constrained dofs. Returned as Linv^T Linv (Gram form): symmetric by
    construction and PSD under any rounding. A block whose factorization
    fails degrades to its scalar-Jacobi inverse (diag^-1 on the diagonal)
    rather than poisoning the lane."""
    Linv, f, diag, ok = _masked_cholesky(D, free_blocks, ridge)
    inv = Linv.mT @ Linv
    inv = inv * f[..., :, None] * f[..., None, :]
    ok = ok & torch.isfinite(inv).all(dim=-1).all(dim=-1)
    jac = torch.where(diag > 0.0, f / torch.where(diag > 0.0, diag, 1.0), 0.0)
    return torch.where(ok[..., None, None], inv, torch.diag_embed(jac))


def block_jacobi_apply(Dinv, x):
    """z = blockdiag(Dinv) x on interleaved (..., n_dofs) vectors."""
    B = Dinv.shape[-1]
    xb = x.reshape(x.shape[:-1] + (-1, B, 1))
    return (Dinv @ xb).flatten(-3)


def spd_block_inv_factor(D, free_blocks, ridge: float = 1e-7, out_dtype=torch.bfloat16):
    """Inverse Cholesky factor Linv of masked SPD diagonal blocks, for
    the Gram-form preconditioner apply M r = Linv^T (Linv r).

    Same masking and ridge as `spd_block_inverse`; returning the factor
    halves the per-iteration read when stored bf16 (`out_dtype`): M =
    L~^T L~ is symmetric PSD by construction for any rounding of the
    factor, unlike a rounded explicit inverse. Columns at fixed dofs are
    zeroed so M never injects residual there. A block whose factorization
    fails degrades to scalar Jacobi (diag^-1/2 on the diagonal: its Gram
    square is the scalar-Jacobi inverse)."""
    Linv, f, diag, ok = _masked_cholesky(D, free_blocks, ridge)
    Linv = Linv * f[..., None, :]
    ok = ok & torch.isfinite(Linv).all(dim=-1).all(dim=-1)
    jac = torch.where(diag > 0.0, f / torch.sqrt(torch.where(diag > 0.0, diag, 1.0)), 0.0)
    Linv = torch.where(ok[..., None, None], Linv, torch.diag_embed(jac))
    return Linv.to(out_dtype)


def gram_apply(Linv, x, storage=None):
    """z = blockdiag(Linv^T Linv) x on interleaved (..., n_dofs) vectors.

    fea_tpu's two batched matvecs with the factor in its storage dtype:
    x, and the intermediate Linv x, are rounded to `storage` (default
    Linv's own dtype; round to nearest even) before each product, and the
    products sum in f32 for a bf16 factor, else in the factor's dtype.
    Both products run in that dtype on the rounded values (bf16 values
    multiply exactly in f32). `Linv` may be an f32 copy of a bf16 factor
    (exact), made once per solve, with `storage=torch.bfloat16`. Returns
    x's dtype."""
    storage = Linv.dtype if storage is None else storage
    acc = torch.float32 if storage == torch.bfloat16 else storage
    L = Linv.to(acc)
    B = L.shape[-1]
    xb = x.reshape(x.shape[:-1] + (-1, B, 1)).to(storage).to(acc)
    y = L @ xb
    z = L.mT @ y.to(storage).to(acc)
    return z.flatten(-3).to(x.dtype)


def planar_to_interleaved(u, n):
    """(..., 2n) comp-major planar -> (..., 2n) node-interleaved."""
    lead = u.shape[:-1]
    return u.reshape(lead + (2, n)).transpose(-1, -2).reshape(lead + (2 * n,))


def interleaved_to_planar(u, n):
    """(..., 2n) node-interleaved -> (..., 2n) comp-major planar."""
    lead = u.shape[:-1]
    return u.reshape(lead + (n, 2)).transpose(-1, -2).reshape(lead + (2 * n,))
